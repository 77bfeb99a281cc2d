"""The batched LiNGAM estimator and both serving engines sharded over the
data ranks (``fit_batch(rules=)``, ``causal_order_batch(rules=)``,
``aot_fit_batch(rules=)``, ``LingamEngine(rules=)``,
``AsyncLingamEngine(rules=)``) on spawned gloo ranks of the CPU, held
against the port's one-rank results and the JAX package's sharded
``fit_batch``.

Grids ``(data, model)`` = (2, 1) on one spawn of 2 ranks, and (4, 1) and
(2, 2) on one spawn of 4 ranks (``test_torch_tp.run_grid``, a 120 s timeout
on every collective, each job on its own grid's mesh). The cases are the
reference's (``tests/test_fit_batch.py:169-211``,
``tests/test_lingam_engine.py:229-241``, ``tests/test_async_engine.py:
276-310``) at their sizes: 8 ragged datasets in the (16, 512) bucket, dense
and ``threshold=True``; 6 exact datasets (the data ranks divide 6 at (2, 1)
and (2, 2), not at (4, 1): every rank computes the whole batch there); the
sync engine with ``pad_batch_pow2`` on and off; the async engine with 4
submitter threads on the leader, ``replicas=2`` and a pre-warm. At (2, 1)
also the async engine's faults: a fit that raises on a follower or on the
leader, a leader whose fits run longer than half the watchdog's budget over
two replicas, and a link lost between the header and the bucket.

What is held:

* every rank's results equal the one-rank results of the same call in this
  process bit for bit: orders, B, noise variances, comparisons, rounds,
  convergence (the pipeline takes each dataset alone, so a rank's block
  computes what the whole batch computes for it);
* the orders equal the JAX package's ``fit_batch(rules=make_rules(cfg,
  Mesh(devices.reshape(grid), ("data", "model"))))`` on fake XLA devices in
  a subprocess beside the ranks, and B lies within 2e-4 of its
  (``tests/test_torch_fit_batch.py``'s bound on the padded ragged case);
* both engines deliver every request, each fit equal to the one-rank
  engine's of the same request; a submit on a follower raises, and the
  leader's ``close()`` ends every follower;
* a fit that raises on one rank fails the leader's request within seconds
  and leaves the ranks in step (the next request is served); a slow fit
  under two replicas expires no watchdog budget; a lost link fails the
  leader's request and ends the followers within seconds;
* only a sharded dispatch whose data ranks do not divide its request count
  pads the batch count.
"""

import os
import subprocess
import sys
import textwrap
import threading
import time
from datetime import timedelta
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import sem
from repro_torch.core.paralingam import (
    ParaLiNGAMConfig,
    aot_fit_batch,
    causal_order_batch,
    fit_batch,
)
from repro_torch.dist.sharding import (
    NO_SHARDING,
    gather_rows,
    make_rules,
    pack_rows,
    row_block,
    unpack_rows,
)
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.serve import (
    AsyncLingamEngine,
    BatchingConfig,
    LingamEngine,
    LingamServeConfig,
    ReplicaPoolConfig,
    bucket_shape,
    dispatch_bucket,
)
from repro_torch.serve import async_engine
from repro_torch.serve.lingam_engine import batch_pad
from repro_torch.utils.shapes import next_pow2
from test_torch_tp import ROOT, grid_id, run_grid

WORLDS = {2: ((2, 1),), 4: ((4, 1), (2, 2))}
GRIDS = tuple(g for grids in WORLDS.values() for g in grids)
PG_TIMEOUT = timedelta(seconds=120)
B_ATOL = 2e-4
RAGGED = [(8, 400), (12, 512), (16, 300), (9, 512), (16, 512), (11, 333), (8, 512), (13, 444)]
CFG = ParaLiNGAMConfig(min_bucket=8)
SCFG = LingamServeConfig(min_p_bucket=8, min_n_bucket=64, max_batch=8)
FIELDS = ("orders", "comparisons", "rounds", "converged", "b", "noise_var")
FIT_FIELDS = ("order", "b", "noise_var", "comparisons", "rounds", "converged")
SUBMITTERS = 4
FAULT_GRID = (2, 1)
#: The watchdog's budget and the leader's fit time in ``job_slow_fits``:
#: one fit is more than half the budget, so a fit that waited behind
#: another's would expire.
BUDGET_S, SLOW_FIT_S = 3.0, 1.6
FAULT_S = 30.0  # a failed request or a lost link shows within this


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _gen(p, n, seed):
    return sem.generate(sem.SemSpec(p=p, n=n, seed=seed))["x"]


def ragged_bucket():
    """The reference's padded ragged case: (xs, mask, n_valid, the datasets)."""
    raw = [_gen(p, n, seed=i) for i, (p, n) in enumerate(RAGGED)]
    xs = np.zeros((8, 16, 512), np.float32)
    mask = np.zeros((8, 16), bool)
    nv = np.zeros((8,), np.int32)
    for i, x in enumerate(raw):
        p, n = x.shape
        xs[i, :p, :n] = x
        mask[i, :p] = True
        nv[i] = n
    return xs, mask, nv, raw


def exact_batch():
    return np.stack([_gen(8, 256, seed=20 + i) for i in range(6)]).astype(np.float32)


def engine_requests():
    """Ragged requests of the reference's engine tests: every one padded in
    n, so a request's dispatch always takes the seams."""
    return [_gen(8 + (i % 3), 200 + 40 * (i % 2), seed=90 + i) for i in range(6)]


def sync_requests():
    return [_gen(8 + (i % 5), 200 + 40 * i, seed=60 + i) for i in range(6)]


def _numpy(res) -> dict:
    return {f: getattr(res, f).numpy() for f in FIELDS if getattr(res, f) is not None}


def _fit_numpy(f) -> dict:
    return {k: np.asarray(getattr(f, k)) for k in FIT_FIELDS}


# ---------------------------------------------------------------------------
# the ranks' jobs (module functions: the spawned ranks import them)
# ---------------------------------------------------------------------------


def job_cases(mesh, grid):
    """Every batched entry point under this grid's rules, on every rank."""
    mesh = make_local_mesh(*grid, device_type="cpu")
    rules = make_rules(CFG, mesh)
    xs, mask, nv, _ = ragged_bucket()
    out = {"rank": dist.get_rank(), "block": row_block(8, rules)[1:],
           "block6": row_block(6, rules)[1:],
           "pads": [batch_pad(b, SCFG, rules) for b in range(1, 9)]}
    for thr in (False, True):
        cfg = ParaLiNGAMConfig(min_bucket=8, threshold=thr)
        out[f"ragged|{thr}"] = _numpy(fit_batch(xs, cfg, mask=mask, n_valid=nv, rules=rules,
                                                device="cpu"))
    out["exact"] = _numpy(fit_batch(exact_batch(), CFG, rules=rules, device="cpu"))
    out["order_only"] = _numpy(causal_order_batch(xs, CFG, mask=mask, n_valid=nv, rules=rules,
                                                  device="cpu"))
    exe = aot_fit_batch(8, 16, 512, CFG, rules=rules, device="cpu")
    out["compiled"] = _numpy(exe(xs, n_valid=nv, mask=mask))
    for pow2 in (True, False):
        scfg = LingamServeConfig(min_p_bucket=8, min_n_bucket=64, pad_batch_pow2=pow2)
        eng = LingamEngine(CFG, scfg, rules, device="cpu")
        out[f"sync|{pow2}"] = [_fit_numpy(f) for f in eng.fit_many(sync_requests())]
    return out


def job_async(mesh, grid):
    """``AsyncLingamEngine(rules=)``: the leader serves every request from
    ``SUBMITTERS`` threads over two replicas; a follower's submit raises and
    its ``close()`` returns once the leader's has."""
    mesh = make_local_mesh(*grid, device_type="cpu")
    rules = make_rules(CFG, mesh)
    requests = engine_requests()
    eng = AsyncLingamEngine(CFG, SCFG, rules, batch_cfg=BatchingConfig(
        max_batch=8, max_queue=64, flush_interval=0.005), replicas=2,
        prewarm=[x.shape for x in requests], device="cpu")
    out = {"prewarm": eng.stats()["prewarm"]}
    if dist.get_rank() != 0:
        try:
            eng.submit(requests[0])
            out["submit_refused"] = False
        except ValueError:
            out["submit_refused"] = True
        eng.close()
        out["follower_ended"] = not eng._follower.is_alive()
        return out
    fits, errors = {}, []

    def submitter(w):
        try:
            for i in range(w, len(requests) * SUBMITTERS, SUBMITTERS):
                fits[i] = eng.fit(requests[i % len(requests)], timeout=100)
        except Exception as e:  # noqa: BLE001 — reported through `errors`
            errors.append(repr(e))

    threads = [threading.Thread(target=submitter, args=(w,)) for w in range(SUBMITTERS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(100)
    stats = eng.stats()
    eng.close(timeout=60)
    out.update(errors=errors, alive=sum(th.is_alive() for th in threads), stats=stats,
               fits={i: _fit_numpy(f) for i, f in fits.items()})
    return out


def _fault_engine(rules, **kwargs):
    """The fault jobs' engine: a bucket dispatches when two requests fill it,
    so the data ranks divide it and the ranks gather its results."""
    return AsyncLingamEngine(CFG, SCFG, rules, batch_cfg=BatchingConfig(
        max_batch=2, max_queue=64, flush_interval=1.0, max_retries=0), device="cpu",
        **kwargs)


def pair():
    """Two requests of one bucket, (8, 256)."""
    return engine_requests()[0:4:3]


def _outcome(eng, xs) -> dict:
    """``eng.fit_many(xs)``'s fits or error, and its seconds."""
    t0 = time.perf_counter()
    try:
        fits = eng.fit_many(xs, timeout=100)
        return {"fits": [_fit_numpy(f) for f in fits], "s": time.perf_counter() - t0}
    except Exception as e:  # noqa: BLE001 — the outcome under test
        return {"error": f"{type(e).__name__}: {e} <- {e.__cause__!r}",
                "s": time.perf_counter() - t0}


def _follower_close(eng) -> dict:
    """A follower's ``close()``: what it raised, and whether its loop ended."""
    t0 = time.perf_counter()
    try:
        eng.close(timeout=100)
        raised = None
    except Exception as e:  # noqa: BLE001 — the outcome under test
        raised = repr(e)
    return {"raised": raised, "ended": not eng._follower.is_alive(),
            "s": time.perf_counter() - t0}


def job_fit_faults(mesh, grid):
    """A fit that raises on the follower (the first dispatch), then on the
    leader (the second), then none: the first two pairs fail, the third is
    served, and the follower's ``close()`` ends it without an error."""
    rules = make_rules(CFG, make_local_mesh(*grid, device_type="cpu"))
    rank, calls, real = dist.get_rank(), [0], async_engine._fit_local

    def faulty(*args, **kwargs):
        calls[0] += 1
        if calls[0] == (2 if rank == 0 else 1):
            raise RuntimeError(f"injected fault on rank {rank}")
        return real(*args, **kwargs)

    async_engine._fit_local = faulty
    try:
        eng = _fault_engine(rules)
        if rank != 0:
            return _follower_close(eng)
        out = {tag: _outcome(eng, pair()) for tag in ("follower_fault", "leader_fault", "served")}
        eng.close(timeout=60)
        return out
    finally:
        async_engine._fit_local = real


def job_slow_fits(mesh, grid):
    """The leader's fits take ``SLOW_FIT_S`` under a watchdog of
    ``BUDGET_S`` over two replicas, and three batches of two are ready at
    once: the replica that waits for the link's lock must not be charged
    the wait."""
    rules = make_rules(CFG, make_local_mesh(*grid, device_type="cpu"))
    real = async_engine._fit_local

    def slow(*args, **kwargs):
        time.sleep(SLOW_FIT_S)
        return real(*args, **kwargs)

    eng = _fault_engine(rules, pool_cfg=ReplicaPoolConfig(replicas=2, dispatch_budget=BUDGET_S))
    if dist.get_rank() != 0:
        return _follower_close(eng)
    async_engine._fit_local = slow
    try:
        tickets = [eng.submit(x) for x in engine_requests()]
        fits = [_fit_numpy(t.result(100)) for t in tickets]
    finally:
        async_engine._fit_local = real
    stats = eng.stats()
    eng.close(timeout=60)
    return {"fits": fits, "stats": stats}


def job_link_lost(mesh, grid):
    """The leader's link fails between the header and the bucket: its
    request fails with ``EngineClosed`` within seconds, so does the next at
    once, and every follower's loop ends, its ``close()`` raising the
    collective's error. The leader's process stays up until the followers
    return (a barrier), so only the closed link can end their wait."""
    rules = make_rules(CFG, make_local_mesh(*grid, device_type="cpu"))
    eng = _fault_engine(rules)
    if dist.get_rank() != 0:
        out = _follower_close(eng)
        dist.barrier()
        return out

    def lost(head, packed=None):
        raise ConnectionError("injected: the link is lost")

    eng.link.bucket = lost
    out = {tag: _outcome(eng, pair()) for tag in ("lost", "after")}
    eng.close(timeout=60)
    dist.barrier()
    return out


# ---------------------------------------------------------------------------
# the reference's sharded fit_batch (a subprocess on fake XLA devices)
# ---------------------------------------------------------------------------

_REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys
sys.path.insert(0, "src")
sys.path.insert(0, "tests")
import numpy as np
import jax
from jax.sharding import Mesh
from repro.core.paralingam import ParaLiNGAMConfig, fit_batch
from repro.dist.sharding import make_rules
from test_torch_lingam_sharded import ragged_bucket

xs, mask, nv, _ = ragged_bucket()
out = {}
for grid in GRIDS:
    mesh = Mesh(np.array(jax.devices()[:grid[0] * grid[1]]).reshape(grid), ("data", "model"))
    for thr in (False, True):
        cfg = ParaLiNGAMConfig(min_bucket=8, threshold=thr)
        res = fit_batch(xs, cfg, mask=mask, n_valid=nv, rules=make_rules(cfg, mesh))
        out[f"{grid[0]}x{grid[1]}|{thr}|orders"] = np.asarray(res.orders)
        out[f"{grid[0]}x{grid[1]}|{thr}|b"] = np.asarray(res.b)
np.savez(OUT, **out)
"""


def start_reference(path):
    code = f"GRIDS, OUT = {GRIDS!r}, {str(path)!r}\n" + textwrap.dedent(_REFERENCE)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{"ranks": {grid: [rank results]}, "reference": {key: array}}``."""
    tmp = tmp_path_factory.mktemp("lingam_sharded")
    ref_path = tmp / "reference.npz"
    proc = start_reference(ref_path)
    try:
        ranks = {}
        for world, grids in WORLDS.items():
            jobs = []
            for grid in grids:
                jobs += [(f"cases|{grid_id(grid)}", job_cases, {"grid": grid}),
                         (f"async|{grid_id(grid)}", job_async, {"grid": grid})]
                if grid == FAULT_GRID:  # the link-lost job closes its group last
                    jobs += [(f"{name}|{grid_id(grid)}", fn, {"grid": grid}) for name, fn in (
                        ("fit_faults", job_fit_faults), ("slow_fits", job_slow_fits),
                        ("link_lost", job_link_lost))]
            got = run_grid(grids[0], jobs, tmp / f"world{world}", pg_timeout=PG_TIMEOUT)
            for grid in grids:
                ranks[grid] = [{k.split("|")[0]: v for k, v in r.items()
                                if k.endswith(grid_id(grid))} for r in got]
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        with np.load(ref_path) as data:
            reference = {k: data[k] for k in data.files}
    finally:
        if proc.poll() is None:
            proc.kill()
    return {"ranks": ranks, "reference": reference}


@pytest.fixture(scope="module")
def one_rank():
    """The same calls on one rank, in this process."""
    xs, mask, nv, _ = ragged_bucket()
    out = {}
    for thr in (False, True):
        cfg = ParaLiNGAMConfig(min_bucket=8, threshold=thr)
        out[f"ragged|{thr}"] = _numpy(fit_batch(xs, cfg, mask=mask, n_valid=nv, device="cpu"))
    out["exact"] = _numpy(fit_batch(exact_batch(), CFG, device="cpu"))
    out["order_only"] = _numpy(causal_order_batch(xs, CFG, mask=mask, n_valid=nv,
                                                  device="cpu"))
    out["compiled"] = out["ragged|False"]
    for pow2 in (True, False):
        scfg = LingamServeConfig(min_p_bucket=8, min_n_bucket=64, pad_batch_pow2=pow2)
        out[f"sync|{pow2}"] = [_fit_numpy(f) for f in
                               LingamEngine(CFG, scfg, device="cpu").fit_many(sync_requests())]
    out["async"] = [_fit_numpy(dispatch_bucket([x], *bucket_shape(*x.shape, SCFG), CFG, SCFG,
                                               device="cpu")[0])
                    for x in engine_requests()]
    return out


def _assert_equal(got: dict, want: dict, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (what, k)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def test_pack_rows_round_trip_and_one_rank_gather():
    """``pack_rows``/``unpack_rows`` return every tensor's rows bit for
    bit, whatever the dtypes; ``gather_rows`` without batch ranks is the
    identity; ``row_block`` without a mesh is every row."""
    g = torch.Generator().manual_seed(0)
    ts = [torch.randn(5, 3, 4, generator=g), torch.arange(5, dtype=torch.int64),
          torch.randint(0, 9, (5, 7), generator=g, dtype=torch.int32), torch.rand(5, 2) > 0.5]
    buf = pack_rows(ts)
    assert buf.dtype == torch.uint8 and buf.shape == (5, 48 + 8 + 28 + 2)
    back = unpack_rows(buf, [(t.dtype, t.shape[1:]) for t in ts])
    assert all(b.dtype == t.dtype and torch.equal(b, t) for b, t in zip(back, ts))
    assert all(torch.equal(a, b) for a, b in zip(gather_rows(ts, NO_SHARDING), ts))
    assert row_block(6, NO_SHARDING) == (NO_SHARDING, 0, 6)


@pytest.mark.parametrize("grid", GRIDS, ids=grid_id)
def test_rank_blocks(runs, grid):
    """Each rank fits its data block of the 8 datasets; 6 datasets are cut
    where the data ranks divide 6, else every rank takes all of them."""
    data = grid[0]
    for r in runs["ranks"][grid]:
        d = r["cases"]["rank"] // grid[1]
        assert r["cases"]["block"] == (d * 8 // data, (d + 1) * 8 // data)
        want6 = (d * 6 // data, (d + 1) * 6 // data) if 6 % data == 0 else (0, 6)
        assert r["cases"]["block6"] == want6


@pytest.mark.parametrize("case", ["ragged|False", "ragged|True", "exact", "order_only",
                                  "compiled"])
@pytest.mark.parametrize("grid", GRIDS, ids=grid_id)
def test_sharded_batch_equals_one_rank(runs, one_rank, grid, case):
    for r in runs["ranks"][grid]:
        _assert_equal(r["cases"][case], one_rank[case], (grid, case, r["cases"]["rank"]))


@pytest.mark.parametrize("threshold", [False, True])
@pytest.mark.parametrize("grid", GRIDS, ids=grid_id)
def test_sharded_orders_equal_the_reference(runs, grid, threshold):
    key = f"{grid_id(grid)}|{threshold}"
    want_orders, want_b = runs["reference"][key + "|orders"], runs["reference"][key + "|b"]
    _, mask, _, raw = ragged_bucket()
    got = runs["ranks"][grid][0]["cases"][f"ragged|{threshold}"]
    for i, x in enumerate(raw):
        p = x.shape[0]
        assert list(got["orders"][i, :p]) == list(want_orders[i, :p]), (grid, i)
        np.testing.assert_allclose(got["b"][i, :p, :p], want_b[i, :p, :p], rtol=0,
                                   atol=B_ATOL)


@pytest.mark.parametrize("pow2", [True, False])
@pytest.mark.parametrize("grid", GRIDS, ids=grid_id)
def test_sync_engine_on_every_rank_equals_one_rank(runs, one_rank, grid, pow2):
    want = one_rank[f"sync|{pow2}"]
    for r in runs["ranks"][grid]:
        got = r["cases"][f"sync|{pow2}"]
        assert len(got) == len(want) == len(sync_requests())
        for g, w in zip(got, want):
            _assert_equal(g, w, (grid, pow2))


@pytest.mark.parametrize("grid", GRIDS, ids=grid_id)
def test_async_engine_leader_serves_and_followers_end(runs, one_rank, grid):
    leader, followers = runs["ranks"][grid][0]["async"], runs["ranks"][grid][1:]
    n = SUBMITTERS * len(engine_requests())
    assert leader["errors"] == [] and leader["alive"] == 0
    st = leader["stats"]
    assert st["delivered"] == st["admitted"] == n and st["kernel_bypass"] == 0
    assert st["pool"]["replicas"] and len(st["pool"]["replicas"]) == 2
    assert sorted(leader["fits"]) == list(range(n))
    for i, f in leader["fits"].items():
        _assert_equal(f, one_rank["async"][i % len(engine_requests())], (grid, i))
    buckets = len({bucket_shape(*x.shape, SCFG) for x in engine_requests()})
    for r in [runs["ranks"][grid][0]] + followers:
        assert r["async"]["prewarm"]["buckets"] == buckets
        assert r["async"]["prewarm"]["executables"] == 4 * buckets  # b_pad 1, 2, 4, 8
    for r in followers:
        assert r["async"]["submit_refused"] and r["async"]["follower_ended"]


def test_dispatch_through_a_warmed_up_bucket():
    """``dispatch_bucket(compiled=)`` takes the reference's executables and
    leaves them unused: the port compiles nothing per shape, so the fits
    equal those without them bit for bit; an exact entry refuses the
    seams."""
    pair = engine_requests()[0:4:3]  # p=8, n=200 and 240: the (8, 256) bucket
    exe = aot_fit_batch(2, 8, 256, CFG, device="cpu")
    got = dispatch_bucket(pair, 8, 256, CFG, SCFG, compiled={(2, 8, 256): exe}, device="cpu")
    cold = dispatch_bucket(pair, 8, 256, CFG, SCFG, device="cpu")
    for g, c in zip(got, cold):
        _assert_equal(_fit_numpy(g), _fit_numpy(c), "compiled")
    exact = aot_fit_batch(2, 8, 256, CFG, padded=False, device="cpu")
    assert not exact.padded and exact.rules is None
    with pytest.raises(ValueError, match="exact"):
        exact(np.zeros((2, 8, 256), np.float32), n_valid=np.full((2,), 256))


@pytest.mark.parametrize("grid", GRIDS, ids=grid_id)
def test_batch_pad_follows_the_data_ranks(runs, grid):
    """Under rules, a bucket pads to a power of two (at most ``max_batch``)
    only where the data ranks do not divide its request count."""
    want = [b if b % grid[0] == 0 else min(next_pow2(b), SCFG.max_batch) for b in range(1, 9)]
    for r in runs["ranks"][grid]:
        assert r["cases"]["pads"] == want


@pytest.mark.parametrize("b", [1, 3, 5, 6, 7, 8])
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("pow2", [True, False])
def test_batch_pad_pads_only_a_sharded_dispatch(b, shards, pow2):
    """One rank never pads (the port compiles nothing per shape); a sharded
    dispatch pads with ``pad_batch_pow2`` where its data ranks do not
    divide ``b``, capped at ``max_batch``."""
    scfg = LingamServeConfig(max_batch=6, pad_batch_pow2=pow2)
    rules = None if shards == 1 else SimpleNamespace(batch_shards=shards)
    want = min(next_pow2(b), 6) if pow2 and b % shards else b
    assert batch_pad(b, scfg, rules) == want
    assert batch_pad(b, scfg, NO_SHARDING) == batch_pad(b, scfg) == b


def test_async_engine_fit_faults_keep_the_ranks_in_step(runs, one_rank):
    """A fit that raises on one rank fails the leader's request within
    seconds, naming the rank, instead of leaving the others in the gather;
    the next request is served as one rank serves it, and the follower ends
    without an error."""
    leader, follower = (r["fit_faults"] for r in runs["ranks"][FAULT_GRID])
    for tag, rank in (("follower_fault", 1), ("leader_fault", 0)):
        assert "DispatchFailed" in leader[tag]["error"], leader[tag]
        assert f"rank(s) {{{rank}: " in leader[tag]["error"], leader[tag]
        assert f"injected fault on rank {rank}" in leader[tag]["error"], leader[tag]
        assert leader[tag]["s"] < FAULT_S
    for got, i in zip(leader["served"]["fits"], (0, 3)):
        _assert_equal(got, one_rank["async"][i], "served")
    assert follower["raised"] is None and follower["ended"]


def test_async_engine_slow_fits_expire_no_watchdog(runs, one_rank):
    """Two replicas, fits longer than half the budget: no dispatch is
    charged its wait for the link, so nothing expires or runs twice."""
    leader = runs["ranks"][FAULT_GRID][0]["slow_fits"]
    pool = leader["stats"]["pool"]
    assert pool["watchdog_expiries"] == 0 and pool["zombie_results"] == 0, pool
    assert leader["stats"]["delivered"] == len(engine_requests())
    for got, want in zip(leader["fits"], one_rank["async"]):
        _assert_equal(got, want, "slow")
    follower = runs["ranks"][FAULT_GRID][1]["slow_fits"]
    assert follower["raised"] is None and follower["ended"]


def test_async_engine_lost_link_fails_fast_and_ends_the_followers(runs):
    leader, follower = (r["link_lost"] for r in runs["ranks"][FAULT_GRID])
    assert "EngineClosed" in leader["lost"]["error"] and "injected" in leader["lost"]["error"]
    assert "EngineClosed" in leader["after"]["error"] and "is closed" in leader["after"]["error"]
    assert leader["lost"]["s"] < FAULT_S and leader["after"]["s"] < FAULT_S
    assert follower["ended"] and follower["raised"] is not None and follower["s"] < FAULT_S
