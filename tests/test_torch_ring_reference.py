"""The port's messaging ring over several ranks (``dist/ring_order.py``,
``dist/ring.py``) held against the JAX package's ring, and what goes with
it: the collectives it issues, its device rule and its update's plain
version.

Grids (pods, ring, model) = (1, 2, 1) on one spawn of 2 gloo CPU ranks, and
(1, 4, 1), (2, 2, 1) (the two-level ring) and (1, 2, 2) (samples over
``model``) on one spawn of 4 (``test_torch_tp.run_grid``; each job builds
its grid's ``make_ring_mesh`` and passes ``device="cpu"``). Beside them a
subprocess runs ``repro.dist.ring_order.causal_order_ring`` on 4 fake XLA
devices reshaped to each grid.

What is held:

* At every grid, dense and ``threshold=True`` (chunk 16, gamma0 1e-6, the
  cases of ``tests/test_torch_ring_threshold.py``), at p=8 and p=17 (the
  problems of ``tests/test_ring_order.py``): every rank's order,
  comparisons, rounds, per-iteration comparisons, rounds and shift counts
  and the summed ``wire`` counters equal the JAX package's exactly (the
  counters are integers; at these sizes both float32 orders agree).
* A ``CollectiveLedger`` around an order: a one-shard order (a gloo world
  of one, every ring dimension of size 1) records no collective; a (1, 2,
  1) dense order records, on every rank, one all-gather of the scores, one
  all-gather of the root column and one all-reduce of the root's row per
  iteration, two all-gathers per stage change (the compaction), and one
  receive per tensor of each shift (two per overlapped hop, the block and
  its entropies; one per sequential hop, the credits), as
  ``make_hier_plan(1, 2).hop_counts()`` counts the hops.
* Every rank's update of its block through the new ``_update_shard`` (the
  plain version, and the ``hopper`` route through the kernel's wrapper,
  which runs the plain version on the CPU) is bit-equal to the ring's
  torch ops before the update kernel took them, at every grid.
* Without ``device`` the ring's entry points raise on this host without a
  card, under a gloo process group, and never move to the CPU on their
  own; the wrapper's fake branch allocates what a launch writes and notes
  its FLOPs.

This module imports no JAX at its top: the spawned ranks import it.
"""

import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import sem
from repro_torch.core.covariance import VAR_EPS, cov_matrix, normalize, rank1_gates
from repro_torch.core.paralingam import (
    ParaLiNGAMConfig,
    _compact,
    causal_order,
    causal_order_scan,
    fit,
)
from repro_torch.dist.ring import Shards, ring_find_root, ring_find_root_jit, ring_mesh
from repro_torch.dist.ring_order import _update_shard, causal_order_ring
from repro_torch.kernels import _fake, ops
from repro_torch.kernels import covupdate as cu
from repro_torch.launch.mesh import make_ring_mesh
from repro_torch.utils.collectives import CollectiveLedger
from repro_torch.utils.schedule import make_hier_plan, make_schedule
from test_torch_tp import ROOT, grid_id, run_grid

#: (pods, ring, model) grids, by the world size that runs them.
WORLDS = {2: ((1, 2, 1),), 4: ((1, 4, 1), (2, 2, 1), (1, 2, 2))}
GRIDS = tuple(g for gs in WORLDS.values() for g in gs)
#: p -> (n, min_bucket): the problems and seeds of tests/test_ring_order.py.
CASES = {8: (2500, 8), 17: (1800, 8)}
THRESHOLD = dict(threshold=True, chunk=16, gamma0=1e-6)
#: The grid whose collectives ``CollectiveLedger`` counts.
LEDGER_GRID = (1, 2, 1)


def problem(p: int):
    n, _ = CASES[p]
    return sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=p))["x"]


def ring_cfg(p: int, threshold: bool) -> dict:
    return dict(order_backend="ring", min_bucket=CASES[p][1], score_backend="torch",
                **(THRESHOLD if threshold else {}))


def case_key(grid, p: int, threshold: bool) -> str:
    return f"{grid_id(grid)}|{p}|{threshold}"


def _summary(res) -> dict:
    return {"order": list(res.order), "comparisons": int(res.comparisons),
            "rounds": int(res.rounds), "converged": bool(res.converged),
            "wire": {k: v for k, v in res.wire.items() if k != "overlap_frac"},
            "per_iteration": [(int(it["comparisons"]), int(it["rounds"]),
                               tuple(int(h) for h in it["hops"])) for it in res.per_iteration]}


# ---------------------------------------------------------------------------
# the rank jobs (fn(mesh, **kw): the mesh is test_torch_tp's, unused)
# ---------------------------------------------------------------------------


def job_orders(mesh, grid):
    """Every case's ring order on this rank over ``make_ring_mesh(*grid)``."""
    ring = make_ring_mesh(*grid, device_type="cpu")
    return {case_key(grid, p, thr): _summary(causal_order_ring(
        problem(p), ParaLiNGAMConfig(**ring_cfg(p, thr)), mesh=ring, device="cpu"))
        for p in CASES for thr in (False, True)}


def job_ledger(mesh, grid):
    """The records of a ``CollectiveLedger`` around one dense p=17 order."""
    ring = make_ring_mesh(*grid, device_type="cpu")
    cfg = ParaLiNGAMConfig(**ring_cfg(17, False))
    causal_order_ring(problem(17), cfg, mesh=ring, device="cpu")  # the mesh's groups exist
    with CollectiveLedger() as ledger:
        res = causal_order_ring(problem(17), cfg, mesh=ring, device="cpu")
    return {"records": ledger.records, "order": list(res.order)}


def _old_update_shard(x_loc, c_loc, mask, root, shards: Shards, n: int):
    """The ring's update of its own rows as torch ops, before the update
    kernel's ring mode took it: the reference of the plain version."""
    m_l, m = c_loc.shape
    dev = x_loc.device
    row_ids = shards.flat * m_l + torch.arange(m_l, device=dev)
    owns = (root // m_l) == shards.flat
    r_l = (root % m_l).reshape(1)
    x_root = shards.sum_rows(torch.where(owns, torch.index_select(x_loc, 0, r_l)[0], 0.0))
    col = torch.index_select(c_loc, 1, root.reshape(1))[:, 0]
    live = mask[shards.flat * m_l:(shards.flat + 1) * m_l] & (row_ids != root)
    b, s_row = rank1_gates(col, live)
    out = (x_loc - b[:, None] * x_root[None, :]) / s_row[:, None]
    sq = torch.sum(torch.square(out), dim=-1)
    if shards.sample_group is not None:
        dist.all_reduce(sq, group=shards.sample_group)
    scale = torch.where(live, torch.rsqrt(torch.clamp(sq / max(n - 1, 1), min=VAR_EPS)), 1.0)
    x2 = out * scale[:, None]
    cols = torch.arange(m, device=dev)
    b_col, s_col = rank1_gates(shards.gather_rows(col), mask & (cols != root))
    c2 = (c_loc - b[:, None] * b_col[None, :]) / (s_row[:, None] * s_col[None, :])
    c2 = torch.where(row_ids[:, None] == cols[None, :], 1.0, torch.clamp(c2, -1.0, 1.0))
    return x2, c2


def job_update(mesh, grid):
    """This rank's first update of the p=17 problem's 32-row stage buffer
    (rows 17.. the padding), four roots in turn (live rows of the first
    blocks, the last live row, and one with a dead row beside it), through
    the old ops, the new plain version and the ``hopper`` route (in place):
    whether each new result equals the old bit for bit."""
    ring = make_ring_mesh(*grid, device_type="cpu")
    shards = Shards(ring, sample_sharded=True)
    x = torch.as_tensor(problem(17), dtype=torch.float32)
    n = x.shape[1]
    xn = normalize(x)
    c = cov_matrix(xn)
    m = 32
    sel = _compact(torch.ones((1, 17), dtype=torch.bool), m)[0]
    xg, cg = xn[sel], c[sel][:, sel]
    m_l, n_loc = m // shards.blocks, n // shards.model
    mi = shards.coord["model"]
    own = slice(shards.flat * m_l, (shards.flat + 1) * m_l)
    x_loc = xg[own, mi * n_loc:(mi + 1) * n_loc].contiguous()
    c_loc = cg[own].contiguous()
    out = {}
    for root, dead in ((1, None), (9, None), (16, None), (3, 4)):
        mask = torch.arange(m) < 17
        if dead is not None:
            mask[dead] = False
        root = torch.tensor(root)
        want = _old_update_shard(x_loc, c_loc, mask, root, shards, n)
        plain = _update_shard(x_loc, c_loc, mask, root, shards, n, "torch")
        xk, ck = x_loc.clone(), c_loc.clone()
        kernel = _update_shard(xk, ck, mask, root, shards, n, "hopper")
        out[int(root)] = {
            "plain": all(torch.equal(a, b) for a, b in zip(plain, want)),
            "hopper": all(torch.equal(a, b) for a, b in zip(kernel, want)),
            "in_place": kernel[0].data_ptr() == xk.data_ptr()
            and kernel[1].data_ptr() == ck.data_ptr(),
            "live_rows": int((mask[own] & (torch.arange(m)[own] != root)).sum())}
    return out


# ---------------------------------------------------------------------------
# the reference on fake XLA devices (a subprocess)
# ---------------------------------------------------------------------------

_REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import pickle
import sys
sys.path.insert(0, "src")
sys.path.insert(0, "tests")
import numpy as np
import jax
from jax.sharding import Mesh
import repro
from repro.dist.ring_order import causal_order_ring
from test_torch_ring_reference import CASES, GRIDS, _summary, case_key, problem, ring_cfg

out = {}
for grid in GRIDS:
    devs = np.array(jax.devices()[:int(np.prod(grid))]).reshape(grid)
    mesh = Mesh(devs, ("pod", "ring", "model"))
    for p in CASES:
        for thr in (False, True):
            cfg = {k: v for k, v in ring_cfg(p, thr).items() if k != "score_backend"}
            res = causal_order_ring(problem(p), repro.ParaLiNGAMConfig(**cfg), mesh)
            out[case_key(grid, p, thr)] = _summary(res)
with open(OUT, "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{"ranks": {grid: [rank results]}, "reference": {case: summary}}``."""
    import pickle

    tmp = tmp_path_factory.mktemp("ring_reference")
    ref_path = tmp / "reference.pkl"
    code = f"OUT = {str(ref_path)!r}\n" + textwrap.dedent(_REFERENCE)
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT,
                            env=dict(os.environ, JAX_PLATFORMS="cpu"))
    try:
        ranks = {}
        for world, grids in WORLDS.items():
            jobs = []
            for grid in grids:
                jobs += [(f"orders|{grid_id(grid)}", job_orders, {"grid": grid}),
                         (f"update|{grid_id(grid)}", job_update, {"grid": grid})]
                if grid == LEDGER_GRID:
                    jobs.append((f"ledger|{grid_id(grid)}", job_ledger, {"grid": grid}))
            got = run_grid((world, 1), jobs, tmp / f"world{world}")
            for grid in grids:
                ranks[grid] = [{k.split("|")[0]: v for k, v in r.items()
                                if k.endswith("|" + grid_id(grid))} for r in got]
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        with open(ref_path, "rb") as f:
            reference = pickle.load(f)
    finally:
        if proc.poll() is None:
            proc.kill()
    return {"ranks": ranks, "reference": reference}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("threshold", [False, True], ids=["dense", "threshold"])
@pytest.mark.parametrize("grid", GRIDS, ids=grid_id)
def test_ring_equals_reference_ring(runs, grid, threshold):
    """Orders, comparisons, rounds, the per-iteration counters and ``wire``
    of every rank equal the JAX package's ring on the same grid."""
    for p in CASES:
        want = runs["reference"][case_key(grid, p, threshold)]
        for r in runs["ranks"][grid]:
            assert r["orders"][case_key(grid, p, threshold)] == want, (grid, p, threshold)
        assert want["converged"]


@pytest.mark.parametrize("grid", GRIDS, ids=grid_id)
def test_wire_counts_the_plan_hops(runs, grid):
    """Each dense iteration shifts ``make_hier_plan``'s hops once; each
    threshold iteration once per round."""
    hc = make_hier_plan(grid[0], grid[1]).hop_counts()
    hops = (hc["intra_ovl"], hc["intra_seq"], hc["cross_ovl"], hc["cross_seq"])
    for p in CASES:
        for thr in (False, True):
            res = runs["ranks"][grid][0]["orders"][case_key(grid, p, thr)]
            for _, rounds, h in res["per_iteration"]:
                assert h == tuple(v * (rounds if thr else 1) for v in hops)


def _ledger_want(p: int, grid) -> dict:
    """Records by op of one dense order at ``grid`` (one row block per
    ring rank, the samples whole)."""
    stages = make_schedule(p, CASES[p][1], ring=grid[1], pods=grid[0]).stages
    compactions = sum(1 for a, b in zip(stages, stages[1:]) if a[0] != b[0])
    hc = make_hier_plan(grid[0], grid[1]).hop_counts()
    per_iteration = 2 * (hc["intra_ovl"] + hc["cross_ovl"]) + hc["intra_seq"] + hc["cross_seq"]
    return {"all-gather": 2 * (p - 1) + 2 * compactions, "all-reduce": p - 1,
            "collective-permute": (p - 1) * per_iteration}


def test_ledger_counts_the_plan_and_the_compactions(runs):
    by_op = []
    for r in runs["ranks"][LEDGER_GRID]:
        ops_ = {}
        for rec in r["ledger"]["records"]:
            ops_[rec["op"]] = ops_.get(rec["op"], 0) + 1
            assert rec["group_size"] == 2
        by_op.append(ops_)
    assert by_op[0] == by_op[1] == _ledger_want(17, LEDGER_GRID)


@pytest.mark.parametrize("grid", GRIDS, ids=grid_id)
def test_update_plain_version_equals_the_old_ops(runs, grid):
    """Every rank's block update, four roots each: the plain version and the
    ``hopper`` route (in place) give the old torch ops' bits."""
    for r in runs["ranks"][grid]:
        for root, got in r["update"].items():
            assert got["plain"] and got["hopper"] and got["in_place"], (grid, root)
    assert any(got["live_rows"] for r in runs["ranks"][grid] for got in r["update"].values())


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo process group of one rank in this process."""
    init = tmp_path_factory.mktemp("ring_world1") / "init"
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=0, world_size=1)
    try:
        yield make_ring_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_one_shard_ledger_is_empty(world1):
    """Every ring dimension of size 1: no collective, the no-group order."""
    cfg = ParaLiNGAMConfig(**ring_cfg(17, False))
    causal_order_ring(problem(17), cfg, mesh=world1, device="cpu")
    with CollectiveLedger() as ledger:
        got = causal_order_ring(problem(17), cfg, mesh=world1, device="cpu")
        thr = causal_order_ring(problem(8), ParaLiNGAMConfig(**ring_cfg(8, True)),
                                mesh=world1, device="cpu")
    assert ledger.records == []
    scan = causal_order_scan(problem(17), ParaLiNGAMConfig(min_bucket=8, score_backend="torch"),
                             device="cpu")
    assert got.order == scan.order and got.converged and thr.converged


def test_row_collectives_of_a_group_of_one_return_their_input(world1):
    shards = Shards(world1)
    t = torch.arange(6.0)
    with CollectiveLedger() as ledger:
        assert shards.gather_rows(t) is t and shards.sum_rows(t) is t
    assert ledger.calls == 0


@pytest.mark.parametrize("entry", ["causal_order_ring", "causal_order", "fit",
                                   "ring_find_root", "ring_find_root_jit"])
def test_ring_entry_points_need_a_card_without_device(world1, entry):
    """Under a gloo group, without ``device`` the ring runs on the card, so on
    this host it raises the device error instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: without device the ring runs on it")
    x = problem(8)
    cfg = ParaLiNGAMConfig(**ring_cfg(8, False))
    xn = normalize(torch.as_tensor(x, dtype=torch.float32))
    args = (xn, cov_matrix(xn), torch.ones(8, dtype=torch.bool))
    calls = {"causal_order_ring": lambda: causal_order_ring(x, cfg, mesh=world1),
             "causal_order": lambda: causal_order(x, cfg),
             "fit": lambda: fit(x, cfg),
             "ring_find_root": lambda: ring_find_root(*args, world1),
             "ring_find_root_jit": lambda: ring_find_root_jit(world1)(*args)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_ring_mesh_device_type_is_the_callers(world1):
    """``ring_mesh`` keeps a caller's mesh, builds on the device type the
    caller names, and takes a given mesh's otherwise: never the process
    group's backend (gloo here)."""
    ranks = torch.arange(1).reshape(1, 1, 1)
    assert ring_mesh(world1, ranks) is world1
    assert ring_mesh(None, ranks, device_type="cpu").device_type == "cpu"
    flat = ring_mesh(world1, ranks.reshape(1, 1), names=("ring", "model"))
    assert flat.device_type == "cpu" and flat.mesh_dim_names == ("ring", "model")


def _ring_inputs(seed=3, m_l=8, m=16, n_loc=40, row0=8):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m_l, n_loc, generator=g)
    c = torch.clamp(torch.randn(m_l, m, generator=g) * 0.3, -0.9, 0.9)
    live = torch.rand(m_l, generator=g) > 0.2
    b, s_row = rank1_gates(c[:, 3], live)
    b_col, s_col = rank1_gates(torch.clamp(torch.randn(m, generator=g) * 0.3, -0.9, 0.9),
                               torch.ones(m, dtype=torch.bool))
    return (x, c, torch.randn(n_loc, generator=g), b, s_row, b_col, s_col, live), row0


def test_ring_update_wrapper_runs_its_plain_version_on_the_cpu():
    """On CPU tensors ``ops.ring_update`` is ``ring_update_ref``, with and
    without a ``reduce``, out of place and in place; a bad shape raises."""
    args, row0 = _ring_inputs()
    for reduce in (None, lambda sq: sq.mul_(2.0)):
        want = cu.ring_update_ref(*args, row0=row0, n=80, reduce=reduce)
        got = ops.ring_update(*args, row0=row0, n=80, reduce=reduce)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        xi, ci = args[0].clone(), args[1].clone()
        out = ops.ring_update(xi, ci, *args[2:], row0=row0, n=80, reduce=reduce, inplace=True)
        assert out[0] is xi and out[1] is ci
        assert torch.equal(xi, want[0]) and torch.equal(ci, want[1])
    assert torch.all(torch.diagonal(want[1][:, row0:]) == 1)
    with pytest.raises(ValueError, match="outside"):
        ops.ring_update(*args, row0=12, n=80)
    with pytest.raises(ValueError, match="want x_loc"):
        ops.ring_update(args[0], args[1], args[2][:-1], *args[3:], row0=row0, n=80)


def test_ring_update_fake_branch_notes_a_launch():
    """On fake tensors (the dry run's route) the wrapper allocates what the
    launch writes, in place or not, notes ``ring_update`` with
    ``flops(x, c)``, and counts no launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    args, row0 = _ring_inputs()
    before = cu.RING_LAUNCHES
    with FakeTensorMode() as mode, _fake.stand_in(), _fake.recording() as calls:
        fake = [mode.from_tensor(a) for a in args]
        x2, c2 = ops.ring_update(*fake, row0=row0, n=80)
        xi, ci = ops.ring_update(*fake, row0=row0, n=80, inplace=True)
    assert x2.shape == args[0].shape and c2.shape == args[1].shape
    assert xi is fake[0] and ci is fake[1]
    assert calls == [("ring_update", cu.flops(args[0].numel(), args[1].numel()))] * 2
    assert cu.RING_LAUNCHES == before


def test_ring_bytes_count_each_live_byte_once():
    """The bound's bytes: the root row, c read and written, the gates, mask
    and sums, and each live row of x read and written once."""
    assert cu.ring_bytes(0, 4, 8, 10) == 4 * 10 + 8 * 4 * 8 + 4 * (12 + 16) + 4
    assert cu.ring_bytes(3, 4, 8, 10) - cu.ring_bytes(0, 4, 8, 10) == 8 * 3 * 10
    assert math.isclose(cu.flops(10, 20), 6 * 30)
