"""The messaging ring of ``repro_torch`` (``dist/ring.py``,
``dist/ring_order.py``) on the CPU, dense, held against the port's scan and
against ``repro``: the cases of ``tests/test_ring_order.py``,
``tests/test_hier_ring.py`` and the ring part of ``tests/test_dist_unit.py``.

Grids (pods, ring, model): (1, 1, 1) in this process, and gloo ranks at
(1, 2, 1), (1, 4, 1), (2, 2, 1), (1, 2, 2) and (2, 2, 2), one spawn per grid
running all of its cases (``run_grid``: one process per rank, one torch
thread each, ``file://`` init under the test's temporary directory, a join
timeout so that a hung rank fails the test instead of holding the run). The
ranks start from a ``forkserver`` that imported torch and this module once,
so a grid does not pay a torch import per rank; the server process itself
is a fresh interpreter with no threads, so forking it is safe.

What is held:

* Every ring order equals the port's own scan order under the same config,
  on every rank. Orders equal ``repro``'s at p=8 and 17; at p=64 (seed 64)
  the float32 orders of the two packages may split at a near-tie
  (ROADMAP.md queue 3), so the p=64 rings are held to the port's scan only.
* The (1, 1, 1) ring's order and per-iteration counters equal
  ``repro.dist.ring_order.causal_order_ring`` on one JAX device.
* The shift counters of every iteration equal
  ``repro.utils.schedule.make_hier_plan(P, R).hop_counts()``.
* ``ring_find_root`` gives ``repro``'s ``find_root_dense`` root on the same
  numpy inputs, and its scores within rtol 2e-4 of ``repro``'s and of the
  port's own dense evaluation (the reference's own tolerance for a ring
  against its dense evaluation), sample-sharded grids included. The input
  is the size of ``tests/test_distributed.py``'s find-root (p=32, n=1024,
  seed 0) drawn from the SEM, where every score but the root's (exactly 0)
  is far above the float32 rounding of the entropies: on Gaussian data
  S ~ 1e-7 sits at that rounding and a relative tolerance across packages
  tests nothing.
* The sample-shard seam (``group=``) gives ``repro.core.pairwise``'s full-n
  values within rtol 1e-5, atol 1e-6 (float32 rounding of two moment sums
  of n/2 terms each, added, against one sum of n terms).

This module imports no JAX at its top: the spawned ranks import it (the
ranks run ``_rank_main``), and JAX is for the parent's references only.
"""

import functools
import math
import multiprocessing as mp
import os
import pickle
import time
import traceback
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import sem
from repro_torch.core import pairwise as tpw
from repro_torch.core.paralingam import (
    ConfigError,
    ParaLiNGAMConfig,
    causal_order,
    causal_order_scan,
    config_from_reference,
    fit,
)
from repro_torch.dist import NO_SHARDING, ShardingRules, make_rules
from repro_torch.dist.ring import process_pair, ring_find_root, ring_find_root_jit, ring_mesh, ring_steps
from repro_torch.dist.ring_order import causal_order_ring, ring_order_stages
from repro_torch.launch.mesh import make_local_mesh, make_ring_mesh

# p -> (n, min_bucket); the problems and seeds of tests/test_ring_order.py.
CASES = {8: (2500, 8), 17: (1800, 8), 64: (1000, 32)}
PS = sorted(CASES)
#: (pods, ring, model) grids run on spawned gloo ranks.
GRIDS = ((1, 2, 1), (1, 4, 1), (2, 2, 1), (1, 2, 2), (2, 2, 2))
#: Seconds a grid's ranks may take before the test fails.
JOIN_TIMEOUT = 300


def grid_id(grid) -> str:
    return "x".join(map(str, grid))


@functools.cache
def problem(p: int):
    """``(x, min_bucket)`` of the case of size p."""
    n, min_bucket = CASES[p]
    return sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=p))["x"], min_bucket


# ---------------------------------------------------------------------------
# spawned gloo ranks
# ---------------------------------------------------------------------------


def _result(res) -> dict:
    return {"order": res.order, "comparisons": res.comparisons,
            "comparisons_dense": res.comparisons_dense, "rounds": res.rounds,
            "converged": res.converged, "per_iteration": res.per_iteration,
            "wire": res.wire, "saving_vs_serial": res.saving_vs_serial}


def _job_order(mesh, x, cfg):
    return _result(causal_order_ring(x, ParaLiNGAMConfig(**cfg), mesh=mesh, device="cpu"))


def _job_causal_order(mesh, x, cfg):
    """``causal_order`` with a ring config and no mesh: every rank of the
    process group as one flat ring."""
    return _result(causal_order(x, ParaLiNGAMConfig(**cfg), device="cpu"))


def _job_find_root(mesh, xn, c, mask):
    """``ring_find_root_jit`` on the grid's mesh (its own topology) and with
    ``topology=(1, world)`` on it and on a flat mesh."""
    xn, c, mask = torch.from_numpy(xn), torch.from_numpy(c), torch.from_numpy(mask)
    world = mesh.mesh.numel()
    flat = ring_mesh(None, torch.arange(world).reshape(1, world, 1), device_type="cpu")
    root, s = ring_find_root(xn, c, mask, mesh, row_axes=("ring",), sample_axis="model",
                             score_backend="torch", device="cpu")
    out = {"axes": (int(root), s.numpy())}
    for name, fn in (("own", ring_find_root_jit(mesh, "torch", device="cpu")),
                     ("pod1", ring_find_root_jit(mesh, "torch", topology=(1, world),
                                                 device="cpu")),
                     ("flat", ring_find_root_jit(flat, "torch", device="cpu"))):
        root, s = fn(xn, c, mask)
        out[name] = (int(root), s.numpy())
    return out


def _job_seam(mesh, xn, c, mask, rows, cols, chunk_idx):
    """The sample-shard seam over the grid's ``model`` group: this rank's
    sample shard of each input, every function with ``group=``."""
    group = mesh.get_group("model")
    shards, mi = dist.get_world_size(group), mesh.get_coordinate()[2]
    n = xn.shape[1] // shards
    xs = torch.from_numpy(xn[:, mi * n:(mi + 1) * n].copy())
    c, mask = torch.from_numpy(c), torch.from_numpy(mask)
    rows, cols, chunk_idx = (torch.from_numpy(a) for a in (rows, cols, chunk_idx))
    xi, xj, cb = xs[rows], xs[cols], c[rows][:, cols]
    live_i, live_j = mask[rows], mask[cols]
    return {
        "row_entropies": tpw.row_entropies(xs, mask, group=group).numpy(),
        "block": tpw.residual_entropy_block(xi, cb, xj, group=group).numpy(),
        "block_kernel_route": tpw.residual_entropy_block(
            xi, cb, xj, backend="hopper", live_i=live_i, live_j=live_j, group=group).numpy(),
        "pair_moments": [h.numpy() for h in tpw.pair_moments(
            xs, torch.take_along_dim(c, chunk_idx, dim=1), xs[chunk_idx],
            group=group)],
    }


JOBS = {"order": _job_order, "causal_order": _job_causal_order,
        "find_root": _job_find_root, "seam": _job_seam}


def _rank_main(rank: int, world: int, init: str, grid, jobs, out: str):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
        try:
            mesh = make_ring_mesh(*grid, device_type="cpu")
            results = {name: JOBS[kind](mesh, **kw) for name, kind, kw in jobs}
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_grid(grid, jobs, out, timeout: float = JOIN_TIMEOUT) -> list[dict]:
    """Run ``jobs`` (``(name, kind, kwargs)``) on P*R*M spawned gloo ranks of
    a ``make_ring_mesh(*grid)`` mesh; returns each rank's ``{name:
    result}``. A rank that fails or outlives ``timeout`` fails the call, and
    every rank still running is stopped."""
    world = math.prod(grid)
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "torch.distributed", __name__])
    init = "file://" + os.path.join(str(out), "init")
    procs = [ctx.Process(target=_rank_main, args=(r, world, init, grid, jobs, str(out)))
             for r in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + timeout
    for proc in procs:
        proc.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, proc in enumerate(procs) if proc.is_alive()]
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join(10)
    errors = [open(os.path.join(str(out), f"rank{r}.err")).read()
              for r in range(world) if os.path.exists(os.path.join(str(out), f"rank{r}.err"))]
    assert not hung, f"grid {grid}: ranks {hung} still running after {timeout} s"
    assert not errors and all(proc.exitcode == 0 for proc in procs), \
        f"grid {grid}: exit codes {[proc.exitcode for proc in procs]}\n" + "\n".join(errors)
    out_ranks = []
    for r in range(world):
        with open(os.path.join(str(out), f"rank{r}.pkl"), "rb") as f:
            out_ranks.append(pickle.load(f))
    return out_ranks


def assert_ranks_agree(ranks: list[dict]):
    """Every rank returned the same orders and counters."""
    def plain(v):
        return pickle.dumps(v) if not isinstance(v, dict) else {k: plain(w) for k, w in v.items()}
    first = {k: plain(v) for k, v in ranks[0].items() if k != "seam"}
    for r, res in enumerate(ranks[1:], 1):
        assert {k: plain(v) for k, v in res.items() if k != "seam"} == first, f"rank {r} differs"


# ---------------------------------------------------------------------------
# references
# ---------------------------------------------------------------------------


def dense_cfg(p: int, **kw) -> dict:
    return dict(order_backend="ring", min_bucket=problem(p)[1], score_backend="torch", **kw)


@functools.cache
def scan_result(p: int, threshold: bool = False):
    """The port's scan under the config of the ring cases."""
    x, min_bucket = problem(p)
    kw = dict(chunk=16, gamma0=1e-6) if threshold else {}
    return causal_order_scan(x, ParaLiNGAMConfig(min_bucket=min_bucket, threshold=threshold,
                                                 score_backend="torch", **kw), device="cpu")


def hop_model(pods: int, ring: int):
    from repro.utils.schedule import make_hier_plan

    hc = make_hier_plan(pods, ring).hop_counts()
    return (hc["intra_ovl"], hc["intra_seq"], hc["cross_ovl"], hc["cross_seq"])


def find_root_problem(p=32, n=1024, seed=0):
    """``(xn, c, mask)`` as numpy: the SEM's data of ``tests/test_distributed
    .py``'s find-root size, normalized and correlated by the JAX package."""
    import jax.numpy as jnp
    from repro.core.covariance import cov_matrix, normalize

    x = sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=seed))["x"]
    xn = normalize(jnp.asarray(x, jnp.float32))
    return np.array(xn), np.array(cov_matrix(xn)), np.ones((p,), bool)


def hold_find_root(root, s, xn, c, mask):
    """A ring find-root's ``(root, scores)`` against ``repro``'s
    ``find_root_dense`` (the same root, rtol 2e-4) and the port's own dense
    evaluation (rtol 2e-4). The comparison bites: every row but the root's
    has a score above ``fused_score.score_tolerance``, the float32 rounding
    of its entropies carried through I and S."""
    from repro.core.paralingam import find_root_dense
    from repro_torch.kernels.fused_score import score_tolerance

    root_d, s_d = find_root_dense(xn, c, mask, block_j=16)
    assert int(root) == int(root_d)
    s_ref = np.array(s_d)
    np.testing.assert_allclose(np.asarray(s), s_ref, rtol=2e-4)
    xt, ct, mt = torch.from_numpy(xn), torch.from_numpy(c), torch.from_numpy(mask)
    above = np.abs(s_ref) > score_tolerance(torch.from_numpy(s_ref), xt, ct, mt).numpy()
    assert int(above.sum()) == xn.shape[0] - 1
    np.testing.assert_allclose(np.asarray(s), tpw.dense_scores(xt, ct, mt)[0].numpy(), rtol=2e-4)


def seam_problem():
    """Rows, correlations and a mask with a dead row, from the JAX package,
    and the row/column/chunk indices of the seam cases."""
    import jax.numpy as jnp
    from repro.core.covariance import cov_matrix, normalize

    rng = np.random.default_rng(11)
    xn = normalize(jnp.asarray(rng.standard_normal((12, 2048)), jnp.float32))
    mask = np.ones((12,), bool)
    mask[5] = False
    chunk_idx = np.stack([(np.arange(3) + i + 1) % 12 for i in range(12)])
    return (np.array(xn), np.array(cov_matrix(xn)), mask, np.arange(0, 7), np.arange(5, 12),
            chunk_idx)


def _dense_jobs(grid) -> list:
    pods, ring, _ = grid
    jobs = [(f"order{p}", "order", dict(x=problem(p)[0], cfg=dense_cfg(p))) for p in PS]
    # the flat ring at equal total shards, named by ring_topology
    jobs += [(f"flat{p}", "order", dict(x=problem(p)[0],
                                        cfg=dense_cfg(p, ring_topology=(1, pods * ring))))
             for p in PS]
    # no mesh given: the world as a flat ring
    jobs.append(("causal_order17", "causal_order", dict(x=problem(17)[0], cfg=dense_cfg(17))))
    xn, c, mask = find_root_problem()
    jobs.append(("find_root", "find_root", dict(xn=xn, c=c, mask=mask)))
    xs, cs, ms, rows, cols, chunk_idx = seam_problem()
    jobs.append(("seam", "seam", dict(xn=xs, c=cs, mask=ms, rows=rows, cols=cols,
                                      chunk_idx=chunk_idx)))
    return jobs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=GRIDS, ids=grid_id)
def dense_grid(request, tmp_path_factory):
    """The dense cases of one grid, run once on its spawned ranks:
    ``(grid, results of every rank)``."""
    grid = request.param
    return grid, run_grid(grid, _dense_jobs(grid), tmp_path_factory.mktemp(grid_id(grid)))


# ---------------------------------------------------------------------------
# the grids
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", PS)
def test_ring_order_equals_scan(dense_grid, p):
    grid, ranks = dense_grid
    res, scan = ranks[0][f"order{p}"], scan_result(p)
    assert res["order"] == scan.order
    assert res["comparisons"] == scan.comparisons_dense  # the analytic dense counters
    assert res["converged"] and res["rounds"] == 0
    assert len(res["per_iteration"]) == p - 1


@pytest.mark.parametrize("p", PS)
def test_ring_hop_counters_equal_plan(dense_grid, p):
    """Per iteration the dense sweep walks the plan once: its shift counters
    equal ``HierPlan.hop_counts``, and ``wire`` sums them."""
    (pods, ring, _), ranks = dense_grid
    res = ranks[0][f"order{p}"]
    model = hop_model(pods, ring)
    assert all(it["hops"] == model for it in res["per_iteration"])
    wire = res["wire"]
    assert (wire["pods"], wire["ring"]) == (pods, ring)
    assert wire["hops_intra"] == (p - 1) * (model[0] + model[1])
    assert wire["hops_cross"] == (p - 1) * (model[2] + model[3])
    assert wire["hops_overlapped"] > 0 and wire["overlap_frac"] > 0


def test_ring_ranks_agree(dense_grid):
    _, ranks = dense_grid
    assert_ranks_agree(ranks)


@pytest.mark.parametrize("p", PS)
def test_hier_ring_equals_flat_ring(dense_grid, p):
    """The flat ring at equal total shards (``ring_topology=(1, P*R)``)
    gives the same order; at P=1 it is the grid's own ring, bit for bit
    (every counter equal)."""
    (pods, ring, _), ranks = dense_grid
    res, flat = ranks[0][f"order{p}"], ranks[0][f"flat{p}"]
    assert flat["order"] == res["order"] == scan_result(p).order
    assert flat["wire"]["pods"] == 1 and flat["wire"]["ring"] == pods * ring
    if pods == 1:
        assert flat == res


def test_ring_find_root_matches_dense(dense_grid):
    """``ring_find_root_jit`` over every rank of the grid (the grid's pod
    split kept) against the dense evaluation (``hold_find_root``)."""
    _, ranks = dense_grid
    hold_find_root(*ranks[0]["find_root"]["own"], *find_root_problem())


def test_ring_find_root_over_named_axes(dense_grid):
    """``ring_find_root(row_axes=("ring",), sample_axis="model")``: the rows
    over ``ring``, the samples over ``model`` (dropped where it has one
    rank), ``pod`` replicated; the dense evaluation's scores."""
    _, ranks = dense_grid
    for res in ranks:
        hold_find_root(*res["find_root"]["axes"], *find_root_problem())


def test_pod1_topology_bit_identical_to_flat_ring(dense_grid):
    """``topology=(1, R)`` on the grid's mesh gives the flat ring's scores
    bit for bit: the two-level walk at P=1 is the flat schedule."""
    _, ranks = dense_grid
    fr = ranks[0]["find_root"]
    assert fr["pod1"][0] == fr["flat"][0]
    assert np.array_equal(fr["pod1"][1], fr["flat"][1])


@pytest.mark.parametrize("fn", ["row_entropies", "block", "block_kernel_route", "pair_moments"])
def test_sample_shard_seam_matches_full_n(dense_grid, fn):
    """With ``group=`` the grid's model group, each function on this rank's
    sample shard gives ``repro.core.pairwise``'s full-n values (the kernel
    route's plain version holds the live pairs)."""
    import jax.numpy as jnp
    from repro.core import pairwise as jpw

    (_, _, msize), ranks = dense_grid
    xn, c, mask, rows, cols, chunk_idx = seam_problem()
    if fn == "row_entropies":
        want = jpw.row_entropies(jnp.asarray(xn), jnp.asarray(mask))
    elif fn == "pair_moments":
        want = jpw.pair_moments(jnp.asarray(xn), jnp.asarray(np.take_along_axis(c, chunk_idx, 1)),
                                jnp.asarray(xn[chunk_idx]))
    else:
        want = jpw.residual_entropy_block(jnp.asarray(xn[rows]), jnp.asarray(c[rows][:, cols]),
                                          jnp.asarray(xn[cols]))
    sel = np.s_[:]
    if fn == "block_kernel_route":
        sel = mask[rows][:, None] & mask[cols][None, :]
    for r, res in enumerate(ranks):
        got = res["seam"][fn]
        pairs = zip(got, want) if fn == "pair_moments" else [(got, want)]
        for g, w in pairs:
            np.testing.assert_allclose(g[sel], np.asarray(w)[sel], rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {r}, model size {msize}")


def test_causal_order_routes_to_the_world_ring(dense_grid):
    """``causal_order(order_backend="ring")`` without a mesh runs every rank
    of the process group as one flat ring."""
    grid, ranks = dense_grid
    res = ranks[0]["causal_order17"]
    assert res["order"] == scan_result(17).order
    assert (res["wire"]["pods"], res["wire"]["ring"]) == (1, math.prod(grid))


# ---------------------------------------------------------------------------
# one shard, in this process
# ---------------------------------------------------------------------------


@functools.cache
def one_shard(p: int) -> object:
    x, _ = problem(p)
    return causal_order_ring(x, ParaLiNGAMConfig(**dense_cfg(p)), device="cpu")


@pytest.mark.parametrize("p", PS)
def test_one_shard_ring_equals_scan(p):
    """Without a process group the ring has one shard and calls no
    collective: the scan's order and counters, wire all zero."""
    res, scan = one_shard(p), scan_result(p)
    assert res.order == scan.order
    assert [it["comparisons"] for it in res.per_iteration] == \
        [it["comparisons"] for it in scan.per_iteration]
    assert res.wire == {"pods": 1, "ring": 1, "hops_intra": 0, "hops_cross": 0,
                        "hops_overlapped": 0, "seq_hops": 0, "seq_cross_hops": 0,
                        "overlap_frac": 0.0}


@pytest.mark.parametrize("p", [8, 17])
def test_one_shard_ring_equals_reference_ring(p):
    """The (1, 1, 1) ring against ``repro``'s ring on one JAX device: the
    same order and per-iteration counters."""
    import jax
    from jax.sharding import Mesh
    import repro
    from repro.dist.ring_order import causal_order_ring as j_ring

    x, min_bucket = problem(p)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("ring", "model"))
    ref = j_ring(x, repro.ParaLiNGAMConfig(order_backend="ring", min_bucket=min_bucket,
                                           score_backend="xla"), mesh=mesh)
    res = one_shard(p)
    assert res.order == ref.order
    assert res.per_iteration == ref.per_iteration
    assert res.wire == ref.wire


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo process group of one rank in this process, and its
    ``("pod", "ring", "model")`` mesh."""
    init = "file://" + str(tmp_path_factory.mktemp("world1") / "init")
    dist.init_process_group("gloo", init_method=init, rank=0, world_size=1)
    try:
        yield make_ring_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_world_of_one_is_bit_equal_to_no_group(world1):
    """A process group of one rank runs every collective on groups of one;
    the result is bit for bit the run without a process group (the card's
    check under NCCL)."""
    x, min_bucket = problem(17)
    cfg = ParaLiNGAMConfig(**dense_cfg(17))
    assert causal_order_ring(x, cfg, mesh=world1, device="cpu") == one_shard(17)


def test_meshes_and_rules_on_a_device_mesh(world1):
    """The port's meshes are ``DeviceMesh`` objects with the reference's
    dimension names; ``make_rules`` reads their sizes."""
    assert world1.mesh_dim_names == ("pod", "ring", "model")
    assert tuple(world1.shape) == (1, 1, 1)
    local = make_local_mesh(device_type="cpu")
    assert local.mesh_dim_names == ("data", "model")
    rules = make_rules(types.SimpleNamespace(), world1)
    assert rules.batch_axes == () and rules.model_axis is None
    assert rules.model_size == 1 and rules.batch_shards == 1


def test_find_root_jit_rejects_bad_topology(world1):
    with pytest.raises(ValueError, match="does not factor"):
        ring_find_root_jit(world1, topology=(2, 4))


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_ring_find_root_degenerate_ring_is_dense(world1, backend):
    """One shard: the dense evaluation, as the reference falls back, through
    the ring's own hop-0 block (the square kernel's plain version here)."""
    xn, c, mask = find_root_problem()
    root, s = ring_find_root(torch.from_numpy(xn), torch.from_numpy(c), torch.from_numpy(mask),
                             world1, row_axes=("ring",), score_backend=backend, device="cpu")
    hold_find_root(root, s, xn, c, mask)


def test_fit_ring_equals_scan_fit():
    """``fit(order_backend="ring")`` runs phase 2 on the ring's order: B and
    noise variances as the scan fit's."""
    x, min_bucket = problem(17)
    res, b = fit(x, ParaLiNGAMConfig(**dense_cfg(17)), device="cpu")
    ref, b_ref = fit(x, ParaLiNGAMConfig(min_bucket=min_bucket, score_backend="torch"),
                     device="cpu")
    assert res.order == ref.order
    assert torch.equal(b, b_ref)
    assert np.array_equal(res.noise_var, ref.noise_var)
    assert res.wire is not None and ref.wire is None


def test_causal_order_routes_ring_config():
    x, _ = problem(8)
    assert causal_order(x, ParaLiNGAMConfig(**dense_cfg(8)), device="cpu").order \
        == scan_result(8).order


def test_ring_topology_config_validation():
    with pytest.raises(ConfigError, match="power-of-two"):
        ParaLiNGAMConfig(order_backend="ring", ring_topology=(3, 2))
    with pytest.raises(ConfigError, match="power-of-two"):
        ParaLiNGAMConfig(order_backend="ring", ring_topology=(2, 0))
    with pytest.raises(ConfigError, match="power-of-two"):
        ParaLiNGAMConfig(order_backend="ring", ring_topology=(2,))
    with pytest.raises(ConfigError, match="order_backend"):
        ParaLiNGAMConfig(order_backend="scan", ring_topology=(2, 2))
    assert ParaLiNGAMConfig(order_backend="ring", ring_topology=[2, 4]).ring_topology == (2, 4)


def test_ring_topology_that_does_not_fit_raises():
    """Without a process group there is one row shard: (2, 2) cannot fit."""
    x, min_bucket = problem(8)
    cfg = ParaLiNGAMConfig(order_backend="ring", min_bucket=min_bucket, ring_topology=(2, 2))
    with pytest.raises(ConfigError, match="does not fit"):
        causal_order_ring(x, cfg, device="cpu")


def test_config_from_reference_maps_ring():
    import dataclasses
    import repro

    ref = repro.ParaLiNGAMConfig(order_backend="ring", ring_topology=(2, 4), threshold=True)
    cfg = config_from_reference(dataclasses.asdict(ref))
    assert (cfg.order_backend, cfg.ring_topology, cfg.threshold) == ("ring", (2, 4), True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the square kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [False, True])
def test_one_shard_ring_on_the_card_equals_scan(cuda, threshold):
    """On the card the one-shard ring launches the square kernel once per
    dense find-root (none under the threshold) and gives the scan's order
    with the same kernel."""
    from repro_torch.kernels import pairwise_score as ps

    x, min_bucket = problem(17)
    kw = dict(score_backend="hopper", min_bucket=min_bucket, threshold=threshold)
    scan = causal_order_scan(x, ParaLiNGAMConfig(**kw), device=cuda)
    before = ps.LAUNCHES
    res = causal_order_ring(x, ParaLiNGAMConfig(order_backend="ring", **kw), device=cuda)
    assert ps.LAUNCHES - before == (0 if threshold else 16)
    assert res.order == scan.order


@pytest.mark.cuda
def test_degenerate_ring_find_root_on_the_card_runs_the_kernel(world1, cuda):
    """A one-shard ``ring_find_root`` on the card launches the square kernel
    once (the ring's hop-0 block), and gives the dense root and scores."""
    from repro_torch.kernels import pairwise_score as ps
    from repro_torch.kernels.fused_score import score_tolerance

    xn, c, mask = (torch.from_numpy(a).to(cuda) for a in find_root_problem())
    before = ps.LAUNCHES
    root, s = ring_find_root(xn, c, mask, world1, score_backend="hopper")
    assert ps.LAUNCHES - before == 1
    s_d = tpw.dense_scores(xn, c, mask)[0]
    assert int(root) == int(torch.argmin(s_d))
    assert bool(torch.all((s - s_d).abs() <= score_tolerance(s_d, xn, c, mask)))


# ---------------------------------------------------------------------------
# schedule, rules, the kernel route's masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r", [1, 2, 3, 4, 5, 8])
def test_process_pair_covers_each_block_pair_once(r):
    """Over the processed steps every unordered block pair is processed by
    exactly one endpoint; the reference's predicate agrees."""
    from repro.dist.ring import process_pair as j_process_pair, ring_steps as j_ring_steps

    assert ring_steps(r) == j_ring_steps(r)
    seen = {}
    for t in range(r + 1):
        for dst in range(r):
            src = (dst - t) % r
            assert process_pair(r, t, dst, src) == j_process_pair(r, t, dst, src)
            if process_pair(r, t, dst, src):
                key = frozenset((dst, src))
                seen[key] = seen.get(key, 0) + 1
    assert all(v == 1 for v in seen.values())
    assert len(seen) == r * (r - 1) // 2


@pytest.mark.parametrize("p,min_bucket", [(8, 8), (17, 8), (64, 32), (85, 32), (512, 32)])
def test_ring_order_stages_equal_reference(p, min_bucket):
    from repro.dist.ring_order import ring_order_stages as j_stages

    for r in (1, 2, 4, 8):
        assert ring_order_stages(p, min_bucket, r) == j_stages(p, min_bucket, r)


def _stub(**axes):
    return types.SimpleNamespace(shape=dict(axes))


def test_make_rules_keeps_pod_axis_on_3axis_mesh():
    rules = make_rules(types.SimpleNamespace(), _stub(pod=2, ring=4, model=2))
    assert rules.batch_axes == ("pod", "ring") and rules.model_axis == "model"
    assert rules.batch_shards == 8
    assert make_rules(types.SimpleNamespace(), _stub(pod=1, ring=4, model=2)).batch_axes \
        == ("ring",)


def test_rules_axis_sizes_and_no_sharding():
    rules = ShardingRules(mesh=_stub(pod=2, data=4, model=8), batch_axes=("pod", "data"),
                          model_axis="model")
    assert rules.model_size == 8 and rules.batch_shards == 8
    assert NO_SHARDING.model_axis is None
    assert NO_SHARDING.model_size == 1 and NO_SHARDING.batch_shards == 1


def test_make_rules_moe_and_batch_override():
    from repro_torch import configs

    cfg = configs.smoke("llama4-scout-17b-a16e").with_overrides(n_experts=6)
    assert make_rules(cfg, _stub(data=2, model=4)).model_axis is None  # 6 % 4 != 0
    assert make_rules(cfg.with_overrides(n_experts=8), _stub(data=2, model=4)).model_axis \
        == "model"
    rules = make_rules(configs.smoke("granite-3-2b"), _stub(data=4, model=2), batch_axes=())
    assert rules.batch_axes == () and rules.batch_shards == 1


@pytest.mark.parametrize("mesh", [None, "stub"])
def test_make_rules_matches_reference(mesh):
    from repro.dist.sharding import make_rules as j_make_rules

    m = None if mesh is None else _stub(pod=2, data=1, ring=2, model=4)
    got, want = make_rules(types.SimpleNamespace(), m), j_make_rules(types.SimpleNamespace(), m)
    assert (got.batch_axes, got.model_axis, got.model_size, got.batch_shards) == \
        (want.batch_axes, want.model_axis, want.model_size, want.batch_shards)


def test_block_kernel_route_passes_masks_and_valid_count():
    """``residual_entropy_block``'s kernel route (its plain version here)
    sums live pairs over the valid samples only: equal to the plain route on
    live pairs, and a zero-padded buffer with ``n_valid`` gives the
    unpadded entries bit for bit."""
    from repro_torch.core.covariance import cov_matrix, normalize

    rng = np.random.default_rng(3)
    xn = normalize(torch.from_numpy(rng.standard_normal((9, 700)).astype(np.float32)))
    c = cov_matrix(xn)
    live = torch.arange(9) != 4
    sel = live[:, None] & live[None, :]
    plain = tpw.residual_entropy_block(xn, c, xn)
    kern = tpw.residual_entropy_block(xn, c, xn, backend="hopper", live_i=live, live_j=live)
    torch.testing.assert_close(kern[sel], plain[sel], rtol=1e-5, atol=1e-6)
    xp = torch.nn.functional.pad(xn, (0, 324))
    padded = tpw.residual_entropy_block(xp, c, xp, backend="hopper", live_i=live, live_j=live,
                                        n_valid=torch.tensor(700))
    assert torch.equal(padded[sel], kern[sel])
