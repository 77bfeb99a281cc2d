"""The threshold state machine per ring shard (``dist.ring.
_ring_threshold_body``) on the CPU: the cases of
``tests/test_ring_threshold.py`` and the threshold half of
``tests/test_hier_ring.py``, on the grids of ``tests/test_torch_ring.py``
(its ``run_grid``: spawned gloo ranks, one spawn per grid).

Parity law (paper Section 3.2): at termination every below-gamma worker's
score is complete and every paused worker's partial score only grows, so
argmin over the gathered scores is the root however the pending chunks were
scheduled across shards and hops. What is held:

* Every ring order equals the port's threshold scan order under the same
  config (chunk 16, gamma0 1e-6), on every rank; ``repro``'s at p=8 and 17
  (the p=64 float32 near-tie of ROADMAP.md queue 3 splits the packages).
* Comparisons are device-measured and at most the dense count; at p=64 the
  saving against the serial count is at least 60% on every grid (the
  reference's acceptance bar).
* The shift counters of every iteration equal
  ``repro.utils.schedule.make_hier_plan(P, R).hop_counts()`` times that
  iteration's rounds.
* At one shard the ring's counters equal the scan's state machine's, and
  the order and per-iteration counters equal ``repro``'s ring on one JAX
  device at p=8 and 17.
"""

import functools
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core.paralingam import ParaLiNGAMConfig
from repro_torch.dist.ring_order import causal_order_ring
from test_torch_ring import (
    GRIDS,
    PS,
    assert_ranks_agree,
    grid_id,
    hop_model,
    problem,
    run_grid,
    scan_result,
)


def thr_cfg(p: int, **kw) -> dict:
    return dict(order_backend="ring", threshold=True, chunk=16, gamma0=1e-6,
                min_bucket=problem(p)[1], score_backend="torch", **kw)


def _threshold_jobs(grid) -> list:
    pods, ring, _ = grid
    jobs = [(f"order{p}", "order", dict(x=problem(p)[0], cfg=thr_cfg(p))) for p in PS]
    # the flat ring at equal total shards, named by ring_topology
    jobs += [(f"flat{p}", "order", dict(x=problem(p)[0],
                                        cfg=thr_cfg(p, ring_topology=(1, pods * ring))))
             for p in PS]
    return jobs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=GRIDS, ids=grid_id)
def threshold_grid(request, tmp_path_factory):
    grid = request.param
    return grid, run_grid(grid, _threshold_jobs(grid), tmp_path_factory.mktemp(grid_id(grid)))


def assert_threshold_counters(res, p: int):
    """Device-measured counters, not analytic fills."""
    assert res["converged"]
    assert 0 < res["comparisons"] <= res["comparisons_dense"]
    assert res["rounds"] > 0 and len(res["per_iteration"]) == p - 1
    assert all(0 < it["comparisons"] <= it["r"] * (it["r"] - 1) // 2
               for it in res["per_iteration"])
    assert sum(it["comparisons"] for it in res["per_iteration"]) == res["comparisons"]
    assert sum(it["rounds"] for it in res["per_iteration"]) == res["rounds"]


@pytest.mark.parametrize("p", PS)
def test_ring_threshold_order_equals_scan(threshold_grid, p):
    _, ranks = threshold_grid
    res = ranks[0][f"order{p}"]
    assert res["order"] == scan_result(p, threshold=True).order == scan_result(p).order
    assert_threshold_counters(res, p)


@pytest.mark.parametrize("p", PS)
def test_ring_threshold_hop_counters(threshold_grid, p):
    """The threshold machine walks the plan once per round."""
    (pods, ring, _), ranks = threshold_grid
    res = ranks[0][f"order{p}"]
    model = hop_model(pods, ring)
    for it in res["per_iteration"]:
        assert it["hops"] == tuple(v * it["rounds"] for v in model)
    assert (res["wire"]["pods"], res["wire"]["ring"]) == (pods, ring)
    assert res["wire"]["hops_overlapped"] > 0 and res["wire"]["overlap_frac"] > 0


def test_ring_threshold_savings_p64(threshold_grid):
    """At least 60% of the serial comparisons saved at p=64 on every grid."""
    _, ranks = threshold_grid
    assert ranks[0]["order64"]["saving_vs_serial"] >= 0.60


def test_ring_threshold_ranks_agree(threshold_grid):
    _, ranks = threshold_grid
    assert_ranks_agree(ranks)


@pytest.mark.parametrize("p", PS)
def test_hier_threshold_equals_flat_ring(threshold_grid, p):
    """The flat ring at equal total shards (``ring_topology=(1, P*R)``)
    gives the same order; at P=1 it is the grid's own ring, bit for bit."""
    (pods, ring, _), ranks = threshold_grid
    res, flat = ranks[0][f"order{p}"], ranks[0][f"flat{p}"]
    assert flat["order"] == res["order"]
    assert (flat["wire"]["pods"], flat["wire"]["ring"]) == (1, pods * ring)
    assert_threshold_counters(flat, p)
    if pods == 1:
        assert flat == res


# ---------------------------------------------------------------------------
# one shard, in this process
# ---------------------------------------------------------------------------


@functools.cache
def one_shard(p: int):
    return causal_order_ring(problem(p)[0], ParaLiNGAMConfig(**thr_cfg(p)), device="cpu")


@pytest.mark.parametrize("p", PS)
def test_one_shard_threshold_equals_scan_machine(p):
    """At one shard the ring's cycle is the scan's round: the same order and
    the same comparisons, rounds and convergence per iteration."""
    res, scan = one_shard(p), scan_result(p, threshold=True)
    assert res.order == scan.order
    assert [{k: v for k, v in it.items() if k != "hops"} for it in res.per_iteration] \
        == scan.per_iteration
    assert all(it["hops"] == (0, 0, 0, 0) for it in res.per_iteration)


@pytest.mark.parametrize("p", [8, 17])
def test_one_shard_threshold_equals_reference_ring(p):
    import jax
    from jax.sharding import Mesh
    import repro
    from repro.dist.ring_order import causal_order_ring as j_ring

    x, min_bucket = problem(p)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("ring", "model"))
    ref = j_ring(x, repro.ParaLiNGAMConfig(order_backend="ring", threshold=True, chunk=16,
                                           gamma0=1e-6, min_bucket=min_bucket,
                                           score_backend="xla"), mesh=mesh)
    res = one_shard(p)
    assert res.order == ref.order
    assert res.per_iteration == ref.per_iteration
    assert res.comparisons == ref.comparisons and res.rounds == ref.rounds


def test_ring_threshold_beats_dense_ring_comparisons():
    """The dense ring's order and comparisons (its analytic r(r-1)/2 per
    iteration, held in ``test_torch_ring.py``) against the threshold's."""
    thr = one_shard(64)
    assert thr.order == scan_result(64).order
    assert thr.comparisons < thr.comparisons_dense == scan_result(64).comparisons


def test_ring_threshold_max_rounds_warns_and_reports_not_converged():
    x, min_bucket = problem(8)
    cfg = ParaLiNGAMConfig(**{**thr_cfg(8), "chunk": 1, "max_rounds": 1})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = causal_order_ring(x, cfg, device="cpu")
    assert not res.converged
    assert all(it["rounds"] <= 1 for it in res.per_iteration)
    assert any("max_rounds=1" in str(w.message) for w in caught)
