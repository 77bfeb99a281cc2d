"""The port's numerical core held against the JAX package on the same numpy
inputs: entropy, covariance and rank-1 updates, the pairwise score
formulations, the stage schedule, phase-2 adjacency and the numpy modules
the port keeps its own copies of.

Tolerances: both sides compute in float32 with the same formulas, so they
differ only where XLA and torch order a reduction or fuse a multiply-add
differently — a few ulps of the reduced quantity. Element-wise results are
held to rtol 1e-6; reductions over n <= 700 samples to rtol 1e-5 /
atol 1e-6 (the tolerance of ``tests/test_fused_score.py``). Scores S are
sums of squares of stats I ~ 1e-3 that are differences of entropies near
1.42, so float32 rounding of the entropies is ~1e-4 of I and ~2e-4 of S; on
this Gaussian data S is 1e-7..1e-5, below any fixed atol worth the name. S
is held to 1e-3 of the case's largest score (largest difference measured:
6.3e-4, the diagonal-tile scores of ``fused_layout`` at p=20).
"""

import dataclasses
import os
import re
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import adjacency as j_adj  # noqa: E402
from repro.core import covariance as j_cov  # noqa: E402
from repro.core import direct_lingam as j_dl  # noqa: E402
from repro.core import entropy as j_ent  # noqa: E402
from repro.core import pairwise as j_pw  # noqa: E402
from repro.core import pruning as j_prune  # noqa: E402
from repro.core import sem as j_sem  # noqa: E402
from repro.core import validate as j_val  # noqa: E402
from repro.utils import schedule as j_sched  # noqa: E402
from repro_torch.core import adjacency as t_adj  # noqa: E402
from repro_torch.core import covariance as t_cov  # noqa: E402
from repro_torch.core import direct_lingam as t_dl  # noqa: E402
from repro_torch.core import entropy as t_ent  # noqa: E402
from repro_torch.core import pairwise as t_pw  # noqa: E402
from repro_torch.core import pruning as t_prune  # noqa: E402
from repro_torch.core import sem as t_sem  # noqa: E402
from repro_torch.core import validate as t_val  # noqa: E402
from repro_torch.utils import schedule as t_sched  # noqa: E402
from repro_torch.utils.shapes import next_pow2  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
#: Largest score difference allowed, as a share of the case's largest score.
SCORE_SHARE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(t), np.asarray(j), rtol=rtol, atol=atol,
                               equal_nan=True)


def _close_scores(t, j, sel=slice(None)):
    """Scores: equal +inf pattern, finite ones within SCORE_SHARE of the
    largest."""
    t, j = np.asarray(_np(t), np.float64)[sel], np.asarray(j, np.float64)[sel]
    np.testing.assert_array_equal(np.isinf(t), np.isinf(j))
    live = np.isfinite(j)
    scale = np.abs(j[live]).max()
    assert scale > 0, "every reference score is zero: the comparison is empty"
    np.testing.assert_allclose(t[live], j[live], rtol=0, atol=SCORE_SHARE * scale)


def _normalized(p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((p, n)).astype(np.float32)
    xn = np.array(jax.jit(j_cov.normalize)(jnp.asarray(x)))
    c = np.array(jax.jit(j_cov.cov_matrix)(jnp.asarray(xn)))
    return xn, c


# ---------------------------------------------------------------------------
# entropy
# ---------------------------------------------------------------------------


def test_entropy_constants_equal():
    assert (t_ent.K1, t_ent.K2, t_ent.BETA, t_ent.H_GAUSS) == (
        j_ent.K1, j_ent.K2, j_ent.BETA, j_ent.H_GAUSS)


@pytest.mark.parametrize("fn", ["log_cosh", "u_exp_moment"])
def test_entropy_integrands_match(fn):
    u = np.random.default_rng(0).standard_normal((5, 700)).astype(np.float32) * 8.0
    u[0, :4] = [0.0, 40.0, -60.0, 1e-8]
    _close(getattr(t_ent, fn)(torch.from_numpy(u)),
           getattr(j_ent, fn)(jnp.asarray(u)), rtol=1e-6, atol=1e-7)


def test_entropy_matches():
    rng = np.random.default_rng(1)
    u = np.stack([rng.standard_normal(600), rng.laplace(size=600),
                  rng.uniform(-1.7, 1.7, 600)]).astype(np.float32)
    _close(t_ent.entropy(torch.from_numpy(u)), j_ent.entropy(jnp.asarray(u)))
    m1, m2 = np.float32([0.3, 0.4, 0.5]), np.float32([0.01, -0.2, 0.1])
    _close(t_ent.entropy_from_moments(torch.from_numpy(m1), torch.from_numpy(m2)),
           j_ent.entropy_from_moments(jnp.asarray(m1), jnp.asarray(m2)),
           rtol=1e-6)


# ---------------------------------------------------------------------------
# covariance
# ---------------------------------------------------------------------------


def test_sample_count_types():
    assert t_cov._sample_count(None, 10, 1) == 9
    assert t_cov._sample_count(None, 1, 1) == 1
    nv = t_cov._sample_count(torch.tensor(7), 10, 1)
    assert nv.dtype == torch.float32 and float(nv) == 6.0
    assert (t_cov.VAR_EPS, t_cov.COLLINEAR_FLOOR) == (j_cov.VAR_EPS, j_cov.COLLINEAR_FLOOR)


def test_full_precision_matmul_is_shared_across_threads():
    """Two threads enter the scope with the caller at "high". Each reads
    "highest" inside the scope after the other has left, and "high" comes
    back only when both have left."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    entered, failures = threading.Barrier(2), []
    left = [threading.Event(), threading.Event()]

    def worker(me, first_out):
        try:
            with t_cov.full_precision_matmul():
                entered.wait(10)
                if me != first_out:
                    assert left[first_out].wait(10)
                    assert torch.get_float32_matmul_precision() == "highest"
            left[me].set()
        except Exception as e:  # noqa: BLE001 — reported through `failures`
            failures.append(repr(e))

    try:
        for first_out in (0, 1):
            for ev in left:
                ev.clear()
            threads = [threading.Thread(target=worker, args=(me, first_out))
                       for me in (0, 1)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(30)
            assert all(not th.is_alive() for th in threads)
            assert failures == []
            assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)


def test_full_precision_matmul_is_scoped():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with t_cov.full_precision_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)


@pytest.mark.parametrize("n_valid", [None, 450])
def test_normalize_and_cov_match(n_valid):
    p, n = 17, 600
    x = np.random.default_rng(2).standard_normal((p, n)).astype(np.float32) * 3 + 1
    if n_valid is not None:
        x[:, n_valid:] = 0.0
    nv_t = None if n_valid is None else torch.tensor(n_valid)
    nv_j = None if n_valid is None else jnp.asarray(n_valid)
    xn_t = t_cov.normalize(torch.from_numpy(x), n_valid=nv_t)
    xn_j = jax.jit(j_cov.normalize)(jnp.asarray(x), n_valid=nv_j)
    _close(xn_t, xn_j)
    if n_valid is not None:
        assert torch.all(xn_t[:, n_valid:] == 0)
    _close(t_cov.cov_matrix(xn_t, n_valid=nv_t), j_cov.cov_matrix(xn_j, n_valid=nv_j))


@pytest.mark.parametrize("p,root,dead,n_valid",
                         [(13, 4, (1, 7), None), (17, 0, (16,), 500),
                          (33, 32, (3, 5, 20), None)])
def test_rank1_updates_match(p, root, dead, n_valid):
    """update_data / update_cov at odd p with dead rows holding NaN."""
    xn, c = _normalized(p, 600, seed=p)
    if n_valid is not None:
        xn[:, n_valid:] = 0.0
    mask = np.ones(p, bool)
    for d in dead:
        mask[d] = False
        xn[d] = np.nan
        c[d, :] = np.nan
        c[:, d] = np.nan
        c[d, d] = 1.0
    nv_t = None if n_valid is None else torch.tensor(n_valid)
    nv_j = None if n_valid is None else jnp.asarray(n_valid)
    root_t = torch.tensor(root)
    x_t = t_cov.update_data(torch.from_numpy(xn), torch.from_numpy(c), root_t,
                            torch.from_numpy(mask), n_valid=nv_t)
    x_j = jax.jit(j_cov.update_data)(jnp.asarray(xn), jnp.asarray(c), root,
                            jnp.asarray(mask), n_valid=nv_j)
    _close(x_t, x_j)
    c_t = t_cov.update_cov(torch.from_numpy(c), root_t, torch.from_numpy(mask))
    c_j = jax.jit(j_cov.update_cov)(jnp.asarray(c), root, jnp.asarray(mask))
    _close(c_t, c_j, rtol=1e-6, atol=1e-7)
    b_t, s_t = t_cov.rank1_gates(torch.from_numpy(c[:, root]), torch.from_numpy(mask))
    b_j, s_j = j_cov.rank1_gates(jnp.asarray(c[:, root]), jnp.asarray(mask))
    _close(b_t, b_j, rtol=0, atol=0)
    _close(s_t, s_j, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# pairwise
# ---------------------------------------------------------------------------


def test_residual_entropy_block_pair_matches():
    xn, c = _normalized(12, 500, seed=5)
    hf_t, hr_t = t_pw.residual_entropy_block_pair(
        torch.from_numpy(xn[:5]), torch.from_numpy(c[:5, 5:]), torch.from_numpy(xn[5:]))
    hf_j, hr_j = jax.jit(j_pw.residual_entropy_block_pair)(
        jnp.asarray(xn[:5]), jnp.asarray(c[:5, 5:]), jnp.asarray(xn[5:]))
    _close(hf_t, hf_j)
    _close(hr_t, hr_j)


@pytest.mark.parametrize("n_valid", [None, 400])
def test_stream_and_row_entropies_match(n_valid):
    xn, _ = _normalized(9, 500, seed=6)
    if n_valid is not None:
        xn[:, n_valid:] = 0.0
    mask = np.arange(9) % 4 != 1
    nv_t = None if n_valid is None else torch.tensor(n_valid)
    nv_j = None if n_valid is None else jnp.asarray(n_valid)
    for t, j in zip(t_pw.stream_moments(torch.from_numpy(xn), n_valid=nv_t),
                    jax.jit(j_pw.stream_moments)(jnp.asarray(xn), n_valid=nv_j)):
        _close(t, j)
    _close(t_pw.row_entropies(torch.from_numpy(xn), torch.from_numpy(mask), n_valid=nv_t),
           jax.jit(j_pw.row_entropies)(jnp.asarray(xn), jnp.asarray(mask), n_valid=nv_j))


def test_tri_block_maps_match_triu_order():
    for nt in (1, 2, 3, 5, 8):
        im_t, jm_t = t_pw.tri_block_maps(nt)
        im_j, jm_j = j_pw.tri_block_maps(nt)
        np.testing.assert_array_equal(im_t, im_j)
        np.testing.assert_array_equal(jm_t, jm_j)
        ij = torch.triu_indices(nt, nt, 1)
        np.testing.assert_array_equal(ij[0].numpy(), im_j)
        np.testing.assert_array_equal(ij[1].numpy(), jm_j)


@pytest.mark.parametrize("p,block", [(20, 8), (33, 16), (7, 32)])
def test_fused_layout_matches(p, block):
    xn, c = _normalized(p, 500, seed=p + block)
    mask = np.arange(p) % 5 != 2
    out_t = t_pw.fused_layout(torch.from_numpy(xn), torch.from_numpy(c),
                              torch.from_numpy(mask), block)
    out_j = jax.jit(j_pw.fused_layout, static_argnums=3)(
        jnp.asarray(xn), jnp.asarray(c), jnp.asarray(mask), block)
    for name, t, j in zip(("xpad", "cp", "c4", "hxb", "mb", "s_diag"), out_t, out_j):
        assert tuple(t.shape) == tuple(j.shape), name
        if name == "s_diag":
            _close_scores(t, j)
        else:
            _close(t, j)


@pytest.mark.parametrize("p,n,block", [(8, 512, 8), (33, 700, 16), (20, 600, 32)])
def test_fused_scores_match(p, n, block):
    xn, c = _normalized(p, n, seed=p + block)
    mask = np.ones(p, bool)
    s_t = t_pw.fused_scores(torch.from_numpy(xn), torch.from_numpy(c),
                            torch.from_numpy(mask), block=block)
    s_j = j_pw.fused_scores(jnp.asarray(xn), jnp.asarray(c), jnp.asarray(mask),
                            block=block)
    _close_scores(s_t, s_j)


@pytest.mark.parametrize("p,n", [(16, 600), (21, 333)])
def test_dense_scores_match(p, n):
    xn, c = _normalized(p, n, seed=3 * p)
    mask = np.arange(p) % 3 != 0
    out_t = t_pw.dense_scores(torch.from_numpy(xn), torch.from_numpy(c),
                              torch.from_numpy(mask))
    out_j = j_pw.dense_scores(jnp.asarray(xn), jnp.asarray(c), jnp.asarray(mask),
                              block_j=p)
    s_t, i_t, hr_t = out_t
    s_j, i_j, hr_j = out_j
    _close_scores(s_t, s_j)
    _close(i_t, i_j)
    # HR's diagonal regresses a row on itself (1 - c_ii^2 clamps to VAR_EPS,
    # amplifying rounding by 1e6); it is never read unmasked.
    off = ~np.eye(p, dtype=bool)
    _close(hr_t.numpy()[off], np.asarray(hr_j)[off])


def test_residual_entropy_matrix_chunking_is_exact(monkeypatch):
    """Column chunks change the buffer size, not the arithmetic."""
    xn, c = _normalized(10, 300, seed=8)
    full = t_pw.residual_entropy_matrix(torch.from_numpy(xn), torch.from_numpy(c))
    monkeypatch.setattr(t_pw, "CHUNK_ELEMS", 3 * 10 * 300)
    chunked = t_pw.residual_entropy_matrix(torch.from_numpy(xn), torch.from_numpy(c))
    assert torch.equal(full, chunked)


# ---------------------------------------------------------------------------
# schedule, adjacency and the copied numpy modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p,min_bucket,ring", [(1, 32, 1), (8, 8, 1), (85, 32, 1),
                                               (512, 32, 1), (100, 16, 4)])
def test_schedule_matches(p, min_bucket, ring):
    assert (t_sched.make_schedule(p, min_bucket, ring=ring).stages
            == j_sched.make_schedule(p, min_bucket, ring=ring).stages)
    assert next_pow2(p) == j_sched.next_pow2(p)


def test_complete_order_matches():
    order = np.array([3, 0, 5, 0, 0, 2, 1], np.int32)  # 3 live, garbage tail
    mask = np.array([True, False, False, True, False, True, False])
    out_t = t_adj.complete_order(torch.from_numpy(order), torch.from_numpy(mask))
    out_j = jax.jit(j_adj.complete_order)(jnp.asarray(order), jnp.asarray(mask))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


@pytest.mark.parametrize("padded", [False, True])
def test_adjacency_from_order_matches(padded):
    """B to 1e-4 absolute and Omega to 1e-4 relative: both factor a 17x17
    float32 correlation matrix whose entries differ by a few ulps."""
    data = t_sem.generate(t_sem.SemSpec(p=17, n=800, seed=4))
    x = data["x"].astype(np.float32)
    order = np.asarray(data["order"], np.int32)
    kw_t, kw_j = {}, {}
    if padded:  # two dead rows last in the order, 100 padded sample columns
        x = np.concatenate([x, np.zeros((2, 800), np.float32)])
        x = np.concatenate([x, np.zeros((19, 100), np.float32)], axis=1)
        order = np.concatenate([order, [17, 18]]).astype(np.int32)
        mask = np.arange(19) < 17
        kw_t = dict(mask=torch.from_numpy(mask), n_valid=torch.tensor(800))
        kw_j = dict(mask=jnp.asarray(mask), n_valid=jnp.asarray(800))
    b_t, om_t = t_adj.adjacency_from_order(torch.from_numpy(x), torch.from_numpy(order),
                                           prune_below=0.05, **kw_t)
    b_j, om_j = jax.jit(j_adj.adjacency_from_order, static_argnames="prune_below")(jnp.asarray(x), jnp.asarray(order),
                                           prune_below=0.05, **kw_j)
    _close(b_t, b_j, rtol=0, atol=1e-4)
    _close(om_t, om_j, rtol=1e-4, atol=0)


def _ragged_batch(shapes, n_pad, seed):
    """Zero-padded raw datasets, their live-row masks and valid counts."""
    rng = np.random.default_rng(seed)
    p_pad = max(p for p, _ in shapes)
    x = np.zeros((len(shapes), p_pad, n_pad), np.float32)
    mask = np.zeros((len(shapes), p_pad), bool)
    for i, (p, n) in enumerate(shapes):
        x[i, :p, :n] = rng.standard_normal((p, n)) * (1 + i) + i
        mask[i, :p] = True
    nv = np.array([n for _, n in shapes], np.int32)
    return torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(nv)


def test_batched_core_equals_per_dataset_calls():
    """A leading dataset axis changes nothing: every batched call of the
    numerical core is bit-identical, dataset by dataset, to the one-dataset
    call on the CPU (normalize, covariance, both rank-1 updates with one root
    per dataset, the fused prologue, complete_order and phase 2)."""
    x, mask, nv = _ragged_batch([(21, 700), (17, 650), (21, 500)], 700, 3)
    xn = torch.where(mask[..., None], t_cov.normalize(x, n_valid=nv), 0.0)
    c = t_cov.cov_matrix(xn, n_valid=nv)
    roots = torch.tensor([2, 16, 0])
    up_x = t_cov.update_data(xn, c, roots, mask, n_valid=nv)
    up_c = t_cov.update_cov(c, roots, mask)
    layout = t_pw.fused_layout(xn, c, mask, 8, n_valid=nv)
    order = torch.stack([torch.from_numpy(np.random.default_rng(i).permutation(21))
                         for i in range(3)])
    order = torch.where(torch.arange(21) < mask.sum(1, keepdim=True), order, 0)
    perm = t_adj.complete_order(order, mask)
    b, om = t_adj.adjacency_from_order(x, perm, mask=mask, n_valid=nv, prune_below=0.05)
    for i in range(3):
        xi = torch.where(mask[i, :, None], t_cov.normalize(x[i], n_valid=nv[i]), 0.0)
        assert torch.equal(xi, xn[i])
        assert torch.equal(t_cov.cov_matrix(xi, n_valid=nv[i]), c[i])
        assert torch.equal(t_cov.update_data(xi, c[i], roots[i], mask[i], n_valid=nv[i]), up_x[i])
        assert torch.equal(t_cov.update_cov(c[i], roots[i], mask[i]), up_c[i])
        for one, many in zip(t_pw.fused_layout(xi, c[i], mask[i], 8, n_valid=nv[i]), layout):
            assert torch.equal(one, many[i])
        assert torch.equal(t_adj.complete_order(order[i], mask[i]), perm[i])
        b_i, om_i = t_adj.adjacency_from_order(x[i], perm[i], mask=mask[i], n_valid=nv[i],
                                               prune_below=0.05)
        assert torch.equal(b_i, b[i]) and torch.equal(om_i, om[i])


def test_batched_core_matches_reference_vmap():
    """The batched normalize, covariance and updates against ``jax.vmap`` of
    the JAX package's functions on the same ragged bucket."""
    x, mask, nv = _ragged_batch([(19, 600), (12, 450)], 600, 5)
    xj, mj, nvj = jnp.asarray(x.numpy()), jnp.asarray(mask.numpy()), jnp.asarray(nv.numpy())
    xn_t = torch.where(mask[..., None], t_cov.normalize(x, n_valid=nv), 0.0)
    xn_j = jax.vmap(lambda a, m, n: jnp.where(m[:, None], j_cov.normalize(a, n_valid=n), 0.0))(
        xj, mj, nvj)
    _close(xn_t, xn_j)
    c_t = t_cov.cov_matrix(xn_t, n_valid=nv)
    c_j = jax.vmap(lambda a, n: j_cov.cov_matrix(a, n_valid=n))(xn_j, nvj)
    _close(c_t, c_j)
    roots = np.array([4, 11])
    up_t = t_cov.update_data(xn_t, c_t, torch.from_numpy(roots), mask, n_valid=nv)
    up_j = jax.vmap(lambda a, cc, r, m, n: j_cov.update_data(a, cc, r, m, n_valid=n))(
        xn_j, c_j, jnp.asarray(roots), mj, nvj)
    _close(up_t, up_j)
    uc_t = t_cov.update_cov(c_t, torch.from_numpy(roots), mask)
    uc_j = jax.vmap(j_cov.update_cov)(c_j, jnp.asarray(roots), mj)
    live = np.asarray(mask[:, :, None] & mask[:, None, :])
    _close(uc_t.numpy()[live], np.asarray(uc_j)[live])


def test_cholesky_ladder_escalates_per_dataset():
    """One dataset whose correlation matrix is singular (a duplicated row)
    escalates the jitter; its neighbour in the batch keeps the smallest
    ridge, bit-identical to its own one-dataset call."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 6, 300)).astype(np.float32)
    x[0, 4] = x[0, 1]  # exactly collinear: Cholesky fails at the 1e-10 ridge
    x = torch.from_numpy(x)
    order = torch.arange(6).expand(2, 6)
    b, om = t_adj.adjacency_from_order(x, order)
    b1, om1 = t_adj.adjacency_from_order(x[1], order[1])
    assert torch.equal(b[1], b1) and torch.equal(om[1], om1)
    b0, om0 = t_adj.adjacency_from_order(x[0], order[0])
    assert torch.equal(b[0], b0) and torch.equal(om[0], om0)
    assert bool(torch.isfinite(b).all())


#: The pure-Python modules the port copies verbatim from the JAX package;
#: they may differ only in the package name of their imports and docstrings.
_COPIED = ("utils/clock.py", "serve/buckets.py", "serve/batching.py", "serve/replica.py")


@pytest.mark.parametrize("path", _COPIED)
def test_copied_python_modules_equal_reference(path):
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    with open(os.path.join(src, "repro", path)) as f:
        ref = f.read()
    with open(os.path.join(src, "repro_torch", path)) as f:
        port = f.read()
    assert port == re.sub(r"\brepro\.", "repro_torch.", ref)


def test_copied_numpy_modules_agree():
    spec = dict(p=9, n=700, density="dense", seed=7)
    d_t = t_sem.generate(t_sem.SemSpec(**spec))
    d_j = j_sem.generate(j_sem.SemSpec(**spec))
    for k in ("x", "b_true", "perm"):
        np.testing.assert_array_equal(d_t[k], d_j[k])
    assert t_sem.is_valid_causal_order(d_t["order"], d_t["b_true"])
    assert t_dl.causal_order(d_t["x"]) == j_dl.causal_order(d_j["x"])
    np.testing.assert_array_equal(
        t_prune.estimate_adjacency(d_t["x"], d_t["order"], prune_below=0.1),
        j_prune.estimate_adjacency(d_j["x"], d_j["order"], prune_below=0.1))
    bad = d_t["x"].copy()
    bad[2, 5] = np.nan
    bad[4] = bad[1]
    assert (dataclasses.asdict(t_val.validate_dataset(bad))
            == dataclasses.asdict(j_val.validate_dataset(bad)))


# ---------------------------------------------------------------------------
# public surface
# ---------------------------------------------------------------------------


def _public_imports(path):
    """Names a package ``__init__`` binds by import, leading underscore aside."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read())
    return sorted(alias.asname or alias.name for node in tree.body
                  if isinstance(node, ast.ImportFrom) for alias in node.names
                  if not (alias.asname or alias.name).startswith("_"))


def test_public_surface_matches_reference():
    """Every name of ``repro.__all__`` and every public name that
    ``repro/core/__init__.py`` imports exists in the port, and the batched
    orders have the reference's dtype."""
    import repro
    import repro.core
    import repro_torch
    import repro_torch.core

    src = os.path.join(os.path.dirname(__file__), "..", "src")
    core_names = _public_imports(os.path.join(src, "repro", "core", "__init__.py"))
    assert {"cov_matrix", "validate_dataset", "pairwise", "sem"} <= set(core_names)
    assert [n for n in repro.__all__ if not hasattr(repro_torch, n)] == []
    assert [n for n in core_names if not hasattr(repro_torch.core, n)] == []
    assert set(core_names) <= set(repro_torch.core.__all__)
    import types

    for n in core_names:  # a module stays a module, a class a class
        t, j = getattr(repro_torch.core, n), getattr(repro.core, n)
        for kind in (types.ModuleType, type):
            assert isinstance(t, kind) == isinstance(j, kind), n
        assert callable(t) == callable(j), n

    x = np.random.default_rng(5).standard_normal((2, 5, 300)).astype(np.float32)
    got = repro_torch.fit_batch(x, device="cpu").orders
    want = repro.fit_batch(jnp.asarray(x)).orders
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("name", ["core.paralingam.fit_batch", "core.paralingam.causal_order_batch",
                                  "core.paralingam.aot_fit_batch",
                                  "serve.lingam_engine.dispatch_bucket",
                                  "serve.lingam_engine.LingamEngine.__init__",
                                  "serve.async_engine.AsyncLingamEngine.__init__",
                                  "serve.lingam_engine.LingamServeConfig"])
def test_batched_and_serving_signatures_take_the_reference_parameters(name):
    """Every parameter (a dataclass: every field) of the reference's batched
    estimator and serving entry points exists in the port's counterpart,
    under the same name; the port adds ``device`` and nothing else."""
    import importlib
    import inspect

    def resolve(package):
        module, _, attr = name.partition(".")
        parts = name.split(".")
        for i in range(len(parts), 0, -1):
            try:
                obj = importlib.import_module(".".join([package] + parts[:i]))
            except ModuleNotFoundError:
                continue
            for a in parts[i:]:
                obj = getattr(obj, a)
            return obj
        raise AssertionError(name)

    def names(obj):
        if dataclasses.is_dataclass(obj):
            return [f.name for f in dataclasses.fields(obj)]
        return [p for p in inspect.signature(obj).parameters if p != "self"]

    want, got = names(resolve("repro")), names(resolve("repro_torch"))
    assert [p for p in want if p not in got] == []
    assert [p for p in got if p not in want] in ([], ["device"])


#: Reference modules whose port counterpart has another path.
_COUNTERPART = {"utils/hlo.py": "utils/collectives.py"}
#: Public names of the JAX package with no meaning in torch, by module (None:
#: the whole module). Besides these, a ``*_jit`` name passes where its base
#: name is in the port (the jitted aliases: PyTorch compiles nothing, and the
#: port keeps such a name only where callers use it), and module constants
#: (the Pallas block sizes, ``interpret`` flags) are not swept: only
#: functions and classes are.
_NO_MEANING_IN_TORCH = {
    # jax/XLA version shims (``AxisType``, ``current_mesh``, ``install``)
    "dist/compat.py": None,
    # XLA's HLO text parser: the port counts its collectives at the call
    # (``utils/collectives.CollectiveLedger``), so there is no text to parse
    "utils/hlo.py": ("parse_collectives",),
    # lowers and compiles a cell with XLA: the port traces it on fake tensors
    "launch/dryrun.py": ("compile_cell",),
    # the Pallas grids' tile arithmetic: the CUDA kernel's launcher sizes its
    # own grid (``fused_score._launch``, ``tile_maps``)
    "kernels/fused_score.py": ("tri_tile_count", "square_tile_count"),
    # the reference tests' materialized (p, p, n) oracle: the port's kernels
    # hold against their own plain versions (``fused_score_vector_ref``)
    "kernels/ref.py": ("residual_entropy_matrix_ref",),
}


def _reference_modules():
    src = os.path.join(os.path.dirname(__file__), "..", "src", "repro")
    for root, _, files in os.walk(src):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(root, f), src).replace(os.sep, "/")


def _public_defs(path) -> list:
    """Public functions and classes a module defines (not imports)."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read())
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def test_every_reference_module_definition_exists_in_the_port():
    """The sweep of every module pair: each public function and class a
    ``repro`` module defines exists in its ``repro_torch`` counterpart,
    unless ``_NO_MEANING_IN_TORCH`` lists it (with the reason)."""
    import importlib

    src = os.path.join(os.path.dirname(__file__), "..", "src")
    missing, swept = [], 0
    for rel in _reference_modules():
        skip = _NO_MEANING_IN_TORCH.get(rel, ())
        if skip is None:
            continue
        port_rel = _COUNTERPART.get(rel, rel)
        name = "repro_torch." + port_rel[:-3].replace("/", ".").removesuffix(".__init__")
        assert os.path.exists(os.path.join(src, "repro_torch", port_rel)), f"no port of {rel}"
        module = importlib.import_module(name)
        for n in _public_defs(os.path.join(src, "repro", rel)):
            swept += 1
            if n in skip or (n.endswith("_jit") and hasattr(module, n.removesuffix("_jit"))):
                continue
            if not hasattr(module, n):
                missing.append(f"{rel}:{n}")
    assert missing == []
    assert swept > 200  # the sweep reads the whole package (213 names when written)


@pytest.mark.parametrize("backend", ["host", "scan", "ring", "bogus"])
def test_resolve_order_backend_matches_reference(backend):
    """The port's ``resolve_order_backend`` names what the reference's does,
    and refuses what it refuses, on a config object of either package."""
    import types

    from repro.core import paralingam as j_pl
    from repro_torch.core import paralingam as t_pl

    cfg = types.SimpleNamespace(order_backend=backend)
    if backend == "bogus":
        with pytest.raises(j_pl.ConfigError, match="bogus"):
            j_pl.resolve_order_backend(cfg)
        with pytest.raises(t_pl.ConfigError, match="bogus"):
            t_pl.resolve_order_backend(cfg)
        return
    assert t_pl.resolve_order_backend(cfg) == j_pl.resolve_order_backend(cfg) == backend
    assert (t_pl.resolve_order_backend(t_pl.ParaLiNGAMConfig(order_backend=backend))
            == j_pl.resolve_order_backend(j_pl.ParaLiNGAMConfig(order_backend=backend)))
    assert t_pl.resolve_order_backend(types.SimpleNamespace()) == "host"


@pytest.mark.parametrize("prune_below", [0.0, 0.05])
def test_estimate_adjacency_matches_reference(prune_below):
    """Phase 2 on its own: B of the port's ``estimate_adjacency`` within the
    tolerance of ``test_adjacency_from_order_matches`` of the reference's,
    from numpy inputs, and equal to ``adjacency_from_order``'s B."""
    data = t_sem.generate(t_sem.SemSpec(p=17, n=800, seed=4))
    x = data["x"].astype(np.float32)
    order = np.asarray(data["order"], np.int32)
    b_t = t_adj.estimate_adjacency(x, order, prune_below=prune_below, device="cpu")
    b_j = j_adj.estimate_adjacency(jnp.asarray(x), jnp.asarray(order), prune_below=prune_below)
    assert b_t.shape == (17, 17) and b_t.dtype == torch.float32
    _close(b_t, b_j, rtol=0, atol=1e-4)
    b_ref, _ = t_adj.adjacency_from_order(torch.from_numpy(x), torch.from_numpy(order).long(),
                                          prune_below=prune_below)
    assert torch.equal(b_t, b_ref)


def test_estimate_adjacency_needs_a_card_without_device():
    """Without ``device`` phase 2 runs on the card, so on a host without one
    it raises the device error instead of running where its input lies."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: without device the call runs on it")
    data = t_sem.generate(t_sem.SemSpec(p=6, n=200, seed=1))
    for x in (data["x"].astype(np.float32), torch.from_numpy(data["x"].astype(np.float32))):
        with pytest.raises(RuntimeError, match="estimate_adjacency.*device='cpu'"):
            t_adj.estimate_adjacency(x, data["order"])
