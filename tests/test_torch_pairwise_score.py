"""The square moments kernel's plain versions held against the JAX package's
Pallas kernel (interpret mode) and its entropy epilogue, on the cases of
``tests/test_kernel_moments.py``, with and without live-row masks and valid
counts (dead pairs exactly 0, a padded buffer with ``n_valid`` bit-equal to
the unpadded one, the masked entries reaching no score); the ``hopper``
score backend through ``fit`` against ``repro.fit``; the wrappers' input
checks; and the kernel build's library name, which hashes the headers the
sources include. The kernel itself runs only on the card
(``test_torch_cuda.py``).

Tolerances:

* Raw sums: ``pairwise_score.sum_tolerance``, 64 float32 ulps of
  sum_k (|u_ij[k]| + 1) per entry, the bound ``chip_smoke.py`` holds the
  kernel to. The two sides round each residual alike up to the last bit of
  1 / sqrt (Pallas takes ``rsqrt``) and sum in different orders; measured
  at p=13, n=700: 9.5e-3 of the bound. A sample shifted by one position
  moves almost every sum beyond it. Only off-diagonal entries are held: the
  (i, i) residual is rounding noise amplified by up to 1e6 (c_ii ~ 1), and
  the two implementations disagree there by up to 0.7 (the JAX package's
  own ``test_pairwise_moments_raw_sums_match_oracle`` fails on it). The
  diagonal never reaches a score.
* Entropies after the epilogue: rtol 1e-5, atol 1e-5 off the diagonal, as
  ``tests/test_kernel_moments.py`` holds its kernel route.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro  # noqa: E402
from repro.core import sem  # noqa: E402
from repro.core.covariance import cov_matrix, normalize  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels.pairwise_score import pairwise_moments as j_moments  # noqa: E402
from repro_torch.core import paralingam as tp  # noqa: E402
from repro_torch.core import pairwise as t_pairwise  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pairwise_score as ps  # noqa: E402
import repro_torch  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _setup(p, n, seed):
    rng = np.random.default_rng(seed)
    xn = jax.jit(normalize)(jnp.asarray(rng.standard_normal((p, n)), jnp.float32))
    return np.array(xn), np.array(jax.jit(cov_matrix)(xn))


def _off(a):
    a = np.asarray(a)
    return a[~np.eye(a.shape[0], a.shape[1], dtype=bool)]


def test_plain_sums_match_pallas_kernel():
    xn, c = _setup(13, 700, seed=1)  # 13 % 8 != 0, 700 % 512 != 0
    j1, j2 = j_moments(jnp.asarray(xn), jnp.asarray(xn), jnp.asarray(c), interpret=True)
    x, ct = torch.from_numpy(xn), torch.from_numpy(c)
    t1, t2 = ops.pairwise_moments(x, x, ct)
    tol = _off(ps.sum_tolerance(x, x, ct).numpy())
    for j, t in ((j1, t1), (j2, t2)):
        assert np.all(np.abs(_off(t.numpy()) - _off(j)) <= tol)
    # The bound refuses a wrong sample pairing.
    w1, _ = ops.pairwise_moments(x, torch.roll(x, 1, dims=1).contiguous(), ct)
    assert np.mean(np.abs(_off(w1.numpy()) - _off(t1.numpy())) > tol) > 0.5


def test_entropy_epilogue_matches_reference():
    xn, c = _setup(11, 900, seed=2)
    h_ref = np.asarray(j_ops.residual_entropy_matrix(jnp.asarray(xn), jnp.asarray(c)))
    x, ct = torch.from_numpy(xn), torch.from_numpy(c)
    h = ops.residual_entropy_matrix(x, ct)
    np.testing.assert_allclose(_off(h.numpy()), _off(h_ref), rtol=1e-5, atol=1e-5)
    # The square backend's seam in core.pairwise runs the same finalize.
    hb = t_pairwise.residual_entropy_block(x, ct, x, backend="hopper")
    assert torch.equal(hb, h)
    np.testing.assert_allclose(_off(h.numpy()),
                               _off(t_pairwise.residual_entropy_matrix(x, ct).numpy()),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,n_pad", [(300, 512), (700, 1600)])
def test_sums_invariant_to_zero_padding(n, n_pad):
    """Zero sample columns add exactly 0 and the sums run chunk by chunk
    from sample 0, so padding n leaves them bit for bit as they were; the
    epilogue with ``n_valid`` gives the unpadded entropies."""
    xn, c = _setup(9, n, seed=3)
    x, ct = torch.from_numpy(xn), torch.from_numpy(c)
    xp = torch.zeros((9, n_pad))
    xp[:, :n] = x
    for a, b in zip(ps.pairwise_moments(x, x, ct), ps.pairwise_moments(xp, xp, ct)):
        assert torch.equal(a, b)
    h_pad = ops.residual_entropy_matrix(xp, ct, n_valid=torch.tensor(n))
    assert torch.equal(h_pad, ops.residual_entropy_matrix(x, ct))


def test_batched_plain_equals_per_dataset():
    xs = [_setup(20, 600, seed=s) for s in (4, 5, 6)]
    xb = torch.from_numpy(np.stack([x for x, _ in xs]))
    cb = torch.from_numpy(np.stack([c for _, c in xs]))
    m1, m2 = ops.pairwise_moments_batch(xb, cb)
    nv = torch.tensor([600, 500, 400])
    hb = ops.residual_entropy_matrix_batch(xb, cb, n_valid=nv)
    for i in range(3):
        o1, o2 = ops.pairwise_moments(xb[i], xb[i], cb[i])
        assert torch.equal(m1[i], o1) and torch.equal(m2[i], o2)
        assert torch.equal(hb[i], ops.residual_entropy_matrix(xb[i], cb[i], n_valid=nv[i]))


def test_wrappers_check_their_inputs():
    x = torch.zeros((4, 10))
    c = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="want c"):
        ps.pairwise_moments(x, x, torch.zeros((4, 3)))
    with pytest.raises(TypeError, match="float32"):
        ps.pairwise_moments(x.double(), x.double(), c.double())
    with pytest.raises(ValueError, match="contiguous"):
        ps.pairwise_moments(x, x, c.t())
    with pytest.raises(ValueError, match="sample axes"):
        ps.pairwise_moments(x, torch.zeros((4, 11)), c)
    with pytest.raises(ValueError, match=r"\(B, p, n\)"):
        ps.pairwise_moments_batch(x, c)


@pytest.mark.parametrize("p,ref_backend", [(8, "pallas"), (17, "xla")])
def test_fit_hopper_matches_reference(p, ref_backend):
    """``fit(score_backend="hopper")`` on the CPU runs the plain square
    sums; its order equals ``repro.fit``'s (through the Pallas kernel in
    interpret mode at p=8, the square jnp path at p=17, which keeps
    interpret-mode time down)."""
    ref_cfg = repro.ParaLiNGAMConfig(score_backend=ref_backend, min_bucket=8)
    cfg = tp.config_from_reference(dataclasses.asdict(ref_cfg))
    cfg = dataclasses.replace(cfg, score_backend="hopper")
    for seed in range(2):
        x = sem.generate(sem.SemSpec(p=p, n=800, density="sparse", seed=seed))["x"]
        ref, _ = repro.fit(x, ref_cfg)
        res, b = repro_torch.fit(x, cfg, device="cpu")
        assert res.order == ref.order, (p, seed)
        assert res.per_iteration == ref.per_iteration
        assert bool(torch.all(torch.isfinite(b)))


def _masked(p, n, n_pad, seed, fill=0.0):
    """Rows and correlations of ``_setup`` with every fourth row dead, held at
    0 as the pipeline holds them, the rows padded to ``n_pad`` samples with
    ``fill``: (numpy rows, numpy c, padded torch rows, torch c, torch mask)."""
    xn, c = _setup(p, n, seed)
    mask = np.arange(p) % 4 != 1
    xn = np.where(mask[:, None], xn, 0.0).astype(np.float32)
    c = np.where(mask[:, None] & mask[None, :], c, 0.0).astype(np.float32)
    xp = torch.full((p, n_pad), fill)
    xp[:, :n] = torch.from_numpy(xn)
    return xn, c, xp, torch.from_numpy(c), torch.from_numpy(mask)


@pytest.mark.parametrize("pj", [13, 5])
def test_plain_masked_n_valid_sums_match_pallas_kernel(pj):
    """The plain version under live-row masks and ``n_valid`` on a padded
    buffer, against the Pallas kernel (interpret mode) on the unpadded rows:
    live off-diagonal sums within ``sum_tolerance``; pairs with a dead row
    exactly 0."""
    xn, c, xp, ct, mask = _masked(13, 700, 1024, seed=7)
    j1, j2 = j_moments(jnp.asarray(xn), jnp.asarray(xn[:pj]), jnp.asarray(c[:, :pj]),
                       interpret=True)
    xj, cj, mj = xp[:pj].contiguous(), ct[:, :pj].contiguous(), mask[:pj].contiguous()
    nv = torch.tensor(700)
    t1, t2 = ps.pairwise_moments(xp, xj, cj, live_i=mask, live_j=mj, n_valid=nv)
    live = (mask[:, None] & mj[None, :]).numpy()
    sel = live & ~np.eye(13, pj, dtype=bool)
    tol = ps.sum_tolerance(xp, xj, cj, nv).numpy()
    for j, t in ((j1, t1), (j2, t2)):
        t = t.numpy()
        assert np.all(t[~live] == 0)
        assert np.all(np.abs(t[sel] - np.asarray(j)[sel]) <= tol[sel])


@pytest.mark.parametrize("fill", [0.0, float("nan")])
@pytest.mark.parametrize("n,n_pad", [(300, 512), (700, 1600)])
def test_plain_n_valid_padding_is_bit_exact(n, n_pad, fill):
    """With ``n_valid`` the plain sums of a padded buffer are the unpadded
    plain sums, bit for bit, whatever the padding holds; under masks too."""
    xn, c, xp, ct, mask = _masked(9, n, n_pad, seed=3, fill=fill)
    x = torch.from_numpy(xn)
    nv = torch.tensor(n)
    for kw in ({}, {"live_i": mask, "live_j": mask}):
        for a, b in zip(ps.pairwise_moments(xp, xp, ct, n_valid=nv, **kw),
                        ps.pairwise_moments(x, x, ct, **kw)):
            assert torch.equal(a, b)


def test_dead_pairs_are_exactly_zero():
    """A pair with a dead row gets exactly 0 by select, even where the dead
    row holds NaN; the live pairs' sums are those of an unmasked call."""
    xn, c = _setup(11, 600, seed=8)
    x, ct = torch.from_numpy(xn), torch.from_numpy(c)
    mask = torch.tensor([i not in (0, 4, 10) for i in range(11)])
    xnan = torch.where(mask[:, None], x, torch.nan).contiguous()
    live = mask[:, None] & mask[None, :]
    free = ps.pairwise_moments(x, x, ct)
    for a, b in zip(ps.pairwise_moments(xnan, xnan, ct, live_i=mask, live_j=mask), free):
        assert torch.equal(a[~live], torch.zeros(int((~live).sum())))
        assert torch.equal(a[live], b[live])


def test_batched_masked_plain_equals_per_dataset():
    """Under masks and per-dataset valid counts, dataset b of the batched
    entry equals the one-dataset entry on dataset b, bit for bit."""
    xs = [_setup(20, 600, seed=s) for s in (4, 5, 6)]
    xb = torch.from_numpy(np.stack([x for x, _ in xs]))
    cb = torch.from_numpy(np.stack([c for _, c in xs]))
    mb = torch.from_numpy(np.arange(20)[None, :] % (np.arange(3)[:, None] + 2) != 0)
    nv = torch.tensor([600, 500, 400])
    m1, m2 = ops.pairwise_moments_batch(xb, cb, mask=mb, n_valid=nv)
    hb = ops.residual_entropy_matrix_batch(xb, cb, mask=mb, n_valid=nv)
    for i in range(3):
        o1, o2 = ops.pairwise_moments(xb[i], xb[i], cb[i], live_i=mb[i], live_j=mb[i],
                                      n_valid=nv[i])
        assert torch.equal(m1[i], o1) and torch.equal(m2[i], o2)
        assert torch.equal(hb[i], ops.residual_entropy_matrix(xb[i], cb[i], mask=mb[i],
                                                              n_valid=nv[i]))


def test_masked_entries_reach_scores_only_through_select():
    """The masked HR matrix differs from the unmasked one only on dead
    pairs, and those reach no score: ``scores_from_stats`` drops them by
    select, so the dense find-root's scores are the same bits either way."""
    xs = [_setup(16, 500, seed=s) for s in (9, 10)]
    xb = torch.from_numpy(np.stack([x for x, _ in xs]))
    cb = torch.from_numpy(np.stack([c for _, c in xs]))
    mb = torch.ones((2, 16), dtype=torch.bool)
    mb[0, [2, 7]] = False
    mb[1, [0, 15]] = False
    nv = torch.tensor([500, 450])
    hx = t_pairwise.row_entropies(xb, mb, n_valid=nv)
    masked = ops.residual_entropy_matrix_batch(xb, cb, mask=mb, n_valid=nv)
    free = ops.residual_entropy_matrix_batch(xb, cb, n_valid=nv)
    live = mb[:, :, None] & mb[:, None, :]
    assert torch.equal(masked[live], free[live])
    s_masked = t_pairwise.scores_from_stats(t_pairwise.pair_stat_matrix(hx, masked), mb)
    s_free = t_pairwise.scores_from_stats(t_pairwise.pair_stat_matrix(hx, free), mb)
    assert torch.equal(s_masked, s_free)
    roots, s = tp._find_root_dense_impl(xb, cb, mb, block_j=8, backend="hopper", n_valid=nv)
    assert torch.equal(s, s_masked)
    assert torch.equal(roots, torch.argmin(s_free, dim=-1))


def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """A kernel's library name changes when its source, or a header beside
    it that the sources include, changes: an edited header never loads a
    stale library."""
    from repro_torch.kernels import _build

    (tmp_path / "k.cu").write_text('#include "m.cuh"\n')
    (tmp_path / "m.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (tmp_path / "m.cuh").write_text("// v2\n")
    second = _build.library_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "m.cuh"\n// edited\n')
    assert _build.library_path("k") not in (first, second)
