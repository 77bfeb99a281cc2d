"""The port's baselines on the CPU against the JAX package: ICA-LiNGAM
(``core.ica_lingam``) and the polynomial scorer (``core.poly_scores``), on
the inputs of ``tests/test_ica_lingam.py`` and ``tests/test_poly_scores.py``.

Tolerances (measured on the CPU, float32 on both sides):

* ``fast_ica`` with the reference's ``jax.random.normal(key, (p, p))`` start
  carried across as ``w0``: W within rtol 1e-4, atol 1e-5 (largest
  difference 1.2e-6 on entries up to 0.54); ``ica_lingam``'s B within the
  same (largest 3.0e-6), the order equal.
* ``cross_power_moments``: each G[m, l] within 1e-5 of its absolute scale
  |X|^m (|X|^l)^T / n, the float32 error bound of a sum of n products
  (largest measured share 1.6e-6). The sums cancel (odd powers), so a
  tolerance relative to the entry itself would not be an error bound.
* ``poly_scores``: each pair moment within 1e-5 of the sum of the absolute
  values of its binomial terms (largest share 6.6e-7), and I and S within
  that bound carried through the entropy's derivative. The clamp lets a
  reach 3.16, so a^10 G[10, 0] terms of ~1e6 cancel to O(1): a plain rtol
  on I fails at entries where both packages are equally far from float64.
* ``hybrid_find_root``: the root equal to the reference's and to the exact
  dense root.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import poly_scores as j_poly  # noqa: E402
from repro.core import sem as j_sem  # noqa: E402
from repro.core.covariance import cov_matrix, normalize  # noqa: E402
from repro.core.ica_lingam import fast_ica as j_fast_ica  # noqa: E402
from repro.core.ica_lingam import ica_lingam as j_ica_lingam  # noqa: E402
from repro.core.paralingam import find_root_dense as j_find_root_dense  # noqa: E402
from repro_torch.core import entropy as t_entropy  # noqa: E402
from repro_torch.core import ica_lingam as t_ica  # noqa: E402
from repro_torch.core import poly_scores as t_poly  # noqa: E402
from repro_torch.core.paralingam import find_root_dense as t_find_root_dense  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
SUM_TOL = 1e-5  # share of a sum's absolute terms


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL)


def _jax_draw(p, seed=0):
    """The reference's random start: ``jax.random.normal(key, (p, p))``."""
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (p, p), jnp.float32))


def _mixed_sources():
    rng = np.random.default_rng(0)
    s = rng.laplace(size=(3, 20000))
    a = rng.standard_normal((3, 3)) + 2 * np.eye(3)
    return a @ s, a


def _easy_sem():
    return j_sem.generate(j_sem.SemSpec(p=5, n=20000, density="sparse", seed=3))


# -- ICA-LiNGAM ----------------------------------------------------------------


def test_fast_ica_matches_reference_start_carried_across():
    x, _ = _mixed_sources()
    want = np.asarray(j_fast_ica(x))
    w, iterations = t_ica._fast_ica(x, w0=_jax_draw(3), device="cpu")
    assert w.dtype == torch.float32 and tuple(w.shape) == (3, 3)
    assert 0 < iterations < 500
    _close(w, want)
    _close(t_ica.fast_ica(x, w0=_jax_draw(3), device="cpu"), want)


def test_fast_ica_unmixes_sources_with_its_own_generator():
    """``tests/test_ica_lingam.py::test_fast_ica_unmixes_sources`` on the
    port, its start drawn from a ``torch.Generator``."""
    x, a = _mixed_sources()
    w = t_ica.fast_ica(x, torch.Generator().manual_seed(0), device="cpu").numpy()
    m = np.abs(w @ a)
    m = m / m.max(axis=1, keepdims=True)
    assert ((m > 0.9).sum(axis=1) == 1).all()
    assert m[m < 0.9].max() < 0.35


def test_ica_lingam_matches_reference():
    data = _easy_sem()
    want_order, want_b = j_ica_lingam(data["x"])
    order, b = t_ica.ica_lingam(data["x"], w0=_jax_draw(5), device="cpu")
    assert order == want_order
    _close(b, want_b)


def test_ica_lingam_recovers_easy_graph_with_its_own_generator():
    """``tests/test_ica_lingam.py::test_ica_lingam_recovers_easy_graph`` on
    the port (default generator)."""
    data = _easy_sem()
    order, b = t_ica.ica_lingam(data["x"], device="cpu")
    assert sorted(order) == list(range(5))
    strong = np.abs(data["b_true"]) > 0.5
    assert np.abs(b - data["b_true"])[strong].mean() < 0.25


def test_fast_ica_at_ecoli_core_runs_to_max_iter_on_the_reference_too():
    """At the E. coli core size (p=85, n=10000) FastICA does not converge,
    in the reference as in the port: the covariance's condition number
    exceeds what float32 resolves, the reference's own eigh returns a
    negative eigenvalue that ``_whiten`` clamps to 1e-10, and the whitened
    directions are rounding noise scaled by ~1e5. W then depends on the
    rounding (two sums' orders part it), so the card and the CPU are held
    equal only where FastICA converges. Run with ``-s`` to read the
    numbers."""
    x = j_sem.generate(j_sem.SemSpec(p=85, n=10000, density="sparse", seed=0))["x"]
    xc = x - x.mean(axis=1, keepdims=True)
    vals64 = np.linalg.eigvalsh(xc @ xc.T / (x.shape[1] - 1))
    cov32 = (jnp.asarray(xc, jnp.float32) @ jnp.asarray(xc, jnp.float32).T) / (x.shape[1] - 1)
    vals32 = np.asarray(jnp.linalg.eigh(cov32)[0])
    cond = vals64[-1] / vals64[0]
    assert cond > 2.0**24 and vals32[0] < 0 < vals64[0]

    last, before = np.asarray(j_fast_ica(x)), np.asarray(j_fast_ica(x, max_iter=499))
    assert not np.array_equal(last, before)  # the reference's loop ran all 500 iterations
    w, iterations = t_ica._fast_ica(x, w0=_jax_draw(85), device="cpu")
    assert iterations == 500
    first_ref = np.asarray(j_fast_ica(x, max_iter=1))
    first, _ = t_ica._fast_ica(x, w0=_jax_draw(85), max_iter=1, device="cpu")
    print(f"\necoli_core cond64={cond:.3e} eig32_min={vals32[0]:.3e} eig64_min={vals64[0]:.3e} "
          f"reference_iterations=500 port_iterations={iterations} "
          f"reference_w_scale={np.abs(last).max():.3e} port_w_scale={w.abs().max().item():.3e} "
          f"diff_at_500={np.abs(w.numpy() - last).max():.3e} "
          f"diff_at_1={np.abs(first.numpy() - first_ref).max():.3e} "
          f"w_scale_at_1={np.abs(first_ref).max():.3e}")


def test_fast_ica_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_ica.fast_ica(np.ones((2, 10)))


# -- the polynomial scorer ------------------------------------------------------


def _setup(p, n, seed):
    data = j_sem.generate(j_sem.SemSpec(p=p, n=n, density="sparse", seed=seed))
    xn = normalize(jnp.asarray(data["x"], jnp.float32))
    c = cov_matrix(xn)
    return xn, c, torch.from_numpy(np.array(xn)), torch.from_numpy(np.array(c))


def _abs_moments(xn):
    """|X|^m (|X|^l)^T / n in float64: the scale of each G[m, l]'s sum."""
    a = np.abs(np.asarray(xn, np.float64))
    out = np.zeros((t_poly.MAX_POW + 1,) * 2 + (a.shape[0],) * 2)
    for m in range(t_poly.MAX_POW + 1):
        for l in range(t_poly.MAX_POW + 1 - m):
            out[m, l] = (a**m) @ (a**l).T / a.shape[1]
    return out


def _abs_poly(coeffs, parities, a, b, scale):
    """The sum of the absolute values of ``_moment_from_poly``'s terms."""
    out = 0.0
    for k, t in enumerate(parities):
        for m in range(t + 1):
            out = out + abs(coeffs[k]) * t_poly._BINOM[t, m] * np.abs(a) ** m \
                * np.abs(b) ** (t - m) * scale[m, t - m]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cross_power_moments_match(seed):
    xn, _, xt, _ = _setup(24, 4000, seed)
    want = np.asarray(j_poly.cross_power_moments(xn), np.float64)
    got = t_poly.cross_power_moments(xt).numpy().astype(np.float64)
    scale = _abs_moments(xn)
    assert got.shape == want.shape == (11, 11, 24, 24)
    unused = np.add.outer(np.arange(11), np.arange(11)) > t_poly.MAX_POW
    assert not got[unused].any() and not want[unused].any()
    assert np.all(np.abs(got - want) <= SUM_TOL * scale + 1e-30)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_poly_scores_match_within_the_sums_error_bound(seed):
    xn, c, xt, ct = _setup(24, 4000, seed)
    mask = np.ones((24,), bool)
    s_want, i_want = (np.asarray(v, np.float64) for v in j_poly.poly_scores(xn, c, jnp.asarray(mask)))
    s_got, i_got = (v.numpy().astype(np.float64) for v in
                    t_poly.poly_scores(xt, ct, torch.from_numpy(mask)))

    # The pair moments, each within SUM_TOL of its absolute terms.
    cc = np.asarray(c, np.float64)
    a = 1.0 / np.sqrt(np.maximum(1.0 - cc**2, 0.1))
    b = cc * a
    scale = _abs_moments(xn)
    even, odd = [2 * k for k in range(t_poly.K_EVEN + 1)], [2 * k + 1 for k in range(t_poly.K_ODD + 1)]
    tol1 = SUM_TOL * _abs_poly(t_poly.ALPHA, even, a, b, scale)
    tol2 = SUM_TOL * _abs_poly(t_poly.BETA, odd, a, b, scale)
    at, bt = (torch.from_numpy(v.astype(np.float32)) for v in (a, b))
    aj, bj = (jnp.asarray(v, jnp.float32) for v in (a, b))
    g_t, g_j = t_poly.cross_power_moments(xt), j_poly.cross_power_moments(xn)
    m1 = t_poly._moment_from_poly(t_poly.ALPHA, even, at, bt, g_t).numpy()
    m2 = t_poly._moment_from_poly(t_poly.BETA, odd, at, bt, g_t).numpy()
    m1_j = np.asarray(j_poly._moment_from_poly(j_poly.ALPHA, even, aj, bj, g_j))
    m2_j = np.asarray(j_poly._moment_from_poly(j_poly.BETA, odd, aj, bj, g_j))
    assert np.all(np.abs(m1 - m1_j) <= tol1) and np.all(np.abs(m2 - m2_j) <= tol2)

    # Carried into the entropies (|dH| <= |dH/dm1| tol1 + |dH/dm2| tol2 to
    # first order, doubled), then I = (Hx_j - Hx_i) + (HR_ij - HR_ji) and S.
    k1, k2, beta = t_entropy.K1, t_entropy.K2, t_entropy.BETA
    tol_h = 2 * (2 * k1 * np.abs(m1_j - beta) * tol1 + 2 * k2 * np.abs(m2_j) * tol2) + 1e-6
    tol_i = tol_h + tol_h.T
    np.fill_diagonal(tol_i, 1e-6)
    assert np.all(np.abs(i_got - i_want) <= tol_i)
    off = ~np.eye(24, dtype=bool)
    neg = np.where(off, np.abs(np.minimum(i_want, 0.0)), 0.0)
    tol_s = np.sum(2 * neg * tol_i + tol_i**2, axis=1, where=off) + 1e-6
    assert np.all(np.abs(s_got - s_want) <= tol_s)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_poly_scores_track_exact_on_the_port(seed):
    """``test_poly_scores.py::test_poly_scores_track_exact`` on the port:
    the ranking of the approximate scores against the exact dense ones."""
    _, _, xt, ct = _setup(24, 4000, seed)
    mask = torch.ones((24,), dtype=torch.bool)
    _, s_exact = t_find_root_dense(xt, ct, mask, block_j=24, score_backend="torch", device="cpu")
    s_approx, _ = t_poly.poly_scores(xt, ct, mask)
    s_exact, s_approx = s_exact.numpy(), s_approx.numpy()
    rank_e = np.argsort(np.argsort(s_exact))
    rank_a = np.argsort(np.argsort(s_approx))
    assert np.corrcoef(rank_e, rank_a)[0, 1] > 0.9
    assert int(np.argmin(s_exact)) in np.argsort(s_approx)[:6]


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_hybrid_root_equals_reference_and_exact(seed):
    xn, c, xt, ct = _setup(32, 3000, seed)
    mask = np.ones((32,), bool)
    j_root, _ = j_poly.hybrid_find_root(xn, c, jnp.asarray(mask), top_k=8)
    exact, _ = j_find_root_dense(xn, c, jnp.asarray(mask), block_j=32)
    root, score = t_poly.hybrid_find_root(xt, ct, torch.from_numpy(mask), top_k=8)
    assert int(root) == int(j_root) == int(exact)
    assert root.ndim == 0 and bool(torch.isfinite(score))


def test_hybrid_root_with_mask():
    xn, c, xt, ct = _setup(16, 2000, 7)
    mask = np.ones((16,), bool)
    mask[[3, 9]] = False
    j_root, _ = j_poly.hybrid_find_root(xn, c, jnp.asarray(mask), top_k=6)
    exact, _ = j_find_root_dense(xn, c, jnp.asarray(mask), block_j=16)
    t_exact, _ = t_find_root_dense(xt, ct, torch.from_numpy(mask), block_j=16,
                                   score_backend="torch", device="cpu")
    root, _ = t_poly.hybrid_find_root(xt, ct, torch.from_numpy(mask), top_k=6)
    assert int(root) == int(j_root) == int(exact) == int(t_exact)


def test_candidates_break_ties_toward_the_lower_index(monkeypatch):
    """``jax.lax.top_k``'s order: equal approximate scores keep the lower
    index first, so with all scores tied the candidates are 0..K-1."""
    _, _, xt, ct = _setup(16, 2000, 7)
    mask = torch.ones((16,), dtype=torch.bool)
    tied = torch.zeros((16,))
    monkeypatch.setattr(t_poly, "poly_scores", lambda xn, c, m: (tied, None))
    seen = {}
    orig = t_poly.residual_entropy_block

    def spy(xi, c_cols, xj, *a, **kw):
        seen.setdefault("cand", xi)
        return orig(xi, c_cols, xj, *a, **kw)

    monkeypatch.setattr(t_poly, "residual_entropy_block", spy)
    t_poly.hybrid_find_root(xt, ct, mask, top_k=5)
    assert torch.equal(seen["cand"], xt[:5])
