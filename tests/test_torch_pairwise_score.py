"""The square moments kernel's plain versions held against the JAX package's
Pallas kernel (interpret mode) and its entropy epilogue, on the cases of
``tests/test_kernel_moments.py``; the ``hopper`` score backend through
``fit`` against ``repro.fit``; and the wrappers' input checks. The kernel
itself runs only on the card (``test_torch_cuda.py``).

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
