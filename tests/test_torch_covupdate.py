"""The port's rank-1 update kernels' CPU route (``kernels.covupdate``,
paper Algorithms 7 and 8) against the JAX package: the plain versions and
``ops.update_data`` / ``ops.update_cov`` on CPU tensors against
``repro.kernels.ops.update_data`` / ``update_cov`` (the Pallas kernels in
interpret mode) and ``repro.kernels.ref.update_data_cov_ref``, on the cases
of ``tests/test_kernels.py::test_covupdate_matches_ref`` and an odd
(7, 130).

Tolerance: rtol/atol 1e-5 on the data and rtol 1e-5, atol 1e-6 on the
covariance, as ``tests/test_kernels.py`` holds the Pallas kernels: the plain
versions take the kernels' order of operations, with 1 / sqrt where the TPU
kernels take rsqrt, a rounding apart.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.covariance import cov_matrix as j_cov_matrix  # noqa: E402
from repro.core.covariance import normalize as j_normalize  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro_torch.kernels import covupdate as t_cu  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402

X_TOL = dict(rtol=1e-5, atol=1e-5)
C_TOL = dict(rtol=1e-5, atol=1e-6)
CASES = [(8, 512), (21, 1000), (64, 4096), (7, 130)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(p, n, root=0):
    """Normalized rows, their correlations and b = c[:, root] with the root
    zeroed, as test_kernels.py builds them (numpy out of the JAX package)."""
    x = np.random.default_rng(p).standard_normal((p, n))
    xn = j_normalize(jnp.asarray(x, jnp.float32))
    c = j_cov_matrix(xn)
    b = np.asarray(c[:, root]).copy()
    b[root] = 0.0
    return np.asarray(xn), np.asarray(c), b.astype(np.float32), np.asarray(xn)[root]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("p,n", CASES)
def test_update_data_matches_reference(p, n):
    xn, c, b, xr = _inputs(p, n)
    want_k = np.asarray(j_ops.update_data(jnp.asarray(xn), jnp.asarray(xr), jnp.asarray(b)))
    want_r, _ = j_ref.update_data_cov_ref(*map(jnp.asarray, (xn, c, b, xr)))
    before = t_cu.DATA_LAUNCHES
    for got in (t_cu.update_data_ref(*_t(xn, xr, b)), ops.update_data(*_t(xn, xr, b)),
                t_ref.update_data_cov_ref(*_t(xn, c, b, xr))[0]):
        assert got.shape == (p, n) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want_k, **X_TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_r), **X_TOL)
    assert t_cu.DATA_LAUNCHES == before  # CPU tensors take the plain version


@pytest.mark.parametrize("p,n", CASES)
def test_update_cov_matches_reference(p, n):
    xn, c, b, xr = _inputs(p, n)
    want_k = np.asarray(j_ops.update_cov(jnp.asarray(c), jnp.asarray(b)))
    _, want_r = j_ref.update_data_cov_ref(*map(jnp.asarray, (xn, c, b, xr)))
    before = t_cu.COV_LAUNCHES
    for got in (t_cu.update_cov_ref(*_t(c, b)), ops.update_cov(*_t(c, b)),
                t_ref.update_data_cov_ref(*_t(xn, c, b, xr))[1]):
        assert got.shape == (p, p)
        np.testing.assert_allclose(got.numpy(), want_k, **C_TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_r), **C_TOL)
        assert torch.equal(torch.diagonal(got), torch.ones(p))
    assert t_cu.COV_LAUNCHES == before


@pytest.mark.parametrize("root", [0, 3, 6])
def test_update_sequence_matches_reference(root):
    """Two refreshes in a row from different roots (the root row of the
    first becomes a zero-b row of the second), as Algorithms 7/8 chain."""
    xn, c, b, xr = _inputs(7, 130, root)
    jx, jc = jnp.asarray(xn), jnp.asarray(c)
    tx, tc = _t(xn, c)
    for r in (root, (root + 2) % 7):
        bj = np.asarray(jc[:, r]).copy()
        bj[r] = 0.0
        jx, jc = j_ops.update_data(jx, jx[r], jnp.asarray(bj)), j_ops.update_cov(jc, jnp.asarray(bj))
        bt = tc[:, r].clone()
        bt[r] = 0.0
        tx, tc = ops.update_data(tx, tx[r].contiguous(), bt), ops.update_cov(tc, bt)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **X_TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **C_TOL)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    xn, c, b, xr = _t(*_inputs(8, 64))
    with pytest.raises(TypeError, match="float32"):
        ops.update_data(xn.double(), xr, b)
    with pytest.raises(ValueError, match="x_root"):
        ops.update_data(xn, xr[:10], b)
    with pytest.raises(ValueError, match="contiguous"):
        ops.update_cov(c.T[:, :].t().T, b)
    with pytest.raises(ValueError, match="want c"):
        ops.update_cov(c[:4], b)
