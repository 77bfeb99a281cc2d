"""The port's rank-1 update kernel's CPU route (``kernels.covupdate``,
paper Algorithms 7 and 8) against the JAX package.

TPU-kernel mode: the plain versions and ``ops.update_data`` /
``ops.update_cov`` on CPU tensors against ``repro.kernels.ops.update_data``
/ ``update_cov`` (the Pallas kernels in interpret mode) and
``repro.kernels.ref.update_data_cov_ref``, on the cases of
``tests/test_kernels.py::test_covupdate_matches_ref`` and an odd (7, 130).

Fit mode: ``ops.rank1_update`` and its plain version on batched buckets
(live-row masks, one root per dataset, ``n_valid`` padding, |b| at and past
1) against ``repro.core.covariance.update_data`` / ``update_cov`` dataset by
dataset; its argument checks and launch count; and the scan's rule that the
caller's ``xn`` and ``c`` are never written.

Tolerance: rtol/atol 1e-5 on the data and rtol 1e-5, atol 1e-6 on the
covariance, as ``tests/test_kernels.py`` holds the Pallas kernels: the plain
versions take the kernels' order of operations, with 1 / sqrt where the TPU
kernels take rsqrt, a rounding apart; the fit mode's renormalization sums
its squares in another order than the JAX package, a few roundings apart.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import covariance as j_cov  # noqa: E402
from repro.core.covariance import cov_matrix as j_cov_matrix  # noqa: E402
from repro.core.covariance import normalize as j_normalize  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro_torch.core import paralingam as tp  # noqa: E402
from repro_torch.core import sem  # noqa: E402
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


def _bucket(shapes, m, n_pad, seed, retired=2, near_one=False):
    """A bucket as the scan holds it, as numpy: dataset i's p_i rows
    normalized (by the JAX package) over its n_i valid samples with zeros
    past them, its correlations, ``retired`` earlier roots dead but holding
    data, and one live root each. ``near_one`` sets live entries of column
    ``root`` of c at and past +-1, so the clip and the 1e-4 floor fire."""
    rng = np.random.default_rng(seed)
    xb = np.zeros((len(shapes), m, n_pad), np.float32)
    cb = np.zeros((len(shapes), m, m), np.float32)
    mask = np.zeros((len(shapes), m), bool)
    roots = np.zeros(len(shapes), np.int64)
    for i, (p, n) in enumerate(shapes):
        xn = np.asarray(j_normalize(jnp.asarray(rng.standard_normal((p, n)), jnp.float32)))
        xb[i, :p, :n] = xn
        cb[i] = np.asarray(j_cov_matrix(jnp.asarray(xb[i]), n_valid=jnp.asarray(n)))
        mask[i, :p] = True
        rows = rng.permutation(p)
        mask[i, rows[:retired]] = False
        roots[i] = rows[retired]
        if near_one:
            live = [r for r in rows[retired + 1:]][:6]
            cb[i, live, roots[i]] = [1.0000001, -1.0000001, 0.99999, -0.9999999, 1.0, -1.0]
    return xb, cb, roots, mask, np.array([n for _, n in shapes], np.int32)


RANK1_CASES = {
    "ragged_n_valid": ([(16, 512), (12, 400), (9, 301)], 16, 512, True, False),
    "fit_call": ([(13, 257), (13, 257)], 13, 257, False, False),  # no valid counts
    "clip_and_floor": ([(12, 300), (10, 280)], 12, 300, True, True),
}


@pytest.mark.parametrize("case", sorted(RANK1_CASES))
def test_rank1_update_plain_matches_reference(case):
    """``ops.rank1_update`` on CPU tensors (its plain version) against the
    JAX package's ``covariance.update_data`` / ``update_cov``, dataset by
    dataset, at X_TOL / C_TOL, with columns past the valid count exactly 0."""
    shapes, m, n_pad, with_nv, near_one = RANK1_CASES[case]
    xb, cb, roots, mask, nv = _bucket(shapes, m, n_pad, m + n_pad, near_one=near_one)
    n_valid = torch.from_numpy(nv) if with_nv else None
    before = t_cu.RANK1_LAUNCHES
    got_x, got_c = ops.rank1_update(*_t(xb, cb, roots, mask), n_valid)
    ref_x, ref_c = t_cu.rank1_update_ref(*_t(xb, cb, roots, mask), n_valid=n_valid)
    assert t_cu.RANK1_LAUNCHES == before  # CPU tensors take the plain version
    assert torch.equal(got_x, ref_x) and torch.equal(got_c, ref_c)
    for i in range(len(shapes)):
        nvj = jnp.asarray(nv[i]) if with_nv else None
        want_x = j_cov.update_data(jnp.asarray(xb[i]), jnp.asarray(cb[i]), int(roots[i]),
                                   jnp.asarray(mask[i]), n_valid=nvj)
        want_c = j_cov.update_cov(jnp.asarray(cb[i]), int(roots[i]), jnp.asarray(mask[i]))
        np.testing.assert_allclose(got_x[i].numpy(), np.asarray(want_x), **X_TOL)
        np.testing.assert_allclose(got_c[i].numpy(), np.asarray(want_c), **C_TOL)
        assert torch.all(got_x[i, :, shapes[i][1]:] == 0)
    if near_one:
        assert torch.all(got_c.abs() <= 1) and torch.all(torch.isfinite(got_x))


def test_rank1_update_in_place_on_the_cpu():
    """``inplace=True`` writes x' over ``xb`` and returns it; ``cb`` is
    never written; without it neither input is."""
    xb, cb, roots, mask, nv = (torch.from_numpy(a) for a in _bucket([(10, 200)] * 2, 10, 200, 4))
    x0, c0 = xb.clone(), cb.clone()
    want_x, want_c = t_cu.rank1_update_ref(xb, cb, roots, mask, n_valid=nv)
    out_x, out_c = ops.rank1_update(xb, cb, roots, mask, nv)
    assert torch.equal(xb, x0) and torch.equal(cb, c0) and torch.equal(out_x, want_x)
    got_x, got_c = ops.rank1_update(xb, cb, roots, mask, nv, inplace=True)
    assert got_x is xb and torch.equal(xb, want_x)
    assert torch.equal(cb, c0) and torch.equal(got_c, want_c)


@pytest.mark.parametrize("bad,error,match", [
    (dict(xb="double"), TypeError, "float32"),
    (dict(cb="short"), ValueError, "want xb"),
    (dict(roots="float"), TypeError, "integer"),
    (dict(mloc="int"), TypeError, "bool mask"),
    (dict(n_valid="long"), ValueError, "want xb"),
    (dict(xb="strided"), ValueError, "contiguous"),
])
def test_rank1_update_refuses_what_the_kernel_does_not_take(bad, error, match):
    xb, cb, roots, mask, nv = (torch.from_numpy(a) for a in _bucket([(8, 64)] * 2, 8, 64, 5))
    args = {"xb": xb, "cb": cb, "roots": roots, "mloc": mask, "n_valid": nv}
    change = {"double": lambda t: t.double(), "short": lambda t: t[:, :4].contiguous(),
              "float": lambda t: t.float(), "int": lambda t: t.int(),
              "long": lambda t: torch.cat([t, t]), "strided": lambda t: t.transpose(1, 2)}
    for name, how in bad.items():
        args[name] = change[how](args[name])
    before = t_cu.RANK1_LAUNCHES
    with pytest.raises(error, match=match):
        ops.rank1_update(args["xb"], args["cb"], args["roots"], args["mloc"], args["n_valid"])
    assert t_cu.RANK1_LAUNCHES == before


@pytest.mark.parametrize("backend,threshold,p,calls", [
    # p=16 starts on the caller's buffer: out of place once, then in place
    ("hopper_fused", False, 16, [False] + [True] * 14),
    # p=12 is first gathered into a 16-row buffer, the scan's own
    ("hopper", True, 12, [True] * 11),
    ("torch_fused", False, 16, [])])
def test_scan_runs_the_update_entry_and_keeps_caller_tensors(monkeypatch, backend, threshold,
                                                             p, calls):
    """Under the kernel backends the scan takes every iteration's update
    through ``ops.rank1_update`` (in place only over a buffer of its own),
    never writes the caller's ``xn`` or ``c``, and gives the plain path's
    order; the plain backends never call it."""
    from repro_torch.core.covariance import cov_matrix, normalize

    want_calls = calls
    x = sem.generate(sem.SemSpec(p=p, n=400, density="sparse", seed=6))["x"]
    xn = normalize(torch.as_tensor(x, dtype=torch.float32))[None].contiguous()
    c = cov_matrix(xn)
    x0, c0 = xn.clone(), c.clone()
    calls = []
    orig = ops.rank1_update

    def spy(xb, cb, roots, mloc, n_valid=None, *, inplace=False):
        calls.append(inplace)
        assert not (inplace and xb.data_ptr() == xn.data_ptr())
        return orig(xb, cb, roots, mloc, n_valid, inplace=inplace)

    monkeypatch.setattr(ops, "rank1_update", spy)
    order = tp._scan_order_impl(xn, c, backend=backend, min_bucket=4, threshold=threshold)[0]
    assert torch.equal(xn, x0) and torch.equal(c, c0)
    assert calls == want_calls
    plain = tp._scan_order_impl(x0, c0, backend="torch_fused", min_bucket=4,
                                threshold=threshold)[0]
    assert torch.equal(order, plain)


def test_host_driver_runs_the_update_entry(monkeypatch):
    """The host driver (``causal_order``) takes each update through
    ``ops.rank1_update`` under a kernel backend, over its own normalized
    copy, and gives the plain driver's order."""
    x = sem.generate(sem.SemSpec(p=10, n=300, density="sparse", seed=9))["x"]
    calls = []
    orig = ops.rank1_update

    def spy(*args, **kw):
        calls.append(kw.get("inplace"))
        return orig(*args, **kw)

    monkeypatch.setattr(ops, "rank1_update", spy)
    got = tp.causal_order(x, tp.ParaLiNGAMConfig(score_backend="hopper_fused", min_bucket=4),
                          device="cpu")
    assert calls == [True] * 9
    want = tp.causal_order(x, tp.ParaLiNGAMConfig(score_backend="torch_fused", min_bucket=4),
                           device="cpu")
    assert got.order == want.order


def test_scale_ulps_reads_a_one_ulp_scale():
    """The check helper: x' against itself reads 0 everywhere; one live
    row's x' scaled by 1 + 2^-23 reads about one ulp there, 0 elsewhere."""
    xb, cb, roots, mask, nv = (torch.from_numpy(a) for a in _bucket([(12, 500)], 12, 500, 8))
    want, _ = t_cu.rank1_update_ref(xb, cb, roots, mask, n_valid=nv)
    assert float(t_cu.scale_ulps(want, want, xb, cb, roots, mask).max()) == 0
    live = mask[0] & (torch.arange(12) != roots[0])
    i = int(torch.nonzero(live)[0])
    got = want.clone()
    got[0, i] *= 1 + 2 ** -23
    ulps = t_cu.scale_ulps(got, want, xb, cb, roots, mask)
    assert 0.4 <= float(ulps[0, i]) <= 2.1 and float(ulps.sum()) == float(ulps[0, i])
