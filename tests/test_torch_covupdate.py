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


# -- the data rows' launch plan (``covupdate.update_plan``), on the CPU

#: (kind, batch, m, n) of fit- and ring-mode launches: the E. coli and p=512
#: fits' first stages, the E. coli dispatch's stages, the ring's (1, 2, 1)
#: and (1, 2, 2) blocks, odd n, and each of ``SUM_ORDER_SHAPES`` as one
#: dataset.
PLAN_SHAPES = sorted({(t_cu.MODE_FIT, 1, 128, 10_000), (t_cu.MODE_FIT, 1, 512, 2000),
                      (t_cu.MODE_FIT, 8, 128, 16384), (t_cu.MODE_FIT, 8, 64, 16384),
                      (t_cu.MODE_FIT, 8, 32, 16384), (t_cu.MODE_RING, 64, 128, 10_000),
                      (t_cu.MODE_RING, 64, 128, 5000), (t_cu.MODE_FIT, 2, 37, 1301),
                      (t_cu.MODE_FIT, 3, 21, 1001), (t_cu.MODE_FIT, 2, 64, 9215)}
                     | {(t_cu.MODE_FIT, 1, rows, n) for rows, n in t_cu.SUM_ORDER_SHAPES})
FORCED = [{}] + [dict(cluster=k) for k in (1, 2, 4)] + [dict(rows=r) for r in (2, 4, 8)]


def _plans(shape):
    for force in FORCED:
        try:
            yield force, t_cu.update_plan(*shape, **force)
        except ValueError:
            assert force, f"the plan refuses {shape} unforced"


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_runs_cover_each_read_exactly_once(shape):
    """Each CTA of a row stages runs that hold every column its replayed
    torch threads read, heads and tails included, and the CTAs' runs
    together hold each column of the row exactly once, at every shift the
    bucket's rows take."""
    kind, batch, m, n = shape
    rows = batch * m if kind == t_cu.MODE_FIT else batch
    for force, plan in _plans(shape):
        o = plan["order"]
        cols = np.zeros(n, np.int64)
        for cta in plan["shares"]:
            for a, b in cta["runs"]:
                assert 0 <= a < b <= n
                cols[a:b] += 1
        assert np.all(cols == 1), (force, plan["shares"])
        for shift in sorted({(r * n) & 3 for r in range(min(rows, 4))}):
            seen = np.zeros(n, np.int64)
            for (u, c), read in t_cu.aten_reads(n, shift, o).items():
                flat = u + c * o["threads"]
                owner = [cta for cta in plan["shares"]
                         if cta["threads"][0] <= flat < cta["threads"][1]]
                assert len(owner) == 1
                held = np.zeros(n, bool)
                for a, b in owner[0]["runs"]:
                    held[a:b] = True
                assert all(held[e] for e in read), (force, shift, u, c)
                seen[read] += 1
            assert np.all(seen == 1), (force, shift)


def _aten_sum(sq, shift, o, nv):
    """torch.sum of one row of float32 squares in ATen's order, thread by
    thread (``aten_reads``: element e of a vector adds into accumulator e
    - e0 mod 4, head and tail into the first), then the warp shuffles over
    x and the tree over y (``ctas`` 1). Columns at or past ``nv`` are +0,
    as the plain version's squares hold them."""
    f = np.float32
    sq = np.where(np.arange(len(sq)) < nv, sq, 0).astype(np.float32)
    e0 = (4 - shift) & 3 if o["vec"] else 0
    vals = []
    for u, read in sorted(t_cu.aten_reads(len(sq), shift, o, nv).items()):
        acc = [f(0)] * 4
        for j, e in enumerate(read):
            if not o["vec"]:
                slot = j & 3
            elif e < e0 or e >= e0 + 4 * ((len(sq) - e0) // 4):
                slot = 0
            else:
                slot = (e - e0) & 3
            acc[slot] = f(acc[slot] + sq[e])
        vals.append(f(f(f(acc[0] + acc[1]) + acc[2]) + acc[3]))
    return _trees(np.array(vals, np.float32), o)


def _trees(vals, o):
    """ATen's shuffles down over each warp's 32 lanes, then its tree over
    the bh warps (the bw = 32 layouts of the cluster and warp paths)."""
    f = np.float32
    warps = []
    for y in range(0, len(vals), 32):
        v = list(vals[y:y + 32])
        for off in (16, 8, 4, 2, 1):
            v = [f(v[x] + v[x + off]) if x + off < 32 else v[x] for x in range(32)]
        warps.append(v[0])
    off = len(warps) // 2
    while off:
        warps = [f(warps[y] + warps[y + off]) if y < off else warps[y] for y in range(len(warps))]
        off //= 2
    return warps[0]


def _cluster_sum(sq, plan, nv):
    """The kernel's cluster path on one row: CTA r stages its runs (run j
    at local vector j * share), replays its torch threads from them, and
    writes its warps' partials where every CTA reads them; then the tree."""
    f = np.float32
    o, k = plan["order"], plan["k"]
    t, share = o["threads"], o["threads"] // plan["k"]
    nvv = min(len(sq) // 4, -(-nv // 4))
    sq4 = np.where(np.arange(len(sq)) < nv, sq, 0).astype(np.float32).reshape(-1, 4)
    partials = np.zeros(t // 32, np.float32)
    for r in range(k):
        v0 = r * share
        local = np.zeros((len(plan["shares"][r]["runs"]) * share, 4), np.float32)
        for j, (a, b) in enumerate(plan["shares"][r]["runs"]):
            local[j * share:j * share + (b - a) // 4] = sq4[a // 4:b // 4]
        vals = []
        for ul in range(share):
            acc = [f(0)] * 4
            L, v = ul, v0 + ul
            while v < nvv:
                acc = [f(acc[i] + local[L, i]) for i in range(4)]
                L, v = L + share, v + t
            vals.append(f(f(f(acc[0] + acc[1]) + acc[2]) + acc[3]))
        for w in range(share // 32):
            one = dict(o, threads=32)
            partials[v0 // 32 + w] = _trees(np.array(vals[32 * w:32 * w + 32], np.float32), one)
    out = list(partials)
    off = len(out) // 2
    while off:
        out = [f(out[y] + out[y + off]) if y < off else out[y] for y in range(len(out))]
        off //= 2
    return out[0]


@pytest.mark.parametrize("shape,force,nv", [
    ((t_cu.MODE_FIT, 1, 128, 10_000), dict(cluster=4), 10_000),
    ((t_cu.MODE_FIT, 1, 128, 10_000), dict(cluster=2), 9_001),
    ((t_cu.MODE_FIT, 1, 128, 10_000), dict(cluster=1), 7_777),
    ((t_cu.MODE_FIT, 8, 128, 16384), {}, 9_904),
    ((t_cu.MODE_RING, 64, 128, 10_000), {}, 10_000),
    ((t_cu.MODE_FIT, 2, 64, 9216), dict(cluster=4), 8_197),
])
def test_cluster_sum_is_atens_sum_bit_for_bit(shape, force, nv):
    """A float32 emulation of the cluster path's partitioned sum (each CTA
    on its own runs, the partials exchanged, the tree run by every CTA)
    equals a sequential emulation of ATen's order bit for bit, valid count
    ending mid-run included."""
    plan = t_cu.update_plan(*shape, **force)
    assert plan["path"] == t_cu.PATH_CLUSTER
    n = shape[3]
    x = np.random.default_rng(n + nv).standard_normal(n).astype(np.float32)
    sq = (x * x).astype(np.float32)
    want = _aten_sum(sq, 0, plan["order"], nv)
    got = _cluster_sum(sq, plan, nv)
    assert np.float32(got).tobytes() == np.float32(want).tobytes()


@pytest.mark.parametrize("n,nv", [(2000, 2000), (5000, 5000), (8003, 7777)])
def test_warp_sum_is_atens_sum_bit_for_bit(n, nv):
    """The warp path's sum (lane x adds vectors x, x + 32, .. of its row,
    then the shuffles) is ATen's one-warp order."""
    o = t_cu.torch_sum_order(512, n)
    assert not o["split"] and o["threads"] == 32
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    sq = (x * x).astype(np.float32)
    want = _aten_sum(sq, (511 * n) & 3, o, nv)
    if n % 4 == 0:
        f = np.float32
        sq4 = np.where(np.arange(n) < nv, sq, 0).astype(np.float32).reshape(-1, 4)
        vals = []
        for lane in range(32):
            acc = [f(0)] * 4
            for v in range(lane, -(-nv // 4), 32):
                acc = [f(acc[i] + sq4[v, i]) for i in range(4)]
            vals.append(f(f(f(acc[0] + acc[1]) + acc[2]) + acc[3]))
        assert np.float32(_trees(np.array(vals, np.float32), o)).tobytes() == \
            np.float32(want).tobytes()
    else:  # odd n takes the row path: ATen's own order, which _aten_sum is
        assert t_cu.update_plan(t_cu.MODE_FIT, 1, 512, n)["path"] == t_cu.PATH_ROW


def test_plan_picks_the_documented_paths():
    """The paths and sizes the design note names at the main path's shapes."""
    p = t_cu.update_plan
    assert (p(t_cu.MODE_FIT, 1, 128, 10_000)["path"], p(t_cu.MODE_FIT, 1, 128, 10_000)["k"]) \
        == (t_cu.PATH_CLUSTER, 4)
    assert p(t_cu.MODE_FIT, 8, 128, 16384)["k"] == 1  # 1,024 rows: one CTA each
    assert p(t_cu.MODE_RING, 64, 128, 10_000)["k"] == 4
    assert (p(t_cu.MODE_FIT, 1, 512, 2000)["path"], p(t_cu.MODE_FIT, 1, 512, 2000)["rows"]) \
        == (t_cu.PATH_WARPS, 2)
    assert p(t_cu.MODE_RING, 64, 128, 5000)["rows"] == 1
    assert p(t_cu.MODE_FIT, 2, 37, 1301)["path"] == t_cu.PATH_ROW
    assert not p(t_cu.MODE_FIT, 1, 40, 131_072)["staged"]
    with pytest.raises(ValueError):
        p(t_cu.MODE_FIT, 1, 512, 2000, cluster=2)
    with pytest.raises(ValueError):
        p(t_cu.MODE_FIT, 1, 128, 10_000, rows=2)
