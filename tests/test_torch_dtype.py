"""The estimator in float64 (``ParaLiNGAMConfig(dtype=torch.float64)``) on
the CPU, held against the JAX package's float64 estimator, which runs only
under ``jax.enable_x64``: ``fit`` and ``fit_batch`` (with ``n_valid`` and
masks), the square (``auto``) and fused (``torch_fused``) plain paths, dense
and threshold, ``find_root_dense``, the host driver, ``config_from_reference``
of a float64 reference config, the ring at one shard and on two gloo ranks,
and ``LingamEngine``. Also: float32 configs give what they gave before, and
float64 runs no update kernel (``dispatch_stats["rank1_update"]``).

The reference runs inside the ``x64`` fixture, which restores the flag when
the test ends (``jax.enable_x64`` as a context manager), and only with
float64 configs: under x64 the reference's float32 threshold ``fit`` raises
a ``lax.cond`` dtype error (``src/repro/core/paralingam.py:444, 475``).
This module imports no JAX at its top: the spawned gloo ranks import it.

What is held: orders, comparison counts and the per-iteration records
equal; B to ``B_ATOL`` = 1e-12 absolute and the noise variances to
``NV_RTOL`` = 1e-12 relative. Both packages factor float64 correlation
matrices that differ in the last bits of their sums; over the 27 fits of
``test_fit_matches_reference`` and ``test_threshold_fit_matches_reference``
the largest differences measured on the CPU are 4.8e-14 (B) and 2.2e-14
(noise variance, relative). A batched row is held bit-equal to the fit of
its dataset alone in the same padded layout (the rows do not depend on the
batch), and a served fit to its dataset's dispatch alone in its bucket; a
zero-padded dataset differs from its unpadded ``fit`` by the rounding of its
sums (at most 3.5e-15 in B here), so those are held to the tolerances.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import adjacency as t_adj  # noqa: E402
from repro_torch.core import direct_lingam, sem  # noqa: E402
from repro_torch.core import pairwise as t_pw  # noqa: E402
from repro_torch.core import paralingam as tp  # noqa: E402
from repro_torch.kernels import covupdate as cu  # noqa: E402
from repro_torch.kernels import fused_score as fs  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AsyncLingamEngine,
    BatchingConfig,
    LingamEngine,
    LingamServeConfig,
    bucket_shape,
    dispatch_bucket,
)
from repro_torch.serve.lingam_engine import pack_bucket  # noqa: E402
from repro_torch.utils.clock import FakeClock  # noqa: E402
import repro_torch  # noqa: E402

B_ATOL, NV_RTOL = 1e-12, 1e-12
F64 = torch.float64
CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ref():
    """The JAX package, imported here (not at the top: the gloo ranks
    import this module)."""
    jax = pytest.importorskip("jax")
    import repro
    from repro.core import paralingam as j_pl

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, repro=repro, pl=j_pl)


@pytest.fixture
def x64(ref):
    """``ref`` with the JAX package in float64 for the test, the flag
    restored after it."""
    with ref.jax.enable_x64(True):
        yield ref


def _gen(p, n, seed):
    return sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=seed))["x"]


def _cfgs(ref, **kw):
    """A float64 reference config and the port's config mapped from it."""
    r = ref.repro.ParaLiNGAMConfig(dtype=ref.jnp.float64, **kw)
    return r, tp.config_from_reference(dataclasses.asdict(r))


def _assert_fit(res, b, want, b_want):
    assert res.order == want.order
    assert res.comparisons == want.comparisons and res.rounds == want.rounds
    assert res.per_iteration == want.per_iteration
    assert b.dtype == F64 and res.noise_var.dtype == np.float64
    np.testing.assert_allclose(b.numpy(), np.asarray(b_want), rtol=0, atol=B_ATOL)
    np.testing.assert_allclose(res.noise_var, np.asarray(want.noise_var), rtol=NV_RTOL)


# ---------------------------------------------------------------------------
# fit, fit_batch, find_root_dense, the host driver
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["auto", "xla_fused"])
@pytest.mark.parametrize("p", [8, 17, 33])
def test_fit_matches_reference(x64, p, backend):
    ref_cfg, cfg = _cfgs(x64, score_backend=backend)
    assert cfg.dtype == F64
    for seed in range(3):
        x = _gen(p, 600, seed)
        want, b_want = x64.repro.fit(x, ref_cfg)
        res, b = repro_torch.fit(x, cfg, **CPU)
        _assert_fit(res, b, want, b_want)


@pytest.mark.parametrize("p", [8, 17, 33])
def test_threshold_fit_matches_reference(x64, p):
    """The threshold scan: every iteration's comparisons and rounds equal
    (gamma and the partial scores are float64 on both sides)."""
    ref_cfg, cfg = _cfgs(x64, threshold=True)
    for seed in range(3):
        x = _gen(p, 600, seed)
        want, b_want = x64.repro.fit(x, ref_cfg)
        res, b = repro_torch.fit(x, cfg, **CPU)
        _assert_fit(res, b, want, b_want)


def _ragged(raw, p_pad, n_pad):
    xs = np.zeros((len(raw), p_pad, n_pad))
    mask = np.zeros((len(raw), p_pad), bool)
    nv = np.zeros((len(raw),), np.int32)
    for i, x in enumerate(raw):
        p, n = x.shape
        xs[i, :p, :n] = x
        mask[i, :p] = True
        nv[i] = n
    return xs, mask, nv


@pytest.mark.parametrize("kw", [dict(), dict(score_backend="xla_fused"), dict(threshold=True)],
                         ids=["auto", "torch_fused", "threshold"])
def test_fit_batch_matches_reference(x64, kw):
    """Ragged datasets zero-padded into one (3, 32, 256) bucket with
    ``n_valid`` and masks: each row's order, counters, B and noise variances
    against the reference's batched fit, and each row bit-equal to its
    dataset's batch of one in the same layout."""
    ref_cfg, cfg = _cfgs(x64, min_bucket=8, **kw)
    raw = [_gen(17, 250, 1), _gen(32, 256, 2), _gen(8, 200, 3)]
    xs, mask, nv = _ragged(raw, 32, 256)
    res = repro_torch.fit_batch(xs, cfg, mask=mask, n_valid=nv, **CPU)
    want = x64.pl.fit_batch(xs, ref_cfg, mask=mask, n_valid=nv)
    assert res.b.dtype == F64
    assert res.orders.tolist() == np.asarray(want.orders).tolist()
    assert res.comparisons.tolist() == np.asarray(want.comparisons).tolist()
    assert res.rounds.tolist() == np.asarray(want.rounds).tolist()
    np.testing.assert_allclose(res.b.numpy(), np.asarray(want.b), rtol=0, atol=B_ATOL)
    np.testing.assert_allclose(res.noise_var.numpy(), np.asarray(want.noise_var),
                               rtol=NV_RTOL, atol=0)
    for i, x in enumerate(raw):
        p = x.shape[0]
        one = repro_torch.fit_batch(xs[i:i + 1], cfg, mask=mask[i:i + 1], n_valid=nv[i:i + 1],
                                    **CPU)
        for field in ("orders", "comparisons", "rounds", "b", "noise_var"):
            assert torch.equal(getattr(res, field)[i], getattr(one, field)[0]), (i, field)
        fit_i, b_i = repro_torch.fit(x, cfg, **CPU)
        assert res.orders[i, :p].tolist() == fit_i.order
        np.testing.assert_allclose(res.b[i, :p, :p].numpy(), b_i.numpy(), rtol=0, atol=B_ATOL)


@pytest.mark.parametrize("backend", ["torch", "torch_fused"])
def test_find_root_dense_matches_reference(x64, backend):
    """Float64 operands keep their dtype: the square path's scores are
    float64, the fused path's float32 (its sweep casts, as ``xla_fused``
    does), each within the reference's rounding."""
    j_backend = {"torch": "xla", "torch_fused": "xla_fused"}[backend]
    x = _gen(17, 800, 5)
    xn = x64.repro.core.covariance.normalize(x64.jnp.asarray(x, x64.jnp.float64))
    c = x64.repro.core.covariance.cov_matrix(xn)
    mask = np.arange(17) % 5 != 2
    root_j, s_j = x64.pl.find_root_dense(xn, c, x64.jnp.asarray(mask), score_backend=j_backend)
    root, s = tp.find_root_dense(torch.from_numpy(np.array(xn)), torch.from_numpy(np.array(c)),
                                 torch.from_numpy(mask), score_backend=backend, **CPU)
    assert int(root) == int(root_j)
    assert s.dtype == (F64 if backend == "torch" else torch.float32)
    assert str(s.dtype).removeprefix("torch.") == str(s_j.dtype)
    live = torch.from_numpy(mask)
    rtol = 1e-10 if backend == "torch" else 1e-4
    np.testing.assert_allclose(s[live].double().numpy(), np.asarray(s_j, np.float64)[mask],
                               rtol=rtol)
    assert torch.all(torch.isinf(s[~live]))


@pytest.mark.parametrize("threshold", [False, True], ids=["dense", "threshold"])
def test_host_causal_order_matches_reference(x64, threshold):
    ref_cfg, cfg = _cfgs(x64, min_bucket=8, threshold=threshold, gamma0=1e-6)
    x = _gen(17, 1800, 17)
    want = x64.pl.causal_order(x, ref_cfg)
    res = repro_torch.core.causal_order(x, cfg, **CPU)
    assert res.order == want.order and res.per_iteration == want.per_iteration
    assert res.comparisons == want.comparisons and res.rounds == want.rounds
    assert tp.causal_order_scan(x, cfg, **CPU).order == want.order


def test_config_from_reference_maps_the_dtype(ref):
    """The reference's ``jnp.float64`` (a dataclass field, with or without
    x64) maps to ``torch.float64``, float32 to float32; the config takes
    torch and numpy dtypes and their names, and refuses anything else."""
    for jdt, want in ((ref.jnp.float64, F64), (ref.jnp.float32, torch.float32)):
        d = dataclasses.asdict(ref.repro.ParaLiNGAMConfig(dtype=jdt))
        assert tp.config_from_reference(d).dtype == want
    for spelling in (torch.float64, np.float64, np.dtype("float64"), "float64"):
        assert tp.ParaLiNGAMConfig(dtype=spelling).dtype == F64
    assert tp.ParaLiNGAMConfig().dtype == torch.float32
    for bad in (torch.float16, np.int32, "bfloat16", "torch.float64"):
        with pytest.raises(tp.ConfigError, match="float32 or float64"):
            tp.ParaLiNGAMConfig(dtype=bad)


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

RING_P, RING_N = 17, 1800


def _ring_cases():
    return [dict(min_bucket=8), dict(min_bucket=8, threshold=True, chunk=16, gamma0=1e-6)]


def job_ring_f64(mesh):
    """This rank's float64 ring orders over a (1, 2, 1) ring mesh."""
    from repro_torch.dist.ring_order import causal_order_ring
    from repro_torch.launch.mesh import make_ring_mesh

    ring = make_ring_mesh(1, 2, 1, device_type="cpu")
    x = _gen(RING_P, RING_N, RING_P)
    return [causal_order_ring(x, tp.ParaLiNGAMConfig(order_backend="ring", dtype=F64, **kw),
                              mesh=ring, device="cpu").order for kw in _ring_cases()]


SHARD_CFG = dict(min_bucket=8, dtype=F64)
SHARD_SCFG = LingamServeConfig(min_p_bucket=8, min_n_bucket=64)


def shard_requests():
    """Ragged float64 requests, every one padded in n (two buckets)."""
    return [_gen(7 + (i % 3), 200 + 40 * (i % 2), seed=70 + i) for i in range(5)]


def _fit_fields(f) -> tuple:
    return (f.order, f.b, f.noise_var, f.comparisons, f.rounds, f.converged)


def job_engines_f64(mesh):
    """Float64 ``fit_batch(rules=)``, ``LingamEngine(rules=)`` and
    ``AsyncLingamEngine(rules=)`` over the (2, 1) data ranks, on every
    rank (the async engine's fits on the leader only)."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import make_rules
    from repro_torch.launch.mesh import make_local_mesh

    cfg = tp.ParaLiNGAMConfig(**SHARD_CFG)
    rules = make_rules(cfg, make_local_mesh(2, 1, device_type="cpu"))
    reqs = shard_requests()
    xs, mask, nv, _ = pack_bucket(reqs, 16, 256, dtype=np.float64)
    res = repro_torch.fit_batch(xs, cfg, mask=mask, n_valid=nv, rules=rules, **CPU)
    out = {"batch": {k: getattr(res, k).numpy() for k in ("orders", "b", "noise_var")},
           "sync": [_fit_fields(f) for f in LingamEngine(cfg, SHARD_SCFG, rules,
                                                         **CPU).fit_many(reqs)]}
    eng = AsyncLingamEngine(cfg, SHARD_SCFG, rules, batch_cfg=BatchingConfig(
        max_batch=8, flush_interval=0.005), **CPU)
    if dist.get_rank() == 0:
        out["async"] = [_fit_fields(eng.fit(x, timeout=100)) for x in reqs]
    eng.close(timeout=60)
    return out


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    """Each of two gloo ranks' float64 ring orders and sharded fits."""
    from test_torch_tp import run_grid

    return run_grid((2, 1), [("orders", job_ring_f64, {}), ("engines", job_engines_f64, {})],
                    tmp_path_factory.mktemp("dtype_ranks"))


def test_ring_matches_the_scan(gloo_ranks):
    """The float64 ring at one shard (no process group) and on two gloo
    ranks gives the port's float64 scan order, dense and threshold."""
    x = _gen(RING_P, RING_N, RING_P)
    scans = [tp.causal_order_scan(x, tp.ParaLiNGAMConfig(dtype=F64, **kw), **CPU).order
             for kw in _ring_cases()]
    one = [tp.causal_order(x, tp.ParaLiNGAMConfig(order_backend="ring", dtype=F64, **kw),
                           **CPU).order for kw in _ring_cases()]
    assert one == scans
    assert [r["orders"] for r in gloo_ranks] == [scans, scans]


def test_sharded_engines_equal_one_rank(gloo_ranks):
    """Over two data ranks, the float64 batched fit and both engines (the
    async one's fits on its leader) give one rank's float64 results bit
    for bit: every rank the whole batch, each served fit its dataset's
    dispatch alone in its bucket."""
    cfg = tp.ParaLiNGAMConfig(**SHARD_CFG)
    reqs = shard_requests()
    xs, mask, nv, _ = pack_bucket(reqs, 16, 256, dtype=np.float64)
    one = repro_torch.fit_batch(xs, cfg, mask=mask, n_valid=nv, **CPU)
    alone = [_fit_fields(dispatch_bucket([x], *bucket_shape(*x.shape, SHARD_SCFG), cfg,
                                         SHARD_SCFG, **CPU)[0]) for x in reqs]
    for rank in gloo_ranks:
        got = rank["engines"]
        for k in ("orders", "b", "noise_var"):
            assert np.array_equal(got["batch"][k], getattr(one, k).numpy()), k
        assert got["batch"]["b"].dtype == np.float64
        fits = got["sync"] + got.get("async", [])
        assert len(fits) == len(reqs) * (2 if "async" in got else 1)
        for f, want in zip(fits, alone + alone):
            assert f[0] == want[0] and f[3:] == want[3:]
            assert np.array_equal(f[1], want[1]) and np.array_equal(f[2], want[2])
    assert "async" in gloo_ranks[0]["engines"]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_lingam_engine_float64_fits_equal_dedicated_fits():
    """Float64 requests of mixed shapes through ``LingamEngine`` and a
    stopped ``AsyncLingamEngine``: each fit bit-equal to its dataset's
    float64 dispatch alone in its bucket, and, where its shape fills the
    bucket, to its float64 ``fit``; the others have the ``fit``'s order and
    its B within the tolerance."""
    cfg = tp.ParaLiNGAMConfig(min_bucket=8, dtype=F64)
    scfg = LingamServeConfig(min_p_bucket=8, min_n_bucket=64)
    shapes = [(8, 256), (7, 256), (17, 500), (16, 512), (8, 300)]
    xs = [_gen(p, n, seed=i) for i, (p, n) in enumerate(shapes)]
    eng = AsyncLingamEngine(cfg, scfg, batch_cfg=BatchingConfig(max_batch=4, flush_interval=1.0),
                            clock=FakeClock(), start=False, **CPU)
    tickets = [eng.submit(x) for x in xs]
    eng.close()
    for fits in (LingamEngine(cfg, scfg, **CPU).fit_many(xs), [t.result(0) for t in tickets]):
        for x, f in zip(xs, fits):
            bucket = bucket_shape(*x.shape, scfg)
            alone = dispatch_bucket([x], *bucket, cfg, scfg, **CPU)[0]
            assert f.b.dtype == np.float64
            assert f.order == alone.order
            assert np.array_equal(f.b, alone.b) and np.array_equal(f.noise_var, alone.noise_var)
            res, b = repro_torch.fit(x, cfg, **CPU)
            assert f.order == res.order
            if x.shape == bucket:
                assert np.array_equal(f.b, b.numpy()) and np.array_equal(f.noise_var,
                                                                         res.noise_var)
            np.testing.assert_allclose(f.b, b.numpy(), rtol=0, atol=B_ATOL)


def test_pack_bucket_float32_is_the_float64_pack_rounded_once():
    raw = [_gen(7, 100, 1), _gen(8, 120, 2)]
    xs32, mask32, nv32, _ = pack_bucket(raw, 8, 128)
    xs64, mask64, nv64, _ = pack_bucket(raw, 8, 128, dtype=np.float64)
    assert xs32.dtype == np.float32 and xs64.dtype == np.float64
    assert np.array_equal(xs32, xs64.astype(np.float32))
    assert np.array_equal(mask32, mask64) and np.array_equal(nv32, nv64)


# ---------------------------------------------------------------------------
# float32 unchanged; no update kernel under float64
# ---------------------------------------------------------------------------


def test_float32_results_unchanged(ref):
    """The default config is float32, and every float32 spelling gives the
    default's bits; the results hold what ``tests/test_torch_fit.py`` holds
    for float32 (the reference's order, B within 2e-4)."""
    x = _gen(17, 600, 0)
    want, b_want = ref.repro.fit(x, ref.repro.ParaLiNGAMConfig())
    base, b_base = repro_torch.fit(x, tp.ParaLiNGAMConfig(), **CPU)
    assert b_base.dtype == torch.float32 and base.order == want.order
    np.testing.assert_allclose(b_base.numpy(), np.asarray(b_want), rtol=0, atol=2e-4)
    xs = np.stack([x, _gen(17, 600, 1)])
    batch = repro_torch.fit_batch(xs, tp.ParaLiNGAMConfig(), **CPU)
    for kw, spellings in ((dict(), (torch.float32, np.float32, "float32")),
                          (dict(score_backend="hopper_fused"), (torch.float32,)),
                          (dict(threshold=True), (torch.float32,))):
        res0, b0 = repro_torch.fit(x, tp.ParaLiNGAMConfig(**kw), **CPU)
        for spelling in spellings:
            res, b = repro_torch.fit(x, tp.ParaLiNGAMConfig(dtype=spelling, **kw), **CPU)
            assert res.order == res0.order and torch.equal(b, b0)
            assert np.array_equal(res.noise_var, res0.noise_var)
    again = repro_torch.fit_batch(xs, tp.ParaLiNGAMConfig(dtype="float32"), **CPU)
    assert torch.equal(again.b, batch.b) and torch.equal(again.orders, batch.orders)
    assert torch.equal(batch.b[0], b_base)


def test_float64_runs_no_update_kernel(monkeypatch):
    """Under ``hopper_fused`` a float64 fit, batch, host order and ring order
    call the score kernel's wrapper on float32 copies once per find-root and
    never the update kernel's (``dispatch_stats["rank1_update"]`` stays 0);
    a float32 fit calls both once per iteration."""
    calls = {"update": 0, "ring_update": 0, "score": []}
    rank1, ring, vec, batch = (cu.rank1_update, cu.ring_update, fs.fused_score_vector,
                               fs.fused_score_batch)

    def spy_rank1(*a, **kw):
        calls["update"] += 1
        return rank1(*a, **kw)

    def spy_ring(*a, **kw):
        calls["ring_update"] += 1
        return ring(*a, **kw)

    def spy_score(fn):
        def call(xb, cb, *a, **kw):
            calls["score"].append((xb.dtype, cb.dtype))
            return fn(xb, cb, *a, **kw)
        return call

    monkeypatch.setattr(cu, "rank1_update", spy_rank1)
    monkeypatch.setattr(cu, "ring_update", spy_ring)
    monkeypatch.setattr(fs, "fused_score_vector", spy_score(vec))
    monkeypatch.setattr(fs, "fused_score_batch", spy_score(batch))
    tp.reset_dispatch_stats()
    x = _gen(17, 600, 3)
    cfg = tp.ParaLiNGAMConfig(score_backend="hopper_fused", min_bucket=8, dtype=F64)
    res, b = repro_torch.fit(x, cfg, **CPU)
    repro_torch.fit_batch(x[None], cfg, **CPU)
    host = repro_torch.core.causal_order(x, cfg, **CPU)
    ring_order = tp.causal_order(x, dataclasses.replace(cfg, order_backend="ring"), **CPU)
    assert calls["update"] == calls["ring_update"] == 0
    assert tp.dispatch_stats_snapshot()["rank1_update"] == 0
    assert len(calls["score"]) == 3 * 16 and set(calls["score"]) == {(torch.float32,) * 2}
    assert host.order == res.order and b.dtype == F64
    assert ring_order.order == tp.causal_order_scan(
        x, dataclasses.replace(cfg, score_backend="hopper"), **CPU).order
    f32, _ = repro_torch.fit(x, dataclasses.replace(cfg, dtype=torch.float32), **CPU)
    assert calls["update"] == 16 and len(calls["score"]) == 4 * 16


def test_plain_chunks_bound_bytes():
    """The plain path's chunk holds as many bytes in float64 as in float32:
    half as many elements."""
    x32 = torch.zeros(3, dtype=torch.float32)
    assert t_pw._chunk_elems(x32) == t_pw.CHUNK_ELEMS
    assert t_pw._chunk_elems(x32.double()) == t_pw.CHUNK_ELEMS // 2


def test_estimate_adjacency_keeps_the_dtype():
    data = sem.generate(sem.SemSpec(p=9, n=400, seed=2))
    x, order = data["x"], data["order"]
    assert t_adj.estimate_adjacency(x, order, **CPU).dtype == F64
    assert t_adj.estimate_adjacency(x.astype(np.float32), order, **CPU).dtype == torch.float32
    b = t_adj.estimate_adjacency(x, order, config=tp.ParaLiNGAMConfig(), **CPU)
    assert b.dtype == torch.float32
    res, b_fit = repro_torch.fit(x, tp.ParaLiNGAMConfig(dtype=F64), **CPU)
    np.testing.assert_allclose(t_adj.estimate_adjacency(x, res.order, **CPU).numpy(),
                               b_fit.numpy(), rtol=0, atol=B_ATOL)


def test_direct_lingam_oracle_is_float64():
    """The serial oracle the p=64 fixtures and ``chip_smoke.py``'s E. coli
    order are held to works in float64 (``direct_lingam.causal_order``)."""
    x = _gen(8, 2500, 0)
    cfg = tp.ParaLiNGAMConfig(min_bucket=8, dtype=F64)
    assert repro_torch.fit(x, cfg, **CPU)[0].order == direct_lingam.causal_order(x)
