"""The port's LiNGAM serving stack on the CPU: ``LingamEngine`` and
``AsyncLingamEngine`` over the torch dispatch (``fit_batch`` on
``device="cpu"``), mirroring ``tests/test_lingam_engine.py`` and
``tests/test_async_engine.py``.

The deterministic tests pump a stopped engine (``start=False``) with the
port's own ``FakeClock`` — no dispatcher thread, no sleeps. The concurrency
tests run real threads with a tiny flush interval and bounded waits.

Tolerances against a dedicated ``repro_torch.fit`` of the same request:
equal orders, B to 1e-4 absolute and noise variances to 1e-3 relative (the
JAX engine tests' bounds). A padded request differs from its unpadded fit
only by the float32 rounding of its sums; the largest differences measured
on these cases are 2.2e-6 (B) and 5.5e-6 (noise variance).
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import direct_lingam, paralingam, sem  # noqa: E402
from repro_torch.core.paralingam import ParaLiNGAMConfig, fit  # noqa: E402
from repro_torch.core.validate import DatasetError  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AsyncLingamEngine,
    BatchingConfig,
    DispatchFailed,
    LingamEngine,
    LingamServeConfig,
    QueueFull,
    RequestTimeout,
    ServeError,
    bucket_shape,
    dispatch_bucket,
    pad_dataset,
)
from repro_torch.serve import lingam_engine  # noqa: E402
from repro_torch.utils.clock import FakeClock  # noqa: E402

CFG = ParaLiNGAMConfig(min_bucket=8)
SCFG = LingamServeConfig(min_p_bucket=8, min_n_bucket=64)
CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def clock():
    return FakeClock()


def _gen(p, n, seed):
    return sem.generate(sem.SemSpec(p=p, n=n, seed=seed))["x"]


def _ref(x, cfg=CFG):
    return fit(x, cfg, **CPU)


def _ref_order(x):
    return _ref(x)[0].order


def _assert_matches_fit(f, x):
    ref, b_ref = _ref(x)
    assert f.order == ref.order
    np.testing.assert_allclose(f.b, b_ref.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(f.noise_var, ref.noise_var, rtol=1e-3)
    assert f.comparisons == ref.comparisons and f.converged
    assert f.b.shape == (x.shape[0],) * 2


def _manual_engine(clock, dispatch=None, **cfg):
    defaults = dict(max_batch=4, max_queue=64, flush_interval=1.0)
    defaults.update(cfg)
    return AsyncLingamEngine(CFG, SCFG, batch_cfg=BatchingConfig(**defaults),
                             clock=clock, dispatch=dispatch, start=False, **CPU)


def _assert_conserved(stats):
    assert stats["submitted"] == (stats["admitted"] + stats["shed"]
                                  + stats["rejected"] + stats["quarantined"])
    assert stats["admitted"] == (stats["delivered"] + stats["timeouts"]
                                 + stats["failed"] + stats["queue_depth"]
                                 + stats["in_flight"])


# -- the sync engine ----------------------------------------------------------


def test_bucket_shape_and_pad():
    assert bucket_shape(3, 10, SCFG) == (8, 64)
    assert bucket_shape(17, 300, SCFG) == (32, 512)
    padded = pad_dataset(np.ones((3, 10)), 8, 64)
    assert padded.shape == (8, 64) and padded.sum() == 30


def test_mixed_shape_requests_match_dedicated_fits():
    eng = LingamEngine(CFG, SCFG, **CPU)
    shapes = [(8, 300), (7, 256), (17, 500), (16, 512), (8, 256), (10, 400)]
    xs = [_gen(p, n, seed=i) for i, (p, n) in enumerate(shapes)]
    fits = eng.fit_many(xs)
    for x, f in zip(xs, fits):
        _assert_matches_fit(f, x)
    assert eng.stats["requests"] == len(xs)
    assert eng.stats["dispatches"] == len(eng.stats["buckets"]) == 4
    assert eng.stats["buckets"][(8, 256)] == 2


def test_engine_orders_match_serial_oracle():
    eng = LingamEngine(CFG, **CPU)
    xs = [_gen(9, 700, seed=31), _gen(13, 900, seed=32)]
    for x, f in zip(xs, eng.fit_many(xs)):
        assert f.order == direct_lingam.causal_order(x)


def test_same_bucket_shares_one_dispatch():
    eng = LingamEngine(CFG, SCFG, **CPU)
    for i in range(5):  # ragged, all land in the (16, 512) bucket
        eng.submit(_gen(9 + i, 257 + 11 * i, seed=i))
    assert eng.pending == 5
    out = eng.flush()
    assert len(out) == 5 and eng.pending == 0
    assert eng.stats["dispatches"] == 1
    assert eng.stats["buckets"] == {(16, 512): 5}


def test_max_batch_splits_dispatches():
    eng = LingamEngine(CFG, LingamServeConfig(min_p_bucket=8, min_n_bucket=64,
                                              max_batch=2), **CPU)
    xs = [_gen(8, 256, seed=i) for i in range(5)]
    fits = eng.fit_many(xs)
    assert eng.stats["dispatches"] == 3  # 2 + 2 + 1
    for x, f in zip(xs, fits):
        assert f.order == _ref_order(x)


def test_submit_rejects_bad_rank():
    eng = LingamEngine(**CPU)
    with pytest.raises(ValueError, match="p, n"):
        eng.submit(np.zeros((2, 3, 4)))


@pytest.mark.parametrize("fail_call,pending_after", [(1, 3), (2, 1)])
def test_failed_dispatch_loses_no_work(monkeypatch, fail_call, pending_after):
    """Requests of failing or undispatched buckets stay queued, and results
    of buckets that already delivered in the same flush are kept for the
    retry flush."""
    eng = LingamEngine(CFG, SCFG, **CPU)
    # two requests in bucket (8, 256), one in bucket (32, 256)
    xs = [_gen(8, 256, seed=70), _gen(8, 250, seed=71), _gen(17, 256, seed=72)]
    ids = [eng.submit(x) for x in xs]
    real_fit_batch = lingam_engine.fit_batch
    calls = {"n": 0}

    def boom(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == fail_call:
            raise RuntimeError("transient dispatch failure")
        return real_fit_batch(*args, **kwargs)

    monkeypatch.setattr(lingam_engine, "fit_batch", boom)
    with pytest.raises(RuntimeError, match="transient"):
        eng.flush()
    assert eng.pending == pending_after
    out = eng.flush()
    assert sorted(out) == sorted(ids) and eng.pending == 0
    for x, i in zip(xs, ids):
        assert out[i].order == _ref_order(x)


def test_dispatch_reads_back_in_one_copy(monkeypatch):
    """``dispatch_bucket`` packs one float32 batch and reads every result
    back through one device-to-host copy."""
    copies = []
    real = lingam_engine._read_back

    def spy(*ts):
        copies.append(len(ts))
        return real(*ts)

    monkeypatch.setattr(lingam_engine, "_read_back", spy)
    xs = [_gen(8, 256, seed=5), _gen(7, 200, seed=6), _gen(8, 250, seed=7)]
    fits = dispatch_bucket(xs, 8, 256, CFG, **CPU)
    assert copies == [6]
    for x, f in zip(xs, fits):
        _assert_matches_fit(f, x)


@pytest.mark.parametrize("engine", [LingamEngine, AsyncLingamEngine])
def test_engines_need_cuda_without_device(monkeypatch, engine):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine(CFG)


def test_engines_refuse_unported_configs():
    """Both engines refuse a ring config at construction, as the reference's
    do (they dispatch through ``fit_batch``, which has no ring form); both
    take a threshold config and serve it through ``fit_batch``."""
    ring = ParaLiNGAMConfig(order_backend="ring")
    with pytest.raises(ValueError, match="no ring form"):
        LingamEngine(ring, **CPU)
    with pytest.raises(ValueError, match="no ring form"):
        AsyncLingamEngine(ring, SCFG, start=False, **CPU)
    cfg = ParaLiNGAMConfig(threshold=True, min_bucket=8)
    x = _gen(6, 300, seed=4)
    want, _ = fit(x, cfg, device="cpu")
    got = LingamEngine(cfg, **CPU).fit_many([x])[0]
    assert got.order == want.order and got.rounds == want.rounds
    clock = FakeClock()
    eng = AsyncLingamEngine(cfg, SCFG, batch_cfg=BatchingConfig(max_batch=4, flush_interval=1.0),
                            clock=clock, start=False, **CPU)
    ticket = eng.submit(x)
    clock.advance(1.0)
    assert eng.step() > 0
    served = ticket.result(0)
    assert served.order == want.order and served.rounds == want.rounds
    assert served.converged and served.comparisons == want.comparisons
    eng.close()


# -- the async engine, deterministic (fake clock, manual pump) ----------------


def test_async_mixed_shapes_match_dedicated_fits(clock):
    eng = _manual_engine(clock)
    shapes = [(8, 300), (7, 256), (8, 256), (10, 400)]
    xs = [_gen(p, n, seed=i) for i, (p, n) in enumerate(shapes)]
    tickets = [eng.submit(x) for x in xs]
    assert eng.step() == 0  # nothing due yet, no bucket full
    clock.advance(1.0)
    assert eng.step() > 0
    for x, t in zip(xs, tickets):
        _assert_matches_fit(t.result(0), x)
    stats = eng.stats()
    assert stats["delivered"] == len(xs)
    for b in stats["buckets"].values():
        assert 0.0 <= b["padding_waste"] < 1.0
    _assert_conserved(stats)


def test_full_bucket_dispatches_without_waiting(clock):
    eng = _manual_engine(clock, max_batch=2)
    xs = [_gen(8, 256, seed=10 + i) for i in range(2)]
    tickets = [eng.submit(x) for x in xs]
    assert eng.step() == 1  # size-triggered: zero time elapsed
    assert [t.result(0).order for t in tickets] == [_ref_order(x) for x in xs]


def test_deadline_flush_and_queued_timeout(clock):
    eng = _manual_engine(clock, flush_interval=10.0, deadline_margin=0.5)
    urgent = eng.submit(_gen(8, 256, seed=20), deadline=1.0)
    clock.advance(0.5)  # due = deadline - margin, far before the 10 s age
    assert eng.step() == 1
    assert urgent.result(0).order == _ref_order(_gen(8, 256, seed=20))
    calls = []
    eng2 = _manual_engine(clock, flush_interval=10.0,
                          dispatch=lambda bucket, ps: calls.append(bucket) or [])
    late = eng2.submit(_gen(8, 256, seed=21), deadline=1.0)
    clock.advance(5.0)  # dispatcher stalled past the deadline
    assert eng2.step() == 0 and calls == []
    with pytest.raises(RequestTimeout):
        late.result(0)
    stats = eng2.stats()
    assert stats["timeouts"] == 1
    _assert_conserved(stats)


def test_shed_backpressure_counts(clock):
    eng = _manual_engine(clock, max_queue=2, overflow="shed")
    xs = [_gen(8, 256, seed=30 + i) for i in range(3)]
    eng.submit(xs[0])
    eng.submit(xs[1])
    with pytest.raises(QueueFull):
        eng.submit(xs[2])
    clock.advance(1.0)
    eng.step()
    stats = eng.stats()
    assert stats["shed"] == 1 and stats["delivered"] == 2
    _assert_conserved(stats)


def test_nan_result_is_retried_then_delivered(clock):
    calls = {"n": 0}

    def nan_once(bucket, payloads):
        out = dispatch_bucket(payloads, *bucket, CFG, **CPU)
        calls["n"] += 1
        if calls["n"] == 1:
            out[0].b = np.full_like(out[0].b, np.nan)
        return out

    eng = _manual_engine(clock, dispatch=nan_once, max_retries=1)
    x = _gen(8, 256, seed=40)
    t = eng.submit(x)
    clock.advance(1.0)
    assert eng.step() == 2  # poisoned dispatch + the retry
    f = t.result(0)
    assert f.order == _ref_order(x) and np.isfinite(f.b).all()
    stats = eng.stats()
    assert stats["retries"] == 1 and stats["delivered"] == 1


def test_nan_result_exhausts_retries_to_typed_error(clock):
    def always_nan(bucket, payloads):
        out = dispatch_bucket(payloads, *bucket, CFG, **CPU)
        for f in out:
            f.noise_var = np.full_like(f.noise_var, np.nan)
        return out

    eng = _manual_engine(clock, dispatch=always_nan, max_retries=1)
    t = eng.submit(_gen(8, 256, seed=41))
    clock.advance(1.0)
    eng.step()
    with pytest.raises(DispatchFailed, match="non-finite"):
        t.result(0)
    stats = eng.stats()
    assert stats["failed"] == 1 and stats["delivered"] == 0
    _assert_conserved(stats)


def test_construction_contracts():
    with pytest.raises(ValueError, match="max_batch"):
        AsyncLingamEngine(CFG, LingamServeConfig(max_batch=4),
                          batch_cfg=BatchingConfig(max_batch=8), start=False, **CPU)
    eng = AsyncLingamEngine(CFG, SCFG, start=False, **CPU)
    with pytest.raises(ValueError, match="p, n"):
        eng.submit(np.zeros((2, 3, 4)))


def test_kernel_bypass_stays_zero_in_engine_stats(clock):
    """A padded dispatch under the kernel backend keeps the kernel route
    (its plain version on the CPU): ``kernel_bypass`` reads 0, and so does
    ``auto_downgrade`` for an explicit backend."""
    x = _gen(7, 200, seed=95)  # ragged -> padded -> n_valid set
    ref = _ref_order(x)
    paralingam.reset_dispatch_stats()
    kcfg = ParaLiNGAMConfig(min_bucket=8, score_backend="hopper_fused")
    eng = AsyncLingamEngine(kcfg, SCFG, batch_cfg=BatchingConfig(flush_interval=1.0),
                            clock=clock, start=False, **CPU)
    t = eng.submit(x)
    clock.advance(1.0)
    eng.step()
    assert t.result(0).order == ref
    st = eng.stats()
    assert st["kernel_bypass"] == 0 and st["auto_downgrade"] == 0
    paralingam.reset_dispatch_stats()


def test_prewarm_populates_cache_and_results_bit_identical(clock):
    """Pre-warming runs one fit per bucket ahead of traffic; a request
    served after the warm-up is bit-identical to the same dispatch without
    it."""
    eng = _manual_engine(clock)
    x = _gen(7, 100, seed=41)
    eng.prewarm([x.shape])
    stats = eng.stats()
    assert stats["prewarm"]["buckets"] == 1
    assert stats["prewarm"]["compile_seconds"] > 0.0
    t = eng.submit(x)
    clock.advance(1.0)
    eng.step()
    cold = dispatch_bucket([x], 8, 128, CFG, **CPU)[0]
    warm = t.result(0)
    assert warm.order == cold.order == _ref_order(x)
    assert np.array_equal(warm.b, cold.b) and np.array_equal(warm.noise_var, cold.noise_var)
    eng.close()


def test_prewarm_shapes_dedupe_into_buckets(clock):
    eng = _manual_engine(clock)
    eng.prewarm([(7, 100), (8, 128), (5, 70)])  # one (8, 128) bucket
    assert eng._warmed == {(8, 128)}
    assert eng.stats()["prewarm"]["buckets"] == 1
    eng.close()


def test_invalid_dataset_rejected_at_submit(clock):
    eng = _manual_engine(clock)
    bad = _gen(6, 80, seed=42)
    bad[2, 5] = np.nan
    with pytest.raises(DatasetError, match="non-finite"):
        eng.submit(bad)
    assert eng.stats()["invalid_datasets"] == 1
    assert eng.stats()["submitted"] == 0  # never reached the queue
    eng2 = AsyncLingamEngine(
        CFG, LingamServeConfig(min_p_bucket=8, min_n_bucket=64, validate=False),
        batch_cfg=BatchingConfig(max_batch=4, flush_interval=1.0),
        clock=clock, start=False, **CPU)
    eng2.submit(bad)  # accepted: the caller opted out of the guardrail
    eng2.close(drain=False)
    eng.close()


# -- the async engine, concurrent (real clock, background threads) ------------


def test_four_concurrent_submitters_match_dedicated_fits():
    datasets = [_gen(8, 128 + 32 * (i % 2), seed=50 + i) for i in range(6)]
    refs = [_ref_order(x) for x in datasets]
    failures = []
    with AsyncLingamEngine(CFG, SCFG, batch_cfg=BatchingConfig(
            max_batch=4, max_queue=64, flush_interval=0.005), **CPU) as eng:

        def worker(w):
            try:
                for i, x in enumerate(datasets):
                    f = eng.fit(x, timeout=300)
                    if f.order != refs[i]:
                        failures.append((w, i, f.order))
            except Exception as e:  # noqa: BLE001 — surfaced via `failures`
                failures.append((w, repr(e)))

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        assert all(not th.is_alive() for th in threads)
        assert failures == []
        stats = eng.stats()
        assert stats["delivered"] == 4 * len(datasets)
        _assert_conserved(stats)


def test_failed_dispatch_loses_no_work_concurrent():
    """4 submitter threads against a dispatch seam that fails transiently:
    every request is delivered with its dedicated-fit order or failed with a
    typed error — never dropped, never hung."""
    datasets = [_gen(8, 128 + 32 * (i % 2), seed=80 + i) for i in range(5)]
    refs = [_ref_order(x) for x in datasets]
    calls = {"n": 0}
    lock = threading.Lock()

    def flaky(bucket, payloads):
        with lock:
            calls["n"] += 1
            k = calls["n"]
        if k in (1, 3):
            raise RuntimeError(f"transient dispatch failure #{k}")
        return dispatch_bucket(payloads, *bucket, CFG, **CPU)

    eng = AsyncLingamEngine(CFG, SCFG, batch_cfg=BatchingConfig(
        max_batch=4, max_queue=64, flush_interval=0.005, max_retries=2),
        dispatch=flaky, **CPU)
    outcomes = []

    def worker(w):
        for i, x in enumerate(datasets):
            try:
                f = eng.fit(x, timeout=300)
                outcomes.append("ok" if f.order == refs[i] else "bad")
            except Exception as e:  # noqa: BLE001
                outcomes.append(e)

    threads = [threading.Thread(target=worker, args=(w,), daemon=True) for w in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    assert all(not th.is_alive() for th in threads)
    eng.close()
    assert len(outcomes) == 4 * len(datasets)
    assert all(o == "ok" or isinstance(o, ServeError) for o in outcomes)
    stats = eng.stats()
    assert stats["dispatch_failures"] >= 1 and stats["retries"] >= 1
    assert stats["delivered"] == sum(1 for o in outcomes if o == "ok")
    assert stats["queue_depth"] == 0 and stats["in_flight"] == 0
    _assert_conserved(stats)


def test_replicated_engine_with_pool_stats():
    """replicas=2 with real threads: results equal dedicated fits, and the
    stats carry a pool section with per-replica health."""
    datasets = [_gen(8, 128, seed=60 + i) for i in range(6)]
    refs = [_ref_order(x) for x in datasets]
    eng = AsyncLingamEngine(CFG, SCFG, batch_cfg=BatchingConfig(
        max_batch=2, max_queue=64, flush_interval=0.005), replicas=2, **CPU)
    try:
        tickets = [eng.submit(x) for x in datasets]
        for t, ref in zip(tickets, refs):
            assert t.result(300).order == ref
        stats = eng.stats()
        pool = stats["pool"]
        assert len(pool["replicas"]) == 2
        assert all(r["state"] == "healthy" for r in pool["replicas"])
        assert sum(r["dispatches"] for r in pool["replicas"]) == stats["dispatches"]
        assert stats["kernel_bypass"] == 0
        _assert_conserved(stats)
    finally:
        eng.close(timeout=10)
