"""Request storms against the port's serving stack on the CPU: the ports of
``tests/test_serve_storm.py`` and of ``tests/test_replica.py``'s engine chaos
storm, and the stranded-ticket storms of the replica pool.

``AsyncLingamEngine`` drains its queue with ``serve.async_engine.
ServingPool``, the reference's ``ReplicaPool`` plus one rule: when no replica
can take work (each is dead, or wedged in a dispatch whose budget the
watchdog has expired), the queue fails with a typed ``DispatchFailed``
instead of waiting for a hang that may never end. The reference's pool
fails its queue only once every replica is dead, so a wedged last replica
strands its requeued tickets (at seed 23 of the pool storm below, 1 of 10,
in every run; the reference engine's chaos storm at seeds 6 and 7 alike).

Every storm here runs to its end without ``ChaosDispatcher.release_all``:
each ticket resolves, delivered or with a typed ``ServeError``, within a
bounded number of clock steps, and the stats ledger balances. A delivered
fit is bit-equal to a dedicated dispatch of its dataset alone in its bucket
(``dispatch_bucket``; the batched fit's rows do not depend on the batch), and
its order is a dedicated ``fit``'s.

The threaded storms advance a ``FakeClock`` by 0.25 s every 10 ms of host
time (5 ms in the bare pool storm), as the reference's chaos storm does.
The engine storm's watchdog budget is 60 s of that clock (2.4 s of host
time), which no CPU fit of these buckets comes near (a fit takes ~20 ms
here), so only the injected hangs expire; it runs at the reference's budget
of 1 s too (40 ms of host time), which CPU fits trip.

This module imports no JAX: the JAX package plays no part in these storms.
"""

import functools
import random
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

from hypothesis import HealthCheck, given, settings, strategies as st  # noqa: E402

from repro_torch.core import sem  # noqa: E402
from repro_torch.core.paralingam import ParaLiNGAMConfig, fit  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AsyncLingamEngine,
    BatchingConfig,
    BatchingCore,
    BucketQuarantined,
    ChaosDispatcher,
    DispatchFailed,
    EngineClosed,
    LingamServeConfig,
    QueueFull,
    ReplicaCrashed,
    ReplicaPoolConfig,
    ServeError,
    ServingPool,
    bucket_shape,
    dispatch_bucket,
)
from repro_torch.serve.replica import DEAD  # noqa: E402
from repro_torch.utils.clock import FakeClock  # noqa: E402

CFG = ParaLiNGAMConfig(min_bucket=8)
SCFG = LingamServeConfig(min_p_bucket=8, min_n_bucket=64)
CPU = dict(device="cpu")
SHAPES = [(6, 100), (7, 120), (8, 90), (9, 140)]  # 2 buckets: (8, 128), (16, 256)
#: Every fault kind of ``ChaosDispatcher``, weighted as the reference's storms.
ALL_FAULTS = {"exc": 2, "reject": 2, "partial": 1, "hang": 1, "crash": 1}
#: Clock steps a storm may take to resolve every ticket.
MAX_STEPS = 3000
#: The engine storm's watchdog budget, seconds of the fake clock.
ENGINE_BUDGET = 60.0

STORM_SETTINGS = settings(max_examples=5, deadline=None,
                          suppress_health_check=[HealthCheck.too_slow])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _gen(p, n, seed):
    return sem.generate(sem.SemSpec(p=p, n=n, seed=seed))["x"]


@functools.lru_cache(maxsize=None)
def _dataset(i: int) -> np.ndarray:
    p, n = SHAPES[i]
    return _gen(p, n, seed=100 + i)


@functools.lru_cache(maxsize=None)
def _ref_order(i: int) -> tuple:
    return tuple(fit(_dataset(i), CFG, **CPU)[0].order)


def _assert_conserved(stats):
    assert stats["submitted"] == (stats["admitted"] + stats["shed"]
                                  + stats["rejected"] + stats["quarantined"])
    assert stats["admitted"] == (stats["delivered"] + stats["timeouts"]
                                 + stats["failed"] + stats["queue_depth"]
                                 + stats["in_flight"])


def _assert_dedicated(f, x):
    """A delivered fit: bit-equal to its dataset's dispatch alone in its
    bucket, with a dedicated ``fit``'s order."""
    alone = dispatch_bucket([x], *bucket_shape(*x.shape, SCFG), CFG, SCFG, **CPU)[0]
    assert f.order == alone.order == fit(x, CFG, **CPU)[0].order
    assert np.array_equal(f.b, alone.b) and np.array_equal(f.noise_var, alone.noise_var)
    assert (f.comparisons, f.rounds, f.converged) == (
        alone.comparisons, alone.rounds, alone.converged)


def _drive(clk, tickets, pause: float) -> int:
    """Advance ``clk`` 0.25 s per ``pause`` of host time until every ticket
    is done; returns the steps taken (MAX_STEPS + 1 if some never was)."""
    for step in range(MAX_STEPS + 1):
        if all(t.done() for t in tickets):
            return step
        clk.advance(0.25)  # flush aging, watchdog budgets, cooldowns
        time.sleep(pause)  # scheduling yield; no timing depends on it
    return MAX_STEPS + 1


# ---------------------------------------------------------------------------
# the stranded-ticket storms
# ---------------------------------------------------------------------------


def _pool_storm(pool_cls, seed):
    """The pool storm: a bare core with an identity dispatch, 3 threaded
    replicas, every fault kind (hangs included), 10 requests over two
    buckets. Returns ``(pool, chaos, tickets, steps)``."""
    clk = FakeClock()
    ident = lambda bucket, payloads: list(payloads)  # noqa: E731
    chaos = [ChaosDispatcher(ident, seed + 100 + i, weights=ALL_FAULTS, fault_rate=0.3,
                             max_faults=6) for i in range(3)]
    core = BatchingCore(None, BatchingConfig(max_batch=4, max_queue=64, flush_interval=0.05,
                                             max_retries=2, max_failovers=4), clock=clk)
    pool = pool_cls(core, ReplicaPoolConfig(replicas=3, dispatch_budget=1.0,
                                            suspect_threshold=2, quarantine_cooldown=0.5),
                    chaos, start=True)
    tickets = [core.submit(i, bucket="AB"[i % 2]) for i in range(10)]
    return pool, chaos, tickets, _drive(clk, tickets, 0.005)


@pytest.mark.parametrize("seed", [21, 22, 23, 24, 25])
def test_pool_storm_every_ticket_resolves(seed):
    """ROADMAP queue 3's reproducer: at seed 23 two replicas crash and the
    third hangs; the watchdog requeues its batch and no thread is left to
    take it. ``ServingPool`` fails it, typed, and shuts intake."""
    pool, chaos, tickets, steps = _pool_storm(ServingPool, seed)
    try:
        assert steps <= MAX_STEPS, f"stranded tickets (seed={seed})"
        for i, t in enumerate(tickets):
            if t.error() is None:
                assert t.result(0) == i  # exact payload, never swapped
            else:
                assert isinstance(t.error(), ServeError)
        snap = pool.core.snapshot()
        assert snap["queue_depth"] == 0 and snap["in_flight"] == 0
        _assert_conserved(snap)
        if pool._stuck:  # seed 23 in every run here: dead, dead, wedged
            assert sum(r.state == DEAD for r in pool.replicas) == 2
            assert pool.snapshot()["watchdog_expiries"] >= 1
            failed = [t.error() for t in tickets if t.error() is not None]
            assert any(isinstance(e, DispatchFailed) and "no replica can take work" in str(e)
                       for e in failed)
            with pytest.raises(EngineClosed):
                pool.core.submit(99, bucket="A")
    finally:
        for ev in chaos:
            ev.release_all()
        pool.close(timeout=5)


def test_last_live_replica_wedged_fails_the_queue():
    """One replica crashes on its first call, the other hangs on its first:
    once the watchdog expires the hang, no replica can take work, and every
    ticket fails with the typed reason; intake is shut. Without the rule
    the requeued tickets would wait for the hang."""
    clk = FakeClock()
    release = threading.Event()

    def crash(bucket, payloads):
        raise ReplicaCrashed("injected")

    def hang(bucket, payloads):
        release.wait()
        return list(payloads)

    core = BatchingCore(None, BatchingConfig(max_batch=4, flush_interval=0.05,
                                             max_failovers=8), clock=clk)
    pool = ServingPool(core, ReplicaPoolConfig(replicas=2, dispatch_budget=1.0),
                       [crash, hang], start=True)
    try:
        tickets = [core.submit(i, bucket="A") for i in range(3)]
        assert _drive(clk, tickets, 0.005) <= MAX_STEPS
        assert all(isinstance(t.error(), DispatchFailed)
                   and "no replica can take work" in str(t.error()) for t in tickets)
        assert [r.state for r in pool.replicas][0] == DEAD
        with pytest.raises(EngineClosed):
            core.submit(9, bucket="A")
        _assert_conserved(core.snapshot())
    finally:
        release.set()
        pool.close(timeout=5)
    assert pool.snapshot()["zombie_results"] == 1


def _engine_storm(seed, pool_budget=ENGINE_BUDGET):
    real = lambda bucket, payloads: dispatch_bucket(  # noqa: E731
        payloads, bucket[0], bucket[1], CFG, SCFG, **CPU)
    chaos = [ChaosDispatcher(real, seed + 100 + i, weights=ALL_FAULTS, fault_rate=0.3,
                             max_faults=6) for i in range(3)]
    clk = FakeClock()
    eng = AsyncLingamEngine(
        CFG, SCFG, batch_cfg=BatchingConfig(max_batch=4, max_queue=64, flush_interval=0.05,
                                            max_retries=2, max_failovers=4),
        clock=clk, dispatch=chaos, start=True,
        pool_cfg=ReplicaPoolConfig(replicas=3, dispatch_budget=pool_budget,
                                   suspect_threshold=2, quarantine_cooldown=0.5), **CPU)
    return eng, chaos, clk


@pytest.mark.parametrize("seed,budget", [(6, ENGINE_BUDGET), (7, ENGINE_BUDGET),
                                         (1337, ENGINE_BUDGET), (6, 1.0), (7, 1.0)])
def test_engine_chaos_storm_every_ticket_resolves(seed, budget):
    """The reference's ``test_engine_chaos_storm_bit_identical`` on the
    port's engine with real CPU fits, at the seeds that strand tickets in
    the reference (6, 7) and at its default seed (1337). Under the
    reference's own budget of 1 s the watchdog also expires real fits,
    which wedges replicas that are only slow: without ``ServingPool``'s
    rule, seeds 6 and 7 then leave tickets pending."""
    eng, chaos, clk = _engine_storm(seed, budget)
    try:
        assert isinstance(eng.pool, ServingPool)
        datasets = [_gen(6 + (i % 3), 60 + 10 * (i % 2), seed=200 + i) for i in range(10)]
        tickets = [eng.submit(x) for x in datasets]
        bad = datasets[0].copy()
        bad[0, 0] = np.nan
        with pytest.raises(ValueError):  # typed reject at submit, never queued
            eng.submit(bad)
        steps = _drive(clk, tickets, 0.01)
        assert steps <= MAX_STEPS, f"stranded tickets (seed={seed})"
        delivered = failed = 0
        for x, t in zip(datasets, tickets):
            if t.error() is None:
                delivered += 1
                _assert_dedicated(t.result(0), x)
            else:
                failed += 1
                assert isinstance(t.error(), ServeError)
        stats = eng.stats()
        assert stats["invalid_datasets"] == 1
        assert stats["delivered"] == delivered
        assert stats["failed"] + stats["timeouts"] == failed
        assert stats["queue_depth"] == 0 and stats["in_flight"] == 0
        _assert_conserved(stats)
        assert stats["kernel_bypass"] == 0
    finally:
        for ev in chaos:
            ev.release_all()
        eng.close(timeout=10)


# ---------------------------------------------------------------------------
# the ports of tests/test_serve_storm.py
# ---------------------------------------------------------------------------


@STORM_SETTINGS
@given(
    reqs=st.lists(st.tuples(st.integers(0, 2), st.integers(-2, 2),
                            st.one_of(st.none(), st.floats(0.1, 5.0))),
                  min_size=1, max_size=40),
    max_batch=st.integers(1, 5),
    max_queue=st.integers(1, 50),
    advance=st.floats(0.05, 2.0),
)
def test_core_storm_ledger_balances(reqs, max_batch, max_queue, advance):
    """Arbitrary request mixes through the bare core: every request ends
    (delivered, shed or timed out) and the global and per-bucket ledgers
    balance exactly."""
    clk = FakeClock()
    core = BatchingCore(lambda bucket, payloads: list(payloads),
                        BatchingConfig(max_batch=max_batch, max_queue=max_queue,
                                       flush_interval=1.0, overflow="shed"), clock=clk)
    tickets, n_shed = [], 0
    for bucket_id, prio, deadline in reqs:
        try:
            tickets.append(core.submit(("payload", len(tickets)), ("b", bucket_id),
                                       priority=prio, deadline=deadline))
        except QueueFull:
            n_shed += 1
        clk.advance(advance)
        core.step()
    for _ in range(200):
        if core.pending == 0:
            break
        clk.advance(1.0)
        core.step()
    assert core.pending == 0
    snap = core.snapshot()
    assert snap["shed"] == n_shed
    assert all(t.done() for t in tickets)
    n_delivered = sum(1 for t in tickets if t.error() is None)
    assert snap["delivered"] == n_delivered
    assert snap["timeouts"] == len(tickets) - n_delivered
    _assert_conserved(snap)
    per_bucket = snap["buckets"].values()
    assert sum(b["requests"] for b in per_bucket) == snap["admitted"]
    assert sum(b["delivered"] for b in per_bucket) == snap["delivered"]
    assert sum(b["timeouts"] for b in per_bucket) == snap["timeouts"]
    for t in tickets:
        if t.error() is None:
            assert t.result(0)[0] == "payload"


@STORM_SETTINGS
@given(
    plan=st.lists(st.lists(st.integers(0, len(SHAPES) - 1), min_size=1, max_size=6),
                  min_size=1, max_size=4),
    priorities=st.lists(st.integers(0, 3), min_size=24, max_size=24),
    max_queue=st.sampled_from([3, 64]),
    overflow=st.sampled_from(["block", "shed"]),
)
def test_engine_storm_bit_identical_and_conserved(plan, priorities, max_queue, overflow):
    """Submitter threads push shuffled dataset mixes through the engine
    under both backpressure policies: every delivered result is bit-equal to
    its dataset's dedicated dispatch, shed requests raise ``QueueFull``, and
    the ledger balances."""
    outcomes = []  # (tag, dataset index, value); list.append is atomic
    with AsyncLingamEngine(
            CFG, SCFG, batch_cfg=BatchingConfig(max_batch=4, max_queue=max_queue,
                                                flush_interval=0.003, overflow=overflow,
                                                max_retries=1), **CPU) as eng:

        def worker(w):
            for k, i in enumerate(plan[w]):
                try:
                    f = eng.fit(_dataset(i), priority=priorities[(7 * w + k) % 24],
                                timeout=300)
                    outcomes.append(("ok", i, f))
                except QueueFull:
                    outcomes.append(("shed", i, None))
                except ServeError as e:
                    outcomes.append(("err", i, e))

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(len(plan))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        assert all(not th.is_alive() for th in threads)
        stats = eng.stats()

    assert len(outcomes) == sum(len(p) for p in plan)  # nothing lost, nothing hung
    assert not [o for o in outcomes if o[0] == "err"]
    for tag, i, f in outcomes:
        if tag == "ok":
            assert tuple(f.order) == _ref_order(i)
            _assert_dedicated(f, _dataset(i))
    n_ok = sum(1 for o in outcomes if o[0] == "ok")
    n_shed = sum(1 for o in outcomes if o[0] == "shed")
    if overflow == "block":
        assert n_shed == 0
    assert stats["delivered"] == n_ok and stats["shed"] == n_shed
    assert stats["queue_depth"] == 0 and stats["in_flight"] == 0
    _assert_conserved(stats)
    assert sum(b["requests"] for b in stats["buckets"].values()) == stats["admitted"]


@STORM_SETTINGS
@given(
    seed=st.integers(0, 2**31 - 1),
    n_reqs=st.integers(5, 40),
    fault_rate=st.floats(0.1, 0.6),
    replicas=st.integers(1, 3),
    breaker_threshold=st.sampled_from([0, 3, 5]),
)
def test_chaos_storm_every_ticket_resolves(seed, n_reqs, fault_rate, replicas,
                                           breaker_threshold):
    """Drawn storms through a manually pumped ``ServingPool``: dispatch
    exceptions, per-request rejections, partial batches and replica crashes
    in one schedule. Every ticket resolves to its exact payload or a typed
    ``ServeError``, the ledger balances, nothing is stranded."""
    clk = FakeClock()
    ident = lambda bucket, payloads: list(payloads)  # noqa: E731
    chaos = [ChaosDispatcher(ident, seed + i,
                             weights={"exc": 2, "reject": 2, "partial": 1, "crash": 1},
                             fault_rate=fault_rate, max_faults=12) for i in range(replicas)]
    core = BatchingCore(None, BatchingConfig(
        max_batch=3, max_queue=64, flush_interval=0.2, max_retries=2, max_failovers=3,
        breaker_threshold=breaker_threshold, breaker_cooldown=1.5), clock=clk)
    pool = ServingPool(core, ReplicaPoolConfig(replicas=replicas, dispatch_budget=None,
                                               suspect_threshold=2, quarantine_cooldown=1.0),
                       chaos, start=False)
    rng = random.Random(seed)
    tickets, submit_errors = [], 0
    for i in range(n_reqs):
        bucket = rng.choice(["A", "B"])
        try:
            tickets.append((i, core.submit(i, bucket=bucket)))
        except (BucketQuarantined, EngineClosed):
            submit_errors += 1
        if rng.random() < 0.6:
            pool.run_once()
        clk.advance(rng.random() * 0.3)
    for _ in range(400):
        progressed = pool.run_once()
        snap = core.snapshot()
        if not progressed and snap["queue_depth"] == 0 and snap["in_flight"] == 0:
            break
        clk.advance(0.5)
    snap = core.snapshot()
    assert snap["queue_depth"] == 0 and snap["in_flight"] == 0
    for i, t in tickets:
        assert t.done(), f"request {i} stranded (seed={seed})"
        if t.error() is None:
            assert t.result(0) == i
        else:
            assert isinstance(t.error(), ServeError)
    _assert_conserved(snap)
    assert snap["submitted"] == len(tickets) + submit_errors
