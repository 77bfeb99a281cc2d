"""Replicated dispatcher pool with health tracking and a hung-dispatch
watchdog — the fault-tolerance layer around :class:`~repro_torch.serve.batching.
BatchingCore`.

``BatchingCore`` owns the admission queue, bucketing, retry and breaker
logic; this module owns *who* drains it. N dispatcher replicas (one thread
each, each with its own ``dispatch`` seam — in production one engine/device
replica each) pull batches from the one shared queue via the core's public
dispatch contract (``take_batch`` / ``complete_batch`` / ``fail_batch`` /
``requeue_batch``), so a crashed or wedged replica never strands a caller:
its batch is re-queued and a healthy peer picks it up.

Replica health state machine (guarded by ``core._mu``)::

    HEALTHY --failure--> SUSPECT --(suspect_threshold consecutive)-->
    QUARANTINED --(quarantine_cooldown elapses)--> PROBATION
        PROBATION --success--> HEALTHY      (re-admitted)
        PROBATION --failure--> QUARANTINED  (back to the bench)
    any state --ReplicaCrashed--> DEAD      (thread exits, never re-admitted)

The **watchdog** enforces a hard wall-clock budget per dispatch call
(``dispatch_budget``). Every dispatch arms an entry in a registry before
calling the seam and disarms it after; a separate watchdog thread parks on
its own condition via the injectable clock seam (``utils/clock.py``'s
sleeper registry) until the earliest armed deadline. On expiry the batch is
failed over (``requeue_batch`` — no retry budget burned), the replica is
marked suspect, and when the wedged call eventually returns its result is
discarded as a *zombie* (the disarm reports the entry already expired —
exactly-once delivery). Because all waiting goes through the clock seam, a
test drives the whole hung-dispatch path by advancing a ``FakeClock`` —
zero real sleeps (tests/test_replica.py).

``ChaosDispatcher`` at the bottom is the seeded fault-injection seam the
chaos-matrix tests and the CI ``chaos`` lane share: one RNG draws a fault
per dispatch call (exception / per-request rejection / partial batch /
hang / replica crash) so a single printed seed reproduces a whole storm.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass

from repro_torch.serve.batching import BatchingCore, DispatchFailed

# replica health states
HEALTHY = "healthy"
SUSPECT = "suspect"
QUARANTINED = "quarantined"
PROBATION = "probation"
DEAD = "dead"


class ReplicaCrashed(Exception):
    """Raised *by a dispatch seam* to model a replica dying mid-call (device
    lost, process killed). The pool fails the batch over to a healthy peer
    (no retry budget burned), marks the replica DEAD, and retires its
    thread. Distinct from ordinary dispatch exceptions, which count against
    the request retry budget and the bucket's circuit breaker."""


class HungDispatch(Exception):
    """Cause attached to a watchdog failover: the dispatch exceeded its
    wall-clock budget. Carries no traceback of the wedged call — that call
    is still running somewhere."""


@dataclass(frozen=True)
class ReplicaPoolConfig:
    replicas: int = 2  # dispatcher threads draining the shared queue
    dispatch_budget: float | None = 5.0  # hard wall-clock seconds per
    #   dispatch call before the watchdog fails the batch over (None
    #   disables the watchdog)
    suspect_threshold: int = 3  # consecutive failures before a SUSPECT
    #   replica is QUARANTINED
    quarantine_cooldown: float = 5.0  # seconds quarantined before PROBATION
    #   re-admission (one probe dispatch decides: heal or re-quarantine)


class _Replica:
    __slots__ = ("idx", "dispatch", "state", "consecutive", "quarantined_at",
                 "stats", "thread")

    def __init__(self, idx: int, dispatch):
        self.idx = idx
        self.dispatch = dispatch
        self.state = HEALTHY
        self.consecutive = 0  # consecutive failures (success resets)
        self.quarantined_at = 0.0
        self.stats = {"dispatches": 0, "failures": 0, "watchdog_expiries": 0,
                      "zombie_results": 0, "quarantines": 0, "heals": 0}
        self.thread: threading.Thread | None = None


class _WatchEntry:
    __slots__ = ("replica", "bucket", "reqs", "deadline")

    def __init__(self, replica, bucket, reqs, deadline):
        self.replica = replica
        self.bucket = bucket
        self.reqs = reqs
        self.deadline = deadline


class ReplicaPool:
    """N dispatcher replicas + watchdog over one ``BatchingCore``.

    ``dispatches`` gives each replica its own dispatch seam (a list of N
    callables); pass None to share ``core.dispatch``. With ``start=True``
    the pool spawns one serve thread per replica (plus the watchdog);
    with ``start=False`` tests drive it deterministically: ``run_once()``
    performs one take+dispatch+complete cycle in the calling thread and
    ``expire_hung()`` performs one watchdog pass.

    Lock ordering: the watchdog registry lock ``_wmu`` and the core's
    ``_mu`` are never held together — arm/disarm touch only ``_wmu``;
    batch completion/failover and health transitions touch only ``_mu``.
    """

    def __init__(self, core: BatchingCore, cfg: ReplicaPoolConfig | None = None,
                 dispatches=None, *, start: bool = True):
        self.core = core
        self.cfg = cfg or ReplicaPoolConfig()
        if self.cfg.replicas < 1:
            raise ValueError(f"need at least one replica, got {self.cfg.replicas}")
        if dispatches is None:
            dispatches = [core.dispatch] * self.cfg.replicas
        if len(dispatches) != self.cfg.replicas:
            raise ValueError(
                f"got {len(dispatches)} dispatch seams for "
                f"{self.cfg.replicas} replicas")
        self.replicas = [_Replica(i, d) for i, d in enumerate(dispatches)]
        self.stats = {"watchdog_expiries": 0, "zombie_results": 0,
                      "crashes": 0, "quarantines": 0, "heals": 0,
                      "failovers": 0}
        self._wmu = threading.Lock()
        self._wcond = threading.Condition(self._wmu)
        self._armed: dict[int, _WatchEntry] = {}
        self._wseq = 0
        self._stopping = False
        self._watchdog: threading.Thread | None = None
        self._started = False
        if start:
            self.start()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "ReplicaPool":
        if self._started:
            return self
        self._started = True
        for rep in self.replicas:
            rep.thread = threading.Thread(
                target=self._serve, args=(rep,),
                name=f"{self.core.name}-replica-{rep.idx}", daemon=True)
            rep.thread.start()
        if self.cfg.dispatch_budget is not None:
            self._watchdog = threading.Thread(
                target=self._watch, name=f"{self.core.name}-watchdog",
                daemon=True)
            self._watchdog.start()
        return self

    def close(self, *, drain: bool = True, timeout: float | None = 10.0) -> None:
        """Shut intake on the core, then retire the pool. With threads, each
        serve thread drains the queue and exits; a thread wedged inside a
        hung dispatch is abandoned (daemon) after ``timeout``. Without
        threads, drains by running ``run_once`` in the calling thread."""
        self.core.shut_intake(drain=drain)
        if self._started:
            for rep in self.replicas:
                if rep.thread is not None:
                    rep.thread.join(timeout)
            with self._wmu:
                self._stopping = True
                self._wcond.notify_all()
            if self._watchdog is not None:
                self._watchdog.join(timeout)
        elif drain:
            while self.run_once():
                pass

    # -- watchdog registry --------------------------------------------------

    def arm_dispatch(self, replica: _Replica, bucket, reqs) -> int | None:
        """Register an in-flight dispatch with the watchdog; returns a token
        for ``disarm_dispatch``. No-op (None) when the watchdog is off."""
        if self.cfg.dispatch_budget is None:
            return None
        deadline = self.core.clock.now() + self.cfg.dispatch_budget
        with self._wmu:
            self._wseq += 1
            token = self._wseq
            self._armed[token] = _WatchEntry(replica, bucket, reqs, deadline)
            self._wcond.notify_all()  # watchdog re-computes earliest deadline
        return token

    def disarm_dispatch(self, token: int | None) -> bool:
        """Remove an armed entry. True if it was still live; False if the
        watchdog already expired it (the result is a zombie — discard)."""
        if token is None:
            return True
        with self._wmu:
            return self._armed.pop(token, None) is not None

    def expire_hung(self) -> int:
        """One watchdog pass: fail over every armed dispatch whose budget
        has expired and mark its replica. Returns the number expired. The
        watchdog thread calls this; FakeClock tests call it directly."""
        now = self.core.clock.now()
        with self._wmu:
            due = [t for t, e in self._armed.items() if e.deadline <= now]
            entries = [self._armed.pop(t) for t in due]
        for e in entries:
            self.core.requeue_batch(e.bucket, e.reqs, HungDispatch(
                f"{self.core.name}: replica {e.replica.idx} dispatch exceeded "
                f"its {self.cfg.dispatch_budget}s budget"))
            with self.core._mu:
                self.stats["watchdog_expiries"] += 1
                self.stats["failovers"] += len(e.reqs)
                e.replica.stats["watchdog_expiries"] += 1
                self._note_failure_locked(e.replica)
        return len(entries)

    def _watch(self) -> None:
        clock = self.core.clock
        while True:
            self.expire_hung()
            with self._wmu:
                if self._stopping and not self._armed:
                    return
                wake = min((e.deadline for e in self._armed.values()),
                           default=None)
                if wake is None:
                    clock.wait(self._wcond, None)
                    continue
                dt = wake - clock.now()
                if dt > 0:
                    clock.wait(self._wcond, dt)

    def _fail_pool(self, cause: BaseException) -> None:
        """Every replica is DEAD: no dispatcher will ever drain the queue
        again, so fail everything queued with a typed error and reject new
        submits — stranding a ticket is the one forbidden outcome."""
        core = self.core
        with core._mu:
            core._closed = True
            core._draining = False
            now = core.clock.now()
            for reqs in core._queue.values():
                for r in reqs:
                    err = DispatchFailed(
                        f"{core.name}: every replica is dead: {cause!r}")
                    err.__cause__ = cause
                    core._finish_locked(r, kind="failed", now=now, error=err)
            core._queue.clear()
            core._depth = 0
            core._work.notify_all()
            core._space.notify_all()
            core._maybe_idle_locked()

    # -- health transitions (caller holds core._mu) -------------------------

    def _note_success_locked(self, rep: _Replica) -> None:
        rep.consecutive = 0
        if rep.state in (SUSPECT, PROBATION):
            if rep.state == PROBATION:
                rep.stats["heals"] += 1
                self.stats["heals"] += 1
            rep.state = HEALTHY

    def _note_failure_locked(self, rep: _Replica) -> None:
        if rep.state == DEAD:
            return
        rep.consecutive += 1
        rep.stats["failures"] += 1
        if (rep.state == PROBATION
                or rep.consecutive >= self.cfg.suspect_threshold):
            rep.state = QUARANTINED
            rep.quarantined_at = self.core.clock.now()
            rep.stats["quarantines"] += 1
            self.stats["quarantines"] += 1
        else:
            rep.state = SUSPECT

    def _heal_due_locked(self, rep: _Replica, now: float) -> float | None:
        """QUARANTINED -> PROBATION once the cooldown elapses; returns the
        absolute heal time while still benched, else None."""
        if rep.state != QUARANTINED:
            return None
        heal_at = rep.quarantined_at + self.cfg.quarantine_cooldown
        if now >= heal_at:
            rep.state = PROBATION  # next dispatch is the probe
            return None
        return heal_at

    # -- dispatching --------------------------------------------------------

    def _dispatch_one(self, rep: _Replica, bucket, reqs) -> None:
        """Run one taken batch on ``rep`` under the watchdog. Exactly one of
        complete/fail/requeue resolves the batch: if the watchdog expired
        this dispatch first, the (late) outcome is discarded as a zombie."""
        token = self.arm_dispatch(rep, bucket, reqs)
        try:
            results = rep.dispatch(bucket, [r.payload for r in reqs])
        except ReplicaCrashed as e:
            live = self.disarm_dispatch(token)
            with self.core._mu:
                rep.state = DEAD
                self.stats["crashes"] += 1
                if live:
                    self.stats["failovers"] += len(reqs)
                all_dead = all(r.state == DEAD for r in self.replicas)
            if live:
                self.core.requeue_batch(bucket, reqs, e)
            if all_dead:
                self._fail_pool(e)
            raise
        except BaseException as e:  # noqa: BLE001 — typed at the core
            live = self.disarm_dispatch(token)
            if live:
                self.core.fail_batch(bucket, reqs, e)
                with self.core._mu:
                    rep.stats["dispatches"] += 1
                    self._note_failure_locked(rep)
            else:
                with self.core._mu:
                    rep.stats["zombie_results"] += 1
                    self.stats["zombie_results"] += 1
            return
        live = self.disarm_dispatch(token)
        if live:
            self.core.complete_batch(bucket, reqs, results)
            with self.core._mu:
                rep.stats["dispatches"] += 1
                self._note_success_locked(rep)
        else:
            with self.core._mu:
                rep.stats["zombie_results"] += 1
                self.stats["zombie_results"] += 1

    def run_once(self, replica: int | None = None) -> bool:
        """Manual-mode drive: heal-check, take one batch, dispatch it on the
        chosen (or first serviceable) replica in the calling thread. Returns
        True if a batch was dispatched. Deterministic under FakeClock."""
        now = self.core.clock.now()
        with self.core._mu:
            rep = None
            candidates = (self.replicas if replica is None
                          else [self.replicas[replica]])
            for cand in candidates:
                if cand.state == DEAD:
                    continue
                self._heal_due_locked(cand, now)
                if cand.state != QUARANTINED:
                    rep = cand
                    break
            if rep is None:
                return False
            taken = self.core._take_batch_locked(now)
        if taken is None:
            return False
        try:
            self._dispatch_one(rep, *taken)
        except ReplicaCrashed:
            pass  # replica marked DEAD; batch already failed over
        return True

    def _serve(self, rep: _Replica) -> None:
        core = self.core
        clock = core.clock
        while True:
            with core._mu:
                if (core._closed and core._depth == 0
                        and core._in_flight == 0):
                    return
                now = clock.now()
                heal_at = self._heal_due_locked(rep, now)
                if heal_at is not None:  # benched: park until cooldown ends
                    clock.wait(core._work, heal_at - now)
                    continue
                taken = core._take_batch_locked(now)
                if taken is None:
                    wake = core._next_wake_locked()
                    if wake is None:
                        clock.wait(core._work, None)
                    else:
                        dt = wake - clock.now()
                        if dt > 0:
                            clock.wait(core._work, dt)
                    continue
            try:
                self._dispatch_one(rep, *taken)
            except ReplicaCrashed:
                return  # thread retires with its dead replica

    # -- stats --------------------------------------------------------------

    def snapshot(self) -> dict:
        """Pool-level stats + per-replica health/counters (the core's own
        ``snapshot()`` stays the request-ledger source of truth)."""
        with self.core._mu:
            out = dict(self.stats)
            out["replicas"] = [
                {"idx": r.idx, "state": r.state,
                 "consecutive_failures": r.consecutive, **r.stats}
                for r in self.replicas
            ]
        with self._wmu:
            out["armed_dispatches"] = len(self._armed)
        return out


class ChaosDispatcher:
    """Seeded fault-injecting wrapper around a real dispatch seam — the
    shared storm generator of the chaos-matrix tests and the CI ``chaos``
    lane. One ``random.Random(seed)`` draws a fault per call, so printing
    the seed reproduces an entire storm bit-for-bit.

    Fault kinds (weights in ``weights``; unlisted kinds default to 0):

    - ``"exc"``     dispatch raises RuntimeError (whole-batch retry path)
    - ``"reject"``  one request's result replaced by an Exception entry
      (the engines' NaN-rejection path)
    - ``"partial"`` result list truncated (wrong-length => batch failure)
    - ``"hang"``    dispatch blocks on an Event until ``release_all()``
      (threaded watchdog tests only — never use in manual mode)
    - ``"crash"``   raises :class:`ReplicaCrashed` (replica dies)

    ``max_faults`` bounds total injections so a storm always ends in
    deliverable results (set it below the pool's combined retry/failover
    budget to guarantee eventual delivery).
    """

    OK = "ok"
    KINDS = ("exc", "reject", "partial", "hang", "crash")

    def __init__(self, inner, seed: int, weights: dict | None = None,
                 *, fault_rate: float = 0.3, max_faults: int | None = None):
        self.inner = inner
        self.seed = seed
        self.rng = random.Random(seed)
        w = dict(weights or {"exc": 2, "reject": 2, "partial": 1})
        self.kinds = [k for k in self.KINDS if w.get(k, 0) > 0]
        self.weights = [w[k] for k in self.kinds]
        self.fault_rate = fault_rate
        self.max_faults = max_faults
        self.calls = 0
        self.injected: list[str] = []  # the storm schedule actually drawn
        self._events: list[threading.Event] = []
        self._mu = threading.Lock()

    def _draw(self) -> tuple[str, float]:
        # every rng use stays under the lock so a seed fully determines the
        # schedule in manual (single-threaded) mode
        with self._mu:
            self.calls += 1
            budget_left = (self.max_faults is None
                           or len(self.injected) < self.max_faults)
            if (budget_left and self.kinds
                    and self.rng.random() < self.fault_rate):
                kind = self.rng.choices(self.kinds, self.weights)[0]
                self.injected.append(kind)
                return kind, self.rng.random()
            return self.OK, 0.0

    def release_all(self) -> None:
        """Unblock every hung call (their results arrive as zombies)."""
        with self._mu:
            events, self._events = self._events, []
        for ev in events:
            ev.set()

    def __call__(self, bucket, payloads):
        kind, aux = self._draw()
        if kind == "exc":
            raise RuntimeError(f"chaos[{self.seed}]: injected dispatch failure")
        if kind == "crash":
            raise ReplicaCrashed(f"chaos[{self.seed}]: injected replica crash")
        if kind == "hang":
            ev = threading.Event()
            with self._mu:
                self._events.append(ev)
            ev.wait()  # until release_all(); watchdog fails the batch over
        results = self.inner(bucket, payloads)
        if kind == "reject" and results:
            results = list(results)
            k = min(int(aux * len(results)), len(results) - 1)
            results[k] = DispatchFailed(
                f"chaos[{self.seed}]: injected per-request rejection")
        elif kind == "partial":
            results = list(results)[:-1]
        return results


__all__ = [
    "ReplicaPool", "ReplicaPoolConfig", "ReplicaCrashed", "HungDispatch",
    "ChaosDispatcher", "HEALTHY", "SUSPECT", "QUARANTINED", "PROBATION",
    "DEAD",
]
