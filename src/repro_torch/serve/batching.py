"""Reusable continuous-batching core shared by the serving engines.

Both engines in ``serve/`` batch for the same reason — jit compiles one
executable per shape, so throughput is won by packing many requests into one
dispatch on a small pow-2 shape grid (``bucket_dim``/``pad_to`` below are
that shared grid logic). This module adds the *service* half: a bounded
admission queue, per-bucket continuous batching with size- and deadline-
triggered flushes, backpressure, load shedding, bounded retry, and a stats
surface. ``AsyncLingamEngine`` (``serve/async_engine.py``) is the first
engine built on it.

Request lifecycle::

        submit(payload, bucket, priority, deadline)
             |
             v
      +------------------+  full + overflow="shed"  -> QueueFull raised (counted)
      | admission queue  |  full + overflow="block" -> submitter parks until a
      |  (max_queue)     |                             dispatch frees space
      +------------------+
             | grouped by bucket key (e.g. the pow-2 padded (p, n) shape)
             v
      +------------------+  a bucket flushes when:
      | per-bucket rows  |    - it holds >= max_batch requests (size trigger)
      |  priority-sorted |    - its earliest "due" time passes (age trigger:
      +------------------+      enqueue + flush_interval, pulled earlier by
             |                  any request deadline minus deadline_margin)
             v
        dispatcher  (background thread, replica pool, or step() in tests)
             |-- deadline already passed      -> ticket <- RequestTimeout
             |-- bucket breaker open          -> ticket <- BucketQuarantined
             |-- dispatch seam raises / returns bad rows:
             |       retries_left > 0  -> re-queued, due=now (counted retry)
             |       retries_left == 0 -> ticket <- DispatchFailed
             |-- dispatcher replica hung/crashed (serve/replica.py):
             |       failovers_left > 0 -> re-queued to a healthy peer
             |       failovers_left == 0 -> ticket <- DispatchFailed
             v
        ticket.result()   (unblocks the submitter with value or typed error)

Every admitted request terminates in exactly one of delivered / timed-out /
failed, and every submitted request is admitted or shed/quarantined — the
conservation laws (``submitted == admitted + shed + rejected + quarantined``,
``admitted == delivered + timeouts + failed + still-queued/in-flight``) that
the fault-injection and storm tests assert. A request is *never* silently
dropped: even a dispatcher-thread crash fails the queue with typed errors
rather than hanging callers.

Two fault-containment mechanisms live at this layer:

* **Per-bucket circuit breakers** (``breaker_threshold`` > 0): K consecutive
  whole-dispatch failures on one bucket shape open that bucket's breaker —
  new submits to the shape fast-fail with ``BucketQuarantined`` (cheap,
  immediate, no retry budget burned) and the bucket's queued requests are
  held rather than dispatched into a failing executable. After
  ``breaker_cooldown`` the breaker goes half-open and admits exactly one
  probe batch: success closes it, failure re-opens it. Per-*request*
  rejections (e.g. a NaN result for one dataset) do NOT count — those are
  data-dependent, not shape-dependent, and ride the normal retry path.
* **Failover re-queue** (``requeue_batch``): an external dispatcher (the
  replica pool's watchdog, a crashed replica) can push a taken batch back
  without burning the per-request *retry* budget — replica failure is not
  the request's fault. A separate ``max_failovers`` budget bounds it so a
  batch can't ping-pong between dying replicas forever.

All time flows through the ``utils.clock`` seam and all device work through
the ``dispatch`` callable, so every timing and failure path is
deterministically testable with ``FakeClock`` + ``ManualDispatcher`` and zero
wall-clock sleeps (tests/test_batching.py).
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass

from repro_torch.utils.clock import Clock, MonotonicClock

# Re-export shims: the shape-bucketing grid moved to its canonical home in
# ``serve.buckets`` (one family instead of the batching/lingam_engine split).
from repro_torch.serve.buckets import bucket_dim, bucket_dims, pad_to  # noqa: F401


# ---------------------------------------------------------------------------
# typed request-terminal errors
# ---------------------------------------------------------------------------


class ServeError(Exception):
    """Base class of every typed serving error a ticket can carry."""


class QueueFull(ServeError):
    """Admission queue full and overflow policy is "shed" (raised at
    ``submit`` time; the request was never admitted)."""


class RequestTimeout(ServeError):
    """The request's deadline passed while it was still queued. Requests
    already in flight on the device are delivered, not cancelled."""


class DispatchFailed(ServeError):
    """Dispatch raised (or produced an invalid result) and the retry budget
    is exhausted; ``__cause__`` carries the last underlying error."""


class BucketQuarantined(ServeError):
    """The request's bucket shape has its circuit breaker open after
    ``breaker_threshold`` consecutive whole-dispatch failures. Raised at
    ``submit`` time (fast-fail, never admitted) and used to terminate
    queued requests of an open bucket without burning their retry budget;
    in the latter case ``__cause__`` carries the underlying dispatch
    error."""


class EngineClosed(ServeError):
    """The engine was closed before this request could be served."""


# ---------------------------------------------------------------------------
# configuration / ticket
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BatchingConfig:
    max_batch: int = 64  # requests per dispatch (a bucket splits into chunks)
    max_queue: int = 256  # bounded admission queue (queued, not yet in flight)
    flush_interval: float = 0.01  # age trigger: flush a bucket once its
    #   oldest request has waited this long (seconds; the occupancy-vs-latency
    #   knob — see EXPERIMENTS.md "Continuous batching")
    deadline_margin: float = 0.0  # flush this early relative to a request
    #   deadline (budget for the dispatch itself)
    overflow: str = "block"  # "block" | "shed": backpressure policy when the
    #   admission queue is full (per-submit override available)
    max_retries: int = 1  # failed-dispatch re-queue budget per request
    max_failovers: int = 4  # replica-failover re-queue budget per request
    #   (hung/crashed dispatcher path via ``requeue_batch``; independent of
    #   max_retries — replica failure is not the request's fault)
    breaker_threshold: int = 0  # K consecutive whole-dispatch failures on
    #   one bucket open its circuit breaker (0 disables breakers entirely)
    breaker_cooldown: float = 30.0  # seconds an open breaker holds before
    #   going half-open and admitting one probe batch
    latency_window: int = 512  # per-bucket delivered-latency ring buffer


class Ticket:
    """One request's completion handle: ``result()`` blocks until the
    dispatcher delivers a value or a typed ``ServeError``."""

    __slots__ = ("req_id", "bucket", "_event", "_value", "_error")

    def __init__(self, req_id: int, bucket):
        self.req_id = req_id
        self.bucket = bucket
        self._event = threading.Event()
        self._value = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        """Block for the result; raises the ticket's typed error if the
        request failed, or ``TimeoutError`` if *this wait* (real wall-clock,
        independent of the engine's clock seam) times out."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.req_id} not done after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._value

    def error(self) -> BaseException | None:
        """The typed error of a finished-failed ticket (None while pending
        or when delivered)."""
        return self._error

    def _deliver(self, value) -> None:
        self._value = value
        self._event.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._event.set()


class _Req:
    __slots__ = ("seq", "payload", "bucket", "priority", "deadline", "due",
                 "enqueue_t", "retries_left", "failovers_left", "ticket")

    def __init__(self, seq, payload, bucket, priority, deadline, due,
                 enqueue_t, retries_left, failovers_left, ticket):
        self.seq = seq
        self.payload = payload
        self.bucket = bucket
        self.priority = priority
        self.deadline = deadline  # absolute engine-clock time, or None
        self.due = due  # absolute time at which this request forces a flush
        self.enqueue_t = enqueue_t
        self.retries_left = retries_left
        self.failovers_left = failovers_left  # replica-failure re-queues
        self.ticket = ticket


# ---------------------------------------------------------------------------
# the core
# ---------------------------------------------------------------------------


class BatchingCore:
    """Bounded admission queue + bucketed continuous batcher.

    ``dispatch(bucket, payloads) -> results`` is the injectable work seam: it
    receives one bucket's batch (payloads in dispatch order) and must return
    one result per payload, in order. A raised exception fails the whole
    batch into the retry path; a result that is an ``Exception`` instance
    fails (or retries) just that request — the hook engines use to reject
    corrupt results (e.g. NaN outputs) without losing the rest of the batch.

    Run modes: ``start()`` spawns the background dispatcher thread
    (production); without it, ``step()`` runs one scheduling pass in the
    calling thread (deterministic tests drive this under a ``FakeClock``).
    """

    def __init__(self, dispatch, cfg: BatchingConfig | None = None, *,
                 clock: Clock | None = None, name: str = "batching"):
        if cfg is not None and cfg.overflow not in ("block", "shed"):
            raise ValueError(f"overflow must be 'block' or 'shed', got {cfg.overflow!r}")
        self.dispatch = dispatch
        self.cfg = cfg or BatchingConfig()
        self.clock = clock or MonotonicClock()
        self.name = name
        self._mu = threading.Lock()
        self._work = threading.Condition(self._mu)  # dispatcher parks here
        self._space = threading.Condition(self._mu)  # blocked submitters park
        self._idle = threading.Condition(self._mu)  # join() waiters park
        self._queue: dict = {}  # bucket -> list[_Req]
        self._depth = 0  # queued request count (the admission bound)
        self._in_flight = 0
        self._seq = 0
        self._closed = False
        self._draining = False  # closed with drain=True: intake shut, but
        #   queued/in-flight work still flushes (and may retry/fail over)
        self._thread: threading.Thread | None = None
        self._breakers: dict = {}  # bucket -> circuit-breaker state dict
        self.stats: dict = {
            "submitted": 0, "admitted": 0, "shed": 0, "rejected": 0,
            "quarantined": 0, "delivered": 0, "timeouts": 0, "failed": 0,
            "retries": 0, "failovers": 0, "dispatches": 0,
            "dispatch_failures": 0, "breaker_opens": 0, "queue_peak": 0,
            "blocked_submits": 0,
        }
        self._buckets: dict = {}  # bucket -> mutable stats dict

    # -- intake -------------------------------------------------------------

    def submit(self, payload, bucket, *, priority: int = 0,
               deadline: float | None = None,
               overflow: str | None = None) -> Ticket:
        """Enqueue one request. ``deadline`` is *relative* seconds from now
        (engine clock); pass None for no deadline. Higher ``priority``
        dispatches first within a bucket. ``overflow`` overrides the
        configured backpressure policy for this call."""
        policy = overflow or self.cfg.overflow
        if policy not in ("block", "shed"):
            raise ValueError(f"overflow must be 'block' or 'shed', got {policy!r}")
        with self._mu:
            self.stats["submitted"] += 1
            if self._closed:
                self.stats["rejected"] += 1
                raise EngineClosed(f"{self.name}: engine is closed")
            if self.cfg.breaker_threshold > 0:
                br = self._breakers.get(bucket)
                if br is not None and br["state"] == "open":
                    if (self.clock.now() - br["opened_at"]
                            < self.cfg.breaker_cooldown):
                        self.stats["quarantined"] += 1
                        self._bucket_stats(bucket)["quarantined"] += 1
                        raise BucketQuarantined(
                            f"{self.name}: bucket {bucket!r} is quarantined "
                            f"after {br['consecutive']} consecutive dispatch "
                            f"failures; retry after cooldown")
                    br["state"] = "half_open"  # cooldown over: admit a probe
                    br["probing"] = False
            blocked = False
            while self._depth >= self.cfg.max_queue:
                if policy == "shed":
                    self.stats["shed"] += 1
                    self._bucket_stats(bucket)["shed"] += 1
                    raise QueueFull(
                        f"{self.name}: admission queue full "
                        f"({self._depth}/{self.cfg.max_queue}); request shed"
                    )
                if not blocked:
                    blocked = True
                    self.stats["blocked_submits"] += 1
                self._space.wait()
                if self._closed:
                    self.stats["rejected"] += 1
                    raise EngineClosed(f"{self.name}: engine closed while blocked")
            now = self.clock.now()
            ticket = Ticket(self._seq, bucket)
            due = now + self.cfg.flush_interval
            abs_deadline = None
            if deadline is not None:
                abs_deadline = now + deadline
                due = min(due, abs_deadline - self.cfg.deadline_margin)
            req = _Req(self._seq, payload, bucket, priority, abs_deadline,
                       due, now, self.cfg.max_retries,
                       self.cfg.max_failovers, ticket)
            self._seq += 1
            self._queue.setdefault(bucket, []).append(req)
            self._depth += 1
            self.stats["admitted"] += 1
            self._bucket_stats(bucket)["requests"] += 1
            self.stats["queue_peak"] = max(self.stats["queue_peak"], self._depth)
            self._work.notify()
        return ticket

    # -- scheduling ---------------------------------------------------------

    def step(self) -> int:
        """One scheduling pass in the calling thread: expire overdue
        deadlines, then dispatch every currently-flushable batch (full
        buckets, or buckets whose earliest due time has passed). Returns the
        number of batches dispatched. This is the deterministic test
        entrypoint; the background thread calls it too."""
        dispatched = 0
        while True:
            taken = self._take_batch()
            if taken is None:
                return dispatched
            self._run_batch(*taken)
            dispatched += 1

    def _bucket_stats(self, bucket) -> dict:
        # caller holds self._mu
        bs = self._buckets.get(bucket)
        if bs is None:
            bs = self._buckets[bucket] = {
                "requests": 0, "dispatches": 0, "delivered": 0, "shed": 0,
                "quarantined": 0, "timeouts": 0, "failed": 0, "retries": 0,
                "failovers": 0, "batch_sum": 0,
                "lat": deque(maxlen=self.cfg.latency_window),
            }
        return bs

    def note_bucket(self, bucket, **deltas) -> None:
        """Accumulate engine-specific numeric counters into a bucket's stats
        (e.g. the LiNGAM engine's padding-waste cells). Thread-safe."""
        with self._mu:
            bs = self._bucket_stats(bucket)
            for k, v in deltas.items():
                bs[k] = bs.get(k, 0) + v

    # -- circuit breakers (per bucket) --------------------------------------

    def _breaker_locked(self, bucket) -> dict:
        br = self._breakers.get(bucket)
        if br is None:
            br = self._breakers[bucket] = {
                "state": "closed", "consecutive": 0, "opened_at": 0.0,
                "probing": False,
            }
        return br

    def _breaker_holds_locked(self, bucket, now: float) -> bool:
        """True if the bucket's breaker currently blocks dispatches.
        Transitions open -> half_open once the cooldown has elapsed;
        half_open admits exactly one probe batch at a time."""
        if self.cfg.breaker_threshold <= 0:
            return False
        br = self._breakers.get(bucket)
        if br is None or br["state"] == "closed":
            return False
        if br["state"] == "open":
            if now - br["opened_at"] < self.cfg.breaker_cooldown:
                return True
            br["state"] = "half_open"
            br["probing"] = False
            return False
        return br["probing"]

    def _note_dispatch_failure_locked(self, bucket) -> None:
        if self.cfg.breaker_threshold <= 0:
            return
        br = self._breaker_locked(bucket)
        br["consecutive"] += 1
        reopen = br["state"] == "half_open"  # failed probe: straight back
        if reopen or (br["state"] == "closed"
                      and br["consecutive"] >= self.cfg.breaker_threshold):
            br["state"] = "open"
            br["opened_at"] = self.clock.now()
            br["probing"] = False
            self.stats["breaker_opens"] += 1
            bs = self._bucket_stats(bucket)
            bs["breaker_opens"] = bs.get("breaker_opens", 0) + 1

    def _note_dispatch_success_locked(self, bucket) -> None:
        if self.cfg.breaker_threshold <= 0:
            return
        br = self._breakers.get(bucket)
        if br is None:
            return
        br["consecutive"] = 0
        br["probing"] = False
        if br["state"] != "closed":
            br["state"] = "closed"
            # held requests are dispatchable again: wake parked dispatchers
            self._work.notify_all()

    # -- batch intake/completion (the dispatch contract) --------------------
    #
    # ``take_batch`` / ``complete_batch`` / ``fail_batch`` / ``requeue_batch``
    # are the public dispatch contract: every taken batch must be handed to
    # exactly one of the other three. ``step()`` composes take + dispatch +
    # complete/fail in one thread; the replica pool (serve/replica.py) splits
    # them across its dispatcher threads and watchdog.

    def take_batch(self):
        """Pop the most urgent flushable batch as ``(bucket, reqs)``, or
        None if nothing is currently dispatchable."""
        now = self.clock.now()
        with self._mu:
            return self._take_batch_locked(now)

    _take_batch = take_batch  # historical internal name

    def _take_batch_locked(self, now: float):
        """Core of ``take_batch``; caller holds ``self._mu``. Also fails
        overdue queued requests with ``RequestTimeout`` — load-shedding of
        work that can no longer meet its deadline, *before* it wastes a
        dispatch — and holds buckets whose circuit breaker is open (bypassed
        while draining, so a close(drain=True) never strands a request
        behind a quarantined shape)."""
        best = None
        best_trigger = None
        for bucket in list(self._queue):
            reqs = self._queue[bucket]
            alive = []
            for r in reqs:
                if r.deadline is not None and r.deadline <= now:
                    self._finish_locked(r, kind="timeouts", now=now,
                                        error=RequestTimeout(
                                            f"{self.name}: request "
                                            f"{r.ticket.req_id} missed its "
                                            f"deadline while queued"))
                    self._depth -= 1
                else:
                    alive.append(r)
            if not alive:
                del self._queue[bucket]
                continue
            self._queue[bucket] = alive
            if not self._draining and self._breaker_holds_locked(bucket, now):
                continue
            trigger = (now if len(alive) >= self.cfg.max_batch
                       else min(r.due for r in alive))
            if trigger <= now and (best is None or trigger < best_trigger):
                best, best_trigger = bucket, trigger
        if best is None:
            self._maybe_idle_locked()
            self._space.notify_all()  # timeouts may have freed space
            return None
        reqs = self._queue[best]
        reqs.sort(key=lambda r: (-r.priority, r.seq))
        take, rest = reqs[: self.cfg.max_batch], reqs[self.cfg.max_batch:]
        if rest:
            self._queue[best] = rest
        else:
            del self._queue[best]
        self._depth -= len(take)
        self._in_flight += len(take)
        br = self._breakers.get(best)
        if br is not None and br["state"] == "half_open":
            br["probing"] = True  # this batch is the one half-open probe
        self._space.notify_all()
        return best, take

    def _run_batch(self, bucket, reqs) -> None:
        try:
            results = self.dispatch(bucket, [r.payload for r in reqs])
        except BaseException as e:  # noqa: BLE001 — every failure is typed
            self.fail_batch(bucket, reqs, e)
            return
        self.complete_batch(bucket, reqs, results)

    def complete_batch(self, bucket, reqs, results) -> None:
        """Deliver one taken batch's results (per-request ``Exception``
        entries reject/retry just that request). A missing or wrong-length
        result list is a whole-batch failure."""
        if results is None or len(results) != len(reqs):
            got = 0 if results is None else len(results)
            self.fail_batch(bucket, reqs, DispatchFailed(
                f"{self.name}: dispatch returned {got} results for "
                f"{len(reqs)} requests (partial batch)"))
            return
        now = self.clock.now()
        with self._mu:
            self.stats["dispatches"] += 1
            bs = self._bucket_stats(bucket)
            bs["dispatches"] += 1
            bs["batch_sum"] += len(reqs)
            self._in_flight -= len(reqs)
            self._note_dispatch_success_locked(bucket)
            for r, val in zip(reqs, results):
                if isinstance(val, BaseException):
                    # per-request rejection from the seam (e.g. NaN result);
                    # data-dependent, so it does NOT count toward the breaker
                    self._retry_or_fail_locked(r, val)
                else:
                    self._finish_locked(r, kind="delivered", now=now, value=val)
            self._maybe_idle_locked()

    def fail_batch(self, bucket, reqs, err: BaseException) -> None:
        """Fail one taken batch into the retry/breaker path (whole-dispatch
        failure: the seam raised, or a replica produced garbage)."""
        with self._mu:
            self.stats["dispatch_failures"] += 1
            self._in_flight -= len(reqs)
            self._note_dispatch_failure_locked(bucket)
            for r in reqs:
                self._retry_or_fail_locked(r, err)
            self._maybe_idle_locked()

    def requeue_batch(self, bucket, reqs, cause) -> None:
        """Fail over one taken batch: push it back onto the queue *without*
        burning per-request retry budget — a hung or crashed dispatcher
        replica is not the request's fault, and does not count toward the
        bucket's breaker. Bounded by ``max_failovers`` per request; on
        exhaustion the request fails with a typed ``DispatchFailed``."""
        now = self.clock.now()
        with self._mu:
            for r in reqs:
                self._in_flight -= 1
                if r.failovers_left > 0 and (not self._closed or self._draining):
                    r.failovers_left -= 1
                    r.due = now  # fail over at the next pass, don't re-age
                    self.stats["failovers"] += 1
                    self._bucket_stats(r.bucket)["failovers"] += 1
                    self._queue.setdefault(r.bucket, []).append(r)
                    self._depth += 1
                else:
                    err = DispatchFailed(
                        f"{self.name}: request {r.ticket.req_id} exhausted "
                        f"its failover budget ({self.cfg.max_failovers}) "
                        f"after repeated replica failures: {cause!r}")
                    if isinstance(cause, BaseException):
                        err.__cause__ = cause
                    self._finish_locked(r, kind="failed", now=now, error=err)
            self._work.notify_all()
            self._maybe_idle_locked()

    def _maybe_idle_locked(self) -> None:
        # Wake join() waiters on EVERY path that can complete the last piece
        # of work — including whole-batch dispatch failure, which previously
        # skipped the notify and could hang join() forever.
        if self._depth == 0 and self._in_flight == 0:
            self._idle.notify_all()
            if self._closed:
                self._work.notify_all()  # let dispatcher/pool threads exit

    def _retry_or_fail_locked(self, r: _Req, err: BaseException) -> None:
        br = self._breakers.get(r.bucket)
        quarantined = (br is not None and br["state"] == "open"
                       and not self._draining)
        if (r.retries_left > 0 and not quarantined
                and (not self._closed or self._draining)):
            r.retries_left -= 1
            r.due = self.clock.now()  # retry at the next pass, don't re-age
            self.stats["retries"] += 1
            self._bucket_stats(r.bucket)["retries"] += 1
            # Re-queueing may transiently exceed max_queue: the bound is an
            # *admission* bound; already-admitted work is never shed.
            self._queue.setdefault(r.bucket, []).append(r)
            self._depth += 1
            self._work.notify()
            return
        if quarantined and not isinstance(err, ServeError):
            final: BaseException = BucketQuarantined(
                f"{self.name}: bucket {r.bucket!r} quarantined after "
                f"repeated dispatch failures; not retrying")
            final.__cause__ = err
        elif isinstance(err, ServeError):
            final = err
        else:
            final = DispatchFailed(f"{self.name}: dispatch failed: {err!r}")
            final.__cause__ = err
        self._finish_locked(r, kind="failed", now=self.clock.now(), error=final)

    def _finish_locked(self, r: _Req, *, kind: str, now: float,
                       value=None, error: BaseException | None = None) -> None:
        self.stats[kind] += 1
        bs = self._bucket_stats(r.bucket)
        bs[kind] += 1
        if kind == "delivered":
            bs["lat"].append(now - r.enqueue_t)
            r.ticket._deliver(value)
        else:
            r.ticket._fail(error)

    # -- background thread --------------------------------------------------

    def start(self) -> "BatchingCore":
        """Spawn the background dispatcher thread (idempotent)."""
        with self._mu:
            if self._closed:
                raise EngineClosed(f"{self.name}: engine is closed")
            if self._thread is not None:
                return self
            self._thread = threading.Thread(
                target=self._run, name=f"{self.name}-dispatcher", daemon=True
            )
        self._thread.start()
        return self

    def _next_wake_locked(self) -> float | None:
        """Earliest absolute time at which queued work may become
        dispatchable — bucket due/deadline/size triggers plus open-breaker
        cooldown expiries — or None if nothing is queued. Shared by the
        background thread and the replica pool's dispatcher threads."""
        wake = None

        def _min(a, b):
            return b if a is None else min(a, b)

        for bucket, reqs in self._queue.items():
            held = False
            if not self._draining and self.cfg.breaker_threshold > 0:
                br = self._breakers.get(bucket)
                if br is not None and br["state"] == "open":
                    wake = _min(wake, br["opened_at"] + self.cfg.breaker_cooldown)
                    held = True
                elif br is not None and br["state"] == "half_open" and br["probing"]:
                    held = True  # probe in flight decides this bucket's fate
            if held:
                for r in reqs:  # deadlines still expire while quarantined
                    if r.deadline is not None:
                        wake = _min(wake, r.deadline)
                continue
            if len(reqs) >= self.cfg.max_batch:
                return self.clock.now()
            for r in reqs:
                wake = _min(wake, r.due)
                if r.deadline is not None:
                    wake = _min(wake, r.deadline)
        return wake

    def _run(self) -> None:
        try:
            while True:
                with self._mu:
                    if self._closed and self._depth == 0:
                        return
                    wake = self._next_wake_locked()
                    if wake is None:  # nothing queued (or all held)
                        self.clock.wait(self._work, None)
                        continue
                    now = self.clock.now()
                    if wake > now:
                        self.clock.wait(self._work, wake - now)
                        continue
                self.step()
        except BaseException as e:  # pragma: no cover - defensive: never hang
            # A dispatcher bug must not strand callers on tickets forever:
            # fail everything queued with a typed error, then re-raise so the
            # crash is loud in logs.
            with self._mu:
                self._closed = True
                for reqs in self._queue.values():
                    for r in reqs:
                        self._finish_locked(
                            r, kind="failed", now=self.clock.now(),
                            error=DispatchFailed(
                                f"{self.name}: dispatcher thread crashed: {e!r}"))
                self._queue.clear()
                self._depth = 0
                self._space.notify_all()
                self._idle.notify_all()
            raise

    # -- lifecycle ----------------------------------------------------------

    def join(self, timeout: float | None = None) -> bool:
        """Block until nothing is queued or in flight (real wall-clock
        ``timeout``); returns False on timeout. Only meaningful with the
        background thread running."""
        deadline = None if timeout is None else (MonotonicClock().now() + timeout)
        with self._mu:
            while self._depth > 0 or self._in_flight > 0:
                remaining = None
                if deadline is not None:
                    remaining = deadline - MonotonicClock().now()
                    if remaining <= 0:
                        return False
                self._idle.wait(remaining)
        return True

    def shut_intake(self, *, drain: bool = True) -> None:
        """Close the admission queue without driving any dispatches — the
        intake half of ``close()``, used by external dispatcher pools that
        own the drain themselves. ``drain=True`` marks everything queued due
        now (and keeps the retry/failover paths alive until the queue is
        empty); ``drain=False`` fails queued requests with ``EngineClosed``.
        Idempotent."""
        with self._mu:
            if self._closed:
                return
            self._closed = True
            self._draining = drain
            if drain:
                now = self.clock.now()
                for reqs in self._queue.values():
                    for r in reqs:
                        r.due = now  # flush immediately, age no further
            else:
                for reqs in self._queue.values():
                    for r in reqs:
                        self._finish_locked(
                            r, kind="failed", now=self.clock.now(),
                            error=EngineClosed(
                                f"{self.name}: closed before dispatch"))
                self._queue.clear()
                self._depth = 0
            self._work.notify_all()
            self._space.notify_all()
            self._maybe_idle_locked()

    def close(self, *, drain: bool = True, timeout: float | None = None) -> None:
        """Stop accepting requests. ``drain=True`` flushes everything still
        queued (ignoring flush-interval aging) before the dispatcher exits —
        in-flight work may still retry or fail over while draining, so every
        ticket deterministically resolves to delivered or a typed error;
        ``drain=False`` fails queued requests with ``EngineClosed``."""
        self.shut_intake(drain=drain)
        with self._mu:
            thread = self._thread
        if thread is not None:
            thread.join(timeout)
        elif drain:
            while self.step():
                pass

    def __enter__(self) -> "BatchingCore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- stats --------------------------------------------------------------

    @property
    def pending(self) -> int:
        with self._mu:
            return self._depth

    def snapshot(self) -> dict:
        """Point-in-time stats: global counters, queue depth/in-flight, and
        per-bucket occupancy, padding counters and p50/p95 delivered latency
        (seconds, engine clock)."""
        with self._mu:
            out = dict(self.stats)
            out["queue_depth"] = self._depth
            out["in_flight"] = self._in_flight
            buckets = {}
            for bucket, bs in self._buckets.items():
                b = {k: v for k, v in bs.items() if k != "lat"}
                if bs["dispatches"]:
                    b["occupancy"] = bs["batch_sum"] / (
                        bs["dispatches"] * self.cfg.max_batch)
                    b["avg_batch"] = bs["batch_sum"] / bs["dispatches"]
                lat = sorted(bs["lat"])
                if lat:
                    b["p50_latency"] = lat[len(lat) // 2]
                    b["p95_latency"] = lat[min(len(lat) - 1,
                                               int(len(lat) * 0.95))]
                if bs.get("total_cells"):
                    b["padding_waste"] = bs.get("pad_cells", 0) / bs["total_cells"]
                br = self._breakers.get(bucket)
                if br is not None:
                    b["breaker"] = br["state"]
                buckets[bucket] = b
            out["buckets"] = buckets
        return out


class ManualDispatcher:
    """Deterministic, scriptable dispatch seam for tests.

    Records every ``(bucket, payloads)`` call; by default maps ``fn`` (the
    identity) over the payloads. Fault injection: ``fail_call(k, exc=...)``
    makes the k-th call (1-based) raise, ``fail_call(k, results=...)``
    substitutes the k-th call's return value — a list (possibly partial, or
    containing ``Exception`` entries for per-request rejection) or a callable
    of the payloads. Each scripted failure fires once."""

    def __init__(self, fn=None):
        self.fn = fn if fn is not None else (lambda p: p)
        self.calls: list[tuple] = []
        self._failures: dict[int, tuple] = {}

    def fail_call(self, k: int, exc: BaseException | None = None,
                  results=None) -> None:
        self._failures[k] = (exc, results)

    def __call__(self, bucket, payloads):
        self.calls.append((bucket, list(payloads)))
        k = len(self.calls)
        if k in self._failures:
            exc, results = self._failures.pop(k)
            if exc is not None:
                raise exc
            return results(payloads) if callable(results) else results
        return [self.fn(p) for p in payloads]
