"""Injectable time seam for the serving layers.

Every component that reads the time or waits for it (the continuous-batching
dispatcher in ``serve/batching.py``, its deadline/timeout bookkeeping) goes
through a ``Clock`` instead of ``time``/``threading`` directly, so tests can
drive *all* timing paths — deadline-triggered flushes, request timeouts,
load-shedding windows — deterministically with :class:`FakeClock` and zero
wall-clock sleeps.

The waiting primitive is condition-based, not sleep-based: ``wait(cond,
timeout)`` parks the caller on a ``threading.Condition`` it already holds,
so real engines wake instantly on new work (``notify``) and fake-clock
engines wake when a test calls :meth:`FakeClock.advance` past the timeout.

The same sleeper registry backs the *watchdog* side of the serving stack
(``serve/replica.py``): the hung-dispatch watchdog parks on its own
condition with ``wait(cond, budget_remaining)``, so a test can drive a
"dispatch exceeded its wall-clock budget" expiry purely by advancing a
``FakeClock`` — no real sleeps anywhere in the timeout path.
"""

from __future__ import annotations

import threading
import time


class Clock:
    """Interface: ``now()`` in seconds + condition ``wait``."""

    def now(self) -> float:
        raise NotImplementedError

    def wait(self, cond: threading.Condition, timeout: float | None) -> None:
        """Wait on ``cond`` (whose lock the caller holds) until notified or
        until ``timeout`` seconds of *this clock's* time pass. Spurious
        wakeups are allowed — callers must re-check their predicate."""
        raise NotImplementedError


class MonotonicClock(Clock):
    """Real time: ``time.monotonic`` + plain timed condition waits."""

    def now(self) -> float:
        return time.monotonic()

    def wait(self, cond: threading.Condition, timeout: float | None) -> None:
        cond.wait(timeout)


class FakeClock(Clock):
    """Manually advanced clock for deterministic timing tests.

    ``now()`` returns the test-controlled time; ``advance(dt)`` moves it
    forward and notifies any thread whose timed ``wait`` has expired. A
    sleeper notified early (new work arrived) simply leaves a stale entry
    behind — a later ``advance`` then delivers one spurious ``notify_all``,
    which the ``Clock.wait`` contract already requires callers to tolerate.

    Most tests don't even need threads: they pair a ``FakeClock`` with a
    stopped engine (``start=False``) and pump it via ``step()`` after each
    ``advance`` — see tests/test_batching.py.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)
        self._mu = threading.Lock()
        self._sleepers: list[tuple[threading.Condition, float]] = []

    def now(self) -> float:
        with self._mu:
            return self._t

    def wait(self, cond: threading.Condition, timeout: float | None) -> None:
        if timeout is not None:
            with self._mu:
                self._sleepers.append((cond, self._t + timeout))
        cond.wait()

    def sleeper_count(self) -> int:
        """Number of registered timed waits not yet expired — lets watchdog
        tests assert that a budget timer really is armed before advancing
        time past it."""
        with self._mu:
            return len(self._sleepers)

    def advance(self, dt: float) -> float:
        """Move time forward by ``dt`` seconds; wake expired sleepers.
        Returns the new time."""
        if dt < 0:
            raise ValueError(f"cannot advance time backwards (dt={dt})")
        with self._mu:
            self._t += dt
            now = self._t
            due = [c for c, wake in self._sleepers if wake <= now]
            self._sleepers = [(c, w) for c, w in self._sleepers if w > now]
        for cond in due:
            with cond:
                cond.notify_all()
        return now

    def advance_to(self, t: float) -> float:
        """Advance to absolute time ``t`` (no-op if already past it)."""
        with self._mu:
            dt = t - self._t
        return self.advance(max(0.0, dt))
