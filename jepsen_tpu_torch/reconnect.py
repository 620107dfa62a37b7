"""Auto-reconnecting connection wrapper and capped exponential backoff.

A copy of the JAX package's ``reconnect.py`` (after jepsen's
``reconnect.clj``): :class:`Wrapper` hands out a live connection and
reopens it after an error, :class:`Backoff` schedules the retries.  The
fleet router's health probes run on :class:`Backoff`
(``fleet/router.py``).  Schedules are the JAX package's for the same
seeded ``rng``.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

log = logging.getLogger("jepsen")


def _note_exhausted() -> None:
    """One backoff schedule out of budget — a fleet-health signal (a
    campaign whose exhaustion counter climbs has nodes that stay dead
    through whole ramps) fed to the flight recorder's /metrics."""
    from .obs import metrics as _obs_metrics

    _obs_metrics.REGISTRY.counter(
        "jtpu_backoff_exhausted_total",
        "Reconnect backoff schedules that ran out of budget").inc()


@dataclass
class Backoff:
    """Capped exponential backoff with jitter and an attempts budget.

    The raw schedule is ``min(cap, base * factor**attempt)``; each delay
    is then shortened by up to ``jitter`` of itself (decorrelated
    retries: a fleet of clients reopening after the same crash must not
    reconnect in lockstep).  ``max_attempts`` bounds the whole loop — a
    reopen loop against a dead server terminates with the last error
    instead of spinning forever at a fixed interval.

    ``rng`` is injectable so the schedule is unit-testable."""

    base: float = 0.05
    cap: float = 2.0
    factor: float = 2.0
    max_attempts: int = 8
    jitter: float = 0.5
    rng: random.Random = field(default_factory=random.Random)
    #: stateful cursor for step()/exhausted() loops (health monitors);
    #: run() keeps its own per-call counter and ignores this
    attempt: int = field(default=0, init=False, compare=False)

    def raw_delay(self, attempt: int) -> float:
        """The un-jittered delay before retry ``attempt`` (0-based)."""
        return min(self.cap, self.base * self.factor ** attempt)

    def delay(self, attempt: int) -> float:
        raw = self.raw_delay(attempt)
        return raw * (1.0 - self.jitter * self.rng.random())

    def delays(self) -> list[float]:
        """The whole jittered schedule (one delay per retry; attempt 0
        runs immediately, so there are ``max_attempts - 1`` sleeps)."""
        return [self.delay(i) for i in range(max(0, self.max_attempts - 1))]

    def budget_s(self) -> float:
        """Worst-case total sleep time across the budget (no jitter)."""
        return sum(self.raw_delay(i)
                   for i in range(max(0, self.max_attempts - 1)))

    # -- the stateful schedule (continuous health loops) ---------------

    def step(self) -> float:
        """The next delay in the STATEFUL schedule; the cursor
        advances.  A monitor loop sleeps ``step()`` after each failed
        probe and calls :meth:`reset` after each success, so a node
        that recovers then re-fails starts from the base delay — not
        the capped one it had ratcheted to."""
        d = self.delay(self.attempt)
        self.attempt += 1
        budget = max(1, self.max_attempts) - 1
        if self.attempt == budget or (budget == 0
                                      and self.attempt == 1):
            # the cursor just crossed the budget (a zero-sleep budget
            # is born exhausted: its first step counts) — the same
            # event run() records on its final failure
            _note_exhausted()
        return d

    def exhausted(self) -> bool:
        """Has the stateful cursor spent the schedule's sleep budget
        (``max_attempts - 1`` sleeps — the same budget :meth:`run`
        spends across its ``max_attempts`` calls)?  A bounded loop
        checks this after each failed probe; :meth:`reset` re-arms.
        An exhausted-but-unreset Backoff makes later loops fail FAST
        (one probe, no re-ramp) until a success resets it — the
        self-healing campaign wants a permanently dead node to cost
        one probe per restart attempt, not a full ramp."""
        return self.attempt >= max(1, self.max_attempts) - 1

    def reset(self) -> None:
        """Re-arm the stateful schedule (successful health check)."""
        self.attempt = 0

    def clone(self) -> "Backoff":
        """A state-identical copy: same cursor AND the same rng stream
        position (``delay`` draws from the rng even at ``jitter=0``, so
        two schedules only stay in lockstep if the stream is copied).
        The model checker clones worlds mid-schedule; a shallow copy
        sharing the rng would let one branch advance another's."""
        b = Backoff(base=self.base, cap=self.cap, factor=self.factor,
                    max_attempts=self.max_attempts, jitter=self.jitter,
                    rng=random.Random())
        b.rng.setstate(self.rng.getstate())
        b.attempt = self.attempt
        return b

    def run(self, fn: Callable[[], Any], *, desc: str = "retry",
            sleep: Callable[[float], None] = time.sleep):
        """Call ``fn`` until it returns without raising; sleep the
        jittered schedule between attempts; after ``max_attempts``
        failures re-raise the last error."""
        last: Optional[BaseException] = None
        for attempt in range(max(1, self.max_attempts)):
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — caller's fn decides
                last = e
                if attempt + 1 >= self.max_attempts:
                    _note_exhausted()
                    break
                d = self.delay(attempt)
                log.debug("%s failed (attempt %d/%d): %s; retrying in "
                          "%.3fs", desc, attempt + 1, self.max_attempts,
                          e, d)
                sleep(d)
        raise last  # type: ignore[misc]


class Wrapper:
    """reconnect.clj:16-56: open/close/name/log? policy functions."""

    def __init__(self, open: Callable[[], Any],
                 close: Callable[[Any], None] = lambda c: None,
                 name: str = "conn", log_errors: bool = True,
                 backoff: Optional[Backoff] = None):
        self._open = open
        self._close = close
        self.name = name
        self.log_errors = log_errors
        self.backoff = backoff
        self._lock = threading.RLock()
        self._conn: Optional[Any] = None
        self._closed = True

    def _open_retrying(self):
        """One open attempt, or the backoff-scheduled reopen loop when a
        :class:`Backoff` was given — capped exponential + jitter with an
        attempts budget, never a fixed-interval spin."""
        if self.backoff is None:
            return self._open()
        return self.backoff.run(self._open, desc=f"open {self.name}")

    def open(self) -> "Wrapper":
        """reconnect.clj:58-66."""
        with self._lock:
            if self._closed:
                self._conn = self._open_retrying()
                self._closed = False
        return self

    def conn(self):
        with self._lock:
            if self._closed:
                self.open()
            return self._conn

    def reopen(self) -> "Wrapper":
        """Close (ignoring errors) and open a fresh conn
        (reconnect.clj:77-90)."""
        with self._lock:
            try:
                if self._conn is not None:
                    self._close(self._conn)
            except Exception as e:
                if self.log_errors:
                    log.warning("error closing %s: %s", self.name, e)
            self._conn = self._open_retrying()
            self._closed = False
        return self

    def close(self) -> None:
        """reconnect.clj:103-112."""
        with self._lock:
            try:
                if self._conn is not None:
                    self._close(self._conn)
            finally:
                self._conn = None
                self._closed = True

    def with_conn(self, f: Callable[[Any], Any]):
        """Run f(conn); on error, reopen the conn and re-raise
        (reconnect.clj:92-101)."""
        c = self.conn()
        try:
            return f(c)
        except Exception as e:
            if self.log_errors:
                log.warning("error on %s: %s; reopening", self.name, e)
            try:
                self.reopen()
            except Exception as e2:
                if self.log_errors:
                    log.warning("error reopening %s: %s", self.name, e2)
            raise e


def wrapper(**kw) -> Wrapper:
    return Wrapper(**kw)
