"""Request-path hardening primitives: token-bucket rate limiting, a
circuit breaker for the cold tier, and the admission controller that
``CTRServer.handle_requests`` runs every burst through.

The port's own copy of ``repro/serve/admission.py``: the same decisions
under the same clock.

The paper's §4.4 guarantee only holds while the serving runtime survives
overload and slow dependencies without stalling the request path. The
production patterns here (cf. SIM 2006.05639 / MIMN 1905.09248 deployment
sections) all share one rule — **degrade loudly, never stall, never lose
silently**:

  * ``TokenBucket`` — sustained-rate admission with burst headroom.
    ``acquire_upto(n)`` admits the *prefix* of a burst the budget covers,
    so a burst is partially served rather than all-or-nothing rejected.
  * ``CircuitBreaker`` — closed → open → half-open → closed around the
    cold tier. A cold read slower than ``deadline_s`` (or raising) is a
    failure; ``failure_threshold`` failures open the circuit, after which
    cold users *degrade to counted misses* (``TierStats.n_degraded``)
    instead of stalling every request behind a sick disk. After
    ``reset_timeout_s`` one probe read is allowed through (half-open):
    fast → closed, slow → re-open.
  * ``AdmissionController`` — the per-burst gate: a non-blocking
    concurrency bound (shed-on-full, whole burst) composed with the token
    bucket (shed the tail). Every shed is counted; callers return an
    explicit ``None`` per shed request, never a shorter list.

Every primitive takes an injectable ``clock`` (``time.monotonic``-like
callable) so tests can
drive timeouts and deadlines deterministically with a virtual clock — no
wall-clock sleeps anywhere in the tests.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/sec refill, capacity
    ``burst`` (default = rate, i.e. one second of headroom). Starts full.
    Non-blocking — callers shed what they cannot acquire."""

    def __init__(self, rate: float, burst: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if rate <= 0:
            raise ValueError(f"rate must be > 0 tokens/sec, got {rate}")
        self.rate = float(rate)
        self.burst = float(rate if burst is None else burst)
        if self.burst < 1:
            raise ValueError(f"burst must be >= 1 token, got {self.burst}")
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = self.burst
        self._t = clock()

    def _refill_locked(self) -> None:
        now = self._clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._t) * self.rate)
        self._t = now

    def try_acquire(self, n: int = 1) -> bool:
        """Take ``n`` tokens or none (all-or-nothing)."""
        with self._lock:
            self._refill_locked()
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def acquire_upto(self, n: int) -> int:
        """Take as many of ``n`` tokens as the budget covers (0..n)."""
        with self._lock:
            self._refill_locked()
            k = min(n, int(self._tokens))
            self._tokens -= k
            return k

    @property
    def tokens(self) -> float:
        with self._lock:
            self._refill_locked()
            return self._tokens


class CircuitBreaker:
    """closed → open → half-open → closed, driven by read durations.

    ``record(duration_s)`` classifies one dependency call: within
    ``deadline_s`` = success, over = failure. ``failure_threshold``
    consecutive failures open the circuit (``allow()`` returns False —
    callers degrade instead of calling the dependency). After
    ``reset_timeout_s`` the next ``allow()`` admits exactly one probe
    (half-open); its outcome closes or re-opens the circuit.

    Thread-safe; transition counts (``n_opens``/``n_half_opens``/
    ``n_closes``) are exported via ``snapshot()`` for the health surface.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, deadline_s: float, failure_threshold: int = 1,
                 reset_timeout_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        self.deadline_s = float(deadline_s)
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self.n_opens = 0
        self.n_half_opens = 0
        self.n_closes = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May the caller hit the dependency right now? Open circuits
        admit one probe per ``reset_timeout_s`` window (half-open)."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if self._clock() - self._opened_at >= self.reset_timeout_s:
                    self._state = self.HALF_OPEN
                    self.n_half_opens += 1
                    return True
                return False
            return False               # half-open: probe already in flight

    def record(self, duration_s: float) -> None:
        if duration_s <= self.deadline_s:
            self.record_success()
        else:
            self.record_failure()

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state == self.HALF_OPEN:
                self._state = self.CLOSED
                self.n_closes += 1

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if (self._state == self.HALF_OPEN
                    or self._failures >= self.failure_threshold):
                if self._state != self.OPEN:
                    self.n_opens += 1
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._failures = 0

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self._state, "n_opens": self.n_opens,
                    "n_half_opens": self.n_half_opens,
                    "n_closes": self.n_closes,
                    "deadline_s": self.deadline_s}


@dataclasses.dataclass
class AdmissionStats:
    """Conservation ledger: ``n_offered == n_admitted + n_shed`` always
    (pinned by the fault-injection property suite)."""

    n_offered: int = 0
    n_admitted: int = 0
    n_shed_rate: int = 0          # token bucket exhausted (burst tail)
    n_shed_concurrency: int = 0   # concurrency bound hit (whole burst)

    @property
    def n_shed(self) -> int:
        return self.n_shed_rate + self.n_shed_concurrency


class AdmissionController:
    """The per-burst request gate: non-blocking concurrency slots
    (shed-on-full) + token-bucket rate limiting (shed the tail). Both
    knobs optional; with neither set every request is admitted (but still
    counted, so the conservation ledger stays total)."""

    def __init__(self, max_concurrency: Optional[int] = None,
                 rate: Optional[float] = None,
                 burst: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if max_concurrency is not None and max_concurrency < 1:
            raise ValueError(
                f"max_concurrency must be >= 1, got {max_concurrency}")
        self.max_concurrency = max_concurrency
        self.bucket = (None if rate is None
                       else TokenBucket(rate, burst, clock=clock))
        self._lock = threading.Lock()
        self._inflight = 0
        self.stats = AdmissionStats()

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def enter(self) -> bool:
        """Claim a concurrency slot (non-blocking). False = caller must
        shed the whole burst. Always pair with ``exit()`` when True."""
        with self._lock:
            if (self.max_concurrency is not None
                    and self._inflight >= self.max_concurrency):
                return False
            self._inflight += 1
            return True

    def exit(self) -> None:
        with self._lock:
            assert self._inflight > 0, "exit() without matching enter()"
            self._inflight -= 1

    def admit(self, n: int) -> int:
        """Rate-limit a burst of ``n`` requests: returns how many are
        admitted (a prefix; the tail is shed and counted)."""
        k = n if self.bucket is None else self.bucket.acquire_upto(n)
        with self._lock:
            self.stats.n_offered += n
            self.stats.n_admitted += k
            self.stats.n_shed_rate += n - k
        return k

    def shed_all(self, n: int) -> None:
        """Book a whole burst shed at the concurrency gate."""
        with self._lock:
            self.stats.n_offered += n
            self.stats.n_shed_concurrency += n
