"""Serving-runtime observability: counters, gauges and histograms with
streaming quantiles (the metrics half of the production surface; the
liveness/readiness half is ``serve/health.py``).

The port's own copy of ``repro/serve/metrics.py`` (the port imports nothing
of the JAX package): the same instruments, the same bucket bounds, the same
snapshots.

The paper's §4.4 deployment claim ("latency-free for the CTR server") is a
*latency-distribution* claim — it cannot be audited from throughput columns
alone. This registry is the one sink every serving layer reports into:

  * ``Counter``   — monotone event counts (requests, sheds, misses,
    promotions, degraded cold reads, …). A counter NEVER decreases; the
    fault-injection suite reads snapshots from a concurrent thread and
    asserts exactly that.
  * ``Gauge``     — last-written level (queue depth, hot-tier fill).
  * ``Histogram`` — streaming latency distribution with O(1) memory:
    observations land in log-spaced buckets (~19% relative resolution,
    ``_GROWTH = 2**0.25``) and p50/p95/p99 are read back by linear
    interpolation inside the covering bucket, clamped to the observed
    min/max. No sample reservoir, no unbounded growth — a week of traffic
    costs the same bytes as a unit test.

Thread-safety: every instrument shares its registry's single lock, and
``snapshot()`` reads everything under that same lock — so a snapshot is an
atomic, internally-consistent cut of the counters (monotone across
successive snapshots even while writer threads hammer the instruments; see
tests/test_runtime_faults.py for the JAX package's copy).

Naming convention is ``layer.metric`` with the per-path split the tentpole
requires: ``bse.fetch_many_ms`` / ``bse.serve_candidates_ms`` /
``ingest.fold_ms`` / ``tier.cold_read_ms`` / ``ctr.request_ms`` histograms;
``tier.promotions`` / ``tier.demotions`` / ``tier.degraded`` /
``ctr.shed`` counters; ``ingest.queue_depth`` / ``tier.hot_fill`` gauges.
All instruments are created lazily on first use, so a layer built without
a registry simply reports nowhere (``metrics=None`` guards stay cheap).
"""
from __future__ import annotations

import math
import threading
from typing import Optional


def _make_bounds() -> tuple:
    """Log-spaced bucket upper bounds: 1e-6 → ~1e4 at 2**0.25 growth.
    Unit-agnostic — callers observe milliseconds by convention, and the
    range covers sub-microsecond dispatch up to multi-second stalls."""
    bounds = []
    b = 1e-6
    while b < 1e4:
        bounds.append(b)
        b *= 2 ** 0.25
    return tuple(bounds)


_BOUNDS = _make_bounds()


class Counter:
    """Monotone counter. ``inc`` with a negative amount is a ValueError —
    monotonicity is the invariant concurrent snapshot readers rely on."""

    __slots__ = ("_lock", "_v")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._v = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter increments must be >= 0, got {n}")
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._v


class Gauge:
    """Last-written level (may go up or down)."""

    __slots__ = ("_lock", "_v")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._v = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Histogram:
    """Streaming distribution: log-spaced buckets + count/sum/min/max.

    ``quantile(q)`` interpolates linearly inside the bucket covering the
    q-rank and clamps to the observed [min, max], so estimates are monotone
    in q and exact at the extremes. Negative/zero observations clamp into
    the first bucket (latencies only).

    **Exemplars**: ``observe(v, exemplar=trace_id)`` makes the
    covering bucket remember the trace id of its LATEST observation, and
    ``exemplar(q)`` reads back the exemplar of the bucket covering the
    q-rank — so "what is p99?" upgrades to "show me a p99 request": the
    returned id resolves against the ``Tracer``'s retained traces
    (serve/tracing.py). Exemplar storage is lazily allocated — histograms
    that never see one pay nothing."""

    __slots__ = ("_lock", "_buckets", "_count", "_sum", "_min", "_max",
                 "_exemplars")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._buckets = [0] * (len(_BOUNDS) + 1)   # +1 overflow bucket
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._exemplars = None          # lazily [trace_id | None] per bucket

    def observe(self, v: float, exemplar=None) -> None:
        v = float(v)
        if math.isnan(v):
            return                      # poisoned sample; never corrupt stats
        # bisect over static bounds — no allocation on the hot path
        lo, hi = 0, len(_BOUNDS)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= _BOUNDS[mid]:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            self._buckets[lo] += 1
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            if exemplar is not None:
                if self._exemplars is None:
                    self._exemplars = [None] * (len(_BOUNDS) + 1)
                self._exemplars[lo] = exemplar

    def exemplar(self, q: float):
        """Trace id exemplifying quantile ``q``: the latest-observation
        exemplar of the bucket covering the q-rank, falling back to the
        nearest populated bucket below that has one. ``None`` when no
        observation carried an exemplar."""
        with self._lock:
            if self._count == 0 or self._exemplars is None:
                return None
            if not 0.0 <= q <= 1.0:
                raise ValueError(f"quantile must be in [0, 1], got {q}")
            rank = q * self._count
            cum = 0
            cover = len(self._buckets) - 1
            for i, n in enumerate(self._buckets):
                cum += n
                if n and cum >= rank:
                    cover = i
                    break
            for i in range(cover, -1, -1):
                if self._exemplars[i] is not None:
                    return self._exemplars[i]
            for i in range(cover + 1, len(self._exemplars)):
                if self._exemplars[i] is not None:
                    return self._exemplars[i]
            return None                # pragma: no cover — guarded above

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        with self._lock:
            return self._quantile_locked(q)

    def _quantile_locked(self, q: float) -> float:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self._count == 0:
            return 0.0
        rank = q * self._count
        cum = 0
        for i, n in enumerate(self._buckets):
            if n == 0:
                continue
            if cum + n >= rank:
                lo = 0.0 if i == 0 else _BOUNDS[i - 1]
                hi = _BOUNDS[i] if i < len(_BOUNDS) else self._max
                frac = (rank - cum) / n
                est = lo + frac * (hi - lo)
                return float(min(max(est, self._min), self._max))
            cum += n
        return float(self._max)        # pragma: no cover — rank <= count

    def snapshot_dict(self) -> dict:
        with self._lock:
            if self._count == 0:
                return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                        "p50": 0.0, "p95": 0.0, "p99": 0.0}
            return {"count": self._count, "sum": self._sum,
                    "min": self._min, "max": self._max,
                    "p50": self._quantile_locked(0.50),
                    "p95": self._quantile_locked(0.95),
                    "p99": self._quantile_locked(0.99)}


class MetricsRegistry:
    """Named instruments, created lazily, all sharing one lock. A name is
    permanently bound to its first-requested kind (asking for the same
    name as a different kind is a programming error and raises)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, object] = {}

    def _get(self, name: str, kind: type):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = kind(self._lock)
                self._instruments[name] = inst
            elif not isinstance(inst, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {kind.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> dict:
        """One atomic cut: ``{"counters": {...}, "gauges": {...},
        "histograms": {name: {count,sum,min,max,p50,p95,p99}}}``. Taken
        under the registry lock, so counters across the snapshot are
        mutually consistent and monotone vs any earlier snapshot."""
        with self._lock:
            counters, gauges, hists = {}, {}, {}
            for name, inst in self._instruments.items():
                if isinstance(inst, Counter):
                    counters[name] = inst._v
                elif isinstance(inst, Gauge):
                    gauges[name] = inst._v
                else:
                    # build the per-histogram dict without re-taking the
                    # (non-reentrant) shared lock
                    h: Histogram = inst
                    if h._count == 0:
                        hists[name] = {"count": 0, "sum": 0.0, "min": 0.0,
                                       "max": 0.0, "p50": 0.0, "p95": 0.0,
                                       "p99": 0.0}
                    else:
                        hists[name] = {
                            "count": h._count, "sum": h._sum,
                            "min": h._min, "max": h._max,
                            "p50": h._quantile_locked(0.50),
                            "p95": h._quantile_locked(0.95),
                            "p99": h._quantile_locked(0.99)}
            return {"counters": counters, "gauges": gauges,
                    "histograms": hists}

    def export_state(self) -> dict:
        """Raw instrument state for exposition-format rendering
        (serve/export.py): one atomic cut like ``snapshot()``, but
        histograms keep their full per-bucket counts (copied) instead of
        collapsing to interpolated quantiles — Prometheus wants the
        buckets themselves. ``bounds`` is the shared upper-bound tuple;
        ``buckets[i]`` counts observations ≤ ``bounds[i]`` (non-
        cumulative; the last entry is the overflow bucket)."""
        with self._lock:
            counters, gauges, hists = {}, {}, {}
            for name, inst in self._instruments.items():
                if isinstance(inst, Counter):
                    counters[name] = inst._v
                elif isinstance(inst, Gauge):
                    gauges[name] = inst._v
                else:
                    hists[name] = {"bounds": _BOUNDS,
                                   "buckets": list(inst._buckets),
                                   "count": inst._count,
                                   "sum": inst._sum}
            return {"counters": counters, "gauges": gauges,
                    "histograms": hists}


def observe_ms(metrics: Optional[MetricsRegistry], name: str,
               seconds: float, exemplar=None) -> None:
    """Guarded convenience: record ``seconds`` into histogram ``name`` in
    milliseconds (optionally carrying a trace-id exemplar), or do nothing
    when no registry is attached."""
    if metrics is not None:
        metrics.histogram(name).observe(1e3 * seconds, exemplar=exemplar)
