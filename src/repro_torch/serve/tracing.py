"""End-to-end request tracing for the serving runtime (the causality half
of observability — ``serve/metrics.py`` holds the aggregates, this module
answers *where a specific request's time went*).

The port's own copy of ``repro/serve/tracing.py``. A span measures the host
clock: around a CUDA launch that nothing synchronizes it holds the launch's
host time, not the kernel's. ``ctr.jit_compile`` keeps the reference's name;
in the port it marks the scoring dispatch that built the kernel library
(``kernels/_build.load``'s first call), the port's one compile on the
request path.

The paper's §4.4 deployment claim ("BSE is latency-free for the CTR
server") is a per-request claim: when a request lands in the p99 bucket we
must be able to say whether the time went to admission, a cold-tier read,
a compile, or the kernel itself — and a ``submit_*`` call must link to
the fold that eventually committed it. Aggregate histograms cannot answer
either; spans can.

Model
-----
  * ``Span`` — one named, monotonic-clock interval with a parent link and
    free-form ``attrs``. Spans nest via a thread-local stack: the first
    ``tracer.span(...)`` on a thread opens a new *trace* (its root span);
    nested calls open children.
  * ``Trace`` — all spans sharing one request-scoped ``trace_id``, plus a
    set of ``flags`` (``shed`` / ``degraded`` / ``forced_drain``) that
    drive retention.
  * ``SpanContext`` — a (trace_id, span_id) pair that can CROSS THREADS:
    the async-ingest queue carries the submitter's context so the writer
    loop's fold lands in the submitting request's trace
    (``Tracer.add_span``), causally linked and on the writer's timeline.

Retention (bounded, tail-based)
-------------------------------
A production tracer cannot keep every trace. On root-span close the trace
is either:
  * **always kept** (bounded FIFO ring of ``max_tail``) when it is flagged
    (shed / degraded / forced_drain) or its root latency ≥ ``slow_ms`` —
    the traces worth debugging are exactly the anomalous ones; or
  * **reservoir-sampled** into ``max_sampled`` slots (uniform over the
    run, seeded — deterministic in tests) so the healthy baseline stays
    inspectable too.
Spans arriving after retention was decided (the async fold of a sampled
request) append if the trace was kept and are dropped silently otherwise.

Zero-cost when off
------------------
``tracer=None`` call sites pay one ``is None`` check; a constructed-but-
disabled tracer (``enabled=False``) returns the shared ``NOOP_SPAN``
singleton from ``span()`` — no allocation, no clock read, no lock. The
disabled-overhead bound is pinned by tests/test_tracing.py for the JAX
package's copy.

Export: ``to_chrome_trace()`` renders the retained traces as Chrome
trace-event JSON (``"X"`` complete events, µs timestamps, one ``tid`` per
thread name) loadable in Perfetto / ``chrome://tracing``; ``report()``
prints the slowest-k breakdown the launcher shows at end of run.
"""
from __future__ import annotations

import collections
import itertools
import json
import random
import threading
import time
from typing import Any, Callable, NamedTuple, Optional, Sequence


class SpanContext(NamedTuple):
    """Portable handle to (trace, span) — what rides a queue entry across
    the async-ingest boundary."""
    trace_id: str
    span_id: int


class Span:
    """One monotonic-clock interval. ``t1 is None`` until finished.
    Mutable by design: ``set()`` attaches attrs mid-span and the dispatch
    path renames ``ctr.score`` to ``ctr.jit_compile`` once it knows the
    dispatch built the kernel library."""

    __slots__ = ("name", "span_id", "parent_id", "t0", "t1", "thread",
                 "attrs")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 t0: float, thread: str):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.t1: Optional[float] = None
        self.thread = thread
        self.attrs: Optional[dict] = None

    def set(self, **attrs) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(attrs)

    @property
    def duration_s(self) -> float:
        if self.t1 is None:
            return 0.0
        return max(self.t1 - self.t0, 0.0)

    @property
    def duration_ms(self) -> float:
        return 1e3 * self.duration_s


class Trace:
    """All spans of one trace_id; ``spans[0]`` is the root."""

    __slots__ = ("trace_id", "spans", "flags")

    def __init__(self, trace_id: str):
        self.trace_id = trace_id
        self.spans: list[Span] = []
        self.flags: set = set()

    @property
    def root(self) -> Span:
        return self.spans[0]

    @property
    def duration_ms(self) -> float:
        return self.root.duration_ms

    def children_of(self, span_id: int) -> list[Span]:
        return [s for s in self.spans if s.parent_id == span_id]


class _NoopSpan:
    """Shared do-nothing span: the disabled-tracing fast path. One module
    singleton — entering it allocates nothing and reads no clock."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> None:
        return None


NOOP_SPAN = _NoopSpan()


class _SpanHandle:
    """Context manager binding an open ``Span`` to its tracer; closing the
    ROOT span hands the trace to the retention policy."""

    __slots__ = ("_tracer", "_trace", "span")

    def __init__(self, tracer: "Tracer", trace: Trace, span: Span):
        self._tracer = tracer
        self._trace = trace
        self.span = span

    # attr passthroughs so call sites treat handle and span alike
    def set(self, **attrs) -> None:
        self.span.set(**attrs)

    @property
    def name(self) -> str:
        return self.span.name

    @name.setter
    def name(self, value: str) -> None:
        self.span.name = value

    def __enter__(self) -> "_SpanHandle":
        return self

    def __exit__(self, *exc) -> None:
        self._tracer._exit_span(self._trace, self.span)


def maybe_span(tracer: Optional["Tracer"], name: str, **attrs):
    """Guarded ``tracer.span``: the one-liner for call sites that may not
    have a tracer attached (returns ``NOOP_SPAN`` when off)."""
    if tracer is None or not tracer.enabled:
        return NOOP_SPAN
    return tracer.span(name, **attrs)


class Tracer:
    """Low-overhead span tracer with bounded, tail-based retention.

    ``clock`` is any monotonic ``() -> seconds`` (injectable —
    ``VirtualClock`` in tests); ``slow_ms`` is the always-keep latency
    threshold (``None`` = only flagged traces are guaranteed);
    ``max_tail`` bounds the always-keep ring, ``max_sampled`` the
    reservoir of unflagged traces. Thread-safe: span enter/exit touch
    thread-local state plus one brief append under the shared lock (also
    taken on root close, cross-thread ``add_span`` and export).
    """

    def __init__(self, enabled: bool = True,
                 clock: Optional[Callable[[], float]] = None,
                 slow_ms: Optional[float] = None,
                 max_tail: int = 512, max_sampled: int = 256,
                 seed: int = 0):
        if max_tail < 1 or max_sampled < 1:
            raise ValueError("max_tail and max_sampled must be >= 1")
        self.enabled = enabled
        self.clock = time.perf_counter if clock is None else clock
        self.slow_ms = slow_ms
        self.max_tail = max_tail
        self.max_sampled = max_sampled
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._ids = itertools.count(1)      # CPython next() is atomic
        self._rng = random.Random(seed)
        self._by_id: dict[str, Trace] = {}  # retained + live
        self._tail: collections.deque = collections.deque()   # trace ids
        self._sampled: list[str] = []       # reservoir of trace ids
        self._n_sample_seen = 0
        self.n_traces = 0                   # roots opened
        self.n_spans = 0
        self.n_dropped = 0                  # finished, not retained

    # ------------------------------------------------------------------
    # span lifecycle (owning thread)
    # ------------------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def span(self, name: str, **attrs):
        """Open a span: a new trace's root when the thread has no open
        span, a child of the innermost open span otherwise. Use as a
        context manager; ``set()`` attaches attrs."""
        if not self.enabled:
            return NOOP_SPAN
        st = self._stack()
        t0 = self.clock()
        sid = next(self._ids)
        tname = threading.current_thread().name
        if st:
            trace, parent = st[-1]
            sp = Span(name, sid, parent.span_id, t0, tname)
        else:
            tid = f"t{next(self._ids):08x}"
            trace = Trace(tid)
            sp = Span(name, sid, None, t0, tname)
            self.n_traces += 1
            with self._lock:
                self._by_id[tid] = trace    # live; retention decides later
        if attrs:
            sp.set(**attrs)
        self.n_spans += 1
        with self._lock:
            trace.spans.append(sp)
        st.append((trace, sp))
        return _SpanHandle(self, trace, sp)

    def _exit_span(self, trace: Trace, span: Span) -> None:
        span.t1 = self.clock()
        st = self._stack()
        # pop through abandoned inner frames (exception unwound past them)
        while st and st[-1][1] is not span:
            st.pop()
        if st:
            st.pop()
        if span.parent_id is None:
            self._retain(trace)

    def current(self) -> Optional[SpanContext]:
        """Context of the innermost open span on THIS thread (what a queue
        entry should carry across the async boundary), or None."""
        if not self.enabled:
            return None
        st = getattr(self._tls, "stack", None)
        if not st:
            return None
        trace, span = st[-1]
        return SpanContext(trace.trace_id, span.span_id)

    def annotate(self, **attrs) -> None:
        """Attach attrs to the innermost open span on this thread."""
        st = getattr(self._tls, "stack", None)
        if st:
            st[-1][1].set(**attrs)

    def flag(self, name: str) -> None:
        """Mark the current thread's open trace (``shed`` / ``degraded`` /
        ``forced_drain`` / ...): flagged traces are ALWAYS retained."""
        st = getattr(self._tls, "stack", None)
        if st:
            st[-1][0].flags.add(name)

    # ------------------------------------------------------------------
    # cross-thread spans (the async-ingest boundary)
    # ------------------------------------------------------------------
    def add_span(self, ctx: Optional[SpanContext], name: str, t0: float,
                 t1: float, **attrs) -> None:
        """Append a FINISHED span to the trace behind ``ctx``, parented to
        ``ctx.span_id`` — how the writer loop lands ``ingest.queued`` /
        ``ingest.fold`` in the submitting request's trace. Silently a
        no-op when the trace was sampled out (retention already decided)
        or ``ctx`` is None."""
        if ctx is None or not self.enabled:
            return
        with self._lock:
            trace = self._by_id.get(ctx.trace_id)
            if trace is None:
                return
            sp = Span(name, next(self._ids), ctx.span_id, t0,
                      threading.current_thread().name)
            sp.t1 = t1
            if attrs:
                sp.set(**attrs)
            trace.spans.append(sp)
            self.n_spans += 1

    def flag_ctx(self, ctx: Optional[SpanContext], name: str) -> None:
        """``flag`` by context: marks a (possibly already finished) trace.
        A trace already sampled out stays dropped — flags steer retention
        at root close, not retroactively."""
        if ctx is None or not self.enabled:
            return
        with self._lock:
            trace = self._by_id.get(ctx.trace_id)
            if trace is not None:
                trace.flags.add(name)

    # ------------------------------------------------------------------
    # retention: always-keep tail + reservoir
    # ------------------------------------------------------------------
    def _retain(self, trace: Trace) -> None:
        keep_tail = bool(trace.flags) or (
            self.slow_ms is not None
            and trace.duration_ms >= self.slow_ms)
        with self._lock:
            if keep_tail:
                self._tail.append(trace.trace_id)
                if len(self._tail) > self.max_tail:
                    evicted = self._tail.popleft()
                    self._by_id.pop(evicted, None)
                    self.n_dropped += 1
                return
            self._n_sample_seen += 1
            if len(self._sampled) < self.max_sampled:
                self._sampled.append(trace.trace_id)
                return
            j = self._rng.randrange(self._n_sample_seen)
            if j < self.max_sampled:
                self._by_id.pop(self._sampled[j], None)
                self._sampled[j] = trace.trace_id
            else:
                self._by_id.pop(trace.trace_id, None)
            self.n_dropped += 1

    # ------------------------------------------------------------------
    # read side
    # ------------------------------------------------------------------
    def get(self, trace_id: str) -> Optional[Trace]:
        with self._lock:
            return self._by_id.get(trace_id)

    def traces(self) -> list[Trace]:
        """Every retained trace (tail + reservoir + still-open), insertion
        order."""
        with self._lock:
            return list(self._by_id.values())

    def finished(self) -> list[Trace]:
        return [t for t in self.traces() if t.spans and t.root.t1 is not None]

    def slowest(self, k: int = 5) -> list[Trace]:
        return sorted(self.finished(), key=lambda t: t.duration_ms,
                      reverse=True)[:k]

    def summary(self) -> dict:
        """Aggregate roll-up: retention
        counts, per-name span totals, compile-span count and the
        span-coverage fraction — the share of retained root time that is
        accounted for by direct child spans (1.0 = every root millisecond
        is attributed to a named stage)."""
        finished = self.finished()
        root_s = 0.0
        child_s = 0.0
        n_compile = 0
        by_name: dict[str, dict] = {}
        for t in finished:
            rd = t.root.duration_s
            root_s += rd
            cd = sum(min(s.duration_s, rd)
                     for s in t.children_of(t.root.span_id))
            child_s += min(cd, rd)
        for t in self.traces():
            for s in t.spans:
                if s.name == "ctr.jit_compile":
                    n_compile += 1
                agg = by_name.setdefault(s.name, {"count": 0,
                                                  "total_ms": 0.0})
                agg["count"] += 1
                agg["total_ms"] += s.duration_ms
        with self._lock:
            n_tail, n_sampled = len(self._tail), len(self._sampled)
        return {
            "n_traces": self.n_traces,
            "n_spans": self.n_spans,
            "n_finished": len(finished),
            "n_retained_tail": n_tail,
            "n_retained_sampled": n_sampled,
            "n_dropped": self.n_dropped,
            "n_compile_spans": n_compile,
            "span_coverage": (min(child_s / root_s, 1.0)
                              if root_s > 0 else 0.0),
            "by_name": by_name,
        }

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def to_chrome_trace(self) -> dict:
        """Chrome trace-event JSON (Perfetto / chrome://tracing loadable):
        one ``"X"`` complete event per finished span (µs since the first
        retained span; monotone within each thread), plus ``"M"``
        thread-name metadata. Unfinished spans are skipped — a live trace
        exports its closed children."""
        traces = self.traces()
        spans = [(t, s) for t in traces for s in t.spans
                 if s.t1 is not None]
        t_base = min((s.t0 for _, s in spans), default=0.0)
        tids: dict[str, int] = {}
        events = []
        for t, s in spans:
            tid = tids.setdefault(s.thread, len(tids) + 1)
            args = {"trace_id": t.trace_id, "span_id": s.span_id}
            if s.parent_id is not None:
                args["parent_id"] = s.parent_id
            if s.attrs:
                args.update(s.attrs)
            if t.flags and s.parent_id is None:
                args["flags"] = sorted(t.flags)
            events.append({
                "name": s.name, "ph": "X", "cat": "serve",
                "ts": 1e6 * (s.t0 - t_base),
                "dur": 1e6 * s.duration_s,
                "pid": 1, "tid": tid, "args": args,
            })
        events.sort(key=lambda e: (e["tid"], e["ts"]))
        meta = [{"name": "process_name", "ph": "M", "pid": 1,
                 "args": {"name": "repro-serve"}}]
        meta += [{"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                  "args": {"name": thread}}
                 for thread, tid in sorted(tids.items(), key=lambda kv: kv[1])]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def save_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, default=str)
        return path

    def report(self, k: int = 5) -> str:
        """Human-readable slowest-``k`` breakdown (end-of-run launcher
        output): per trace, the root latency, flags, and each child span's
        share."""
        slow = self.slowest(k)
        if not slow:
            return "tracing: no finished traces retained"
        s = self.summary()
        lines = [f"tracing: {s['n_traces']} traces "
                 f"({s['n_retained_tail']} tail + "
                 f"{s['n_retained_sampled']} sampled retained, "
                 f"{s['n_dropped']} dropped), "
                 f"span coverage {s['span_coverage']:.0%}, "
                 f"{s['n_compile_spans']} compile spans",
                 f"slowest {len(slow)} traces:"]
        for t in slow:
            flags = f" [{','.join(sorted(t.flags))}]" if t.flags else ""
            lines.append(f"  {t.trace_id} {t.duration_ms:8.3f}ms"
                         f" {t.root.name}{flags}")
            for c in sorted(t.children_of(t.root.span_id),
                            key=lambda c: c.t0):
                extra = ""
                if c.attrs:
                    extra = " " + ",".join(f"{k}={v}" for k, v in
                                           sorted(c.attrs.items()))
                lines.append(f"    {c.duration_ms:10.3f}ms {c.name}{extra}")
        return "\n".join(lines)
