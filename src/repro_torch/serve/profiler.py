"""Measured kernel profiling and the memory ledger of the serving stores.

Counterpart of ``repro/serve/profiler.py``: the same classes, fields and
reports, so the two packages' ``profile.json`` read alike
(``tools/profile_report.py`` renders either, ``tools/bench_check.py::
check_profile`` checks either).

``KernelProfiler``
    Wraps ``SDIMEngine``'s dispatch sites (encode / query / serve /
    serve_fused / update and their sharded variants: the engine routes
    every kernel call through ``profiler.profile`` when one is attached).
    Per dispatch it records the time of the call: on the card, a pair of
    CUDA events on the stream the dispatch runs on, the host waiting on
    the end event (a dispatch over shards on several cards: the host clock
    around it, each card's stream synchronized); with an injected
    ``clock`` (``StepClock`` in the tests), that clock around the call and
    a wait for the stream; on the CPU, ``time.perf_counter``. The first
    dispatch of each (kernel, argument shapes and dtypes) counts as a
    compile and stays out of the sample: it carries the first-use ``nvcc``
    build of ``kernels/_build.py``, as a JAX dispatch that grew its jit
    cache carries the compile. Before every dispatch, outside its timed
    window, it counts the call's flops and bytes with ``kernels/cost.py``
    (the work this call's data needs: valid rows, present users, touched
    slots; a sharded dispatch sums its shards' launches), and adds them up
    over the timed calls as it adds up their time, per kernel and per
    signature: a record's ``flops`` and ``bytes`` are the mean over the
    calls its mean time is taken over, and its roofline prediction
    (``distributed/roofline.py``) is that of those means, with the bytes a
    sharded dispatch moves between distinct devices as its collective term.
    The counts stay on the device (no wait for the card before a dispatch)
    until a record is read, or 1,024 of them are pending, and are then read
    at once.
    The JAX package counts from shapes (XLA's ``cost_analysis()``) once per
    kernel; a data-dependent count taken once would depend on which call
    came first.

``MemoryLedger``
    Byte accounting keyed by ``(store, tier, dtype)`` over every grow /
    evict / promote / demote / quantize / spill / unlink / restore event
    of ``TableStore`` / ``WarmPool`` / ``ColdStore`` (each store has a
    ``ledger`` seam and reports allocation deltas at its event sites).
    Tier totals go out as ``mem.*`` gauges, and ``verify()`` checks
    conservation: the bytes the events add up to for every tier equal the
    bytes the tier holds now (``numel() * element_size()`` of the device
    tensors plus their scales, ``nbytes`` of the host arrays, the sizes of
    the live segment files). dtypes are named as the JAX package names
    them ("float32", "bfloat16", "int8", "float8_e4m3fn"), so the two
    packages' ``snapshot()``s compare.

Both take a lock: under async ingest the writer thread folds (``update``,
``encode``, tier moves) while requests run ``serve_fused``. Both are opt-in:
an engine without a profiler and a store without a ledger pay one ``is
None`` check per call site.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.distributed import roofline
from repro_torch.kernels import cost
from repro_torch.serve.metrics import MetricsRegistry, observe_ms
from repro_torch.serve.tracing import Tracer, maybe_span

# ledger tier -> where the bytes physically live
TIER_LOCATION = {"hot": "device", "warm": "host", "cold": "disk"}


# ---------------------------------------------------------------------------
# kernel profiler
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class KernelRecord:
    """Measured and modeled profile of one named dispatch site (or of one
    signature of it)."""

    name: str
    n_calls: int = 0            # timed dispatches
    n_compiles: int = 0         # first dispatches of a signature, not timed
    total_s: float = 0.0
    min_s: float = math.inf
    max_s: float = 0.0
    total_flops: float = 0.0    # kernels/cost.py, summed over the timed calls
    total_bytes: float = 0.0
    total_collective: float = 0.0   # bytes moved between distinct devices
    n_chips: int = 1                # distinct devices of the dispatch
    _pending: list = dataclasses.field(default_factory=list, repr=False)
    SETTLE_EVERY = 1024             # pending counts read at once at the latest

    def _settle(self) -> None:
        """Add the pending counts of the timed calls to the totals: each
        device's counts read in one copy to the host."""
        if not self._pending:
            return
        vals = [v for c in self._pending for v in c]
        got = [None if torch.is_tensor(v) else float(v) for v in vals]
        by_dev: dict = {}
        for i, v in enumerate(vals):
            if torch.is_tensor(v):
                by_dev.setdefault(v.device, []).append(i)
        for idx in by_dev.values():
            for i, x in zip(idx, torch.stack([vals[i].double() for i in idx]).tolist()):
                got[i] = x
        for flops, nbytes in zip(got[::2], got[1::2]):
            self.total_flops += flops
            self.total_bytes += nbytes
        self._pending.clear()

    @property
    def mean_s(self) -> float:
        return self.total_s / self.n_calls if self.n_calls else 0.0

    @property
    def time_ms(self) -> float:
        """Mean measured time per dispatch, milliseconds."""
        return 1e3 * self.mean_s

    @property
    def flops(self) -> float:
        """Mean counted operations per timed dispatch."""
        self._settle()
        return self.total_flops / self.n_calls if self.n_calls else 0.0

    @property
    def bytes(self) -> float:
        """Mean counted bytes moved per timed dispatch."""
        self._settle()
        return self.total_bytes / self.n_calls if self.n_calls else 0.0

    @property
    def collective(self) -> float:
        """Mean bytes moved between distinct devices per timed dispatch."""
        return self.total_collective / self.n_calls if self.n_calls else 0.0

    @property
    def ai(self) -> float:
        """Arithmetic intensity (flops per byte moved)."""
        return self.flops / self.bytes if self.bytes > 0 else 0.0

    @property
    def predicted(self) -> Optional[roofline.RooflineRecord]:
        """The roofline of the mean counts; None until a call was timed."""
        if not self.n_calls:
            return None
        return roofline.analyze(self.name, self.flops, self.bytes, self.collective,
                                self.n_chips)

    @property
    def pct_peak(self) -> float:
        """Predicted least time over measured time, clamped to [0, 1]; 0.0
        until a call was timed."""
        p = self.predicted
        if p is None or self.mean_s <= 0.0:
            return 0.0
        return min(1.0, p.roofline_time / self.mean_s)

    def add(self, dt: float, c: cost.Cost, collective: int = 0, n_chips: int = 1) -> None:
        self.n_calls += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)
        self._pending.append(c)
        if len(self._pending) >= self.SETTLE_EVERY:     # bound what the card holds
            self._settle()
        self.total_collective += collective
        self.n_chips = max(self.n_chips, n_chips)

    def to_dict(self) -> dict:
        d = {
            "calls": self.n_calls,
            "compiles": self.n_compiles,
            "time_ms": self.time_ms,
            "min_ms": 0.0 if self.min_s is math.inf else 1e3 * self.min_s,
            "max_ms": 1e3 * self.max_s,
            "flops": self.flops,
            "bytes": self.bytes,
            "ai": self.ai,
            "pct_peak": self.pct_peak,
        }
        p = self.predicted
        if p is not None:
            d["predicted"] = {
                "t_compute_ms": 1e3 * p.t_compute,
                "t_memory_ms": 1e3 * p.t_memory,
                "t_collective_ms": 1e3 * p.t_collective,
                "roofline_ms": 1e3 * p.roofline_time,
                "bottleneck": p.bottleneck,
            }
        return d


def _sig(x):
    if torch.is_tensor(x):
        return tuple(x.shape), x.dtype, x.device.type
    if isinstance(x, (tuple, list)):       # a sharded store's blocks
        return tuple(map(_sig, x))
    return x


def _signature(args: tuple, kwargs: dict) -> tuple:
    """What makes a dispatch new: each tensor argument's shape, dtype and
    device (of each block, for a sharded store), and every other argument's
    value."""
    return (tuple(map(_sig, args)), tuple((k, _sig(v)) for k, v in sorted(kwargs.items())))


def _cuda_devices(args: tuple, kwargs: dict) -> list:
    """The CUDA devices the tensors of a dispatch (blocks included) lie on."""
    found = []
    stack = [*args, *kwargs.values()]
    while stack:
        x = stack.pop()
        if isinstance(x, (tuple, list)):
            stack.extend(x)
        elif torch.is_tensor(x) and x.is_cuda and x.device not in found:
            found.append(x.device)
    return found


class KernelProfiler:
    """Measured per-dispatch profiling for ``SDIMEngine``.

    ``attach(engine)`` sets ``engine.profiler``; every later engine
    dispatch goes through ``profile``. ``clock`` is any monotonic ``() ->
    seconds`` (None: CUDA events on the card, ``time.perf_counter`` on the
    CPU); ``metrics`` gets ``kernel.<name>_ms`` histograms and a
    ``kernel.compiles`` counter; ``tracer`` a ``kernel.<name>`` span per
    dispatch carrying the call's ``flops`` / ``bytes`` / ``ai``.
    ``records`` holds one ``KernelRecord`` per kernel, ``signatures`` one
    per (kernel, signature) with the same fields."""

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        self.clock = clock
        self.metrics = metrics
        self.tracer = tracer
        self.records: dict[str, KernelRecord] = {}
        self.signatures: dict[tuple, KernelRecord] = {}      # (name, signature)
        self._lock = threading.Lock()

    def attach(self, engine) -> Any:
        """Wire this profiler into an ``SDIMEngine``; returns the engine."""
        engine.profiler = self
        return engine

    def _timed(self, fn, args: tuple, kwargs: dict):
        devs = _cuda_devices(args, kwargs)
        if self.clock is None and len(devs) == 1:
            stream = torch.cuda.current_stream(devs[0])
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            out = fn(*args, **kwargs)
            end.record(stream)
            end.synchronize()
            return out, start.elapsed_time(end) / 1e3
        clock = time.perf_counter if self.clock is None else self.clock
        t0 = clock()
        out = fn(*args, **kwargs)
        for dev in devs:
            torch.cuda.current_stream(dev).synchronize()
        return out, clock() - t0

    def profile(self, name: str, fn, args: tuple, kwargs: dict):
        """Run one dispatch under measurement: the call's cost (before the
        call: ``update`` writes its store in place), the timed call, and
        the first dispatch of a signature kept out of the sample."""
        key = (name, _signature(args, kwargs))
        with self._lock:
            rec = self.records.get(name)
            if rec is None:
                rec = self.records[name] = KernelRecord(name)
            sig = self.signatures.get(key)
            compiled_now = sig is None
            if compiled_now:
                sig = self.signatures[key] = KernelRecord(name)
        c = cost.DISPATCH[name](*args, **kwargs)
        moved = cost.collective_bytes(name, args, kwargs)
        chips = cost.n_devices(name, args, kwargs)
        with maybe_span(self.tracer, f"kernel.{name}") as sp:
            out, dt = self._timed(fn, args, kwargs)
            with self._lock:
                if compiled_now:
                    rec.n_compiles += 1
                    sig.n_compiles += 1
                else:
                    rec.add(dt, c, moved, chips)
                    sig.add(dt, c, moved, chips)
            if compiled_now:
                sp.set(compile=True)
                if self.metrics is not None:
                    self.metrics.counter("kernel.compiles").inc()
            else:
                observe_ms(self.metrics, f"kernel.{name}_ms", dt)
            if self.tracer is not None and self.tracer.enabled:
                c = cost.settle(c)          # the timed call has synchronized
                sp.set(time_ms=1e3 * dt, flops=c.flops, bytes=c.bytes,
                       ai=c.flops / c.bytes if c.bytes > 0 else 0.0)
        return out

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        """``{kernel: {time_ms, flops, bytes, ai, pct_peak, ...}}``: the
        ``per_kernel`` block of ``profile.json``."""
        with self._lock:
            return {name: rec.to_dict() for name, rec in sorted(self.records.items())}

    def roofline_report(self) -> str:
        """Measured against predicted: per kernel the mean measured time,
        flops, bytes and arithmetic intensity beside the roofline's least
        time and its bottleneck term."""
        hdr = (f"{'kernel':<20} {'calls':>5} {'time_ms':>9} {'flops':>10} "
               f"{'bytes':>10} {'AI':>7} {'pct_peak':>8} {'pred_ms':>9} "
               f"{'bound':<10}")
        lines = ["measured roofline (per dispatch; warmup excluded):", hdr, "-" * len(hdr)]
        with self._lock:        # a record's counts settle as they are read
            records = sorted(self.records.items())
            for name, rec in records:
                if rec.predicted is not None:
                    pred = f"{1e3 * rec.predicted.roofline_time:>9.4f}"
                    bound = rec.predicted.bottleneck
                else:
                    pred, bound = f"{'-':>9}", "-"
                lines.append(
                    f"{name:<20} {rec.n_calls:>5} {rec.time_ms:>9.4f} "
                    f"{rec.flops:>10.3g} {rec.bytes:>10.3g} {rec.ai:>7.3f} "
                    f"{rec.pct_peak:>8.3f} {pred} {bound:<10}")
        if not records:
            lines.append("(no profiled dispatches)")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# memory ledger
# ---------------------------------------------------------------------------
def _dtype_key(dtype: torch.dtype) -> str:
    """A storage dtype as the JAX package's ledger keys name it
    ("float32", "bfloat16", "int8", "float8_e4m3fn")."""
    return str(dtype).removeprefix("torch.")


class MemoryLedger:
    """Event-driven byte accounting over the serving stores.

    ``attach(store)`` registers every tier of a ``TieredTableStore`` (or
    the one device tier of a ``TableStore``) under a ``(store_name, tier,
    dtype)`` key, starting each at its current allocation. From then on the
    stores report allocation deltas at every event site (``add``) and
    traffic events (``count``); tier totals are kept as they go and copied
    to ``mem.<tier>_bytes`` / ``mem.total_bytes`` gauges when a
    ``MetricsRegistry`` is attached. ``verify()`` returns the tiers whose
    event-accumulated bytes differ from what they hold now: empty means no
    event site was missed or mis-sized."""

    def __init__(self, metrics: Optional[MetricsRegistry] = None):
        self.metrics = metrics
        self._bytes: dict[tuple, int] = {}        # (store, tier, dtype) -> B
        self.events: dict[str, int] = {}          # event kind -> count
        self.moved_bytes: dict[str, int] = {}     # traffic kind -> bytes
        self._watch: list[tuple] = []             # (key, ground-truth fn)
        self._lock = threading.RLock()

    # ------------------------------------------------------------------
    # registration
    # ------------------------------------------------------------------
    def _register(self, sub, key: tuple, truth: Callable[[], int]) -> None:
        sub.ledger = self
        sub._ledger_key = key
        with self._lock:
            self._bytes[key] = int(truth())
            self._watch.append((key, truth))
            self._export()

    def attach(self, store, name: str = "bse"):
        """Register ``store`` (``TableStore`` or ``TieredTableStore``) and
        all its tiers; returns the store."""
        from repro_torch.serve.tiered_store import TieredTableStore

        dt = _dtype_key(store.dtype)
        if isinstance(store, TieredTableStore):
            store.ledger = self
            self._register(store.hot, (name, "hot", dt), store.hot._nbytes)
            self._register(store.warm, (name, "warm", dt), store.warm._nbytes)
            if store.cold is not None:
                self._register(store.cold, (name, "cold", dt), store.cold._nbytes)
        else:
            self._register(store, (name, "hot", dt), store._nbytes)
        return store

    # ------------------------------------------------------------------
    # event sinks (called by the stores)
    # ------------------------------------------------------------------
    def add(self, key: tuple, delta: int, kind: str) -> None:
        """An event at ``key`` changed its tier's allocation by ``delta``
        bytes (grow / spill / segment unlink / wholesale restore)."""
        with self._lock:
            self._bytes[key] = self._bytes.get(key, 0) + int(delta)
            self.events[kind] = self.events.get(kind, 0) + 1
            self._export()

    def set_total(self, key: tuple, nbytes: int, kind: str) -> None:
        """Wholesale replacement (restore paths): the tier now holds
        exactly ``nbytes``."""
        with self._lock:
            self._bytes[key] = int(nbytes)
            self.events[kind] = self.events.get(kind, 0) + 1
            self._export()

    def count(self, kind: str, n: int = 1, moved: int = 0) -> None:
        """A traffic event that changed no allocation: evictions,
        quantizing writes, promote / demote row movement (``moved`` bytes
        crossed a tier boundary)."""
        with self._lock:
            self.events[kind] = self.events.get(kind, 0) + int(n)
            if moved:
                self.moved_bytes[kind] = self.moved_bytes.get(kind, 0) + int(moved)

    # ------------------------------------------------------------------
    # readback
    # ------------------------------------------------------------------
    def tier_bytes(self, tier: str) -> int:
        with self._lock:
            return sum(v for (_, t, _), v in self._bytes.items() if t == tier)

    def total(self) -> int:
        with self._lock:
            return sum(self._bytes.values())

    def _export(self) -> None:
        if self.metrics is None:
            return
        for tier in ("hot", "warm", "cold"):
            self.metrics.gauge(f"mem.{tier}_bytes").set(self.tier_bytes(tier))
        self.metrics.gauge("mem.total_bytes").set(self.total())

    def verify(self) -> list[str]:
        """Conservation: event-accumulated bytes against what every
        registered tier holds now. An empty list means conserved."""
        problems = []
        with self._lock:
            for key, truth in self._watch:
                reported = int(truth())
                if self._bytes.get(key, 0) != reported:
                    problems.append(f"{'/'.join(map(str, key))}: ledger "
                                    f"{self._bytes.get(key, 0)} B != reported {reported} B")
        return problems

    def snapshot(self) -> dict:
        """The ``mem`` block of ``profile.json``."""
        with self._lock:
            return {
                "hot_bytes": self.tier_bytes("hot"),
                "warm_bytes": self.tier_bytes("warm"),
                "cold_bytes": self.tier_bytes("cold"),
                "total_bytes": self.total(),
                "events": dict(sorted(self.events.items())),
                "moved_bytes": dict(sorted(self.moved_bytes.items())),
                "by_key": {"/".join(map(str, k)): v
                           for k, v in sorted(self._bytes.items(), key=lambda kv: kv[0])},
            }

    def report(self) -> str:
        errs = self.verify()
        ok = "conservation OK" if not errs else f"CONSERVATION BROKEN: {errs}"
        return (f"mem ledger: hot {self.tier_bytes('hot')} B (device), "
                f"warm {self.tier_bytes('warm')} B (host), "
                f"cold {self.tier_bytes('cold')} B (disk) — {ok}")
