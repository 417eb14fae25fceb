"""Async streaming ingestion for BSE — the paper's §4.4 deployment story.

Counterpart of ``repro/serve/ingest.py``. Behavior-sequence encoding is
*latency-free* for the CTR server because hashing runs OFF the request
path:

    submit_*  ──►  bounded event queue  ──►  writer loop  ──►  table store
    (writers,       (host-side deque,        (drain_once:       (folds via
     non-block)      drops counted on         batched            BSEIngestor)
                     backpressure)            launches)               │
                                                                 commit ▼
    fetch_many / serve_candidates  ◄───────  CommittedView (version-stamped
    (readers, lock-free)                     snapshot of the hot state)

Design rules, each load-bearing:

  * **The queue never blocks and never lies.** ``submit_event`` /
    ``submit_history`` return ``False`` when the queue is full — the event
    is DROPPED and counted (``IngestStats.n_dropped``).
  * **Readers see the last committed version, always.** A fold mutates the
    live store, then publishes a fresh ``CommittedView`` (the hot tier's
    tensors and a frozen copy of its user→slot index) in one attribute
    store. JAX arrays are immutable; torch tensors are not, and the port's
    writes and ``sdim_update`` fold in place. So the runtime turns copy on
    write on (``store.donate_writes = False``): the first write after a
    commit (a fold, a tier move, an eviction) clones the hot tier's tensors
    and every later write until the next commit goes into that clone in
    place, so a tensor a view holds never changes (one clone per commit IS
    the double-buffer cost).
  * **Streams.** On CUDA every fold runs on the runtime's own stream (the
    writer thread's, and the caller's for a fold made inline): the kernel
    wrappers launch on the calling thread's current stream. A commit
    records an event on that stream after the fold; a reader's stream
    waits on the event of the view it reads (never on a fold in flight)
    and marks the view's tensors as read there (``record_stream``), so the
    caching allocator does not hand their memory to the next fold while
    the read runs. A fold made for a caller on another stream (``flush``,
    ``evict``, a forced drain) starts after that stream's work and makes
    it wait for the fold's end.
    A sharded store's blocks on the runtime's device fold on its stream,
    those on other cards on their current streams, where reads launched
    after the commit come after the fold in stream order; copy on write
    clones only the blocks of the shards a fold writes to.
  * **Staleness is bounded on the write path.** Per-user un-folded entries
    are counted (``staleness``); a submit that would push a user past
    ``max_staleness`` first folds queue batches inline on the SUBMITTING
    thread until the user is under the bound.
  * **Reads promote via the queue.** On a tiered store a read cannot
    promote warm/cold users inline (promotion writes the hot tier); a miss
    enqueues a *touch*, and the writer loop promotes in hot-capacity-sized
    chunks. The user misses (zero row) until the next commit.
  * **Errors are not swallowed.** A fold that raises puts the entries it
    did not fold back at the head of the queue and re-raises; a writer
    thread that dies keeps its exception (``error``), leaves its work
    queued (``health_snapshot`` then reports ``live: false``), and
    ``stop`` raises it.

Fold results are bit-identical to synchronous ingestion fed the same
batches: the writer loop calls the very same ``BSEIngestor`` methods with
the same batched arrays, and the event fold's per-slot sums run in batch
order (``serve/bse_server.py``).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.serve.quant import dequantize_rows
from repro_torch.serve.table_store import gather_rows
from repro_torch.serve.tiered_store import TieredTableStore, burst_cap, burst_chunks
from repro_torch.serve.tracing import NOOP_SPAN

_EVENT, _HISTORY, _TOUCH = 0, 1, 2
_KIND_NAMES = ("event", "history", "touch")


@dataclasses.dataclass
class IngestStats:
    """Observability surface of the ingestion runtime (what the launcher
    and ``chip_smoke.py`` print)."""

    n_enqueued: int = 0
    n_dropped: int = 0          # backpressure rejections (queue full)
    n_deduped: int = 0          # history/touch submits merged with a queued one
    n_forced_drains: int = 0    # submits that folded inline (staleness bound)
    n_folds: int = 0
    n_events_folded: int = 0
    n_histories_folded: int = 0
    n_touches_folded: int = 0
    queue_depth: int = 0        # as of the last submit/commit
    max_queue_depth: int = 0
    last_drain_batch: int = 0
    max_drain_batch: int = 0
    fold_time_s: float = 0.0
    # per-(user, commit) folded-entry counts — the backlog each user
    # actually experienced; bounded so a long run can't grow without limit
    staleness_samples: list = dataclasses.field(default_factory=list)

    _MAX_SAMPLES = 4096

    def note_depth(self, depth: int) -> None:
        self.queue_depth = depth
        self.max_queue_depth = max(self.max_queue_depth, depth)

    def note_staleness(self, k: int) -> None:
        s = self.staleness_samples
        s.append(int(k))
        if len(s) > self._MAX_SAMPLES:
            del s[:len(s) // 2]

    def staleness_p95(self) -> float:
        if not self.staleness_samples:
            return 0.0
        return float(np.percentile(self.staleness_samples, 95))

    def staleness_max(self) -> int:
        return max(self.staleness_samples, default=0)

    def as_dict(self) -> dict:
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self)
             if f.name != "staleness_samples"}
        d["staleness_p95"] = self.staleness_p95()
        d["staleness_max"] = self.staleness_max()
        return d


class CommittedView:
    """Immutable snapshot of the HOT serving state at one commit: the hot
    tier's tensors (never written again: copy on write; a sharded hot
    tier's per-shard blocks), a frozen copy of the user→slot index and, on
    CUDA, the event recorded after the fold it publishes. Same miss contract
    as the store's ``lookup``: unknown users get slot 0 (handle (0, 0) on a
    sharded store) and ``present=False``; ``rows`` of a sharded view gather
    from the held blocks onto the store's device."""

    __slots__ = ("version", "data", "scales", "quantized", "sharded", "device", "event",
                 "_index")

    def __init__(self, version: int, store: Any,
                 event: Optional["torch.cuda.Event"] = None):
        hot = store.hot if isinstance(store, TieredTableStore) else store
        self.version = version
        self.data, self.scales = hot.share()
        self.quantized = hot.quantized
        self.sharded = hot.sharded
        self.device = hot.device
        self.event = event
        self._index = dict(hot._slot_of)

    def __contains__(self, user: Any) -> bool:
        return user in self._index

    def __len__(self) -> int:
        return len(self._index)

    def lookup(self, users: Sequence[Any]) -> tuple[np.ndarray, np.ndarray]:
        present = np.asarray([u in self._index for u in users], bool)
        if self.sharded:
            slots = np.asarray([self._index.get(u, (0, 0)) for u in users],
                               np.int32).reshape(-1, 2)
        else:
            slots = np.asarray([self._index.get(u, 0) for u in users], np.int32)
        return slots, present

    def tensors(self):
        """(data, scales) for a read on the current stream: on CUDA the
        stream waits for this commit's event, and the caching allocator
        learns that the stream reads each tensor (every block of a sharded
        view)."""
        if self.event is not None:
            torch.cuda.current_stream(self.device).wait_event(self.event)
        held = [*self.data, *(self.scales or ())] if self.sharded else [self.data, self.scales]
        for t in held:
            if t is not None and t.device.type == "cuda":
                t.record_stream(torch.cuda.current_stream(t.device))
        return self.data, self.scales

    def rows(self, slots) -> torch.Tensor:
        data, scales = self.tensors()
        if self.sharded:
            payload, row_scales = gather_rows(data, scales, np.asarray(slots, np.int64)
                                              .reshape(-1, 2), self.device)
            return dequantize_rows(payload, row_scales) if self.quantized else payload
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=data.device)
        if self.quantized:
            return dequantize_rows(data[idx], scales[idx])
        return data[idx]

    def row(self, user: Any) -> Optional[torch.Tensor]:
        s = self._index.get(user)
        if s is None:
            return None
        return self.rows(np.asarray([s], np.int32))[0]


class AsyncIngestor:
    """The queue + writer-loop runtime between a ``BSEIngestor`` (write
    half) and a ``BSEFetcher`` (read half). See the module docstring for
    the contract. Built by ``BSEServer(async_ingest=True)``.

    Queue entries (drained strictly in order; every entry CARRIES its
    submitter's trace context + enqueue time as the final two fields, so
    the fold lands in the submitting request's trace — see
    serve/tracing.py):
      ``(_EVENT, user, item, cat, ctx, t_enq)`` — one behavior event;
      ``(_HISTORY, user, items, cats, mask, ctx, t_enq)`` — full
      re-encode; subsumes (removes + counts as deduped) everything still
      queued for the user, since the fold overwrites the whole row —
      latest history wins;
      ``(_TOUCH, user, ctx, t_enq)`` — tiered-store promotion request
      from a read miss (deduped the same way; carries no staleness).

    The writer loop (``start``/``stop``) is optional — tests and
    single-threaded callers drive ``drain_once``/``flush`` directly.
    ``error`` holds the exception a dead writer thread died of.
    """

    def __init__(self, ingestor: Any, store: Any, queue_depth: int = 1024,
                 max_staleness: int = 64, drain_batch: int = 256,
                 metrics: Any = None, tracer: Any = None):
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        if max_staleness < 1:
            raise ValueError(
                f"max_staleness must be >= 1, got {max_staleness}")
        if drain_batch < 1:
            raise ValueError(f"drain_batch must be >= 1, got {drain_batch}")
        self._ingestor = ingestor
        self._store = store
        self.queue_depth = queue_depth
        self.max_staleness = max_staleness
        self.drain_batch = drain_batch
        self.stats = IngestStats()
        self.metrics = metrics          # optional MetricsRegistry
        self.tracer = tracer            # optional Tracer
        # double-buffer safety: no device buffer a CommittedView may still
        # reference is ever written (the first write after a commit clones)
        store.donate_writes = False
        # writer-loop batching linger: fold only once ``drain_batch``
        # entries are queued OR the oldest entry is ``linger_s`` old.
        # 0.0 = fold as soon as anything is queued. Bigger lingers mean
        # fewer, larger folds — less launch overhead contending with the
        # serving path, at the cost of time-staleness (count-staleness is
        # still bounded by ``max_staleness`` on the submit path).
        self.linger_s = 0.0
        self._q: collections.deque = collections.deque()
        self._oldest: Optional[float] = None  # enqueue time of queue head
        self._qlock = threading.Lock()        # queue + pending bookkeeping
        self._fold_lock = threading.Lock()    # store mutation + commit
        self._pending: dict[Any, int] = {}    # un-folded entries per user
        self._hist_pending: set = set()
        self._touch_pending: set = set()
        self._wake = threading.Event()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None
        self._version = 0
        dev = store.hot.device if isinstance(store, TieredTableStore) else store.device
        # the stream every fold runs on (None on the CPU)
        self._stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self.committed = CommittedView(0, store, self._record())

    # ------------------------------------------------------------------
    # write side: non-blocking submits
    # ------------------------------------------------------------------
    def staleness(self, user: Any) -> int:
        """Entries of ``user`` enqueued but not yet folded — never exceeds
        ``max_staleness`` (the submit path folds inline first)."""
        return self._pending.get(user, 0)

    def _note_drop(self) -> None:
        """Backpressure rejection: counted in stats AND the metrics
        registry (call with the queue lock held)."""
        self.stats.n_dropped += 1
        if self.metrics is not None:
            self.metrics.counter("ingest.dropped").inc()

    def _trace_ctx(self):
        """(SpanContext, enqueue time) to ride the queue entry — the
        submitter's innermost open span, so the eventual fold appears in
        the submitting request's trace. (None, 0.0) when not tracing."""
        tr = self.tracer
        if tr is None or not tr.enabled:
            return None, 0.0
        ctx = tr.current()
        if ctx is None:
            return None, 0.0
        return ctx, tr.clock()

    def _bound_staleness(self, user: Any) -> None:
        if self._pending.get(user, 0) < self.max_staleness:
            return
        self.stats.n_forced_drains += 1
        tr = self.tracer
        sp = NOOP_SPAN
        if tr is not None and tr.enabled:
            # the submit folded inline — anomalous enough to always keep
            tr.flag("forced_drain")
            sp = tr.span("ingest.forced_drain", user=str(user))
        with sp:
            while self._pending.get(user, 0) >= self.max_staleness:
                if self.drain_once() == 0:  # pragma: no cover — safety net
                    break

    def submit_event(self, user: Any, item: int, cat: int) -> bool:
        """Enqueue one behavior event. ``False`` = queue full, event
        dropped (counted in ``stats.n_dropped``) — never blocks a reader,
        never raises."""
        self._bound_staleness(user)
        ctx, t_enq = self._trace_ctx()
        with self._qlock:
            if len(self._q) >= self.queue_depth:
                self._note_drop()
                accepted = False
            else:
                self._q.append((_EVENT, user, int(item), int(cat),
                                ctx, t_enq))
                if self._oldest is None:
                    self._oldest = time.perf_counter()
                self._pending[user] = self._pending.get(user, 0) + 1
                self.stats.n_enqueued += 1
                self.stats.note_depth(len(self._q))
                accepted = True
        self._wake.set()
        return accepted

    def submit_history(self, user: Any, items, cats, mask=None) -> bool:
        """Enqueue a full history re-encode. The fold is a wholesale
        overwrite, so it SUBSUMES everything still queued for this user —
        earlier histories, events, touches — which are removed and counted
        in ``stats.n_deduped``; synchronous ingestion would have clobbered
        them the same way. Latest history wins, matching sync order."""
        self._bound_staleness(user)
        ctx, t_enq = self._trace_ctx()
        with self._qlock:
            if user in self._hist_pending or user in self._touch_pending \
                    or self._pending.get(user, 0):
                kept = [e for e in self._q if e[1] != user]
                removed = len(self._q) - len(kept)
                if removed:
                    self._q = collections.deque(kept)
                    self.stats.n_deduped += removed
                self._hist_pending.discard(user)
                self._touch_pending.discard(user)
                # in-flight fold may still hold popped entries of this user;
                # keep their pending count so staleness stays honest
                left = self._pending.get(user, 0) - removed
                if left > 0:
                    self._pending[user] = left
                else:
                    self._pending.pop(user, None)
            if len(self._q) >= self.queue_depth:
                self._note_drop()
                return False
            self._q.append((_HISTORY, user, np.asarray(items),
                            np.asarray(cats),
                            None if mask is None else np.asarray(mask),
                            ctx, t_enq))
            if self._oldest is None:
                self._oldest = time.perf_counter()
            self._hist_pending.add(user)
            self._pending[user] = self._pending.get(user, 0) + 1
            self.stats.n_enqueued += 1
            self.stats.note_depth(len(self._q))
        self._wake.set()
        return True

    def submit_touch(self, user: Any) -> bool:
        """Promotion request from a read miss (tiered stores): the writer
        loop pulls the user hot off the request path. Deduped per user; no
        staleness accounting (nothing new to fold)."""
        ctx, t_enq = self._trace_ctx()
        with self._qlock:
            if user in self._touch_pending:
                return True
            if len(self._q) >= self.queue_depth:
                self._note_drop()
                return False
            self._q.append((_TOUCH, user, ctx, t_enq))
            if self._oldest is None:
                self._oldest = time.perf_counter()
            self._touch_pending.add(user)
            self.stats.n_enqueued += 1
            self.stats.note_depth(len(self._q))
        self._wake.set()
        return True

    def submit_events(self, users: Sequence[Any], items, cats,
                      mask=None) -> int:
        """Batched ``submit_event``: per-user event blocks (B,) or (B, E),
        exploded into single-event entries (the drain re-batches them into
        one launch). Returns the accepted count; the remainder was
        dropped on backpressure (counted)."""
        items = np.asarray(items)
        cats = np.asarray(cats)
        mask = None if mask is None else np.asarray(mask)
        if items.ndim == 1:
            items, cats = items[:, None], cats[:, None]
            mask = None if mask is None else mask[:, None]
        accepted = 0
        for b, user in enumerate(users):
            for e in range(items.shape[1]):
                if mask is not None and not mask[b, e] > 0:
                    continue
                accepted += self.submit_event(user, items[b, e], cats[b, e])
        return accepted

    def submit_histories(self, users: Sequence[Any], items, cats,
                         masks=None) -> int:
        """Batched ``submit_history``; returns the accepted count."""
        items = np.asarray(items)
        cats = np.asarray(cats)
        accepted = 0
        for b, user in enumerate(users):
            accepted += self.submit_history(
                user, items[b], cats[b],
                None if masks is None else np.asarray(masks)[b])
        return accepted

    # ------------------------------------------------------------------
    # writer side: drain / fold / commit
    # ------------------------------------------------------------------
    def drain_once(self) -> int:
        """Pop ≤ ``drain_batch`` entries (queue order), fold them through
        the ingestor in maximal batched launches, then commit a new
        ``CommittedView``. Returns the number of entries folded (0 = queue
        empty). Serialized by the fold lock — safe from any thread."""
        with self._fold_lock:
            with self._qlock:
                n = min(self.drain_batch, len(self._q))
                batch = [self._q.popleft() for _ in range(n)]
                self._oldest = None if not self._q else time.perf_counter()
            if not batch:
                return 0
            tr = self.tracer
            if tr is not None and not tr.enabled:
                tr = None
            t_drain = tr.clock() if tr is not None else 0.0
            t0 = time.perf_counter()
            with self._on_stream():
                done = 0
                try:
                    for kind, group in _segment(batch):
                        if kind == _EVENT:
                            self._ingestor.ingest_events(
                                [e[1] for e in group],
                                np.asarray([e[2] for e in group]),
                                np.asarray([e[3] for e in group]))
                            self.stats.n_events_folded += len(group)
                        elif kind == _HISTORY:
                            self._ingestor.ingest_histories(
                                [e[1] for e in group],
                                np.stack([e[2] for e in group]),
                                np.stack([e[3] for e in group]),
                                _stack_masks(group))
                            self.stats.n_histories_folded += len(group)
                        else:
                            self._fold_touches([e[1] for e in group])
                        done += len(group)
                except BaseException:
                    # what did not fold goes back to the head of the queue,
                    # still counted; what did is committed; the error stays
                    with self._qlock:
                        self._q.extendleft(reversed(batch[done:]))
                        self._oldest = time.perf_counter()
                    self._commit(batch[:done])
                    raise
                self._commit(batch)
            dt = time.perf_counter() - t0
            self.stats.fold_time_s += dt
            self.stats.n_folds += 1
            self.stats.last_drain_batch = n
            self.stats.max_drain_batch = max(self.stats.max_drain_batch, n)
            if self.metrics is not None:
                self.metrics.histogram("ingest.fold_ms").observe(1e3 * dt)
                self.metrics.counter("ingest.folded").inc(n)
            if tr is not None:
                # land the async half in each submitter's trace: the
                # time-in-queue span and the fold that committed it —
                # submit → queue → fold → commit-version as one causally
                # linked trace across the thread boundary
                t_done = tr.clock()
                version = self._version
                for e in batch:
                    ctx = e[-2]
                    if ctx is None:
                        continue
                    tr.add_span(ctx, "ingest.queued", e[-1], t_drain,
                                user=str(e[1]), kind=_KIND_NAMES[e[0]])
                    tr.add_span(ctx, "ingest.fold", t_drain, t_done,
                                user=str(e[1]), kind=_KIND_NAMES[e[0]],
                                commit_version=version)
            return n

    def _fold_touches(self, users: Sequence[Any]) -> None:
        self.stats.n_touches_folded += len(users)
        cap = burst_cap(self._store)
        known = [u for u in users if u in self._store]
        if cap is None or not known:
            return                  # nothing to promote on unbounded stores
        # lookup() runs the tiered residency engine: warm/cold users are
        # batch-promoted into the hot tier, in hot-capacity-sized chunks
        for lo, hi in burst_chunks(known, cap):
            self._store.lookup(known[lo:hi])

    def _commit(self, batch: Sequence[tuple]) -> None:
        with self._qlock:
            folded: dict[Any, int] = {}
            for e in batch:
                if e[0] == _TOUCH:
                    self._touch_pending.discard(e[1])
                    continue
                if e[0] == _HISTORY:
                    self._hist_pending.discard(e[1])
                folded[e[1]] = folded.get(e[1], 0) + 1
            for u, k in folded.items():
                left = self._pending.get(u, 0) - k
                if left > 0:
                    self._pending[u] = left
                else:
                    self._pending.pop(u, None)
                self.stats.note_staleness(k)
            self._version += 1
            # single attribute store = the atomic publish; readers holding
            # the previous view keep gathering from its tensors, which copy
            # on write leaves untouched
            self.committed = CommittedView(self._version, self._store, self._record())
            self.stats.queue_depth = len(self._q)
            if self.metrics is not None:
                self.metrics.gauge("ingest.queue_depth").set(len(self._q))

    def _record(self) -> Optional["torch.cuda.Event"]:
        """An event on the current CUDA stream (the fold's), or None on the
        CPU."""
        if self._stream is None:
            return None
        return torch.cuda.current_stream(self._stream.device).record_event()

    @contextlib.contextmanager
    def _on_stream(self):
        """Run store mutations on the runtime's stream. A caller on another
        stream (``flush``, ``evict``, a forced drain on a submitting thread)
        has the fold start after its stream's work and its stream wait for
        the fold's end, since it may read the live store next."""
        ws = self._stream
        if ws is None or torch.cuda.current_stream(ws.device) == ws:
            yield
            return
        caller = torch.cuda.current_stream(ws.device)
        ws.wait_stream(caller)
        with torch.cuda.stream(ws):
            yield
        caller.wait_stream(ws)

    def flush(self) -> None:
        """Drain until empty — quiesce before snapshot/shutdown/asserts."""
        while self.drain_once():
            pass

    # ------------------------------------------------------------------
    # maintenance ops that must serialize with folds
    # ------------------------------------------------------------------
    def evict(self, user: Any) -> bool:
        """Evict under the fold lock and commit, so no fold interleaves
        with the index surgery and readers flip atomically to the
        post-eviction version. Entries still queued for the user fold
        later into a fresh table (same as sync evict-then-ingest)."""
        with self._fold_lock, self._on_stream():
            ok = self._store.evict(user)
            self._commit([])
        return ok

    def refresh(self, params: Any) -> None:
        """Model push: queued behaviors were embedded under the OLD params
        and are dropped with the store contents; a fresh empty version is
        committed so readers never mix embeddings across pushes."""
        with self._fold_lock, self._on_stream():
            with self._qlock:
                self._q.clear()
                self._pending.clear()
                self._hist_pending.clear()
                self._touch_pending.clear()
            self._ingestor.params = params
            self._store.clear()
            self._commit([])

    # ------------------------------------------------------------------
    # writer loop
    # ------------------------------------------------------------------
    def start(self) -> None:
        """Run the writer loop on a daemon thread (idempotent). The kernel
        library is built first, on this thread, so the writer's first fold
        does not start a build (``kernels/_build.load``)."""
        if self._thread is not None:
            return
        if self._stream is not None:
            from repro_torch.kernels import _build
            _build.load()
        self._stop = False
        self.error = None
        self._thread = threading.Thread(target=self._run,
                                        name="bse-ingest-writer", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        ctx = contextlib.ExitStack()
        if self._stream is not None:
            ctx.enter_context(torch.cuda.device(self._stream.device))
            ctx.enter_context(torch.cuda.stream(self._stream))
        try:
            with ctx:
                while not self._stop:
                    with self._qlock:
                        n = len(self._q)
                        ripe = n >= self.drain_batch or (
                            n > 0 and self._oldest is not None
                            and time.perf_counter() - self._oldest >= self.linger_s)
                    if ripe and self.drain_once():
                        continue
                    self._wake.wait(0.005 if n else 0.02)
                    self._wake.clear()
        except BaseException as e:
            self.error = e          # kept for stop() and the health probe
            raise

    def stop(self, flush: bool = True, timeout: Optional[float] = None
             ) -> bool:
        """Join the writer loop; by default drain whatever is left so no
        accepted entry is lost on shutdown. Shutdown ordering contract
        (drain-or-count, never hang, never lose silently):

          * signal the loop FIRST, then join — a writer mid-fold finishes
            its current batch and exits;
          * ``timeout`` bounds the join. A writer stuck in a fold (e.g. a
            stalled embed) leaves ``stop`` returning ``False`` with every
            unfolded entry still queued AND counted in
            ``stats.queue_depth`` — nothing is silently lost, and the
            (daemon) thread drains the backlog if it ever unsticks;
          * ``flush=True`` then drains the remainder inline — bounded by
            the same ``timeout`` on the fold lock, so a stuck fold can
            never turn shutdown into a hang;
          * ``flush=False`` keeps the queue as-is: entries remain counted
            (``stats.queue_depth``/``n_enqueued`` vs ``n_*_folded``);
          * a writer that died of an exception is not quietly restarted or
            drained around: ``stop`` raises that exception (its unfolded
            entries stay queued and counted).

        Returns ``True`` iff the runtime fully quiesced."""
        t, self._thread = self._thread, None
        if t is not None:
            self._stop = True
            self._wake.set()
            t.join(timeout)
            if t.is_alive():
                # stuck mid-fold: leave the daemon to it; report honestly
                with self._qlock:
                    self.stats.note_depth(len(self._q))
                return False
            if self.error is not None:
                with self._qlock:
                    self.stats.note_depth(len(self._q))
                raise RuntimeError("the ingest writer thread died") from self.error
        if flush:
            if timeout is not None:
                if not self._fold_lock.acquire(timeout=timeout):
                    with self._qlock:
                        self.stats.note_depth(len(self._q))
                    return False
                self._fold_lock.release()
            self.flush()
        with self._qlock:
            return len(self._q) == 0


def _segment(batch: Sequence[tuple]) -> list[tuple[int, list]]:
    """Queue order -> maximal foldable groups: consecutive same-kind runs,
    with history runs further split so each group has distinct users and
    one history length (the ``ingest_histories`` contract: one encode
    launch per group). Order within and across groups is preserved, so
    fold results match submitting the same entries synchronously."""
    out: list[tuple[int, list]] = []
    cur_kind: Optional[int] = None
    cur: list = []

    def flush():
        nonlocal cur
        if cur:
            out.append((cur_kind, cur))
            cur = []

    for e in batch:
        if e[0] != cur_kind:
            flush()
            cur_kind = e[0]
        elif cur_kind == _HISTORY and cur and (
                e[1] in {g[1] for g in cur}
                or e[2].shape != cur[0][2].shape):
            flush()
        cur.append(e)
    flush()
    return out


def _stack_masks(group: Sequence[tuple]):
    """(B,) of per-history masks (some None) -> stacked (B, L) or None.
    Histories without a mask get all-ones (mask semantics: >0 = real)."""
    masks = [e[4] for e in group]
    if all(m is None for m in masks):
        return None
    return np.stack([np.ones(e[2].shape, np.float32) if m is None
                     else np.asarray(m, np.float32)
                     for e, m in zip(group, masks)])
