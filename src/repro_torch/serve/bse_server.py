"""BSE server (paper §4.4): user-wise behavior-sequence hashing, decoupled
from the CTR server.

Counterpart of ``repro/serve/bse_server.py``. Per-user bucket tables (the
L-free (G, U, d) serving state) live in a ``TableStore``, a
``ShardedTableStore`` over the model axis of ``mesh`` (``serve/
table_store.py``) or, given any of ``hot_capacity``/``store_dir``/
``policy``/``warm_capacity``, a ``TieredTableStore`` (device-hot /
host-warm / disk-cold, ``serve/tiered_store.py``, its hot tier sharded
when ``mesh`` is given too) whose ``snapshot``/``restore`` round-trip the
full serving state. The server is split along the paper's own seam into
two halves that share only the store and the stats:

  * ``BSEIngestor`` — the write path: embeds behaviors with the current
    params and folds them into the store. ``ingest_histories`` encodes a
    burst of histories in one ``bse_encode`` launch; ``ingest_events``
    folds a burst of events into an fp32 store in one ``sdim_update``
    launch (duplicate users accumulate in batch order; a sharded store
    launches once per shard, ``SDIMEngine.update_sharded``); bf16/int8/fp8
    stores encode the events (``bse_encode``), sum them per slot in batch
    order (``slot_sums``: no atomics, the same bits every run) and
    read-modify-write the touched rows. Bursts wider than a tiered store's
    hot tier are chunked (``burst_chunks``).
  * ``BSEFetcher`` — the read path: ``fetch``/``fetch_many`` (a gather in
    the wire dtype, default bf16, the paper's 8 KB figure, with exact byte
    accounting; ``sdim_query`` then runs on the CTR side) and
    ``serve_candidates`` (one ``sdim_fused_serve`` launch straight off the
    store, one per shard off a sharded store). With an ``AsyncIngestor``
    attached (``serve/ingest.py``), reads resolve against the last
    COMMITTED version of the hot state and never observe a fold in flight;
    their misses enqueue promotion touches.

``async_ingest=True`` inserts the queue + writer-loop runtime between the
halves; ``ingest_*`` then enqueue and return the accepted count. A user no
tier (or, async, no committed version) holds reads as an all-zero row or
zero interest and counts as a miss. ``metrics`` and ``tracer`` record the
read path (``bse.fetch_many`` / ``bse.serve_candidates`` spans and
``*_ms`` histograms) and the tier movement below it.

``refresh_params`` models the model push: the behavior embedding changed,
so the whole store is invalidated and re-encoded lazily. ``embed_fn(params,
items, cats)`` reads the embedding weights from ``params`` (``CTRServer.
build`` passes the model itself).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.engine import SDIMEngine
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serve.admission import CircuitBreaker
from repro_torch.serve.metrics import MetricsRegistry, observe_ms
from repro_torch.serve.table_store import ShardedTableStore, TableStore
from repro_torch.serve.tiered_store import (TieredTableStore, _atomic_json, _atomic_npz,
                                            burst_cap, burst_chunks, is_tiered)
from repro_torch.serve.tracing import NOOP_SPAN, Tracer


@dataclasses.dataclass
class BSEStats:
    n_encodes: int = 0
    n_updates: int = 0
    n_fetches: int = 0
    n_misses: int = 0          # fetches of users the store does not hold
    bytes_transmitted: int = 0
    encode_time_s: float = 0.0


def sync_stream(t: torch.Tensor) -> None:
    """Wait for the current stream's work on ``t``'s device (where the JAX
    package blocks until an array is ready)."""
    if t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()


def slot_sums(deltas: torch.Tensor, inv: np.ndarray, n: int) -> torch.Tensor:
    """Per-slot sums of the batch rows ``deltas`` (B, …), ``inv`` (B,)
    naming each row's slot in [0, n). Each slot's rows are added in batch
    order, one rank at a time (the k-th row of every slot together), so no
    two adds hit one row at once: no atomics, the same bits on every run,
    and the order of ``jax.ops.segment_sum`` on the host."""
    inv = np.asarray(inv, np.int64).ravel()
    out = torch.zeros((n, *deltas.shape[1:]), dtype=deltas.dtype, device=deltas.device)
    if not inv.size:
        return out
    order = np.argsort(inv, kind="stable")
    rank = np.empty_like(inv)
    rank[order] = np.arange(inv.size) - np.searchsorted(inv[order], inv[order])
    for k in range(int(rank.max()) + 1):
        sel = np.nonzero(rank == k)[0]
        dst = torch.as_tensor(inv[sel], device=deltas.device)
        out[dst] = out[dst] + deltas[torch.as_tensor(sel, device=deltas.device)]
    return out


class _TablesView:
    """Read-only dict-like view over the store, keyed by user."""

    def __init__(self, store: Any):
        self._store = store

    def __getitem__(self, user: Any) -> torch.Tensor:
        row = self._store.row(user)
        if row is None:
            raise KeyError(user)
        return row

    def __contains__(self, user: Any) -> bool:
        return user in self._store

    def __len__(self) -> int:
        return len(self._store)

    def __iter__(self):
        return self._store.users()

    def values(self):
        return (self[u] for u in self._store.users())


class BSEIngestor:
    """Write half: embed behaviors, fold them into the shared table store.
    Owns the params snapshot (embeddings change on model push). The fp32
    event fold runs ``sdim_update`` in place on ``store.writable()``: under
    the async runtime's copy on write that is a clone once a committed view
    holds the store's data, so the view keeps its bits."""

    def __init__(self, embed_fn: Callable, params: Any, engine: SDIMEngine,
                 R: torch.Tensor, store: Any, stats: BSEStats,
                 metrics: Optional[MetricsRegistry] = None):
        self.embed_fn = embed_fn
        self.params = params
        self.engine = engine
        self.R = R
        self.store = store
        self.stats = stats
        self.metrics = metrics

    def _mask(self, mask) -> Optional[torch.Tensor]:
        if mask is None:
            return None
        return torch.as_tensor(np.asarray(mask, np.float32), device=self.store.device)

    @torch.no_grad()
    def ingest_histories(self, users: Sequence[Any], items: np.ndarray,
                         cats: np.ndarray, masks: Optional[np.ndarray] = None) -> None:
        """Batched full (re-)encode: B distinct users' histories (B, L) in
        ONE ``bse_encode`` launch, written into their slots. A burst wider
        than a tiered store's hot tier is split into hot-capacity chunks."""
        assert len(set(users)) == len(users), "duplicate users in one encode"
        cap = burst_cap(self.store)
        if cap is not None and len(users) > cap:
            items, cats = np.asarray(items), np.asarray(cats)
            for lo, hi in burst_chunks(list(users), cap):
                self.ingest_histories(users[lo:hi], items[lo:hi], cats[lo:hi],
                                      None if masks is None else np.asarray(masks)[lo:hi])
            return
        t0 = time.perf_counter()
        seq_e = self.embed_fn(self.params, np.asarray(items), np.asarray(cats))
        tables = self.engine.encode(seq_e, self._mask(masks), R=self.R)
        sync_stream(tables)
        dt = time.perf_counter() - t0
        self.stats.encode_time_s += dt
        self.stats.n_encodes += len(users)
        observe_ms(self.metrics, "bse.ingest_encode_ms", dt)
        # assign_fresh: every row is overwritten, so a tiered store drops
        # stale warm/cold copies instead of promoting them
        self.store.write(self.store.assign_fresh(users), tables)

    @torch.no_grad()
    def ingest_events(self, users: Sequence[Any], items: np.ndarray,
                      cats: np.ndarray, mask: Optional[np.ndarray] = None) -> None:
        """Batched real-time events: one event block per user — items/cats
        (B,) or (B, E) — folded into the store. Users may repeat (duplicate
        slots accumulate in batch order); unseen users start from a zero
        table. An fp32 store takes ONE ``sdim_update`` launch. bf16, int8
        and fp8 stores cannot take an in-place add of raw payload, so their
        events are encoded (``bse_encode``), summed per slot
        (``slot_sums``), and the touched rows read, added to and written
        back (requantized / saturating cast)."""
        items, cats = np.asarray(items), np.asarray(cats)
        mask = None if mask is None else np.asarray(mask)
        if items.ndim == 1:
            items, cats = items[:, None], cats[:, None]
            mask = None if mask is None else mask[:, None]
        if mask is not None:
            assert mask.shape == items.shape, (mask.shape, items.shape)
        cap = burst_cap(self.store)
        if cap is not None and len(set(users)) > cap:
            for lo, hi in burst_chunks(list(users), cap):
                self.ingest_events(users[lo:hi], items[lo:hi], cats[lo:hi],
                                   None if mask is None else mask[lo:hi])
            return
        ev_e = self.embed_fn(self.params, items, cats)             # (B, E, d)
        m = self._mask(mask)
        slots = self.store.assign(users)
        if self.store.dtype != torch.float32:
            deltas = self.engine.encode(ev_e, m, R=self.R)          # (B, G, U, d)
            uniq, inv = np.unique(slots, axis=0 if self.store.sharded else None,
                                  return_inverse=True)
            self.store.write(uniq, self.store.rows(uniq) + slot_sums(deltas, inv, len(uniq)))
        elif self.store.sharded:
            # copy on write clones only the shards whose rows the fold writes
            blocks, _ = self.store.writable(self.store.shards_of(slots))
            self.engine.update_sharded(blocks, slots, ev_e, m, R=self.R,
                                       mesh=self.store.mesh_ctx)
        else:
            self.engine.update(self.store.writable()[0], slots, ev_e, m, R=self.R)
        self.stats.n_updates += int(items.size if mask is None else np.sum(mask > 0))


class BSEFetcher:
    """Read half: gather / fused-score against the table store, cast to the
    wire dtype, account the bytes of what crosses. With an
    ``AsyncIngestor`` attached, every read resolves against its last
    committed view, and misses enqueue promotion touches."""

    def __init__(self, engine: SDIMEngine, R: torch.Tensor, store: Any,
                 wire_dtype: torch.dtype, stats: BSEStats,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        self.engine = engine
        self.R = R
        self.store = store
        self.wire_dtype = wire_dtype
        self.stats = stats
        self.metrics = metrics
        self.tracer = tracer
        self._async = None      # AsyncIngestor once attached

    def attach(self, runtime) -> None:
        self._async = runtime

    def _view(self):
        """Committed view to read from, or None for the live store."""
        return None if self._async is None else self._async.committed

    def _touch_misses(self, users: Sequence[Any], present) -> None:
        if self._async is not None:
            for u, p in zip(users, present):
                if not p:
                    self._async.submit_touch(u)

    def _span(self, name: str, n: int):
        tr = self.tracer
        return tr.span(name, n=n) if tr is not None and tr.enabled else NOOP_SPAN

    def _account(self, wire: torch.Tensor, n_users: int, misses: int) -> None:
        self.stats.n_fetches += n_users
        self.stats.n_misses += misses
        self.stats.bytes_transmitted += wire.numel() * wire.element_size()

    def _observe(self, name: str, t0: float, n_users: int, misses: int) -> None:
        if self.metrics is not None:
            observe_ms(self.metrics, name, time.perf_counter() - t0)
            self.metrics.counter("bse.fetches").inc(n_users)
            self.metrics.counter("bse.misses").inc(misses)

    @torch.no_grad()
    def fetch(self, user: Any) -> Optional[torch.Tensor]:
        """One user's table in the wire dtype; unknown user -> ``None``
        (counted in ``stats.n_misses``). On a tiered store it promotes like
        ``fetch_many``; async, a user not in the committed view misses and
        is queued for promotion."""
        view = self._view()
        if view is not None:
            table = view.row(user)
            if table is None:
                self.stats.n_misses += 1
                self._async.submit_touch(user)
                return None
        else:
            if user not in self.store:
                self.stats.n_misses += 1
                return None
            table = self.store.rows(self.store.slots([user]))[0]
        wire = table.to(self.wire_dtype)
        self._account(wire, 1, 0)
        return wire

    @torch.no_grad()
    def fetch_many(self, users: Sequence[Any]) -> torch.Tensor:
        """ONE gather -> (B, G, U, d) in the wire dtype. A user the store
        does not hold gets an ALL-ZERO row and counts as a miss. On a tiered
        store warm/cold users are batch-promoted, the burst chunked to the
        hot capacity."""
        with self._span("bse.fetch_many", len(users)) as sp:
            t0 = time.perf_counter()
            view = self._view()
            if view is not None:
                slots, present = view.lookup(users)
                rows = view.rows(slots)
                self._touch_misses(users, present)
            else:
                cap = burst_cap(self.store)
                if cap is not None:
                    chunks = burst_chunks(list(users), cap)
                    if len(chunks) > 1:
                        return torch.cat([self.fetch_many(users[lo:hi])
                                          for lo, hi in chunks])
                slots, present = self.store.lookup(users)
                rows = self.store.rows(slots)
            misses = len(users) - int(present.sum())
            if misses:
                rows = rows * torch.as_tensor(present, dtype=rows.dtype,
                                              device=rows.device)[:, None, None, None]
            wire = rows.to(self.wire_dtype)
            self._account(wire, len(users), misses)
            sp.set(misses=misses)
            self._observe("bse.fetch_many_ms", t0, len(users), misses)
            return wire

    @torch.no_grad()
    def serve_candidates(self, users: Sequence[Any], q: torch.Tensor,
                         R: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Fused serving: score candidates ``q`` (B, C, d) for ``users`` in
        ONE ``sdim_fused_serve`` launch straight off the store (int8/fp8
        rows dequantized in the kernel); returns interest (B, C, d) in the
        wire dtype. Unknown users get zero interest; the miss contract,
        chunking and committed-view reads are ``fetch_many``'s."""
        with self._span("bse.serve_candidates", len(users)) as sp:
            t0 = time.perf_counter()
            view = self._view()
            if view is not None:
                slots, present = view.lookup(users)
                data, scales = view.tensors()
                self._touch_misses(users, present)
            else:
                cap = burst_cap(self.store)
                if cap is not None:
                    chunks = burst_chunks(list(users), cap)
                    if len(chunks) > 1:
                        return torch.cat([self.serve_candidates(users[lo:hi], q[lo:hi], R=R)
                                          for lo, hi in chunks])
                slots, present = self.store.lookup(users)
                data, scales = self.store.data, self.store.scales
            if self.store.sharded:
                out = self.engine.serve_fused_sharded(
                    data, slots, q, present=present, scales=scales,
                    R=self.R if R is None else R, mesh=self.store.mesh_ctx)
            else:
                out = self.engine.serve_fused(data, slots, q, present=present, scales=scales,
                                              R=self.R if R is None else R)
            wire = out.to(self.wire_dtype)
            misses = len(users) - int(present.sum())
            self._account(wire, len(users), misses)
            sp.set(misses=misses)
            self._observe("bse.serve_candidates_ms", t0, len(users), misses)
            return wire


class BSEServer:
    def __init__(self, embed_fn: Callable, params: Any, engine: SDIMEngine,
                 R: Optional[torch.Tensor] = None,
                 wire_dtype: torch.dtype = torch.bfloat16, capacity: int = 64,
                 mesh: Any = None, hot_capacity: Optional[int] = None,
                 store_dir: Optional[str] = None,
                 policy: Optional[str] = None, warm_capacity: Optional[int] = None,
                 store: Any = None, table_dtype: Any = torch.float32,
                 async_ingest: bool = False, queue_depth: int = 1024,
                 max_staleness: int = 64, drain_batch: int = 256,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 cold_deadline_s: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None,
                 device: DeviceLike = "cuda"):
        """``table_dtype`` is the STORAGE dtype of the bucket tables (fp32 |
        bf16 | int8 | fp8, see serve/quant.py); ``wire_dtype`` the dtype of
        what ``fetch``/``fetch_many``/``serve_candidates`` hand the CTR
        server.

        ``mesh`` (a ``MeshCtx`` or a list of devices, which may repeat)
        shards the table store over its model axis (``ShardedTableStore``):
        capacity scales with the shards, reads assemble on ``device``, event
        folds go through ``SDIMEngine.update_sharded`` and fused reads
        through ``serve_fused_sharded``. ``None`` keeps one ``TableStore``.

        Any of ``hot_capacity`` (device-tier user bound), ``store_dir``
        (cold-tier segment directory), ``policy`` (``"clock"``/``"lru"``)
        or ``warm_capacity`` selects the ``TieredTableStore``. An explicit
        ``store`` (e.g. from ``TieredTableStore.restore``) overrides them.
        With ``mesh`` the tiered store's hot tier is sharded.

        ``async_ingest=True`` decouples the write path: ``ingest_*`` enqueue
        onto a bounded queue (depth ``queue_depth``, drops counted) drained
        by a writer loop in batches of ≤ ``drain_batch``; reads serve the
        last committed version; a user's un-folded backlog is bounded by
        ``max_staleness``.

        ``metrics`` is the shared ``MetricsRegistry`` (one is created when
        not given); ``tracer`` adds spans on the read path, the tier
        movement and the async fold. ``cold_deadline_s`` arms the tiered
        store's cold-tier circuit breaker; ``clock`` injects a virtual
        clock for deterministic fault tests."""
        self.engine = engine
        self.R = engine.R if R is None else R
        self.wire_dtype = wire_dtype
        self.metrics = MetricsRegistry() if metrics is None else metrics
        self.tracer = tracer
        cfg = engine.cfg
        tiered = is_tiered(hot_capacity, store_dir, policy, warm_capacity)
        if cold_deadline_s is not None and not tiered and store is None:
            raise ValueError(
                "cold_deadline_s arms the cold-tier circuit breaker, which "
                "needs the tiered store (pass hot_capacity=/store_dir=/"
                "policy=/warm_capacity=)")
        if store is not None:
            assert tuple(store.row_shape) == (cfg.n_groups, cfg.n_buckets, cfg.d), \
                (store.row_shape, cfg)
            self.store = store
            # an injected store joins this server's observability/runtime
            if isinstance(store, TieredTableStore):
                store.metrics = self.metrics
                store.tracer = tracer
                if clock is not None:
                    store._clock = clock
                if cold_deadline_s is not None and store.breaker is None:
                    store.breaker = CircuitBreaker(deadline_s=cold_deadline_s,
                                                   clock=store._clock)
        elif tiered:
            self.store = TieredTableStore(
                cfg.n_groups, cfg.n_buckets, cfg.d,
                hot_capacity=capacity if hot_capacity is None else hot_capacity,
                mesh=mesh, policy=policy or "clock", store_dir=store_dir,
                warm_capacity=warm_capacity, dtype=table_dtype,
                cold_deadline_s=cold_deadline_s, clock=clock,
                metrics=self.metrics, tracer=tracer, device=resolve_device(device))
        elif mesh is None:
            self.store = TableStore(cfg.n_groups, cfg.n_buckets, cfg.d, capacity=capacity,
                                    dtype=table_dtype, device=device)
        else:
            self.store = ShardedTableStore(cfg.n_groups, cfg.n_buckets, cfg.d, mesh,
                                           capacity=capacity, dtype=table_dtype,
                                           device=device)
        self.tables = _TablesView(self.store)
        self.stats = BSEStats()
        self.ingestor = BSEIngestor(embed_fn, params, engine, self.R, self.store,
                                    self.stats, metrics=self.metrics)
        self.fetcher = BSEFetcher(engine, self.R, self.store, wire_dtype, self.stats,
                                  metrics=self.metrics, tracer=tracer)
        self.async_ingest = None
        if async_ingest:
            from repro_torch.serve.ingest import AsyncIngestor
            self.async_ingest = AsyncIngestor(
                self.ingestor, self.store, queue_depth=queue_depth,
                max_staleness=max_staleness, drain_batch=drain_batch,
                metrics=self.metrics, tracer=tracer)
            self.fetcher.attach(self.async_ingest)

    # the params/embed snapshot lives on the write half
    @property
    def params(self) -> Any:
        return self.ingestor.params

    @params.setter
    def params(self, value: Any) -> None:
        self.ingestor.params = value

    @property
    def embed_fn(self) -> Callable:
        return self.ingestor.embed_fn

    @embed_fn.setter
    def embed_fn(self, value: Callable) -> None:
        self.ingestor.embed_fn = value

    def refresh_params(self, params: Any) -> None:
        """Model push: new embeddings invalidate the whole store (re-encoded
        lazily; the index is emptied so no stale slot can be read). Async:
        queued behaviors were embedded for the OLD model and are dropped
        with the store; the runtime commits a fresh empty version."""
        if self.async_ingest is not None:
            self.async_ingest.refresh(params)
            return
        self.ingestor.params = params
        self.store.clear()

    # ------------------------------------------------------------------
    # ingest (async servers enqueue; sync servers fold inline)
    # ------------------------------------------------------------------
    def ingest_history(self, user: Any, items, cats, mask=None):
        """Full (re-)encode of one user's history."""
        return self.ingest_histories([user], np.asarray(items)[None], np.asarray(cats)[None],
                                     None if mask is None else np.asarray(mask)[None])

    def ingest_histories(self, users, items, cats, masks=None):
        """Batched full (re-)encode. On an async server this ENQUEUES and
        returns the accepted count (rejects are counted drops)."""
        if self.async_ingest is not None:
            return self.async_ingest.submit_histories(users, items, cats, masks)
        return self.ingestor.ingest_histories(users, items, cats, masks)

    def ingest_event(self, user: Any, item: int, cat: int):
        """One real-time behavior event (an O(m·d) fold)."""
        return self.ingest_events([user], np.array([item]), np.array([cat]))

    def ingest_events(self, users, items, cats, mask=None):
        """Batched real-time events. On an async server this ENQUEUES the
        per-user event blocks and returns the accepted count."""
        if self.async_ingest is not None:
            return self.async_ingest.submit_events(users, items, cats, mask)
        return self.ingestor.ingest_events(users, items, cats, mask)

    def evict(self, user: Any) -> bool:
        """Drop a user's table; its slot is zeroed and recycled."""
        if self.async_ingest is not None:
            return self.async_ingest.evict(user)
        return self.store.evict(user)

    # ------------------------------------------------------------------
    # fetch (the read half)
    # ------------------------------------------------------------------
    def fetch(self, user: Any) -> Optional[torch.Tensor]:
        return self.fetcher.fetch(user)

    def fetch_many(self, users: Sequence[Any]) -> torch.Tensor:
        return self.fetcher.fetch_many(users)

    def serve_candidates(self, users: Sequence[Any], q: torch.Tensor,
                         R: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.fetcher.serve_candidates(users, q, R=R)

    def table_bytes(self) -> int:
        """Per-user serving-state bytes: stored bytes for quantized stores,
        the wire-cast row for float stores."""
        if len(self.store) == 0:
            return 0
        if self.store.quantized:
            return self.store.row_nbytes()
        itemsize = torch.empty((), dtype=self.wire_dtype).element_size()
        return int(np.prod(self.store.row_shape)) * itemsize

    # ------------------------------------------------------------------
    # snapshot / restore (tiered store only — the durable deployment)
    # ------------------------------------------------------------------
    def snapshot(self, dir: str) -> str:
        """Persist the FULL serving state under ``dir``: every tier of the
        store plus the hash family ``R``, the wire dtype and the serving
        stats. Async servers quiesce first (queue flushed, folds
        committed)."""
        if not isinstance(self.store, TieredTableStore):
            raise TypeError(
                "snapshot() needs the tiered store (pass hot_capacity=/"
                "store_dir=/policy= when building the BSEServer)")
        if self.async_ingest is not None:
            self.async_ingest.flush()
        self.store.snapshot(dir)
        _atomic_npz(os.path.join(dir, "server.npz"), R=self.R.detach().cpu().numpy())
        _atomic_json(os.path.join(dir, "server.json"),
                     {"wire_dtype": str(self.wire_dtype).removeprefix("torch."),
                      "stats": dataclasses.asdict(self.stats)})
        return dir

    @classmethod
    def restore(cls, dir: str, embed_fn: Callable, params: Any, engine: SDIMEngine,
                mesh: Any = None, store_dir: Optional[str] = None,
                device: DeviceLike = "cuda") -> "BSEServer":
        """Rebuild a server from ``snapshot(dir)`` on ``device``: tiers,
        indices, policy state, stats and ``R`` come from disk; the embed fn,
        params and engine (code, not state) from the caller. A sharded
        snapshot needs a ``mesh`` with the same shard count."""
        dev = resolve_device(device)
        store = TieredTableStore.restore(dir, mesh=mesh, store_dir=store_dir, device=dev)
        with np.load(os.path.join(dir, "server.npz")) as z:
            R = torch.as_tensor(z["R"], device=dev)
        with open(os.path.join(dir, "server.json")) as f:
            meta = json.load(f)
        srv = cls(embed_fn, params, engine, R=R,
                  wire_dtype=getattr(torch, meta["wire_dtype"]), store=store, device=dev)
        srv.stats = BSEStats(**meta["stats"])
        srv.ingestor.stats = srv.fetcher.stats = srv.stats
        return srv
