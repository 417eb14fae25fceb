"""BSE server (paper §4.4): user-wise behavior-sequence hashing, decoupled
from the CTR server.

Counterpart of ``repro/serve/bse_server.py`` on one device: per-user bucket
tables (the L-free (G, U, d) serving state) live in a ``TableStore``; the
write half (``BSEIngestor``) encodes full histories in one ``bse_encode``
launch per burst and folds real-time events in one ``sdim_update`` launch
(in place, duplicate users accumulate); the read half (``BSEFetcher``)
answers CTR-server fetches in the wire dtype (default bf16, the paper's
8 KB figure) with exact byte accounting, or scores candidates straight off
the store in one ``sdim_fused_serve`` launch. A user the store does not
hold reads as an all-zero row (or zero interest) and counts as a miss.

The tiered store, the sharded store, async ingest, metrics and tracing are
not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.engine import SDIMEngine
from repro_torch.device import DeviceLike
from repro_torch.serve.table_store import TableStore


@dataclasses.dataclass
class BSEStats:
    n_encodes: int = 0
    n_updates: int = 0
    n_fetches: int = 0
    n_misses: int = 0          # fetches of users the store does not hold
    bytes_transmitted: int = 0
    encode_time_s: float = 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class BSEIngestor:
    """Write half: embed behaviors, fold them into the shared table store.
    ``embed_fn(items, cats)`` maps host id arrays to (…, d) embeddings on
    the store's device."""

    def __init__(self, embed_fn: Callable, engine: SDIMEngine, R: torch.Tensor,
                 store: TableStore, stats: BSEStats):
        self.embed_fn = embed_fn
        self.engine = engine
        self.R = R
        self.store = store
        self.stats = stats

    def _mask(self, mask) -> Optional[torch.Tensor]:
        if mask is None:
            return None
        return torch.as_tensor(np.asarray(mask, np.float32), device=self.store.device)

    @torch.no_grad()
    def ingest_histories(self, users: Sequence[Any], items: np.ndarray,
                         cats: np.ndarray, masks: Optional[np.ndarray] = None) -> None:
        """Batched full (re-)encode: B distinct users' histories (B, L) in
        ONE ``bse_encode`` launch, written into their slots."""
        assert len(set(users)) == len(users), "duplicate users in one encode"
        t0 = time.perf_counter()
        seq_e = self.embed_fn(np.asarray(items), np.asarray(cats))
        tables = self.engine.encode(seq_e, self._mask(masks), R=self.R)
        _sync(tables.device)
        self.stats.encode_time_s += time.perf_counter() - t0
        self.stats.n_encodes += len(users)
        self.store.write(self.store.assign(users), tables)

    @torch.no_grad()
    def ingest_events(self, users: Sequence[Any], items: np.ndarray,
                      cats: np.ndarray, mask: Optional[np.ndarray] = None) -> None:
        """Batched real-time events: one event block per user — items/cats
        (B,) or (B, E) — folded into the store. Users may repeat (duplicate
        slots accumulate); unseen users start from a zero table. An fp32
        store takes ONE in-place ``sdim_update`` launch. bf16 and int8
        stores cannot take an in-place add of raw payload, so their events
        are encoded (``bse_encode``), summed per slot, and the touched rows
        read, added to and written back (requantized / saturating cast)."""
        items, cats = np.asarray(items), np.asarray(cats)
        mask = None if mask is None else np.asarray(mask)
        if items.ndim == 1:
            items, cats = items[:, None], cats[:, None]
            mask = None if mask is None else mask[:, None]
        if mask is not None:
            assert mask.shape == items.shape, (mask.shape, items.shape)
        ev_e = self.embed_fn(items, cats)                          # (B, E, d)
        m = self._mask(mask)
        slots = self.store.assign(users)
        if self.store.dtype != torch.float32:
            deltas = self.engine.encode(ev_e, m, R=self.R)          # (B, G, U, d)
            uniq, inv = np.unique(slots, return_inverse=True)
            summed = torch.zeros((len(uniq), *deltas.shape[1:]), dtype=deltas.dtype,
                                 device=deltas.device)
            summed.index_add_(0, torch.as_tensor(inv.ravel(), device=deltas.device),
                              deltas)
            self.store.write(uniq, self.store.rows(uniq) + summed)
        else:
            self.engine.update(self.store.data, slots, ev_e, m, R=self.R)
        self.stats.n_updates += int(items.size if mask is None else np.sum(mask > 0))


class BSEFetcher:
    """Read half: gather / fused-score against the table store, cast to the
    wire dtype, account the bytes of what crosses."""

    def __init__(self, engine: SDIMEngine, R: torch.Tensor, store: TableStore,
                 wire_dtype: torch.dtype, stats: BSEStats):
        self.engine = engine
        self.R = R
        self.store = store
        self.wire_dtype = wire_dtype
        self.stats = stats

    def _account(self, wire: torch.Tensor, n_users: int, misses: int) -> torch.Tensor:
        self.stats.n_fetches += n_users
        self.stats.n_misses += misses
        self.stats.bytes_transmitted += wire.numel() * wire.element_size()
        return wire

    @torch.no_grad()
    def fetch(self, user: Any) -> Optional[torch.Tensor]:
        """One user's table in the wire dtype; unknown user -> ``None``
        (counted in ``stats.n_misses``)."""
        if user not in self.store:
            self.stats.n_misses += 1
            return None
        wire = self.store.rows(self.store.slots([user]))[0].to(self.wire_dtype)
        return self._account(wire, 1, 0)

    @torch.no_grad()
    def fetch_many(self, users: Sequence[Any]) -> torch.Tensor:
        """ONE gather -> (B, G, U, d) in the wire dtype. A user the store
        does not hold gets an ALL-ZERO row and counts as a miss."""
        slots, present = self.store.lookup(users)
        rows = self.store.rows(slots)
        misses = len(users) - int(present.sum())
        if misses:
            rows = rows * torch.as_tensor(present, dtype=rows.dtype,
                                          device=rows.device)[:, None, None, None]
        return self._account(rows.to(self.wire_dtype), len(users), misses)

    @torch.no_grad()
    def serve_candidates(self, users: Sequence[Any], q: torch.Tensor,
                         R: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Fused serving: score candidates ``q`` (B, C, d) for ``users`` in
        ONE ``sdim_fused_serve`` launch straight off the store (int8 rows
        dequantized in the kernel); returns interest (B, C, d) in the wire
        dtype. Unknown users get zero interest."""
        slots, present = self.store.lookup(users)
        out = self.engine.serve_fused(self.store.data, slots, q, present=present,
                                      scales=self.store.scales,
                                      R=self.R if R is None else R)
        misses = len(users) - int(present.sum())
        return self._account(out.to(self.wire_dtype), len(users), misses)


class BSEServer:
    def __init__(self, embed_fn: Callable, engine: SDIMEngine,
                 R: Optional[torch.Tensor] = None,
                 wire_dtype: torch.dtype = torch.bfloat16, capacity: int = 64,
                 table_dtype: Any = torch.float32, device: DeviceLike = "cuda"):
        """``table_dtype`` is the STORAGE dtype of the bucket tables (fp32 |
        bf16 | int8, see serve/quant.py); ``wire_dtype`` the dtype of what
        ``fetch``/``fetch_many``/``serve_candidates`` hand the CTR server."""
        self.engine = engine
        self.R = engine.R if R is None else R
        self.wire_dtype = wire_dtype
        cfg = engine.cfg
        self.store = TableStore(cfg.n_groups, cfg.n_buckets, cfg.d, capacity=capacity,
                                dtype=table_dtype, device=device)
        self.stats = BSEStats()
        self.ingestor = BSEIngestor(embed_fn, engine, self.R, self.store, self.stats)
        self.fetcher = BSEFetcher(engine, self.R, self.store, wire_dtype, self.stats)

    def ingest_histories(self, users, items, cats, masks=None) -> None:
        self.ingestor.ingest_histories(users, items, cats, masks)

    def ingest_events(self, users, items, cats, mask=None) -> None:
        self.ingestor.ingest_events(users, items, cats, mask)

    def evict(self, user: Any) -> bool:
        """Drop a user's table; its slot is zeroed and recycled."""
        return self.store.evict(user)

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
