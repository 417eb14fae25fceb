"""Tiered BSE state store — device-hot / host-warm / disk-cold (§4.4 at
production scale).

Counterpart of ``repro/serve/tiered_store.py``. "Millions of users" cannot
fit one card's memory, and a restart must not lose serving state, so the
BSE state lives in three tiers:

  * **hot tier** — the device ``TableStore`` (a ``ShardedTableStore`` when
    a ``mesh`` is given), but *bounded*: capacity is fixed at
    ``hot_capacity`` users (rounded up to ``S·⌈hot_capacity/S⌉`` over S
    shards) and never grows. A pluggable ``EvictionPolicy`` (``"clock"`` —
    one-bit second chance — or ``"lru"``) decides who stays hot;
  * **warm tier** — a host numpy pool (``WarmPool``) with its own slot
    index and amortized-doubling growth. Demoted rows land here;
  * **cold tier** — on-disk ``.npz`` segments (``ColdStore``), written
    atomically (tmp file + ``os.replace``). When the warm pool exceeds
    ``warm_capacity``, its oldest rows spill to a new segment; a segment
    with no live row is unlinked.

Movement between tiers is **batched**: one burst costs at most one hot
gather (demotion read), one hot zero-scatter (slot recycle) and one hot
write-scatter (promotion), never a per-user launch. ``TierStats.
n_hot_gathers`` / ``n_hot_scatters`` count them so tests can prove it.

Host tiers hold the STORED bytes: int8/fp8 payload plus the per-row fp32
scales, so demote → promote never requantizes and is bit-exact. numpy has
no bf16 or fp8, so those payloads are held as their raw bits (int16 /
uint8, ``table_store.to_host``/``from_host``); segments and the snapshot
manifest record the storage dtype. Device↔host copies are synchronous, so
a host buffer the warm pool reuses is never read by a copy still in
flight.

``snapshot(dir)`` / ``restore(dir)`` round-trip all three tiers, every
index, the policy's recency state and the tier stats, so a restarted server
answers bit for bit without re-ingesting a history (``BSEServer.snapshot``
adds the hash family ``R`` and the serving stats). The file layout is the
reference's; the arrays are the port's raw-bit host form.

The store is compute-free, like the store it fronts. User keys must be
JSON-serializable scalars (int or str): they are persisted in segment files
and manifests.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import shutil
import time
from typing import Any, Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serve.admission import CircuitBreaker
from repro_torch.serve.metrics import observe_ms
from repro_torch.serve.quant import TABLE_DTYPES, dequantize_rows, resolve_table_dtype
from repro_torch.serve.table_store import (ShardedTableStore, TableStore, from_host, host_dtype,
                                           to_host)
from repro_torch.serve.tracing import maybe_span


# ---------------------------------------------------------------------------
# checkpoint.py idiom: never leave a half-written file in place
# ---------------------------------------------------------------------------
def _atomic_npz(path: str, **arrays) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _atomic_json(path: str, obj) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# eviction policies
# ---------------------------------------------------------------------------
class EvictionPolicy:
    """Tracks hot-tier residents and picks demotion victims.

    The tiered store calls ``insert`` when a user becomes hot, ``touch`` on
    every access, ``remove`` when a user leaves the hot tier, and
    ``victims(k, exclude)`` to choose k users to demote — ``exclude`` pins
    the current burst (a user about to be served must never be its own
    victim). ``state()``/``load_state()`` round-trip the recency state
    through snapshots as JSON-able lists.
    """

    name = "base"

    def insert(self, user: Any) -> None:
        raise NotImplementedError

    def touch(self, user: Any) -> None:
        raise NotImplementedError

    def remove(self, user: Any) -> None:
        raise NotImplementedError

    def victims(self, k: int, exclude=()) -> list:
        raise NotImplementedError

    def state(self) -> dict:
        raise NotImplementedError

    def load_state(self, state: dict) -> None:
        raise NotImplementedError


class LRUPolicy(EvictionPolicy):
    """Exact least-recently-used (dict insertion order = recency order)."""

    name = "lru"

    def __init__(self):
        self._order: dict[Any, None] = {}

    def insert(self, user):
        self._order[user] = None

    def touch(self, user):
        if user in self._order:
            del self._order[user]
            self._order[user] = None

    def remove(self, user):
        self._order.pop(user, None)

    def victims(self, k, exclude=()):
        out = [u for u in self._order if u not in exclude][:k]
        if len(out) < k:
            raise RuntimeError(
                f"need {k} victims but only {len(out)} evictable hot users")
        return out

    def state(self):
        return {"order": list(self._order)}

    def load_state(self, state):
        self._order = {u: None for u in state["order"]}


class ClockPolicy(EvictionPolicy):
    """CLOCK (one-bit second chance): O(1) touch — no list reshuffling on
    the hot path, which is why production KV caches prefer it over exact
    LRU. A hand sweeps a ring of hot users; referenced users get their bit
    cleared and one more round, unreferenced ones are victims.

    Ring cells are ``[user, alive]`` entries tracked per user, so ``remove``
    kills exactly one cell and a later re-insert (demote → re-promote, the
    common Zipf hot-head path) cannot revive the stale tombstone — the user
    gets a genuinely fresh second chance. Dead cells are popped lazily by
    the sweep."""

    name = "clock"

    def __init__(self):
        self._ring: list[list] = []           # [user, alive] cells
        self._cell: dict[Any, list] = {}      # user -> its live cell
        self._ref: dict[Any, int] = {}
        self._hand = 0

    def insert(self, user):
        assert user not in self._cell, f"user {user!r} already tracked"
        cell = [user, True]
        self._ring.append(cell)
        self._cell[user] = cell
        self._ref[user] = 1

    def touch(self, user):
        if user in self._ref:
            self._ref[user] = 1

    def remove(self, user):
        cell = self._cell.pop(user, None)
        if cell is not None:
            cell[1] = False                   # tombstone: popped lazily
        self._ref.pop(user, None)

    def victims(self, k, exclude=()):
        evictable = sum(1 for u in self._ref if u not in exclude)
        if evictable < k:
            raise RuntimeError(
                f"need {k} victims but only {evictable} evictable hot users")
        out, chosen = [], set()
        steps = 0
        limit = 3 * len(self._ring) + k + 8    # 2 sweeps always suffice
        while len(out) < k:
            steps += 1
            assert steps <= limit, "CLOCK sweep failed to terminate"
            if self._hand >= len(self._ring):
                self._hand = 0
            u, alive = self._ring[self._hand]
            if not alive or u in chosen:
                self._ring.pop(self._hand)     # tombstone: drop, don't advance
            elif u in exclude:
                self._hand += 1
            elif self._ref[u]:
                self._ref[u] = 0               # second chance
                self._hand += 1
            else:
                out.append(u)
                chosen.add(u)
                self._hand += 1
        return out

    def state(self):
        ordered = self._ring[self._hand:] + self._ring[:self._hand]
        return {"order": [[u, int(self._ref[u])]
                          for u, alive in ordered if alive]}

    def load_state(self, state):
        self._ring = [[u, True] for u, _ in state["order"]]
        self._cell = {cell[0]: cell for cell in self._ring}
        self._ref = {u: int(r) for u, r in state["order"]}
        self._hand = 0


POLICIES = {"lru": LRUPolicy, "clock": ClockPolicy}

# the hot-tier bound used when tiering is requested without an explicit
# hot_capacity (mirrors TableStore's default capacity)
DEFAULT_HOT_CAPACITY = 64


def burst_cap(store) -> Optional[int]:
    """Max distinct users one batched op may touch, or None if unbounded —
    the tiered store's hot-tier residency bound. Callers (``BSEServer``,
    the async ingest writer) chunk oversized bursts with ``burst_chunks``
    so the bound degrades to extra dispatches, never a request-path 500."""
    return getattr(store, "hot_capacity", None)


def burst_chunks(users: Sequence[Any], cap: int) -> list[tuple[int, int]]:
    """Greedy split of a burst into index ranges ``[lo, hi)`` that each
    touch at most ``cap`` DISTINCT users, preserving order. Duplicates
    within a range share the distinct-user budget, so every range is safe
    for ``_ensure_resident``; the single range ``[(0, len(users))]`` comes
    back whenever the burst already fits."""
    if cap < 1:
        raise ValueError(f"burst chunk cap must be >= 1, got {cap}")
    bounds: list[tuple[int, int]] = []
    lo = 0
    seen: set = set()
    for i, u in enumerate(users):
        if u not in seen:
            if len(seen) == cap:
                bounds.append((lo, i))
                lo = i
                seen = set()
            seen.add(u)
    bounds.append((lo, len(users)))
    return bounds


def is_tiered(hot_capacity=None, store_dir=None, policy=None,
              warm_capacity=None) -> bool:
    """The one predicate for "did the caller ask for the tiered store" —
    shared by ``BSEServer``, ``CTRServer.build`` and the launcher so the
    layers can never diverge on which knobs enable tiering."""
    return any(v is not None
               for v in (hot_capacity, store_dir, policy, warm_capacity))


def make_policy(policy) -> EvictionPolicy:
    if isinstance(policy, EvictionPolicy):
        return policy
    if policy not in POLICIES:
        raise ValueError(f"unknown eviction policy {policy!r}; "
                         f"have {sorted(POLICIES)}")
    return POLICIES[policy]()


def dtype_name(dtype: torch.dtype) -> str:
    """The table-dtype name (``fp32``/``bf16``/``int8``/``fp8``) of a
    storage dtype, as segments and manifests record it."""
    return next(k for k, v in TABLE_DTYPES.items() if v == dtype)


# ---------------------------------------------------------------------------
# warm tier: host ndarray pool
# ---------------------------------------------------------------------------
class WarmPool:
    """Host-memory row pool: one (N, G, U, d) numpy array + user→slot index
    with amortized-doubling growth. Insertion order of the index doubles as
    demotion age, which ``oldest`` (the spill order) reads.

    Rows are held as stored: ``dtype`` is the storage dtype, the array the
    host form of it (raw bits for bf16/fp8), and a quantized tier adds a
    parallel (N, G, U) fp32 ``scales`` array."""

    # accounting seam: a serve/profiler.MemoryLedger sets both on attach
    ledger = None
    _ledger_key = None

    def __init__(self, row_shape, dtype: torch.dtype, capacity: int = 64,
                 quantized: bool = False):
        self.row_shape = tuple(row_shape)
        self.dtype = dtype
        self.quantized = quantized
        self.data = np.zeros((max(1, capacity), *self.row_shape), host_dtype(dtype))
        self.scales = (np.zeros((max(1, capacity), *self.row_shape[:-1]),
                                np.float32) if quantized else None)
        self._slot_of: dict[Any, int] = {}
        self._free = list(range(self.data.shape[0] - 1, -1, -1))

    def _nbytes(self) -> int:
        """Host bytes this pool holds right now (the ledger's ground truth)."""
        return self.data.nbytes + (self.scales.nbytes if self.quantized else 0)

    def __len__(self) -> int:
        return len(self._slot_of)

    def __contains__(self, user) -> bool:
        return user in self._slot_of

    def users(self) -> Iterator[Any]:
        return iter(self._slot_of)

    def put(self, users: Sequence[Any], rows: np.ndarray,
            scales: Optional[np.ndarray] = None) -> None:
        assert len(users) == len(rows), (len(users), rows.shape)
        assert (scales is not None) == self.quantized
        assert rows.dtype == self.data.dtype, (rows.dtype, self.data.dtype)
        old = self._nbytes()
        while len(self._free) < len(users):
            n = self.data.shape[0]
            self.data = np.concatenate([self.data, np.zeros_like(self.data)])
            if self.quantized:
                self.scales = np.concatenate([self.scales, np.zeros_like(self.scales)])
            self._free[:0] = range(2 * n - 1, n - 1, -1)
        if self.ledger is not None and self._nbytes() != old:
            self.ledger.add(self._ledger_key, self._nbytes() - old, "grow")
        for i, (u, row) in enumerate(zip(users, rows)):
            assert u not in self._slot_of, f"user {u!r} already warm"
            s = self._free.pop()
            self._slot_of[u] = s
            self.data[s] = row
            if self.quantized:
                self.scales[s] = scales[i]

    def take(self, users: Sequence[Any]) -> tuple[np.ndarray, Optional[np.ndarray]]:
        """Remove ``users``; returns (rows (B, G, U, d), scales or None)."""
        slots = [self._slot_of.pop(u) for u in users]
        idx = np.asarray(slots, np.int64)
        rows = self.data[idx].copy()
        scales = self.scales[idx].copy() if self.quantized else None
        self._free.extend(slots)
        return rows, scales

    def peek(self, user) -> Optional[tuple[np.ndarray, Optional[np.ndarray]]]:
        """One row as stored (payload, scales or None), or None."""
        s = self._slot_of.get(user)
        if s is None:
            return None
        return self.data[s], (self.scales[s] if self.quantized else None)

    def oldest(self, k: int) -> list:
        return list(self._slot_of)[:k]

    def clear(self) -> None:
        self._slot_of.clear()
        self._free = list(range(self.data.shape[0] - 1, -1, -1))
        self.data[:] = 0
        if self.quantized:
            self.scales[:] = 0
        if self.ledger is not None:   # in-place zeroing: the allocation keeps
            self.ledger.count("clear")

    # ---- snapshot seam -------------------------------------------------
    def host_state(self) -> dict:
        state = {"data": self.data,
                 "index": [[u, int(s)] for u, s in self._slot_of.items()]}
        if self.quantized:
            state["scales"] = self.scales
        return state

    def load_host_state(self, state: dict) -> None:
        data = np.asarray(state["data"])
        assert data.shape[1:] == self.row_shape, (data.shape, self.row_shape)
        assert data.dtype == self.data.dtype, (data.dtype, self.data.dtype)
        old = self._nbytes()
        self.data = np.array(data)
        if self.quantized:
            self.scales = np.array(np.asarray(state["scales"]), np.float32)
        self._slot_of = {u: int(s) for u, s in state["index"]}
        used = set(self._slot_of.values())
        self._free = [s for s in range(self.data.shape[0] - 1, -1, -1)
                      if s not in used]
        if self.ledger is not None:   # wholesale replace: the shape may differ
            self.ledger.add(self._ledger_key, self._nbytes() - old, "restore")


# ---------------------------------------------------------------------------
# cold tier: on-disk .npz segments
# ---------------------------------------------------------------------------
class ColdStore:
    """Append-only ``.npz`` segments under ``dir`` + an in-memory
    user→(segment, row) index. One spill = one segment file (rows, a JSON
    user list and the storage dtype's name, so segments are
    self-describing), written atomically. Rows removed by promotion or
    eviction go dead in place; a segment whose live count hits zero is
    unlinked."""

    # accounting seam: a serve/profiler.MemoryLedger sets both on attach
    ledger = None
    _ledger_key = None

    def __init__(self, dir: str):
        self.dir = dir
        os.makedirs(dir, exist_ok=True)
        self._seg_of: dict[Any, tuple[int, int]] = {}
        self._live: dict[int, int] = {}
        existing = [int(os.path.basename(p)[4:-4])
                    for p in glob.glob(os.path.join(dir, "seg_*.npz"))]
        self._next = max(existing, default=-1) + 1

    def _seg_nbytes(self, seg: int) -> int:
        try:
            return os.path.getsize(self._path(seg))
        except OSError:
            return 0

    def _nbytes(self) -> int:
        """Bytes of the live segment files (the ledger's ground truth)."""
        return sum(self._seg_nbytes(seg) for seg in self._live)

    def _path(self, seg: int) -> str:
        return os.path.join(self.dir, f"seg_{seg:08d}.npz")

    def __len__(self) -> int:
        return len(self._seg_of)

    def __contains__(self, user) -> bool:
        return user in self._seg_of

    def users(self) -> Iterator[Any]:
        return iter(self._seg_of)

    @property
    def n_segments(self) -> int:
        return len(self._live)

    def spill(self, users: Sequence[Any], rows: np.ndarray,
              scales: Optional[np.ndarray] = None, dtype: str = "fp32") -> None:
        """Write ``users``' stored rows (host form of storage dtype
        ``dtype``) to a new segment."""
        assert len(users) == len(rows), (len(users), rows.shape)
        seg = self._next
        self._next += 1
        arrays = {"rows": np.asarray(rows),
                  "users": np.asarray(json.dumps(list(users))),
                  "dtype": np.asarray(dtype)}
        if scales is not None:     # quantized tier: segments carry the scales
            arrays["scales"] = np.asarray(scales)
        _atomic_npz(self._path(seg), **arrays)
        for i, u in enumerate(users):
            assert u not in self._seg_of, f"user {u!r} already cold"
            self._seg_of[u] = (seg, i)
        self._live[seg] = len(users)
        if self.ledger is not None:
            self.ledger.add(self._ledger_key, self._seg_nbytes(seg), "spill")

    def read(self, user) -> tuple[np.ndarray, Optional[np.ndarray]]:
        """One user's stored row (payload, scales or None), no removal."""
        seg, r = self._seg_of[user]
        with np.load(self._path(seg)) as z:
            return (np.array(z["rows"][r]),
                    np.array(z["scales"][r]) if "scales" in z.files else None)

    def load_remove(self, users: Sequence[Any]
                    ) -> tuple[np.ndarray, Optional[np.ndarray]]:
        """Promote: read ``users``' rows (each touched segment loaded once)
        and drop them from the index. Returns ``(rows, scales-or-None)``."""
        by_seg: dict[int, list] = {}
        for u in users:
            seg, r = self._seg_of[u]
            by_seg.setdefault(seg, []).append((u, r))
        rows, scales = {}, {}
        for seg, entries in by_seg.items():
            with np.load(self._path(seg)) as z:
                data = z["rows"]
                sdata = z["scales"] if "scales" in z.files else None
                for u, r in entries:
                    rows[u] = np.array(data[r])
                    if sdata is not None:
                        scales[u] = np.array(sdata[r])
        self.remove(users)
        out_rows = np.stack([rows[u] for u in users])
        out_scales = (np.stack([scales[u] for u in users])
                      if len(scales) == len(users) else None)
        return out_rows, out_scales

    def remove(self, users: Sequence[Any]) -> None:
        for u in users:
            seg, _ = self._seg_of.pop(u)
            self._live[seg] -= 1
            if self._live[seg] == 0:
                del self._live[seg]
                # size BEFORE the unlink; the segment leaves the live set
                # either way, so the ledger drops it either way
                if self.ledger is not None:
                    self.ledger.add(self._ledger_key, -self._seg_nbytes(seg), "unlink")
                try:
                    os.remove(self._path(seg))
                except OSError:
                    pass

    def clear(self) -> None:
        for seg in list(self._live):
            if self.ledger is not None:
                self.ledger.add(self._ledger_key, -self._seg_nbytes(seg), "unlink")
            try:
                os.remove(self._path(seg))
            except OSError:
                pass
        self._seg_of.clear()
        self._live.clear()

    # ---- snapshot seam -------------------------------------------------
    def index_state(self) -> list:
        return [[u, int(s), int(r)] for u, (s, r) in self._seg_of.items()]

    def load_index_state(self, index: list) -> None:
        self._seg_of = {u: (int(s), int(r)) for u, s, r in index}
        self._live = {}
        for seg, _ in self._seg_of.values():
            self._live[seg] = self._live.get(seg, 0) + 1
        for seg in self._live:
            assert os.path.exists(self._path(seg)), \
                f"cold index references missing segment {self._path(seg)}"
        self._next = max(self._live, default=self._next - 1) + 1
        if self.ledger is not None:   # wholesale index replace: resync
            self.ledger.set_total(self._ledger_key,
                                  self._nbytes(), "restore")


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TierStats:
    """Per-unique-user-per-batch tier accounting, plus the batched-device-op
    counters that pin the no-per-user-launch invariant."""

    hot_hits: int = 0           # user already hot when a batch touched it
    warm_promotions: int = 0    # warm -> hot
    cold_promotions: int = 0    # cold -> hot
    demotions: int = 0          # hot -> warm
    spills: int = 0             # warm -> cold
    misses: int = 0             # user in no tier (lookup only)
    n_degraded: int = 0         # cold users served as misses (breaker open
                                # or cold read failed) instead of stalling
    promote_bytes: int = 0      # bytes written hot-ward (warm/cold -> hot)
    demote_bytes: int = 0       # bytes read off the hot tier on demotion
    spill_bytes: int = 0        # bytes written to cold segments
    n_hot_gathers: int = 0      # batched device gathers (demotion reads)
    n_hot_scatters: int = 0     # batched device scatters (recycle + promote)

    @property
    def hit_rate(self) -> float:
        seen = (self.hot_hits + self.warm_promotions + self.cold_promotions
                + self.misses)
        return self.hot_hits / seen if seen else 1.0


def _nbytes(rows: np.ndarray, scales: Optional[np.ndarray]) -> int:
    return rows.nbytes + (0 if scales is None else scales.nbytes)


# ---------------------------------------------------------------------------
# the tiered store
# ---------------------------------------------------------------------------
class TieredTableStore:
    """Bounded hot ``TableStore``/``ShardedTableStore`` + ``WarmPool`` +
    ``ColdStore``, presenting the surface the ``BSEServer`` speaks
    (``assign``/``lookup``/``rows``/``write``/``data``/…), so the serving
    stack routes through it unchanged.

    Residency protocol: every batched op first calls ``_ensure_resident``,
    which partitions the burst's unique users by tier, demotes victims
    (policy-chosen, burst-pinned) if the hot tier lacks room, and promotes
    warm/cold users — all in ≤1 hot gather + ≤2 hot scatters per burst.
    A burst may touch at most ``hot_capacity`` distinct users.

    ``warm_capacity=None`` lets the warm pool grow without bound (no cold
    spills even when ``store_dir`` is set); with ``store_dir=None`` there is
    no cold tier and the warm pool is always unbounded.
    """

    def __init__(self, n_groups: int, n_buckets: int, d: int,
                 hot_capacity: int = DEFAULT_HOT_CAPACITY,
                 dtype: Any = torch.float32, mesh: Any = None, policy="clock",
                 store_dir: Optional[str] = None,
                 warm_capacity: Optional[int] = None,
                 cold_deadline_s: Optional[float] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 clock=None, metrics=None, tracer=None,
                 device: DeviceLike = "cuda"):
        """``cold_deadline_s`` arms a ``CircuitBreaker`` around the cold
        tier: a cold segment read slower than the deadline (or raising)
        opens the circuit, after which cold users on the READ path degrade
        to counted misses (``stats.n_degraded``) instead of stalling every
        request behind a sick disk; write-path promotions (``create=True``)
        always read. ``breaker`` shares or injects one, ``clock`` is a
        virtual clock for tests, ``metrics`` receives the tier counters and
        the cold-read latency, ``tracer`` gets ``tier.cold_read`` /
        ``tier.promote`` / ``tier.demote`` spans on actual tier movement
        and flags degraded requests' traces. ``mesh`` (a ``MeshCtx`` or a
        device list) shards the hot tier over its model axis; its rows then
        assemble on ``device``."""
        if hot_capacity < 1:
            raise ValueError(
                f"hot_capacity must be >= 1, got {hot_capacity} — a tiered "
                "store needs at least one device-resident slot")
        if mesh is None:
            self.hot = TableStore(n_groups, n_buckets, d, capacity=hot_capacity,
                                  dtype=dtype, device=resolve_device(device))
        else:
            self.hot = ShardedTableStore(n_groups, n_buckets, d, mesh, capacity=hot_capacity,
                                         dtype=dtype, device=device)
        # sharded capacity rounds up to S * ceil(hot_capacity / S)
        self.hot_capacity = self.hot.capacity
        self.warm = WarmPool(self.hot.row_shape, self.hot.dtype,
                             capacity=self.hot_capacity,
                             quantized=self.hot.quantized)
        self.cold = None if store_dir is None else ColdStore(store_dir)
        self.warm_capacity = warm_capacity
        self.policy = make_policy(policy)
        self.stats = TierStats()
        self._clock = time.perf_counter if clock is None else clock
        if breaker is None and cold_deadline_s is not None:
            breaker = CircuitBreaker(deadline_s=cold_deadline_s, clock=self._clock)
        self.breaker = breaker
        self.metrics = metrics
        self.tracer = tracer
        # accounting seam: serve/profiler.MemoryLedger.attach registers
        # every tier and sets this for the tier-movement traffic events
        self.ledger = None

    # ------------------------------------------------------------------
    # delegated surface
    # ------------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.hot.device

    @property
    def sharded(self) -> bool:
        return self.hot.sharded

    @property
    def mesh_ctx(self):
        return self.hot.mesh_ctx          # sharded hot tier only

    @property
    def n_shards(self) -> int:
        return self.hot.n_shards          # sharded hot tier only

    def shards_of(self, handles) -> list[int]:
        return self.hot.shards_of(handles)

    @property
    def row_shape(self):
        return self.hot.row_shape

    @property
    def dtype(self):
        return self.hot.dtype

    @property
    def quantized(self) -> bool:
        return self.hot.quantized

    @property
    def donate_writes(self) -> bool:
        """Hot-tier write mode; the async ingest runtime turns it off so
        committed reader views survive every write (copy on write)."""
        return self.hot.donate_writes

    @donate_writes.setter
    def donate_writes(self, value: bool) -> None:
        self.hot.donate_writes = value

    @property
    def n_saturated(self) -> int:
        return self.hot.n_saturated

    @property
    def n_nonfinite(self) -> int:
        return self.hot.n_nonfinite

    @property
    def scales(self):
        """Per-row quantization scales of the HOT tier (None unless
        quantized) — what the fused serve kernel reads."""
        return self.hot.scales

    @property
    def data(self):
        return self.hot.data

    def share(self):
        return self.hot.share()

    def writable(self, shards=None):
        """The hot tier's writable tensors (``shards``: a sharded hot
        tier's shards to clone, default every one)."""
        return self.hot.writable() if shards is None else self.hot.writable(shards)

    @property
    def capacity(self) -> int:
        """Device (hot-tier) capacity — the device-memory bound."""
        return self.hot.capacity

    def __len__(self) -> int:
        return len(self.hot) + len(self.warm) + \
            (0 if self.cold is None else len(self.cold))

    def __contains__(self, user) -> bool:
        return self.tier(user) is not None

    def users(self) -> Iterator[Any]:
        yield from self.hot.users()
        yield from self.warm.users()
        if self.cold is not None:
            yield from self.cold.users()

    def tier(self, user) -> Optional[str]:
        if user in self.hot:
            return "hot"
        if user in self.warm:
            return "warm"
        if self.cold is not None and user in self.cold:
            return "cold"
        return None

    def tier_sizes(self) -> dict[str, int]:
        return {"hot": len(self.hot), "warm": len(self.warm),
                "cold": 0 if self.cold is None else len(self.cold)}

    # ------------------------------------------------------------------
    # residency engine: batched promote / demote
    # ------------------------------------------------------------------
    def _ensure_resident(self, users: Sequence[Any], create: bool) -> None:
        uniq = list(dict.fromkeys(users))
        hot_u, warm_u, cold_u, new_u = [], [], [], []
        for u in uniq:
            t = self.tier(u)
            if t == "hot":
                hot_u.append(u)
            elif t == "warm":
                warm_u.append(u)
            elif t == "cold":
                cold_u.append(u)
            elif create:
                new_u.append(u)
            else:
                self.stats.misses += 1
        # with the cold tier marked sick, READ-path cold users degrade to
        # counted misses; write-path promotions always read
        if (cold_u and not create and self.breaker is not None
                and not self.breaker.allow()):
            self._degrade(cold_u)
            cold_u = []
        need = len(warm_u) + len(cold_u) + len(new_u)
        if len(hot_u) + need > self.hot_capacity:
            raise ValueError(
                f"burst touches {len(hot_u) + need} distinct users but the "
                f"hot tier holds {self.hot_capacity}; split the burst or "
                f"raise hot_capacity")
        self.stats.hot_hits += len(hot_u)
        for u in hot_u:
            self.policy.touch(u)
        if not need:
            return
        free = self.hot_capacity - len(self.hot)
        if free < need:
            self._demote(need - free, pinned=set(uniq))
        # cold read FIRST (timed, breaker-recorded): if it fails those users
        # degrade before the warm pool is touched
        cold_parts = None
        if cold_u:
            t0 = self._clock()
            with maybe_span(self.tracer, "tier.cold_read", n=len(cold_u)):
                try:
                    cold_parts = self.cold.load_remove(cold_u)
                except Exception:
                    if self.breaker is None or create:
                        raise
                    self.breaker.record_failure()
                    self._degrade(cold_u)
                    cold_u = []
                else:
                    dt = self._clock() - t0
                    if self.breaker is not None:
                        self.breaker.record(dt)
                    observe_ms(self.metrics, "tier.cold_read_ms", dt)
        promote = warm_u + cold_u
        if promote:
            with maybe_span(self.tracer, "tier.promote",
                            n_warm=len(warm_u), n_cold=len(cold_u)):
                rparts, sparts = [], []
                if warm_u:
                    r, s = self.warm.take(warm_u)
                    rparts.append(r)
                    sparts.append(s)
                if cold_u:
                    rparts.append(cold_parts[0])
                    sparts.append(cold_parts[1])
                rows = rparts[0] if len(rparts) == 1 else np.concatenate(rparts)
                scales = None
                if self.hot.quantized:
                    assert all(s is not None for s in sparts), \
                        "quantized store promoted rows without scales"
                    scales = sparts[0] if len(sparts) == 1 else np.concatenate(sparts)
                # ONE scatter promotes the whole batch, as stored bytes (no
                # requantization); the uploads are synchronous copies
                self.hot.write_raw(
                    self.hot.assign(promote),
                    from_host(rows, self.hot.dtype, self.device),
                    None if scales is None else from_host(scales, torch.float32,
                                                          self.device))
                self.stats.n_hot_scatters += 1
                self.stats.warm_promotions += len(warm_u)
                self.stats.cold_promotions += len(cold_u)
                self.stats.promote_bytes += _nbytes(rows, scales)
                if self.ledger is not None:
                    self.ledger.count("promote", len(promote), moved=_nbytes(rows, scales))
                if self.metrics is not None:
                    self.metrics.counter("tier.promotions").inc(len(promote))
        if new_u:
            self.hot.assign(new_u)     # fresh slots read zero; no device op
        for u in promote + new_u:
            self.policy.insert(u)
        # spill AFTER promotion: a burst user freshly classified warm must
        # never ride a demotion-triggered spill to cold mid-batch
        self._spill_overflow()
        assert self.hot.capacity == self.hot_capacity, \
            (self.hot.capacity, self.hot_capacity)
        if self.metrics is not None:
            self.metrics.gauge("tier.hot_fill").set(len(self.hot) / self.hot_capacity)

    def _degrade(self, cold_users: Sequence[Any]) -> None:
        """Serve cold users as misses THIS burst (counted, surfaced): they
        stay in the cold index and promote once the breaker closes."""
        self.stats.n_degraded += len(cold_users)
        if self.metrics is not None:
            self.metrics.counter("tier.degraded").inc(len(cold_users))
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.flag("degraded")
            self.tracer.annotate(degraded=len(cold_users))

    def _demote(self, k: int, pinned: set) -> None:
        with maybe_span(self.tracer, "tier.demote", k=k):
            victims = self.policy.victims(k, exclude=pinned)
            # 1 gather of the stored bytes, copied to the host synchronously
            payload, scales = self.hot.rows_raw(self.hot.slots(victims))
            vrows = to_host(payload)
            vscales = None if scales is None else to_host(scales)
            self.stats.n_hot_gathers += 1
            self.hot.evict_many(victims)                       # 1 zero-scatter
            self.stats.n_hot_scatters += 1
            for v in victims:
                self.policy.remove(v)
            self.warm.put(victims, vrows, vscales)
            self.stats.demotions += k
            self.stats.demote_bytes += _nbytes(vrows, vscales)
            if self.ledger is not None:
                self.ledger.count("demote", k, moved=_nbytes(vrows, vscales))
            if self.metrics is not None:
                self.metrics.counter("tier.demotions").inc(k)

    def _spill_overflow(self) -> None:
        if self.warm_capacity is None or self.cold is None:
            return
        excess = len(self.warm) - self.warm_capacity
        if excess > 0:
            old = self.warm.oldest(excess)
            rows, scales = self.warm.take(old)
            self.cold.spill(old, rows, scales, dtype=dtype_name(self.dtype))
            self.stats.spills += excess
            self.stats.spill_bytes += _nbytes(rows, scales)

    # ------------------------------------------------------------------
    # TableStore surface (residency-aware)
    # ------------------------------------------------------------------
    def assign(self, users: Sequence[Any]) -> np.ndarray:
        """Hot slots for ``users`` — promoting, demoting and allocating as
        needed. Fresh users read all-zero; duplicates share one slot."""
        self._ensure_resident(users, create=True)
        return self.hot.assign(users)

    def assign_fresh(self, users: Sequence[Any]) -> np.ndarray:
        """``assign`` for callers about to overwrite every row wholesale
        (``ingest_histories``' full re-encode): warm/cold copies of these
        users are DROPPED instead of promoted."""
        uniq = list(dict.fromkeys(users))
        stale_warm = [u for u in uniq if u in self.warm]
        if stale_warm:
            self.warm.take(stale_warm)
        if self.cold is not None:
            stale_cold = [u for u in uniq if u in self.cold]
            if stale_cold:
                self.cold.remove(stale_cold)
        return self.assign(users)

    def slots(self, users: Sequence[Any]) -> np.ndarray:
        """Hot slots of known users (promoted first); KeyError on unknown."""
        self._ensure_resident(users, create=False)
        return self.hot.slots(users)

    def lookup(self, users: Sequence[Any]) -> tuple[np.ndarray, np.ndarray]:
        """Miss-tolerant ``slots``: known users are promoted to hot, unknown
        ones get slot 0 with ``present=False`` (counted in
        ``stats.misses``)."""
        self._ensure_resident(users, create=False)
        return self.hot.lookup(users)

    def rows(self, slots) -> torch.Tensor:
        return self.hot.rows(slots)

    def row(self, user) -> Optional[torch.Tensor]:
        """Read-only peek across all tiers — no promotion, no recency touch
        (the serving path is ``lookup`` + ``rows``). Dequantized for
        quantized stores, in the storage dtype otherwise, on the device."""
        t = self.tier(user)
        if t is None:
            return None
        if t == "hot":
            return self.hot.row(user)
        payload, scales = self.warm.peek(user) if t == "warm" else self.cold.read(user)
        row = from_host(payload, self.dtype, self.device)
        if self.quantized:
            return dequantize_rows(row, from_host(scales, torch.float32, self.device))
        return row

    def write(self, slots, rows: torch.Tensor) -> None:
        self.hot.write(slots, rows)

    def rows_raw(self, slots):
        return self.hot.rows_raw(slots)

    def write_raw(self, slots, payload, scales=None) -> None:
        self.hot.write_raw(slots, payload, scales)

    def row_nbytes(self) -> int:
        return self.hot.row_nbytes()

    def evict(self, user) -> bool:
        """Drop a user from whichever tier holds it (deletion, not
        demotion)."""
        t = self.tier(user)
        if t == "hot":
            self.policy.remove(user)
            return self.hot.evict(user)
        if t == "warm":
            self.warm.take([user])
            return True
        if t == "cold":
            self.cold.remove([user])
            return True
        return False

    def clear(self) -> None:
        """Invalidate everything (model push): all tiers emptied, cold
        segments unlinked, policy and stats reset."""
        self.hot.clear()
        self.warm.clear()
        if self.cold is not None:
            self.cold.clear()
        self.policy = make_policy(self.policy.name)
        self.stats = TierStats()

    # ------------------------------------------------------------------
    # snapshot / restore
    # ------------------------------------------------------------------
    def snapshot(self, dir: str) -> str:
        """Write the complete store state under ``dir``: ``tiers.npz`` (hot
        + warm arrays in host form), ``manifest.json`` (indices, storage
        dtype, policy recency state, stats, config) and ``cold/seg_*.npz``
        (live segments copied; a segment already inside ``dir`` is left in
        place). Every file lands atomically. Returns ``dir``."""
        os.makedirs(dir, exist_ok=True)
        hot_state = self.hot.host_state()
        warm_state = self.warm.host_state()
        tier_arrays = {"hot": hot_state["data"], "warm": warm_state["data"]}
        if self.hot.quantized:
            tier_arrays["hot_scales"] = hot_state["scales"]
            tier_arrays["warm_scales"] = warm_state["scales"]
        _atomic_npz(os.path.join(dir, "tiers.npz"), **tier_arrays)
        cold_index = []
        if self.cold is not None:
            cold_dir = os.path.join(dir, "cold")
            os.makedirs(cold_dir, exist_ok=True)
            cold_index = self.cold.index_state()
            for seg in sorted({s for s, _ in self.cold._seg_of.values()}):
                src = self.cold._path(seg)
                dst = os.path.join(cold_dir, os.path.basename(src))
                if os.path.normpath(src) != os.path.normpath(dst):
                    tmp = f"{dst}.tmp-{os.getpid()}"
                    shutil.copyfile(src, tmp)
                    os.replace(tmp, dst)
        manifest = {
            "row_shape": list(self.row_shape),
            "dtype": dtype_name(self.dtype),
            "host_dtype": str(self.warm.data.dtype),
            "sharded": self.sharded,
            "n_shards": self.hot.n_shards if self.sharded else 1,
            "hot_capacity": self.hot_capacity,
            "warm_capacity": self.warm_capacity,
            "has_cold": self.cold is not None,
            "policy": {"name": self.policy.name, "state": self.policy.state()},
            "stats": dataclasses.asdict(self.stats),
            "hot_index": hot_state["index"],
            "warm_index": warm_state["index"],
            "cold_index": cold_index,
        }
        _atomic_json(os.path.join(dir, "manifest.json"), manifest)
        return dir

    @classmethod
    def restore(cls, dir: str, mesh: Any = None, store_dir: Optional[str] = None,
                device: DeviceLike = "cuda") -> "TieredTableStore":
        """Rebuild a store from ``snapshot(dir)`` on ``device``. A sharded
        snapshot needs a ``mesh`` with the same shard count. By default
        the snapshot's own ``cold/`` directory becomes the live cold store
        (the snapshot IS the durable state); pass ``store_dir`` to relocate
        (segments copied)."""
        with open(os.path.join(dir, "manifest.json")) as f:
            man = json.load(f)
        if man["sharded"] and mesh is None:
            raise ValueError("snapshot was sharded; restore needs a mesh")
        if not man["sharded"] and mesh is not None:
            raise ValueError("snapshot was single-device; mesh given")
        G, U, d = man["row_shape"]
        dtype = resolve_table_dtype(man["dtype"])
        if man["host_dtype"] != str(host_dtype(dtype)):
            raise ValueError(f"snapshot holds {man['dtype']} rows as "
                             f"{man['host_dtype']}, expected {host_dtype(dtype)}")
        target = None
        if man["has_cold"]:
            src_dir = os.path.join(dir, "cold")
            target = store_dir or src_dir
            if os.path.normpath(target) != os.path.normpath(src_dir):
                os.makedirs(target, exist_ok=True)
                for u, seg, _ in man["cold_index"]:
                    name = f"seg_{int(seg):08d}.npz"
                    dst = os.path.join(target, name)
                    if not os.path.exists(dst):
                        tmp = f"{dst}.tmp-{os.getpid()}"
                        shutil.copyfile(os.path.join(src_dir, name), tmp)
                        os.replace(tmp, dst)
        elif store_dir is not None:
            target = store_dir
        store = cls(G, U, d, hot_capacity=man["hot_capacity"], dtype=dtype, mesh=mesh,
                    policy=man["policy"]["name"], store_dir=target,
                    warm_capacity=man["warm_capacity"], device=device)
        if man["sharded"] and store.hot.n_shards != man["n_shards"]:
            raise ValueError(f"snapshot has {man['n_shards']} shards, mesh "
                             f"has {store.hot.n_shards}")
        with np.load(os.path.join(dir, "tiers.npz")) as z:
            hot_state = {"data": z["hot"], "index": man["hot_index"]}
            warm_state = {"data": z["warm"], "index": man["warm_index"]}
            if store.hot.quantized:
                hot_state["scales"] = z["hot_scales"]
                warm_state["scales"] = z["warm_scales"]
            store.hot.load_host_state(hot_state)
            store.warm.load_host_state(warm_state)
        if man["has_cold"] and man["cold_index"]:
            store.cold.load_index_state(man["cold_index"])
        store.policy.load_state(man["policy"]["state"])
        store.stats = TierStats(**man["stats"])
        return store
