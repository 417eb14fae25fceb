"""TableStore — contiguous multi-user BSE state (paper §4.4 at scale).

Counterpart of ``repro/serve/table_store.py::TableStore``: one contiguous
``(N, G, U, d)`` device tensor of per-user bucket tables plus a host-side
user → slot index with amortized-doubling growth and slot recycling on
eviction. Storage dtype fp32 (default), bf16, or int8/fp8 with a parallel
``(N, G, U)`` fp32 ``scales`` tensor: quantized stores quantize on
``write`` (non-finite rows zeroed and counted in ``n_nonfinite``) and
dequantize on ``rows``; bf16 stores take a saturating cast on ``write``
(counted in ``n_saturated``). ``rows_raw``/``write_raw`` move stored bytes
verbatim (tier movement must be bit-exact).

Writes. JAX arrays are immutable, so the reference's scatters return new
arrays (donating the old buffer unless ``donate_writes`` is off). Here a
write indexes into the tensor IN PLACE by default. ``donate_writes=False``
(set by the async ingest runtime, ``serve/ingest.py``) makes writes copy on
write: once a committed reader view holds the tensors (``share``), the next
write clones ``data`` (and ``scales``), rebinds them and writes in place
from then on, so a tensor that a view holds never changes and the store
clones at most once between two commits, however many writes (a demotion's
zero-scatter, a promotion, a fold) fall between them. Under copy on write
on CUDA the store also tells the caching allocator which stream reads each
tensor (``record_stream``), so memory a read on another stream still uses
is not handed out again.

Host copies. numpy has no bf16 or fp8, so ``host_state``/``load_host_state``
and the tiered store's host tiers hold such payloads as their raw bits
(int16 / uint8; ``to_host`` / ``from_host``); fp32 and int8 stay as they are.

``ShardedTableStore`` is the same contract partitioned by slot over the
model axis of a ``MeshCtx`` (``distributed/mesh_ctx.py``): shard k keeps a
``(C, G, U, d)`` block (and ``(C, G, U)`` scales) on the mesh's device k, a
slot handle is a ``(shard, local)`` pair, new users go to the shard with
the most free slots, and every shard doubles at once. Its rows assemble on
the store's ``device`` (the server's); the engine's sharded dispatches
(``core/engine.py``) launch one kernel per shard.
"""
from __future__ import annotations

import warnings
from typing import Any, Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.mesh_ctx import MeshCtx, canonical, owned
from repro_torch.serve.quant import (_range, dequantize_rows, is_quantized,
                                     quantize_rows_checked, resolve_table_dtype,
                                     saturate_cast)

# numpy has no bf16 or fp8: host copies of such payloads hold their raw bits
_HOST_BITS = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8}


def host_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a host copy of ``dtype`` payload is held in."""
    return torch.empty((), dtype=_HOST_BITS.get(dtype, dtype)).numpy().dtype


def to_host(t: torch.Tensor) -> np.ndarray:
    """Stored values -> a numpy copy on the host, bf16/fp8 as raw bits. A
    synchronous copy: the caller may reuse or free the device memory
    after it returns."""
    bits = _HOST_BITS.get(t.dtype)
    t = t.detach() if bits is None else t.detach().view(bits)
    return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()


def from_host(a: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Inverse of ``to_host``: a fresh ``device`` tensor of storage dtype
    ``dtype`` from a host array (raw bits for bf16/fp8), copied
    synchronously, so the host buffer may be reused at once."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    bits = _HOST_BITS.get(dtype)
    if t.dtype != (dtype if bits is None else bits):
        raise TypeError(f"host array of {a.dtype} for a {dtype} store")
    t = t.to(device, copy=True)
    return t if bits is None else t.view(dtype)


class TableStore:
    sharded = False
    # accounting seam: a serve/profiler.MemoryLedger sets both on attach;
    # the event sites below report allocation deltas and traffic through it
    ledger = None
    _ledger_key = None

    def __init__(self, n_groups: int, n_buckets: int, d: int, capacity: int = 64,
                 dtype: Any = torch.float32, device: DeviceLike = "cuda"):
        assert capacity >= 1
        self.device = resolve_device(device)
        self.row_shape = (n_groups, n_buckets, d)
        self.dtype = resolve_table_dtype(dtype)
        self.quantized = is_quantized(self.dtype)
        self._check_range = not self.quantized and _range(self.dtype) is not None
        self.data = torch.zeros((capacity, *self.row_shape), dtype=self.dtype,
                                device=self.device)
        # one fp32 scale per (G, U) bucket row (see serve/quant.py)
        self.scales = (torch.zeros((capacity, n_groups, n_buckets), dtype=torch.float32,
                                   device=self.device) if self.quantized else None)
        self._slot_of: dict[Any, int] = {}
        self._user_of: dict[int, Any] = {}
        self._free = list(range(capacity - 1, -1, -1))
        self.n_grows = 0
        self.n_evictions = 0
        self.n_saturated = 0
        self.n_nonfinite = 0
        # False = copy-on-write writes (async ingest's committed views)
        self.donate_writes = True
        self._shared = False        # a committed view holds data/scales

    def _nbytes(self) -> int:
        """Bytes this store holds on its device right now (the ledger's
        ground truth)."""
        n = self.data.numel() * self.data.element_size()
        if self.quantized:
            n += self.scales.numel() * self.scales.element_size()
        return n

    def _use(self, *tensors: Optional[torch.Tensor]) -> None:
        """Under copy on write on CUDA: mark ``tensors`` as read on the
        current stream, so the caching allocator does not reuse their
        memory while that read may still be in flight."""
        if self.donate_writes or self.device.type != "cuda":
            return
        stream = torch.cuda.current_stream(self.device)
        for t in tensors:
            if t is not None:
                t.record_stream(stream)

    def share(self) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The (data, scales) a committed reader view holds from now on.
        Under copy on write the next write clones them first."""
        self._shared = not self.donate_writes
        return self.data, self.scales

    def writable(self) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The (data, scales) a write goes into in place: the store's own
        tensors, cloned and rebound first if a view holds them."""
        if self._shared:
            self._use(self.data, self.scales)
            self.data = self.data.clone()
            if self.scales is not None:
                self.scales = self.scales.clone()
            self._shared = False
        return self.data, self.scales

    def _note_saturation(self, n: int) -> None:
        if n and not self.n_saturated:
            warnings.warn(f"TableStore({self.dtype}): {n} value(s) outside the "
                          f"storage dtype's range were saturated (see n_saturated)",
                          stacklevel=3)
        self.n_saturated += n

    def _note_nonfinite(self, n: int) -> None:
        if n and not self.n_nonfinite:
            warnings.warn(f"TableStore({self.dtype}): {n} row(s) containing inf/NaN "
                          "were zeroed on write (see n_nonfinite)", stacklevel=3)
        self.n_nonfinite += n

    def _index(self, slots) -> torch.Tensor:
        return torch.as_tensor(np.asarray(slots, np.int64), device=self.device)

    # ------------------------------------------------------------------
    # index
    # ------------------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    def __len__(self) -> int:
        return len(self._slot_of)

    def __contains__(self, user: Any) -> bool:
        return user in self._slot_of

    def users(self) -> Iterator[Any]:
        return iter(self._slot_of)

    def slot(self, user: Any) -> Optional[int]:
        return self._slot_of.get(user)

    def slots(self, users: Sequence[Any]) -> np.ndarray:
        """Slots of known users; raises KeyError naming the unknown ones."""
        missing = [u for u in users if u not in self._slot_of]
        if missing:
            raise KeyError(f"users not in table store: {missing}")
        return np.asarray([self._slot_of[u] for u in users], np.int32)

    def lookup(self, users: Sequence[Any]) -> tuple[np.ndarray, np.ndarray]:
        """Miss-tolerant ``slots``: unknown users get slot 0 (always a valid
        gather index) and ``present=False``."""
        present = np.asarray([u in self._slot_of for u in users], bool)
        slots = np.asarray([self._slot_of.get(u, 0) for u in users], np.int32)
        return slots, present

    def assign(self, users: Sequence[Any]) -> np.ndarray:
        """Slots for ``users``, allocating for unknown ones (doubling the
        tensor when the free list runs dry). Duplicate users share one slot;
        fresh slots read all-zero."""
        need = len({u for u in users if u not in self._slot_of})
        while len(self._free) < need:
            self._grow()
        slots = []
        for u in users:
            s = self._slot_of.get(u)
            if s is None:
                s = self._free.pop()
                self._slot_of[u] = s
                self._user_of[s] = u
            slots.append(s)
        return np.asarray(slots, np.int32)

    def assign_fresh(self, users: Sequence[Any]) -> np.ndarray:
        """``assign`` for callers about to overwrite every row wholesale
        (full re-encode). Here an alias; the tiered store overrides it to
        skip promoting rows that would be thrown away."""
        return self.assign(users)

    def _grow(self) -> None:
        cap = self.capacity
        old = self._nbytes()
        self._use(self.data, self.scales)
        self.data = torch.cat([self.data, torch.zeros_like(self.data)])
        if self.quantized:
            self.scales = torch.cat([self.scales, torch.zeros_like(self.scales)])
        self._free[:0] = range(2 * cap - 1, cap - 1, -1)
        self._shared = False
        self.n_grows += 1
        if self.ledger is not None:
            self.ledger.add(self._ledger_key, self._nbytes() - old, "grow")

    def evict(self, user: Any) -> bool:
        """Drop a user; the zeroed slot is recycled by the next allocation."""
        return self.evict_many([user]) == 1

    def evict_many(self, users: Sequence[Any]) -> int:
        """Batched evict: known users' slots zeroed in one write and
        recycled; unknown users ignored, duplicates deduped. Returns the
        evicted count."""
        known = [u for u in dict.fromkeys(users) if u in self._slot_of]
        if not known:
            return 0
        self.write(self.slots(known),
                   torch.zeros((len(known), *self.row_shape), dtype=torch.float32,
                               device=self.device))
        for u in known:
            s = self._slot_of.pop(u)
            del self._user_of[s]
            self._free.append(s)
        self.n_evictions += len(known)
        if self.ledger is not None:
            self.ledger.count("evict", len(known))
        return len(known)

    def clear(self) -> None:
        """Invalidate everything (model push): index emptied, tensors replaced
        by zeros (a committed view keeps the old ones), growth/eviction
        counters reset."""
        self._slot_of.clear()
        self._user_of.clear()
        self._free = list(range(self.capacity - 1, -1, -1))
        self.data = torch.zeros_like(self.data)
        if self.quantized:
            self.scales = torch.zeros_like(self.scales)
        self._shared = False
        self.n_grows = 0
        self.n_evictions = 0
        if self.ledger is not None:   # same-shape zeroing: the allocation keeps
            self.ledger.count("clear")

    # ------------------------------------------------------------------
    # rows
    # ------------------------------------------------------------------
    def rows(self, slots: Sequence[int]) -> torch.Tensor:
        """One gather: (B,) slots -> (B, G, U, d). Quantized stores
        dequantize, so callers see fp32 rows."""
        idx = self._index(slots)
        self._use(self.data, self.scales)
        if self.quantized:
            return dequantize_rows(self.data[idx], self.scales[idx])
        return self.data[idx]

    def row(self, user: Any) -> Optional[torch.Tensor]:
        """One user's (G, U, d) row (dequantized for quantized stores), or
        None for a user the store does not hold."""
        s = self._slot_of.get(user)
        return None if s is None else self.rows([s])[0]

    def write(self, slots: Sequence[int], rows: torch.Tensor) -> None:
        """Overwrite (B,) slots with rows (B, G, U, d): quantize on write
        for int8/fp8 stores, a saturating cast for bf16. In place, or copy
        on write with ``donate_writes`` off."""
        idx = self._index(slots)
        if self.quantized:
            payload, row_scales, n_bad = quantize_rows_checked(rows, dtype=self.dtype)
            self._note_nonfinite(int(n_bad))
            data, scales = self.writable()
            data[idx] = payload
            scales[idx] = row_scales
            if self.ledger is not None:
                self.ledger.count("quantize", len(idx))
            return
        if self._check_range:
            rows, n = saturate_cast(rows, dtype=self.dtype)
            self._note_saturation(int(n))
        self.writable()[0][idx] = rows.to(self.dtype)

    # ------------------------------------------------------------------
    # raw-byte seam (tier movement must be bit-exact)
    # ------------------------------------------------------------------
    def rows_raw(self, slots) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(B,) slots -> (payload in the STORAGE dtype, scales or None)."""
        idx = self._index(slots)
        self._use(self.data, self.scales)
        return self.data[idx], (self.scales[idx] if self.quantized else None)

    def write_raw(self, slots, payload: torch.Tensor,
                  scales: Optional[torch.Tensor] = None) -> None:
        """Inverse of ``rows_raw``: stored bytes written back verbatim."""
        idx = self._index(slots)
        if payload.dtype != self.dtype:
            raise TypeError(f"write_raw: payload {payload.dtype} into a "
                            f"{self.dtype} store")
        if self.quantized != (scales is not None):
            raise ValueError("write_raw: scales go with quantized stores only")
        data, store_scales = self.writable()
        data[idx] = payload.to(self.device)
        if self.quantized:
            store_scales[idx] = scales.to(self.device, torch.float32)

    def row_nbytes(self) -> int:
        """Stored bytes per user row: payload + (quantized) its scales."""
        n = int(np.prod(self.row_shape)) * self.dtype.itemsize
        if self.quantized:
            n += int(np.prod(self.row_shape[:-1])) * 4
        return n

    # ------------------------------------------------------------------
    # serialization seam (tiered snapshot/restore)
    # ------------------------------------------------------------------
    def host_state(self) -> dict:
        """Full store state as host objects: the payload (one device→host
        copy; bf16/fp8 as raw bits) plus the user→slot index as a json-able
        list of pairs (quantized stores add the scales)."""
        self._use(self.data, self.scales)
        state = {"data": to_host(self.data),
                 "index": [[u, int(s)] for u, s in self._slot_of.items()]}
        if self.quantized:
            state["scales"] = to_host(self.scales)
        return state

    def load_host_state(self, state: dict) -> None:
        """Inverse of ``host_state``: replaces tensors and index wholesale.
        The free list is rebuilt as the complement of the indexed slots, so
        a restored store allocates exactly like the snapshotted one."""
        data = np.asarray(state["data"])
        if tuple(data.shape[1:]) != self.row_shape:
            raise ValueError(f"host state rows {data.shape[1:]}, store rows {self.row_shape}")
        old = self._nbytes()
        self.data = from_host(data, self.dtype, self.device)
        if self.quantized:
            self.scales = from_host(np.asarray(state["scales"], np.float32),
                                    torch.float32, self.device)
        self._shared = False
        self._slot_of = {u: int(s) for u, s in state["index"]}
        self._user_of = {s: u for u, s in self._slot_of.items()}
        self._free = [s for s in range(self.capacity - 1, -1, -1)
                      if s not in self._user_of]
        if self.ledger is not None:   # wholesale replace: the shape may differ
            self.ledger.add(self._ledger_key, self._nbytes() - old, "restore")


# ---------------------------------------------------------------------------
# sharded store: one (C, G, U, d) block per shard of the mesh's model axis
# ---------------------------------------------------------------------------
def gather_rows(blocks: Sequence[torch.Tensor], scale_blocks: Optional[Sequence[torch.Tensor]],
                handles: np.ndarray, device: torch.device
                ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The rows of (B, 2) ``[shard, local]`` handles out of per-shard
    blocks, assembled on ``device`` in the STORAGE dtype (with their scales
    for a quantized store). Each row is copied from the one shard that owns
    it: the reference sums the masked rows of every shard (a psum; integer
    payloads in int32), which gives the same values."""
    B = handles.shape[0]
    out = torch.empty((B, *blocks[0].shape[1:]), dtype=blocks[0].dtype, device=device)
    sc = (None if scale_blocks is None else
          torch.empty((B, *scale_blocks[0].shape[1:]), dtype=torch.float32, device=device))
    for k, block in enumerate(blocks):
        mine, local = owned(handles, k)
        if not mine.any():
            continue
        pos = torch.as_tensor(np.flatnonzero(mine), device=device)
        lo = torch.as_tensor(local[mine], dtype=torch.int64, device=block.device)
        out[pos] = block[lo].to(device)
        if sc is not None:
            sc[pos] = scale_blocks[k][lo].to(device)
    return out, sc


class ShardedTableStore:
    """``TableStore`` partitioned by slot over the model axis of a mesh
    (``MeshCtx`` or a sequence of devices). Same contract, two changes of
    representation, as in the reference:

      * shard k keeps its own ``(C, G, U, d)`` block on model device k
        (``blocks``; ``data`` is the tuple of them), plus ``(C, G, U)`` fp32
        scales for int8/fp8 (``scale_blocks``); global capacity is ``S·C``
        and grows by doubling every shard's ``C`` at once;
      * a slot handle is a ``(shard, local)`` pair: ``assign``/``slots``/
        ``lookup`` return a (B, 2) int32 array that ``rows``/``write`` and
        ``SDIMEngine.update_sharded``/``serve_fused_sharded`` take. New users
        go to the shard with the most free slots (the first such shard), so
        occupancy stays balanced within ±1; each shard recycles its own
        evicted slots.

    Rows gathered by ``rows``/``rows_raw`` assemble on ``device`` (default:
    shard 0's). Copy on write (``donate_writes=False``) is per shard: after
    ``share()``, a write clones only the blocks it writes to.
    """

    sharded = True
    # accounting seam: a serve/profiler.MemoryLedger sets both on attach
    ledger = None
    _ledger_key = None

    def __init__(self, n_groups: int, n_buckets: int, d: int, mesh, capacity: int = 64,
                 dtype: Any = torch.float32, device: DeviceLike = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.mesh_ctx = MeshCtx.wrap(mesh)
        if self.mesh_ctx is None:
            raise ValueError("a sharded store needs a mesh (a MeshCtx or a device list)")
        self.devices = tuple(resolve_device(dev) for dev in self.mesh_ctx.devices)
        self.device = self.devices[0] if device is None else canonical(resolve_device(device))
        self.row_shape = (n_groups, n_buckets, d)
        self.dtype = resolve_table_dtype(dtype)
        self.quantized = is_quantized(self.dtype)
        self._check_range = not self.quantized and _range(self.dtype) is not None
        S = self.n_shards
        per = max(1, -(-capacity // S))                     # ceil; >= 1 a shard
        self.blocks = [torch.zeros((per, *self.row_shape), dtype=self.dtype, device=dev)
                       for dev in self.devices]
        self.scale_blocks = ([torch.zeros((per, n_groups, n_buckets), dtype=torch.float32,
                                          device=dev) for dev in self.devices]
                             if self.quantized else None)
        self._slot_of: dict[Any, tuple[int, int]] = {}
        self._user_of: dict[tuple[int, int], Any] = {}
        self._free = [list(range(per - 1, -1, -1)) for _ in range(S)]
        self.n_grows = 0
        self.n_evictions = 0
        self.n_saturated = 0
        self.n_nonfinite = 0
        self.donate_writes = True
        self._shared = [False] * S      # a committed view holds shard k's block

    _note_saturation = TableStore._note_saturation
    _note_nonfinite = TableStore._note_nonfinite
    row_nbytes = TableStore.row_nbytes

    def _nbytes(self) -> int:
        """Bytes the blocks (and scales) hold on their devices right now."""
        n = sum(b.numel() * b.element_size() for b in self.blocks)
        if self.quantized:
            n += sum(s.numel() * s.element_size() for s in self.scale_blocks)
        return n

    def _use(self, tensors) -> None:
        """Under copy on write, mark CUDA ``tensors`` as read on their
        device's current stream (see ``TableStore._use``)."""
        if self.donate_writes:
            return
        for t in tensors:
            if t.device.type == "cuda":
                t.record_stream(torch.cuda.current_stream(t.device))

    def _tensors(self, k: int) -> list:
        return [self.blocks[k]] + ([self.scale_blocks[k]] if self.quantized else [])

    @property
    def data(self) -> tuple:
        return tuple(self.blocks)

    @property
    def scales(self) -> Optional[tuple]:
        return None if self.scale_blocks is None else tuple(self.scale_blocks)

    def share(self) -> tuple[tuple, Optional[tuple]]:
        """The (blocks, scale blocks) a committed view holds from now on.
        Under copy on write, a later write clones each block it writes to
        once."""
        self._shared = [not self.donate_writes] * self.n_shards
        return self.data, self.scales

    def writable(self, shards: Optional[Sequence[int]] = None) -> tuple[list, Optional[list]]:
        """The blocks (and scale blocks) a write goes into in place: the
        store's own, with each of ``shards`` (default: every shard) that a
        view holds cloned and rebound first."""
        for k in range(self.n_shards) if shards is None else shards:
            if self._shared[k]:
                self._use(self._tensors(k))
                self.blocks[k] = self.blocks[k].clone()
                if self.quantized:
                    self.scale_blocks[k] = self.scale_blocks[k].clone()
                self._shared[k] = False
        return self.blocks, self.scale_blocks

    # ------------------------------------------------------------------
    # index
    # ------------------------------------------------------------------
    @property
    def n_shards(self) -> int:
        return self.mesh_ctx.n_shards

    @property
    def per_shard_capacity(self) -> int:
        return self.blocks[0].shape[0]

    @property
    def capacity(self) -> int:
        return self.n_shards * self.per_shard_capacity

    def __len__(self) -> int:
        return len(self._slot_of)

    def __contains__(self, user: Any) -> bool:
        return user in self._slot_of

    def users(self) -> Iterator[Any]:
        return iter(self._slot_of)

    def slot(self, user: Any) -> Optional[tuple[int, int]]:
        return self._slot_of.get(user)

    def shard_load(self) -> list[int]:
        """Live users per shard (balanced within ±1 by ``assign``)."""
        per = self.per_shard_capacity
        return [per - len(f) for f in self._free]

    def shards_of(self, handles) -> list[int]:
        """The shards that own at least one of (B, 2) ``handles``."""
        return sorted({int(k) for k in np.asarray(handles).reshape(-1, 2)[:, 0]})

    def slots(self, users: Sequence[Any]) -> np.ndarray:
        """(B, 2) [shard, local] handles; KeyError names unknown users."""
        missing = [u for u in users if u not in self._slot_of]
        if missing:
            raise KeyError(f"users not in table store: {missing}")
        return np.asarray([self._slot_of[u] for u in users], np.int32).reshape(-1, 2)

    def lookup(self, users: Sequence[Any]) -> tuple[np.ndarray, np.ndarray]:
        """Miss-tolerant ``slots``: unknown users get handle (0, 0) and
        ``present=False``."""
        present = np.asarray([u in self._slot_of for u in users], bool)
        slots = np.asarray([self._slot_of.get(u, (0, 0)) for u in users],
                           np.int32).reshape(-1, 2)
        return slots, present

    def assign(self, users: Sequence[Any]) -> np.ndarray:
        """(B, 2) handles for ``users``, allocating unknown ones on the
        shard with the most free slots (doubling every shard when all free
        lists are empty). Duplicate users share one handle; fresh slots
        read all-zero."""
        for u in users:
            if u in self._slot_of:
                continue
            k = max(range(self.n_shards), key=lambda i: len(self._free[i]))
            if not self._free[k]:
                self.grow()
            s = (k, self._free[k].pop())
            self._slot_of[u] = s
            self._user_of[s] = u
        return np.asarray([self._slot_of[u] for u in users], np.int32).reshape(-1, 2)

    def assign_fresh(self, users: Sequence[Any]) -> np.ndarray:
        """``assign`` for full-overwrite callers (see ``TableStore``)."""
        return self.assign(users)

    def grow(self) -> None:
        """Double every shard's block at once (no rows move between
        shards, so every handle stays valid)."""
        per = self.per_shard_capacity
        old = self._nbytes()
        for k in range(self.n_shards):
            self._use(self._tensors(k))
        self.blocks = [torch.cat([b, torch.zeros_like(b)]) for b in self.blocks]
        if self.quantized:
            self.scale_blocks = [torch.cat([s, torch.zeros_like(s)])
                                 for s in self.scale_blocks]
        for f in self._free:
            f[:0] = range(2 * per - 1, per - 1, -1)
        self._shared = [False] * self.n_shards
        self.n_grows += 1
        if self.ledger is not None:
            self.ledger.add(self._ledger_key, self._nbytes() - old, "grow")

    def evict(self, user: Any) -> bool:
        """Drop a user; the zeroed slot is recycled by its shard."""
        return self.evict_many([user]) == 1

    def evict_many(self, users: Sequence[Any]) -> int:
        """Batched evict: known users' slots zeroed in one write and
        recycled; unknown users ignored, duplicates deduped. Returns the
        evicted count."""
        known = [u for u in dict.fromkeys(users) if u in self._slot_of]
        if not known:
            return 0
        self.write(self.slots(known),
                   torch.zeros((len(known), *self.row_shape), dtype=torch.float32,
                               device=self.device))
        for u in known:
            s = self._slot_of.pop(u)
            del self._user_of[s]
            self._free[s[0]].append(s[1])
        self.n_evictions += len(known)
        if self.ledger is not None:
            self.ledger.count("evict", len(known))
        return len(known)

    def clear(self) -> None:
        """Invalidate everything (model push): index emptied, blocks
        replaced by zeros (a committed view keeps the old ones), growth and
        eviction counters reset."""
        per = self.per_shard_capacity
        self._slot_of.clear()
        self._user_of.clear()
        self._free = [list(range(per - 1, -1, -1)) for _ in range(self.n_shards)]
        self.blocks = [torch.zeros_like(b) for b in self.blocks]
        if self.quantized:
            self.scale_blocks = [torch.zeros_like(s) for s in self.scale_blocks]
        self._shared = [False] * self.n_shards
        self.n_grows = 0
        self.n_evictions = 0
        if self.ledger is not None:   # same-shape zeroing: the allocation keeps
            self.ledger.count("clear")

    # ------------------------------------------------------------------
    # rows
    # ------------------------------------------------------------------
    def _handles(self, slots) -> np.ndarray:
        """(B, 2) handles from the host, range-checked there."""
        h = np.asarray(slots.cpu() if isinstance(slots, torch.Tensor) else slots,
                       np.int64).reshape(-1, 2)
        if h.size and (h[:, 0].min() < 0 or h[:, 0].max() >= self.n_shards
                       or h[:, 1].min() < 0 or h[:, 1].max() >= self.per_shard_capacity):
            raise IndexError(f"handles outside [0, {self.n_shards}) x "
                             f"[0, {self.per_shard_capacity})")
        return h

    def rows_raw(self, slots) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(B, 2) handles -> (payload in the STORAGE dtype, scales or None)
        on ``device``."""
        h = self._handles(slots)
        for k in self.shards_of(h):
            self._use(self._tensors(k))
        return gather_rows(self.blocks, self.scale_blocks, h, self.device)

    def rows(self, slots) -> torch.Tensor:
        """(B, 2) handles -> (B, G, U, d) on ``device``; quantized stores
        dequantize, so callers see fp32 rows."""
        payload, scales = self.rows_raw(slots)
        return dequantize_rows(payload, scales) if self.quantized else payload

    def row(self, user: Any) -> Optional[torch.Tensor]:
        s = self._slot_of.get(user)
        return None if s is None else self.rows(np.asarray([s], np.int32))[0]

    def _scatter(self, h: np.ndarray, payload: torch.Tensor,
                 scales: Optional[torch.Tensor]) -> None:
        """Write each row of ``payload`` (and ``scales``) into the block of
        the shard that owns its handle; only owned rows are written."""
        for k in self.shards_of(h):
            mine, local = owned(h, k)
            blocks, scale_blocks = self.writable([k])
            dev = blocks[k].device
            pos = torch.as_tensor(np.flatnonzero(mine), device=payload.device)
            lo = torch.as_tensor(local[mine], dtype=torch.int64, device=dev)
            blocks[k][lo] = payload[pos].to(dev)
            if scales is not None:
                scale_blocks[k][lo] = scales[pos].to(dev, torch.float32)

    def write(self, slots, rows: torch.Tensor) -> None:
        """Overwrite (B, 2) handles with rows (B, G, U, d): quantize on
        write for int8/fp8, a saturating cast for bf16, as ``TableStore``."""
        h = self._handles(slots)
        if self.quantized:
            payload, row_scales, n_bad = quantize_rows_checked(rows, dtype=self.dtype)
            self._note_nonfinite(int(n_bad))
            self._scatter(h, payload, row_scales)
            if self.ledger is not None:
                self.ledger.count("quantize", len(h))
            return
        if self._check_range:
            rows, n = saturate_cast(rows, dtype=self.dtype)
            self._note_saturation(int(n))
        self._scatter(h, rows.to(self.dtype), None)

    def write_raw(self, slots, payload: torch.Tensor,
                  scales: Optional[torch.Tensor] = None) -> None:
        """Inverse of ``rows_raw``: stored bytes written back verbatim."""
        if payload.dtype != self.dtype:
            raise TypeError(f"write_raw: payload {payload.dtype} into a {self.dtype} store")
        if self.quantized != (scales is not None):
            raise ValueError("write_raw: scales go with quantized stores only")
        self._scatter(self._handles(slots), payload, scales)

    # ------------------------------------------------------------------
    # serialization seam (tiered snapshot/restore)
    # ------------------------------------------------------------------
    def host_state(self) -> dict:
        """Full store state as host objects: the (S, C, G, U, d) payload
        (bf16/fp8 as raw bits) plus the user → (shard, local) index as
        json-able pairs (quantized stores add the (S, C, G, U) scales)."""
        for k in range(self.n_shards):
            self._use(self._tensors(k))
        state = {"data": np.stack([to_host(b) for b in self.blocks]),
                 "index": [[u, [int(s[0]), int(s[1])]] for u, s in self._slot_of.items()]}
        if self.quantized:
            state["scales"] = np.stack([to_host(s) for s in self.scale_blocks])
        return state

    def load_host_state(self, state: dict) -> None:
        """Inverse of ``host_state``: blocks and index replaced wholesale.
        The payload must have this store's shard count; each shard's free
        list is rebuilt as the complement of its indexed handles."""
        data = np.asarray(state["data"])
        if data.ndim != 5 or data.shape[0] != self.n_shards \
                or tuple(data.shape[2:]) != self.row_shape:
            raise ValueError(f"host state {data.shape}, store of {self.n_shards} shards of "
                             f"rows {self.row_shape}")
        old = self._nbytes()
        self.blocks = [from_host(data[k], self.dtype, dev) for k, dev in enumerate(self.devices)]
        if self.quantized:
            scales = np.asarray(state["scales"], np.float32)
            self.scale_blocks = [from_host(scales[k], torch.float32, dev)
                                 for k, dev in enumerate(self.devices)]
        self._shared = [False] * self.n_shards
        self._slot_of = {u: (int(s[0]), int(s[1])) for u, s in state["index"]}
        self._user_of = {s: u for u, s in self._slot_of.items()}
        per = self.per_shard_capacity
        self._free = [[l for l in range(per - 1, -1, -1) if (k, l) not in self._user_of]
                      for k in range(self.n_shards)]
        if self.ledger is not None:   # wholesale replace: the shape may differ
            self.ledger.add(self._ledger_key, self._nbytes() - old, "restore")
