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

The sharded store is not ported yet.
"""
from __future__ import annotations

import warnings
from typing import Any, Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
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
        n = int(np.prod(self.row_shape)) * self.data.element_size()
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
