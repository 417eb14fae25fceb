"""TableStore — contiguous multi-user BSE state (paper §4.4 at scale).

Counterpart of ``repro/serve/table_store.py::TableStore``: one contiguous
``(N, G, U, d)`` device tensor of per-user bucket tables plus a host-side
user → slot index with amortized-doubling growth and slot recycling on
eviction. Storage dtype fp32 (default), bf16, or int8 with a parallel
``(N, G, U)`` fp32 ``scales`` tensor: quantized stores quantize on
``write`` (non-finite rows zeroed and counted in ``n_nonfinite``) and
dequantize on ``rows``; bf16 stores take a saturating cast on ``write``
(counted in ``n_saturated``). ``rows_raw``/``write_raw`` move stored bytes
verbatim. Writes index into the tensor in place.

The sharded store, the memory ledger and host snapshots are not ported yet.
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


class TableStore:
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

    def _grow(self) -> None:
        cap = self.capacity
        self.data = torch.cat([self.data, torch.zeros_like(self.data)])
        if self.quantized:
            self.scales = torch.cat([self.scales, torch.zeros_like(self.scales)])
        self._free[:0] = range(2 * cap - 1, cap - 1, -1)
        self.n_grows += 1

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
        return len(known)

    def clear(self) -> None:
        """Invalidate everything (model push): index emptied, tensor zeroed,
        growth/eviction counters reset."""
        self._slot_of.clear()
        self._user_of.clear()
        self._free = list(range(self.capacity - 1, -1, -1))
        self.data.zero_()
        if self.quantized:
            self.scales.zero_()
        self.n_grows = 0
        self.n_evictions = 0

    # ------------------------------------------------------------------
    # rows
    # ------------------------------------------------------------------
    def rows(self, slots: Sequence[int]) -> torch.Tensor:
        """One gather: (B,) slots -> (B, G, U, d). Quantized stores
        dequantize, so callers see fp32 rows."""
        idx = self._index(slots)
        if self.quantized:
            return dequantize_rows(self.data[idx], self.scales[idx])
        return self.data[idx]

    def write(self, slots: Sequence[int], rows: torch.Tensor) -> None:
        """Overwrite (B,) slots with rows (B, G, U, d) in place: quantize on
        write for int8 stores, a saturating cast for bf16."""
        idx = self._index(slots)
        if self.quantized:
            payload, row_scales, n_bad = quantize_rows_checked(rows, dtype=self.dtype)
            self._note_nonfinite(int(n_bad))
            self.data[idx] = payload
            self.scales[idx] = row_scales
            return
        if self._check_range:
            rows, n = saturate_cast(rows, dtype=self.dtype)
            self._note_saturation(int(n))
        self.data[idx] = rows.to(self.dtype)

    # ------------------------------------------------------------------
    # raw-byte seam (tier movement must be bit-exact)
    # ------------------------------------------------------------------
    def rows_raw(self, slots) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(B,) slots -> (payload in the STORAGE dtype, scales or None)."""
        idx = self._index(slots)
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
        self.data[idx] = payload.to(self.device)
        if self.quantized:
            self.scales[idx] = scales.to(self.device, torch.float32)

    def row_nbytes(self) -> int:
        """Stored bytes per user row: payload + (quantized) its scales."""
        n = int(np.prod(self.row_shape)) * self.data.element_size()
        if self.quantized:
            n += int(np.prod(self.row_shape[:-1])) * 4
        return n
