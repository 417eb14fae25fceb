"""sdim_update: fold event behaviors into rows of the table store, in place.

Wrapper of the CUDA kernel ``csrc/sdim_update.cu`` (which replaces the Pallas
kernel ``repro/kernels/sdim_update/sdim_update.py:77``) and its plain
PyTorch version ``sdim_update_ref``. The JAX version returns a new store
(its caller donates the old buffer); both versions here write the fp32
store IN PLACE and return it. Duplicate slots accumulate; a row whose mask
is all zero writes nothing. The wrapper runs the plain version for CPU
tensors only; for CUDA tensors it launches the kernel or raises.
``sdim_update.launches`` counts kernel launches. The kernel splits each
batch row's signature groups over ``update_splits`` CTAs; the first batch
row of each slot owns it and folds every batch row of that slot in b order,
so no two CTAs write one element (no atomics) and two launches agree bit
for bit. tau 5..10 (32..1,024 buckets a group) launch the large-tau path
(``csrc/sdim_update_large_tau.cu``: a CTA a (batch row, group) sorts its
slot's events by bucket in shared memory and reads and writes only the
cells they reach, with the same contracts; any E: rows of more than
``UPDATE_LT_MAX_E`` events are taken in chunks of that many, each cell's
partial row sum carried from chunk to chunk in a device scratch that the
wrapper allocates on that path only, ``update_large_tau_path``). Rows
wider than ``MAX_REG_D`` (d > 128: a CTA of the tau <= 4 kernel holds
``update_cells(d)`` cells, 8 at d = 256, fewer than a group's 16 at tau =
4) take the large-tau path at every tau (``update_path``): eight lanes an
event hash its columns in a loop (bucket_of's bits, as bse_encode's wide
path), and a cell is folded in passes of 128 columns.
The kernel has no backward (it ingests): on CUDA the wrapper raises where
autograd would record the call.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sdim_bucket.sdim_bucket import MAX_REG_D, MAX_TAU, bse_encode_ref

ITEMS = 2           # (cell, float4 column) sums a thread holds (sdim_update.cu kItems)
THREADS = 256       # threads a CTA (sdim_common.cuh kThreads)
UPDATE_LT_MAX_E = 8192   # events a chunk of the large-tau path sorts (kUpdateMaxE)


def sdim_update_ref(store: torch.Tensor, slots: torch.Tensor,
                    events: torch.Tensor, mask: torch.Tensor, R: torch.Tensor,
                    tau: int) -> torch.Tensor:
    """store (N, G, U, d) fp32 += bucket sums of events (B, E, d) by slot."""
    deltas = bse_encode_ref(events, mask, R, tau)            # (B, G, U, d)
    return store.index_add_(0, slots.long(), deltas)


def update_cells(d: int) -> int:
    """The (group, bucket) cells a CTA holds at width d: ITEMS sums a thread
    over the THREADS // (d / 4) cells that one pass of the block covers."""
    return ITEMS * (THREADS // (d // 4))


def update_splits(B: int, G: int, U: int, d: int, n_sm: int) -> int:
    """Signature-group slices per batch row, one CTA each: as many as fill
    the ``n_sm`` SMs in one wave at two CTAs an SM (the kernel's launch
    bound), at most G, and at least as many as keep a CTA at
    ``update_cells(d)`` cells."""
    s_min = -(-G // max(1, update_cells(d) // U))
    return max(s_min, min(G, 2 * n_sm // max(B, 1)))


def update_path(d: int, tau: int) -> str:
    """The fold's path: ``"groups"`` (csrc/sdim_update.cu, signature-group
    slices with register sums) at tau <= 4 and d <= ``MAX_REG_D``, else
    ``"lists"`` (csrc/sdim_update_large_tau.cu; its wide variant above
    ``MAX_REG_D``)."""
    return "groups" if tau <= 4 and d <= MAX_REG_D else "lists"


def update_large_tau_path(E: int) -> str:
    """The large-tau fold's path for rows of E events: ``"sorted"`` (a
    row's events sorted in shared memory at once, no device scratch) up to
    ``UPDATE_LT_MAX_E``, else ``"chunked"`` (chunks of that many, each
    cell's partial sum in a scratch of (B, G, U, d) fp32)."""
    return "sorted" if E <= UPDATE_LT_MAX_E else "chunked"


def sdim_update(store: torch.Tensor, slots: torch.Tensor, events: torch.Tensor,
                mask: torch.Tensor, R: torch.Tensor, tau: int) -> torch.Tensor:
    """Fold events (B, E, d) fp32|bf16 with mask (B, E) into rows ``slots``
    (B,) int32 in [0, N) of the fp32 store (N, G, U, d), in place."""
    if store.device.type == "cpu":
        return sdim_update_ref(store, slots, events, mask, R, tau)
    return sdim_update_cuda(store, slots, events, mask, R, tau)


def sdim_update_cuda(store: torch.Tensor, slots: torch.Tensor, events: torch.Tensor,
                     mask: torch.Tensor, R: torch.Tensor, tau: int,
                     splits: Optional[int] = None) -> torch.Tensor:
    """The kernel launch of ``sdim_update`` with ``splits`` signature-group
    slices per batch row (None: ``update_splits`` for this device; tau <= 4
    at d <= 128 only, the large-tau path gives each group a CTA)."""
    _build.refuse_grad("sdim_update", store, events, mask, R)
    N, G, U, d = store.shape
    B, E, _ = events.shape
    m = R.shape[0]
    if (G != m // tau or U != 1 << tau or R.shape != (m, d)
            or events.shape[-1] != d or slots.shape != (B,)
            or mask.shape != (B, E)):
        raise ValueError(f"sdim_update: shapes store {tuple(store.shape)} "
                         f"events {tuple(events.shape)} slots "
                         f"{tuple(slots.shape)} mask {tuple(mask.shape)}")
    if not 1 <= tau <= MAX_TAU or d % 4 or d < 4:
        raise ValueError(f"sdim_update: the kernel takes tau 1..{MAX_TAU} and d a multiple "
                         f"of 4; got tau {tau}, d {d}")
    code = _build.dtype_code("sdim_update", events, (torch.float32, torch.bfloat16))
    if store.dtype != torch.float32:
        raise TypeError("sdim_update: the store must be float32")
    if slots.dtype != torch.int32:
        raise TypeError("sdim_update: slots must be int32")
    if mask.dtype != torch.float32 or R.dtype != torch.float32:
        raise TypeError("sdim_update: mask and R must be float32")
    dev = _build.require_cuda("sdim_update", store, slots, events, mask, R)
    _build.require_aligned("sdim_update", store, events, R)
    lists = update_path(d, tau) == "lists"
    if lists:
        if splits is not None:
            raise ValueError("sdim_update: group slices are the tau <= 4 kernel's; the "
                             "large-tau path gives each (batch row, group) a CTA")
        splits = 1
    elif splits is None:
        splits = update_splits(B, G, U, d, _build.sm_count(dev))
    if not lists and (not 1 <= splits <= G or -(-G // splits) * U > update_cells(d)):
        raise ValueError(f"sdim_update: {splits} group slices of G = {G} groups; the kernel "
                         f"takes 1..G slices of at most {update_cells(d)} cells at d = {d}")
    if B == 0 or E == 0:
        return store
    work = None
    if lists and update_large_tau_path(E) == "chunked":
        work = torch.empty((B, G, U, d), dtype=torch.float32, device=dev)
    lib = _build.load()
    with _build.on_device(dev):
        err = lib.sdim_update(store.data_ptr(), slots.data_ptr(),
                              events.data_ptr(), code, mask.data_ptr(),
                              R.data_ptr(), _build.ptr(work), B, E, G, U, d, m, tau,
                              splits, _build.stream(dev))
    _build.check(err, "sdim_update")
    sdim_update.launches += 1
    return store


sdim_update.launches = 0
