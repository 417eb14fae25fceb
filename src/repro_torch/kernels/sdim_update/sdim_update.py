"""sdim_update: fold event behaviors into rows of the table store, in place.

Wrapper of the CUDA kernel ``csrc/sdim_update.cu`` (which replaces the Pallas
kernel ``repro/kernels/sdim_update/sdim_update.py:77``) and its plain
PyTorch version ``sdim_update_ref``. The JAX version returns a new store
(its caller donates the old buffer); both versions here write the fp32
store IN PLACE and return it. Duplicate slots accumulate; a row whose mask
is all zero writes nothing. The wrapper runs the plain version for CPU
tensors only; for CUDA tensors it launches the kernel or raises.
``sdim_update.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sdim_bucket.sdim_bucket import bse_encode_ref


def sdim_update_ref(store: torch.Tensor, slots: torch.Tensor,
                    events: torch.Tensor, mask: torch.Tensor, R: torch.Tensor,
                    tau: int) -> torch.Tensor:
    """store (N, G, U, d) fp32 += bucket sums of events (B, E, d) by slot."""
    deltas = bse_encode_ref(events, mask, R, tau)            # (B, G, U, d)
    return store.index_add_(0, slots.long(), deltas)


def sdim_update(store: torch.Tensor, slots: torch.Tensor, events: torch.Tensor,
                mask: torch.Tensor, R: torch.Tensor, tau: int) -> torch.Tensor:
    """Fold events (B, E, d) fp32|bf16 with mask (B, E) into rows ``slots``
    (B,) int32 in [0, N) of the fp32 store (N, G, U, d), in place."""
    if store.device.type == "cpu":
        return sdim_update_ref(store, slots, events, mask, R, tau)
    N, G, U, d = store.shape
    B, E, _ = events.shape
    m = R.shape[0]
    if (G != m // tau or U != 1 << tau or R.shape != (m, d)
            or events.shape[-1] != d or slots.shape != (B,)
            or mask.shape != (B, E)):
        raise ValueError(f"sdim_update: shapes store {tuple(store.shape)} "
                         f"events {tuple(events.shape)} slots "
                         f"{tuple(slots.shape)} mask {tuple(mask.shape)}")
    code = _build.dtype_code("sdim_update", events, (torch.float32, torch.bfloat16))
    if store.dtype != torch.float32:
        raise TypeError("sdim_update: the store must be float32")
    if slots.dtype != torch.int32:
        raise TypeError("sdim_update: slots must be int32")
    if mask.dtype != torch.float32 or R.dtype != torch.float32:
        raise TypeError("sdim_update: mask and R must be float32")
    dev = _build.require_cuda("sdim_update", store, slots, events, mask, R)
    if B == 0 or E == 0:
        return store
    lib = _build.load()
    with _build.on_device(dev):
        err = lib.sdim_update(store.data_ptr(), slots.data_ptr(),
                              events.data_ptr(), code, mask.data_ptr(),
                              R.data_ptr(), B, E, G, U, d, m, tau,
                              _build.stream(dev))
    _build.check(err, "sdim_update")
    sdim_update.launches += 1
    return store


sdim_update.launches = 0
