"""sdim_fused_serve: slot gather + dequantize + bucket query in one launch.

Wrapper of the CUDA kernel ``csrc/sdim_fused_serve.cu`` (which replaces the
Pallas kernel ``repro/kernels/sdim_fused_serve/sdim_fused_serve.py:86``) and
its plain PyTorch version ``sdim_fused_serve_ref``. The wrapper runs the
plain version for CPU tensors only; for CUDA tensors it launches the kernel
or raises. ``sdim_fused_serve.launches`` counts kernel launches. Store
dtypes: fp32, bf16, int8 (with per-row scales); fp8 is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import sdim, simhash
from repro_torch.kernels import _build

C_PER_BLOCK = 32         # candidates per block (one tile of sdim_common.cuh)


def sdim_fused_serve_ref(store: torch.Tensor, slots: torch.Tensor,
                         q: torch.Tensor, R: torch.Tensor, tau: int, *,
                         scales: Optional[torch.Tensor] = None,
                         present: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather rows ``slots`` (dequantized by ``scales``), hash candidates and
    read interest (Eq. 12); absent users' output is multiplied by 0."""
    idx = slots.long()
    rows = store[idx].float()                                 # (B, G, U, d)
    if scales is not None:
        rows = rows * scales[idx].float()[..., None]
    out = sdim.fused_query(rows, simhash.signatures(q, R, tau))
    if present is not None:
        out = out * present.float()[:, None, None]
    return out


def sdim_fused_serve(store: torch.Tensor, slots: torch.Tensor, q: torch.Tensor,
                     R: torch.Tensor, tau: int, *,
                     scales: Optional[torch.Tensor] = None,
                     present: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Store (N, G, U, d) fp32|bf16|int8 [+ scales (N, G, U) fp32], slots
    (B,) int32 in [0, N), candidates q (B, C, d) fp32 [+ present (B,) fp32]
    -> interest (B, C, d) fp32, zero where ``present`` is 0."""
    if store.device.type == "cpu":
        return sdim_fused_serve_ref(store, slots, q, R, tau, scales=scales,
                                    present=present)
    N, G, U, d = store.shape
    B, C, _ = q.shape
    m = R.shape[0]
    if (G != m // tau or U != 1 << tau or R.shape != (m, d)
            or q.shape[-1] != d or slots.shape != (B,)
            or (present is not None and present.shape != (B,))
            or (scales is not None and scales.shape != (N, G, U))):
        raise ValueError(f"sdim_fused_serve: shapes store {tuple(store.shape)} "
                         f"q {tuple(q.shape)} slots {tuple(slots.shape)} "
                         f"R {tuple(R.shape)} tau {tau}")
    code = _build.dtype_code("sdim_fused_serve", store,
                             (torch.float32, torch.bfloat16, torch.int8))
    if (store.dtype == torch.int8) != (scales is not None):
        raise ValueError("sdim_fused_serve: int8 stores need scales; other "
                         "stores take none")
    if slots.dtype != torch.int32:
        raise TypeError("sdim_fused_serve: slots must be int32")
    for name, t in (("q", q), ("R", R), ("scales", scales), ("present", present)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"sdim_fused_serve: {name} must be float32")
    extra = [t for t in (scales, present) if t is not None]
    dev = _build.require_cuda("sdim_fused_serve", store, slots, q, R, *extra)
    out = torch.empty((B, C, d), dtype=torch.float32, device=dev)
    if B == 0 or C == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.sdim_fused_serve(
            store.data_ptr(), code, _build.ptr(scales), slots.data_ptr(),
            _build.ptr(present), q.data_ptr(), R.data_ptr(), out.data_ptr(),
            B, C, C_PER_BLOCK, G, U, d, m, tau, _build.stream(dev))
    _build.check(err, "sdim_fused_serve")
    sdim_fused_serve.launches += 1
    return out


sdim_fused_serve.launches = 0
