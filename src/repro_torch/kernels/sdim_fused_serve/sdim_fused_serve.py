"""sdim_fused_serve: slot gather + dequantize + bucket query in one launch.

Wrapper of the CUDA kernel ``csrc/sdim_fused_serve.cu`` (which replaces the
Pallas kernel ``repro/kernels/sdim_fused_serve/sdim_fused_serve.py:86``) and
its plain PyTorch version ``sdim_fused_serve_ref``. The wrapper runs the
plain version for CPU tensors only; for CUDA tensors it launches the kernel
or raises. ``sdim_fused_serve.launches`` counts kernel launches. Store
dtypes: fp32, bf16, and int8 or fp8 (e4m3) with per-row scales. The kernel
gives each user a thread-block cluster that splits the row and the
candidates, so each present user's row is read from device memory once.
Where that body's shared memory does not fit a CTA (``query_plan``: d =
256 at tau = 4, m = 500) the wrapper launches sdim_query's wide path with
the slot, the scales and present (``kernels/sdim_query/csrc/wide_query.cuh``),
the body sdim_query takes at the same shape, so the fused read and the
fetched read (``sdim_query(store[slots], ...)``) give the same bits.
tau 5..10 (32..1,024 buckets a group: a user's table no longer fits a
CTA) launch the large-tau path (``csrc/sdim_fused_serve_large_tau.cu``:
each candidate hashes itself for every group, then reads, dequantizes and
normalizes only the G rows it selects, eight rows' loads in flight at
once; any d, its columns in a loop above 128, ``gather_shape_wide``). The
kernel has no backward (it serves): on CUDA the wrapper raises where
autograd would record the call.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import sdim, simhash
from repro_torch.kernels import _build
from repro_torch.kernels.sdim_bucket.sdim_bucket import MAX_TAU
from repro_torch.kernels.sdim_query.sdim_query import launch_plan
from repro_torch.serve.quant import is_quantized

GATHER_WIDE_SMEM = 96 * 1024   # csrc/fused_query_large_tau.cuh kGatherWideSmem


def gather_large_tau_smem(cands: int, teams: int, d: int, wide: bool) -> int:
    """The large-tau gather CTA's shared memory
    (``fused_query_large_tau_smem``): the normalized rows, the candidates
    and, ``wide`` (d > 128), the running sums."""
    return 4 * d * (cands * teams + (2 if wide else 1) * cands)


def gather_shape_wide(cands: int, teams: int, d: int) -> tuple[int, int]:
    """The WIDE gather's (candidates, teams) a CTA from ``gather_shape``'s
    (``gather_shape_wide`` in ``csrc/fused_query_large_tau.cuh``): the
    candidates halved, then the teams, while the CTA's shared memory
    exceeds ``GATHER_WIDE_SMEM``."""
    while gather_large_tau_smem(cands, teams, d, True) > GATHER_WIDE_SMEM:
        if cands > 1:
            cands //= 2
        elif teams > 1:
            teams = (teams + 1) // 2
        else:
            break
    return cands, teams


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
    """Store (N, G, U, d) fp32|bf16|int8|fp8 [+ scales (N, G, U) fp32], slots
    (B,) int32 in [0, N), candidates q (B, C, d) fp32 [+ present (B,) fp32]
    -> interest (B, C, d) fp32, zero where ``present`` is 0."""
    if store.device.type == "cpu":
        return sdim_fused_serve_ref(store, slots, q, R, tau, scales=scales,
                                    present=present)
    _build.refuse_grad("sdim_fused_serve", store, q, R, scales, present)
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
                             (torch.float32, torch.bfloat16, torch.int8,
                              torch.float8_e4m3fn))
    if not 1 <= tau <= MAX_TAU or d % 4 or G * U * d * store.element_size() % 16:
        raise ValueError(f"sdim_fused_serve: the kernel takes tau 1..{MAX_TAU}, d a multiple "
                         f"of 4 and a user's table of G*U*d values in whole 16-byte loads; got "
                         f"tau {tau}, G {G}, U {U}, d {d}, {store.dtype}")
    if is_quantized(store.dtype) != (scales is not None):
        raise ValueError("sdim_fused_serve: int8 and fp8 stores need scales; "
                         "other stores take none")
    if slots.dtype != torch.int32:
        raise TypeError("sdim_fused_serve: slots must be int32")
    for name, t in (("q", q), ("R", R), ("scales", scales), ("present", present)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"sdim_fused_serve: {name} must be float32")
    extra = [t for t in (scales, present) if t is not None]
    dev = _build.require_cuda("sdim_fused_serve", store, slots, q, R, *extra)
    _build.require_aligned("sdim_fused_serve", store, q, R)
    out = torch.empty_like(q)               # (B, C, d) fp32, contiguous like q
    if B == 0 or C == 0:
        return out
    tile, gc, r_staged = launch_plan(B, C, G, d, tau, store.dtype, dev, store=True)
    lib = _build.load()
    with _build.on_device(dev):
        err = lib.sdim_fused_serve(
            store.data_ptr(), code, _build.ptr(scales), slots.data_ptr(),
            _build.ptr(present), q.data_ptr(), R.data_ptr(), out.data_ptr(),
            B, C, G, U, d, m, tau, tile, gc, r_staged, _build.stream(dev))
    _build.check(err, "sdim_fused_serve")
    sdim_fused_serve.launches += 1
    return out


sdim_fused_serve.launches = 0
