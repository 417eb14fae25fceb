"""sdim_query: candidate hash + own-bucket read + ℓ2 combine (Eq. 12).

Wrapper of the CUDA kernel ``csrc/sdim_query.cu`` (which replaces the Pallas
kernel ``repro/kernels/sdim_query/sdim_query.py:52``) and its plain PyTorch
version ``sdim_query_ref``. The wrapper runs the plain version for CPU
tensors only; for CUDA tensors it launches the kernel or raises.
``sdim_query.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core import sdim, simhash
from repro_torch.kernels import _build

C_PER_BLOCK = 32         # candidates per block (one tile of sdim_common.cuh)


def sdim_query_ref(q: torch.Tensor, table: torch.Tensor, R: torch.Tensor,
                   tau: int) -> torch.Tensor:
    """(B, C, d), (B, G, U, d) -> (B, C, d) fp32."""
    return sdim.fused_query(table, simhash.signatures(q, R, tau))


def sdim_query(q: torch.Tensor, table: torch.Tensor, R: torch.Tensor,
               tau: int) -> torch.Tensor:
    """Candidates q (B, C, d) fp32 against bucket tables (B, G, U, d)
    fp32|bf16 -> interest (B, C, d) fp32."""
    if q.device.type == "cpu":
        return sdim_query_ref(q, table, R, tau)
    B, C, d = q.shape
    m = R.shape[0]
    G, U = m // tau, 1 << tau
    if m % tau or table.shape != (B, G, U, d) or R.shape != (m, d):
        raise ValueError(f"sdim_query: shapes q {tuple(q.shape)} table "
                         f"{tuple(table.shape)} R {tuple(R.shape)} tau {tau}")
    code = _build.dtype_code("sdim_query", table, (torch.float32, torch.bfloat16))
    if q.dtype != torch.float32 or R.dtype != torch.float32:
        raise TypeError("sdim_query: q and R must be float32")
    dev = _build.require_cuda("sdim_query", q, table, R)
    out = torch.empty((B, C, d), dtype=torch.float32, device=dev)
    if B == 0 or C == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.sdim_query(table.data_ptr(), code, q.data_ptr(), R.data_ptr(),
                             out.data_ptr(), B, C, C_PER_BLOCK, G, U, d, m,
                             tau, _build.stream(dev))
    _build.check(err, "sdim_query")
    sdim_query.launches += 1
    return out


sdim_query.launches = 0
