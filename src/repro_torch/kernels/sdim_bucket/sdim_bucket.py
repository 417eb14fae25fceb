"""bse_encode: SimHash + signature pack + bucket sum of a behavior batch.

Wrapper of the CUDA kernel ``csrc/bse_encode.cu`` (which replaces the Pallas
kernel ``repro/kernels/sdim_bucket/sdim_bucket.py:117``) and its plain
PyTorch version ``bse_encode_ref``. The wrapper runs the plain version for
CPU tensors only; for CUDA tensors it launches the kernel or raises.
``bse_encode.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core import sdim, simhash
from repro_torch.kernels import _build

_TILE_ROWS = 32          # sdim_common.cuh kTileRows


def bse_encode_ref(seq: torch.Tensor, mask: torch.Tensor, R: torch.Tensor,
                   tau: int) -> torch.Tensor:
    """(B, L, d), (B, L), (m, d) -> bucket table (B, G, U, d) fp32."""
    sig = simhash.signatures(seq, R, tau)
    return sdim.bucket_table(seq, sig, mask, 1 << tau)


def l_per_block(B: int, L: int, target_blocks: int) -> int:
    """Behaviors per block: split L so that about ``target_blocks`` blocks
    run, in whole tiles (each block adds its chunk into the zeroed output
    with atomics)."""
    chunks = max(1, min(-(-target_blocks // max(B, 1)), -(-L // _TILE_ROWS)))
    per = -(-L // chunks)
    return -(-per // _TILE_ROWS) * _TILE_ROWS


def bse_encode(seq: torch.Tensor, mask: torch.Tensor, R: torch.Tensor,
               tau: int) -> torch.Tensor:
    """Behaviors seq (B, L, d) fp32|bf16 with mask (B, L) and hash family
    R (m, d) -> bucket table (B, G, U, d) fp32."""
    if seq.device.type == "cpu":
        return bse_encode_ref(seq, mask, R, tau)
    B, L, d = seq.shape
    m = R.shape[0]
    if m % tau or R.shape != (m, d) or mask.shape != (B, L):
        raise ValueError(f"bse_encode: shapes seq {tuple(seq.shape)} mask "
                         f"{tuple(mask.shape)} R {tuple(R.shape)} tau {tau}")
    G, U = m // tau, 1 << tau
    code = _build.dtype_code("bse_encode", seq, (torch.float32, torch.bfloat16))
    if mask.dtype != torch.float32 or R.dtype != torch.float32:
        raise TypeError("bse_encode: mask and R must be float32")
    dev = _build.require_cuda("bse_encode", seq, mask, R)
    # two blocks per SM
    per = l_per_block(B, L, 2 * torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.zeros((B, G * U, d), dtype=torch.float32, device=dev)
    if B == 0 or L == 0:
        return out.reshape(B, G, U, d)
    lib = _build.load()
    with _build.on_device(dev):
        err = lib.sdim_bse_encode(seq.data_ptr(), code, mask.data_ptr(),
                                  R.data_ptr(), out.data_ptr(), B, L, per,
                                  G, U, d, m, tau, _build.stream(dev))
    _build.check(err, "bse_encode")
    bse_encode.launches += 1
    return out.reshape(B, G, U, d)


bse_encode.launches = 0
