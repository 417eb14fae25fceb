"""bse_encode: SimHash + signature pack + bucket sum of a behavior batch.

Wrapper of the CUDA kernel ``csrc/bse_encode.cu`` (which replaces the Pallas
kernel ``repro/kernels/sdim_bucket/sdim_bucket.py:117``) and its plain
PyTorch version ``bse_encode_ref``. The wrapper runs the plain version for
CPU tensors only; for CUDA tensors it launches the kernel or raises.
``bse_encode.launches`` counts kernel launches. The kernel splits each
user's signature groups over ``encode_splits`` CTAs, each of which writes
its slice of the table once (no atomics, no zero-filled output).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import sdim, simhash
from repro_torch.kernels import _build

MAX_CELLS = 16      # (group, bucket) sums a CTA holds in registers (bse_encode.cu kCells)
MAX_L = 32768       # behaviors a user: the kernel's list of 8-row batches lives in shared memory


def bse_encode_ref(seq: torch.Tensor, mask: torch.Tensor, R: torch.Tensor,
                   tau: int) -> torch.Tensor:
    """(B, L, d), (B, L), (m, d) -> bucket table (B, G, U, d) fp32."""
    sig = simhash.signatures(seq, R, tau)
    return sdim.bucket_table(seq, sig, mask, 1 << tau)


def encode_splits(B: int, G: int, U: int, n_sm: int) -> int:
    """Signature-group slices per user, one CTA each: as many as fill the
    ``n_sm`` SMs in one wave (a CTA of 512 threads and ~200 KB of shared
    memory takes an SM), at most G, and at least as many as keep a CTA at
    ``MAX_CELLS`` (group, bucket) sums."""
    s_min = -(-G // (MAX_CELLS // U))
    return max(s_min, min(G, n_sm // max(B, 1)))


def bse_encode(seq: torch.Tensor, mask: torch.Tensor, R: torch.Tensor,
               tau: int) -> torch.Tensor:
    """Behaviors seq (B, L, d) fp32|bf16 with mask (B, L) and hash family
    R (m, d) -> bucket table (B, G, U, d) fp32."""
    if seq.device.type == "cpu":
        return bse_encode_ref(seq, mask, R, tau)
    return bse_encode_cuda(seq, mask, R, tau)


def bse_encode_cuda(seq: torch.Tensor, mask: torch.Tensor, R: torch.Tensor,
                    tau: int, splits: Optional[int] = None) -> torch.Tensor:
    """The kernel launch of ``bse_encode`` with ``splits`` signature-group
    slices per user (None: ``encode_splits`` for this device)."""
    B, L, d = seq.shape
    m = R.shape[0]
    if m % tau or R.shape != (m, d) or mask.shape != (B, L):
        raise ValueError(f"bse_encode: shapes seq {tuple(seq.shape)} mask "
                         f"{tuple(mask.shape)} R {tuple(R.shape)} tau {tau}")
    G, U = m // tau, 1 << tau
    if not 1 <= tau <= 4 or d % 8 or d > 128 or L > MAX_L:
        raise ValueError(f"bse_encode: the kernel takes tau 1..4, d a multiple of 8 "
                         f"up to 128 and L up to {MAX_L}; got tau {tau}, d {d}, L {L}")
    code = _build.dtype_code("bse_encode", seq, (torch.float32, torch.bfloat16))
    if mask.dtype != torch.float32 or R.dtype != torch.float32:
        raise TypeError("bse_encode: mask and R must be float32")
    dev = _build.require_cuda("bse_encode", seq, mask, R)
    _build.require_aligned("bse_encode", seq, R)
    if splits is None:
        splits = encode_splits(B, G, U, _build.sm_count(dev))
    if B == 0 or L == 0:
        return torch.zeros((B, G, U, d), dtype=torch.float32, device=dev)
    out = R.new_empty((B, G, U, d))         # fp32 on R's device
    lib = _build.load()
    with _build.on_device(dev):
        err = lib.sdim_bse_encode(seq.data_ptr(), code, mask.data_ptr(), R.data_ptr(),
                                  out.data_ptr(), B, L, G, U, d, m, tau, splits,
                                  _build.stream(dev))
    _build.check(err, "bse_encode")
    bse_encode.launches += 1
    return out


bse_encode.launches = 0
