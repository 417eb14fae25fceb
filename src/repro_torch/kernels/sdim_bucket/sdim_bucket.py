"""bse_encode: SimHash + signature pack + bucket sum of a behavior batch,
and its gradient.

Wrapper of the CUDA kernel ``csrc/bse_encode.cu`` (which replaces the Pallas
kernel ``repro/kernels/sdim_bucket/sdim_bucket.py:117``) and its plain
PyTorch version ``bse_encode_ref``. The wrapper runs the plain version for
CPU tensors only; for CUDA tensors it launches the kernel or raises.
``bse_encode.launches`` counts kernel launches. The kernel splits each
user's signature groups over ``encode_splits`` CTAs, each of which writes
its slice of the table once (no atomics, no zero-filled output). tau 5..10
(32..1,024 buckets a group, more than a CTA's registers hold) launch the
large-tau path (``csrc/bse_encode_large_tau.cu``), as the backward does.

Where autograd records the call (grad mode on, ``seq`` requiring grad) the
wrapper goes through ``BSEEncodeFn``, whose backward is
``bse_encode_backward``: the CUDA kernel ``csrc/bse_encode_backward.cu`` on
the card (no TPU kernel corresponds to it: the JAX package differentiates
the XLA formulation), its closed-form plain version on the CPU. Signatures
are comparisons and carry no gradient, so the gradient of the table
T[b,g,u] = sum_l [sig_g(s_bl) = u] mask_bl s_bl is a gather,
d seq[b,l] = mask[b,l] * sum_g dT[b, g, sig_g(s_bl)]; R is a buffer, and a
mask that requires grad is refused.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import sdim, simhash
from repro_torch.kernels import _build

MAX_CELLS = 16      # (group, bucket) sums a CTA holds in registers (bse_encode.cu kCells)
MAX_L = 32768       # behaviors a user: the kernel's list of 8-row batches lives in shared memory
MAX_BWD_SMEM = 200 * 1024   # the backward's shared copy of a user's table and of R (tau <= 4)
MAX_TAU = 10        # tau 5..MAX_TAU: the large-tau path (csrc/large_tau.cuh), d up to 128


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
    R (m, d) -> bucket table (B, G, U, d) fp32; differentiable in seq."""
    if _build.needs_grad(seq, mask, R):
        if mask.requires_grad or R.requires_grad:
            raise ValueError("bse_encode: the gradient flows to seq only; mask and R "
                             "must not require grad")
        return BSEEncodeFn.apply(seq, mask, R, tau)
    return _encode(seq, mask, R, tau)


def _encode(seq, mask, R, tau):
    if seq.device.type == "cpu":
        return bse_encode_ref(seq, mask, R, tau)
    return bse_encode_cuda(seq, mask, R, tau)


class BSEEncodeFn(torch.autograd.Function):
    """``bse_encode`` with its gradient in seq (``bse_encode_backward``)."""

    @staticmethod
    def forward(ctx, seq, mask, R, tau):
        ctx.tau = tau
        ctx.save_for_backward(seq, mask, R)
        return _encode(seq, mask, R, tau)

    @staticmethod
    def backward(ctx, dT):
        seq, mask, R = ctx.saved_tensors
        return bse_encode_backward(dT.contiguous(), seq, mask, R, ctx.tau), None, None, None


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
    if not 1 <= tau <= MAX_TAU or d % 4 or d > 128 or L > MAX_L:
        raise ValueError(f"bse_encode: the kernel takes tau 1..{MAX_TAU}, d a multiple of 4 "
                         f"up to 128 and L up to {MAX_L}; got tau {tau}, d {d}, L {L}")
    code = _build.dtype_code("bse_encode", seq, (torch.float32, torch.bfloat16))
    if mask.dtype != torch.float32 or R.dtype != torch.float32:
        raise TypeError("bse_encode: mask and R must be float32")
    dev = _build.require_cuda("bse_encode", seq, mask, R)
    _build.require_aligned("bse_encode", seq, R)
    if splits is None:      # the large-tau path takes no slices
        splits = encode_splits(B, G, U, _build.sm_count(dev)) if tau <= 4 else 1
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


def bse_encode_backward_ref(dT: torch.Tensor, seq: torch.Tensor, mask: torch.Tensor,
                            R: torch.Tensor, tau: int) -> torch.Tensor:
    """dT (B, G, U, d) -> d seq (B, L, d) in seq's dtype: each row's G
    gathered rows of dT summed in group order, times its mask."""
    sig = simhash.signatures(seq, R, tau).long()                   # (B, L, G)
    b = torch.arange(seq.shape[0], device=seq.device)[:, None]
    acc = torch.zeros(seq.shape, dtype=torch.float32, device=seq.device)
    for g in range(dT.shape[1]):
        acc = acc + dT[b, g, sig[..., g]].float()
    return (acc * mask.float()[..., None]).to(seq.dtype)


def backward_splits(B: int, L: int, n_sm: int) -> int:
    """Row chunks per user, one CTA each (8 warps, four rows a warp at a
    time, ~90 KB of shared memory at full width: two CTAs an SM): as many
    as fit the ``n_sm`` SMs in one wave at two CTAs an SM, at least one,
    at most one per 32 rows."""
    return max(1, min(-(-L // 32), 2 * n_sm // max(B, 1)))


def bse_encode_backward(dT: torch.Tensor, seq: torch.Tensor, mask: torch.Tensor,
                        R: torch.Tensor, tau: int) -> torch.Tensor:
    """Gradient of ``bse_encode`` in seq: dT (B, G, U, d) fp32 -> d seq
    (B, L, d) in seq's dtype."""
    if seq.device.type == "cpu":
        return bse_encode_backward_ref(dT, seq, mask, R, tau)
    return bse_encode_backward_cuda(dT, seq, mask, R, tau)


def bse_encode_backward_cuda(dT: torch.Tensor, seq: torch.Tensor, mask: torch.Tensor,
                             R: torch.Tensor, tau: int,
                             splits: Optional[int] = None) -> torch.Tensor:
    """The kernel launch of ``bse_encode_backward`` with ``splits`` row
    chunks per user (None: ``backward_splits`` for this device)."""
    B, L, d = seq.shape
    m = R.shape[0]
    G, U = m // tau, 1 << tau
    if (m % tau or R.shape != (m, d) or mask.shape != (B, L)
            or dT.shape != (B, G, U, d)):
        raise ValueError(f"bse_encode_backward: shapes dT {tuple(dT.shape)} seq "
                         f"{tuple(seq.shape)} mask {tuple(mask.shape)} R {tuple(R.shape)} "
                         f"tau {tau}")
    if (not 1 <= tau <= MAX_TAU or d % 4 or d > 128
            or tau <= 4 and 4 * (G * U * d + m * (d + 4)) > MAX_BWD_SMEM):
        raise ValueError(f"bse_encode_backward: the kernel takes tau 1..{MAX_TAU}, d a multiple "
                         f"of 4 up to 128 and, at tau <= 4, a user's table and R within "
                         f"{MAX_BWD_SMEM} bytes of shared memory; got tau {tau}, d {d}, m {m}")
    code = _build.dtype_code("bse_encode_backward", seq, (torch.float32, torch.bfloat16))
    for name, t in (("dT", dT), ("mask", mask), ("R", R)):
        if t.dtype != torch.float32:
            raise TypeError(f"bse_encode_backward: {name} must be float32")
    dev = _build.require_cuda("bse_encode_backward", dT, seq, mask, R)
    _build.require_aligned("bse_encode_backward", dT, seq, R)
    if splits is None:
        splits = backward_splits(B, L, _build.sm_count(dev))
    out = torch.empty_like(seq)
    if B == 0 or L == 0:
        return out
    lib = _build.load()
    with _build.on_device(dev):
        err = lib.sdim_bse_encode_backward(dT.data_ptr(), seq.data_ptr(), code, mask.data_ptr(),
                                           R.data_ptr(), out.data_ptr(), B, L, G, U, d, m, tau,
                                           splits, _build.stream(dev))
    _build.check(err, "bse_encode_backward")
    bse_encode_backward.launches += 1
    return out


bse_encode_backward.launches = 0
