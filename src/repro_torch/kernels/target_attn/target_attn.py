"""target_attention_flash: online-softmax target attention of C candidates
against a whole behavior sequence (the DIN long-sequence baseline).

Wrapper of the CUDA kernel ``csrc/target_attn.cu`` (which replaces the
Pallas kernel ``repro/kernels/target_attn/target_attn.py:59``) and its plain
PyTorch version ``target_attention_flash_ref``. The wrapper runs the plain
version for CPU tensors only; for CUDA tensors it launches the kernel or
raises. ``target_attention_flash.launches`` counts kernel launches.

Where autograd records the call (grad mode on, q or seq requiring grad)
the wrapper goes through ``TargetAttentionFn``, whose backward is
``target_attention_flash_backward``: the CUDA kernel
``csrc/target_attn_backward.cu`` on the card (no TPU kernel corresponds to
it: the JAX package differentiates the XLA formulation), its closed-form
plain version on the CPU. seq is both key and value, so with
P = softmax(s), s = scale q seq^T (masked logits -1e30, constants):
  dS   = P o (dout seq^T - D),  D = rowsum(dout o out), 0 where masked
  dq   = scale dS seq
  dseq = P^T dout + scale dS^T q.
A fully masked user attends uniformly (P = 1/L), so its rows get dout / L
and its candidates no gradient. A mask that requires grad is refused. At
C = 1 the backward is one launch that reads seq once (``backward_split``
picks its CTAs: a cluster of CTAs a long history, several users a CTA for
short ones); at C > 1 two launches.

The forward has two bodies: a cluster of CTAs splits a user's rows over
64-candidate tiles (the main path's C = 128 over L = 1,024), and at C = 1
with at most ``TA_FOLD_MAX_L`` rows (the retrieval kinds' folded users)
a warp owns a whole user, ``forward_split`` users a CTA.
"""
from __future__ import annotations

import functools
from typing import Callable, Tuple

import torch

from repro_torch.core.target_attention import default_scale, target_attention
from repro_torch.kernels import _build

_scale = functools.lru_cache(maxsize=None)(default_scale)


def target_attention_flash_ref(q: torch.Tensor, seq: torch.Tensor,
                               mask: torch.Tensor) -> torch.Tensor:
    """(B, C, d), (B, L, d), (B, L) -> (B, C, d) fp32."""
    return target_attention(q.float(), seq.float(), mask)


def target_attention_flash(q: torch.Tensor, seq: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Candidates q (B, C, d) fp32 against behaviors seq (B, L, d)
    fp32|bf16 with mask (B, L) fp32 -> softmax(q·Sᵀ/√d) S (B, C, d) fp32;
    masked logits are −1e30. Differentiable in q and seq."""
    if _build.needs_grad(q, seq, mask):
        if mask.requires_grad:
            raise ValueError("target_attention_flash: the gradient flows to q and seq; "
                             "the mask must not require grad")
        return TargetAttentionFn.apply(q, seq, mask)
    return _attend(q, seq, mask)


class TargetAttentionFn(torch.autograd.Function):
    """``target_attention_flash`` with its gradients in q and seq
    (``target_attention_flash_backward``)."""

    @staticmethod
    def forward(ctx, q, seq, mask):
        out = _attend(q, seq, mask)
        ctx.save_for_backward(q, seq, mask, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, seq, mask, out = ctx.saved_tensors
        dq, dseq = target_attention_flash_backward(dout.contiguous(), q, seq, mask, out)
        return (dq if ctx.needs_input_grad[0] else None,
                dseq if ctx.needs_input_grad[1] else None, None)


def _attend(q, seq, mask):
    if q.device.type == "cpu":
        return target_attention_flash_ref(q, seq, mask)
    B, C, d = q.shape
    L = seq.shape[1]
    if seq.shape != (B, L, d) or mask.shape != (B, L) or d % 4 or d > 256:
        raise ValueError(f"target_attention_flash: shapes q {tuple(q.shape)} seq "
                         f"{tuple(seq.shape)} mask {tuple(mask.shape)} (the kernel "
                         f"takes d a multiple of 4 up to 256)")
    code = _build.dtype_code("target_attention_flash", seq, (torch.float32, torch.bfloat16))
    if q.dtype != torch.float32 or mask.dtype != torch.float32:
        raise TypeError("target_attention_flash: q and mask must be float32")
    dev = _build.require_cuda("target_attention_flash", q, seq, mask)
    _build.require_aligned("target_attention_flash", q, seq)
    out = torch.empty((B, C, d), dtype=torch.float32, device=dev)
    if B == 0 or C == 0:
        return out
    upc = forward_split(B, L, C, _build.sm_count(dev))
    lib = _build.load()
    with _build.on_device(dev):
        err = lib.sdim_target_attention(q.data_ptr(), seq.data_ptr(), code, mask.data_ptr(),
                                        out.data_ptr(), B, L, C, d, _scale(d), upc,
                                        _build.stream(dev))
    _build.check(err, "target_attention_flash")
    target_attention_flash.launches += 1
    return out


target_attention_flash.launches = 0


TA_FOLD_MAX_L = 64       # rows a user of the forward's folded body (target_attn.cu kFoldMaxL)
TA_FOLD_MAX_USERS = 8    # users (a warp each) a CTA of the folded body


def forward_split(B: int, L: int, C: int, n_sm: int) -> int:
    """Users a CTA of the forward's folded body (a warp a user) at C = 1
    and L <= ``TA_FOLD_MAX_L``, or 0: the cluster body (C > 1 or longer
    histories). The most users a CTA (8, 4 or 2) for which the grid keeps
    a CTA for each of the ``n_sm`` SMs, else one."""
    if C != 1 or L > TA_FOLD_MAX_L or B <= 0:
        return 0
    upc = TA_FOLD_MAX_USERS
    while upc > 1 and -(-B // upc) < n_sm:
        upc //= 2
    return upc


TA_BWD_ROWS = 64 * 1024        # rows a CTA of the one-launch backward stages
TA_BWD_MAX_ROWS = 192 * 1024   # the most rows a CTA of a cluster stages (one CTA an SM)
TA_BWD_MAX_CLUSTER = 8         # CTAs of a cluster (the portable most)


def backward_split(B: int, L: int, C: int, d: int, elem_bytes: int, n_sm: int,
                   clusters: Callable[[int, int, int], int]) -> Tuple[int, int]:
    """(users a CTA, CTAs a user) that the backward launches at C = 1, or
    (0, 0): the two-launch path (C > 1, or a user whose rows exceed 8 CTAs
    of ``TA_BWD_MAX_ROWS``). Short histories: the most users a CTA (2, 4 or
    8) whose rows stay within ``TA_BWD_ROWS`` while the grid keeps a CTA
    for each of the ``n_sm`` SMs. Else one user a CTA, in a cluster of the
    fewest CTAs that keep each CTA's rows within ``TA_BWD_ROWS`` (more CTAs
    of fewer rows were slower on the H100: every CTA pays the staging and
    exchange latency), shrunk to the largest cluster whose B clusters all
    fit the card at once (a second wave doubles the time) with each CTA's
    rows within ``TA_BWD_MAX_ROWS``, kept where none does. ``clusters(upc,
    cap, S)``: the clusters of S CTAs, ``cap`` rows a slot, that the card
    holds at once (``launch_split`` asks the card)."""
    if C != 1 or B <= 0 or L <= 0:
        return 0, 0
    user = -(-L * d * elem_bytes // 16) * 16
    upc = 8
    while upc > 1 and (upc * user > TA_BWD_ROWS or -(-B // upc) < n_sm):
        upc //= 2
    if upc > 1:
        return upc, 1
    S = -(-user // TA_BWD_ROWS)
    if S > TA_BWD_MAX_CLUSTER:
        if -(-L // TA_BWD_MAX_CLUSTER) * d * elem_bytes > TA_BWD_MAX_ROWS:
            return 0, 0
        S = TA_BWD_MAX_CLUSTER
    for s in range(S, 1, -1):
        cap = -(-L // s)
        if cap * d * elem_bytes > TA_BWD_MAX_ROWS:
            break
        if B <= clusters(1, cap, s):
            return 1, s
    return 1, S


def launch_split(B: int, L: int, C: int, d: int, seq_dtype: torch.dtype,
                 dev: torch.device) -> Tuple[int, int]:
    """``backward_split`` with ``dev``'s SM count and cluster capacity: the
    split ``target_attention_flash_backward`` launches there."""
    code = _build.DTYPE_CODES[seq_dtype]
    return backward_split(
        B, L, C, d, seq_dtype.itemsize, _build.sm_count(dev),
        lambda upc, cap, S: _build.clusters("sdim_target_attention_backward_clusters", dev,
                                            code, d, upc, cap, S))


def target_attention_flash_backward_ref(
        dout: torch.Tensor, q: torch.Tensor, seq: torch.Tensor, mask: torch.Tensor,
        out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """dout (B, C, d) -> (dq (B, C, d) fp32, dseq (B, L, d) in seq's dtype)
    in closed form; ``out`` is the forward's output."""
    scale = _scale(q.shape[-1])
    x, qf, do = seq.float(), q.float(), dout.float()
    valid = (mask > 0)[:, None, :]
    s = torch.einsum("bcd,bld->bcl", qf, x) * scale
    P = torch.softmax(torch.where(valid, s, torch.full((), -1e30, device=s.device)), dim=-1)
    dP = torch.einsum("bcd,bld->bcl", do, x)
    D = torch.sum(do * out.float(), dim=-1, keepdim=True)
    dS = torch.where(valid, P * (dP - D), torch.zeros((), device=s.device))
    dq = scale * torch.einsum("bcl,bld->bcd", dS, x)
    dseq = (torch.einsum("bcl,bcd->bld", P, do)
            + scale * torch.einsum("bcl,bcd->bld", dS, qf))
    return dq, dseq.to(seq.dtype)


def target_attention_flash_backward(
        dout: torch.Tensor, q: torch.Tensor, seq: torch.Tensor, mask: torch.Tensor,
        out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients of ``target_attention_flash`` in q and seq: dout (B, C, d)
    fp32 and the forward's output -> (dq (B, C, d) fp32, dseq (B, L, d) in
    seq's dtype)."""
    if q.device.type == "cpu":
        return target_attention_flash_backward_ref(dout, q, seq, mask, out)
    B, C, d = q.shape
    L = seq.shape[1]
    if (seq.shape != (B, L, d) or mask.shape != (B, L) or dout.shape != (B, C, d)
            or out.shape != (B, C, d) or d % 4 or d > 256):
        raise ValueError(f"target_attention_flash_backward: shapes dout {tuple(dout.shape)} "
                         f"q {tuple(q.shape)} seq {tuple(seq.shape)} mask "
                         f"{tuple(mask.shape)} out {tuple(out.shape)} (the kernel takes d a "
                         f"multiple of 4 up to 256)")
    code = _build.dtype_code("target_attention_flash_backward", seq,
                             (torch.float32, torch.bfloat16))
    for name, t in (("dout", dout), ("q", q), ("mask", mask), ("out", out)):
        if t.dtype != torch.float32:
            raise TypeError(f"target_attention_flash_backward: {name} must be float32")
    dev = _build.require_cuda("target_attention_flash_backward", dout, q, seq, mask, out)
    _build.require_aligned("target_attention_flash_backward", dout, q, seq, out)
    if B == 0 or C == 0 or L == 0:      # no candidate, or no row to attend to
        return (torch.zeros((B, C, d), dtype=torch.float32, device=dev),
                torch.zeros_like(seq))
    dq = torch.empty((B, C, d), dtype=torch.float32, device=dev)
    dseq = torch.empty_like(seq)
    upc, S = launch_split(B, L, C, d, seq.dtype, dev)
    stats = None if S else torch.empty((B, C, 4), dtype=torch.float32, device=dev)
    lib = _build.load()
    with _build.on_device(dev):
        err = lib.sdim_target_attention_backward(
            dout.data_ptr(), q.data_ptr(), seq.data_ptr(), code, mask.data_ptr(),
            out.data_ptr(), _build.ptr(stats), dq.data_ptr(), dseq.data_ptr(),
            B, L, C, d, _scale(d), upc, S, _build.stream(dev))
    _build.check(err, "target_attention_flash_backward")
    target_attention_flash_backward.launches += 1
    return dq, dseq


target_attention_flash_backward.launches = 0
