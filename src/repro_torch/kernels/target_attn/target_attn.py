"""target_attention_flash: online-softmax target attention of C candidates
against a whole behavior sequence (the DIN long-sequence baseline).

Wrapper of the CUDA kernel ``csrc/target_attn.cu`` (which replaces the
Pallas kernel ``repro/kernels/target_attn/target_attn.py:59``) and its plain
PyTorch version ``target_attention_flash_ref``. The wrapper runs the plain
version for CPU tensors only; for CUDA tensors it launches the kernel or
raises. ``target_attention_flash.launches`` counts kernel launches.
"""
from __future__ import annotations

import functools

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
    masked logits are −1e30."""
    if q.device.type == "cpu":
        return target_attention_flash_ref(q, seq, mask)
    B, C, d = q.shape
    L = seq.shape[1]
    if seq.shape != (B, L, d) or mask.shape != (B, L) or d % 8 or d > 256:
        raise ValueError(f"target_attention_flash: shapes q {tuple(q.shape)} seq "
                         f"{tuple(seq.shape)} mask {tuple(mask.shape)} (the kernel "
                         f"takes d a multiple of 8 up to 256)")
    code = _build.dtype_code("target_attention_flash", seq, (torch.float32, torch.bfloat16))
    if q.dtype != torch.float32 or mask.dtype != torch.float32:
        raise TypeError("target_attention_flash: q and mask must be float32")
    dev = _build.require_cuda("target_attention_flash", q, seq, mask)
    _build.require_aligned("target_attention_flash", q, seq)
    out = torch.empty((B, C, d), dtype=torch.float32, device=dev)
    if B == 0 or C == 0:
        return out
    lib = _build.load()
    with _build.on_device(dev):
        err = lib.sdim_target_attention(q.data_ptr(), seq.data_ptr(), code, mask.data_ptr(),
                                        out.data_ptr(), B, L, C, d, _scale(d),
                                        _build.stream(dev))
    _build.check(err, "target_attention_flash")
    target_attention_flash.launches += 1
    return out


target_attention_flash.launches = 0
