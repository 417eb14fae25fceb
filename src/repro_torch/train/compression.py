"""Gradient compression with error feedback (the EF-SGD / 1-bit-Adam family).

The port's counterpart of ``repro/train/compression.py``: a gradient is
quantized to int8 (one absmax scale per tensor) or rounded to bf16 before
it would cross the interconnect, and the quantization residual is carried
in an error-feedback buffer, so the compression bias vanishes over steps
[Seide et al. 2014; Karimireddy et al. 2019]. The train loop applies it
around the optimizer (``LoopConfig.compress``). The JAX package's
``compressed_psum`` (int8 on the data-parallel wire) waits for the port's
multi-device slice.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 values, 0-d fp32 scale max|x| / 127 + 1e-12); rounding
    half to even, as jnp.round."""
    xf = x.float()
    scale = torch.max(torch.abs(xf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(tensors: Tensors) -> Tensors:
    return {k: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            for k, t in tensors.items()}


def ef_compress(grads: Tensors, ef: Tensors, mode: str = "int8") -> Tuple[Tensors, Tensors]:
    """(grads + residual) -> (compressed grads, new residual), by name."""
    comp, new_ef = {}, {}
    for k, g in grads.items():
        gf = g.float() + ef[k]
        if mode == "int8":
            deq = dequantize_int8(*quantize_int8(gf))
        elif mode == "bf16":
            deq = gf.to(torch.bfloat16).float()
        else:
            raise ValueError(mode)
        comp[k], new_ef[k] = deq, gf - deq
    return comp, new_ef
