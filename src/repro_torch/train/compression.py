"""Gradient compression with error feedback (the EF-SGD / 1-bit-Adam family).

The port's counterpart of ``repro/train/compression.py``: a gradient is
quantized to int8 (one absmax scale per tensor) or rounded to bf16 before
it would cross the interconnect, and the quantization residual is carried
in an error-feedback buffer, so the compression bias vanishes over steps
[Seide et al. 2014; Karimireddy et al. 2019]. The train loop applies it
around the optimizer (``LoopConfig.compress``). ``compress_tree_int8`` /
``decompress_tree_int8`` do a whole tensor dict at once.

``compressed_psum`` is the reference's int8 mean over the data axis, run
over the data blocks' gradient dicts in one process: one scale shared by
all blocks (the largest ``max|g|`` of any block, / 127, + 1e-12), each
block rounded half to even and clipped to int8 (the payload a link would
carry, a quarter of fp32's bytes), the payloads summed as int32 in block
order on the first block's device, and the sum times the scale over the
number of blocks handed back to every block on its own device.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

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


def compress_tree_int8(tree: Tensors) -> Tuple[Tensors, Tensors]:
    """Every tensor of ``tree`` -> (int8 values by name, scales by name)."""
    qs = {k: quantize_int8(t) for k, t in tree.items()}
    return {k: q for k, (q, _) in qs.items()}, {k: s for k, (_, s) in qs.items()}


def decompress_tree_int8(q: Tensors, s: Tensors) -> Tensors:
    return {k: dequantize_int8(q[k], s[k]) for k in q}


def compressed_psum(blocks: List[Tensors]) -> List[Tensors]:
    """The int8 mean of the data blocks' gradient dicts (one dict a
    block, each on its block's device) -> one dict a block, each the mean
    on its block's device."""
    n = len(blocks)
    out: List[Tensors] = [{} for _ in blocks]
    for k in blocks[0]:
        gs = [b[k].float() for b in blocks]
        home = gs[0].device
        scale = torch.max(torch.stack([torch.max(torch.abs(g)).to(home) for g in gs]))
        scale = scale / 127.0 + 1e-12
        qs = [torch.clamp(torch.round(g / scale.to(g.device)), -127, 127).to(torch.int8)
              for g in gs]
        qsum = qs[0].to(torch.int32)
        for q in qs[1:]:
            qsum = qsum + q.to(home, torch.int32)
        mean = qsum.float() * scale / float(n)
        for b, g in zip(out, gs):
            b[k] = mean.to(g.device, copy=True)
    return out


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
