"""Bidirectional multi-head attention of the CTR encoder blocks (BST,
BERT4Rec).

Counterpart of the parts of ``repro/nn/attention.py`` that
``models/ctr.py``'s ``EncoderBlock`` uses: ``rope_frequencies``,
``apply_rope``, ``masked_softmax`` and ``GQAttention.apply`` with
``causal=False``, ``use_bias=True`` and as many key/value heads as query
heads. As there, RoPE rotates q and k (positions ``arange(T)``) even where
the model also adds a learned position embedding, and a masked score is
replaced by -1e30 before an fp32 softmax, so a query whose keys are all
masked attends uniformly to every key (a user with no recent behavior in
BERT4Rec's front-padded window). ``scaled_dot_product_attention`` with a
boolean mask gives NaN there, so the scores go through the plain einsum
and softmax. The LM parts (KV caches, query chunking, MLA, grouped heads)
belong to the LM stack, which the port has not taken up.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.nn.layers import Linear


def rope_frequencies(head_dim: int, positions: torch.Tensor, theta: float = 10000.0):
    """(cos, sin) of shape positions.shape + (head_dim / 2,), fp32."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device),
                           exponent)
    angles = positions[..., None].float() * freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., T, H, D); cos/sin (..., T, D/2), broadcast over the heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def masked_softmax(scores: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Softmax over the last axis in fp32; where ``mask`` is False the
    score is -1e30 (a row with no True attends uniformly)."""
    scores = scores.float()
    if mask is not None:
        scores = torch.where(mask, scores, torch.full((), -1e30, device=scores.device))
    return torch.softmax(scores, dim=-1)


class GQAttention(nn.Module):
    """Bidirectional multi-head self-attention with biased projections
    ``wq``, ``wk``, ``wv``, ``wo`` and RoPE (theta 10,000) on q and k."""

    def __init__(self, d_model: int, n_heads: int, head_dim: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_heads, self.head_dim = n_heads, head_dim
        inner = n_heads * head_dim
        for name, (i, o) in (("wq", (d_model, inner)), ("wk", (d_model, inner)),
                             ("wv", (d_model, inner)), ("wo", (inner, d_model))):
            self.add_module(name, Linear(i, o, True, device=device, generator=generator))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x (B, T, d_model), mask (B, T, T) bool (True: attend) -> (B, T,
        d_model)."""
        B, T, _ = x.shape
        H, D = self.n_heads, self.head_dim
        q = self.wq(x).reshape(B, T, H, D)
        k = self.wk(x).reshape(B, T, H, D)
        v = self.wv(x).reshape(B, T, H, D)
        cos, sin = rope_frequencies(D, torch.arange(T, device=x.device)[None])
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) / math.sqrt(D)
        probs = masked_softmax(scores, mask[:, None])
        out = torch.einsum("bhts,bshd->bthd", probs.to(v.dtype), v)
        return self.wo(out.reshape(B, T, H * D))
