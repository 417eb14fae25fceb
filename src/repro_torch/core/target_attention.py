"""Target attention (DIN, paper §3.2): the short-term branch of the CTR
model, and the function the long-term kind ``"target"`` computes through
``kernels/target_attn`` (the DIN long-sequence baseline). Counterpart of
``repro/core/target_attention.py::target_attention``; plain PyTorch, as the
JAX package leaves it to XLA outside any kernel."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def default_scale(d: int) -> float:
    """1/√d rounded as fp32, as jnp computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def target_attention(q: torch.Tensor, seq: torch.Tensor,
                     mask: Optional[torch.Tensor],
                     scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q·Sᵀ/√d) S — q (B, d) or (B, C, d), seq (B, L, d), mask
    (B, L). Masked logits are −1e30, so a fully masked row attends
    uniformly."""
    if scale is None:
        scale = default_scale(q.shape[-1])
    single = q.ndim == 2
    qc = q[:, None, :] if single else q
    scores = torch.einsum("bcd,bld->bcl", qc.float(), seq.float()) * scale
    if mask is not None:
        scores = torch.where(mask[:, None, :] > 0, scores,
                             torch.full((), -1e30, dtype=scores.dtype, device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bcl,bld->bcd", probs, seq.float()).to(seq.dtype)
    return out[:, 0] if single else out
