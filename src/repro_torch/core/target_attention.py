"""Target attention (DIN, paper §3.2) and DIN's activation unit.

Counterpart of ``repro/core/target_attention.py``:

* ``target_attention`` — softmax(q·Sᵀ/√d) S: the short-term branch of the
  CTR model, and the function the long-term kind ``"target"`` and the
  retrieval baselines compute through ``kernels/target_attn`` (the DIN
  long-sequence baseline); plain PyTorch, as the JAX package leaves it to
  XLA outside any kernel.
* ``DinActivationUnit`` — DIN's own attention, a(q, s) = sigmoid(MLP([q, s,
  q − s, q ⊙ s])) with no softmax: the interest kind ``din_mlp``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.nn.layers import MLP


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


class DinActivationUnit(nn.Module):
    """Parametric DIN attention: weights sigmoid(MLP([q, s, q − s, q ⊙ s]))
    over the behaviors, not softmax-normalized (DIN keeps the intensity of
    interest), summed with the behaviors. The MLP (4d -> 36 -> 1, relu) is
    ``mlp.fc{i}``, the JAX package's ``mlp.fc{i}.{w,b}``.

    The feature tensor is (B, C, L, 4d): 4.3 GB in fp32 for a 16-request
    burst of 128 candidates over L = 1024, d = 128. The candidates are taken
    in chunks whose feature tensor holds at most ``CHUNK_ELEMS`` values
    (1 GiB in fp32); each candidate's arithmetic is the same either way.
    """

    CHUNK_ELEMS = 1 << 28

    def __init__(self, d: int, hidden: Sequence[int] = (36,), *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d = d
        self.mlp = MLP(4 * d, [*hidden, 1], "relu", device=device, generator=generator)

    def forward(self, q: torch.Tensor, seq: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """q (B, d) or (B, C, d) against seq (B, L, d) [+ mask (B, L)] -> q's
        shape, in seq's dtype."""
        single = q.ndim == 2
        qc = q[:, None, :] if single else q
        B, C, d = qc.shape
        L = seq.shape[1]
        step = max(1, self.CHUNK_ELEMS // max(B * L * 4 * d, 1))
        out = torch.cat([self._weigh(qc[:, i:i + step], seq, mask)
                         for i in range(0, max(C, 1), step)], dim=1)
        return out[:, 0] if single else out

    def _weigh(self, qc: torch.Tensor, seq: torch.Tensor,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
        B, C, d = qc.shape
        L = seq.shape[1]
        qe = qc[:, :, None, :].expand(B, C, L, d)
        se = seq[:, None, :, :].expand(B, C, L, d)
        feats = torch.cat([qe, se, qe - se, qe * se], dim=-1)
        w = torch.sigmoid(self.mlp(feats)[..., 0])                      # (B, C, L)
        if mask is not None:
            w = w * mask[:, None, :].to(w.dtype)
        return torch.einsum("bcl,bld->bcd", w.float(), seq.float()).to(seq.dtype)
