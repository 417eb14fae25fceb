"""Retrieval-based long-term interest baselines the paper compares against
(Tables 2/3).

Counterpart of ``repro/core/retrieval.py``:

* ``avg_pooling``  — DIN(Avg-Pooling): the masked mean of the history.
* ``sim_hard``     — SIM(hard): behaviors of the candidate's category, the
  most recent k of them, then target attention.
* ``eta``          — ETA: SimHash both sides, the k behaviors of largest
  Hamming similarity to the candidate, then target attention.
* ``UBR4CTRLite``  — UBR4CTR simplified: a learned query/key projection
  scores the behaviors, top k, then target attention.

The attention over the k retrieved rows is exact target attention through
the ``target_attention_flash`` kernel (its plain version for CPU tensors),
with the candidates folded into users: q (B·C, 1, d), seq (B·C, k, d),
mask (B·C, k). A candidate with fewer than k eligible rows masks the rest;
one with none attends uniformly over the k rows it gathered, as the kernel
and the JAX package do for a fully masked user.

Top-k breaks ties as ``jax.lax.top_k`` does: the larger score first and,
among equal scores (-inf included), the lower index first — a stable
descending sort. ETA's scores are integers, so ties are the normal case.
The scores only choose rows: no gradient flows through them, so
``UBR4CTRLite``'s projections get none (``jax.grad`` gives them exactly 0).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.core import simhash
from repro_torch.kernels.target_attn.target_attn import target_attention_flash
from repro_torch.nn.layers import Linear


def avg_pooling(seq: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, L, d), (B, L) -> (B, d) masked mean."""
    if mask is None:
        return torch.mean(seq, dim=1)
    m = mask.float()
    s = torch.einsum("bl,bld->bd", m, seq.float())
    return (s / (torch.sum(m, dim=1, keepdim=True) + 1e-9)).to(seq.dtype)


def top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest scores along the last axis, in
    ``jax.lax.top_k``'s order (ties: lower index first)."""
    if k > scores.shape[-1]:
        raise ValueError(f"top_k: k = {k} exceeds the {scores.shape[-1]} scores")
    values, indices = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def retrieve_attend(q: torch.Tensor, seq: torch.Tensor, scores: torch.Tensor,
                    k: int) -> torch.Tensor:
    """q (B, C, d) attends over the top-k rows of seq (B, L, d) by scores
    (B, C, L), -inf where a row may not be retrieved -> (B, C, d) in seq's
    dtype."""
    B, C, d = q.shape
    with torch.no_grad():
        top, idx = top_k(scores, k)                                     # (B, C, k)
        sub_mask = torch.isfinite(top).float()
    users = torch.arange(B, device=seq.device)[:, None, None]
    sub_seq = seq[users, idx]                                           # (B, C, k, d)
    out = target_attention_flash(q.float().reshape(B * C, 1, d).contiguous(),
                                 sub_seq.reshape(B * C, k, d).contiguous(),
                                 sub_mask.reshape(B * C, k).contiguous())
    return out.reshape(B, C, d).to(seq.dtype)


def _masked(scores: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """scores (B, C, L) with -inf where mask (B, L) is 0."""
    if mask is None:
        return scores
    return torch.where(mask[:, None, :] > 0, scores,
                       torch.full((), float("-inf"), device=scores.device))


def sim_hard(q: torch.Tensor, seq: torch.Tensor, mask: Optional[torch.Tensor],
             seq_cat: torch.Tensor, q_cat: torch.Tensor, k: int) -> torch.Tensor:
    """SIM(hard): q (B, d) or (B, C, d) with category ids q_cat (B,) or
    (B, C) against seq (B, L, d) with seq_cat (B, L): the most recent k
    valid behaviors of the candidate's category, then target attention."""
    single = q.ndim == 2
    qc = q[:, None, :] if single else q
    qcat = q_cat[:, None] if single else q_cat
    L = seq.shape[1]
    with torch.no_grad():
        match = seq_cat[:, None, :] == qcat[:, :, None]                # (B, C, L)
        if mask is not None:
            match = match & (mask[:, None, :] > 0)
        recency = torch.arange(L, dtype=torch.float32, device=seq.device) / L
        scores = torch.where(match, 1.0 + recency,
                             torch.full((), float("-inf"), device=seq.device))
    out = retrieve_attend(qc, seq, scores, k)
    return out[:, 0] if single else out


def eta(q: torch.Tensor, seq: torch.Tensor, mask: Optional[torch.Tensor],
        R: torch.Tensor, k: int) -> torch.Tensor:
    """ETA: the k behaviors whose SimHash codes (R (m, d)) match the
    candidate's in the most bits, then target attention. The projection is
    IEEE fp32, as in the kernels: on the card TF32 matmuls must be off."""
    if seq.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("eta hashes in IEEE fp32: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    single = q.ndim == 2
    qc = q[:, None, :] if single else q
    with torch.no_grad():
        codes_s = simhash.hash_codes(seq, R).float()                   # (B, L, m)
        codes_q = simhash.hash_codes(qc, R).float()                    # (B, C, m)
        sim = (torch.einsum("bcm,blm->bcl", codes_q, codes_s)
               + torch.einsum("bcm,blm->bcl", 1 - codes_q, 1 - codes_s))
        scores = _masked(sim, mask)
    out = retrieve_attend(qc, seq, scores, k)
    return out[:, 0] if single else out


class UBR4CTRLite(nn.Module):
    """Learned retrieval: score = (W_q q)·(W_k s), top k, target attention.
    ``wq`` and ``wk`` are the JAX package's ``wq.w`` and ``wk.w`` (no bias)."""

    def __init__(self, d: int, k: int, proj_dim: int = 32, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d, self.k, self.proj_dim = d, k, proj_dim
        self.wq = Linear(d, proj_dim, False, device=device, generator=generator)
        self.wk = Linear(d, proj_dim, False, device=device, generator=generator)

    def forward(self, q: torch.Tensor, seq: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        single = q.ndim == 2
        qc = q[:, None, :] if single else q
        with torch.no_grad():
            sim = torch.einsum("bcp,blp->bcl", self.wq(qc).float(), self.wk(seq).float())
            scores = _masked(sim, mask)
        out = retrieve_attend(qc, seq, scores, self.k)
        return out[:, 0] if single else out
