"""SDIM hash-sampling attention (paper §4.1–4.2).

Counterpart of ``repro/core/sdim.py``:

* the bucket form: ``l2_normalize``, ``bucket_table`` (Eq. 8/11),
  ``gather_buckets``, ``combine_groups`` and ``fused_query`` (Eq. 12) and
  ``sdim_attention`` — the plain versions the kernels under ``kernels/``
  are held against;
* ``sdim_attention_gather`` — the literal Eq. 9/11/12 collision gather, an
  oracle equal to the bucket form (the same linear operator);
* ``sdim_expected_attention`` — the closed-form expectation of Eq. 14 (the
  m/τ → ∞ limit), the interest kind ``sdim_expected``. It has no kernel.

All bucket arithmetic in fp32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import simhash


def l2_normalize(v: torch.Tensor, eps: float = 1e-12, dim: int = -1) -> torch.Tensor:
    """v / sqrt(Σ v² + eps) — eps inside the sqrt, as the JAX package."""
    denom = torch.sqrt(torch.sum(torch.square(v.float()), dim=dim, keepdim=True) + eps)
    return (v / denom).to(v.dtype)


def bucket_table(seq: torch.Tensor, sig_seq: torch.Tensor,
                 mask: Optional[torch.Tensor], n_buckets: int) -> torch.Tensor:
    """Per-group signature-bucket sums T[b,g,u] = Σ_j 1[sig=u]·mask_j·s_j.

    seq (B, L, d), sig_seq (B, L, G), mask (B, L) or None -> (B, G, U, d) fp32.
    """
    onehot = F.one_hot(sig_seq.long(), n_buckets).float()           # (B,L,G,U)
    if mask is not None:
        onehot = onehot * mask[..., None, None].float()
    return torch.einsum("blgu,bld->bgud", onehot, seq.float())


def gather_buckets(table: torch.Tensor, sig_q: torch.Tensor) -> torch.Tensor:
    """table (B, G, U, d); sig_q (B, G) or (B, C, G) -> (B, G, d) / (B, C, G, d)."""
    U = table.shape[-2]
    onehot = F.one_hot(sig_q.long(), U).to(table.dtype)
    if sig_q.ndim == 2:
        return torch.einsum("bgu,bgud->bgd", onehot, table)
    return torch.einsum("bcgu,bgud->bcgd", onehot, table)


def combine_groups(per_group: torch.Tensor) -> torch.Tensor:
    """ℓ2-normalize each signature group's collision sum, then average over
    groups (Eq. 12). per_group (..., G, d) -> (..., d)."""
    return torch.mean(l2_normalize(per_group), dim=-2)


def fused_query(table: torch.Tensor, sig_q: torch.Tensor) -> torch.Tensor:
    """Gather each group's own bucket, ℓ2-normalize, mean over groups, as one
    multi-hot product against the row-normalized table.

    table (B, G, U, d); sig_q (B, G) or (B, C, G) -> (B, d) / (B, C, d) fp32.
    """
    B, G, U, d = table.shape
    tn = l2_normalize(table.reshape(B, G * U, d).float())
    offsets = torch.arange(G, dtype=torch.int64, device=sig_q.device) * U
    flat_idx = sig_q.long() + offsets
    multihot = F.one_hot(flat_idx, G * U).float().sum(dim=-2)
    if sig_q.ndim == 2:
        out = torch.einsum("bk,bkd->bd", multihot, tn)
    else:
        out = torch.einsum("bck,bkd->bcd", multihot, tn)
    return out / G


def sdim_attention(q: torch.Tensor, seq: torch.Tensor,
                   mask: Optional[torch.Tensor], R: torch.Tensor,
                   tau: int) -> torch.Tensor:
    """User-interest representation; output has q's leading shape + (d,)."""
    U = 1 << tau
    sig_seq = simhash.signatures(seq, R, tau)
    sig_q = simhash.signatures(q, R, tau)
    table = bucket_table(seq, sig_seq, mask, U)
    return fused_query(table, sig_q).to(seq.dtype)


def sdim_attention_gather(q: torch.Tensor, seq: torch.Tensor,
                          mask: Optional[torch.Tensor], R: torch.Tensor,
                          tau: int) -> torch.Tensor:
    """The literal collision gather of Eq. 9/11/12: per group, the sum of
    the behaviors whose signature equals the candidate's, then
    ``combine_groups``. Equal to ``sdim_attention``."""
    sig_seq = simhash.signatures(seq, R, tau)                   # (B, L, G)
    sig_q = simhash.signatures(q, R, tau)                       # (B, G) / (B, C, G)
    if sig_q.ndim == 2:
        p = (sig_seq == sig_q[:, None, :]).float()              # (B, L, G)
        if mask is not None:
            p = p * mask[:, :, None].float()
        per_group = torch.einsum("blg,bld->bgd", p, seq.float())
    else:
        p = (sig_seq[:, None, :, :] == sig_q[:, :, None, :]).float()   # (B, C, L, G)
        if mask is not None:
            p = p * mask[:, None, :, None].float()
        per_group = torch.einsum("bclg,bld->bcgd", p, seq.float())
    return combine_groups(per_group).to(seq.dtype)


def sdim_expected_attention(q: torch.Tensor, seq: torch.Tensor,
                            mask: Optional[torch.Tensor], tau: int) -> torch.Tensor:
    """E[Attn(q, S)] (Eq. 13/14): weights (1 − arccos(cos θ)/π)^τ over the
    valid behaviors, normalized by their sum (+1e-12). q (B, d) or
    (B, C, d) -> q's shape, in seq's dtype. Its gradient is non-finite
    where a cosine reaches ±1 (``simhash.collision_expectation``), in the
    JAX package as here."""
    qn = l2_normalize(q.float())
    sn = l2_normalize(seq.float())
    single = q.ndim == 2
    cos = torch.einsum("bd,bld->bl" if single else "bcd,bld->bcl", qn, sn)
    w = simhash.collision_expectation(cos, tau)
    if mask is not None:
        w = w * (mask.float() if single else mask[:, None, :].float())
    w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-12)
    out = torch.einsum("bl,bld->bd" if single else "bcl,bld->bcd", w, seq.float())
    return out.to(seq.dtype)
