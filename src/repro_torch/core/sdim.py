"""SDIM hash-sampling attention, bucket form (paper §4.1–4.2).

Counterpart of ``repro/core/sdim.py`` for what decoupled serving needs:
``l2_normalize``, ``bucket_table`` (Eq. 8/11), ``fused_query`` (Eq. 12) and
``sdim_attention``. Plain tensor code: the kernels under ``kernels/`` are
the fast versions and these are what they are held against. All bucket
arithmetic in fp32.
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
