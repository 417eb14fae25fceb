"""SDIM hash-sampling attention (paper §4.1–4.2).

Counterpart of ``repro/core/sdim.py``:

* the bucket form: ``l2_normalize``, ``bucket_table`` (Eq. 8/11),
  ``gather_buckets``, ``combine_groups`` and ``fused_query`` (Eq. 12) and
  ``sdim_attention`` — the plain versions the kernels under ``kernels/``
  are held against;
* ``sdim_attention_gather`` — the literal Eq. 9/11/12 collision gather, an
  oracle equal to the bucket form (the same linear operator);
* ``sdim_expected_attention`` — the closed-form expectation of Eq. 14 (the
  m/τ → ∞ limit), the interest kind ``sdim_expected``. It has no kernel;
* the paper's technique applied to LM decode: ``kv_bucket_table`` (an
  exact KV cache folded into per-head bucket tables of values keyed on the
  keys' signatures, ``kv_signatures``), ``kv_bucket_fold`` (one new row
  folded in place) and
  ``sdim_decode_attention`` (queries read their kv head's buckets; the ℓ2
  form through the ``sdim_query`` kernel).

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


# ---------------------------------------------------------------------------
# SDIM-compressed KV attention (the paper's technique applied to LM decode)
# ---------------------------------------------------------------------------
def kv_signatures(k: torch.Tensor, R: torch.Tensor, tau: int) -> torch.Tensor:
    """Keys (..., dk) -> bucket ids (..., G), bit = [r·k >= 0] with the
    projection in fp64: the products of fp32 values are exact there and the
    sum's rounding (~1e-16 of its terms) flips no sign that matters, so a
    key gets the same ids whether hashed alone (a decode step's fold) or
    among a cache's rows (the offline encode), whichever GEMM the two
    shapes select. An fp32 projection of 128 terms rounds at ~1e-7 and its
    order depends on the GEMM: at full width ~1 key in 10^5 could change
    bucket between the two paths. Against the reference's fp32 hash a key
    differs only where its fp32 projection is within rounding of 0. R may
    be given in fp64 (``LMModel.R64``), which saves its cast a call."""
    proj = torch.einsum("...d,md->...m", k.double(), R.double())
    return simhash.pack_signatures((proj >= 0).to(torch.int32), tau)


def kv_bucket_table(k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor],
                    R: torch.Tensor, tau: int):
    """Per-head bucket sums of values keyed on the keys' signatures: k (B,
    S, H, dk), v (B, S, H, dv), mask (B, S) or None -> (value table (B, H,
    G, U, dv), count table (B, H, G, U)), fp32. O(G·U·dv) state a head
    instead of O(S·dv). A one-hot contraction over S, as the reference
    (``repro/core/sdim.py:157-175``): one GEMM a (b, h), the same bits on
    every run (no ``index_add_``, whose CUDA sums are not)."""
    U = 1 << tau
    onehot = F.one_hot(kv_signatures(k, R, tau).long(), U).float()       # (B, S, H, G, U)
    if mask is not None:
        onehot = onehot * mask[:, :, None, None, None].float()
    vt = torch.einsum("bshgu,bshd->bhgud", onehot, v.float())
    ct = torch.einsum("bshgu->bhgu", onehot)
    return vt, ct


def kv_bucket_fold(value_table: torch.Tensor, count_table: torch.Tensor,
                   k: torch.Tensor, v: torch.Tensor, R: torch.Tensor, tau: int) -> None:
    """Fold one new row per (b, h) into the tables in place: k (B, H, dk),
    v (B, H, dv); value_table (B, H, G, U, dv) and count_table (B, H, G, U)
    contiguous fp32. The reference adds ``kv_bucket_table`` of the row
    (``repro/models/lm.py:277-278``), a one-hot product with one hit per
    (b, h, g); here each hit cell gets ``+= v`` and ``+= 1`` through an
    indexed write whose B·H·G indices are all distinct, so the same bits
    as the reference's sum and deterministic on the card."""
    B, H, G, U, dv = value_table.shape
    sig = kv_signatures(k, R, tau).reshape(-1).long()                     # (B·H·G,)
    cells = torch.arange(B * H * G, device=sig.device) * U + sig
    vt, ct = value_table.view(-1, dv), count_table.view(-1)
    vt[cells] += v.float()[:, :, None, :].expand(B, H, G, dv).reshape(-1, dv)
    ct[cells] += 1.0


def sdim_decode_attention(q: torch.Tensor, value_table: torch.Tensor,
                          count_table: torch.Tensor, R: torch.Tensor, tau: int,
                          normalize: str = "l2") -> torch.Tensor:
    """Queries q (B, T, H, dk) read the buckets of their key/value head:
    value_table (B, Hkv, G, U, dv), count_table (B, Hkv, G, U), Hkv
    dividing H (query head h reads kv head h // (H / Hkv); Hkv = H is the
    reference's layout after its ``jnp.repeat``) -> (B, T, H, dv) fp32.

    ``"l2"`` (the paper's Eq. 12): each group's own bucket ℓ2-normalized,
    averaged over the groups, through ``kernels/sdim_query.sdim_query``
    (the Pallas ``sdim_query``'s counterpart) with one table row per (b,
    kv head) and its T·H/Hkv queries as the candidates; the tables are
    never repeated per query head. ``"count"``: each bucket's value sum over
    its count (+1e-9), averaged over the groups, in plain PyTorch."""
    from repro_torch.kernels.sdim_query.sdim_query import sdim_query

    B, T, H, dk = q.shape
    Hkv, G, U, dv = value_table.shape[1:]
    if H % Hkv or value_table.shape[0] != B or count_table.shape != value_table.shape[:-1]:
        raise ValueError(f"sdim_decode_attention: q {tuple(q.shape)}, value table "
                         f"{tuple(value_table.shape)}, count table {tuple(count_table.shape)}")
    Gq = H // Hkv
    if normalize == "l2":
        qk = q.float().reshape(B, T, Hkv, Gq, dk).transpose(1, 2).reshape(B * Hkv, T * Gq, dk)
        out = sdim_query(qk.contiguous(), value_table.reshape(B * Hkv, G, U, dv), R, tau)
        return out.reshape(B, Hkv, T, Gq, dv).transpose(1, 2).reshape(B, T, H, dv)
    if normalize != "count":
        raise ValueError(f"normalize {normalize!r} not in ('l2', 'count')")
    sig_q = simhash.signatures(q, R, tau).reshape(B, T, Hkv, Gq, G)
    onehot = F.one_hot(sig_q.long(), U).to(value_table.dtype)           # (B, T, Hkv, Gq, G, U)
    per_group = torch.einsum("btkqgu,bkgud->btkqgd", onehot, value_table)
    cnt = torch.einsum("btkqgu,bkgu->btkqg", onehot, count_table)
    out = torch.mean(per_group / (cnt[..., None] + 1e-9), dim=-2)
    return out.reshape(B, T, H, dv)
