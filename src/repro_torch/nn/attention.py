"""Grouped-query attention: the CTR encoder blocks' bidirectional attention
(BST, BERT4Rec) and the dense LM family's causal attention with a KV cache.

Counterpart of ``repro/nn/attention.py``: ``rope_frequencies``,
``apply_rope``, ``_causal_mask``, ``masked_softmax`` and ``GQAttention``
(``n_kv_heads``, ``qk_norm``, ``use_bias``, ``rope_theta``, ``causal``; the
masked ``_attend``, the query-chunked ``_attend_chunked``, ``init_cache``
and ``decode_step``). The CTR encoder (``models/ctr.py``) builds it with the
defaults here: bidirectional, biased, as many key/value heads as query
heads; the LM blocks (``nn/transformer.py``) pass the reference's LM
settings. As there, RoPE rotates q and k (positions ``arange(T)`` unless
given) even where a model also adds a learned position embedding, and a
masked score is replaced by -1e30 before an fp32 softmax, so a query whose
keys are all masked attends uniformly to every key (a user with no recent
behavior in BERT4Rec's front-padded window).
``scaled_dot_product_attention`` with a boolean mask gives NaN there, so
the scores go through the plain einsum and softmax.

Three departures in layout, none in the function:

* Each query head reads its own key/value head in place (q viewed as
  ``(B, T, n_kv_heads, group, D)``): the reference repeats k and v to
  ``n_heads`` heads (``jnp.repeat``), which at a 32k cache is 4 × 537 MB a
  layer and step.
* The cache is head-major, (B, n_kv_heads, S, D) where the reference's is
  (B, S, n_kv_heads, D): each (b, kv head) owns a contiguous (S, D) slab,
  so a decode step's scores and its weighted sum of values are batched
  matrix products over B·n_kv_heads slabs, and a run of rows is a view.
  From 2 · ``DECODE_ROW_CHUNK`` rows on, the weighted sum is split over
  the rows (``_weighted_values``): one product over all S rows gives
  cuBLAS a few long, thin GEMMs that it runs on a few SMs, far slower than
  one read of the cache at 32k rows (PERF.md §6).
* The cache is written in place (the new row at ``cache_len``) where the
  reference returns an updated copy, and a decode step reads the cache's
  first ``cache_len + 1`` rows only: the rows the reference masks with
  -1e30 have a softmax weight of exactly 0. The chunked prefill reads, for
  the query chunk ending at position p, the keys up to p, for the same
  reason. Sums run in another order than the reference's, so results agree
  to fp32 rounding.

``MLAttention`` is the counterpart of the reference's multi-head latent
attention (DeepSeek-V2): keys and values are compressed into a
``kv_lora_rank`` latent c_kv plus one shared RoPE key, and attention runs
in the absorbed form (the query through ``wk_b`` into latent space, the
output through ``wv_b`` out of it), so its cache holds c_kv (B, S, r) and
k_rope (B, S, dr) only, in the reference's layout. Its decode writes the
cache in place, reads the first ``cache_len + 1`` rows and splits long
weighted sums over rows, as ``GQAttention``'s. The sequence-parallel decode
attention waits for the tooling slice (ROADMAP.md, A5).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.nn.layers import Linear, RMSNorm


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


def _causal_mask(q_len: int, kv_len: int, q_offset: int = 0, device=None) -> torch.Tensor:
    """Boolean (q_len, kv_len), True = attend: query i sits at absolute
    position q_offset + i and sees the keys at positions <= its own."""
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    return torch.arange(kv_len, device=device)[None, :] <= q_pos


DECODE_ROW_CHUNK = 1024       # cache rows a partial product of a decode step sums


def _weighted_values(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p (B, Hkv, G, n) @ v (B, Hkv, n, D) -> (B, Hkv, G, D). From two
    chunks of ``DECODE_ROW_CHUNK`` rows on, one batched product a chunk
    (the chunks' partial sums added, then the rows left over), so the work
    spreads over B·Hkv·chunks GEMMs instead of B·Hkv."""
    B, Hkv, G, n = p.shape
    s = DECODE_ROW_CHUNK
    c = n // s
    if c < 2:
        return torch.matmul(p, v)
    m = c * s
    out = torch.matmul(p[..., :m].reshape(B, Hkv, G, c, s).transpose(2, 3),
                       v[:, :, :m].reshape(B, Hkv, c, s, -1)).sum(2)
    if m < n:
        out = out + torch.matmul(p[..., m:], v[:, :, m:])
    return out


def masked_softmax(scores: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Softmax over the last axis in fp32; where ``mask`` is False the
    score is -1e30 (a row with no True attends uniformly)."""
    scores = scores.float()
    if mask is not None:
        scores = torch.where(mask, scores, torch.full((), -1e30, device=scores.device))
    return torch.softmax(scores, dim=-1)


class GQAttention(nn.Module):
    """Multi-head attention with ``n_kv_heads`` key/value heads shared by
    groups of ``n_heads / n_kv_heads`` query heads (query head h reads
    key/value head h // group), projections ``wq``, ``wk``, ``wv``, ``wo``,
    optional per-head ``q_norm``/``k_norm`` (RMSNorm before RoPE) and RoPE
    at ``rope_theta``. Causal attention over T >= 2 * ``q_chunk`` without an
    explicit mask runs query chunk by query chunk."""

    def __init__(self, d_model: int, n_heads: int, head_dim: int, *,
                 n_kv_heads: Optional[int] = None, qk_norm: bool = False,
                 use_bias: bool = True, rope_theta: float = 10000.0, causal: bool = False,
                 q_chunk: int = 1024, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n_kv_heads = n_heads if n_kv_heads is None else n_kv_heads
        if n_heads % n_kv_heads:
            raise ValueError(f"n_heads {n_heads} is not a multiple of n_kv_heads {n_kv_heads}")
        self.n_heads, self.n_kv_heads, self.head_dim = n_heads, n_kv_heads, head_dim
        self.rope_theta, self.causal, self.q_chunk = rope_theta, causal, q_chunk
        kw = dict(device=device, generator=generator)
        self.wq = Linear(d_model, n_heads * head_dim, use_bias, **kw)
        self.wk = Linear(d_model, n_kv_heads * head_dim, use_bias, **kw)
        self.wv = Linear(d_model, n_kv_heads * head_dim, use_bias, **kw)
        self.wo = Linear(n_heads * head_dim, d_model, use_bias, **kw)
        self.qk_norm = qk_norm
        if qk_norm:
            self.q_norm = RMSNorm(head_dim, device=device)
            self.k_norm = RMSNorm(head_dim, device=device)

    @property
    def n_groups(self) -> int:
        return self.n_heads // self.n_kv_heads

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """x (B, T, d_model), positions (B, T) -> q (B, T, H, D) and k, v
        (B, T, Hkv, D), q and k normed (qk_norm) and rotated."""
        B, T, _ = x.shape
        D = self.head_dim
        q = self.wq(x).reshape(B, T, self.n_heads, D)
        k = self.wk(x).reshape(B, T, self.n_kv_heads, D)
        v = self.wv(x).reshape(B, T, self.n_kv_heads, D)
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        cos, sin = rope_frequencies(D, positions, self.rope_theta)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def _attend(self, q, k, v, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """q (B, T, H, D), k/v (B, S, Hkv, D), mask (B, T, S) or (T, S) bool
        or None -> (B, T, H * D); each query head against its own kv head."""
        B, T, H, D = q.shape
        Hkv = k.shape[2]
        qg = q.reshape(B, T, Hkv, H // Hkv, D)
        scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) / math.sqrt(D)
        if mask is not None:
            mask = mask[:, None, None] if mask.ndim == 3 else mask
        probs = masked_softmax(scores, mask)
        out = torch.einsum("bkgts,bskd->btkgd", probs.to(v.dtype), v)
        return out.reshape(B, T, H * D)

    def _attend_chunked(self, q, k, v) -> torch.Tensor:
        """Causal attention over query chunks of ``q_chunk`` rows (q
        positions 0..T-1 against k/v of the same length): the score slab
        is (B, H, chunk, keys up to the chunk's end), never (B, H, T, T)."""
        B, T, H, D = q.shape
        c = self.q_chunk
        if T % c:
            raise ValueError(f"chunked attention needs T % q_chunk == 0, got T {T}, "
                             f"q_chunk {c}")
        outs = []
        for i in range(T // c):
            end = (i + 1) * c
            mask = _causal_mask(c, end, i * c, device=q.device)
            outs.append(self._attend(q[:, i * c:end], k[:, :end], v[:, :end], mask))
        return torch.cat(outs, dim=1)

    def forward(self, x: torch.Tensor, positions: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence attention. x (B, T, d_model); positions (B, T)
        (default ``arange(T)``); mask (B, T, T) bool, True: attend (default
        causal where ``causal``) -> (B, T, d_model)."""
        B, T, _ = x.shape
        if positions is None:
            positions = torch.arange(T, device=x.device)[None]
        q, k, v = self.qkv(x, positions)
        if mask is None and self.causal and T >= 2 * self.q_chunk:
            out = self._attend_chunked(q, k, v)
        else:
            if mask is None and self.causal:
                mask = _causal_mask(T, T, device=x.device)
            out = self._attend(q, k, v, mask)
        return self.wo(out)

    # -- serving ------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> dict:
        """Zero k and v caches (batch, n_kv_heads, max_len, head_dim)."""
        shape = (batch, self.n_kv_heads, max_len, self.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def decode_step(self, x: torch.Tensor, cache: dict, cache_len: int):
        """x (B, 1, d_model) at position ``cache_len``, where ``cache`` holds
        ``cache_len`` valid rows. Writes the new key and value into row
        ``cache_len`` of ``cache`` in place; returns (out (B, 1, d_model),
        cache). Each kv head's query heads attend to its first
        ``cache_len + 1`` rows: scores (B, Hkv, group, n) and their
        weighted sum of values (``_weighted_values``), batched products
        over the (n, D) slabs."""
        B, Hkv, S, D = cache["k"].shape
        if not 0 <= cache_len < S:
            raise ValueError(f"decode at position {cache_len} of a cache of {S} rows")
        positions = torch.full((B, 1), cache_len, dtype=torch.int32, device=x.device)
        q, k_new, v_new = self.qkv(x, positions)
        cache["k"][:, :, cache_len] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, :, cache_len] = v_new[:, 0].to(cache["v"].dtype)
        n = cache_len + 1
        k, v = cache["k"][:, :, :n], cache["v"][:, :, :n]
        qg = q.reshape(B, Hkv, self.n_groups, D).float()
        scores = torch.matmul(qg, k.float().transpose(-1, -2)) / math.sqrt(D)
        out = _weighted_values(masked_softmax(scores, None).to(v.dtype), v)   # (B, Hkv, group, D)
        return self.wo(out.reshape(B, 1, self.n_heads * D)), cache


class MLAttention(nn.Module):
    """Multi-head latent attention with decoupled RoPE. Projections (each a
    bias-free ``Linear``): ``wq_a`` (d_model -> q_lora_rank), ``q_a_norm``,
    ``wq_b`` (-> H·(dn + dr)), ``wkv_a`` (d_model -> r + dr), ``kv_a_norm``
    (on c_kv), ``wk_b`` (r -> H·dn), ``wv_b`` (r -> H·dv), ``wo`` (H·dv ->
    d_model). Scores are q_nope·wk_b against c_kv plus q_rope·k_rope, scaled
    by 1/√(dn + dr); causal attention over T >= 2·``q_chunk`` without an
    explicit mask runs query chunk by query chunk."""

    def __init__(self, d_model: int, n_heads: int, kv_lora_rank: int = 512,
                 q_lora_rank: int = 1536, nope_head_dim: int = 128, rope_head_dim: int = 64,
                 v_head_dim: int = 128, rope_theta: float = 10000.0, causal: bool = True,
                 q_chunk: int = 1024, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        H, dn, dr, dv = n_heads, nope_head_dim, rope_head_dim, v_head_dim
        self.n_heads, self.kv_lora_rank, self.nope_head_dim = H, kv_lora_rank, dn
        self.rope_head_dim, self.v_head_dim = dr, dv
        self.rope_theta, self.causal, self.q_chunk = rope_theta, causal, q_chunk
        kw = dict(device=device, generator=generator)
        self.wq_a = Linear(d_model, q_lora_rank, False, **kw)
        self.q_a_norm = RMSNorm(q_lora_rank, device=device)
        self.wq_b = Linear(q_lora_rank, H * (dn + dr), False, **kw)
        self.wkv_a = Linear(d_model, kv_lora_rank + dr, False, **kw)
        self.kv_a_norm = RMSNorm(kv_lora_rank, device=device)
        self.wk_b = Linear(kv_lora_rank, H * dn, False, **kw)
        self.wv_b = Linear(kv_lora_rank, H * dv, False, **kw)
        self.wo = Linear(H * dv, d_model, False, **kw)

    @property
    def scale(self) -> float:
        return 1.0 / math.sqrt(self.nope_head_dim + self.rope_head_dim)

    def q(self, x: torch.Tensor, positions: torch.Tensor):
        """x (B, T, d_model), positions (B, T) -> q_nope (B, T, H, dn) and
        q_rope (B, T, H, dr), rotated."""
        B, T, _ = x.shape
        H, dn, dr = self.n_heads, self.nope_head_dim, self.rope_head_dim
        q = self.wq_b(self.q_a_norm(self.wq_a(x))).reshape(B, T, H, dn + dr)
        cos, sin = rope_frequencies(dr, positions, self.rope_theta)
        return q[..., :dn], apply_rope(q[..., dn:], cos, sin)

    def kv_latent(self, x: torch.Tensor, positions: torch.Tensor):
        """x (B, T, d_model) -> c_kv (B, T, r), normed, and the shared k_rope
        (B, T, dr), rotated."""
        r = self.kv_lora_rank
        kv = self.wkv_a(x)
        cos, sin = rope_frequencies(self.rope_head_dim, positions, self.rope_theta)
        return self.kv_a_norm(kv[..., :r]), apply_rope(kv[..., None, r:], cos, sin)[..., 0, :]

    def absorb_q(self, q_nope: torch.Tensor) -> torch.Tensor:
        """q_nope (B, T, H, dn) -> its latent form q_nope·wk_b (B, T, H, r)."""
        wk_b = self.wk_b.weight.view(self.n_heads, self.nope_head_dim, self.kv_lora_rank)
        return torch.einsum("bthd,hdr->bthr", q_nope, wk_b)

    def up_values(self, out_lat: torch.Tensor) -> torch.Tensor:
        """out_lat (B, T, H, r) -> (B, T, H·dv) through ``wv_b``."""
        B, T, H, r = out_lat.shape
        wv_b = self.wv_b.weight.view(H, self.v_head_dim, r)
        return torch.einsum("bthr,hdr->bthd", out_lat, wv_b).reshape(B, T, H * self.v_head_dim)

    def _attend(self, q_nope, q_rope, c_kv, k_rope, mask: Optional[torch.Tensor]):
        """q_nope (B, T, H, dn), q_rope (B, T, H, dr) against c_kv (B, S, r)
        and k_rope (B, S, dr); mask (B, T, S) or (T, S) bool or None -> (B,
        T, H·dv), the scores and the output in latent space."""
        q_lat = self.absorb_q(q_nope)
        scores = (torch.einsum("bthr,bsr->bhts", q_lat, c_kv)
                  + torch.einsum("bthd,bsd->bhts", q_rope, k_rope)) * self.scale
        if mask is not None:
            mask = mask[:, None] if mask.ndim == 3 else mask
        probs = masked_softmax(scores, mask)
        out_lat = torch.einsum("bhts,bsr->bthr", probs.to(c_kv.dtype), c_kv)
        return self.up_values(out_lat)

    def _attend_chunked(self, q_nope, q_rope, c_kv, k_rope) -> torch.Tensor:
        """Causal latent attention over query chunks of ``q_chunk`` rows,
        each against the latent rows up to its end."""
        T = q_nope.shape[1]
        c = self.q_chunk
        if T % c:
            raise ValueError(f"chunked attention needs T % q_chunk == 0, got T {T}, "
                             f"q_chunk {c}")
        outs = []
        for i in range(T // c):
            end = (i + 1) * c
            mask = _causal_mask(c, end, i * c, device=q_nope.device)
            outs.append(self._attend(q_nope[:, i * c:end], q_rope[:, i * c:end],
                                     c_kv[:, :end], k_rope[:, :end], mask))
        return torch.cat(outs, dim=1)

    def forward(self, x: torch.Tensor, positions: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence attention. x (B, T, d_model); positions (B, T)
        (default ``arange(T)``); mask (B, T, T) bool, True: attend (default
        causal where ``causal``) -> (B, T, d_model)."""
        B, T, _ = x.shape
        if positions is None:
            positions = torch.arange(T, device=x.device)[None]
        q_nope, q_rope = self.q(x, positions)
        c_kv, k_rope = self.kv_latent(x, positions)
        if mask is None and self.causal and T >= 2 * self.q_chunk:
            out = self._attend_chunked(q_nope, q_rope, c_kv, k_rope)
        else:
            if mask is None and self.causal:
                mask = _causal_mask(T, T, device=x.device)
            out = self._attend(q_nope, q_rope, c_kv, k_rope, mask)
        return self.wo(out)

    # -- serving ------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> dict:
        """Zero latent caches ``ckv`` (batch, max_len, kv_lora_rank) and
        ``krope`` (batch, max_len, rope_head_dim)."""
        return {"ckv": torch.zeros((batch, max_len, self.kv_lora_rank), dtype=dtype,
                                   device=device),
                "krope": torch.zeros((batch, max_len, self.rope_head_dim), dtype=dtype,
                                     device=device)}

    def decode_step(self, x: torch.Tensor, cache: dict, cache_len: int):
        """x (B, 1, d_model) at position ``cache_len``, where ``cache`` holds
        ``cache_len`` valid rows. Writes the new latent and RoPE key into row
        ``cache_len`` in place; returns (out (B, 1, d_model), cache). The H
        query heads attend to the first ``cache_len + 1`` rows: scores (B,
        1, H, n) and their weighted sum of latent rows
        (``_weighted_values``), batched products over the (n, r) slab."""
        B, S, r = cache["ckv"].shape
        if not 0 <= cache_len < S:
            raise ValueError(f"decode at position {cache_len} of a cache of {S} rows")
        positions = torch.full((B, 1), cache_len, dtype=torch.int32, device=x.device)
        q_nope, q_rope = self.q(x, positions)
        c_new, kr_new = self.kv_latent(x, positions)
        cache["ckv"][:, cache_len] = c_new[:, 0].to(cache["ckv"].dtype)
        cache["krope"][:, cache_len] = kr_new[:, 0].to(cache["krope"].dtype)
        n = cache_len + 1
        ckv, krope = cache["ckv"][:, None, :n], cache["krope"][:, None, :n]  # (B, 1, n, .)
        q_lat = self.absorb_q(q_nope)                                         # (B, 1, H, r)
        scores = (torch.matmul(q_lat.float(), ckv.float().transpose(-1, -2))
                  + torch.matmul(q_rope.float(), krope.float().transpose(-1, -2))) * self.scale
        out_lat = _weighted_values(masked_softmax(scores, None).to(ckv.dtype), ckv)
        return self.wo(self.up_values(out_lat)), cache
