"""CTR model family with a pluggable long-term interest module.

Counterpart of ``repro/models/ctr.py``. Archs (``CTRConfig.arch``):
  * ``din``       — the paper's own online model (Fig. 3): short-term target
                    attention + long-term interest module + MLP head.
  * ``wide_deep`` — Wide&Deep: ``n_sparse`` candidate fields, wide linear
                    terms + deep MLP, the fields' embeddings concatenated
                    in place of the target embedding.
  * ``bst``       — Behavior Sequence Transformer: the target appended to
                    the short sequence, ``n_blocks`` post-LN encoder blocks,
                    the target position's output.
  * ``dien``      — DIEN: GRU interest extraction, then AUGRU interest
                    evolution against the target.
  * ``bert4rec``  — BERT4Rec: a bidirectional encoder over the recent
                    sequence, mean-pooled over its valid positions.

Every arch takes any ``interest.kind`` for the long branch (the paper's
"architecture-free" claim, §4.4). Behaviors are concat(item_emb, cat_emb)
(2·embed_dim), the DIN convention; the long branch also gets the raw
category ids (``sim_hard`` matches on them). The weights live in the
module (the JAX package threads a params pytree instead;
``repro_torch.weights`` carries one across). ``wide_deep``'s 40 field
tables are one stacked (n_sparse, field_vocab, embed_dim) parameter, its
wide terms one (n_sparse, field_vocab, 1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from repro_torch.core.interest import InterestConfig, InterestModule
from repro_torch.core.target_attention import target_attention
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn.attention import GQAttention
from repro_torch.nn.layers import MLP, Embedding, LayerNorm, Linear, embedding
from repro_torch.nn.rnn import AUGRU, GRU

ARCHS = ("din", "wide_deep", "bst", "dien", "bert4rec")


@dataclasses.dataclass(frozen=True)
class CTRConfig:
    arch: str = "din"
    n_items: int = 2_000_000
    n_cats: int = 10_000
    embed_dim: int = 32
    short_len: int = 16
    long_len: int = 1024
    mlp_hidden: tuple = (1024, 512, 256)
    interest: InterestConfig = InterestConfig()
    ctx_dim: int = 4
    # wide_deep
    n_sparse: int = 40
    field_vocab: int = 1_000_000
    # bst / bert4rec
    n_heads: int = 8
    n_blocks: int = 1
    # dien
    gru_dim: int = 108
    emb_init: float = 0.01      # embedding init std

    @property
    def behavior_dim(self) -> int:
        return 2 * self.embed_dim


class EncoderBlock(nn.Module):
    """Post-LN bidirectional encoder block (BST / BERT4Rec): attention
    (``n_heads`` heads of d_model / n_heads, biased projections, RoPE), add
    and ``ln1``; GELU MLP of width 4·d_model, add and ``ln2``."""

    def __init__(self, d_model: int, n_heads: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.attn = GQAttention(d_model, n_heads, d_model // n_heads, device=device,
                                generator=generator)
        self.ln1 = LayerNorm(d_model, device=device)
        self.mlp = MLP(d_model, [4 * d_model, d_model], "gelu", device=device,
                       generator=generator)
        self.ln2 = LayerNorm(d_model, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x (B, T, d_model), mask (B, T) (> 0: a valid key) -> (B, T, d_model)."""
        B, T = mask.shape
        x = self.ln1(x + self.attn(x, mask=(mask[:, None, :] > 0).expand(B, T, T)))
        return self.ln2(x + self.mlp(x))


class CTRModel(nn.Module):
    def __init__(self, cfg: CTRConfig, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.arch not in ARCHS:
            raise ValueError(f"unknown arch {cfg.arch!r} (have {ARCHS})")
        dev = resolve_device(device)
        self.cfg = cfg
        e = cfg.behavior_dim
        kw = dict(device=dev, generator=generator)
        self.item_emb = Embedding(cfg.n_items, cfg.embed_dim, cfg.emb_init, **kw)
        self.cat_emb = Embedding(cfg.n_cats, cfg.embed_dim, cfg.emb_init, **kw)
        self.interest = InterestModule(dataclasses.replace(cfg.interest, d=e), **kw)
        self.head = MLP(self._head_in_dim(), [*cfg.mlp_hidden, 1], "relu", **kw)
        normal = lambda *shape: nn.Parameter(0.01 * torch.randn(shape, **kw))
        if cfg.arch == "wide_deep":
            self.field_tables = normal(cfg.n_sparse, cfg.field_vocab, cfg.embed_dim)
            self.wide = nn.Parameter(torch.zeros((cfg.n_sparse, cfg.field_vocab, 1), device=dev))
            self.wide_bias = nn.Parameter(torch.zeros(1, device=dev))
        elif cfg.arch == "bst":
            self.pos_emb = normal(cfg.short_len + 1, e)
            self.blocks = nn.ModuleList(EncoderBlock(e, cfg.n_heads, **kw)
                                        for _ in range(cfg.n_blocks))
        elif cfg.arch == "dien":
            self.gru = GRU(e, cfg.gru_dim, **kw)
            self.augru = AUGRU(cfg.gru_dim, cfg.gru_dim, **kw)
            self.att_proj = Linear(e, cfg.gru_dim, False, **kw)
        elif cfg.arch == "bert4rec":
            self.in_proj = Linear(e, cfg.embed_dim, True, **kw)
            self.pos_emb = normal(cfg.short_len, cfg.embed_dim)
            self.blocks = nn.ModuleList(EncoderBlock(cfg.embed_dim, cfg.n_heads, **kw)
                                        for _ in range(cfg.n_blocks))

    def _head_in_dim(self) -> int:
        cfg = self.cfg
        e = cfg.behavior_dim
        long_dim = 0 if cfg.interest.kind == "none" else e
        short_dim = {"din": e, "wide_deep": e, "bst": e, "dien": cfg.gru_dim,
                     "bert4rec": cfg.embed_dim}[cfg.arch]
        first = cfg.n_sparse * cfg.embed_dim if cfg.arch == "wide_deep" else e
        return first + short_dim + long_dim + cfg.ctx_dim  # target|fields + short + long + ctx

    @property
    def engine(self):
        """The SDIM compute engine."""
        assert self.cfg.interest.kind == "sdim"
        return self.interest.engine

    # ---------------- shared featurization ----------------
    def _embed_behaviors(self, items: torch.Tensor, cats: torch.Tensor) -> torch.Tensor:
        # hash trick: raw id spaces fold into the table (floor mod, as jnp)
        items = items.long() % self.cfg.n_items
        cats = cats.long() % self.cfg.n_cats
        return torch.cat([self.item_emb(items), self.cat_emb(cats)], dim=-1)

    def _short_rep(self, batch: dict, target_e: torch.Tensor) -> torch.Tensor:
        """The arch's short-term representation of the most recent
        short_len behaviors (history is padded at the front) against the
        target (B, e)."""
        cfg = self.cfg
        s = cfg.short_len
        mask = batch["hist_mask"][:, -s:]
        seq_e = self._embed_behaviors(batch["hist_items"][:, -s:],
                                      batch["hist_cats"][:, -s:])        # (B, s, e)
        if cfg.arch in ("din", "wide_deep"):
            return target_attention(target_e, seq_e, mask)
        if cfg.arch == "bst":
            x = torch.cat([seq_e, target_e[:, None, :]], dim=1) + self.pos_emb[None]
            m = torch.cat([mask, torch.ones_like(mask[:, :1])], dim=1)
            for block in self.blocks:
                x = block(x, m)
            return x[:, -1]                                              # the target's position
        if cfg.arch == "dien":
            hs, _ = self.gru(seq_e, mask=mask)
            scores = torch.einsum("bd,btd->bt", self.att_proj(target_e), hs) / math.sqrt(cfg.gru_dim)
            att = torch.softmax(torch.where(mask > 0, scores,
                                            torch.full((), -1e30, device=scores.device)), dim=-1)
            return self.augru(hs, att, mask=mask)[1]
        # bert4rec: mean over the valid positions
        x = self.in_proj(seq_e) + self.pos_emb[None]
        for block in self.blocks:
            x = block(x, mask)
        m = mask.to(x.dtype)[..., None]
        return torch.sum(x * m, dim=1) / torch.clamp(torch.sum(m, dim=1), min=1.0)

    def _fields(self, sparse_ids: torch.Tensor):
        """wide_deep's candidate fields: sparse_ids (N, n_sparse) -> (the
        fields' embeddings concatenated in field order (N, n_sparse ·
        embed_dim), the wide logit (N,))."""
        cfg = self.cfg
        if sparse_ids is None:
            raise ValueError("wide_deep needs sparse_ids (one id per field)")
        ids = sparse_ids.long() + cfg.field_vocab * torch.arange(cfg.n_sparse,
                                                                 device=sparse_ids.device)
        fields = embedding(ids, self.field_tables.view(-1, cfg.embed_dim)).flatten(1)
        wide = embedding(ids, self.wide.view(-1, 1)).sum(1) + self.wide_bias
        return fields, wide[..., 0]

    def _logits(self, feats: list, ctx: torch.Tensor, sparse_ids) -> torch.Tensor:
        """The head over [target or fields, short, long, ctx] (+ the wide
        logit for wide_deep)."""
        wide = None
        if self.cfg.arch == "wide_deep":
            fields, wide = self._fields(sparse_ids)
            feats = [fields] + feats[1:]                                 # concat interaction
        out = self.head(torch.cat([*feats, ctx.to(feats[0].dtype)], dim=-1))[..., 0]
        return out if wide is None else out + wide

    # ---------------- forward ----------------
    def apply(self, batch: dict) -> torch.Tensor:
        """Pointwise CTR logits (B,); ``batch["sparse_ids"]`` (B, n_sparse)
        for wide_deep."""
        target_e = self._embed_behaviors(batch["cand_item"], batch["cand_cat"])
        feats = [target_e, self._short_rep(batch, target_e)]
        if self.cfg.interest.kind != "none":
            long_e = self._embed_behaviors(batch["hist_items"], batch["hist_cats"])
            feats.append(self.interest(target_e, long_e, batch["hist_mask"],
                                       seq_cat=batch["hist_cats"], q_cat=batch["cand_cat"]))
        return self._logits(feats, batch["ctx"], batch.get("sparse_ids"))

    forward = apply

    def loss(self, batch: dict):
        """(mean binary cross-entropy with logits, logits (B,)), in the
        JAX package's stable form max(z, 0) - z y + log1p(e^-|z|)."""
        logits = self.apply(batch)
        y = batch["label"].to(logits.dtype)
        ll = torch.clamp(logits, min=0) - logits * y + torch.log1p(torch.exp(-torch.abs(logits)))
        return torch.mean(ll), logits

    # ---------------- serving ----------------
    def encode_bse_table(self, user_batch: dict) -> torch.Tensor:
        """BSE-server step: embed the long history (B, L) and encode it into
        bucket tables (B, G, U, e) — everything candidate-independent."""
        long_e = self._embed_behaviors(user_batch["hist_items"], user_batch["hist_cats"])
        return self.engine.encode(long_e, user_batch["hist_mask"], R=self.interest.R)

    def score_candidates(self, user_batch: dict, cand_items: torch.Tensor,
                         cand_cats: torch.Tensor, ctx: torch.Tensor,
                         sparse_ids: Optional[torch.Tensor] = None,
                         bucket_table: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One user's state (hist_* (1, L)) against C candidates (C,), ctx
        (C, ctx_dim) -> (C,) logits: the B = 1 case of
        ``score_candidates_many``, so the two cannot drift apart.
        ``sparse_ids`` (C, n_sparse): wide_deep's fields; ``bucket_table``
        (1, G, U, e) is the decoupled deployment's fetched table."""
        return self.score_candidates_many(
            user_batch, cand_items[None], cand_cats[None], ctx[None],
            sparse_ids=None if sparse_ids is None else sparse_ids[None],
            bucket_tables=bucket_table)[0]

    def score_candidates_many(self, user_batch: dict, cand_items: torch.Tensor,
                              cand_cats: torch.Tensor, ctx: torch.Tensor,
                              sparse_ids: Optional[torch.Tensor] = None,
                              bucket_tables: Optional[torch.Tensor] = None,
                              interest: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A micro-batch of B requests -> (B, C) logits.

        user_batch: hist_* (B, ≥short_len); cand_*: (B, C); ctx (B, C,
        ctx_dim); ``sparse_ids`` (B, C, n_sparse): wide_deep's fields. The
        long branch reads ``bucket_tables`` (B, G, U, e) fetched from the
        BSE server (``engine.query``), or ``interest`` (B, C, e) already
        computed by the fused serve on the BSE side, or, with neither, the
        raw (B, L) history: ONE ``engine.serve`` for kind ``sdim`` (inline
        serving), the interest module for any other kind (``target``: exact
        target attention; the retrieval kinds: top k, then target
        attention). The short branch runs per (request, candidate) pair on
        the user's recent window, as the reference's."""
        cfg = self.cfg
        B, C = cand_items.shape
        e = cfg.behavior_dim
        target_e = self._embed_behaviors(cand_items, cand_cats)          # (B, C, e)
        tflat = target_e.reshape(B * C, e)

        def per_pair(x):  # (B, ...) user-side -> (B*C, ...) request pairs
            return x[:, None].expand(B, C, *x.shape[1:]).reshape(B * C, *x.shape[1:])

        # the pair view only feeds the short-term branch: broadcast just the
        # recent window, never (B·C, L) copies of the history
        s = cfg.short_len
        pair = {k: per_pair(user_batch[k][:, -s:])
                for k in ("hist_items", "hist_cats", "hist_mask")}
        feats = [tflat, self._short_rep(pair, tflat)]

        if cfg.interest.kind != "none":
            if interest is not None:
                long_out = interest
            elif bucket_tables is not None:
                long_out = self.engine.query(target_e, bucket_tables, R=self.interest.R)
            else:
                long_e = self._embed_behaviors(user_batch["hist_items"],
                                               user_batch["hist_cats"])    # (B, L, e)
                if cfg.interest.kind == "sdim":
                    long_out = self.engine.serve(target_e, long_e, user_batch["hist_mask"],
                                                 R=self.interest.R)
                else:
                    long_out = self.interest(target_e, long_e, user_batch["hist_mask"],
                                             seq_cat=user_batch["hist_cats"], q_cat=cand_cats)
            feats.append(long_out.reshape(B * C, e).to(tflat.dtype))
        sids = None if sparse_ids is None else sparse_ids.reshape(B * C, cfg.n_sparse)
        return self._logits(feats, ctx.reshape(B * C, -1), sids).reshape(B, C)
