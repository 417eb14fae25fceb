"""CTR model, ``din`` arch: the paper's own online model (Fig. 3).

Counterpart of ``repro/models/ctr.py`` for ``arch="din"``: short-term target
attention + long-term interest module (any of its nine kinds) + MLP head
over [target, short rep, long interest, ctx]. Behaviors are
concat(item_emb, cat_emb) (2·embed_dim), the DIN convention; the long
branch also gets the raw category ids (``sim_hard`` matches on them). The
weights live in the module (the JAX package threads a params pytree
instead; ``repro_torch.weights`` carries one across). The other archs are
not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.core.interest import InterestConfig, InterestModule
from repro_torch.core.target_attention import target_attention
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn.layers import MLP, Embedding


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
    emb_init: float = 0.01      # embedding init std

    @property
    def behavior_dim(self) -> int:
        return 2 * self.embed_dim


class CTRModel(nn.Module):
    def __init__(self, cfg: CTRConfig, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.arch != "din":
            raise NotImplementedError(f"arch {cfg.arch!r} is not ported (have 'din')")
        dev = resolve_device(device)
        self.cfg = cfg
        e = cfg.behavior_dim
        self.item_emb = Embedding(cfg.n_items, cfg.embed_dim, cfg.emb_init,
                                  device=dev, generator=generator)
        self.cat_emb = Embedding(cfg.n_cats, cfg.embed_dim, cfg.emb_init,
                                 device=dev, generator=generator)
        self.interest = InterestModule(dataclasses.replace(cfg.interest, d=e),
                                       device=dev, generator=generator)
        self.head = MLP(self._head_in_dim(), [*cfg.mlp_hidden, 1], "relu",
                        device=dev, generator=generator)

    def _head_in_dim(self) -> int:
        e = self.cfg.behavior_dim
        long_dim = 0 if self.cfg.interest.kind == "none" else e
        return e + e + long_dim + self.cfg.ctx_dim       # target + short TA + long + ctx

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
        """Target attention over the most recent short_len behaviors
        (history is padded at the front)."""
        s = self.cfg.short_len
        seq_e = self._embed_behaviors(batch["hist_items"][:, -s:],
                                      batch["hist_cats"][:, -s:])
        return target_attention(target_e, seq_e, batch["hist_mask"][:, -s:])

    # ---------------- forward ----------------
    def apply(self, batch: dict) -> torch.Tensor:
        """Pointwise CTR logits (B,)."""
        target_e = self._embed_behaviors(batch["cand_item"], batch["cand_cat"])
        feats = [target_e, self._short_rep(batch, target_e)]
        if self.cfg.interest.kind != "none":
            long_e = self._embed_behaviors(batch["hist_items"], batch["hist_cats"])
            feats.append(self.interest(target_e, long_e, batch["hist_mask"],
                                       seq_cat=batch["hist_cats"], q_cat=batch["cand_cat"]))
        feats.append(batch["ctx"].to(target_e.dtype))
        return self.head(torch.cat(feats, dim=-1))[..., 0]

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
                         bucket_table: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One user's state (hist_* (1, L)) against C candidates (C,), ctx
        (C, ctx_dim) -> (C,) logits: the B = 1 case of
        ``score_candidates_many``, so the two cannot drift apart.
        ``bucket_table`` (1, G, U, e) is the decoupled deployment's fetched
        table."""
        return self.score_candidates_many(user_batch, cand_items[None], cand_cats[None],
                                          ctx[None], bucket_tables=bucket_table)[0]

    def score_candidates_many(self, user_batch: dict, cand_items: torch.Tensor,
                              cand_cats: torch.Tensor, ctx: torch.Tensor,
                              bucket_tables: Optional[torch.Tensor] = None,
                              interest: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A micro-batch of B requests -> (B, C) logits.

        user_batch: hist_* (B, ≥short_len); cand_*: (B, C); ctx (B, C,
        ctx_dim). The long branch reads ``bucket_tables`` (B, G, U, e)
        fetched from the BSE server (``engine.query``), or ``interest``
        (B, C, e) already computed by the fused serve on the BSE side, or,
        with neither, the raw (B, L) history: ONE ``engine.serve`` for kind
        ``sdim`` (inline serving), the interest module for any other kind
        (``target``: exact target attention; the retrieval kinds: top k, then
        target attention)."""
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

        feats.append(ctx.reshape(B * C, -1).to(tflat.dtype))
        return self.head(torch.cat(feats, dim=-1))[..., 0].reshape(B, C)
