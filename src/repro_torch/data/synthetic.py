"""Synthetic CTR requests with planted long-term interest structure.

The port's own copy of ``repro/data/synthetic.py``'s ``SyntheticCTRConfig``
and ``generate_batch`` (same numpy draws, so the same seed gives the same
batch): each user has ``n_interests`` latent categories, the history comes
in sessions focused on one interest, padded at the FRONT so the most recent
behaviors are the last positions. Pure numpy on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticCTRConfig:
    n_items: int = 20000
    n_cats: int = 100
    hist_len: int = 256          # L
    short_len: int = 16
    n_interests: int = 5
    session_len: int = 16        # behaviors per interest session
    p_in_interest: float = 0.9   # history fidelity
    label_noise: float = 0.1
    min_hist_frac: float = 0.3   # users have uniform(frac·L, L) behaviors
    n_ctx: int = 4

    @property
    def items_per_cat(self) -> int:
        return self.n_items // self.n_cats


def _item_of_cat(rng: np.random.Generator, cats: np.ndarray, cfg: SyntheticCTRConfig):
    """One item id drawn uniformly from each given category id."""
    return cats * cfg.items_per_cat + rng.integers(0, cfg.items_per_cat, cats.shape)


def generate_batch(cfg: SyntheticCTRConfig, batch: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    L = cfg.hist_len
    interests = np.stack(
        [rng.choice(cfg.n_cats, cfg.n_interests, replace=False) for _ in range(batch)])
    n_sessions = (L + cfg.session_len - 1) // cfg.session_len
    sess_interest = interests[
        np.arange(batch)[:, None], rng.integers(0, cfg.n_interests, (batch, n_sessions))]
    hist_cats = np.repeat(sess_interest, cfg.session_len, axis=1)[:, :L]
    noise = rng.random((batch, L)) > cfg.p_in_interest
    hist_cats = np.where(noise, rng.integers(0, cfg.n_cats, (batch, L)), hist_cats)
    hist_items = _item_of_cat(rng, hist_cats, cfg)

    lengths = rng.integers(int(cfg.min_hist_frac * L), L + 1, batch)
    pos = np.arange(L)[None, :]
    hist_mask = (pos >= (L - lengths[:, None])).astype(np.float32)

    is_pos = rng.random(batch) < 0.5
    pick = rng.integers(0, cfg.n_interests, batch)
    pos_cat = interests[np.arange(batch), pick]
    neg_cat = rng.integers(0, cfg.n_cats, batch)
    for _ in range(4):
        collide = (neg_cat[:, None] == interests).any(axis=1)
        neg_cat = np.where(collide, rng.integers(0, cfg.n_cats, batch), neg_cat)
    cand_cat = np.where(is_pos, pos_cat, neg_cat)
    cand_item = _item_of_cat(rng, cand_cat, cfg)

    flip = rng.random(batch) < cfg.label_noise
    label = np.where(is_pos ^ flip, 1.0, 0.0).astype(np.float32)
    ctx = rng.integers(0, 2, (batch, cfg.n_ctx)).astype(np.float32)
    return {
        "hist_items": hist_items.astype(np.int32),
        "hist_cats": hist_cats.astype(np.int32),
        "hist_mask": hist_mask,
        "cand_item": cand_item.astype(np.int32),
        "cand_cat": cand_cat.astype(np.int32),
        "ctx": ctx,
        "label": label,
    }
