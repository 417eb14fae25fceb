"""Synthetic CTR requests with planted long-term interest structure.

The port's own copy of ``repro/data/synthetic.py``'s ``SyntheticCTRConfig``,
``generate_batch``, ``serving_request`` and ``generate_batch_graded`` (same
numpy draws, so the same seed gives the same arrays): each user has
``n_interests`` latent categories, the history comes in sessions focused on
one interest, padded at the FRONT so the most recent behaviors are the last
positions. ``generate_batch_graded`` labels clicks with a softmax
target-attention teacher over per-item latent vectors (the function SDIM
approximates), the training stream of ``launch/train.py``. Pure numpy on
the host.
"""
from __future__ import annotations

import dataclasses
import functools

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


def serving_request(cfg: SyntheticCTRConfig, n_candidates: int, seed: int) -> dict:
    """One user's full state + ``n_candidates`` candidates (the CTR-server
    request shape)."""
    b = generate_batch(cfg, 1, seed)
    rng = np.random.default_rng(seed + 1)
    cand_cat = rng.integers(0, cfg.n_cats, n_candidates)
    cand_item = _item_of_cat(rng, cand_cat, cfg)
    return {
        "hist_items": b["hist_items"][0],
        "hist_cats": b["hist_cats"][0],
        "hist_mask": b["hist_mask"][0],
        "cand_item": cand_item.astype(np.int32),
        "cand_cat": cand_cat.astype(np.int32),
        "ctx": np.repeat(b["ctx"], n_candidates, axis=0),
    }


@functools.lru_cache(maxsize=2)
def _latents(cfg: SyntheticCTRConfig, dim: int, seed: int = 777) -> np.ndarray:
    """Per-item unit latent vectors (n_items, dim) float64, clustered by
    category. Cached per (cfg, dim, seed): at sdim-paper FULL (10M items)
    the array is 640 MB and takes seconds to draw, and every batch of a
    stream reads it. The cache hands every caller the same array: read it,
    never write it."""
    rng = np.random.default_rng(seed)
    cat_centers = rng.standard_normal((cfg.n_cats, dim))
    cat_centers /= np.linalg.norm(cat_centers, axis=1, keepdims=True)
    item_lat = cat_centers[np.arange(cfg.n_items) // cfg.items_per_cat]
    item_lat = item_lat + 0.35 * rng.standard_normal((cfg.n_items, dim))
    item_lat /= np.linalg.norm(item_lat, axis=1, keepdims=True)
    item_lat.flags.writeable = False
    return item_lat


def generate_batch_graded(cfg: SyntheticCTRConfig, batch: int, seed: int,
                          latent_dim: int = 8, beta: float = 6.0,
                          signal: float = 6.0) -> dict:
    """CTR batch whose labels come from a target-attention teacher over the
    whole (masked) history:

        w_j ∝ exp(β·⟨ẑ_c, ẑ_j⟩),  s = Σ_j w_j ⟨ẑ_c, ẑ_j⟩,
        y ~ Bernoulli(σ(signal·(s − median(s))))

    half of the candidates are a random history item, half the
    ``generate_batch`` candidate."""
    base = generate_batch(cfg, batch, seed)
    lat = _latents(cfg, latent_dim)
    rng = np.random.default_rng(seed + 13)

    take = rng.integers(0, cfg.hist_len, batch)
    anchor = base["hist_items"][np.arange(batch), take]
    rng.standard_normal((batch, latent_dim))   # the JAX copy's unused jitter: same draws after it
    cand_item = np.where(rng.random(batch) < 0.5, base["cand_item"], anchor)
    cand_cat = cand_item // cfg.items_per_cat

    zc = lat[cand_item]                                 # (B, dim)
    zh = lat[base["hist_items"]]                        # (B, L, dim)
    cos = np.einsum("bd,bld->bl", zc, zh)
    mask = base["hist_mask"]
    logits = beta * cos - 1e30 * (1 - mask)
    w = np.exp(logits - logits.max(axis=1, keepdims=True))
    w /= w.sum(axis=1, keepdims=True)
    s = np.einsum("bl,bl->b", w, cos)
    p = 1.0 / (1.0 + np.exp(-signal * (s - np.median(s))))
    label = (rng.random(batch) < p).astype(np.float32)

    out = dict(base)
    out["cand_item"] = cand_item.astype(np.int32)
    out["cand_cat"] = cand_cat.astype(np.int32)
    out["label"] = label
    return out
