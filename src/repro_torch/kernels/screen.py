"""Margin-screened inputs for holding hash kernels against their plain
versions.

Two implementations sum the m×d projection r·x in different orders, so a
projection within rounding of 0 can get a different sign bit and send a row
to another bucket: a legitimate difference, not a fault. Inputs drawn here
keep every projection at least ``margin·‖r‖·‖x‖`` away from 0, measured in
float64 on the values as they are stored, so all implementations agree on
every bit. ``screen_item_rows`` does the same for a CTR model's training
batches: it redraws the item-embedding rows of the behaviors and
candidates a step hashes until each clears the margin.
"""
from __future__ import annotations

import numpy as np
import torch

MARGIN = 1e-3


def stored(x: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """float32 values of ``x`` after rounding to ``dtype``."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dtype).float().numpy()


def clears_margin(x: np.ndarray, R: np.ndarray, margin: float = MARGIN) -> np.ndarray:
    """Per row of x (..., d): every |r·x| >= margin·‖r‖·‖x‖ (float64)."""
    x64 = np.asarray(x, np.float64)
    R64 = np.asarray(R, np.float64)
    proj = np.abs(x64 @ R64.T)
    bound = margin * np.linalg.norm(x64, axis=-1)[..., None] * np.linalg.norm(R64, axis=-1)
    return np.all(proj >= bound, axis=-1)


def screened_normal(rng: np.random.Generator, shape, R: np.ndarray,
                    dtype: torch.dtype = torch.float32,
                    margin: float = MARGIN) -> np.ndarray:
    """Standard-normal rows (..., d), redrawn until every row clears the
    margin; returned as float32 holding the values exactly as ``dtype``
    stores them."""
    d = shape[-1]
    x = stored(rng.standard_normal(shape).reshape(-1, d), dtype)
    while True:
        bad = ~clears_margin(x, R, margin)
        if not bad.any():
            return x.reshape(shape)
        x[bad] = stored(rng.standard_normal((int(bad.sum()), d)), dtype)


@torch.no_grad()
def hashed_behaviors(model, batch: dict):
    """(item ids, cat ids) of what an sdim model's step on ``batch`` hashes:
    every valid history row and every candidate, flattened."""
    valid = batch["hist_mask"] > 0
    return (torch.cat([batch["hist_items"][valid].reshape(-1), batch["cand_item"].reshape(-1)]),
            torch.cat([batch["hist_cats"][valid].reshape(-1), batch["cand_cat"].reshape(-1)]))


@torch.no_grad()
def item_rows_clear(model, items: torch.Tensor, cats: torch.Tensor,
                    margin: float = MARGIN) -> torch.Tensor:
    """Per (item, cat) pair: whether its behavior embedding clears the
    margin against the model's R (float64 on the model's device)."""
    x = model._embed_behaviors(items, cats).double()
    R = model.interest.R.double()
    bound = margin * torch.linalg.norm(x, dim=-1)[:, None] * torch.linalg.norm(R, dim=-1)
    return torch.all(torch.abs(x @ R.T) >= bound, dim=-1)


@torch.no_grad()
def screen_item_rows(model, batches, generator: torch.Generator,
                     margin: float = MARGIN, max_rounds: int = 64) -> int:
    """Redraw, N(0, emb_init²) from ``generator``, the item-embedding rows
    of every behavior and candidate that ``batches`` (dicts of tensors on
    the model's device) hash until each clears the margin; returns how
    many rows were redrawn. Raises if ``max_rounds`` do not get there."""
    pairs = [hashed_behaviors(model, b) for b in batches]
    items = torch.cat([p[0] for p in pairs]).long() % model.cfg.n_items
    cats = torch.cat([p[1] for p in pairs]).long()
    table = model.item_emb.weight
    redrawn = 0
    for _ in range(max_rounds):
        bad = ~item_rows_clear(model, items, cats, margin)
        if not bool(bad.any()):
            return redrawn
        rows = torch.unique(items[bad])
        table[rows] = model.cfg.emb_init * torch.randn(
            (rows.numel(), table.shape[1]), generator=generator, device=generator.device,
            dtype=table.dtype).to(table.device)
        redrawn += rows.numel()
    raise RuntimeError(f"item rows still short of the hash margin after {max_rounds} rounds")
