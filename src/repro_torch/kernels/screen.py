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

A top-k over float scores has the same hazard at its boundary: where the
k-th and (k+1)-th scores lie within rounding of each other, two
implementations may retrieve different rows. ``topk_clear`` says whether
they are apart, and ``screen_topk_rows`` redraws, for a ``ubr4ctr``
model, the item rows at that boundary until they are. (ETA's scores are
integer counts of equal bits: once the hash bits agree they are equal,
and every implementation breaks their frequent ties by index.)
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


def topk_clear(scores: np.ndarray, k: int, margin: float = MARGIN) -> np.ndarray:
    """Per row of ``scores`` (..., L), -inf where a row is not eligible:
    whether the k-th and (k+1)-th largest are apart by more than
    ``margin`` times the row's largest finite |score|, or exactly equal.
    Equal scores come from equal inputs (-inf, or a behavior that occurs
    twice in a history, whose rows are the same embedding): every
    implementation computes them equal and breaks the tie by index."""
    s = -np.sort(-np.asarray(scores, np.float64), axis=-1)
    if s.shape[-1] <= k:
        return np.ones(s.shape[:-1], bool)
    kth, nxt = s[..., k - 1], s[..., k]
    finite = np.where(np.isfinite(s), np.abs(s), 0.0).max(axis=-1)
    gap = np.where(np.isfinite(nxt), kth - np.where(np.isfinite(nxt), nxt, 0.0), np.inf)
    return (gap == 0) | (gap > margin * finite)


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


@torch.no_grad()
def ubr4ctr_scores(model, batch: dict) -> torch.Tensor:
    """A ``ubr4ctr`` model's retrieval scores (B, C, L) of ``batch``'s
    candidates (``cand_item`` (B,) or (B, C)) against its history, in
    float64, -inf where the history is masked."""
    seq = model._embed_behaviors(batch["hist_items"], batch["hist_cats"]).double()
    q = model._embed_behaviors(batch["cand_item"], batch["cand_cat"]).double()
    q = q[:, None] if q.ndim == 2 else q
    ubr = model.interest.ubr
    s = torch.einsum("bcp,blp->bcl", q @ ubr.wq.weight.double().T, seq @ ubr.wk.weight.double().T)
    return torch.where(batch["hist_mask"][:, None, :] > 0, s,
                       torch.full((), float("-inf"), dtype=s.dtype, device=s.device))


@torch.no_grad()
def screen_topk_rows(model, batches, generator: torch.Generator, margin: float = MARGIN,
                     max_rounds: int = 64) -> int:
    """For a ``ubr4ctr`` model: redraw, N(0, emb_init²) from ``generator``,
    the item-embedding rows at the k-th and (k+1)-th places of every
    candidate's retrieval scores in ``batches`` (dicts of tensors on the
    model's device) until each candidate's two are apart (``topk_clear``);
    returns how many rows were redrawn. Raises if ``max_rounds`` do not get
    there."""
    k = model.cfg.interest.top_k
    table = model.item_emb.weight
    redrawn = 0
    for _ in range(max_rounds):
        rows = []
        for b in batches:
            scores = ubr4ctr_scores(model, b)
            bad = torch.from_numpy(~topk_clear(scores.cpu().numpy(), k, margin)).to(scores.device)
            if bool(bad.any()):
                order = torch.sort(scores, dim=-1, descending=True, stable=True)[1]
                at = order[..., k - 1:k + 1][bad]                       # (n, 2) history places
                users = torch.nonzero(bad)[:, 0]
                rows.append(b["hist_items"][users[:, None], at].reshape(-1))
        if not rows:
            return redrawn
        rows = torch.unique(torch.cat(rows).long() % model.cfg.n_items)
        table[rows] = model.cfg.emb_init * torch.randn(
            (rows.numel(), table.shape[1]), generator=generator, device=generator.device,
            dtype=table.dtype).to(table.device)
        redrawn += rows.numel()
    raise RuntimeError(f"top-k boundaries still within the margin after {max_rounds} rounds")
