"""Bag lookups over embedding tables.

Counterpart of ``repro/embedding/embedding_bag.py``:

* ``bag_lookup`` — the ragged layout: flat ``indices`` (N,) and
  ``segment_ids`` (N,), the bag of each index -> (num_bags, dim), summed,
  averaged or maxed per bag;
* ``multihot_lookup`` — the padded layout (..., n_hot) with a mask, summed
  or averaged over the hot axis;
* ``qr_embedding`` — quotient-remainder tables [arXiv:1909.02107]:
  ``emb(id) = Q[id // buckets] ∘ R[id % buckets]``.

Gathers go through ``nn/layers.embedding`` and bag sums through
``nn/layers.segment_sum``, so a gradient has the same bits on every run on
the card (no atomics), as every embedding gradient of the port. A max over
an empty bag is -inf, as ``jax.ops.segment_max`` gives it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.nn.layers import embedding, segment_sum


def bag_lookup(table: torch.Tensor, indices: torch.Tensor, segment_ids: torch.Tensor,
               num_bags: int, mode: str = "sum",
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """table (V, d), indices and segment_ids (N,) -> (num_bags, d);
    ``weights`` (N,) scales each row first. An empty bag sums to 0,
    averages to 0 and maxes to -inf."""
    rows = embedding(indices.long(), table)                       # (N, d)
    if weights is not None:
        rows = rows * weights[:, None].to(rows.dtype)
    seg = segment_ids.long()
    if mode == "sum":
        return segment_sum(rows, seg, num_bags)
    if mode == "mean":
        s = segment_sum(rows, seg, num_bags)
        c = segment_sum(torch.ones(indices.shape, dtype=rows.dtype, device=rows.device),
                        seg, num_bags)
        return s / torch.clamp(c, min=1.0)[:, None]
    if mode == "max":
        out = torch.full((num_bags, rows.shape[1]), float("-inf"), dtype=rows.dtype,
                         device=rows.device)
        return out.scatter_reduce(0, seg[:, None].expand_as(rows), rows, "amax",
                                  include_self=True)
    raise ValueError(mode)


def multihot_lookup(table: torch.Tensor, indices: torch.Tensor,
                    mask: Optional[torch.Tensor], mode: str = "sum") -> torch.Tensor:
    """table (V, d), indices (..., n_hot) padded, mask (..., n_hot) (1: a
    valid index; None: all valid) -> (..., d)."""
    rows = embedding(indices.long(), table)                       # (..., n_hot, d)
    if mask is None:
        if mode == "sum":
            return torch.sum(rows, dim=-2)
        if mode == "mean":
            return torch.mean(rows, dim=-2)
        raise ValueError(mode)
    m = mask[..., None].to(rows.dtype)
    s = torch.sum(rows * m, dim=-2)
    if mode == "sum":
        return s
    if mode == "mean":
        return s / torch.clamp(torch.sum(m, dim=-2), min=1.0)
    raise ValueError(mode)


def qr_embedding(q_table: torch.Tensor, r_table: torch.Tensor, ids: torch.Tensor,
                 buckets: int, combine: str = "add") -> torch.Tensor:
    """q_table (ceil(V / buckets), d), r_table (buckets, d): Q[id //
    buckets] + R[id % buckets] (``combine="add"``) or their product
    (``"mul"``)."""
    ids = ids.long()
    q = embedding(ids // buckets, q_table)
    r = embedding(ids % buckets, r_table)
    return q + r if combine == "add" else q * r
