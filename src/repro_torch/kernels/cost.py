"""Analytical flops and bytes of the engine's five kernel dispatches.

The JAX package reads a dispatch's cost from XLA's ``cost_analysis()``;
the port has no compiler to ask, so each function here counts, from the
dispatch's own arguments (those ``core/engine.py`` hands the kernel
wrapper), the fp32 operations the kernel must do and the bytes it must
move: each input read once, each output written once, and only the work
this call's data needs (valid rows, present users, touched slots). The
kernel profiler (``serve/profiler.py``) turns them into a roofline
prediction (``distributed/roofline.py``), and ``chip_smoke.py`` phase 3
into each kernel's bound.

Per hashed row (behavior, event or candidate) of width d, a hash family
R (m, d) in G = m / tau groups costs 2 m d operations for the projections
plus G d for the bucket add or read; the query's bucket read costs 3 d a
(group, bucket) row (its l2 normalization and the sum).

Each function returns ``Cost(flops, bytes)``. Data-dependent counts read
the mask, slots or present flags (a device sync on the card).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Cost(NamedTuple):
    flops: float
    bytes: float


def _hash_flops(R: torch.Tensor, tau: int) -> int:
    m, d = R.shape
    return 2 * m * d + (m // tau) * d


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _valid(mask: torch.Tensor) -> float:
    """Rows with a nonzero weight: the only ones a kernel reads and hashes."""
    return float((mask > 0).sum())


def encode(seq: torch.Tensor, mask: torch.Tensor, R: torch.Tensor, *, tau: int) -> Cost:
    """``bse_encode``: seq (B, L, d), mask (B, L) -> table (B, G, U, d) fp32."""
    B, _, d = seq.shape
    G, valid = R.shape[0] // tau, _valid(mask)
    return Cost(valid * _hash_flops(R, tau),
                valid * d * seq.element_size() + _nbytes(mask) + _nbytes(R)
                + B * G * (1 << tau) * d * 4)


def query(q: torch.Tensor, table: torch.Tensor, R: torch.Tensor, *, tau: int) -> Cost:
    """``sdim_query``: q (B, C, d) fp32, table (B, G, U, d) -> (B, C, d) fp32."""
    B, C, d = q.shape
    G, U = table.shape[1:3]
    return Cost(B * C * _hash_flops(R, tau) + B * G * U * 3 * d,
                _nbytes(table) + 2 * _nbytes(q) + _nbytes(R))


def serve(q: torch.Tensor, seq: torch.Tensor, mask: torch.Tensor, R: torch.Tensor, *,
          tau: int) -> Cost:
    """``bse_serve``: q (B, C, d) fp32, seq (B, L, d), mask (B, L) -> (B, C, d)
    fp32; the table of each user lives in shared memory only."""
    B, C, d = q.shape
    G, valid = R.shape[0] // tau, _valid(mask)
    return Cost((valid + B * C) * _hash_flops(R, tau) + B * G * (1 << tau) * 3 * d,
                valid * d * seq.element_size() + _nbytes(mask) + 2 * _nbytes(q) + _nbytes(R))


def serve_fused(store: torch.Tensor, slots: torch.Tensor, q: torch.Tensor, R: torch.Tensor,
                *, tau: int, scales: Optional[torch.Tensor] = None,
                present: Optional[torch.Tensor] = None) -> Cost:
    """``sdim_fused_serve``: the rows ``slots`` (B,) of the store (N, G, U, d)
    (+ their scales) against q (B, C, d) -> (B, C, d) fp32. An absent user
    reads no row and needs only its zero output."""
    B, C, d = q.shape
    G, U = store.shape[1:3]
    n = B if present is None else float((present > 0).sum())
    row = G * U * d * store.element_size() + (0 if scales is None else G * U * 4)
    return Cost(n * C * _hash_flops(R, tau) + n * G * U * 3 * d,
                n * (row + C * d * 4) + _nbytes(q) + _nbytes(R) + B * 8)


def update(store: torch.Tensor, slots: torch.Tensor, events: torch.Tensor,
           mask: torch.Tensor, R: torch.Tensor, *, tau: int) -> Cost:
    """``sdim_update``: fold events (B, E, d) [mask (B, E)] into the rows
    ``slots`` (B,) of the store in place: each touched row read and written
    once, only valid events read and hashed."""
    G, U, d = store.shape[1:]
    valid = _valid(mask)
    touched = int(torch.unique(slots[(mask > 0).any(1)]).numel())
    return Cost(valid * _hash_flops(R, tau),
                2 * touched * G * U * d * store.element_size() + valid * d * events.element_size()
                + _nbytes(mask) + slots.shape[0] * 4 + _nbytes(R))


# engine dispatch name -> its cost (SDIMEngine._dispatch's names)
DISPATCH = {"encode": encode, "query": query, "serve": serve, "serve_fused": serve_fused,
            "update": update}
