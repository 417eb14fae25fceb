"""BSE — Behavior Sequence Encoding (paper §4.4).

Counterpart of ``repro/core/bse.py``. The hashing of the behavior sequence
is candidate-independent, so it is factored into a standalone encode step
whose output — the *bucket table* ``(G, 2^τ, d)`` of per-signature sums —
is the full serving state per user. The CTR server then only hashes
candidates and reads buckets: O(B·m·log d), independent of L.

With the paper's online dims (m=48, τ=3, d=128 ⇒ 16×8×128) a table is
32 KB in bf16; the size is L-free, which is the point. New behaviors fold
into a table with O(m·d) work (``update_table``): how a BSE server ingests
real-time events without re-encoding history.

Plain tensor math over ``core/sdim.py`` and ``core/simhash.py``, as in the
reference (which reaches no kernel here either); the serving path runs the
same math through the ``SDIMEngine`` kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import sdim, simhash


@dataclasses.dataclass(frozen=True)
class BSEConfig:
    m: int = 48
    tau: int = 3
    d: int = 128

    @property
    def n_groups(self) -> int:
        return self.m // self.tau

    @property
    def n_buckets(self) -> int:
        return 1 << self.tau

    def table_bytes(self, dtype_bytes: int = 2) -> int:
        return self.n_groups * self.n_buckets * self.d * dtype_bytes


def encode_sequence(seq: torch.Tensor, mask: Optional[torch.Tensor],
                    R: torch.Tensor, tau: int) -> torch.Tensor:
    """Behavior sequence (B, L, d) or (L, d) [+ mask of the leading shape]
    -> bucket table (…, G, U, d) fp32."""
    squeezed = seq.ndim == 2
    if squeezed:
        seq = seq[None]
        mask = mask[None] if mask is not None else None
    sig = simhash.signatures(seq, R, tau)
    table = sdim.bucket_table(seq, sig, mask, 1 << tau)
    return table[0] if squeezed else table


def update_table(table: torch.Tensor, new_items: torch.Tensor,
                 R: torch.Tensor, tau: int) -> torch.Tensor:
    """Incremental BSE ingest: fold n new behaviors (n, d) into a (G, U, d)
    table; returns the new table."""
    return table + encode_sequence(new_items, None, R, tau)


def query_interest(table: torch.Tensor, q: torch.Tensor, R: torch.Tensor,
                   tau: int) -> torch.Tensor:
    """CTR-server side: hash candidates, read buckets, ℓ2-combine groups.
    table (B, G, U, d) with q (B, C, d) / (B, d), or one user's (G, U, d)
    with q (C, d)."""
    if table.ndim == 3:  # single user
        sig_q = simhash.signatures(q[None], R, tau)
        return sdim.fused_query(table[None], sig_q)[0]
    return sdim.fused_query(table, simhash.signatures(q, R, tau))
