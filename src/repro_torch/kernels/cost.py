"""Analytical flops and bytes of the engine's five kernel dispatches.

The JAX package reads a dispatch's cost from XLA's ``cost_analysis()``;
the port has no compiler to ask, so each function here counts, from the
dispatch's own arguments (those ``core/engine.py`` hands the kernel
wrapper), the fp32 operations the kernel must do and the bytes it must
move: each input read once, each output written once, and only the work
this call's data needs (valid rows, present users, touched slots, the
table rows the candidates select). The kernel profiler
(``serve/profiler.py``) turns them into a roofline prediction
(``distributed/roofline.py``), and ``chip_smoke.py`` phase 3 into each
kernel's bound.

Per hashed row (behavior, event or candidate) of width d, a hash family
R (m, d) in G = m / tau groups costs 2 m d operations for the projections
plus G d for the bucket add or read; the query's bucket read costs 3 d a
(group, bucket) row (its l2 normalization and the sum).

Each function returns ``Cost(flops, bytes)``. A count that depends on the
data (valid rows, present users, touched slots, selected rows) is a 0-dim int64 tensor on
the data's device, computed without waiting for the device; the profiler
reads its records' counts once, when it reports. ``settle`` reads a cost
as two numbers.

The sharded dispatches (``update_sharded``, ``serve_fused_sharded``,
``serve_sharded``) launch one kernel per shard; their cost is the sum over
those launches, each counted on its own (masked) arguments.
``collective_bytes`` counts the bytes a dispatch moves between distinct
devices (inputs sent to a shard on another device, its output sent back):
0 when every shard shares the caller's device, as on one card.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import simhash
from repro_torch.core.engine import serve_shards
from repro_torch.distributed.mesh_ctx import owned


class Cost(NamedTuple):
    flops: Any      # a number, or a 0-dim int64 tensor (a count of the data)
    bytes: Any


def settle(c: Cost) -> Cost:
    """``c`` with both counts read as Python numbers."""
    return Cost(*(float(v) for v in c))


def _sum(costs) -> Cost:
    flops, nbytes = 0, 0
    for c in costs:
        flops, nbytes = flops + c.flops, nbytes + c.bytes
    return Cost(flops, nbytes)


def _hash_flops(R: torch.Tensor, tau: int) -> int:
    m, d = R.shape
    return 2 * m * d + (m // tau) * d


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _valid(mask: torch.Tensor) -> torch.Tensor:
    """Rows with a nonzero weight: the only ones a kernel reads and hashes."""
    return (mask > 0).sum()


def encode(seq: torch.Tensor, mask: torch.Tensor, R: torch.Tensor, *, tau: int) -> Cost:
    """``bse_encode``: seq (B, L, d), mask (B, L) -> table (B, G, U, d) fp32."""
    B, _, d = seq.shape
    G, valid = R.shape[0] // tau, _valid(mask)
    return Cost(valid * _hash_flops(R, tau),
                valid * d * seq.element_size() + _nbytes(mask) + _nbytes(R)
                + B * G * (1 << tau) * d * 4)


def query(q: torch.Tensor, table: torch.Tensor, R: torch.Tensor, *, tau: int) -> Cost:
    """``sdim_query``: q (B, C, d) fp32, table (B, G, U, d) -> (B, C, d)
    fp32. Only the (user, group, bucket) rows the candidates hash to are
    read and normalized: at most B·G·min(C, U) of the B·G·U. The count is
    the function's, whichever path launches it: at MLA's latent width (d =
    512, the wide path) the 128 heads of one token select every row of the
    table."""
    B, C, d = q.shape
    G, U = table.shape[1:3]
    sig = simhash.signatures(q.float(), R.float(), tau).long()              # (B, C, G)
    rows = (torch.arange(B, device=q.device)[:, None, None] * G
            + torch.arange(G, device=q.device)) * U + sig
    hit = torch.zeros(B * G * U, dtype=torch.bool, device=q.device)
    hit[rows.reshape(-1)] = True
    n = hit.sum()
    return Cost(B * C * _hash_flops(R, tau) + n * 3 * d,
                n * d * table.element_size() + 2 * _nbytes(q) + _nbytes(R))


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
    n = B if present is None else (present > 0).sum()
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
    # distinct slots among the rows with a valid event: sorted, -1 for the
    # others, each slot counted at its first place
    s = torch.where((mask > 0).any(1), slots.long(), -1).sort().values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    touched = (first & (s >= 0)).sum()
    return Cost(valid * _hash_flops(R, tau),
                2 * touched * G * U * d * store.element_size() + valid * d * events.element_size()
                + _nbytes(mask) + slots.shape[0] * 4 + _nbytes(R))


def update_sharded(blocks, handles: torch.Tensor, events: torch.Tensor, mask: torch.Tensor,
                   R: torch.Tensor, *, tau: int) -> Cost:
    """``update_sharded``: one ``update`` a shard over the whole batch, the
    foreign rows masked out (counted on the mask's device)."""
    h = handles.numpy()

    def shard(k):
        mine, local = owned(h, k)
        mk = mask * torch.as_tensor(mine, dtype=mask.dtype, device=mask.device)[:, None]
        return update(blocks[k], torch.as_tensor(local, device=mask.device), events, mk, R,
                      tau=tau)
    return _sum(shard(k) for k in range(len(blocks)))


def serve_fused_sharded(blocks, handles: torch.Tensor, q: torch.Tensor, R: torch.Tensor, *,
                        tau: int, scales=None, present: Optional[torch.Tensor] = None) -> Cost:
    """``serve_fused_sharded``: one ``serve_fused`` a shard over the whole
    batch, present only for the users the shard owns."""
    h = handles.numpy()
    pres = np.ones(len(h), bool) if present is None else present.numpy()

    def shard(k):
        return serve_fused(blocks[k], handles[:, 1], q, R, tau=tau,
                           scales=None if scales is None else scales[k],
                           present=torch.as_tensor(owned(h, k)[0] & pres))
    return _sum(shard(k) for k in range(len(blocks)))


def serve_sharded(q: torch.Tensor, seq: torch.Tensor, mask: torch.Tensor, R: torch.Tensor, *,
                  tau: int, devices) -> Cost:
    """``serve_sharded``: one ``serve`` a shard over its rows of the padded
    batch."""
    return _sum(serve(q[lo:hi], seq[lo:hi], mask[lo:hi], R, tau=tau)
                for lo, hi in serve_shards(q.shape[0], len(devices)))


# engine dispatch name -> its cost (SDIMEngine._dispatch's names)
DISPATCH = {"encode": encode, "query": query, "serve": serve, "serve_fused": serve_fused,
            "update": update, "update_sharded": update_sharded,
            "serve_fused_sharded": serve_fused_sharded, "serve_sharded": serve_sharded}


def collective_bytes(name: str, args: tuple, kwargs: dict) -> int:
    """Bytes the dispatch ``name`` moves between distinct devices: the
    inputs each shard on another device than the caller's receives and the
    output it sends back (``update_sharded`` writes its blocks in place and
    sends nothing back). 0 for the single-device dispatches."""
    if name == "update_sharded":
        blocks, handles, events, mask, R = args
        sent = _nbytes(events) + _nbytes(mask) + _nbytes(R) + handles.shape[0] * 4
        return sum(sent for b in blocks if b.device != events.device)
    if name == "serve_fused_sharded":
        blocks, handles, q, R = args
        B = q.shape[0]
        sent = _nbytes(q) + _nbytes(R) + B * 8 + _nbytes(q)       # q, R, slots, present; out
        return sum(sent for b in blocks if b.device != q.device)
    if name == "serve_sharded":
        q, seq, mask, R = args
        row = lambda t: _nbytes(t) // max(t.shape[0], 1)
        return sum((hi - lo) * (2 * row(q) + row(seq) + row(mask)) + _nbytes(R)
                   for dev, (lo, hi) in zip(kwargs["devices"],
                                            serve_shards(q.shape[0], len(kwargs["devices"])))
                   if dev != q.device)
    return 0


def n_devices(name: str, args: tuple, kwargs: dict) -> int:
    """Distinct devices the dispatch ``name`` runs on (1 for every
    single-device dispatch)."""
    if name in ("update_sharded", "serve_fused_sharded"):
        devs = [b.device for b in args[0]]
    elif name == "serve_sharded":
        devs = list(kwargs["devices"])
    else:
        return 1
    return len(set(devs))
