"""The numpy emulations of the port's split-work kernels' schedules,
shared by tests/test_torch_*_schedules.py (one file a kernel). A numpy
emulation of how ``target_attn.cu``, ``bse_serve.cu``, ``bse_encode.cu``
and ``sdim_fused_serve.cu`` split their work over CTAs (a thread-block
cluster, or a grid of signature-group slices) and merge it, held against
the JAX package on seeded, margin-screened inputs. The CUDA kernels cannot
run here; this pins the algebra they implement.

- target attention's cluster body: each of S ranks (8 or 7) runs the
  online softmax over its chunk of 32-row tiles, skipping wholly masked
  tiles unless the user has no valid row, and the partial (m, den, acc)
  are merged in rank order (its folded body: tests/test_torch_fold_schedules.py);
- bse_serve: each of S ranks streams 64-row tiles and builds the table of
  its own range of signature groups (uneven where S does not divide G),
  l2-normalizes it and sums its groups' buckets per candidate; the
  partials are summed in rank order and divided by G;
- bse_encode: each of S CTAs (``encode_splits``) lists the user's 8-row
  batches with a nonzero weight and deals them out to its 16 warps in turn;
  each warp hashes its batches for the CTA's groups and adds each row to
  its bucket in row order; the warps' partial tables are summed in warp
  order and the CTA writes its slice of the table once;
- sdim_fused_serve and sdim_query (one body, fused_query.cuh): each of S
  ranks dequantizes and l2-normalizes its ceil(G*U/S) rows of the user's
  table (the store row slots[b], or row b of a fetched table), rounded up
  to the fewest rows that fill whole 16-byte loads (at d = 36: 2 bf16
  rows, 4 int8 or fp8 rows), reading them 16 bytes at a time, a load that
  straddles two rows taking each value's own row scale; it hashes its
  ceil(C/S) candidates for all G groups, and answers them by summing the
  owners' rows in g order, then / G * present; absent users read no row;
- sdim_query's wide path (wide_query.cuh, where fused_query.cuh's shared
  memory does not fit: MLA's latent, d = 512): each of S = 8 ranks owns
  ceil(d/4 / S) float4 columns of R, of every table row and of each pass
  of 128 candidates; a row's sum of squares over a rank's columns is a
  warp's (float4 columns dealt to the 32 lanes, then a butterfly), a
  candidate's projection a thread's (columns in order); both are summed
  over the ranks in rank order by every rank (each reading the others'
  partials), so every rank gets the same norms and signatures; each rank
  writes its own columns of every answer, the G rows summed in g order,
  then / G;
- sdim_update: the first batch row of each slot owns it; each of S CTAs
  (``update_splits``) takes a slice of its signature groups, starts from
  the stored slice, adds each batch row of the slot in b order (the row's
  events summed in e order, kEv at a time) and writes only the cells that
  an event with a nonzero weight reached;
- the backward kernels (bse_encode_backward, sdim_query_backward,
  target_attn_backward), held against jax.grad of the JAX package's XLA
  formulations: bse_encode_backward gives each of S CTAs a chunk of a
  user's rows, and each row the sum of its G gathered rows of dT in group
  order, times its mask; sdim_query_backward gives each of S CTAs a slice
  of a user's groups, walks the candidates in passes of 32, adds dout / G
  of each hit into its (g, u) rows in c order, then forms (g - t^ (t^ .
  g)) / n, reading only the selected rows and writing the others +0;
  target_attn_backward runs a CTA per candidate (32 row groups
  with an online max and denominator each, merged in group order, then
  dS * seq summed per row group and merged in order: dq) and a CTA per 32
  rows that loops over the candidates in order (dseq);
- the large-tau paths (large_tau.cuh, tau 5..10): bse_encode gives CTA
  (b, s) the Gs whole groups of slice s (``encode_large_tau_splits``),
  hashes each valid row once for each of them, links each group's rows
  into one list a bucket in row order (link_round, then link_heads) and
  writes every cell once, its list's rows added in order from zero; its
  backward gathers a row's G rows of dT in group order; sdim_query runs
  sdim_fused_serve's gather body (below) with user b reading table row b;
  its backward gives CTA (b, s) the Gs groups of slice s
  (``query_backward_large_tau_splits``), lists the candidates by bucket
  the same way, reads each selected row once and adds dout / G of its
  list in c order, and writes the unselected rows +0 without reading the
  table (``test_large_tau_training_schedules_at_the_list_edges``: every
  row in one bucket, each in its own, C > U, L = 0, C = 0); sdim_update's
  fold is emulated in tests/test_torch_fold_schedules.py;
  sdim_fused_serve runs the gather body of large_tau.cuh: a team of eight
  lanes a (candidate, group), a pass of ``teams`` groups at a time, hashes
  the candidate, reads the selected row of its slot scaled by its own
  scale and stores it over its norm; the rows are summed in g order, then
  / G * present; bse_serve's first kernel gives CTA (b, s, j) a slice of
  Gs groups and a chunk of K ranks (``serve_large_tau_splits``), ranks
  the buckets the candidates select (each warp's bits ORed, then the
  warps' in order; u order), walks the tiles of 128 rows that hold a
  nonzero weight, each warp writing its eight rows' byte of every slice
  row's row mask, and sums each mask's rows lowest bit first (l order);
  its second kernel is the gather body on the ranks (also at tau = 1, G =
  48, and G = 80, where the teams take the groups in passes).

Each kernel is also emulated at dien's behavior width d = 36 (the
``*-d36`` cases): nine float4 columns a row, rows of 144 bytes in fp32,
72 in bf16 and 36 in int8 or fp8; and at the other widths d % 8 == 4
that the wrappers take (``*-d4``, ``*-d20``, ``*-d44``): one, five and
eleven float4 columns, int8 rows of 4, 20 and 44 bytes. Target attention
and its backward are emulated at d = 4, 12, 36 and 44.

Tolerance: atol 1e-5 / rtol 1e-5 in fp32 (the same sums in another order),
as the reference's own tests (tests/test_kernels.py:46-58).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sdim as jsdim
from repro.core import simhash as jsimhash
from repro.core.sdim import sdim_attention as jsdim_attention
from repro.core.target_attention import target_attention as jtarget_attention
from repro.kernels.sdim_bucket.ref import bse_encode_ref as jbse_encode_ref
from repro.kernels.sdim_fused_serve.ref import sdim_fused_serve_ref as jsdim_fused_serve_ref
from repro.kernels.sdim_query.ref import sdim_query_ref as jsdim_query_ref
from repro.kernels.sdim_update.ref import sdim_update_ref as jsdim_update_ref
from repro.kernels.sdim_update.sdim_update import sdim_update as jsdim_update
from repro.kernels.target_attn.ref import target_attention_ref as jtarget_attention_ref
from repro.serve import quant as jquant
from repro_torch.kernels.screen import screened_normal
from repro_torch.kernels.sdim_bucket.sdim_bucket import (MAX_CELLS, encode_large_tau_splits,
                                                         encode_splits)
from repro_torch.kernels.sdim_update.sdim_update import (sdim_update_ref, update_cells,
                                                         update_splits)
from repro_torch.kernels.sdim_bucket.sdim_bucket import (BWD_LT_DEVICE_Q, BWD_LT_ROUND,
                                                         BWD_ROUND, LT_BWD_DEVICE,
                                                         backward_splits,
                                                         encode_backward_large_tau_split,
                                                         row_lanes)
from repro_torch.kernels.target_attn.target_attn import TA_BWD_MAX_ROWS, TA_BWD_ROWS
from repro_torch.kernels.target_attn.target_attn import backward_split as ta_backward_split
from repro_torch.kernels.sdim_query.sdim_query import (WIDE_MAX_CANDS,
                                                       query_backward_large_tau_splits,
                                                       query_backward_splits, wide_tile)
from repro_torch.kernels.sdim_serve.sdim_serve import gather_shape, serve_large_tau_splits

FP32 = dict(atol=1e-5, rtol=1e-5)
MASKED = np.float32(-1e30)
LAYOUTS = ["random", "front", "last"]
GPCS = (18,) * 7 + (6,)   # the model card's groups of SMs (132): a cluster stays in one


def card_clusters(per_sm: int = 2):
    """Stands in on the CPU for a backward kernel's cluster-capacity query:
    the clusters of S CTAs (its last argument) that a model 132-SM card
    holds at once, each SM holding ``per_sm`` of the kernel's CTAs and each
    cluster within one of ``GPCS``. At two CTAs an SM it holds 29 clusters
    of 8 and 36 of 7, so 32 users take clusters of 7, as on the H100."""
    return lambda *args: sum(g * per_sm // args[-1] for g in GPCS)


def _mask(rng, B, L, layout):
    """(B, L) fp32 mask; with B > 1 the last user has every row masked."""
    if layout == "random":
        mask = (rng.random((B, L)) > 0.25).astype(np.float32)
    elif layout == "front":                       # leading chunks wholly masked
        lengths = rng.integers(1, max(L // 3, 1) + 1, B)
        mask = (np.arange(L)[None] >= L - lengths[:, None]).astype(np.float32)
    else:                                         # valid rows in the last chunk only
        mask = np.zeros((B, L), np.float32)
        mask[:, -5:] = 1.0
    if B > 1:
        mask[-1] = 0.0
    return mask


def target_attention_schedule(q, seq, mask, S=8, TC=64, TL=32):
    """target_attn.cu's schedule in numpy fp32."""
    B, C, d = q.shape
    L = seq.shape[1]
    scale = np.float32(1.0) / np.sqrt(np.float32(d))
    nt = -(-L // TL)
    per_rank = -(-nt // S)
    out = np.zeros((B, C, d), np.float32)
    for b in range(B):
        user_valid = bool((mask[b] > 0).any())
        for c0 in range(0, C, TC):
            qc = q[b, c0:c0 + TC]
            states = []
            for rank in range(S):
                m = np.full(len(qc), MASKED, np.float32)
                den = np.zeros(len(qc), np.float32)
                acc = np.zeros((len(qc), d), np.float32)
                for t in range(rank * per_rank, min(nt, (rank + 1) * per_rank)):
                    rows = slice(t * TL, min(L, (t + 1) * TL))
                    w, x = mask[b, rows], seq[b, rows]
                    if user_valid and not (w > 0).any():
                        continue                  # its weights are exactly 0
                    s = np.where(w[None] > 0, (qc @ x.T) * scale, MASKED)
                    m_new = np.maximum(m, s.max(1))
                    p = np.exp(s - m_new[:, None])
                    alpha = np.exp(m - m_new)
                    den = den * alpha + p.sum(1)
                    acc = acc * alpha[:, None] + p @ x
                    m = m_new
                states.append((m, den, acc))
            M = np.max([st[0] for st in states], axis=0)
            den = np.zeros_like(M)
            acc = np.zeros((len(qc), d), np.float32)
            for m_j, den_j, acc_j in states:      # rank order
                e = np.exp(m_j - M)
                den = den + den_j * e
                acc = acc + acc_j * e[:, None]
            out[b, c0:c0 + TC] = acc / (den + np.float32(1e-30))[:, None]
    return out


def _signatures(x, R_groups, tau):
    """(n, d) rows, (ng, tau, d) projections -> (n, ng) bucket ids."""
    bits = (np.einsum("nd,gtd->ngt", x, R_groups) >= 0).astype(np.int64)
    return (bits << np.arange(tau)).sum(-1)


def bse_serve_schedule(q, seq, mask, R, tau, S, TL=64, TC=64):
    """bse_serve.cu's schedule in numpy fp32: S ranks over G groups."""
    B, C, d = q.shape
    L = seq.shape[1]
    G, U = R.shape[0] // tau, 1 << tau
    Rg = R.reshape(G, tau, d)
    out = np.zeros((B, C, d), np.float32)
    for b in range(B):
        tables = []
        for rank in range(S):
            g0, g1 = rank * G // S, (rank + 1) * G // S
            table = np.zeros((g1 - g0, U, d), np.float32)
            for l0 in range(0, L, TL):
                w, x = mask[b, l0:l0 + TL], seq[b, l0:l0 + TL]
                if not (w != 0).any():
                    continue                      # a zero-weight tile adds nothing
                sig = _signatures(x, Rg[g0:g1], tau)
                for gl in range(g1 - g0):
                    onehot = (sig[:, gl, None] == np.arange(U)).astype(np.float32)
                    table[gl] += onehot.T @ (w[:, None] * x)
            norm = np.sqrt((table * table).sum(-1, keepdims=True) + np.float32(1e-12))
            tables.append((g0, g1, table / norm))
        for c0 in range(0, C, TC):
            qc = q[b, c0:c0 + TC]
            partials = []
            for g0, g1, tn in tables:
                sig = _signatures(qc, Rg[g0:g1], tau)
                partials.append(sum(tn[gl, sig[:, gl]] for gl in range(g1 - g0)))
            total = np.zeros_like(partials[0])
            for p in partials:                    # rank order
                total = total + p
            out[b, c0:c0 + TC] = total / np.float32(G)
    return out


def bse_encode_schedule(seq, mask, R, tau, S, batch=8, warps=16):
    """bse_encode.cu's schedule in numpy fp32: S CTAs per user over G
    groups. Returns the table and how often each element was written."""
    B, L, d = seq.shape
    G, U = R.shape[0] // tau, 1 << tau
    Rg = R.reshape(G, tau, d)
    out = np.full((B, G, U, d), np.nan, np.float32)
    writes = np.zeros((B, G, U, d), np.int64)
    for b in range(B):
        live = [t for t in range(-(-L // batch)) if (mask[b, t * batch:(t + 1) * batch] != 0).any()]
        for rank in range(S):
            g0, g1 = rank * G // S, (rank + 1) * G // S
            assert (g1 - g0) * U <= MAX_CELLS
            parts = np.zeros((warps, g1 - g0, U, d), np.float32)
            for v in range(warps):                # entry i of the list: warp i % 16
                mine = live[v::warps]
                rows = (np.concatenate([np.arange(t * batch, min(L, (t + 1) * batch))
                                        for t in mine]) if mine else np.zeros(0, np.int64))
                rows = rows[mask[b, rows] != 0]
                sig = _signatures(seq[b, rows], Rg[g0:g1], tau)
                for gl in range(g1 - g0):
                    for u in range(U):
                        pick = rows[sig[:, gl] == u]
                        if len(pick):             # the warp's rows of the cell, in row order
                            terms = mask[b, pick, None] * seq[b, pick]
                            parts[v, gl, u] = np.cumsum(terms, axis=0, dtype=np.float32)[-1]
            total = np.zeros((g1 - g0, U, d), np.float32)
            for v in range(warps):                # warp order
                total = total + parts[v]
            out[b, g0:g1] = total
            writes[b, g0:g1] += 1
    return out, writes


def _dequantize_by_loads(vals, scale, d, V):
    """fused_query.cuh's dequantizing read of a rank's rows, flattened
    (n * d values): V values a 16-byte load; value k of the load at e is in
    row (e + k) // d, tracked as the kernel tracks it."""
    out = np.empty_like(vals)
    for e in range(0, len(vals), V):
        r = e // d
        nxt, s = (r + 1) * d - e, scale[r]
        for k in range(V):
            if k == nxt:
                r, nxt = r + 1, nxt + d
                s = scale[r]
            out[e + k] = vals[e + k] * s
    return out


def sdim_fused_serve_schedule(store, scales, slots, present, q, R, tau, S, TC=32,
                              itemsize=4):
    """fused_query.cuh's schedule in numpy fp32: a cluster of S ranks per
    user splits the (g, u) rows and the candidates. ``slots`` None: user b
    reads row b (sdim_query); ``present`` None: every user present;
    ``itemsize``: the stored dtype's bytes a value."""
    B, C, d = q.shape
    G, U = R.shape[0] // tau, 1 << tau
    GU = G * U
    Rg = R.reshape(G, tau, d)
    V = 16 // itemsize                            # values a 16-byte load
    align = next(a for a in range(1, 17) if a * d * itemsize % 16 == 0)
    assert GU * d * itemsize % 16 == 0            # the wrappers' check
    per_row, per_c = -(-(-(-GU // S)) // align) * align, -(-C // S)
    out = np.full((B, C, d), np.nan, np.float32)
    for b in range(B):
        pres = np.float32(1.0) if present is None else present[b]
        if pres == 0:                             # no row read
            out[b] = 0.0
            continue
        slot = b if slots is None else slots[b]
        row = store[slot].reshape(GU, d).astype(np.float32)
        scale = (np.ones(GU, np.float32) if scales is None
                 else scales[slot].reshape(GU).astype(np.float32))
        slices = []
        for rank in range(S):                     # each rank: its rows, normalized
            lo, hi = min(GU, rank * per_row), min(GU, (rank + 1) * per_row)
            start = (slot * GU + lo) * d * itemsize
            assert start % 16 == 0 and (hi - lo) * d * itemsize % 16 == 0  # whole loads
            t = _dequantize_by_loads(row[lo:hi].reshape(-1), scale[lo:hi], d, V).reshape(-1, d)
            norm = np.sqrt((t * t).sum(-1, keepdims=True) + np.float32(1e-12))
            slices.append(t / norm)
        for rank in range(S):                     # each rank: its candidates
            c_lo, c_hi = min(C, rank * per_c), min(C, (rank + 1) * per_c)
            for c0 in range(c_lo, c_hi, TC):
                qc = q[b, c0:min(c_hi, c0 + TC)]
                sig = _signatures(qc, Rg, tau)    # (n, G)
                acc = np.zeros((len(qc), d), np.float32)
                for g in range(G):                # g order, rows read from their owners
                    idx = g * U + sig[:, g]
                    owner = idx // per_row
                    acc = acc + np.stack([slices[o][i - o * per_row]
                                          for o, i in zip(owner, idx)])
                out[b, c0:c0 + len(qc)] = acc / np.float32(G) * pres
    return out


def sdim_update_schedule(store, slots, events, mask, R, tau, S, EV=64):
    """sdim_update.cu's schedule in numpy fp32: the first batch row of each
    slot owns it; each of its S CTAs takes a slice of the signature groups,
    starts from the stored slice, adds every batch row of the slot in b
    order (the row's events summed per cell in e order, hashed EV at a
    time) and writes only the cells some weighted event reached. Returns the
    store and how often each element was written."""
    N, G, U, d = store.shape
    B, E, _ = events.shape
    Rg = R.reshape(G, tau, d)
    out = store.copy()
    writes = np.zeros(store.shape, np.int64)
    for b in range(B):
        slot = slots[b]
        if (slots[:b] == slot).any():             # an earlier batch row owns the slot
            continue
        for rank in range(S):
            g0, g1 = rank * G // S, (rank + 1) * G // S
            acc = store[slot, g0:g1].copy()
            touched = np.zeros((g1 - g0, U), bool)
            for bb in b + np.flatnonzero(slots[b:] == slot):  # b order
                delta = np.zeros((g1 - g0, U, d), np.float32)
                for e0 in range(0, E, EV):
                    x = events[bb, e0:e0 + EV].astype(np.float32)
                    w = mask[bb, e0:e0 + EV]
                    sig = _signatures(x, Rg[g0:g1], tau)
                    for gl in range(g1 - g0):
                        for u in range(U):
                            pick = np.flatnonzero((sig[:, gl] == u) & (w != 0))
                            if len(pick):         # e order, after the batch before
                                terms = np.concatenate([delta[gl, u][None],
                                                        w[pick, None] * x[pick]])
                                delta[gl, u] = np.cumsum(terms, axis=0, dtype=np.float32)[-1]
                                touched[gl, u] = True
                acc = acc + delta                 # the row's bucket sums, to the running total
            out[slot, g0:g1][touched] = acc[touched]
            writes[slot, g0:g1][touched] += 1
    return out, writes


def _update_inputs(rng, B, E, d, m, tau, case, N=None):
    """Store (with -0.0 cells), slots, events and mask for ``case``: ``dups``
    (random slots with duplicates, a zero-mask row at slot 0 and an
    all-masked duplicate of another row's slot) or ``two-slots`` (every
    row on slot 0 or slot 2)."""
    G, U = m // tau, 1 << tau
    N = N or B + 2
    R = rng.standard_normal((m, d)).astype(np.float32)
    events = screened_normal(rng, (B, E, d), R)
    mask = (rng.random((B, E)) > 0.25).astype(np.float32)
    store = rng.standard_normal((N, G, U, d)).astype(np.float32)
    store[:, :, 0, :4] = -0.0                     # signed zeros keep their bits unless written
    if case == "dups":
        slots = rng.integers(1, max(2, B // 2), B).astype(np.int32)
        slots[0], mask[0] = 0, 0.0                # zero-mask row at slot 0: writes nothing
        slots[-1], mask[-1] = slots[1], 0.0       # an all-masked duplicate
    else:
        slots = np.where(rng.random(B) > 0.5, 0, 2).astype(np.int32)
    return store, slots, events, mask, R


# ---------------------------------------------------------------------------
# the backward kernels
# ---------------------------------------------------------------------------
def bse_encode_backward_schedule(dT, seq, mask, R, tau, S, warps=8):
    """bse_encode_backward.cu's schedule in numpy fp32: a cluster of S CTAs
    a user, rank r owning rows [r*L/S, (r+1)*L/S) (every CTA receives the
    user's dT and R whole); a team of four lanes hashes two rows at once,
    warp w taking the rounds of BWD_ROUND rows w, w + warps, ...; a round's (row, float4 column) pairs dealt to the lanes in order,
    each the sum of the row's G gathered rows of dT in group order from +0,
    times its mask; a masked row writes zero unhashed. Returns d seq and
    the write counts of each (row, float4 column)."""
    B, L, d = seq.shape
    G = R.shape[0] // tau
    Rg = R.reshape(G, tau, d)
    nq = d // 4
    out = np.full((B, L, d), np.nan, np.float32)
    writes = np.zeros((B, L, nq), np.int64)
    rw = BWD_ROUND
    for b in range(B):
        for r in range(S):
            lo, hi = r * L // S, (r + 1) * L // S
            for w in range(warps):
                for base in range(w * rw, hi - lo, warps * rw):
                    rows = np.arange(lo + base, min(hi, lo + base + rw))
                    live = mask[b, rows] != 0
                    sig = _signatures(seq[b, rows], Rg, tau)      # the teams' ids
                    for j in range(len(rows) * nq):                # lanes over (row, column)
                        rr, k = divmod(j, nq)
                        l, cols = rows[rr], slice(4 * k, 4 * k + 4)
                        writes[b, l, k] += 1
                        acc = np.zeros(4, np.float32)
                        if live[rr]:
                            for g in range(G):                     # group order
                                acc = acc + dT[b, g, sig[rr, g], cols]
                        out[b, l, cols] = acc * mask[b, l] if live[rr] else 0.0
    return out, writes


def sdim_query_backward_schedule(dout, q, table, R, tau, S, P=32):
    """sdim_query_backward.cu's schedule (tau <= 4) in numpy fp32: CTA j of
    user b owns groups [j*G/S, (j+1)*G/S); the candidates go in passes of
    P (kCands), each hashed for the CTA's groups; a team a row adds dout /
    G of each candidate that selects the row, in c order (pass after
    pass); a selected row reads its table row once and writes (g - t^
    (t^ . g)) / n as products with 1 / n, n summed in normalize_rows4's
    order (``_warp_sum_of_squares``); an unselected row is written +0
    unread. Returns dT, the write counts and the table rows' read counts."""
    B, C, d = q.shape
    G, U = R.shape[0] // tau, 1 << tau
    Rg = R.reshape(G, tau, d)
    fG = np.float32(G)
    out = np.full((B, G, U, d), np.nan, np.float32)
    writes = np.zeros((B, G, U), np.int64)
    reads = np.zeros((B, G, U), np.int64)
    for b in range(B):
        for j in range(S):
            g0, g1 = j * G // S, (j + 1) * G // S
            g = np.zeros((g1 - g0, U, d), np.float32)
            hit = np.zeros((g1 - g0, U), bool)
            for c0 in range(0, C, P):                                   # passes
                sig = _signatures(q[b, c0:c0 + P], Rg[g0:g1], tau)     # (n, ng)
                for gi in range(g1 - g0):
                    for u in range(U):                                  # a team a row
                        for c in np.flatnonzero(sig[:, gi] == u):       # c order
                            g[gi, u] = g[gi, u] + dout[b, c0 + c] / fG
                            hit[gi, u] = True
            for gi in range(g1 - g0):
                for u in range(U):
                    writes[b, g0 + gi, u] += 1
                    if not hit[gi, u]:
                        out[b, g0 + gi, u] = 0.0                        # +0, unread
                        continue
                    t = table[b, g0 + gi, u]
                    reads[b, g0 + gi, u] += 1
                    inv = np.float32(1) / np.sqrt(_warp_sum_of_squares(t[None])[0]
                                                  + np.float32(1e-12))
                    th = t * inv
                    out[b, g0 + gi, u] = (g[gi, u] - th * np.sum(th * g[gi, u])) * inv
    return out, writes, reads


def _merge_stats(m, den, mo, deno):
    """target_attn_backward.cu merge_stats: the online-softmax merge of two
    (max, denominator) pairs, in fp32."""
    mn = np.maximum(m, mo)
    return mn, (den * np.exp(m - mn) + deno * np.exp(mo - mn)).astype(np.float32)


def target_attention_backward_schedule(dout, q, seq, mask, out, upc, S):
    """target_attn_backward.cu's one launch (C = 1) in numpy fp32: upc users
    a CTA of 8 warps (8 / upc warps, nt threads, a user) or a cluster of S
    CTAs a user, rank r owning rows [r*cap, (r+1)*cap), cap = ceil(L/S).
    A cluster's slot stages only its rows from the first valid one (rounded
    down to an even row) to the last, the rest getting the masked logit
    unread; a CTA of whole users (S = 1) stages every row. Logits
    and dp a row; each thread's rows t, t + nt, ... merged online, a warp's
    by a butterfly (xor 16, ..., 1), the slot's warps in warp order and the
    ranks in rank order (M, DEN); dS and P a row; dseq = P dout + scale dS
    q a (row, float4 column); dq partials of RP row phases over the
    staged rows (the least RP with RP^2 >= 4 rows, at most nt // nq),
    added in phase order, then the ranks' in rank order, times scale. Returns dq, dseq and each (row, float4 column)'s write
    count."""
    B, C, d = q.shape
    assert C == 1
    L = seq.shape[1]
    nq = d // 4
    nt = 32 * (8 // upc)
    cap = -(-L // S)
    scale = np.float32(1.0) / np.sqrt(np.float32(d))
    dq = np.zeros((B, C, d), np.float32)
    dseq = np.full((B, L, d), np.nan, np.float32)
    writes = np.zeros((B, L, nq), np.int64)
    for b in range(B):
        qv, dv = q[b, 0], dout[b, 0]
        Dc = np.float32(np.dot(dv, out[b, 0]))
        ranks = []
        for r in range(S):
            lo = r * cap
            n = max(0, min(cap, L - lo))
            x, valid = seq[b, lo:lo + n], mask[b, lo:lo + n] > 0
            live = np.flatnonzero(valid)
            if S == 1:                                # whole users: every row staged
                f0, e0 = 0, n
            else:
                f0, e0 = (int(live[0]) & ~1, int(live[-1]) + 1) if len(live) else (0, 0)
            a = np.full(n, MASKED, np.float32)
            dp = np.zeros(n, np.float32)
            a[f0:e0] = np.where(valid[f0:e0], (x[f0:e0] @ qv) * scale, MASKED)
            dp[f0:e0] = x[f0:e0] @ dv
            # each thread's rows online, then a warp's butterfly, then warps in order
            k_rows = -(-n // nt)
            pad = np.full(k_rows * nt, MASKED, np.float32)
            pad[:n] = a
            m = np.full(nt, MASKED, np.float32)
            den = np.zeros(nt, np.float32)
            for k in range(k_rows):
                row = pad[k * nt:(k + 1) * nt]
                has = np.arange(k * nt, (k + 1) * nt) < n
                mm, dd = _merge_stats(m, den, row, np.float32(1))
                m, den = np.where(has, mm, m), np.where(has, dd, den)
            m, den = m.reshape(-1, 32), den.reshape(-1, 32)
            for o in (16, 8, 4, 2, 1):
                m, den = _merge_stats(m, den, m[:, np.arange(32) ^ o], den[:, np.arange(32) ^ o])
            ms, ds = m[0, 0], den[0, 0]
            for wi in range(1, len(m)):
                ms, ds = _merge_stats(ms, ds, m[wi, 0], den[wi, 0])
            ranks.append((ms, ds, lo, n, x, valid, a, dp, f0, e0))
        M = max(rk[0] for rk in ranks)
        DEN = np.float32(0)
        for rk in ranks:                                          # rank order
            DEN = np.float32(DEN + rk[1] * np.exp(rk[0] - M))
        total = np.zeros(d, np.float32)
        for ms, ds, lo, n, x, valid, a, dp, f0, e0 in ranks:
            P = (np.exp(a - M) / DEN).astype(np.float32)
            dS = np.where(valid, P * (dp - Dc), 0).astype(np.float32)
            dseq[b, lo:lo + n] = P[:, None] * dv + (scale * dS)[:, None] * qv
            writes[b, lo:lo + n] += 1
            part = np.zeros(d, np.float32)
            RP = min(math.isqrt(max(4 * (e0 - f0), 1) - 1) + 1, nt // nq if nt >= nq else 1)
            for r0 in range(RP):                                  # row phase order
                acc = np.zeros(d, np.float32)
                for rr in range(f0 + r0, e0, RP):
                    acc = acc + dS[rr] * x[rr]
                part = part + acc
            total = total + part                                  # rank order
        dq[b, 0] = scale * total
    return dq, dseq, writes


def target_attention_backward_two_launch_schedule(dout, q, seq, mask, out, groups=32):
    """target_attn_backward.cu's two-launch path (C > 1) in numpy fp32: a
    CTA per candidate (row group r takes rows r, r + 32, ...: an online max
    and denominator each, merged in group order; then dS * seq per row
    group, merged in order) and a CTA per 32-row tile looping over the
    candidates."""
    B, C, d = q.shape
    L = seq.shape[1]
    scale = np.float32(1.0) / np.sqrt(np.float32(d))
    dq = np.zeros((B, C, d), np.float32)
    dseq = np.zeros((B, L, d), np.float32)
    for b in range(B):
        valid = mask[b] > 0
        stats = []
        for c in range(C):
            Dc = np.float32(np.dot(dout[b, c], out[b, c]))
            a = np.where(valid, (seq[b] @ q[b, c]) * scale, MASKED).astype(np.float32)
            ms, dens = [], []
            for r in range(groups):
                m, den = MASKED, np.float32(0)
                for l in range(r, L, groups):
                    mn = max(m, a[l])
                    den = den * np.exp(m - mn) + np.exp(a[l] - mn)
                    m = mn
                ms.append(m)
                dens.append(den)
            M = max(ms)
            DEN = np.float32(0)
            for m, den in zip(ms, dens):              # group order
                DEN = DEN + den * np.exp(m - M)
            dS = np.where(valid, np.exp(a - M) / DEN * (seq[b] @ dout[b, c] - Dc), 0)
            parts = [(dS[r::groups, None] * seq[b, r::groups]).sum(0) for r in range(groups)]
            total = np.zeros(d, np.float32)
            for p in parts:
                total = total + p
            dq[b, c] = scale * total
            stats.append((M, DEN, Dc))
        for l0 in range(0, L, groups):                # a CTA per 32 rows
            for l in range(l0, min(L, l0 + groups)):
                acc = np.zeros(d, np.float32)
                for c, (M, DEN, Dc) in enumerate(stats):
                    s = np.float32(np.dot(q[b, c], seq[b, l]))
                    p = np.exp((s * scale if valid[l] else MASKED) - M) / DEN
                    k = scale * p * (np.dot(dout[b, c], seq[b, l]) - Dc) if valid[l] else 0.0
                    acc = acc + p * dout[b, c] + k * q[b, c]
                dseq[b, l] = acc
    return dq, dseq


def _jax_sdim_backward(dout, q, seq, mask, R, tau):
    """(table, dT, d seq) of <dout, query(q, encode(seq))> by jax.grad."""
    R = jnp.asarray(R)

    def encode(s):
        return jsdim.bucket_table(s, jsimhash.signatures(s, R, tau), jnp.asarray(mask), 1 << tau)

    table, vjp = jax.vjp(encode, jnp.asarray(seq))
    sig_q = jsimhash.signatures(jnp.asarray(q), R, tau)
    dT = jax.grad(lambda t: jnp.sum(jsdim.fused_query(t, sig_q) * jnp.asarray(dout)))(table)
    return np.array(table), np.array(dT), np.array(vjp(dT)[0])


def _jax_encode_vjp(dT, seq, mask, R, tau):
    """d seq of <dT, encode(seq)> by jax.vjp of the JAX package's XLA
    formulation, for any dT."""
    R = jnp.asarray(R)

    def encode(s):
        return jsdim.bucket_table(s, jsimhash.signatures(s, R, tau), jnp.asarray(mask), 1 << tau)

    return np.array(jax.vjp(encode, jnp.asarray(seq))[1](jnp.asarray(dT))[0])


def _jax_target_backward(dout, q, seq, mask):
    """(out, dq, d seq) of <dout, target_attention(q, seq)> by jax.grad."""
    out = np.asarray(jtarget_attention(jnp.asarray(q), jnp.asarray(seq), jnp.asarray(mask)))
    jdq, jdseq = jax.grad(lambda a, b: jnp.sum(jtarget_attention(a, b, jnp.asarray(mask))
                                               * jnp.asarray(dout)), argnums=(0, 1))(
        jnp.asarray(q), jnp.asarray(seq))
    return out, np.asarray(jdq), np.asarray(jdseq)


def _dot4(a, b, acc):
    """sdim_common.cuh's dot4 over whole float4 columns, in column order:
    acc + a . b one fp32 FMA step at a time (rows of a against rows of b)."""
    for k in range(a.shape[-1]):
        acc = (acc + a[..., k] * b[..., k]).astype(np.float32)
    return acc


def _warp_sum_of_squares(t):
    """normalize-style row sums of squares by a warp: lane l sums float4
    columns l, l + 32, ... (dot4), then a butterfly (xor 16, ..., 1)."""
    rows, n = t.shape
    cols = t.reshape(rows, n // 4, 4)
    lanes = np.zeros((32, rows), np.float32)
    for k in range(n // 4):
        lanes[k % 32] = _dot4(cols[:, k], cols[:, k], lanes[k % 32])
    for o in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[np.arange(32) ^ o]).astype(np.float32)
    return lanes[0]


def _warp_dot(x, y):
    """A warp's dot products of rows x (..., d) with y (..., d), broadcast:
    lane l sums the float4 columns l, l + 32, ... in order (dot4), then a
    butterfly (xor 16, ..., 1)."""
    n = np.broadcast_shapes(x.shape, y.shape)[:-1]
    xc = x.reshape(*x.shape[:-1], -1, 4)
    yc = y.reshape(*y.shape[:-1], -1, 4)
    lanes = np.zeros((32,) + n, np.float32)
    for k in range(xc.shape[-2]):
        lanes[k % 32] = _dot4(xc[..., k, :], yc[..., k, :], lanes[k % 32])
    for o in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[np.arange(32) ^ o]).astype(np.float32)
    return lanes[0]


SMEM_OPTIN, SMEM_SM = 232448, 233472   # the H100's shared memory: a CTA's opt-in, an SM's


def _a16(n):
    return -(-n // 16) * 16


def card_ctas(smem, per_sm=4):
    """Stands in on the CPU for a kernel's CTA-capacity query: the CTAs of
    ``smem`` bytes of shared memory one SM of a model H100 holds (1 KB of
    the SM's 228 KB reserved a CTA), at most ``per_sm`` (registers); 0
    where a CTA's opt-in 227 KB does not hold them."""
    return 0 if smem > SMEM_OPTIN else min(per_sm, SMEM_SM // (smem + 1024))


def wide_smem(G, d, m, tile, elem=4):
    """wide_query.cuh's wide_layout: the tile's candidates; one region
    for R, then for two buffers of a candidate's G rows (``elem`` bytes a
    value) and its G normalized rows; the projections, signatures, the
    mbarrier."""
    return (_a16(4 * tile * d) + max(_a16(4 * m * d), 2 * _a16(elem * G * d) + _a16(4 * G * d))
            + _a16(4 * tile * m) + _a16(4 * tile * G) + 8)


def sdim_query_wide_schedule(q, table, R, tau, tile=None, n_sm=132):
    """wide_query.cuh's schedule in numpy fp32: CTA (x, b) answers the tile
    of candidates [x * tile, (x + 1) * tile) of user b (``wide_tile`` on
    the model card, or ``tile``); a warp a projection row sums it over the
    float4 columns in a warp's order (``_warp_dot``) for each candidate;
    the signatures select a row a group; a warp a selected row sums its
    squares in the same order (``_warp_sum_of_squares``), so every CTA that
    reads a row gets the same norm; a thread a (candidate, float4 column)
    adds the G rows times 1 / norm in g order from +0, then / G. Returns
    the answers, the write counts of each (candidate, float4 column) and
    the tile."""
    B, C, d = q.shape
    G, U, m = R.shape[0] // tau, 1 << tau, R.shape[0]
    nq = d // 4
    if tile is None:
        tile = wide_tile(B, C, n_sm, lambda t: card_ctas(wide_smem(G, d, m, t)))
    out = np.full((B, C, d), np.nan, np.float32)
    writes = np.zeros((B, C, nq), np.int64)
    norms = {}                                            # (b, g, u) -> the norm each CTA got
    for b in range(B):
        for c0 in range(0, C, tile):                      # CTA (c0 / tile, b)
            qt = q[b, c0:c0 + tile]
            proj = _warp_dot(qt[:, None], R[None])        # (n, m)
            bits = (proj.reshape(len(qt), G, tau) >= 0).astype(np.int64)
            sig = (bits << np.arange(tau)).sum(-1)        # (n, G)
            rows = table[b, np.arange(G)[None], sig].astype(np.float32)   # (n, G, d)
            nrm = np.sqrt(_warp_sum_of_squares(rows.reshape(-1, d)).reshape(len(qt), G)
                          + np.float32(1e-12))
            for c in range(len(qt)):
                for g in range(G):
                    key = (b, g, int(sig[c, g]))
                    assert norms.setdefault(key, nrm[c, g]) == nrm[c, g]   # one norm a row
            acc = np.zeros((len(qt), d), np.float32)
            inv = np.float32(1) / nrm                     # a row's values times 1 / n
            for g in range(G):                            # g order
                acc = acc + rows[:, g] * inv[:, g, None]
            out[b, c0:c0 + len(qt)] = acc / np.float32(G)
            writes[b, c0:c0 + len(qt)] += 1
    return out, writes, tile


# ---------------------------------------------------------------------------
# the large-tau paths (large_tau.cuh: tau 5..10, 32..1,024 buckets a group)
# ---------------------------------------------------------------------------
def _link_lists(keys, U):
    """large_tau.cuh's link_rounds and link_heads in numpy. link_rounds, a
    round of 32 keys (a lane each) at a time: each keyed lane links to the
    next lane of its key in the round (-1: none) and the lowest lane of a
    key is marked first. link_heads, the rounds from the last to the first:
    every lane reads first (a round's last lane of a key reads the key's
    head so far), then the last lane writes that as its link and the first
    lane becomes the key's head. Returns head (U,) and the links (n,) (-1:
    none)."""
    n = len(keys)
    link = np.full(n, -1, np.int64)
    first = np.zeros(n, bool)
    for base in range(0, n, 32):                     # link_rounds
        lanes = range(base, min(base + 32, n))
        for i in lanes:
            if keys[i] >= 0:
                peers = [j for j in lanes if keys[j] == keys[i]]
                link[i] = next((j for j in peers if j > i), -1)
                first[i] = peers[0] == i
    head = np.full(U, -1, np.int64)
    for base in range(max(n - 1, 0) // 32 * 32, -1, -32):   # link_heads
        lanes = [i for i in range(base, min(base + 32, n)) if keys[i] >= 0]
        read = {i: head[keys[i]] for i in lanes if link[i] < 0}
        for i, nxt in read.items():                  # after every read
            link[i] = nxt
        for i in lanes:
            if first[i]:
                head[keys[i]] = i
    return head, link


def _walk(head, link, u):
    """The rows of bucket u's list, in list order."""
    rows, r = [], head[u]
    while r >= 0:
        rows.append(int(r))
        r = link[r]
    return rows


def encode_large_tau_schedule(seq, mask, R, tau, n_sm=132):
    """bse_encode_large_tau.cu's forward in numpy fp32: CTA (b, s) owns the
    Gs groups of slice s (``encode_large_tau_splits``); it hashes each row
    of nonzero weight once for each of its groups, links each group's rows
    into one list a bucket (``_link_lists``), and each cell adds its
    bucket's rows in list order from zero and is written once, zeros
    included. L = 0 launches nothing (the wrapper returns zeros). Returns
    the table, the write counts of its rows and the hash count of each
    (row, group)."""
    B, L, d = seq.shape
    G, U = R.shape[0] // tau, 1 << tau
    Rg = R.reshape(G, tau, d)
    out = np.full((B, G, U, d), np.nan, np.float32)
    writes = np.zeros((B, G, U), np.int64)
    hashes = np.zeros((B, L, G), np.int64)
    if L == 0:
        return np.zeros((B, G, U, d), np.float32), writes + 1, hashes
    Gs, slices, _ = encode_large_tau_splits(B, G, U, L, d, tau, n_sm)
    assert (slices - 1) * Gs < G <= slices * Gs
    for b in range(B):
        x, w = seq[b].astype(np.float32), mask[b]
        live = w != 0
        for s in range(slices):
            for g in range(s * Gs, min(G, (s + 1) * Gs)):
                keys = np.where(live, _signatures(x, Rg[g:g + 1], tau)[:, 0], -1)
                hashes[b, live, g] += 1
                head, link = _link_lists(keys, U)
                listed = []
                for u in range(U):
                    rows = _walk(head, link, u)
                    assert rows == sorted(rows) and (keys[rows] == u).all()   # l order
                    listed += rows
                    acc = np.zeros(d, np.float32)
                    for r in rows:
                        acc = acc + w[r] * x[r]
                    out[b, g, u] = acc
                    writes[b, g, u] += 1
                assert sorted(listed) == np.flatnonzero(live).tolist()
    return out, writes, hashes


def bwd_lt_smem(G, U, d, tau, Q, staged, r_shared=True):
    """bse_encode_backward_large_tau.cu's bwd_lt_layout: the user's dT where staged,
    R where ``r_shared``, a round's bucket ids (a short a (row, group)) and
    weights, two mbarriers."""
    rows = BWD_LT_ROUND // Q
    return ((_a16(4 * G * U * d) if staged else 0) + (_a16(4 * G * tau * d) if r_shared else 0)
            + _a16(2 * rows * G) + _a16(4 * rows) + 16)


def bwd_lt_ctas(G, U, L, d, tau):
    """The model card's capacity query of the large-tau backward, by layout
    (True: dT and R staged, False: R, ``LT_BWD_DEVICE``: neither, at
    ``BWD_LT_DEVICE_Q`` lanes a row)."""
    def ctas(layout):
        if layout is not True and layout == LT_BWD_DEVICE:
            return card_ctas(bwd_lt_smem(G, U, d, tau, BWD_LT_DEVICE_Q, False, False))
        return card_ctas(bwd_lt_smem(G, U, d, tau, row_lanes(L, d), bool(layout)))
    return ctas


def encode_backward_large_tau_schedule(dT, seq, mask, R, tau, n_sm=132, B_card=None,
                                       staged=None):
    """The large-tau backward (bse_encode_backward_large_tau.cu) in numpy fp32: the
    wrapper's split on the model card for ``B_card`` users (default B):
    S CTAs a user, CTA (b, s) owning rows [s*L/S, (s+1)*L/S) in rounds of
    256 / Q rows (Q = row_lanes(L, d) lanes a row; BWD_LT_DEVICE_Q in the
    LT_BWD_DEVICE layout, where R is read from device memory), with the
    user's dT copied into its shared memory where ``staged`` (the layout:
    True, False or LT_BWD_DEVICE; default: as the split picks it). Each
    round hashes its valid rows for every group; warp w takes the round's
    rows [w * 32/Q, (w+1) * 32/Q), its (row, float4 column)
    pairs dealt to the lanes in order, each the sum of the row's G rows of
    dT in g order from
    +0, then times the mask, from the CTA's copy where staged, else read
    from device memory; a masked row is neither hashed nor read and gets
    +0. Returns d seq, the write counts of each (row, float4 column), the
    hash counts of each (row, group), the device reads of each row of dT
    (selected rows, or whole copies of a user's dT where staged) and
    (staged, S)."""
    B, L, d = seq.shape
    G, U = R.shape[0] // tau, 1 << tau
    Rg, nq = R.reshape(G, tau, d), d // 4
    out = np.full((B, L, d), np.nan, np.float32)
    writes = np.zeros((B, L, nq), np.int64)
    hashes = np.zeros((B, L, G), np.int64)
    reads = np.zeros((B, G, U), np.int64)
    if L == 0:                                       # the wrapper launches nothing
        return out, writes, hashes, reads, (False, 0)
    fit, S = encode_backward_large_tau_split(B_card or B, L, d, n_sm, bwd_lt_ctas(G, U, L, d, tau))
    staged = fit if staged is None else staged
    device = staged is not True and staged == LT_BWD_DEVICE
    Q = BWD_LT_DEVICE_Q if device else row_lanes(L, d)
    staged = staged is True
    rnd, tw = BWD_LT_ROUND // Q, 32 // Q
    assert S == 1 or S <= -(-L // rnd)
    for b in range(B):
        for s in range(S):
            lo, hi = s * L // S, (s + 1) * L // S
            if staged:
                reads[b] += 1                        # one copy of the user's dT a CTA
            for base in range(0, hi - lo, rnd):
                rows = np.arange(lo + base, min(hi, lo + base + rnd))
                w = mask[b, rows]
                live = w != 0
                keys = np.full((len(rows), G), -1, np.int64)
                keys[live] = _signatures(seq[b, rows[live]], Rg, tau)
                hashes[b, rows[live]] += 1
                for warp in range(8):
                    r = np.arange(warp * tw, min(len(rows), (warp + 1) * tw))
                    j = np.arange(len(r) * nq)                 # lanes over (row, column)
                    rr, k = r[j // nq], j % nq
                    cols = 4 * k[:, None] + np.arange(4)
                    acc = np.zeros((len(j), 4), np.float32)
                    for g in range(G):                         # g order
                        u = keys[rr, g]
                        v = dT[b, g, np.maximum(u, 0)[:, None], cols]
                        acc = acc + np.where(live[rr][:, None], v, np.float32(0))
                        if not staged:                         # a row's d values once
                            np.add.at(reads[b, g], u[live[rr] & (k == 0)], 1)
                    out[b, rows[rr][:, None], cols] = np.where(
                        live[rr][:, None], acc * w[rr][:, None], np.float32(0))
                    writes[b, rows[rr], k] += 1
    return out, writes, hashes, reads, (staged, S)


def query_large_tau_schedule(q, table, R, tau):
    """sdim_query_large_tau.cu's forward: sdim_fused_serve's large-tau body
    (``fused_serve_large_tau_schedule``: the gather body's teams a
    (candidate, group), ``teams`` groups a pass, the rows over their norms
    in g order, then / G) with user b reading table row b, no scale, every
    user present."""
    B = q.shape[0]
    return fused_serve_large_tau_schedule(table, None, np.arange(B), np.ones(B, np.float32),
                                          q, R, tau)


def query_backward_large_tau_schedule(dout, q, table, R, tau, n_sm=132):
    """sdim_query_large_tau.cu's backward in numpy fp32: CTA (b, s) owns the
    Gs groups of slice s (``query_backward_large_tau_splits``); it hashes
    each candidate once for each of its groups and links them into one list
    a bucket; a bucket without a list is written +0 without a table read,
    a selected one reads its table row once, adds dout / G of its list's
    candidates in list order and writes (g - t^ (t^ . g)) / n. Returns dT,
    the write counts of its rows and the table rows' read counts."""
    B, C, d = q.shape
    G, U = R.shape[0] // tau, 1 << tau
    Gs, slices, _ = query_backward_large_tau_splits(B, G, U, C, d, tau, n_sm)
    assert (slices - 1) * Gs < G <= slices * Gs
    sig = _signatures(q.reshape(B * C, d), R.reshape(G, tau, d), tau).reshape(B, C, G)
    out = np.full((B, G, U, d), np.nan, np.float32)
    writes = np.zeros((B, G, U), np.int64)
    reads = np.zeros((B, G, U), np.int64)
    for b in range(B):
        for s in range(slices):
            for g in range(s * Gs, min(G, (s + 1) * Gs)):
                head, link = _link_lists(sig[b, :, g], U)
                for u in range(U):
                    writes[b, g, u] += 1
                    cands = _walk(head, link, u)
                    if not cands:
                        out[b, g, u] = 0.0
                        continue
                    assert cands == sorted(cands) and (sig[b, cands, g] == u).all()   # c order
                    gv = np.zeros(d, np.float32)
                    for c in cands:
                        gv = gv + dout[b, c] / np.float32(G)
                    t = table[b, g, u]
                    reads[b, g, u] += 1
                    n = np.sqrt(np.sum(t * t) + np.float32(1e-12))
                    th = t / n
                    out[b, g, u] = (gv - th * np.sum(th * gv)) / n
    return out, writes, reads


def _selected(q, R, tau):
    """(B, G, U) bool: the buckets the candidates select."""
    B, C, d = q.shape
    G, U = R.shape[0] // tau, 1 << tau
    sig = _signatures(q.reshape(B * C, d), R.reshape(G, tau, d), tau).reshape(B, C, G)
    sel = np.zeros((B, G, U), bool)
    for b in range(B):
        for g in range(G):
            sel[b, g, sig[b, :, g]] = True
    return sel


def _check_large_tau_training(seq, q, mask, R, tau, dout):
    """The four large-tau training schedules against the JAX package: the
    encode against its bucket-table oracle, every cell written once and every
    valid (row, group) hashed once; the query against its oracle; both
    backward schedules against jax.grad of its XLA formulation, every row
    of dT written once, only the selected rows read, the others +0."""
    B, L, d = seq.shape
    C = q.shape[1]
    jtable = np.asarray(jbse_encode_ref(jnp.asarray(seq), jnp.asarray(mask), jnp.asarray(R), tau))
    table, writes, hashes = encode_large_tau_schedule(seq, mask, R, tau)
    assert (writes == 1).all()
    assert (hashes == (mask != 0)[..., None]).all()
    np.testing.assert_allclose(table, jtable, **FP32)
    if C:
        out = query_large_tau_schedule(q, jtable, R, tau)
        ref = np.asarray(jsdim_query_ref(jnp.asarray(q), jnp.asarray(jtable), jnp.asarray(R),
                                         tau))
        np.testing.assert_allclose(out, ref, **FP32)
    _, jdT, jdseq = _jax_sdim_backward(dout, q, seq, mask, R, tau)
    dT, writes, reads = query_backward_large_tau_schedule(dout, q, jtable, R, tau)
    assert (writes == 1).all()
    sel = _selected(q, R, tau)
    assert (reads == sel).all()
    assert not dT[~sel].any() and not np.signbit(dT[~sel]).any()    # +0, unread
    np.testing.assert_allclose(dT, jdT, **FP32)
    for layout in (None, True, False):               # the wrapper's choice, then each
        dseq, writes, hashes, reads, _ = encode_backward_large_tau_schedule(jdT, seq, mask, R,
                                                                            tau, staged=layout)
        np.testing.assert_allclose(dseq, jdseq, **FP32)
        assert L == 0 or (writes == 1).all()
        assert (hashes == (mask != 0)[..., None]).all()
        assert not dseq[mask == 0].any() and not np.signbit(dseq[mask == 0]).any()   # +0
    return table, dT, dseq


def _distinct_rows(rng, n, R, tau):
    """n margin-screened rows of R's width whose buckets in group 0 differ."""
    d = R.shape[1]
    pool = screened_normal(rng, (64 * n, d), R)
    sig = _signatures(pool, R[:tau].reshape(1, tau, d), tau)[:, 0]
    _, first = np.unique(sig, return_index=True)
    assert len(first) >= n
    return pool[np.sort(first)[:n]]


# the serving reads at tau 5..10 (sdim_fused_serve_large_tau.cu,
# bse_serve_large_tau.cu; sdim_update_large_tau.cu's fold:
# tests/test_torch_fold_schedules.py)
SERVE_TILE = 128             # bse_serve_large_tau.cu kServeTile: 8 rows a warp


def _gather_large_tau(sel, row_of, G, d, teams):
    """large_tau.cuh's gather body for one candidate: a team of eight lanes
    a group, ``teams`` groups at a time, each reads its selected row
    (``row_of(g, sel[g])``, scaled) and stores it over its norm; then the
    chunk's rows are added in g order. Returns the sum."""
    acc = np.zeros(d, np.float32)
    for g0 in range(0, G, teams):
        chunk = []
        for g in range(g0, min(G, g0 + teams)):                       # the teams, at once
            row = row_of(g, sel[g])
            chunk.append(row / np.sqrt(np.sum(row * row) + np.float32(1e-12)))
        for row in chunk:                                              # g order
            acc = acc + row
    return acc


def fused_serve_large_tau_schedule(store, scales, slots, present, q, R, tau):
    """sdim_fused_serve_large_tau.cu in numpy fp32: the team of each
    (candidate, group) hashes the candidate for its group and reads the
    selected row of its user's slot, scaled by its own scale; the gather
    body sums the rows over their norms in g order; then / G * present. An
    absent user reads no row."""
    B, C, d = q.shape
    G = R.shape[0] // tau
    _, teams = gather_shape(B, C, G, n_sm=132)
    sig = _signatures(q.reshape(B * C, d), R.reshape(G, tau, d), tau).reshape(B, C, G)
    out = np.zeros((B, C, d), np.float32)
    for b in range(B):
        if present[b] == 0:
            continue
        slot = slots[b]

        def row_of(g, u):
            row = store[slot, g, u].astype(np.float32)
            return row if scales is None else row * scales[slot, g, u]

        for c in range(C):
            out[b, c] = (_gather_large_tau(sig[b, c], row_of, G, d, teams) / np.float32(G)
                         * present[b])
    return out


def serve_large_tau_schedule(q, seq, mask, R, tau, n_sm=132, Gs=None, K=None):
    """bse_serve_large_tau.cu in numpy fp32. Kernel 1: CTA (b, s, j) holds
    the Gs groups of slice s and ranks [jK, (j+1)K) of each
    (``serve_large_tau_splits``, or the ``Gs`` and ``K`` given). Its 16
    warps hash user b's candidates, eight a warp, 128 a round, each warp
    ORing its candidates' buckets into its own bitmap words; the warps'
    words are ORed in warp order and ranked (u order), and chunk 0 writes
    each candidate's rank. Then, a tile of SERVE_TILE staged rows at a
    time (only tiles with a nonzero weight), warp w keys its rows 8w..8w+7
    of nonzero weight to their slice rows in each group (or -1) and
    writes, for every slice row, the byte of its rows among them: byte w
    of the slice row's row mask; each cell adds the rows of its mask in
    row order (lowest bit first) into its sums, which go to a scratch by
    rank. Kernel 2: the gather body
    on the candidate's ranks; then / G. Returns the output, each scratch
    row's and rank's write count, and how many buckets had rows in two
    tiles or more."""
    B, C, d = q.shape
    L = seq.shape[1]
    G, U = R.shape[0] // tau, 1 << tau
    Rg = R.reshape(G, tau, d)
    every, warps, per_warp = min(U, C), SERVE_TILE // 8, 8
    split = serve_large_tau_splits(B, G, U, C, d, tau, n_sm)
    Gs, K = Gs or split[0], K or split[2]
    qsig = _signatures(q.reshape(B * C, d), Rg, tau).reshape(B, C, G)
    ssig = _signatures(seq.reshape(B * L, d), Rg, tau).reshape(B, L, G)
    tab = np.full((B, G, every, d), np.nan, np.float32)
    writes = np.zeros((B, G, every), np.int64)
    ranks = np.full((B, C, G), -1, np.int64)
    rank_writes = np.zeros((B, C, G), np.int64)
    split_buckets = 0
    for b in range(B):
        for g0 in range(0, G, Gs):
            groups = range(g0, min(G, g0 + Gs))
            selected = {}
            for g in groups:                                           # the bitmap
                warp_bits = [set() for _ in range(warps)]
                for base in range(0, C, SERVE_TILE):
                    for c in range(base, min(C, base + SERVE_TILE)):
                        warp_bits[(c - base) // per_warp].add(qsig[b, c, g])
                selected[g] = sorted(set().union(*warp_bits))          # u order = rank
            rank = {g: {u: k for k, u in enumerate(selected[g])} for g in groups}
            for j in range(-(-every // K)):
                lo = j * K
                if j == 0:
                    for g in groups:
                        ranks[b, :, g] = [rank[g][u] for u in qsig[b, :, g]]
                        rank_writes[b, :, g] += 1
                if all(lo >= len(selected[g]) for g in groups):
                    continue
                sums = {g: np.zeros((K, d), np.float32) for g in groups}
                tiles_of = {}
                for l0 in range(0, L, SERVE_TILE):
                    x = seq[b, l0:l0 + SERVE_TILE].astype(np.float32)
                    w = mask[b, l0:l0 + SERVE_TILE]
                    if not w.any():                                    # not listed
                        continue
                    for g in groups:
                        keys = [rank[g].get(ssig[b, l0 + r, g], -1) - lo
                                if w[r] != 0 else -1 for r in range(len(w))]
                        keys = [k if 0 <= k < K else -1 for k in keys]
                        masks = np.zeros(K, object)                    # 128-bit masks
                        for wp in range(warps):                        # byte wp: warp wp's rows
                            for k in range(K):
                                byte = sum(1 << i for i in range(per_warp)
                                           if wp * per_warp + i < len(keys)
                                           and keys[wp * per_warp + i] == k)
                                masks[k] |= byte << (per_warp * wp)
                        for k in range(K):
                            m = int(masks[k])
                            if m:
                                tiles_of.setdefault((g, k), set()).add(l0)
                            while m:                                   # four rows at a time
                                batch = []
                                for _ in range(4):
                                    if m:
                                        batch.append((m & -m).bit_length() - 1)
                                        m &= m - 1
                                for r in batch:                        # lowest bit first
                                    sums[g][k] = sums[g][k] + w[r] * x[r]
                split_buckets += sum(len(t) > 1 for t in tiles_of.values())
                for g in groups:
                    hi = min(len(selected[g]), lo + K)
                    tab[b, g, lo:hi] = sums[g][:hi - lo]
                    writes[b, g, lo:hi] += 1
    _, teams = gather_shape(B, C, G, n_sm)
    out = np.zeros((B, C, d), np.float32)
    for b in range(B):
        for c in range(C):
            out[b, c] = _gather_large_tau(ranks[b, c], lambda g, k: tab[b, g, k], G, d,
                                          teams) / np.float32(G)
    return out, writes, rank_writes, split_buckets
