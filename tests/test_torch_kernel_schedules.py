"""CPU rehearsal of the port's split-work kernels' schedules: a numpy
emulation of how ``target_attn.cu``, ``bse_serve.cu``, ``bse_encode.cu``
and ``sdim_fused_serve.cu`` split their work over CTAs (a thread-block
cluster, or a grid of signature-group slices) and merge it, held against
the JAX package on seeded, margin-screened inputs. The CUDA kernels cannot
run here; this pins the algebra they implement.

- target attention: each of S ranks (8 or 7) runs the online softmax
  over its chunk of 32-row tiles, skipping wholly masked tiles unless the
  user has no valid row, and the partial (m, den, acc) are merged in rank
  order;
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
  g)) / n; target_attn_backward runs a CTA per candidate (32 row groups
  with an online max and denominator each, merged in group order, then
  dS * seq summed per row group and merged in order: dq) and a CTA per 32
  rows that loops over the candidates in order (dseq);
- the large-tau paths (large_tau.cuh, tau 5..10): bse_encode gives CTA
  (b, g, j) a slice of group g's buckets, at most 64 KB of them, and adds
  each pass of 1,024 rows into the slice in row order; its backward
  gathers a row's G rows of dT in group order; sdim_query sums each
  candidate's G selected rows, each over its own norm, in g order, then
  / G; its backward gives CTA (b, g, j) 64 rows of group g and adds
  dout / G of the candidates that select a row in c order.

Each kernel is also emulated at dien's behavior width d = 36 (the
``*-d36`` cases): nine float4 columns a row, rows of 144 bytes in fp32,
72 in bf16 and 36 in int8 or fp8; and at the other widths d % 8 == 4
that the wrappers take (``*-d4``, ``*-d20``, ``*-d44``): one, five and
eleven float4 columns, int8 rows of 4, 20 and 44 bytes. Target attention
and its backward are emulated at d = 4, 12, 36 and 44.

Tolerance: atol 1e-5 / rtol 1e-5 in fp32 (the same sums in another order),
as the reference's own tests (tests/test_kernels.py:46-58).
"""
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
from repro_torch.kernels.sdim_bucket.sdim_bucket import MAX_CELLS, encode_splits
from repro_torch.kernels.sdim_update.sdim_update import (sdim_update_ref, update_cells,
                                                         update_splits)
from repro_torch.kernels.sdim_bucket.sdim_bucket import backward_splits
from repro_torch.kernels.sdim_query.sdim_query import query_backward_splits

FP32 = dict(atol=1e-5, rtol=1e-5)
MASKED = np.float32(-1e30)
LAYOUTS = ["random", "front", "last"]


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


@pytest.mark.parametrize("S", [8, 7])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", [(2, 40, 8, 32), (3, 300, 70, 64), (2, 1024, 128, 128),
                                   (2, 77, 9, 4), (3, 130, 40, 12), (2, 1024, 128, 36),
                                   (2, 95, 17, 44)],
                         ids=["L-below-a-tile-per-rank", "ragged", "full-width", "d4", "d12",
                              "dien-d36", "d44"])
def test_target_attention_schedule_matches_jax(shape, layout, S):
    """S = 8 chunks, and S = 7 (the kernel's cluster at a 16-user burst on
    the H100): uneven chunks and candidate slices; also at the widths
    d % 8 == 4 the kernel takes (one, three, nine and eleven float4
    columns)."""
    B, L, C, d = shape
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, C, d)).astype(np.float32)
    seq = rng.standard_normal((B, L, d)).astype(np.float32)
    mask = _mask(rng, B, L, layout)
    out = target_attention_schedule(q, seq, mask, S=S)
    ref = np.asarray(jtarget_attention_ref(jnp.asarray(q), jnp.asarray(seq), jnp.asarray(mask)))
    np.testing.assert_allclose(out, ref, **FP32)
    # the fully masked user attends uniformly over all L rows
    np.testing.assert_allclose(out[-1], np.broadcast_to(seq[-1].mean(0), (C, d)), **FP32)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape,S", [((64, 32, 1, 32), 1), ((2, 40, 8, 32), 2),
                                     ((3, 70, 5, 32), 3)],
                         ids=["folded-retrieval", "two-tiles", "three-tiles"])
def test_target_attention_schedule_at_short_histories(shape, S, layout):
    """Below 8 row tiles the launch takes one CTA per tile (S = number of
    tiles): the retrieval kinds' folded shape (users of one candidate over
    k = 32 rows) runs S = 1."""
    B, L, C, d = shape
    rng = np.random.default_rng(13)
    q = rng.standard_normal((B, C, d)).astype(np.float32)
    seq = rng.standard_normal((B, L, d)).astype(np.float32)
    mask = _mask(rng, B, L, layout)
    out = target_attention_schedule(q, seq, mask, S=S)
    ref = np.asarray(jtarget_attention_ref(jnp.asarray(q), jnp.asarray(seq), jnp.asarray(mask)))
    np.testing.assert_allclose(out, ref, **FP32)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", [
    (2, 40, 8, 32, 12, 2, 4),        # G = 6 over S = 4: ranges 1, 2, 1, 2
    (3, 300, 70, 64, 24, 4, 4),      # G = 6, U = 16 over S = 4
    (2, 1024, 128, 128, 48, 3, 8),   # the main shape: G = 16, 2 groups a rank
    (2, 1000, 100, 128, 36, 3, 8),   # G = 12 over S = 8: ranges 1 or 2
    (2, 1024, 128, 36, 48, 3, 8),    # dien FULL: d = 36, 2 groups a rank
    (3, 301, 70, 36, 10, 2, 5),      # d = 36, G = 5: a group a rank
    (3, 77, 9, 4, 12, 2, 6),         # d = 4: one float4 column, a group a rank
    (2, 130, 40, 20, 24, 3, 8),      # d = 20: five float4 columns, split 2 and 3
    (2, 95, 17, 44, 16, 4, 4),       # d = 44, U = 16: eleven float4 columns
], ids=["G6-S4", "G6-U16-S4", "full-width", "G12-S8", "dien-d36", "G5-d36", "G6-d4",
        "G8-d20", "U16-d44"])
def test_bse_serve_schedule_matches_jax(shape, layout):
    B, L, C, d, m, tau, S = shape
    rng = np.random.default_rng(12)
    R = rng.standard_normal((m, d)).astype(np.float32)
    seq = screened_normal(rng, (B, L, d), R)
    q = screened_normal(rng, (B, C, d), R)
    mask = _mask(rng, B, L, layout)
    out = bse_serve_schedule(q, seq, mask, R, tau, S)
    ref = np.asarray(jsdim_attention(jnp.asarray(q), jnp.asarray(seq), jnp.asarray(mask),
                                     jnp.asarray(R), tau))
    np.testing.assert_allclose(out, ref, **FP32)
    assert not out[-1].any()                      # the fully masked user reads zero


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


@pytest.mark.parametrize("S", [8, 16])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", [
    (2, 40, 32, 12, 2),          # G = 6
    (3, 300, 64, 24, 4),         # G = 6, U = 16: at least 3 slices
    (2, 1024, 128, 48, 3),       # the main shape: G = 16
    (2, 1000, 128, 36, 3),       # G = 12: uneven slices at S = 8
    (2, 1024, 36, 48, 3),        # dien FULL: d = 36
    (3, 301, 36, 10, 2),         # d = 36, G = 5, a 5-row tail batch
    (3, 77, 4, 12, 2),           # d = 4, a 5-row tail batch
    (2, 130, 20, 24, 3),         # d = 20, G = 8, a 2-row tail batch
    (2, 95, 44, 16, 4),          # d = 44, U = 16
], ids=["G6", "G6-U16", "full-width", "G12", "dien-d36", "G5-d36", "G6-d4", "G8-d20",
        "U16-d44"])
def test_bse_encode_schedule_matches_jax(shape, layout, S):
    """S = 8 or 16 slices, capped as the wrapper caps them (at most G, at
    least enough for MAX_CELLS sums a CTA): every element is written once,
    and a fully masked user gets a zero table."""
    B, L, d, m, tau = shape
    G, U = m // tau, 1 << tau
    S = max(-(-G // (MAX_CELLS // U)), min(G, S))
    rng = np.random.default_rng(13)
    R = rng.standard_normal((m, d)).astype(np.float32)
    seq = screened_normal(rng, (B, L, d), R)
    mask = _mask(rng, B, L, layout)
    out, writes = bse_encode_schedule(seq, mask, R, tau, S)
    ref = np.asarray(jbse_encode_ref(jnp.asarray(seq), jnp.asarray(mask), jnp.asarray(R), tau))
    assert (writes == 1).all()
    np.testing.assert_allclose(out, ref, **FP32)
    assert not out[-1].any()                      # the fully masked user


@pytest.mark.parametrize("B, G, U, want", [
    (16, 16, 8, 8),              # the 16-user burst: 128 CTAs, two groups each
    (4, 16, 8, 16),              # a small burst: one group a CTA
    (32, 16, 8, 8),              # the 32-user event fold: 8 slices keep a CTA at 16 sums
    (1, 6, 16, 6),               # never more slices than groups
    (4096, 16, 4, 4),            # a large batch, U = 4: 4 groups a CTA
    (4096, 12, 16, 12),          # U = 16: one group a CTA
    (0, 16, 8, 16),              # no user
])
def test_encode_splits_fill_one_wave(B, G, U, want):
    S = encode_splits(B, G, U, n_sm=132)
    assert S == want
    assert -(-G // S) * U <= MAX_CELLS
    assert B * S <= 132 or S == -(-G // (MAX_CELLS // U))


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


@pytest.mark.parametrize("store_dtype", ["fp32", "bf16", "int8", "fp8",
                                         "query-fp32", "query-bf16"])
@pytest.mark.parametrize("shape", [
    (3, 8, 32, 12, 2, 8),        # G*U = 24 rows: 3 a rank; one candidate a rank
    (3, 70, 64, 24, 4, 8),       # U = 16, ragged C
    (2, 128, 128, 48, 3, 8),     # the main shape: 16 rows and 16 candidates a rank
    (3, 100, 128, 36, 3, 8),     # G = 12 over 8 ranks, C = 100
    (2, 5, 128, 48, 3, 7),       # 7 ranks: uneven rows, ranks without candidates
    (3, 128, 36, 48, 3, 8),      # dien FULL: d = 36, 16 rows a rank
    (3, 70, 36, 10, 2, 8),       # d = 36, G*U = 20: 3 rows a rank rounded up to the loads
    (3, 33, 4, 12, 2, 8),        # d = 4: an int8 load spans 4 rows, 3 rows a rank -> 4
    (3, 40, 20, 12, 2, 8),       # d = 20: int8 loads straddle rows at offsets 4, 8, 12
    (2, 16, 44, 48, 3, 8),       # d = 44: int8 rows of 44 bytes, 16 rows a rank
], ids=["small", "U16", "full-width", "G12", "S7-C5", "dien-d36", "G5-d36", "G6-d4",
        "G6-d20", "d44"])
def test_sdim_fused_serve_schedule_matches_jax(shape, store_dtype):
    """The fused store read, and (``query-*``) sdim_query's identity slots:
    user b reads row b of a fetched fp32 or bf16 table, held against JAX's
    sdim_query oracle."""
    B, C, d, m, tau, S = shape
    G, U = m // tau, 1 << tau
    rng = np.random.default_rng(14)
    R = rng.standard_normal((m, d)).astype(np.float32)
    q = screened_normal(rng, (B, C, d), R)
    if store_dtype.startswith("query-"):
        tables = rng.standard_normal((B, G, U, d)).astype(np.float32)
        tables[0] = 0.0                           # a fully masked user's zero table
        jtable = jnp.asarray(tables, jnp.bfloat16 if store_dtype == "query-bf16"
                             else jnp.float32)
        table = np.asarray(jtable).astype(np.float32)  # the fetched values, exactly
        out = sdim_fused_serve_schedule(table, None, None, None, q, R, tau, S,
                                        itemsize=jtable.dtype.itemsize)
        # the kernel reads a bf16 table exactly into fp32; the oracle would
        # keep it in bf16, so it gets the same values in fp32
        ref = np.asarray(jsdim_query_ref(jnp.asarray(q), jnp.asarray(table), jnp.asarray(R),
                                         tau))
        np.testing.assert_allclose(out, ref, **FP32)
        assert not out[0].any()                   # the zero table reads zero
        return
    N = 2 * B + 1
    rows = rng.standard_normal((N, G, U, d)).astype(np.float32)
    rows *= rng.uniform(0.1, 10.0, (N, G, U, 1)).astype(np.float32)  # unlike row scales
    rows[0] = 0.0                                 # a fully masked user's zero table
    slots = rng.permutation(N)[:B].astype(np.int32)
    slots[0] = 0
    present = np.ones(B, np.float32)
    present[-1] = 0.0                             # the last user is absent
    jscales = None
    if store_dtype in ("int8", "fp8"):
        jstore, jscales = jquant.quantize_rows(jnp.asarray(rows),
                                               dtype=jquant.TABLE_DTYPES[store_dtype])
    else:
        jstore = jnp.asarray(rows, jnp.bfloat16 if store_dtype == "bf16" else jnp.float32)
    store = np.asarray(jstore).astype(np.float32)  # the stored values, exactly
    scales = None if jscales is None else np.asarray(jscales)
    out = sdim_fused_serve_schedule(store, scales, slots, present, q, R, tau, S,
                                    itemsize=jstore.dtype.itemsize)
    ref = np.asarray(jsdim_fused_serve_ref(jstore, jnp.asarray(slots), jnp.asarray(q),
                                           jnp.asarray(R), tau, scales=jscales,
                                           present=jnp.asarray(present)))
    np.testing.assert_allclose(out, ref, **FP32)
    assert not out[-1].any()                      # the absent user
    assert not out[0].any()                       # the zero table reads zero


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


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", ["dups", "two-slots"])
@pytest.mark.parametrize("shape", [
    (6, 5, 32, 12, 2, 4),        # G = 6 over S = 4: slices 1, 2, 1, 2; E = 5
    (6, 16, 128, 48, 3, 4),      # the main path's width: 4 groups a CTA, E = 16
    (5, 16, 128, 36, 3, 8),      # G = 12 over S = 8: slices of 1 or 2
    (4, 80, 64, 24, 4, 2),       # U = 16, E = 80: two event batches a row
    (6, 16, 36, 48, 3, 3),       # dien FULL: d = 36, the fewest slices (6 groups a CTA)
    (6, 5, 36, 10, 2, 4),        # d = 36, E = 5: bf16 rows on 8-byte boundaries
    (6, 5, 4, 12, 2, 3),         # d = 4, E = 5: bf16 event rows of 8 bytes
    (6, 16, 20, 24, 3, 8),       # d = 20: a group a CTA
    (5, 40, 44, 16, 4, 2),       # d = 44, U = 16, E = 40: two event batches a row
], ids=["G6-S4-E5", "full-width", "G12-S8", "U16-E80", "dien-d36", "G5-E5-d36", "G6-E5-d4",
        "G8-d20", "U16-E40-d44"])
def test_sdim_update_schedule_matches_jax(shape, case, dtype):
    """Against JAX's segment-sum oracle and the Pallas kernel in interpret
    mode: every element is written at most once, a zero-mask row and an
    all-masked duplicate write nothing, and untouched cells (signed zeros
    included) keep their exact bits."""
    B, E, d, m, tau, S = shape
    rng = np.random.default_rng(15)
    store, slots, events, mask, R = _update_inputs(rng, B, E, d, m, tau, case)
    jev = jnp.asarray(events, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    ev = np.asarray(jev).astype(np.float32)       # the event values, exactly
    out, writes = sdim_update_schedule(store, slots, np.asarray(jev), mask, R, tau, S)
    args = (jnp.asarray(store), jnp.asarray(slots), jev, jnp.asarray(mask), jnp.asarray(R), tau)
    np.testing.assert_allclose(out, np.asarray(jsdim_update_ref(*args)), **FP32)
    np.testing.assert_allclose(out, np.asarray(jsdim_update(*args, interpret=True)), **FP32)
    assert writes.max() <= 1
    untouched = writes == 0
    assert (out.view(np.uint32)[untouched] == store.view(np.uint32)[untouched]).all()
    if case == "dups":
        assert not writes[0].any()                # slot 0: only the zero-mask row
    reached = np.zeros_like(writes, bool)         # cells some weighted event reached
    G, U = m // tau, 1 << tau
    sig = _signatures(ev.reshape(-1, d), R.reshape(G, tau, d), tau).reshape(B, E, G)
    for b, e in zip(*np.nonzero(mask)):
        reached[slots[b], np.arange(G), sig[b, e]] = True
    np.testing.assert_array_equal(writes == 1, reached)


def test_sdim_update_schedule_no_events_writes_nothing():
    """E = 0 (against the plain version alone: the Pallas kernel takes no
    empty block): the store comes back bit for bit."""
    rng = np.random.default_rng(16)
    store, slots, events, mask, R = _update_inputs(rng, 6, 0, 32, 12, 2, "dups")
    out, writes = sdim_update_schedule(store, slots, events, mask, R, 2, 4)
    plain = sdim_update_ref(torch.from_numpy(store.copy()), torch.from_numpy(slots),
                            torch.from_numpy(events), torch.from_numpy(mask),
                            torch.from_numpy(R), 2)
    np.testing.assert_allclose(out, plain.numpy(), **FP32)
    assert not writes.any()
    np.testing.assert_array_equal(out.view(np.uint32), store.view(np.uint32))


@pytest.mark.parametrize("B, G, U, d, want", [
    (32, 16, 8, 128, 8),         # the 32-user event fold: 256 CTAs, two groups each
    (16, 16, 8, 128, 16),        # a 16-user fold: a group a CTA
    (1, 16, 8, 128, 16),         # one user: never more slices than groups
    (1024, 16, 8, 128, 8),       # a large batch: the fewest slices, 2 groups each
    (1024, 12, 16, 128, 12),     # U = 16: a group a CTA at most
    (64, 6, 4, 32, 4),           # as many as one wave allows
    (16, 6, 4, 32, 6),           # never more than G
    (0, 16, 8, 128, 16),         # no batch row
    (32, 16, 8, 36, 8),          # d = 36: 28 cells a pass of the block, 56 a CTA
    (1024, 16, 8, 36, 3),        # d = 36, a large batch: the fewest slices, 6 groups each
])
def test_update_splits_fill_one_wave(B, G, U, d, want):
    S = update_splits(B, G, U, d, n_sm=132)
    assert S == want
    assert 1 <= S <= G and -(-G // S) * U <= update_cells(d)
    assert B * S <= 2 * 132 or S == -(-G // (update_cells(d) // U))


# ---------------------------------------------------------------------------
# the backward kernels
# ---------------------------------------------------------------------------
def bse_encode_backward_schedule(dT, seq, mask, R, tau, S, warps=8):
    """bse_encode_backward.cu's schedule in numpy fp32: CTA j of user b owns
    rows [j*L/S, (j+1)*L/S); warp w of it takes four rows at a time, lo +
    4w .. lo + 4w + 3, then 32 rows on; a masked row writes zero unhashed.
    Returns d seq and the write counts."""
    B, L, d = seq.shape
    G = R.shape[0] // tau
    Rg = R.reshape(G, tau, d)
    out = np.full((B, L, d), np.nan, np.float32)
    writes = np.zeros((B, L), np.int64)
    for b in range(B):
        for j in range(S):
            lo, hi = j * L // S, (j + 1) * L // S
            for w in range(warps):
                mine = [lo + r0 + h for r0 in range(4 * w, hi - lo, 4 * warps)
                        for h in range(4) if r0 + h < hi - lo]
                for l in mine:
                    writes[b, l] += 1
                    if mask[b, l] == 0:
                        out[b, l] = 0.0
                        continue
                    sig = _signatures(seq[b, l][None], Rg, tau)[0]
                    acc = np.zeros(d, np.float32)
                    for g in range(G):                # group order
                        acc = acc + dT[b, g, sig[g]]
                    out[b, l] = mask[b, l] * acc
    return out, writes


def sdim_query_backward_schedule(dout, q, table, R, tau, S, TC=32):
    """sdim_query_backward.cu's schedule in numpy fp32: CTA j of user b owns
    groups [j*G/S, (j+1)*G/S); candidates in passes of TC, each hit adds
    dout / G into its row in c order; then the row formula. Returns dT and
    the write counts."""
    B, C, d = q.shape
    G, U = R.shape[0] // tau, 1 << tau
    Rg = R.reshape(G, tau, d)
    out = np.full((B, G, U, d), np.nan, np.float32)
    writes = np.zeros((B, G, U), np.int64)
    for b in range(B):
        for j in range(S):
            g0, g1 = j * G // S, (j + 1) * G // S
            g = np.zeros((g1 - g0, U, d), np.float32)
            for c0 in range(0, C, TC):
                sig = _signatures(q[b, c0:c0 + TC], Rg[g0:g1], tau)    # (n, ng)
                for c in range(len(sig)):
                    for gl in range(g1 - g0):
                        g[gl, sig[c, gl]] += dout[b, c0 + c] / np.float32(G)
            t = table[b, g0:g1]
            n = np.sqrt(np.sum(t * t, -1, keepdims=True) + np.float32(1e-12))
            th = t / n
            out[b, g0:g1] = (g - th * np.sum(th * g, -1, keepdims=True)) / n
            writes[b, g0:g1] += 1
    return out, writes


def target_attention_backward_schedule(dout, q, seq, mask, out, groups=32):
    """target_attn_backward.cu's schedule in numpy fp32: a CTA per candidate
    (row group r takes rows r, r + 32, ...: an online max and denominator
    each, merged in group order; then dS * seq per row group, merged in
    order) and a CTA per 32-row tile looping over the candidates."""
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


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", [
    (2, 40, 3, 32, 12, 2),
    (3, 100, 40, 64, 24, 4),     # U = 16; two candidate passes
    (2, 64, 1, 128, 48, 3),      # the main shape, C = 1 (pointwise CTR)
    (2, 64, 1, 36, 48, 3),       # dien FULL's width, C = 1
    (2, 40, 3, 4, 12, 2),        # d = 4
    (3, 64, 1, 20, 24, 3),       # d = 20, C = 1
    (2, 50, 33, 44, 16, 4),      # d = 44, U = 16, two candidate passes
], ids=["G6", "G6-U16", "full-width", "dien-d36", "G6-d4", "G8-d20", "U16-d44"])
def test_sdim_backward_schedules_match_jax(shape, layout):
    """bse_encode_backward and sdim_query_backward split as the wrappers
    split them on a 132-SM card (and with fewer, uneven slices): every
    element written once; a fully masked user's rows get zero."""
    B, L, C, d, m, tau = shape
    G = m // tau
    rng = np.random.default_rng(21)
    R = rng.standard_normal((m, d)).astype(np.float32)
    seq = screened_normal(rng, (B, L, d), R)
    q = screened_normal(rng, (B, C, d), R)
    mask = _mask(rng, B, L, layout)
    dout = rng.standard_normal((B, C, d)).astype(np.float32)
    table, jdT, jdseq = _jax_sdim_backward(dout, q, seq, mask, R, tau)
    for S in (query_backward_splits(B, G, 132), max(1, G // 4 + 1)):
        dT, writes = sdim_query_backward_schedule(dout, q, table, R, tau, S)
        assert (writes == 1).all()
        np.testing.assert_allclose(dT, jdT, **FP32)
    for S in (backward_splits(B, L, 132), 3):
        dseq, writes = bse_encode_backward_schedule(jdT, seq, mask, R, tau, S)
        assert (writes == 1).all()
        np.testing.assert_allclose(dseq, jdseq, **FP32)
        assert not dseq[-1].any()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", [(2, 40, 3, 32), (3, 70, 5, 64), (2, 96, 1, 128),
                                   (2, 40, 3, 4), (3, 70, 5, 12), (2, 96, 1, 36),
                                   (2, 50, 3, 44)])
def test_target_attention_backward_schedule_matches_jax(shape, layout):
    """L not a multiple of 32 (row groups with one row more than others),
    C = 1, and a fully masked last user (uniform weights: its rows get
    sum_c dout / L, its candidates nothing); d = 4, 12, 36 and 44 too."""
    B, L, C, d = shape
    rng = np.random.default_rng(22)
    seq = rng.standard_normal((B, L, d)).astype(np.float32)
    q = rng.standard_normal((B, C, d)).astype(np.float32)
    mask = _mask(rng, B, L, layout)
    dout = rng.standard_normal((B, C, d)).astype(np.float32)
    out = np.asarray(jtarget_attention(jnp.asarray(q), jnp.asarray(seq), jnp.asarray(mask)))
    dq, dseq = target_attention_backward_schedule(dout, q, seq, mask, out)
    jdq, jdseq = jax.grad(lambda a, b: jnp.sum(jtarget_attention(a, b, jnp.asarray(mask))
                                               * jnp.asarray(dout)), argnums=(0, 1))(
        jnp.asarray(q), jnp.asarray(seq))
    np.testing.assert_allclose(dq, np.asarray(jdq), **FP32)
    np.testing.assert_allclose(dseq, np.asarray(jdseq), **FP32)
    assert not dq[-1].any()


@pytest.mark.parametrize("B, L, G, want_rows, want_groups", [
    (32, 1024, 16, 8, 8),        # the training step: 256 CTAs each, one wave at two an SM
    (1, 1024, 16, 32, 16),       # one user: a chunk per 32 rows (capped), one group a CTA
    (4096, 1024, 16, 1, 1),      # a large batch: one CTA a user
    (2, 40, 6, 2, 6),            # short histories: at most one chunk per 32 rows
])
def test_backward_splits_fill_one_wave(B, L, G, want_rows, want_groups):
    assert backward_splits(B, L, n_sm=132) == want_rows
    assert query_backward_splits(B, G, n_sm=132) == want_groups
    assert B * want_rows <= 2 * 132 or want_rows == 1


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


def sdim_query_wide_schedule(q, table, R, tau, S=8, TC=128):
    """wide_query.cuh's schedule in numpy fp32: S ranks split the float4
    columns; partial sums of squares and projections merged in rank order."""
    B, C, d = q.shape
    G, U = R.shape[0] // tau, 1 << tau
    nq, GU, m = d // 4, G * U, R.shape[0]
    K = -(-nq // S)                                      # float4 columns a rank
    cols = [slice(4 * min(nq, r * K), 4 * min(nq, (r + 1) * K)) for r in range(S)]
    out = np.full((B, C, d), np.nan, np.float32)
    for b in range(B):
        t = table[b].reshape(GU, d).astype(np.float32)
        ss = [_warp_sum_of_squares(t[:, c]) for c in cols]
        total = np.zeros(GU, np.float32)
        for part in ss:                                  # rank order
            total = (total + part).astype(np.float32)
        tn = t / np.sqrt(total + np.float32(1e-12))[:, None]
        for c0 in range(0, C, TC):
            qc = q[b, c0:c0 + TC]
            proj = np.zeros((len(qc), m), np.float32)
            for c in cols:                               # rank order
                proj = (proj + _dot4(qc[:, None, c], R[None, :, c],
                                     np.zeros((len(qc), m), np.float32))).astype(np.float32)
            bits = (proj.reshape(len(qc), G, tau) >= 0).astype(np.int64)
            sig = (bits << np.arange(tau)).sum(-1)       # (n, G)
            acc = np.zeros((len(qc), d), np.float32)
            for g in range(G):                           # g order
                acc = (acc + tn[g * U + sig[:, g]]).astype(np.float32)
            out[b, c0:c0 + len(qc)] = acc / np.float32(G)
    return out


@pytest.mark.parametrize("shape", [
    (1, 128, 512, 48, 3),        # deepseek-v2's SDIM-KV read: 16 float4 columns a rank
    (2, 300, 516, 48, 3),        # d % 8 == 4: 17 columns a rank, 10 on the last; 3 passes
    (2, 33, 512, 36, 3),         # G = 12
    (2, 5, 512, 48, 4),          # U = 16
], ids=["mla", "d516", "G12", "U16"])
def test_sdim_query_wide_schedule_matches_jax(shape):
    """The wide path against JAX's sdim_query oracle, a zero table reading
    zero."""
    B, C, d, m, tau = shape
    G, U = m // tau, 1 << tau
    rng = np.random.default_rng(d + C)
    R = rng.standard_normal((m, d)).astype(np.float32)
    q = screened_normal(rng, (B, C, d), R)
    table = rng.standard_normal((B, G, U, d)).astype(np.float32)
    table[0, :, 1] = 0.0                          # empty buckets
    if B > 1:
        table[-1] = 0.0                           # a user with no keys
    out = sdim_query_wide_schedule(q, table, R, tau)
    ref = np.asarray(jsdim_query_ref(jnp.asarray(q), jnp.asarray(table), jnp.asarray(R), tau))
    np.testing.assert_allclose(out, ref, **FP32)
    if B > 1:
        assert not out[-1].any()


# ---------------------------------------------------------------------------
# the large-tau paths (large_tau.cuh: tau 5..10, 32..1,024 buckets a group)
# ---------------------------------------------------------------------------
LT_PASS = 1024               # bse_encode_large_tau.cu kPass
LT_SLICE_BYTES = 64 * 1024   # its kSliceBytes
LT_BWD_ROWS = 64             # sdim_query_large_tau.cu kBwdRowsPerCta


def _lt_slice_buckets(U, d):
    ut = U
    while ut > 1 and ut * d * 4 > LT_SLICE_BYTES:
        ut //= 2
    return ut


def encode_large_tau_schedule(seq, mask, R, tau):
    """bse_encode_large_tau.cu's forward in numpy fp32: CTA (b, g, j) owns
    buckets [j*UT, (j+1)*UT) of group g and adds the rows of each pass of
    kPass whose bucket it owns, in row order. Returns the table and the
    write counts."""
    B, L, d = seq.shape
    G, U = R.shape[0] // tau, 1 << tau
    UT = _lt_slice_buckets(U, d)
    Rg = R.reshape(G, tau, d)
    out = np.full((B, G, U, d), np.nan, np.float32)
    writes = np.zeros((B, G, U), np.int64)
    for b in range(B):
        for g in range(G):
            for u0 in range(0, U, UT):
                cells = np.zeros((UT, d), np.float32)
                for l0 in range(0, L, LT_PASS):
                    x, w = seq[b, l0:l0 + LT_PASS], mask[b, l0:l0 + LT_PASS]
                    sig = _signatures(x, Rg[g:g + 1], tau)[:, 0] - u0
                    for r in np.flatnonzero((w != 0) & (sig >= 0) & (sig < UT)):   # row order
                        cells[sig[r]] = cells[sig[r]] + w[r] * x[r]
                out[b, g, u0:u0 + UT] = cells
                writes[b, g, u0:u0 + UT] += 1
    return out, writes


def encode_backward_large_tau_schedule(dT, seq, mask, R, tau):
    """The large-tau backward: a row's G selected rows of dT summed in group
    order, times its mask; a masked row gets zero, unhashed."""
    B, L, d = seq.shape
    G = R.shape[0] // tau
    sig = _signatures(seq.reshape(B * L, d), R.reshape(G, tau, d), tau).reshape(B, L, G)
    out = np.zeros((B, L, d), np.float32)
    for b in range(B):
        for l in np.flatnonzero(mask[b] != 0):
            acc = np.zeros(d, np.float32)
            for g in range(G):
                acc = acc + dT[b, g, sig[b, l, g]]
            out[b, l] = mask[b, l] * acc
    return out


def query_large_tau_schedule(q, table, R, tau):
    """sdim_query_large_tau.cu's forward: each candidate adds its G selected
    rows, each divided by its own norm, in g order, then / G."""
    B, C, d = q.shape
    G = R.shape[0] // tau
    sig = _signatures(q.reshape(B * C, d), R.reshape(G, tau, d), tau).reshape(B, C, G)
    out = np.zeros((B, C, d), np.float32)
    for g in range(G):
        rows = table[np.arange(B)[:, None], g, sig[..., g]].astype(np.float32)    # (B, C, d)
        n = np.sqrt(np.sum(rows * rows, -1, keepdims=True) + np.float32(1e-12))
        out = out + rows / n
    return out / np.float32(G)


def query_backward_large_tau_schedule(dout, q, table, R, tau):
    """The large-tau backward: CTA (b, g, j) owns rows [64j, 64j + 64) of
    group g, adds dout / G of each candidate that selects a row in c order,
    then writes (g - t^ (t^ . g)) / n. Returns dT and the write counts."""
    B, C, d = q.shape
    G, U = R.shape[0] // tau, 1 << tau
    sig = _signatures(q.reshape(B * C, d), R.reshape(G, tau, d), tau).reshape(B, C, G)
    out = np.full((B, G, U, d), np.nan, np.float32)
    writes = np.zeros((B, G, U), np.int64)
    for b in range(B):
        for g in range(G):
            for u0 in range(0, U, LT_BWD_ROWS):
                u1 = min(U, u0 + LT_BWD_ROWS)
                gv = np.zeros((u1 - u0, d), np.float32)
                for c in range(C):                    # c order
                    if u0 <= sig[b, c, g] < u1:
                        gv[sig[b, c, g] - u0] += dout[b, c] / np.float32(G)
                t = table[b, g, u0:u1]
                n = np.sqrt(np.sum(t * t, -1, keepdims=True) + np.float32(1e-12))
                th = t / n
                out[b, g, u0:u1] = (gv - th * np.sum(th * gv, -1, keepdims=True)) / n
                writes[b, g, u0:u1] += 1
    return out, writes


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", [
    (2, 40, 3, 32, 10, 5),       # U = 32
    (2, 256, 1, 32, 45, 5),      # Table 4's tau = 5 training shape (m = 45), two users
    (2, 256, 1, 32, 40, 10),     # Table 4's tau = 10 (m = 40, U = 1,024): two slices a group
    (1, 1100, 70, 16, 12, 6),    # two passes of rows; two candidate hash rounds
    (1, 60, 3, 128, 20, 10),     # d = 128: eight slices of 128 buckets a group
    (2, 50, 2, 36, 14, 7),       # dien's width d = 36
], ids=["U32", "table4-tau5", "table4-tau10", "two-passes", "d128", "d36"])
def test_large_tau_schedules_match_jax(shape, layout):
    """bse_encode, sdim_query and both backward kernels at tau 5..10 against
    the JAX package (its bucket table and query oracles, and jax.grad of its
    XLA formulation): every element written once, a fully masked user's
    rows and gradient zero."""
    B, L, C, d, m, tau = shape
    rng = np.random.default_rng(23 + tau)
    R = rng.standard_normal((m, d)).astype(np.float32)
    seq = screened_normal(rng, (B, L, d), R)
    q = screened_normal(rng, (B, C, d), R)
    mask = _mask(rng, B, L, layout)
    dout = rng.standard_normal((B, C, d)).astype(np.float32)
    jtable = np.asarray(jbse_encode_ref(jnp.asarray(seq), jnp.asarray(mask), jnp.asarray(R), tau))
    table, writes = encode_large_tau_schedule(seq, mask, R, tau)
    assert (writes == 1).all()
    np.testing.assert_allclose(table, jtable, **FP32)
    out = query_large_tau_schedule(q, jtable, R, tau)
    ref = np.asarray(jsdim_query_ref(jnp.asarray(q), jnp.asarray(jtable), jnp.asarray(R), tau))
    np.testing.assert_allclose(out, ref, **FP32)
    _, jdT, jdseq = _jax_sdim_backward(dout, q, seq, mask, R, tau)
    dT, writes = query_backward_large_tau_schedule(dout, q, jtable, R, tau)
    assert (writes == 1).all()
    np.testing.assert_allclose(dT, jdT, **FP32)
    dseq = encode_backward_large_tau_schedule(jdT, seq, mask, R, tau)
    np.testing.assert_allclose(dseq, jdseq, **FP32)
    if B > 1:
        assert not table[-1].any() and not dseq[-1].any()
