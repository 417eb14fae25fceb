"""CPU rehearsal of the port's split-work kernels' schedules: a numpy
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
from repro_torch.kernels.sdim_bucket.sdim_bucket import (BWD_LT_ROUND, BWD_ROUND,
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
    tiles): users of one candidate over k = 32 rows run S = 1 on the
    cluster body (the wrapper runs the retrieval kinds' folded users on the
    folded body, ``target_attention_folded_schedule`` in
    tests/test_torch_fold_schedules.py)."""
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
        dT, writes, reads = sdim_query_backward_schedule(dout, q, table, R, tau, S)
        assert (writes == 1).all() and (reads == _selected(q, R, tau)).all()
        np.testing.assert_allclose(dT, jdT, **FP32)
    for S in (backward_splits(B, L, 132, card_clusters()), 3):
        dseq, writes = bse_encode_backward_schedule(jdT, seq, mask, R, tau, S)
        assert (writes == 1).all()
        np.testing.assert_allclose(dseq, jdseq, **FP32)
        assert not dseq[-1].any()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("tau", [1, 3, 4])
def test_sdim_backward_schedules_at_the_protocol_shape(tau, layout):
    """The Table 2/3 protocol's and Table 4's training step (B = 128, L =
    256, d = 32, C = 1, m = 48): the splits the wrappers take for 128 users
    on a 132-SM card (bse_encode_backward: clusters of 3 where it holds
    four CTAs an SM), emulated for the first three users."""
    B, L, C, d, m = 3, 256, 1, 32, 48
    G = m // tau
    rng = np.random.default_rng(23 + tau)
    R = rng.standard_normal((m, d)).astype(np.float32)
    seq = screened_normal(rng, (B, L, d), R)
    q = screened_normal(rng, (B, C, d), R)
    mask = _mask(rng, B, L, layout)
    dout = rng.standard_normal((B, C, d)).astype(np.float32)
    table, jdT, jdseq = _jax_sdim_backward(dout, q, seq, mask, R, tau)
    S = backward_splits(128, L, 132, card_clusters(4))
    assert S == 3
    dseq, writes = bse_encode_backward_schedule(jdT, seq, mask, R, tau, S)
    assert (writes == 1).all()
    np.testing.assert_allclose(dseq, jdseq, **FP32)
    dT, writes, reads = sdim_query_backward_schedule(dout, q, table, R, tau,
                                                     query_backward_splits(128, G, 132))
    assert (writes == 1).all() and (reads == _selected(q, R, tau)).all()
    np.testing.assert_allclose(dT, jdT, **FP32)


def _jax_target_backward(dout, q, seq, mask):
    """(out, dq, d seq) of <dout, target_attention(q, seq)> by jax.grad."""
    out = np.asarray(jtarget_attention(jnp.asarray(q), jnp.asarray(seq), jnp.asarray(mask)))
    jdq, jdseq = jax.grad(lambda a, b: jnp.sum(jtarget_attention(a, b, jnp.asarray(mask))
                                               * jnp.asarray(dout)), argnums=(0, 1))(
        jnp.asarray(q), jnp.asarray(seq))
    return out, np.asarray(jdq), np.asarray(jdseq)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", [(2, 40, 3, 32), (3, 70, 5, 64), (2, 96, 1, 128),
                                   (2, 40, 3, 4), (3, 70, 5, 12), (2, 96, 1, 36),
                                   (2, 50, 3, 44)])
def test_target_attention_backward_schedule_matches_jax(shape, layout):
    """L not a multiple of 32 (row groups with one row more than others),
    C = 1, and a fully masked last user (uniform weights: its rows get
    sum_c dout / L, its candidates nothing); d = 4, 12, 36 and 44 too. C >
    1 takes the two-launch path; the first candidate alone (C = 1) the one
    launch, at the split the wrapper takes and at a cluster of 2."""
    B, L, C, d = shape
    rng = np.random.default_rng(22)
    seq = rng.standard_normal((B, L, d)).astype(np.float32)
    q = rng.standard_normal((B, C, d)).astype(np.float32)
    mask = _mask(rng, B, L, layout)
    dout = rng.standard_normal((B, C, d)).astype(np.float32)
    if C > 1:
        assert ta_backward_split(B, L, C, d, 4, 132, card_clusters()) == (0, 0)
        out, jdq, jdseq = _jax_target_backward(dout, q, seq, mask)
        dq, dseq = target_attention_backward_two_launch_schedule(dout, q, seq, mask, out)
        np.testing.assert_allclose(dq, jdq, **FP32)
        np.testing.assert_allclose(dseq, jdseq, **FP32)
        assert not dq[-1].any()
        q, dout = q[:, :1].copy(), dout[:, :1].copy()
    out, jdq, jdseq = _jax_target_backward(dout, q, seq, mask)
    for upc, S in (ta_backward_split(B, L, 1, d, 4, 132, card_clusters()), (1, 2)):
        dq, dseq, writes = target_attention_backward_schedule(dout, q, seq, mask, out, upc, S)
        assert (writes == 1).all()
        np.testing.assert_allclose(dq, jdq, **FP32)
        np.testing.assert_allclose(dseq, jdseq, **FP32)
        assert not dq[-1].any()


@pytest.mark.parametrize("shape", [
    (128, 16, 32, 24),        # the protocol's folded retrieval kinds: 128 users, k = 16
    (2048, 32, 128, 24),      # chip_smoke's folded shape: 16 x 128 candidates, k = 32
    (2048, 32, 36, 24),       # dien's width
    (128, 256, 32, 3),        # the protocol's target kind (B = 128, L = 256, d = 32)
    (32, 1024, 128, 2),       # the training step (B = 32, L = 1,024, d = 128)
], ids=["folded-L16-d32", "folded-L32-d128", "folded-L32-d36", "protocol-target",
        "train-main"])
def test_target_attention_backward_schedule_at_the_training_shapes(shape):
    """The one launch at the shapes its launches on record use, with the
    split the wrapper takes for all B users on a 132-SM card (users packed
    a CTA, or a cluster a user), emulated for the first `n` users. Folded
    users hold their valid rows first (top-k order), some fewer than k and
    some none (uniform weights, no gradient in the candidate)."""
    B, L, d, n = shape
    rng = np.random.default_rng(24)
    seq = rng.standard_normal((n, L, d)).astype(np.float32)
    q = rng.standard_normal((n, 1, d)).astype(np.float32)
    dout = rng.standard_normal((n, 1, d)).astype(np.float32)
    if L <= 32:
        found = rng.integers(0, L + 1, n)
        found[:2] = (0, L)
        mask = (np.arange(L)[None] < found[:, None]).astype(np.float32)
    else:
        mask = _mask(rng, n, L, "front")
    upc, S = ta_backward_split(B, L, 1, d, 4, 132, card_clusters())
    assert (upc, S) == {2048: (4, 1) if d == 128 else (8, 1), 32: (1, 7)}.get(B, (1, 1))
    out, jdq, jdseq = _jax_target_backward(dout, q, seq, mask)
    dq, dseq, writes = target_attention_backward_schedule(dout, q, seq, mask, out, upc, S)
    assert (writes == 1).all()
    np.testing.assert_allclose(dq, jdq, **FP32)
    np.testing.assert_allclose(dseq, jdseq, **FP32)
    assert not dq[mask.sum(1) == 0].any()


@pytest.mark.parametrize("B, L, G, per_sm, want_rows, want_groups", [
    (32, 1024, 16, 2, 7, 8),     # the training step: 29 clusters of 8 fit, 32 of 7: 224 CTAs
    (24, 1024, 16, 2, 8, 11),    # 24 users: clusters of 8 fit
    (1, 1024, 16, 2, 8, 16),     # one user: the largest cluster, one group a CTA
    (4096, 1024, 16, 2, 1, 1),   # a large batch: one CTA a user
    (2, 40, 6, 2, 2, 6),         # short histories: at most one CTA per 32 rows
    (128, 256, 16, 4, 3, 2),     # the protocol's step, four CTAs an SM: clusters of 3
])
def test_backward_splits_fill_one_wave(B, L, G, per_sm, want_rows, want_groups):
    fit = card_clusters(per_sm)
    assert backward_splits(B, L, 132, fit) == want_rows
    assert query_backward_splits(B, G, n_sm=132) == want_groups
    assert want_rows == 1 or B * (want_rows - 1) < 2 * 132        # two CTAs an SM at most
    assert want_rows == 1 or B <= fit(want_rows)                  # one wave


@pytest.mark.parametrize("B, L, C, d, elem, per_sm, want", [
    (32, 1024, 1, 128, 4, 2, (1, 7)),     # the training step: 29 clusters of 8 fit, 36 of 7
    (24, 1024, 1, 128, 4, 2, (1, 8)),     # 24 users: 64 KB a CTA in clusters of 8
    (32, 1024, 1, 36, 4, 2, (1, 3)),      # dien's width: 48 KB a CTA
    (32, 1024, 1, 128, 2, 2, (1, 4)),     # bf16 rows
    (128, 256, 1, 32, 4, 2, (1, 1)),      # the protocol's target kind: 32 KB, one CTA a user
    (2048, 32, 1, 128, 4, 2, (4, 1)),     # folded retrieval: four users a CTA (64 KB)
    (2048, 16, 1, 32, 4, 2, (8, 1)),      # 2,048 users of 16 rows
    (128, 16, 1, 32, 4, 2, (1, 1)),       # the protocol's folded kinds: a CTA a user
    (2048, 32, 1, 36, 4, 2, (8, 1)),      # folded at dien's width
    (600, 32, 1, 128, 4, 2, (4, 1)),      # 150 CTAs of four: a CTA for each SM
    (400, 32, 1, 128, 4, 2, (2, 1)),      # four would leave SMs idle
    (100, 16, 1, 32, 4, 2, (1, 1)),       # few short users: one a CTA
    (32, 1024, 1, 256, 4, 1, (1, 8)),     # d = 256, one CTA an SM: no cluster of <= 192 KB fits
    (32, 4096, 1, 256, 4, 1, (0, 0)),     # past 8 CTAs' shared memory: two launches
    (32, 1024, 128, 128, 4, 2, (0, 0)),   # C > 1: two launches
])
def test_target_attention_backward_split(B, L, C, d, elem, per_sm, want):
    """(users a CTA, CTAs a user) that the target attention backward
    launches on the model card."""
    fit = card_clusters(per_sm)
    upc, S = ta_backward_split(B, L, C, d, elem, 132, fit)
    assert (upc, S) == want
    if S:
        cap = -(-L // S)
        assert upc * cap * d * elem <= (TA_BWD_ROWS if upc > 1 else TA_BWD_MAX_ROWS)
        assert S == 1 or (S - 1) * TA_BWD_ROWS < L * d * elem     # the fewest CTAs
        assert S in (1, 8) or B <= fit(upc, cap, S)               # shrunk to one wave
        assert -(-B // upc) >= 132 or upc == 1


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


@pytest.mark.parametrize("shape", [
    (1, 128, 512, 48, 3),        # deepseek-v2's SDIM-KV read: 128 CTAs of one candidate
    (2, 300, 516, 48, 3),        # d % 8 == 4: 129 float4 columns, 5 a lane, the last on one
    (2, 33, 512, 36, 3),         # G = 12
    (2, 5, 512, 48, 4),          # U = 16
    (8, 128, 512, 48, 3),        # B = 8: tiles of 4 (256 CTAs)
    (8, 70, 512, 48, 3),         # C not a multiple of the tile: 70 = 23 * 3 + 1
    (2, 0, 512, 48, 3),          # C = 0: no CTA
    (2, 9, 1024, 48, 3),         # d = 1,024: R alone 192 KB, one CTA an SM
], ids=["mla", "d516", "G12", "U16", "B8", "C70", "C0", "d1024"])
def test_sdim_query_wide_schedule_matches_jax(shape):
    """The wide path against JAX's sdim_query oracle, every answer written
    once, a zero table reading zero, and the tile the model card's one-wave
    choice."""
    B, C, d, m, tau = shape
    G, U = m // tau, 1 << tau
    rng = np.random.default_rng(d + C)
    R = rng.standard_normal((m, d)).astype(np.float32)
    q = screened_normal(rng, (B, C, d), R)
    table = rng.standard_normal((B, G, U, d)).astype(np.float32)
    table[0, :, 1] = 0.0                          # empty buckets
    if B > 1:
        table[-1] = 0.0                           # a user with no keys
    out, writes, tile = sdim_query_wide_schedule(q, table, R, tau)
    assert (writes == 1).all()
    assert tile == {(1, 128): 1, (8, 128): 4, (8, 70): 3}.get((B, C), tile)
    ref = np.asarray(jsdim_query_ref(jnp.asarray(q), jnp.asarray(table), jnp.asarray(R), tau))
    np.testing.assert_allclose(out, ref, **FP32)
    if B > 1:
        assert not out[-1].any()


@pytest.mark.parametrize("B, C, d, m, want", [
    (1, 128, 512, 48, 1),      # the MLA read: 128 CTAs, two an SM
    (8, 128, 512, 48, 4),      # 256 CTAs of 4 (tiles of 3 need 344)
    (8, 70, 512, 48, 3),       # 192 CTAs of 3 (tiles of 2 need 280)
    (3, 300, 516, 48, 4),      # 225 CTAs of 4
    (2, 33, 1024, 48, 1),      # one CTA an SM: 66 CTAs
    (64, 128, 1024, 48, 8),    # no tile fits one wave: the most candidates a CTA
    (1, 1, 512, 48, 1),
])
def test_wide_tile_fills_one_wave(B, C, d, m, want):
    """The wide path's tile (sdim_query.py wide_tile) on the model card:
    the fewest candidates a CTA whose B * ceil(C / tile) CTAs fit one wave
    of the 132 SMs, else WIDE_MAX_CANDS; a tile of one candidate fits a
    CTA's shared memory up to d = 1,184 at m = 48 and not at 1,188."""
    G = m // 3
    ctas = lambda t: card_ctas(wide_smem(G, d, m, t))
    tile = wide_tile(B, C, 132, ctas)
    assert tile == want and 1 <= tile <= WIDE_MAX_CANDS
    fits = B * -(-C // tile) <= 132 * ctas(tile)
    assert fits or tile == WIDE_MAX_CANDS
    assert tile == 1 or not B * -(-C // (tile - 1)) <= 132 * ctas(tile - 1)
    assert card_ctas(wide_smem(16, 1184, 48, 1)) > 0 and card_ctas(wide_smem(16, 1188, 48, 1)) == 0


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


def bwd_lt_smem(G, U, d, tau, Q, staged):
    """bse_encode_large_tau.cu's bwd_lt_layout: the user's dT where staged,
    R, a round's bucket ids (a short a (row, group)) and weights, two
    mbarriers."""
    rows = BWD_LT_ROUND // Q
    return ((_a16(4 * G * U * d) if staged else 0) + _a16(4 * G * tau * d) + _a16(2 * rows * G)
            + _a16(4 * rows) + 16)


def bwd_lt_ctas(G, U, L, d, tau):
    """The model card's capacity query of the large-tau backward."""
    return lambda staged: card_ctas(bwd_lt_smem(G, U, d, tau, row_lanes(L, d), staged))


def encode_backward_large_tau_schedule(dT, seq, mask, R, tau, n_sm=132, B_card=None,
                                       staged=None):
    """The large-tau backward (bse_encode_large_tau.cu) in numpy fp32: the
    wrapper's split on the model card for ``B_card`` users (default B):
    S CTAs a user, CTA (b, s) owning rows [s*L/S, (s+1)*L/S) in rounds of
    256 / Q rows (Q = row_lanes(L, d) lanes a row), with the user's dT
    copied into its shared memory where ``staged`` (default: where it
    fits). Each round hashes its valid rows for every group; warp w takes
    the round's rows [w * 32/Q, (w+1) * 32/Q), its (row, float4 column)
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
    Q = row_lanes(L, d)
    fit, S = encode_backward_large_tau_split(B_card or B, L, d, n_sm, bwd_lt_ctas(G, U, L, d, tau))
    staged = fit if staged is None else staged
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


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", [
    (2, 40, 3, 32, 10, 5),       # U = 32
    (2, 256, 1, 32, 45, 5),      # Table 4's tau = 5 training shape (m = 45), two users
    (2, 256, 1, 32, 40, 10),     # Table 4's tau = 10 (m = 40, U = 1,024)
    (1, 1100, 70, 16, 12, 6),    # 35 rounds of links; two candidate hash rounds
    (1, 60, 3, 128, 20, 10),     # d = 128
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
    table, _, dseq = _check_large_tau_training(seq, q, mask, R, tau, dout)
    if B > 1:
        assert not table[-1].any() and not dseq[-1].any()


def _distinct_rows(rng, n, R, tau):
    """n margin-screened rows of R's width whose buckets in group 0 differ."""
    d = R.shape[1]
    pool = screened_normal(rng, (64 * n, d), R)
    sig = _signatures(pool, R[:tau].reshape(1, tau, d), tau)[:, 0]
    _, first = np.unique(sig, return_index=True)
    assert len(first) >= n
    return pool[np.sort(first)[:n]]


@pytest.mark.parametrize("case", ["one-bucket", "distinct", "C>U", "L0", "C0"])
def test_large_tau_training_schedules_at_the_list_edges(case):
    """The two list-building schedules where the lists are extreme: every
    valid row (and candidate) in one bucket of each group (one list of all
    of them, in order); every row and candidate in a bucket of its own (G =
    1, tau = 10: lists of one); C > U, so candidates repeat buckets (tau =
    5, C = 100); L = 0 (no launch: a zero table, a zero gradient) and C = 0
    (every row of dT +0, no table row read)."""
    rng = np.random.default_rng(31)
    B, L, C, d, m, tau = dict(distinct=(2, 40, 40, 32, 10, 10), L0=(2, 0, 8, 32, 10, 5),
                              C0=(2, 40, 0, 32, 40, 10)).get(case, (2, 120, 100, 32, 10, 5))
    R = rng.standard_normal((m, d)).astype(np.float32)
    mask = _mask(rng, B, L, "random")
    if case == "distinct":
        seq = np.stack([_distinct_rows(rng, L, R, tau) for _ in range(B)])
        q = seq[:, rng.permutation(L)[:C]].copy()
    else:
        seq = screened_normal(rng, (B, L, d), R)
        q = screened_normal(rng, (B, C, d), R)
    if case == "one-bucket":                     # positive multiples of one row
        seq = (seq[:, :1] * rng.uniform(0.5, 2.0, (B, L, 1))).astype(np.float32)
        q = (seq[:, :1] * rng.uniform(0.5, 2.0, (B, C, 1))).astype(np.float32)
    dout = rng.standard_normal((B, C, d)).astype(np.float32)
    table, dT, _ = _check_large_tau_training(seq, q, mask, R, tau, dout)
    G, U = m // tau, 1 << tau
    sel = _selected(q, R, tau)
    nonzero = np.abs(table).sum(-1) > 0
    if case == "one-bucket":
        assert (nonzero[:-1].sum(-1) == 1).all() and (sel.sum(-1) == 1).all()
    if case == "distinct":
        assert (nonzero[:-1].sum(-1) == (mask[:-1] != 0).sum(-1)[:, None]).all()
        assert (sel.sum(-1) == C).all()
    if case == "C>U":
        assert C > U and (sel.sum(-1) < C).all()
    if case in ("L0", "C0"):
        assert not table.any() if case == "L0" else not dT.any()


@pytest.mark.parametrize("case", ["fits", "all-masked"])
@pytest.mark.parametrize("tau, m, d", [(5, 45, 32), (5, 45, 128), (7, 42, 32), (7, 42, 128),
                                       (10, 40, 32), (10, 40, 128)])
def test_large_tau_backward_layouts(tau, m, d, case):
    """The large-tau backward's two layouts of dT at Table 4's tau 5, 7
    and 10 (m = 45, 42, 40) at d = 32 and 128, L = 300 (not a multiple of a
    round: 256 rows at d = 32, 64 at d = 128), split as for Table 4's 128
    users: the wrapper stages a user's dT where it fits a CTA beside R
    (tau 5 at both widths: 36 and 144 KB; tau 7 at d = 32: 96 KB) and
    gathers it from device memory elsewhere; both layouts against jax.grad,
    every element written once, a staged CTA reading its user's dT once and
    a gathering one the G rows of each valid row only; "all-masked": no row
    hashed or read, every gradient +0."""
    B, L, C = 2, 300, 1
    G, U = m // tau, 1 << tau
    rng = np.random.default_rng(40 + tau + d)
    R = rng.standard_normal((m, d)).astype(np.float32)
    seq = screened_normal(rng, (B, L, d), R)
    q = screened_normal(rng, (B, C, d), R)
    mask = _mask(rng, B, L, "random") if case == "fits" else np.zeros((B, L), np.float32)
    dout = rng.standard_normal((B, C, d)).astype(np.float32)
    _, jdT, _ = _jax_sdim_backward(dout, q, seq, mask, R, tau)
    jdT = jdT + rng.standard_normal(jdT.shape).astype(np.float32)   # every row of dT nonzero
    jdseq = _jax_encode_vjp(jdT, seq, mask, R, tau)
    fits = bwd_lt_ctas(G, U, L, d, tau)(True) > 0
    assert fits == ((tau, d) in ((5, 32), (5, 128), (7, 32)))
    sig = _signatures(seq.reshape(-1, d), R.reshape(G, tau, d), tau).reshape(B, L, G)
    for layout in (None, not fits):
        dseq, writes, hashes, reads, (staged, S) = encode_backward_large_tau_schedule(
            jdT, seq, mask, R, tau, B_card=128, staged=layout)
        assert staged == (fits if layout is None else layout) and S >= 1
        assert (writes == 1).all() and (hashes == (mask != 0)[..., None]).all()
        if staged:
            assert (reads == S).all()
        else:
            want = np.zeros((B, G, U), np.int64)
            for b in range(B):
                for g in range(G):
                    np.add.at(want[b, g], sig[b, mask[b] != 0, g], 1)
            assert (reads == want).all()
        np.testing.assert_allclose(dseq, jdseq, **FP32)
        assert not dseq[mask == 0].any() and not np.signbit(dseq[mask == 0]).any()


@pytest.mark.parametrize("B, L, G, U, d, tau, want", [
    (128, 256, 9, 32, 32, 5, (True, 1)),       # Table 4's tau 5: 36 KB of dT a user, 128 CTAs
    (128, 256, 4, 1024, 32, 10, (False, 1)),   # Table 4's tau 10: 512 KB a user, gathered
    (16, 1024, 9, 32, 128, 5, (True, 8)),      # the ingest at tau 5: 144 KB, one CTA an SM
    (16, 1024, 4, 1024, 128, 10, (False, 16)),  # the ingest at tau 10: a CTA a 64-row round
    (2, 1100, 2, 64, 16, 6, (True, 5)),        # a round of 256 rows a CTA
    (1, 32768, 4, 1024, 128, 10, (False, 512)),  # the longest history: 512 rounds, one wave
    (4096, 256, 9, 32, 32, 5, (True, 1)),      # a large batch: one CTA a user
    (2, 20, 9, 32, 32, 5, (True, 1)),          # L <= 32: eight lanes a row, one round
    (2, 256, 80, 1024, 128, 10, (False, 1)),   # R alone past a CTA: refused by the wrapper
])
def test_large_tau_backward_split_fills_one_wave(B, L, G, U, d, tau, want):
    """The large-tau backward's split (sdim_bucket.py
    encode_backward_large_tau_split) on the model card: dT staged where the
    user's whole dT fits a CTA beside R, and as many CTAs a user as fit one
    wave of the 132 SMs, at most one a round of rows."""
    ctas = bwd_lt_ctas(G, U, L, d, tau)
    staged, S = encode_backward_large_tau_split(B, L, d, 132, ctas)
    assert (staged, S) == want
    assert staged == (ctas(True) > 0)
    rounds = -(-L // (BWD_LT_ROUND // row_lanes(L, d)))
    per_sm = ctas(staged)
    assert 1 <= S <= rounds
    assert B * S <= 132 * per_sm or S == 1
    assert S == rounds or B * (S + 1) > 132 * per_sm
    if want == (False, 1) and G == 80:
        assert per_sm == 0


@pytest.mark.parametrize("kernel, B, G, U, n, d, tau, want", [
    # the forward (n = L): as few slices as give the 132 SMs a CTA each
    ("encode", 128, 9, 32, 256, 32, 5, (5, 2, 512)),       # Table 4's tau 5: 256 CTAs
    ("encode", 128, 4, 1024, 256, 32, 10, (2, 2, 512)),    # Table 4's tau 10: 256 CTAs
    ("encode", 16, 4, 1024, 1024, 128, 10, (1, 4, 1024)),  # the ingest at tau 10: 64 CTAs
    ("encode", 16, 9, 32, 1024, 128, 5, (1, 9, 512)),      # the ingest at tau 5: 144 CTAs
    ("encode", 4096, 12, 1024, 256, 128, 10, (4, 3, 256)),  # a large batch: 4 groups in 48 KB
    ("encode", 1, 4, 1024, 32768, 128, 10, (1, 4, 1024)),   # the longest history
    ("encode", 0, 9, 32, 256, 32, 5, (1, 9, 1024)),        # no user
    # the backward (n = C): as many slices as fit one wave of 256 threads
    ("query_backward", 128, 9, 32, 1, 32, 5, (3, 3, 256)),     # Table 4's tau 5: 384 CTAs
    ("query_backward", 128, 4, 1024, 1, 32, 10, (1, 4, 256)),  # Table 4's tau 10: 512 CTAs
    ("query_backward", 3, 2, 128, 2000, 36, 7, (1, 2, 256)),   # C = 2,000: 16 KB of lists a group
    ("query_backward", 1, 4, 1024, 16384, 128, 10, (1, 4, 256)),  # the most candidates
    ("query_backward", 4096, 12, 1024, 1, 128, 10, (4, 3, 256)),  # a large batch
])
def test_large_tau_list_splits_fill_one_wave(kernel, B, G, U, n, d, tau, want):
    """The large-tau training kernels' split (large_tau.cuh list_split): a
    CTA's groups within 48 KB of shared memory (one group at least), each
    slice as even as it goes, the CTAs within one wave of the 132 SMs
    (1,024 / threads * 4 CTAs of 64 registers a thread an SM) where the
    groups allow; the forward with as few slices (re-reads of a user's rows)
    as give every SM a CTA, the backward with as many as fill the wave."""
    split = (encode_large_tau_splits(B, G, U, n, d, tau, n_sm=132) if kernel == "encode" else
             query_backward_large_tau_splits(B, G, U, n, d, tau, n_sm=132))
    Gs, slices, threads = split
    assert split == want
    assert (slices - 1) * Gs < G <= slices * Gs and threads in (256, 512, 1024)
    per = 4 * tau * d + 2 * (2 * U + 2 * (-(-n // 8) * 8))
    gs_max = max(1, min(G, 48 * 1024 // per))
    assert Gs <= gs_max
    wave = 132 * 4 * 256 // threads
    assert max(B, 1) * slices <= wave or slices == -(-G // gs_max)
    if kernel == "encode":      # fewer slices would leave an SM without a CTA
        assert slices == -(-G // gs_max) or max(B, 1) * (slices - 1) < 132
    else:                       # more slices would overflow the wave
        assert slices == G or max(B, 1) * -(-G // max(Gs - 1, 1)) > 132 * 4 or Gs == 1


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


@pytest.mark.parametrize("B, G, U, C, d, tau, want", [
    (16, 9, 32, 128, 128, 5, (2, 5, 32, 1)),     # phase 20's tau 5: 80 CTAs (144 pass 132)
    (16, 4, 1024, 128, 128, 10, (1, 4, 64, 2)),  # tau 10: 128 ranks in two chunks of 64
    (16, 48, 2, 128, 128, 1, (6, 8, 2, 1)),      # tau = 1, m = 48: 128 CTAs of 6 groups
    (16, 4, 1024, 128, 36, 10, (1, 4, 128, 1)),  # d = 36: 227 slice rows a CTA, one chunk
    (1, 48, 2, 128, 128, 1, (1, 48, 2, 1)),      # one user: a group a CTA
    (4096, 48, 2, 128, 128, 1, (10, 5, 2, 1)),   # a large batch: 10 projections a row
    (4096, 12, 1024, 1, 128, 10, (1, 12, 1, 1)),  # one candidate, tau 10: a group a CTA
    (4096, 24, 4, 4, 36, 2, (5, 5, 4, 1)),       # tau 2: 5 groups of 10 projections
])
def test_serve_large_tau_splits_fill_one_wave(B, G, U, C, d, tau, want):
    """bse_serve's large-tau kernel 1: a CTA's sums fit its threads'
    registers (SERVE_CELLS each), it hashes at most 10 projections a row,
    and the grid, one CTA an SM, fits the 132 SMs in one wave where the
    groups and ranks allow."""
    Gs, slices, K, chunks = serve_large_tau_splits(B, G, U, C, d, tau, n_sm=132)
    assert (Gs, slices, K, chunks) == want
    assert Gs * K * (d // 4) <= 4 * 512 and Gs * tau <= 10
    assert (slices - 1) * Gs < G <= slices * Gs and K * chunks >= min(U, C)
    # one wave, or as few slices as the registers and projections allow
    gs_max = min(G, 10 // tau, max(1, 2048 // (d // 4) // K))
    assert B * slices * chunks <= 132 or slices == -(-G // gs_max)


@pytest.mark.parametrize("B, C, G, want", [
    (16, 128, 9, (7, 9)),        # phase 20's tau 5: all nine groups in one pass
    (16, 128, 4, (8, 4)),        # tau 10: 16 candidates a CTA would leave SMs idle
    (16, 128, 48, (4, 16)),      # tau = 1, m = 48: three passes keep one wave
    (1, 128, 48, (1, 48)),       # one user: one pass
    (16, 128, 2, (8, 4)),        # G < 4: four teams a candidate (one a float4 column)
])
def test_gather_shape_fits_one_wave(B, C, G, want):
    """The large-tau gather body's CTA: at most 64 teams, a thread for each
    (candidate, float4 column), all the burst's teams on the 132 SMs at
    once (2,048 threads an SM), and the CTAs at least one an SM."""
    cands, teams = gather_shape(B, C, G, n_sm=132)
    assert (cands, teams) == want
    assert cands * teams <= 64 and 8 * teams >= 32
    assert 8 * B * C * teams <= 132 * 2048 or teams == 4
    assert B * -(-C // cands) >= 132 or cands == 1


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", [
    (3, 40, 8, 32, 10, 5, {}, "random"),            # U = 32, one chunk of min(U, C) = 8 ranks
    (3, 90, 40, 16, 20, 10, dict(K=16), "random"),  # tau = 10: chunks of 16 ranks over 40
    (3, 50, 12, 36, 14, 7, dict(K=5), "random"),    # dien's width d = 36, ragged chunks of 5
    (2, 60, 20, 128, 48, 1, dict(n_sm=16), "random"),   # tau = 1 at G = 48: slices of Gs = 6
    (3, 1100, 6, 16, 12, 6, {}, "random"),          # 18 tiles of rows, the last one partial
    (3, 70, 16, 16, 45, 5, dict(n_sm=4), "random"),     # Gs = 5 over G = 9: a short last slice
    (3, 150, 8, 16, 20, 5, {}, "one-bucket"),       # every valid row in one selected bucket
    (3, 200, 8, 32, 10, 5, {}, "tile-split"),       # buckets whose rows span tiles
    (3, 40, 8, 128, 80, 1, {}, "random"),           # G = 80: gather teams take 64 groups a pass
], ids=["U32", "tau10-chunks", "d36-chunks", "tau1-G48", "two-passes", "Gs-ragged",
        "one-bucket", "tile-split", "G80-team-passes"])
def test_large_tau_serving_schedules_match_jax(shape, layout):
    """bse_serve and sdim_fused_serve at tau 5..10 (bse_serve also at tau
    = 1, G = 48) against the JAX package (its SDIM attention and its
    fused-serve oracle; the event fold into the same stores is
    ``test_large_tau_update_schedule_matches_jax`` in
    tests/test_torch_fold_schedules.py): half the candidates are users'
    own valid behaviors, so outputs are not all zero; every scratch row and
    rank is written once; a fully masked user and an absent one read zero. ``one-bucket``
    makes each user's behaviors positive multiples of one row, so every
    valid row lands in one bucket of each group (the longest l-order
    chain, across tiles); ``tile-split`` checks that buckets' rows span
    tile boundaries."""
    B, L, C, d, m, tau, split, case = shape
    G, U = m // tau, 1 << tau
    rng = np.random.default_rng(29 + tau)
    R = rng.standard_normal((m, d)).astype(np.float32)
    seq = screened_normal(rng, (B, L, d), R)
    if case == "one-bucket":
        seq = (seq[:, :1] * rng.uniform(0.5, 2.0, (B, L, 1))).astype(np.float32)
    q = screened_normal(rng, (B, C, d), R)
    mask = _mask(rng, B, L, layout)
    for b in range(B - 1):
        q[b, :C // 2] = seq[b, rng.choice(np.flatnonzero(mask[b]), C // 2)]
    out, writes, rank_writes, split_buckets = serve_large_tau_schedule(q, seq, mask, R, tau,
                                                                      **split)
    ref = np.asarray(jsdim_attention(jnp.asarray(q), jnp.asarray(seq), jnp.asarray(mask),
                                     jnp.asarray(R), tau))
    np.testing.assert_allclose(out, ref, **FP32)
    selected = [len(np.unique(_signatures(q[b], R.reshape(G, tau, d), tau)[:, g]))
                for b in range(B) for g in range(G)]
    assert writes.sum() == sum(selected) and writes.max() == 1
    assert (rank_writes == 1).all()
    assert not out[-1].any() and np.abs(out[:-1]).sum(-1).astype(bool).mean() >= 0.5
    if case != "random" and layout == "random":
        assert split_buckets > 0
    if tau == 1:
        return
    N = 2 * B + 1                                 # the fused read of encoded users
    store = rng.standard_normal((N, G, U, d)).astype(np.float32)
    slots = rng.permutation(np.arange(1, N))[:B].astype(np.int32)
    store[slots] = np.asarray(jbse_encode_ref(jnp.asarray(seq), jnp.asarray(mask),
                                              jnp.asarray(R), tau))
    present = np.ones(B, np.float32)
    present[0] = 0.0
    jstore, jscales = jquant.quantize_rows(jnp.asarray(store), dtype=jnp.int8)
    for st, sc in ((store, None), (np.asarray(jstore).astype(np.float32), np.asarray(jscales))):
        fused = fused_serve_large_tau_schedule(st, sc, slots, present, q, R, tau)
        fref = np.asarray(jsdim_fused_serve_ref(
            jstore if sc is not None else jnp.asarray(st), jnp.asarray(slots), jnp.asarray(q),
            jnp.asarray(R), tau, scales=None if sc is None else jscales,
            present=jnp.asarray(present)))
        np.testing.assert_allclose(fused, fref, **FP32)
        assert not fused[0].any() and not fused[-1].any()
        assert np.abs(fused[1:-1]).sum(-1).astype(bool).mean() >= 0.5
