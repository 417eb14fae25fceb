"""CPU rehearsal of two kernel paths of the folded shapes: numpy emulations
of how they divide and order their work, held against the JAX package on
seeded (margin-screened where a hash is involved) inputs. The CUDA kernels
cannot run here; this pins the algebra they implement.

- target attention's folded body (``target_attn.cu``, C = 1 and at most
  ``TA_FOLD_MAX_L`` rows: the retrieval kinds' folded users): a warp a
  user lists the rows to attend to (the valid ones, or every row for a
  fully masked user), takes them in chunks of 4 K rows (K = 16 / J rows a
  lane, J float4 columns a lane of eight), a row's logit by eight lanes
  (dot4 in column order, then the butterfly xor 4, 2, 1), the online
  softmax over each chunk (its max and weight sum over the four row
  groups by xor 8, 16), each row group's p x summed over its rows in
  order, the row groups' accumulators added by xor 8, 16, and acc / (den
  + 1e-30) written; ``forward_split`` (users a CTA, or 0: the cluster
  body) pinned on the model card;
- sdim_update's large-tau fold (``sdim_update_large_tau.cu``, tau 5..10):
  CTA (b, g) leaves unless b is its slot's first batch row; per window of
  256 batch rows it lists the owned rows in b order and takes them in
  sub-windows of max(1, 256 // E) rows; it hashes each sub-window's events
  for group g (-1 at weight 0), sorts them by bucket with warp 0's
  counting sort (ranks and counts 32 events a round, the cells in order
  of their first event, prefix-summed starts), and folds each cell from
  the stored cell: each owned row's events of the cell in e order with
  fmaf, the row's sum added to the running total in b order, the cell
  written once a sub-window. (The first design's emulation and its cases
  lived in the schedules file now split by kernel; the shared emulations
  are in ``tests/torch_schedules.py``.)

Tolerance: atol 1e-5 / rtol 1e-5 in fp32 (the same sums in another order),
as the reference's own tests (tests/test_kernels.py:46-58); cells no
weighted event reached are compared bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.sdim_bucket.ref import bse_encode_ref as jbse_encode_ref
from repro.kernels.sdim_update.ref import sdim_update_ref as jsdim_update_ref
from repro.kernels.sdim_update.sdim_update import sdim_update as jsdim_update
from repro.kernels.target_attn.ref import target_attention_ref as jtarget_attention_ref
from repro_torch.kernels.screen import screened_normal
from repro_torch.kernels.target_attn.target_attn import (TA_FOLD_MAX_L, TA_FOLD_MAX_USERS,
                                                         forward_split)
from torch_schedules import FP32, LAYOUTS, MASKED, _mask, _signatures


def _fmaf(a, x, acc):
    """fmaf(a, x, acc) in fp32, element by element (the product is exact in
    fp64, so one rounding of the sum stands in for the fused one)."""
    return (np.float64(a) * x.astype(np.float64) + acc.astype(np.float64)).astype(np.float32)


def _group_dot(q, x):
    """Eight lanes a row: lane p sums the float4 columns p, p + 8, ... of q .
    x_r in column order (dot4, one fmaf a value), then the butterfly xor 4,
    2, 1 adds the eight partials. q (d,), x (n, d) -> (n,)."""
    n, d = x.shape
    lanes = np.zeros((8, n), np.float32)
    for k in range(d):
        p = (k // 4) % 8
        lanes[p] = _fmaf(q[k], x[:, k], lanes[p])
    for o in (4, 2, 1):
        lanes = (lanes + lanes[np.arange(8) ^ o]).astype(np.float32)
    return lanes[0]


def _row_groups(v):
    """The four row groups' values (4, ...) added as the shuffles xor 8, then
    xor 16 add them: (v0 + v1) + (v2 + v3)."""
    return ((v[0] + v[1]).astype(np.float32) + (v[2] + v[3]).astype(np.float32)).astype(
        np.float32)


def target_attention_folded_schedule(q, seq, mask):
    """target_attn.cu's folded body in numpy fp32 (module docstring)."""
    B, C, d = q.shape
    assert C == 1
    L = seq.shape[1]
    nq = d // 4
    J = next(j for j in (1, 2, 4, 8) if 8 * j >= nq)
    K = 16 // J
    scale = np.float32(1.0) / np.sqrt(np.float32(d))
    out = np.zeros((B, 1, d), np.float32)
    for b in range(B):
        valid = mask[b] > 0
        none = not valid.any()
        rows = np.arange(L) if none else np.flatnonzero(valid)
        m, den = MASKED, np.float32(0)
        acc = np.zeros((4, d), np.float32)
        for c0 in range(0, len(rows), 4 * K):
            x = seq[b, rows[c0:c0 + 4 * K]].astype(np.float32)
            s = _group_dot(q[b, 0], x)
            a = np.full(len(x), MASKED, np.float32) if none else (s * scale).astype(np.float32)
            mx = np.float32(max(m, a.max()))
            alpha = np.exp(np.float32(m - mx)).astype(np.float32)
            p = np.exp(a - mx).astype(np.float32)
            sums = np.zeros(4, np.float32)
            for i in range(len(x)):                # a row group's rows in order
                sums[i % 4] = np.float32(sums[i % 4] + p[i])
            den = np.float32(den * alpha + _row_groups(sums))
            acc = (acc * alpha).astype(np.float32)
            for i in range(len(x)):
                acc[i % 4] = _fmaf(p[i], x[i], acc[i % 4])
            m = mx
        out[b, 0] = (_row_groups(acc) / np.float32(den + np.float32(1e-30))).astype(np.float32)
    return out


def _folded_mask(rng, B, L, layout):
    """(B, L) fp32 mask of folded users: valid rows first (``prefix``, the
    retrieval kinds' top-k order) or anywhere (``random``); user 0 has
    none, user 1 every row, user 2 one."""
    if layout == "prefix":
        found = rng.integers(0, L + 1, B)
        mask = (np.arange(L)[None] < found[:, None]).astype(np.float32)
    else:
        mask = (rng.random((B, L)) > 0.4).astype(np.float32)
    mask[0] = 0.0
    mask[1] = 1.0
    if B > 2 and L:
        mask[2] = 0.0
        mask[2, rng.integers(0, L)] = 1.0
    return mask


@pytest.mark.parametrize("layout", ["prefix", "random"])
@pytest.mark.parametrize("L", [0, 1, 13, 32, 33, TA_FOLD_MAX_L])
@pytest.mark.parametrize("d", [4, 36, 128, 256])
def test_target_attention_folded_schedule_matches_jax(d, L, layout):
    """Every chunking the folded body takes (J = 1, 2, 4, 8: 64, 32, 16, 8
    rows a chunk), L = 0 and 1, L not a multiple of 8, L past one ballot
    (33) and the body's most (64): within FP32 of the JAX package; a fully
    masked user attends uniformly over all L rows (zeros at L = 0)."""
    B = 5
    rng = np.random.default_rng(100 * d + L)
    q = rng.standard_normal((B, 1, d)).astype(np.float32)
    seq = rng.standard_normal((B, L, d)).astype(np.float32)
    mask = _folded_mask(rng, B, L, layout)
    out = target_attention_folded_schedule(q, seq, mask)
    ref = np.asarray(jtarget_attention_ref(jnp.asarray(q), jnp.asarray(seq), jnp.asarray(mask)))
    np.testing.assert_allclose(out, ref, **FP32)
    np.testing.assert_allclose(out[0, 0], seq[0].mean(0) if L else np.zeros(d), **FP32)


def test_target_attention_folded_schedule_at_the_retrieval_shape():
    """The retrieval kinds' folded shape, cut to 64 users: one candidate over
    k = 32 rows at d = 128 (two chunks of 16 rows), valid rows first."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((64, 1, 128)).astype(np.float32)
    seq = rng.standard_normal((64, 32, 128)).astype(np.float32)
    mask = _folded_mask(rng, 64, 32, "prefix")
    out = target_attention_folded_schedule(q, seq, mask)
    ref = np.asarray(jtarget_attention_ref(jnp.asarray(q), jnp.asarray(seq), jnp.asarray(mask)))
    np.testing.assert_allclose(out, ref, **FP32)


@pytest.mark.parametrize("B, L, C, want", [
    (2048, 32, 1, 8),      # folded retrieval: 256 CTAs of eight users (a warp each)
    (2048, 16, 1, 8),
    (1056, 32, 1, 8),      # 132 CTAs of eight: one for each SM
    (1000, 32, 1, 4),      # eight would leave SMs idle
    (300, 64, 1, 2),       # the body's most rows
    (200, 32, 1, 1),       # few users: one a CTA
    (128, 16, 1, 1),       # the protocol's folded kinds
    (1, 1, 1, 1),
    (2048, 65, 1, 0),      # past 64 rows: the cluster body
    (128, 256, 1, 0),      # the protocol's target kind
    (16, 1024, 128, 0),    # the main path's burst
    (2048, 32, 2, 0),      # more than one candidate
    (0, 32, 1, 0),
])
def test_target_attention_forward_split(B, L, C, want):
    """Users a CTA of the forward's folded body on the model card (132 SMs),
    0 where the cluster body runs."""
    upc = forward_split(B, L, C, 132)
    assert upc == want
    if upc:
        assert C == 1 and L <= TA_FOLD_MAX_L and upc <= TA_FOLD_MAX_USERS
        assert -(-B // upc) >= 132 or upc == 1                     # a CTA for each SM
        assert upc == TA_FOLD_MAX_USERS or -(-B // (2 * upc)) < 132  # the most users that do


LT_UPDATE_ROWS = 256         # sdim_update_large_tau.cu kUpdateRows (a window of batch rows)
LT_UPDATE_EVENTS = 256       # kUpdateEvents: events a sub-window holds at E <= 256


def _counting_sort(keys):
    """Warp 0's sort of a sub-window's buckets (-1: none): 32 events a
    round, each event's rank among its bucket's is the bucket's count before
    the round plus its lanes below of that bucket; a bucket whose count was 0
    becomes a cell at its first event; the cells' counts prefix-summed into
    starts; each event written to start + rank. Returns (cells, starts,
    counts, sorted events)."""
    cnt, cells = {}, []
    rank = np.zeros(len(keys), np.int64)
    for r0 in range(0, len(keys), 32):
        rnd = list(keys[r0:r0 + 32])
        had = {k: cnt.get(k, 0) for k in set(rnd) if k >= 0}   # read before the round writes
        for i, k in enumerate(rnd):
            if k < 0:
                continue
            below = rnd[:i].count(k)
            rank[r0 + i] = had[k] + below
            if had[k] == 0 and below == 0:
                cells.append(k)
        for k in had:
            cnt[k] = had[k] + rnd.count(k)
    counts = [cnt[k] for k in cells]
    starts = np.cumsum([0] + counts)[:len(counts)].astype(np.int64)
    start_of = dict(zip(cells, starts))
    order = np.full(sum(counts), -1, np.int64)
    for i, k in enumerate(keys):
        if k >= 0:
            order[start_of[k] + rank[i]] = i
    assert (order >= 0).all()
    return cells, starts, counts, order


def _one_round_sort(keys):
    """Warp 0's sort of a sub-window of at most 32 events, the kernel's
    register branch: lane k holds event k's bucket (-1 past the events);
    its peers are the lanes of its bucket, the lowest of them (a first) holds
    the bucket's count, an inclusive scan of those counts over the lanes
    gives each first its start, every lane its peers' start plus its peers
    below, and a first's cell is its rank among the firsts. The same result
    as ``_counting_sort``."""
    assert len(keys) <= 32
    key = [int(k) for k in keys] + [-1] * (32 - len(keys))
    peers = [[j for j in range(32) if key[j] == key[i]] for i in range(32)]
    first = [key[i] >= 0 and peers[i][0] == i for i in range(32)]
    cnt = [len(peers[i]) if first[i] else 0 for i in range(32)]
    incl = np.cumsum(cnt)
    order = np.full(sum(cnt), -1, np.int64)
    cells, starts, counts = [], [], []
    for i in range(32):
        start = int(incl[peers[i][0]] - cnt[peers[i][0]])
        if key[i] >= 0:
            order[start + peers[i].index(i)] = i
        if first[i]:
            cells.append(key[i])
            starts.append(start)
            counts.append(cnt[i])
    assert (order >= 0).all()
    return cells, np.asarray(starts, np.int64), counts, order


def update_large_tau_schedule(store, slots, events, mask, R, tau):
    """sdim_update_large_tau.cu in numpy fp32 (module docstring). Returns
    the store and the write counts of each (row, group, bucket) cell."""
    N, G, U, d = store.shape
    B, E, _ = events.shape
    Rg = R.reshape(G, tau, d)
    out = store.copy()
    writes = np.zeros((N, G, U), np.int64)
    W = max(1, LT_UPDATE_EVENTS // E)
    for b in range(B):
        slot = slots[b]
        if (slots[:b] == slot).any():
            continue
        for g in range(G):
            for p in range(b, B, LT_UPDATE_ROWS):
                owned = [i for i in range(p, min(B, p + LT_UPDATE_ROWS)) if slots[i] == slot]
                for s0 in range(0, len(owned), W):
                    rows = owned[s0:s0 + W]
                    x = events[rows].astype(np.float32).reshape(-1, d)      # k = s * E + e
                    w = mask[rows].reshape(-1)
                    keys = np.where(w != 0, _signatures(x, Rg[g:g + 1], tau)[:, 0], -1)
                    sort = _one_round_sort if len(keys) <= 32 else _counting_sort
                    cells, starts, counts, order = sort(keys)
                    for u, start, cnt in zip(cells, starts, counts):
                        lst = order[start:start + cnt]
                        assert (np.diff(lst) > 0).all()                    # (b, e) order
                        acc = out[slot, g, u].copy()
                        delta = np.zeros(d, np.float32)
                        cur = lst[0] // E
                        for k in lst:
                            if k // E != cur:                              # the row's sum
                                acc = (acc + delta).astype(np.float32)
                                delta = np.zeros(d, np.float32)
                                cur = k // E
                            delta = _fmaf(w[k], x[k], delta)
                        out[slot, g, u] = (acc + delta).astype(np.float32)
                        writes[slot, g, u] += 1
    return out, writes


@pytest.mark.parametrize("n, buckets", [(1, 4), (16, 32), (17, 3), (32, 1), (32, 32),
                                        (32, 1024), (5, 0)])
def test_large_tau_update_sorts_agree(n, buckets):
    """The register branch's one-round sort (n <= 32) gives the lists of
    the general rounds: the same cells in order of their first event, the
    same starts and counts, each cell's events in (b, e) order; buckets 0:
    every event unweighted (-1)."""
    rng = np.random.default_rng(n * 7 + buckets)
    keys = rng.integers(0, buckets, n) if buckets else np.full(n, -1)
    keys = np.where(rng.random(n) < 0.2, -1, keys)
    one, general = _one_round_sort(keys), _counting_sort(keys)
    assert one[0] == general[0] and one[2] == general[2]
    np.testing.assert_array_equal(one[1], general[1])
    np.testing.assert_array_equal(one[3], general[3])


def _check_fold(store, slots, events, mask, R, tau, pallas=False):
    """The emulation against the JAX oracle (and the Pallas kernel in
    interpret mode where ``pallas``) at FP32; unreached cells keep their
    bits; returns the write counts."""
    folded, writes = update_large_tau_schedule(store, slots, events, mask, R, tau)
    args = (jnp.asarray(store), jnp.asarray(slots), jnp.asarray(events), jnp.asarray(mask),
            jnp.asarray(R), tau)
    np.testing.assert_allclose(folded, np.asarray(jsdim_update_ref(*args)), **FP32)
    if pallas:
        np.testing.assert_allclose(folded, np.asarray(jsdim_update(*args, interpret=True)),
                                   **FP32)
    untouched = np.repeat((writes == 0)[..., None], store.shape[-1], -1)
    np.testing.assert_array_equal(folded.view(np.uint32)[untouched],
                                  store.view(np.uint32)[untouched])
    return writes


# (B, L, d, m, tau) of the large-tau serving cases whose stores the fold
# updates: U = 32, tau 10, dien's d = 36, two tiles of rows, a short last
# group slice, one bucket, buckets across tiles
SERVING_FOLDS = {"U32": (3, 40, 32, 10, 5, "random"), "tau10-chunks": (3, 90, 16, 20, 10, "random"),
                 "d36-chunks": (3, 50, 36, 14, 7, "random"),
                 "two-passes": (3, 1100, 16, 12, 6, "random"),
                 "Gs-ragged": (3, 70, 16, 45, 5, "random"),
                 "one-bucket": (3, 150, 16, 20, 5, "one-bucket"),
                 "tile-split": (3, 200, 32, 10, 5, "tile-split")}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", list(SERVING_FOLDS))
def test_large_tau_update_schedule_matches_jax(case, layout):
    """The fold of E = 5 events into stores of encoded users (random rows
    elsewhere), every slot twice, a zero-mask row: against the JAX oracle
    and the Pallas kernel in interpret mode; each reached cell written once,
    the others keep their bits."""
    B, L, d, m, tau, kind = SERVING_FOLDS[case]
    G, U = m // tau, 1 << tau
    rng = np.random.default_rng(29 + tau)
    R = rng.standard_normal((m, d)).astype(np.float32)
    seq = screened_normal(rng, (B, L, d), R)
    if kind == "one-bucket":
        seq = (seq[:, :1] * rng.uniform(0.5, 2.0, (B, L, 1))).astype(np.float32)
    mask = _mask(rng, B, L, layout)
    N = 2 * B + 1
    store = rng.standard_normal((N, G, U, d)).astype(np.float32)
    slots = rng.permutation(np.arange(1, N))[:B].astype(np.int32)
    store[slots] = np.asarray(jbse_encode_ref(jnp.asarray(seq), jnp.asarray(mask),
                                              jnp.asarray(R), tau))
    E = 5
    events = screened_normal(rng, (2 * B, E, d), R)
    ev_mask = (rng.random((2 * B, E)) > 0.25).astype(np.float32)
    ev_slots = np.r_[slots, slots[::-1]].astype(np.int32)   # every slot twice
    ev_mask[0] = 0.0                              # a zero-mask row
    writes = _check_fold(store, ev_slots, events, ev_mask, R, tau, pallas=True)
    assert writes.max() == 1


# (B, E, d, m, tau, slots): duplicates on random slots, E = 1, 5, 16, 40 and
# 300 (a sub-window of one row, hashed and sorted in ten rounds), and
# windows of many rows (E = 1: sub-windows of 256 rows; E = 16: of 16)
FOLD_EDGES = {"dups-E1": (24, 1, 16, 10, 5, 6), "dups-E5": (24, 5, 36, 14, 7, 6),
              "dups-E16": (16, 16, 36, 40, 10, 5), "dups-E40": (8, 40, 16, 45, 5, 3),
              "E300": (3, 300, 16, 20, 10, 2), "many-rows-E1": (600, 1, 16, 10, 5, 2),
              "many-rows-E16": (300, 16, 4, 14, 7, 3)}


@pytest.mark.parametrize("case", list(FOLD_EDGES))
def test_large_tau_update_schedule_at_the_edges(case):
    """Duplicate slots, zero-mask rows (row 0 and every fourth row's), -0.0
    cells, E from 1 to 300 and windows of many rows: within FP32 of the JAX
    oracle, unreached cells (-0.0 included) bit for bit, a reached cell
    written once a sub-window that reaches it."""
    B, E, d, m, tau, n_slots = FOLD_EDGES[case]
    G, U = m // tau, 1 << tau
    rng = np.random.default_rng(B * E + tau)
    R = rng.standard_normal((m, d)).astype(np.float32)
    store = rng.standard_normal((n_slots + 1, G, U, d)).astype(np.float32)
    store[:, :, ::3, :4] = -0.0
    slots = rng.integers(0, n_slots, B).astype(np.int32)
    events = screened_normal(rng, (B, E, d), R)
    mask = (rng.random((B, E)) > 0.25).astype(np.float32)
    mask[::4] = 0.0
    writes = _check_fold(store, slots, events, mask, R, tau)
    W = max(1, LT_UPDATE_EVENTS // E)
    sub_windows = {s: sum(-(-int((slots[p:p + LT_UPDATE_ROWS] == s).sum()) // W)
                          for p in range(int(np.flatnonzero(slots == s)[0]), B, LT_UPDATE_ROWS))
                   for s in np.unique(slots)}
    for s, n in sub_windows.items():
        assert writes[s].max() <= n
    assert writes.sum() > 0 and not writes[n_slots].any()
