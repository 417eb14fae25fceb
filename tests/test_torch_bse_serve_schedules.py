"""CPU rehearsal of bse_serve' schedules (bse_serve's cluster body and both
kernels of its large-tau path, with sdim_fused_serve's large-tau gather
body): numpy emulations of how the kernels split and merge their work, held
against the JAX package on seeded, margin-screened inputs (the emulations
and the whole list: tests/torch_schedules.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.sdim import sdim_attention as jsdim_attention
from repro.kernels.sdim_bucket.ref import bse_encode_ref as jbse_encode_ref
from repro.kernels.sdim_fused_serve.ref import sdim_fused_serve_ref as jsdim_fused_serve_ref
from repro.serve import quant as jquant
from repro_torch.kernels.screen import screened_normal
from repro_torch.kernels.sdim_serve.sdim_serve import gather_shape, serve_large_tau_splits
from torch_schedules import (FP32, LAYOUTS, _mask, _signatures, bse_serve_schedule,
                             fused_serve_large_tau_schedule, serve_large_tau_schedule)


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
