"""CPU rehearsal of bse_encode and the tau <= 4 backward kernels' schedules
(bse_encode's group slices and warps, bse_encode_backward's and
sdim_query_backward's splits): numpy emulations of how the kernels split
and merge their work, held against the JAX package on seeded, margin-
screened inputs (the emulations and the whole list:
tests/torch_schedules.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.sdim_bucket.ref import bse_encode_ref as jbse_encode_ref
from repro_torch.kernels.screen import screened_normal
from repro_torch.kernels.sdim_bucket.sdim_bucket import MAX_CELLS, backward_splits, encode_splits
from repro_torch.kernels.sdim_query.sdim_query import query_backward_splits
from torch_schedules import (FP32, LAYOUTS, _jax_sdim_backward, _mask, _selected,
                             bse_encode_backward_schedule, bse_encode_schedule, card_clusters,
                             sdim_query_backward_schedule)


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
