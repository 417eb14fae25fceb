"""CPU rehearsal of the large-tau training kernels' schedules (bse_encode's
large-tau forward and backward and sdim_query's large-tau forward and
backward): numpy emulations of how the kernels split and merge their work,
held against the JAX package on seeded, margin-screened inputs (the
emulations and the whole list: tests/torch_schedules.py).
"""
import numpy as np
import pytest

from repro_torch.kernels.screen import screened_normal
from repro_torch.kernels.sdim_bucket.sdim_bucket import (BWD_LT_DEVICE_Q, BWD_LT_ROUND,
                                                         LT_BWD_DEVICE,
                                                         encode_backward_large_tau_split,
                                                         encode_large_tau_splits, row_lanes)
from repro_torch.kernels.sdim_query.sdim_query import query_backward_large_tau_splits
from torch_schedules import (FP32, LAYOUTS, _check_large_tau_training, _distinct_rows,
                             _jax_encode_vjp, _jax_sdim_backward, _mask, _selected, _signatures,
                             bwd_lt_ctas, encode_backward_large_tau_schedule)


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
    (2, 256, 80, 1024, 128, 10, (LT_BWD_DEVICE, 4)),   # R alone past a CTA: R from memory
])
def test_large_tau_backward_split_fills_one_wave(B, L, G, U, d, tau, want):
    """The large-tau backward's split (sdim_bucket.py
    encode_backward_large_tau_split) on the model card: dT staged where the
    user's whole dT fits a CTA beside R, R alone where that fits, else
    neither (LT_BWD_DEVICE, four lanes a row), and as many CTAs a user as
    fit one wave of the 132 SMs, at most one a round of rows."""
    ctas = bwd_lt_ctas(G, U, L, d, tau)
    staged, S = encode_backward_large_tau_split(B, L, d, 132, ctas)
    assert (staged, S) == want
    assert (staged is True) == (ctas(True) > 0)
    lanes = BWD_LT_DEVICE_Q if staged is LT_BWD_DEVICE else row_lanes(L, d)
    rounds = -(-L // (BWD_LT_ROUND // lanes))
    per_sm = ctas(staged)
    assert 1 <= S <= rounds
    assert B * S <= 132 * per_sm or S == 1
    assert S == rounds or B * (S + 1) > 132 * per_sm
    if G == 80:
        assert ctas(False) == 0 and per_sm > 0


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
