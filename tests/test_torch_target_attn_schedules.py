"""CPU rehearsal of target_attention_flash and its backward' schedules (target
attention's cluster body and target_attn_backward): numpy emulations of how
the kernels split and merge their work, held against the JAX package on
seeded, margin-screened inputs (the emulations and the whole list:
tests/torch_schedules.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.target_attn.ref import target_attention_ref as jtarget_attention_ref
from repro_torch.kernels.target_attn.target_attn import (TA_BWD_MAX_ROWS, TA_BWD_ROWS,
                                                         backward_split as ta_backward_split)
from torch_schedules import (FP32, LAYOUTS, _jax_target_backward, _mask, card_clusters,
                             target_attention_backward_schedule,
                             target_attention_backward_two_launch_schedule,
                             target_attention_schedule)


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
