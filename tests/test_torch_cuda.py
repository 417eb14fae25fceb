"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Imports torch and ``repro_torch`` only (no JAX), so it runs on a GPU
host that has no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test skips inside itself where there is no CUDA. Inputs are margin-
screened (``repro_torch.kernels.screen``), so kernel and plain version agree
on every hash bit. Tolerances: fp32 atol 1e-5 / rtol 1e-5 (sums in another
order); atol 1e-4 for bse_encode (sums of up to L rows in row order,
against the plain version's order); bf16 / int8 / fp8 operands are read
identically by both, so fp32 tolerances hold there too. No kernel adds
with atomics: every one gives the same bits on two launches.

The backward kernels (bse_encode_backward, sdim_query_backward,
target_attention_flash_backward) are held against their closed-form
plain versions at FP32 (sums in another order), and at one bf16 step
(rtol 8e-3) where the gradient is written in bf16: the two round fp32
sums that differ in the last bits. The serving kernels refuse to run
under autograd, and a CTR model's loss on the card reaches the item
embeddings through the long branch with the CPU's gradients.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import sdim_paper
from repro_torch.core import simhash
from repro_torch.core.target_attention import default_scale
from repro_torch.kernels.screen import (hashed_behaviors, item_rows_clear, screen_item_rows,
                                        screened_normal)
from repro_torch.kernels.sdim_bucket.sdim_bucket import (
    MAX_CELLS, MAX_L, bse_encode, bse_encode_backward, bse_encode_backward_cuda,
    bse_encode_backward_ref, bse_encode_cuda, bse_encode_ref)
from repro_torch.kernels.sdim_fused_serve.sdim_fused_serve import (
    sdim_fused_serve, sdim_fused_serve_ref)
from repro_torch.kernels.sdim_query.sdim_query import (
    sdim_query, sdim_query_backward, sdim_query_backward_cuda, sdim_query_backward_ref,
    sdim_query_ref)
from repro_torch.kernels.sdim_serve.sdim_serve import bse_serve, bse_serve_ref
from repro_torch.kernels.sdim_update.sdim_update import (
    UPDATE_LT_MAX_E, sdim_update, sdim_update_cuda, sdim_update_ref, update_cells)
from repro_torch.kernels.target_attn.target_attn import (
    target_attention_flash, target_attention_flash_backward,
    target_attention_flash_backward_ref, target_attention_flash_ref)
from repro_torch.kernels.target_attn.target_attn import forward_split as ta_forward_split
from repro_torch.kernels.target_attn.target_attn import launch_split as ta_launch_split
from repro_torch.models.ctr import CTRModel
from repro_torch.serve.quant import TABLE_DTYPES, quantize_rows

SHAPES = [  # (B, L, C, d, m, tau)
    (1, 40, 8, 32, 12, 2),
    (3, 300, 70, 64, 24, 4),
    (4, 1024, 128, 128, 48, 3),
    (32, 16, 128, 128, 48, 3),   # an event fold's encode: L in one block per user
]
# the cluster and group-split kernels (bse_serve, target_attention_flash,
# sdim_fused_serve, sdim_query, bse_encode) also at G = 12 over 8 ranks
# (uneven group or row ranges), L = 1000 and C = 100
CLUSTER_SHAPES = SHAPES + [(3, 1000, 100, 128, 36, 3)]
# where each user's valid rows lie: random, front-padded (the leading L
# chunks wholly masked), or only the last 5 rows (the last chunk)
LAYOUTS = ["random", "front", "last"]
FP32 = dict(atol=1e-5, rtol=1e-5)
ATOMIC = dict(atol=1e-4, rtol=1e-5)
BF16_OUT = dict(atol=1e-5, rtol=8e-3)     # one bf16 step of a gradient written in bf16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dev, dtype=torch.float32, seed=0):
    B, L, C, d, m, tau = shape
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((m, d)).astype(np.float32)
    seq = screened_normal(rng, (B, L, d), R, dtype)
    q = screened_normal(rng, (B, C, d), R)
    mask = (rng.random((B, L)) > 0.25).astype(np.float32)
    t = lambda x: torch.from_numpy(x).to(dev)
    return t(seq).to(dtype), t(q), t(mask), t(R), rng


def _layout(mask, layout, rng):
    """Re-draw the valid rows of ``mask`` (B, L) as ``layout`` says; a user
    with B > 1 keeps a fully masked last row set either way."""
    B, L = mask.shape
    if layout == "front":
        lengths = torch.from_numpy(rng.integers(1, max(L // 3, 1) + 1, B))
        mask = (torch.arange(L)[None] >= L - lengths[:, None]).float().to(mask.device)
    elif layout == "last":
        mask = torch.zeros_like(mask)
        mask[:, -5:] = 1.0
    if B > 1:
        mask[-1] = 0
    return mask


LARGE_TAU_SHAPES = [  # (B, L, C, d, m, tau): the large-tau paths (large_tau.cuh)
    (2, 40, 3, 32, 10, 5),
    (128, 256, 1, 32, 45, 5),    # Table 4's tau = 5 training shape
    (128, 256, 1, 32, 40, 10),   # Table 4's tau = 10: U = 1,024, two slices a group
    (2, 1100, 70, 16, 12, 6),    # two passes of rows; three CTAs of candidates
    (3, 60, 40, 128, 20, 10),    # d = 128: eight slices a group
    (2, 50, 2, 36, 14, 7),       # dien's width d = 36
    (16, 1024, 128, 128, 40, 10),  # the decoupled deployment's history ingest at tau = 10
    (3, 300, 2000, 36, 14, 7),   # C = 2,000 over U = 128: candidates share buckets
]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", LARGE_TAU_SHAPES)
def test_large_tau_kernels(shape, dtype, layout, dev):
    """tau 5..10: bse_encode (fp32|bf16 behaviors), sdim_query (off the
    fp32 table and its bf16 wire copy) and both backward kernels against
    their plain versions; two launches give the same bits; a fully masked
    user gets a zero table and gradient; the rows of dT that no candidate
    selects are +0 and equal the plain version's (which holds -0 there
    where a product with a negative dout was not summed with +0)."""
    B, L, C, d, m, tau = shape
    seq, q, mask, R, rng = _inputs(shape, dev, dtype, seed=tau)
    mask = _layout(mask, layout, rng)
    before = (bse_encode.launches, sdim_query.launches, bse_encode_backward.launches,
              sdim_query_backward.launches)
    table = bse_encode(seq, mask, R, tau)
    torch.testing.assert_close(table, bse_encode_ref(seq, mask, R, tau), **ATOMIC)
    assert torch.equal(table, bse_encode(seq, mask, R, tau))
    for wire in (table, table.to(torch.bfloat16)):
        out = sdim_query(q, wire, R, tau)
        torch.testing.assert_close(out, sdim_query_ref(q, wire, R, tau), **FP32)
        assert torch.equal(out, sdim_query(q, wire, R, tau))
    dout = torch.from_numpy(rng.standard_normal((B, C, d)).astype(np.float32)).to(dev)
    dT = sdim_query_backward(dout, q, table, R, tau)
    dT_ref = sdim_query_backward_ref(dout, q, table, R, tau)
    torch.testing.assert_close(dT, dT_ref, **FP32)
    assert torch.equal(dT, sdim_query_backward(dout, q, table, R, tau))
    hits = torch.nn.functional.one_hot(simhash.signatures(q, R, tau).long(), 1 << tau)
    unselected = hits.sum(1) == 0                          # (B, G, U)
    assert torch.equal(dT[unselected], dT_ref[unselected])  # the plain version's -0 is 0
    assert not dT[unselected].view(torch.int32).any()      # +0: no sign bit
    dseq = bse_encode_backward(dT, seq, mask, R, tau)
    tol = BF16_OUT if dtype == torch.bfloat16 else FP32
    torch.testing.assert_close(dseq, bse_encode_backward_ref(dT, seq, mask, R, tau), **tol)
    assert torch.equal(dseq, bse_encode_backward(dT, seq, mask, R, tau))
    torch.cuda.synchronize()
    assert (bse_encode.launches, sdim_query.launches, bse_encode_backward.launches,
            sdim_query_backward.launches) == (before[0] + 2, before[1] + 4, before[2] + 2,
                                              before[3] + 2)
    if B > 1:                                   # _layout masks the last user
        assert not table[-1].any() and not dseq[-1].any()


# the large-tau backward's two layouts of dT, (B, L, d, m, tau): staged in
# a CTA's shared memory where the user's dT fits beside R, else gathered
# from device memory (csrc/bse_encode_backward_large_tau.cu)
LT_BWD_CASES = [
    ((128, 256, 32, 45, 5), True), ((128, 256, 32, 45, 5), False),    # Table 4's tau 5
    ((128, 256, 32, 40, 10), False),                                   # Table 4's tau 10
    ((4, 300, 32, 42, 7), True), ((4, 300, 32, 42, 7), False),        # 96 KB; two rounds
    ((3, 1100, 128, 45, 5), True), ((3, 1100, 128, 45, 5), False),    # 144 KB; d = 128
    ((2, 50, 36, 14, 7), True), ((2, 50, 36, 14, 7), False),          # dien's width
    ((3, 20, 64, 40, 10), False),                                      # L <= 32: eight lanes a row
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, staged", LT_BWD_CASES)
def test_large_tau_backward_at_both_layouts(shape, staged, dtype, dev):
    """bse_encode_backward at tau 5..10 with the user's dT staged and
    gathered, fp32 and bf16 rows, against its plain version on a dT whose
    every row is nonzero: ragged masks with a fully masked last user (+0
    everywhere, no sign bit), the same bits twice, every split of rows the
    wrapper could take (1, 2 and its own CTAs a user); L = 0 launches
    nothing."""
    from repro_torch.kernels.sdim_bucket.sdim_bucket import launch_large_tau_split

    B, L, d, m, tau = shape
    G, U = m // tau, 1 << tau
    seq, _, mask, R, rng = _inputs((B, L, 1, d, m, tau), dev, dtype, seed=50 + tau)
    mask = _layout(mask, "random", rng)
    dT = torch.from_numpy(rng.standard_normal((B, G, U, d)).astype(np.float32)).to(dev)
    fits, S = launch_large_tau_split(B, L, G, d, tau, dtype, dev)
    assert fits == staged or not staged
    ref = bse_encode_backward_ref(dT, seq, mask, R, tau)
    tol = BF16_OUT if dtype == torch.bfloat16 else FP32
    before = bse_encode_backward.launches
    for splits in sorted({1, 2, S}):
        out = bse_encode_backward_cuda(dT, seq, mask, R, tau, splits, staged)
        torch.testing.assert_close(out.float(), ref.float(), **tol)
        assert out.dtype == dtype
        assert torch.equal(out, bse_encode_backward_cuda(dT, seq, mask, R, tau, splits, staged))
        assert not out[-1].any() and not out[mask == 0].float().view(torch.int32).any()
    torch.cuda.synchronize()
    assert bse_encode_backward.launches == before + 2 * len({1, 2, S})
    empty = bse_encode_backward_cuda(dT, seq[:, :0].contiguous(), mask[:, :0].contiguous(), R,
                                     tau, 1, staged)
    assert empty.shape == (B, 0, d) and bse_encode_backward.launches == before + 2 * len({1, 2, S})


# bse_serve's large-tau path also takes tau <= 4 where its cluster body
# cannot hold the groups: Table 4's tau = 1 row (m = 48, G = 48)
WIDE_G_SHAPES = [(4, 1024, 128, 128, 48, 1), (3, 100, 20, 36, 48, 1),
                 (2, 100, 20, 128, 80, 1)]   # G = 80: the gather's teams take 64 groups a pass


def _store_case(shape, store_dtype, dev, seed):
    """A store of 2B + 1 random rows (slot 0 zero: a fully masked user's
    table) in ``store_dtype`` with its scales, slots with the last user on
    slot 0, and every other user absent."""
    B, L, C, d, m, tau = shape
    rng = np.random.default_rng(seed)
    N = 2 * B + 1
    rows = torch.from_numpy(rng.standard_normal((N, m // tau, 1 << tau, d)).astype(
        np.float32)).to(dev)
    rows[0] = 0
    scales = None
    if store_dtype in ("int8", "fp8"):
        store, scales = quantize_rows(rows, dtype=TABLE_DTYPES[store_dtype])
    else:
        store = rows.to(torch.bfloat16 if store_dtype == "bf16" else torch.float32)
    slots = torch.tensor(rng.integers(0, N, B), dtype=torch.int32, device=dev)
    slots[-1] = 0
    present = torch.ones(B, device=dev)
    present[::2] = 0
    return store, scales, slots, present


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", LARGE_TAU_SHAPES + WIDE_G_SHAPES)
def test_large_tau_bse_serve(shape, dtype, layout, dev):
    """tau 5..10, and tau = 1 at G = 48: bse_serve's large-tau path against
    its plain version on ragged masks; candidates half drawn from the users'
    own behaviors, so most select a nonempty bucket; the same bits on two
    launches; a fully masked user reads zero; C = 0 launches nothing."""
    B, L, C, d, m, tau = shape
    seq, q, mask, R, rng = _inputs(shape, dev, dtype, seed=30 + tau)
    mask = _layout(mask, layout, rng)
    own = torch.from_numpy(rng.integers(0, L, (B, C // 2))).to(dev)
    q[:, :C // 2] = torch.gather(seq.float(), 1, own[..., None].expand(-1, -1, d))
    before = bse_serve.launches
    out = bse_serve(q, seq, mask, R, tau)
    torch.testing.assert_close(out, bse_serve_ref(q, seq, mask, R, tau), **FP32)
    assert torch.equal(out, bse_serve(q, seq, mask, R, tau))
    torch.cuda.synchronize()
    assert bse_serve.launches == before + 2
    if B > 1:
        assert not out[-1].any()
    empty = bse_serve(q[:, :0].contiguous(), seq, mask, R, tau)
    assert empty.shape == (B, 0, d) and bse_serve.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("store_dtype", ["fp32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("shape", LARGE_TAU_SHAPES)
def test_large_tau_sdim_fused_serve(shape, store_dtype, dev):
    """tau 5..10: the fused read off fp32, bf16, int8 and fp8 stores (at d =
    36 int8 and fp8 rows are 36 bytes: 4-byte loads) against its plain
    version; absent users and the zero row read zero; the same bits twice."""
    B, L, C, d, m, tau = shape
    _, q, _, R, _ = _inputs(shape, dev, seed=40 + tau)
    store, scales, slots, present = _store_case(shape, store_dtype, dev, seed=tau)
    before = sdim_fused_serve.launches
    run = lambda: sdim_fused_serve(store, slots, q, R, tau, scales=scales, present=present)
    out = run()
    ref = sdim_fused_serve_ref(store, slots, q, R, tau, scales=scales, present=present)
    torch.testing.assert_close(out, ref, **FP32)
    assert torch.equal(out, run())
    torch.cuda.synchronize()
    assert sdim_fused_serve.launches == before + 2
    assert not out[::2].any() and not out[-1].any()
    on_rows = (present > 0) & (slots != 0)                  # present users on random rows
    assert out[on_rows].abs().sum(-1).gt(0).all()


# chip_smoke.py phase 20 (a)'s shapes (B, L, C, d, m, tau): a 16-user burst
# of 128 candidates against 1,024 behaviors at Table 4's tau 5 and 10 and
# tau = 1 at m = 48, at d = 128 and dien's d = 36
LT_TOL = 1e-5                       # decoupled against inline (chip_smoke.py LT_TOL)
PHASE20_SHAPES = [(16, 1024, 128, d, m, tau) for d in (128, 36)
                  for tau, m in ((5, 45), (10, 40), (1, 48))]
PHASE20_IDS = [f"tau{s[5]}-m{s[4]}-d{s[3]}" for s in PHASE20_SHAPES]


def _phase20_inputs(shape, dev, dtype, seed):
    """Phase 20 (a)'s inputs: front-padded histories of L/2..L valid rows,
    the last user fully masked, half of each other user's candidates its
    own valid behaviors."""
    B, L, C, d, m, tau = shape
    seq, q, _, R, rng = _inputs(shape, dev, dtype, seed=seed)
    mask = (torch.arange(L)[None] >= torch.from_numpy(rng.integers(0, L // 2, B))[:, None])
    mask = mask.float().to(dev)
    mask[-1] = 0
    for b in range(B - 1):
        own = torch.from_numpy(rng.choice(np.flatnonzero(mask[b].cpu().numpy()), C // 2))
        q[b, :C // 2] = seq[b, own.to(dev)].float()
    return seq, q, mask, R


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", PHASE20_SHAPES, ids=PHASE20_IDS)
def test_large_tau_bse_serve_at_phase20_shapes(shape, dtype, dev):
    """bse_serve's redesigned large-tau path (group slices, staged tiles,
    the gather body) at phase 20's shapes against its plain version: the
    same bits on two launches, the fully masked user zero, C = 0 and L = 0;
    at tau 5 and 10 inline against decoupled (bse_encode's table read by
    sdim_fused_serve off an fp32 store) within LT_TOL."""
    B, L, C, d, m, tau = shape
    seq, q, mask, R = _phase20_inputs(shape, dev, dtype, seed=60 + tau)
    before = bse_serve.launches
    out = bse_serve(q, seq, mask, R, tau)
    ref = bse_serve_ref(q, seq, mask, R, tau)
    torch.testing.assert_close(out, ref, **FP32)
    assert torch.equal(out, bse_serve(q, seq, mask, R, tau))
    torch.cuda.synchronize()
    assert bse_serve.launches == before + 2
    assert not out[-1].any() and ref[:-1].abs().sum(-1).gt(0).float().mean() >= 0.5
    assert bse_serve(q[:, :0].contiguous(), seq, mask, R, tau).shape == (B, 0, d)
    none = bse_serve(q, seq[:, :0].contiguous(), mask[:, :0].contiguous(), R, tau)
    torch.cuda.synchronize()
    assert none.shape == (B, C, d) and not none.any()
    if tau >= 5:
        table = bse_encode(seq, mask, R, tau)
        slots = torch.arange(B, dtype=torch.int32, device=dev)
        decoupled = sdim_fused_serve(table, slots, q, R, tau)
        assert (decoupled - out).abs().max().item() <= LT_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("store_dtype", ["fp32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("shape", [s for s in PHASE20_SHAPES if s[5] >= 5],
                         ids=[i for s, i in zip(PHASE20_SHAPES, PHASE20_IDS) if s[5] >= 5])
def test_large_tau_sdim_fused_serve_at_phase20_shapes(shape, store_dtype, dev):
    """sdim_fused_serve's redesigned large-tau path (the gather body) at
    phase 20's shapes, off a store of 64 users' encoded histories in four
    dtypes (int8 and fp8 rows of 36 bytes at d = 36), against its plain
    version: an absent user and the fully masked one read zero, the same
    bits on two launches, C = 0 launches nothing."""
    B, L, C, d, m, tau = shape
    seq, q, mask, R = _phase20_inputs(shape, dev, torch.float32, seed=70 + tau)
    users = 64
    hist = torch.cat([seq, torch.randn((users - B, L, d), device=dev)])
    hmask = torch.cat([mask, torch.ones((users - B, L), device=dev)])
    rows = bse_encode_ref(hist, hmask, R, tau)
    scales = None
    if store_dtype in ("int8", "fp8"):
        store, scales = quantize_rows(rows, dtype=TABLE_DTYPES[store_dtype])
    else:
        store = rows.to(torch.bfloat16 if store_dtype == "bf16" else torch.float32)
    slots = torch.arange(B, dtype=torch.int32, device=dev)
    present = torch.ones(B, device=dev)
    present[1] = 0
    run = lambda qq: sdim_fused_serve(store, slots, qq, R, tau, scales=scales, present=present)
    before = sdim_fused_serve.launches
    out = run(q)
    ref = sdim_fused_serve_ref(store, slots, q, R, tau, scales=scales, present=present)
    torch.testing.assert_close(out, ref, **FP32)
    assert torch.equal(out, run(q))
    torch.cuda.synchronize()
    assert sdim_fused_serve.launches == before + 2
    assert not out[1].any() and not out[-1].any()
    assert ref[2:-1].abs().sum(-1).gt(0).float().mean() >= 0.5
    assert run(q[:, :0].contiguous()).shape == (B, 0, d)
    assert sdim_fused_serve.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dups", "two-slots"])
@pytest.mark.parametrize("E", [1, 5, 16, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", LARGE_TAU_SHAPES)
def test_large_tau_sdim_update(shape, dtype, E, case, dev):
    """tau 5..10: duplicate slots fold in b order (one owner a slot), a
    zero-mask row writes nothing, only reached cells are written (-0.0
    elsewhere keeps its bits); the same bits on two launches; E = 0 leaves
    the store as it was."""
    store, slots, events, mask, R = _update_case(shape, case, dev, dtype, E, seed=50)
    tau = shape[-1]
    a, b, c = store.clone(), store.clone(), store.clone()
    before = sdim_update.launches
    assert sdim_update(a, slots, events, mask, R, tau) is a
    sdim_update(c, slots, events, mask, R, tau)
    sdim_update_ref(b, slots, events, mask, R, tau)
    torch.cuda.synchronize()
    assert sdim_update.launches == before + 2
    _check_update(store, a, b, slots, events, mask, R)
    assert torch.equal(a.view(torch.int32), c.view(torch.int32))
    if case == "dups":                                       # only row 0 aims at slot 0
        assert torch.equal(a[0].view(torch.int32), store[0].view(torch.int32))
    d = store.clone()
    sdim_update(d, slots, events[:, :0].contiguous(), mask[:, :0].contiguous(), R, tau)
    assert torch.equal(d.view(torch.int32), store.view(torch.int32))


@pytest.mark.cuda
def test_large_tau_sdim_update_many_rows(dev):
    """B = 1200 batch rows on 40 slots at tau = 7: each owner lists its rows
    over five windows of 256, and a later window starts from the cells the
    earlier one wrote."""
    shape = (600, 16, 8, 36, 21, 7)
    store, slots, events, mask, R = _update_case(shape, "dups", dev)
    slots = slots % 40
    a, b = store.clone(), store.clone()
    sdim_update(a, slots, events, mask, R, 7)
    sdim_update_ref(b, slots, events, mask, R, 7)
    _check_update(store, a, b, slots, events, mask, R)


@pytest.mark.cuda
@pytest.mark.parametrize("E, tau, B, n_slots", [(1, 5, 300, 1), (300, 10, 20, 5)],
                         ids=["E1-256-rows-a-sub-window", "E300-one-row-a-sub-window"])
def test_large_tau_sdim_update_sub_windows(E, tau, B, n_slots, dev):
    """The large-tau fold's sub-windows of owned rows (max(1, 256 // E) of
    them): at E = 1, 600 batch rows on one slot fill windows and
    sub-windows of 256 rows (then 88); at E = 300 each sub-window is one
    row whose events are hashed in ten rounds and sorted in ten. Against
    the plain version at FP32, the cells no weighted event reached keep
    their bits, the same bits twice."""
    store, slots, events, mask, R = _update_case((B, 16, 8, 36, 10 * tau, tau), "dups", dev,
                                                 E=E, seed=51)
    slots = slots % n_slots
    a, b, c = store.clone(), store.clone(), store.clone()
    sdim_update(a, slots, events, mask, R, tau)
    sdim_update(c, slots, events, mask, R, tau)
    sdim_update_ref(b, slots, events, mask, R, tau)
    _check_update(store, a, b, slots, events, mask, R)
    assert torch.equal(a.view(torch.int32), c.view(torch.int32))


@pytest.mark.cuda
def test_large_tau_sdim_update_refuses_more_events_than_it_sorts(dev):
    """The large-tau fold sorts a batch row's events in shared memory, at
    most UPDATE_LT_MAX_E at once: past that it no longer refuses but folds
    the row in chunks (d = 4), against the plain version, the cells no
    weighted event reached keeping their bits."""
    store, slots, events, mask, R = _update_case((2, 16, 8, 4, 10, 5), "dups", dev,
                                                 E=UPDATE_LT_MAX_E + 1)
    a, b = store.clone(), store.clone()
    sdim_update(a, slots, events, mask, R, 5)
    sdim_update_ref(b, slots, events, mask, R, 5)
    _check_update(store, a, b, slots, events, mask, R)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_bse_encode_kernel(shape, dtype, dev):
    seq, _, mask, R, _ = _inputs(shape, dev, dtype)
    before = bse_encode.launches
    out = bse_encode(seq, mask, R, shape[-1])
    torch.cuda.synchronize()
    assert bse_encode.launches == before + 1
    torch.testing.assert_close(out, bse_encode_ref(seq, mask, R, shape[-1]), **ATOMIC)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", ["fewest", "auto", "G"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CLUSTER_SHAPES)
def test_bse_encode_kernel_group_slices(shape, dtype, layout, splits, dev):
    """The fewest group slices a CTA can hold (up to 4 groups each), the
    wrapper's choice, and one group per CTA; wholly masked tiles, and (B >
    1) a last user with every behavior masked, whose table is zero."""
    seq, _, mask, R, rng = _inputs(shape, dev, dtype, seed=5)
    B, G, U, tau = shape[0], shape[4] // shape[5], 1 << shape[5], shape[5]
    mask = _layout(mask, layout, rng)
    S = {"fewest": -(-G // (MAX_CELLS // U)), "auto": None, "G": G}[splits]
    out = bse_encode_cuda(seq, mask, R, tau, S)
    torch.testing.assert_close(out, bse_encode_ref(seq, mask, R, tau), **ATOMIC)
    if B > 1:
        assert not out[-1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CLUSTER_SHAPES)
def test_sdim_query_kernel(shape, table_dtype, dev):
    """(B > 1) the last user's history is fully masked: a zero table, which
    reads zero."""
    seq, q, mask, R, rng = _inputs(shape, dev)
    mask = _layout(mask, "random", rng)
    table = bse_encode_ref(seq, mask, R, shape[-1]).to(table_dtype)
    before = sdim_query.launches
    out = sdim_query(q, table, R, shape[-1])
    torch.cuda.synchronize()
    assert sdim_query.launches == before + 1
    torch.testing.assert_close(out, sdim_query_ref(q, table, R, shape[-1]), **FP32)
    if shape[0] > 1:
        assert not out[-1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("store_dtype", ["fp32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("shape", CLUSTER_SHAPES)
def test_sdim_fused_serve_kernel(shape, store_dtype, dev):
    """Absent users (every other one) read zero; slot 0 holds a zero row
    (a fully masked user's table), which reads zero too."""
    B, L, C, d, m, tau = shape
    _, q, _, R, rng = _inputs(shape, dev)
    N = 2 * B + 1
    rows = torch.from_numpy(rng.standard_normal((N, m // tau, 1 << tau, d)).astype(
        np.float32)).to(dev)
    rows[0] = 0
    scales = None
    if store_dtype in ("int8", "fp8"):
        store, scales = quantize_rows(rows, dtype=TABLE_DTYPES[store_dtype])
    else:
        store = rows.to(torch.bfloat16 if store_dtype == "bf16" else torch.float32)
    slots = torch.tensor(rng.integers(0, N, B), dtype=torch.int32, device=dev)
    slots[-1] = 0
    present = torch.ones(B, device=dev)
    present[::2] = 0
    out = sdim_fused_serve(store, slots, q, R, tau, scales=scales, present=present)
    ref = sdim_fused_serve_ref(store, slots, q, R, tau, scales=scales, present=present)
    torch.testing.assert_close(out, ref, **FP32)
    assert not out[::2].any()
    assert not out[-1].any()


def _update_case(shape, case, dev, dtype=torch.float32, E=None, seed=1):
    """Store (with -0.0 cells), slots, events, mask and R of an event fold
    of 2B batch rows: ``dups`` (random slots with duplicates, a zero-mask
    row at slot 0) or ``two-slots`` (every row on slot 1 or slot B)."""
    B, L, C, d, m, tau = shape
    E = min(L, 16) if E is None else E
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((m, d)).astype(np.float32)
    events = torch.from_numpy(screened_normal(rng, (2 * B, E, d), R, dtype)).to(dev, dtype)
    mask = torch.from_numpy((rng.random((2 * B, E)) > 0.2).astype(np.float32)).to(dev)
    if case == "dups":
        slots = np.r_[0, rng.integers(1, B + 1, 2 * B - 1)]
        mask[0] = 0                                          # zero-mask row at slot 0
    else:
        slots = np.where(rng.random(2 * B) > 0.5, 1, B)
    store = torch.randn((B + 1, m // tau, 1 << tau, d), device=dev)
    store[:, :, 0, :4] = -0.0
    slots = torch.tensor(slots, dtype=torch.int32, device=dev)
    return store, slots, events, mask, torch.from_numpy(R).to(dev)


def _check_update(store, out, ref, slots, events, mask, R):
    """out against the plain version at FP32; the (group, bucket) cells no
    weighted event reached keep their exact bits (-0.0 included)."""
    torch.testing.assert_close(out, ref, **FP32)
    N, G, U, d = store.shape
    sig = simhash.signatures(events.float(), R, U.bit_length() - 1)   # (B, E, G)
    b, e = torch.nonzero(mask != 0, as_tuple=True)
    reached = torch.zeros((N, G, U), dtype=torch.bool, device=store.device)
    reached[slots[b].long()[:, None], torch.arange(G, device=store.device), sig[b, e]] = True
    assert torch.equal(out[~reached].view(torch.int32), store[~reached].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dups", "two-slots"])
@pytest.mark.parametrize("shape", SHAPES)
def test_sdim_update_kernel(shape, case, dev):
    """Duplicate slots fold in b order (the Pallas kernel's running total);
    a zero-mask row at slot 0 leaves slot 0's bits alone."""
    store, slots, events, mask, R = _update_case(shape, case, dev)
    tau = shape[-1]
    a, b = store.clone(), store.clone()
    before = sdim_update.launches
    assert sdim_update(a, slots, events, mask, R, tau) is a
    torch.cuda.synchronize()
    assert sdim_update.launches == before + 1
    sdim_update_ref(b, slots, events, mask, R, tau)
    _check_update(store, a, b, slots, events, mask, R)
    if case == "dups":                                       # only row 0 aims at slot 0
        assert torch.equal(a[0].view(torch.int32), store[0].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("splits", ["fewest", "auto", "G"])
@pytest.mark.parametrize("E", [5, 16, 40, 80])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CLUSTER_SHAPES)
def test_sdim_update_kernel_group_slices(shape, dtype, E, splits, dev):
    """The fewest group slices a CTA can hold, the wrapper's choice and one
    group per CTA; E = 5 (a mask row at an odd offset; 6 rows a unit), 16
    (2 rows a unit), 40 and 80 (two and three units a row); bf16 events."""
    store, slots, events, mask, R = _update_case(shape, "dups", dev, dtype, E, seed=6)
    G, U, d, tau = store.shape[1], store.shape[2], store.shape[3], shape[-1]
    S = {"fewest": -(-G // (update_cells(d) // U)), "auto": None, "G": G}[splits]
    a, b = store.clone(), store.clone()
    sdim_update_cuda(a, slots, events, mask, R, tau, S)
    sdim_update_ref(b, slots, events, mask, R, tau)
    _check_update(store, a, b, slots, events, mask, R)


@pytest.mark.cuda
def test_sdim_update_kernel_many_rows(dev):
    """B = 1200 batch rows on 40 slots: each owner lists its rows over five
    windows of 256; and E = 0 leaves the store as it was."""
    shape = (600, 16, 8, 128, 48, 3)
    store, slots, events, mask, R = _update_case(shape, "dups", dev)
    slots = slots % 40
    a, b = store.clone(), store.clone()
    sdim_update(a, slots, events, mask, R, 3)
    sdim_update_ref(b, slots, events, mask, R, 3)
    _check_update(store, a, b, slots, events, mask, R)
    c = store.clone()
    sdim_update(c, slots, events[:, :0].contiguous(), mask[:, :0].contiguous(), R, 3)
    assert torch.equal(c.view(torch.int32), store.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CLUSTER_SHAPES)
def test_bse_serve_kernel(shape, dtype, layout, dev):
    """Ragged L and C, G = 6 (one group per CTA) and G = 12 (uneven group
    ranges), tau = 4, wholly masked tiles, and (B > 1) a last user with every
    behavior masked, who reads zero."""
    seq, q, mask, R, rng = _inputs(shape, dev, dtype, seed=2)
    B, tau = shape[0], shape[-1]
    mask = _layout(mask, layout, rng)
    before = bse_serve.launches
    out = bse_serve(q, seq, mask, R, tau)
    torch.cuda.synchronize()
    assert bse_serve.launches == before + 1
    torch.testing.assert_close(out, bse_serve_ref(q, seq, mask, R, tau), **FP32)
    if B > 1:
        assert not out[-1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CLUSTER_SHAPES)
def test_target_attention_flash_kernel(shape, dtype, layout, dev):
    """Ragged L and C (L below one tile per cluster rank at L = 40), wholly
    masked leading chunks, valid rows in the last chunk only, and (B > 1) a
    fully masked last user, who attends uniformly over all L rows."""
    seq, q, mask, _, rng = _inputs(shape, dev, dtype, seed=3)
    mask = _layout(mask, layout, rng)
    before = target_attention_flash.launches
    out = target_attention_flash(q, seq, mask)
    torch.cuda.synchronize()
    assert target_attention_flash.launches == before + 1
    torch.testing.assert_close(out, target_attention_flash_ref(q, seq, mask), **FP32)
    if shape[0] > 1:
        uniform = seq[-1].float().mean(0).expand(shape[2], -1)
        torch.testing.assert_close(out[-1], uniform, **FP32)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["bse_serve", "target_attention_flash", "bse_encode",
                                    "sdim_fused_serve", "sdim_query-fp32", "sdim_query-bf16",
                                    "sdim_update"])
def test_cluster_merges_are_deterministic(kernel, dev):
    """The kernels that split a user's work over CTAs merge it in rank
    order or in row order, or (sdim_update) give each slot one owner that
    folds its rows in b order, without atomics: two launches on the same
    inputs agree bit for bit."""
    shape = (4, 1024, 128, 128, 48, 3)
    seq, q, mask, R, rng = _inputs(shape, dev, seed=4)
    mask = _layout(mask, "front", rng)
    if kernel == "bse_serve":
        run = lambda: bse_serve(q, seq, mask, R, shape[-1])
    elif kernel == "target_attention_flash":
        run = lambda: target_attention_flash(q, seq, mask)
    elif kernel == "bse_encode":
        run = lambda: bse_encode(seq, mask, R, shape[-1])
    elif kernel == "sdim_fused_serve":
        store = bse_encode_ref(seq, mask, R, shape[-1])
        slots = torch.tensor([3, 1, 0, 2], dtype=torch.int32, device=dev)
        run = lambda: sdim_fused_serve(store, slots, q, R, shape[-1])
    elif kernel.startswith("sdim_query"):
        table = bse_encode_ref(seq, mask, R, shape[-1])
        if kernel.endswith("bf16"):
            table = table.to(torch.bfloat16)
        run = lambda: sdim_query(q, table, R, shape[-1])
    else:
        store, slots, events, ev_mask, R = _update_case((16,) + shape[1:], "dups", dev)
        run = lambda: sdim_update(store.clone(), slots, events, ev_mask, R, shape[-1])
    assert torch.equal(run(), run())


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernel_does_not_take(dev):
    seq, q, mask, R, _ = _inputs(SHAPES[0], dev)
    with pytest.raises(ValueError):
        bse_encode(seq, mask.cpu(), R, 2)                     # mixed devices
    with pytest.raises(ValueError):
        bse_encode(seq.transpose(1, 2).contiguous().transpose(1, 2), mask, R, 2)
    with pytest.raises(TypeError):
        sdim_query(q.double(), bse_encode_ref(seq, mask, R, 2), R, 2)
    with pytest.raises(TypeError):
        bse_serve(q.bfloat16(), seq, mask, R, 2)                # candidates are fp32
    with pytest.raises(ValueError):
        target_attention_flash(q, seq, mask[:, :-1].contiguous())
    for d in (6, 260):                          # d not a multiple of 4, or above 256
        qd = torch.zeros((*q.shape[:2], d), device=dev)
        sd = torch.zeros((*seq.shape[:2], d), device=dev)
        with pytest.raises(ValueError):
            target_attention_flash(qd, sd, mask)
        with pytest.raises(ValueError):
            target_attention_flash_backward(qd, qd, sd, mask, qd)
    shifted = torch.empty(seq.numel() + 1, device=dev)[1:].view(seq.shape)
    shifted.copy_(seq)                          # contiguous, 4 bytes past a boundary
    with pytest.raises(ValueError):
        bse_serve(q, shifted, mask, R, 2)


@pytest.mark.cuda
def test_redesigned_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """bse_encode takes tau 1..10, any d a multiple of 4 (past 128 on its
    list path: held against the plain version at d = 136) and any L (past
    MAX_L its batch list takes the rows in spans: held against the plain
    version); sdim_fused_serve and sdim_query take tau 1..10, any d a
    multiple of 4 (d = 136 at tau 5 held against the plain versions), a
    user's table in whole 16-byte loads and 16-byte aligned operands;
    sdim_update takes tau 1..10, any d a multiple of 4 (d = 136 held
    against the plain version), at tau <= 4 and d <= 128 1..G group slices
    that keep a CTA at update_cells(d) cells (elsewhere none), and 16-byte
    aligned operands; bse_serve takes tau 1..10 and d up to 128."""
    seq, q, mask, R, rng = _inputs((2, 64, 16, 136, 10, 5), dev)
    R8 = R[:8].contiguous()
    torch.testing.assert_close(bse_encode(seq, mask, R8, 2),          # d = 136
                               bse_encode_ref(seq, mask, R8, 2), **ATOMIC)
    with pytest.raises(ValueError, match="tau 1..10"):
        bse_encode(seq[..., :128].contiguous(), mask, torch.zeros((11, 128), device=dev), 11)
    with pytest.raises(ValueError, match="d a multiple of 4"):
        bse_encode(seq[..., :10].contiguous(), mask, R[:8, :10].contiguous(), 2)
    R16 = R[:8, :16].contiguous()
    long_seq = torch.from_numpy(screened_normal(rng, (1, MAX_L + 8, 16),
                                                R16.cpu().numpy())).to(dev)
    long_mask = torch.ones((1, MAX_L + 8), device=dev)
    torch.testing.assert_close(bse_encode(long_seq, long_mask, R16, 2),
                               bse_encode_ref(long_seq, long_mask, R16, 2), **ATOMIC)
    rows = torch.randn((3, 4, 4, 8), device=dev)
    slots = torch.tensor([0, 2], dtype=torch.int32, device=dev)
    q8 = q[:, :, :8].contiguous()
    store, scales = quantize_rows(rows[:, :1, :2, :4].contiguous(), dtype=torch.int8)
    with pytest.raises(ValueError, match="16-byte loads"):     # G = 1, U = 2, d = 4: 8 bytes
        sdim_fused_serve(store, slots, q[:, :, :4].contiguous(), R[:1, :4].contiguous(), 1,
                         scales=scales)
    shifted = torch.empty(q8.numel() + 1, device=dev)[1:].view(q8.shape)
    shifted.copy_(q8)                           # contiguous, 4 bytes past a boundary
    with pytest.raises(ValueError, match="16-byte boundary"):
        sdim_fused_serve(rows, slots, shifted, R[:8, :8].contiguous(), 2)
    # sdim_query: d = 6 (not a multiple of 4); tau 11; d = 136 at tau 5; a shifted table
    with pytest.raises(ValueError, match="16-byte loads"):
        sdim_query(q[:2, :, :6].contiguous(), torch.zeros((2, 4, 4, 6), device=dev,
                                                          dtype=torch.bfloat16),
                   R[:8, :6].contiguous(), 2)
    with pytest.raises(ValueError, match="tau 1..10"):
        sdim_query(q[:2, :, :8].contiguous(), torch.zeros((2, 1, 2048, 8), device=dev),
                   torch.zeros((11, 8), device=dev), 11)
    R5 = R[:5].contiguous()
    table136 = torch.from_numpy(rng.standard_normal((2, 1, 32, 136)).astype(np.float32)).to(dev)
    torch.testing.assert_close(sdim_query(q, table136, R5, 5),
                               sdim_query_ref(q, table136, R5, 5), **FP32)
    table = torch.zeros((2, 4, 4, 8), device=dev)
    shifted_t = torch.empty(table.numel() + 1, device=dev)[1:].view(table.shape)
    with pytest.raises(ValueError, match="16-byte boundary"):
        sdim_query(q8, shifted_t, R[:8, :8].contiguous(), 2)
    # sdim_update: d = 10 and d = 136, tau 5, too few or too many slices, a shifted store
    ev = torch.zeros((2, 3, 8), device=dev)
    ev_mask = torch.ones((2, 3), device=dev)
    store8 = torch.zeros((4, 4, 4, 8), device=dev)
    with pytest.raises(ValueError, match="d a multiple of 4"):
        sdim_update(torch.zeros((4, 4, 4, 10), device=dev), slots,
                    torch.zeros((2, 3, 10), device=dev), ev_mask, R[:8, :10].contiguous(), 2)
    ev136 = torch.from_numpy(screened_normal(rng, (2, 3, 136), R8.cpu().numpy())).to(dev)
    store136 = torch.from_numpy(rng.standard_normal((4, 4, 4, 136)).astype(np.float32)).to(dev)
    torch.testing.assert_close(sdim_update(store136.clone(), slots, ev136, ev_mask, R8, 2),
                               sdim_update_ref(store136.clone(), slots, ev136, ev_mask, R8, 2),
                               **FP32)
    with pytest.raises(ValueError, match="tau 1..10"):
        sdim_update(torch.zeros((4, 1, 2048, 8), device=dev), slots, ev, ev_mask,
                    torch.zeros((11, 8), device=dev), 11)
    with pytest.raises(ValueError, match="group slices"):  # the large-tau path takes none
        sdim_update_cuda(torch.zeros((4, 2, 32, 8), device=dev), slots, ev, ev_mask,
                         R[:10, :8].contiguous(), 5, 1)
    # sdim_fused_serve and bse_serve: tau 11; d = 136 at tau 5
    with pytest.raises(ValueError, match="tau 1..10"):
        sdim_fused_serve(torch.zeros((3, 1, 2048, 8), device=dev), slots, q8,
                         torch.zeros((11, 8), device=dev), 11)
    store5 = torch.cat([table136, table136.flip(0)])             # (4, 1, 32, 136)
    torch.testing.assert_close(sdim_fused_serve(store5, slots, q, R5, 5),
                               sdim_fused_serve_ref(store5, slots, q, R5, 5), **FP32)
    with pytest.raises(ValueError, match="tau 1..10"):
        bse_serve(q8, torch.zeros((2, 64, 8), device=dev), mask, torch.zeros((11, 8), device=dev),
                  11)
    with pytest.raises(ValueError, match="d a multiple of 4 up to 128"):
        bse_serve(q[:2, :, :136].contiguous(), seq[:2, :, :136].contiguous(), mask,
                  R[:5, :136].contiguous(), 5)
    for splits in (0, 5):
        with pytest.raises(ValueError, match="group slices"):
            sdim_update_cuda(store8, slots, ev, ev_mask, R[:8, :8].contiguous(), 2, splits)
    big = torch.zeros((2, 8, 16, 128), device=dev)            # a group a CTA at most
    with pytest.raises(ValueError, match="group slices"):
        sdim_update_cuda(big, slots, torch.zeros((2, 3, 128), device=dev), ev_mask,
                         torch.zeros((32, 128), device=dev), 4, 1)
    shifted_s = torch.empty(store8.numel() + 1, device=dev)[1:].view(store8.shape)
    with pytest.raises(ValueError, match="16-byte boundary"):
        sdim_update(shifted_s, slots, ev, ev_mask, R[:8, :8].contiguous(), 2)


# ---------------------------------------------------------------------------
# the decoupled deployment's four kernels past d = 128 (bse_encode and
# sdim_update on their lists' wide variants at every tau, sdim_query and
# sdim_fused_serve on the fused body, the wide path or the large-tau
# gather's wide variant) and past the fused body's shared memory at tau <= 4
# (the wide path, R read from device memory at m = 500)
# ---------------------------------------------------------------------------
WIDE_TAUS = [(3, 48), (4, 48), (5, 45), (10, 40)]   # (tau, m)


def _decoupled_read_checks(q, store, slots, R, tau):
    """sdim_query off the fetched rows store[slots] and sdim_fused_serve off
    the store, fp32 and bf16 (and int8, fp8 for the fused read), against
    their plain versions, each the same bits twice; the fused read of the
    fp32 store equals sdim_query of its rows bit for bit; an absent user's
    answers are zero."""
    table = store[slots.long()].contiguous()
    for dt in (torch.float32, torch.bfloat16):
        t = table.to(dt)
        got = sdim_query(q, t, R, tau)
        torch.testing.assert_close(got, sdim_query_ref(q, t, R, tau), **FP32)
        assert torch.equal(got, sdim_query(q, t, R, tau))
    fused = sdim_fused_serve(store, slots, q, R, tau)
    assert torch.equal(fused, sdim_query(q, table, R, tau))      # one body, one set of bits
    present = torch.ones(q.shape[0], device=q.device)
    present[-1] = 0.0
    for dt in TABLE_DTYPES.values():
        if dt in (torch.float32, torch.bfloat16):
            st, sc = store.to(dt), None
        else:
            st, sc = quantize_rows(store, dtype=dt)
        got = sdim_fused_serve(st, slots, q, R, tau, scales=sc, present=present)
        torch.testing.assert_close(got, sdim_fused_serve_ref(st, slots, q, R, tau, scales=sc,
                                                             present=present), **FP32)
        assert torch.equal(got, sdim_fused_serve(st, slots, q, R, tau, scales=sc,
                                                 present=present))
        assert not got[-1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [132, 256])
@pytest.mark.parametrize("tau, m", WIDE_TAUS)
def test_decoupled_kernels_take_wide_rows(tau, m, d, dev):
    """bse_encode (fp32 and bf16 behaviors, a fully masked user), an
    sdim_update fold (a duplicate slot, a zero-mask row) on the encoded
    store, and both reads of the folded store, at d > 128, against their
    plain versions, each the same bits twice: the encode-plus-fold store
    rows equal the plain versions' within ATOMIC, so encode and fold bucket
    every behavior alike."""
    B, L, C, E, N = 4, 300, 70, 20, 6
    seq, q, mask, R, rng = _inputs((B, L, C, d, m, tau), dev, torch.bfloat16)
    seq = seq.float()                         # bf16 values: screened in both types
    mask[-1] = 0.0
    for dt in (torch.float32, torch.bfloat16):
        s = seq.to(dt)
        got = bse_encode(s, mask, R, tau)
        torch.testing.assert_close(got, bse_encode_ref(s, mask, R, tau), **ATOMIC)
        assert torch.equal(got, bse_encode(s, mask, R, tau))
    G, U = m // tau, 1 << tau
    store = torch.zeros((N, G, U, d), device=dev)
    slots = torch.tensor([4, 1, 0, 2], dtype=torch.int32, device=dev)
    store[slots.long()] = bse_encode(seq, mask, R, tau)
    plain = torch.zeros_like(store)
    plain[slots.long()] = bse_encode_ref(seq, mask, R, tau)
    ev_slots = torch.tensor([1, 4, 1, 3], dtype=torch.int32, device=dev)   # 1 twice; 3 new
    events = torch.from_numpy(screened_normal(rng, (4, E, d), R.cpu().numpy(),
                                              torch.bfloat16)).to(dev)
    ev_mask = torch.from_numpy((rng.random((4, E)) > 0.2).astype(np.float32)).to(dev)
    ev_mask[2] = 0.0                                                          # a zero-mask row
    for dt in (torch.float32, torch.bfloat16):
        ev = events.to(dt)
        got = sdim_update(store.clone(), ev_slots, ev, ev_mask, R, tau)
        torch.testing.assert_close(got, sdim_update_ref(store.clone(), ev_slots, ev, ev_mask, R,
                                                        tau), **FP32)
        assert torch.equal(got, sdim_update(store.clone(), ev_slots, ev, ev_mask, R, tau))
    sdim_update(store, ev_slots, events, ev_mask, R, tau)
    sdim_update_ref(plain, ev_slots, events, ev_mask, R, tau)
    torch.testing.assert_close(store, plain, **ATOMIC)
    _decoupled_read_checks(q[:, :C], store, slots, R, tau)
    torch.cuda.synchronize()


QUERY_PLAN_SHAPES = [  # (m, tau, d, plan on the H100): the fused body's layout past a CTA
    (500, 4, 128, ("wide", 125, False)),   # R alone 256,000 B: read from device memory
    (48, 4, 256, ("wide", 12, True)),      # R + table + candidates 280,080 B
    (500, 4, 256, ("wide", 74, False)),    # two buffers of a candidate's rows too: chunks
    (48, 3, 256, ("fused", 16, True)),     # fits (215,056 B)
]


@pytest.mark.cuda
@pytest.mark.parametrize("m, tau, d, plan", QUERY_PLAN_SHAPES)
def test_reads_past_the_fused_body(m, tau, d, plan, dev):
    """sdim_query and sdim_fused_serve where the fused body's shared memory
    does not fit a CTA (these ended in a CUDA launch error): the wide path
    (R read from device memory at m = 500, the selected rows in chunks of
    groups at m = 500, d = 256) against the plain versions, the same bits
    twice, the fused read equal to sdim_query of the fetched rows bit for
    bit, fp32 / bf16 / int8 / fp8 stores."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.sdim_query.sdim_query import query_plan

    optin = _build.smem_optin(dev)
    if optin == 232448:
        assert query_plan(m // tau, 1 << tau, d, m, 4, optin) == plan
    B, C, N = 4, 70, 6
    rng = np.random.default_rng(m + d)
    R = rng.standard_normal((m, d)).astype(np.float32)
    q = torch.from_numpy(screened_normal(rng, (B, C, d), R)).to(dev)
    store = torch.from_numpy(rng.standard_normal((N, m // tau, 1 << tau, d))
                             .astype(np.float32)).to(dev)
    store[:, :, 1] = 0.0                                        # empty buckets
    slots = torch.tensor([5, 0, 3, 3], dtype=torch.int32, device=dev)
    _decoupled_read_checks(q, store, slots, torch.from_numpy(R).to(dev), tau)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# widths d % 8 == 4, where a bf16 row is not a whole number of 16-byte
# pieces: dien's behavior width d = 2 * 18 = 36 (rows of 144 bytes in fp32,
# 72 in bf16 and 36 in int8 and fp8), d = 4 (one 16-byte int8 load spans
# four rows; one float4 column, so most hash lanes hold none), d = 20 and
# d = 44 (int8 rows of 20 and 44 bytes: loads straddle rows at offsets
# d = 36 never gives; 44 has eleven float4 columns)
# ---------------------------------------------------------------------------
D4MOD8_SHAPES = [
    (16, 1024, 128, 36, 48, 3),   # dien FULL: a 16-request burst (G = 16, U = 8)
    (3, 301, 70, 36, 10, 2),      # L = 301 (a 5-row tail batch), G = 5: uneven splits
    (4, 67, 33, 36, 24, 4),       # tau = 4, G = 6
    (5, 77, 9, 4, 12, 2),         # d = 4, G * U = 24: 3 rows a rank rounded up to 4
    (3, 130, 40, 20, 24, 3),      # d = 20, G = 8
    (2, 95, 17, 44, 16, 4),       # d = 44, tau = 4, G = 4
]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", D4MOD8_SHAPES)
def test_bse_encode_and_its_backward_at_d4mod8(shape, dtype, layout, dev):
    """bse_encode (a bf16 batch of an odd number of 72-byte rows ends in an
    8-byte tail) and its backward against the plain versions, the same bits
    on two launches; (B > 1) a fully masked last user."""
    seq, _, mask, R, rng = _inputs(shape, dev, dtype, seed=11)
    B, tau = shape[0], shape[-1]
    mask = _layout(mask, layout, rng)
    out = bse_encode(seq, mask, R, tau)
    torch.testing.assert_close(out, bse_encode_ref(seq, mask, R, tau), **ATOMIC)
    assert torch.equal(out, bse_encode(seq, mask, R, tau))
    if B > 1:
        assert not out[-1].any()
    dT = torch.randn(out.shape, device=dev)
    grad = bse_encode_backward(dT, seq, mask, R, tau)
    assert grad.dtype == dtype and torch.equal(grad, bse_encode_backward(dT, seq, mask, R, tau))
    torch.testing.assert_close(grad.float(),
                               bse_encode_backward_ref(dT, seq, mask, R, tau).float(),
                               **(FP32 if dtype == torch.float32 else BF16_OUT))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", D4MOD8_SHAPES + [(2048, 32, 1, 36, 12, 2)],
                         ids=[str(s) for s in D4MOD8_SHAPES] + ["folded-d36"])
def test_target_attention_flash_and_its_backward_at_d4mod8(shape, dtype, layout, dev):
    """target_attention_flash and its backward at d % 8 == 4 (bf16 rows of
    72, 8, 40 and 88 bytes, a user's rows off a 16-byte boundary where b L
    is odd) and at the retrieval kinds' folded shape at d = 36 (2,048 users
    of one candidate over 32 rows), against the plain versions at FP32
    (BF16_OUT for a bf16 dseq), the same bits on two launches; (B > 1) a
    fully masked last user attends uniformly and its candidates get no
    gradient."""
    seq, q, mask, _, rng = _inputs(shape, dev, dtype, seed=13)
    mask = _layout(mask, layout, rng)
    out = target_attention_flash(q, seq, mask)
    torch.testing.assert_close(out, target_attention_flash_ref(q, seq, mask), **FP32)
    assert torch.equal(out, target_attention_flash(q, seq, mask))
    if shape[0] > 1:
        uniform = seq[-1].float().mean(0).expand(shape[2], -1)
        torch.testing.assert_close(out[-1], uniform, **FP32)
    dout = torch.randn(q.shape, device=dev)
    dq, dseq = target_attention_flash_backward(dout, q, seq, mask, out)
    again = target_attention_flash_backward(dout, q, seq, mask, out)
    assert torch.equal(dq, again[0]) and torch.equal(dseq, again[1]) and dseq.dtype == dtype
    rq, rseq = target_attention_flash_backward_ref(dout, q, seq, mask, out)
    torch.testing.assert_close(dq, rq, **FP32)
    torch.testing.assert_close(dseq.float(), rseq.float(),
                               **(FP32 if dtype == torch.float32 else BF16_OUT))
    if shape[0] > 1:
        assert not dq[-1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dups", "two-slots"])
@pytest.mark.parametrize("E", [5, 16, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", D4MOD8_SHAPES)
def test_sdim_update_at_d4mod8(shape, dtype, E, case, dev):
    """bf16 event rows of 72 bytes start on 8-byte boundaries (E = 5: every
    other row), where the kernel stages them itself instead of by bulk
    copy; the same bits on two launches."""
    store, slots, events, mask, R = _update_case(shape, case, dev, dtype, E, seed=12)
    tau = shape[-1]
    a, b = store.clone(), store.clone()
    sdim_update(a, slots, events, mask, R, tau)
    sdim_update_ref(b, slots, events, mask, R, tau)
    _check_update(store, a, b, slots, events, mask, R)
    again = sdim_update(store.clone(), slots, events, mask, R, tau)
    assert torch.equal(a.view(torch.int32), again.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", D4MOD8_SHAPES)
def test_bse_serve_at_d4mod8(shape, dtype, layout, dev):
    """bf16 rows staged in 8-byte pieces; (B > 1) a fully masked last user
    reads zero; the same bits on two launches."""
    seq, q, mask, R, rng = _inputs(shape, dev, dtype, seed=13)
    mask = _layout(mask, layout, rng)
    out = bse_serve(q, seq, mask, R, shape[-1])
    torch.testing.assert_close(out, bse_serve_ref(q, seq, mask, R, shape[-1]), **FP32)
    assert torch.equal(out, bse_serve(q, seq, mask, R, shape[-1]))
    if shape[0] > 1:
        assert not out[-1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", D4MOD8_SHAPES)
def test_sdim_query_and_its_backward_at_d4mod8(shape, table_dtype, dev):
    """Tables of 72-byte bf16 rows (the default wire): a CTA's rows are an
    even number, so its 16-byte loads start on a 16-byte boundary; the
    backward (fp32) at C and at C = 1, the training step's, compared times
    each row's n as test_sdim_query_backward_kernel does (a zero row's
    gradient is g / 1e-6)."""
    seq, q, mask, R, rng = _inputs(shape, dev, seed=14)
    tau = shape[-1]
    mask = _layout(mask, "random", rng)
    table = bse_encode_ref(seq, mask, R, tau).to(table_dtype)
    out = sdim_query(q, table, R, tau)
    torch.testing.assert_close(out, sdim_query_ref(q, table, R, tau), **FP32)
    assert torch.equal(out, sdim_query(q, table, R, tau))
    if shape[0] > 1:
        assert not out[-1].any()
    t32 = table.float()
    n = torch.sqrt(torch.sum(t32 * t32, -1, keepdim=True) + 1e-12)
    for qq in (q, q[:, :1].contiguous()):
        dout = torch.randn(qq.shape, device=dev)
        torch.testing.assert_close(sdim_query_backward(dout, qq, t32, R, tau) * n,
                                   sdim_query_backward_ref(dout, qq, t32, R, tau) * n, **FP32)


@pytest.mark.cuda
@pytest.mark.parametrize("store_dtype", ["fp32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("shape", D4MOD8_SHAPES)
def test_sdim_fused_serve_at_d4mod8(shape, store_dtype, dev):
    """Rows of 144 / 72 / 36 / 36 bytes: 16-byte loads that straddle two
    rows take each value's own row scale; absent users and a zero row read
    zero; the same bits on two launches."""
    B, L, C, d, m, tau = shape
    _, q, _, R, rng = _inputs(shape, dev, seed=15)
    N = 2 * B + 1
    rows = torch.from_numpy(rng.standard_normal((N, m // tau, 1 << tau, d)).astype(
        np.float32)).to(dev)
    rows *= torch.from_numpy(rng.uniform(0.1, 10.0, (N, m // tau, 1 << tau, 1)).astype(
        np.float32)).to(dev)                        # rows of unlike scales
    rows[0] = 0
    scales = None
    if store_dtype in ("int8", "fp8"):
        store, scales = quantize_rows(rows, dtype=TABLE_DTYPES[store_dtype])
    else:
        store = rows.to(torch.bfloat16 if store_dtype == "bf16" else torch.float32)
    slots = torch.tensor(rng.integers(0, N, B), dtype=torch.int32, device=dev)
    slots[-1] = 0
    present = torch.ones(B, device=dev)
    present[1::3] = 0
    run = lambda: sdim_fused_serve(store, slots, q, R, tau, scales=scales, present=present)
    out = run()
    torch.testing.assert_close(out, sdim_fused_serve_ref(store, slots, q, R, tau, scales=scales,
                                                         present=present), **FP32)
    assert torch.equal(out, run())
    assert not out[1::3].any() and not out[-1].any()


# ---------------------------------------------------------------------------
# the backward kernels
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("splits", ["auto", "one", "rows"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CLUSTER_SHAPES)
def test_bse_encode_backward_kernel(shape, dtype, layout, splits, dev):
    """Against the plain version: the wrapper's cluster, one CTA a user and
    the largest cluster (8 CTAs, or one per 8 rows where fewer); wholly
    masked leading rows, valid rows only at the end, and (B > 1) a fully
    masked last user, whose gradient is 0."""
    seq, _, mask, R, rng = _inputs(shape, dev, dtype, seed=7)
    B, L, tau = shape[0], shape[1], shape[-1]
    mask = _layout(mask, layout, rng)
    G, U, d = shape[4] // tau, 1 << tau, shape[3]
    dT = torch.randn((B, G, U, d), device=dev)
    S = {"auto": None, "one": 1, "rows": min(8, -(-L // 8))}[splits]
    before = bse_encode_backward.launches
    out = bse_encode_backward_cuda(dT, seq, mask, R, tau, S)
    torch.cuda.synchronize()
    assert bse_encode_backward.launches == before + 1 and out.dtype == dtype
    torch.testing.assert_close(out.float(), bse_encode_backward_ref(dT, seq, mask, R, tau).float(),
                               **(FP32 if dtype == torch.float32 else BF16_OUT))
    if B > 1:
        assert not out[-1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("C", [0, 1, 33, None])
@pytest.mark.parametrize("shape", CLUSTER_SHAPES)
def test_sdim_query_backward_kernel(shape, C, dev):
    """C = 0 (a zero gradient, every row written), 1 (pointwise training),
    33 (two passes of candidates) and the shape's C; (B > 1) the last
    user's table is zero (a fully masked history). Compared times each
    row's n = sqrt(|t|^2 + 1e-12): a zero row's gradient is g / 1e-6, which
    scales the rounding of g by 1e6."""
    seq, q, mask, R, rng = _inputs(shape, dev, seed=8)
    mask = _layout(mask, "random", rng)
    tau = shape[-1]
    q = q[:, :shape[2] if C is None else C].contiguous()
    table = bse_encode_ref(seq, mask, R, tau)
    dout = torch.randn(q.shape, device=dev)
    for S in (None, 1):
        before = sdim_query_backward.launches
        out = sdim_query_backward_cuda(dout, q, table, R, tau, S)
        torch.cuda.synchronize()
        assert sdim_query_backward.launches == before + 1
        n = torch.sqrt(torch.sum(table * table, -1, keepdim=True) + 1e-12)
        torch.testing.assert_close(out * n, sdim_query_backward_ref(dout, q, table, R, tau) * n,
                                   **FP32)
    if q.shape[1] == 0:
        assert not out.any()


# sdim_query_backward's tau <= 4 body at the shapes its launches use and at
# its edges (B, L, C, d, m, tau, case): the training step (d = 128 and
# dien's 36), the Table 2/3 protocol's and Table 4's step, d = 4 and 20,
# U = 16 with C = 33 and 40 (two candidate passes), C = 0, every candidate
# in one bucket, d = 512 (a warp a row) and a fully masked user
QUERY_BWD_CASES = [(32, 256, 1, 128, 48, 3, "random"), (128, 256, 1, 32, 48, 3, "random"),
                   (32, 256, 1, 36, 48, 3, "random"), (4, 60, 3, 4, 12, 2, "random"),
                   (4, 60, 5, 20, 24, 3, "random"), (3, 60, 33, 32, 48, 4, "random"),
                   (3, 60, 40, 36, 48, 4, "random"), (3, 60, 0, 32, 48, 3, "random"),
                   (3, 60, 20, 32, 48, 3, "one-bucket"), (2, 60, 40, 512, 24, 3, "random"),
                   (3, 60, 8, 128, 48, 1, "masked")]


@pytest.mark.cuda
@pytest.mark.parametrize("case", QUERY_BWD_CASES, ids=[f"{c[0]}x{c[2]}-d{c[3]}-tau{c[5]}-{c[6]}"
                                                       for c in QUERY_BWD_CASES])
def test_sdim_query_backward_at_its_shapes(case, dev):
    """The redesigned tau <= 4 backward against its plain version (times
    each row's n: a zero row's gradient is g / 1e-6): the same bits on two
    launches, one launch a call, and the rows no candidate selects exactly
    +0 (the plain version may hold -0 there)."""
    B, L, C, d, m, tau, kind = case
    seq, q, mask, R, rng = _inputs((B, L, max(C, 1), d, m, tau), dev, seed=17)
    q = q[:, :C].contiguous()
    if kind == "one-bucket":                    # positive multiples of one candidate
        q = (q[:, :1] * torch.rand((B, C, 1), device=dev) + 0.5 * q[:, :1]).contiguous()
    if kind == "masked":
        mask[-1] = 0
    table = bse_encode_ref(seq, mask, R, tau)
    dout = torch.randn(q.shape, device=dev)
    before = sdim_query_backward.launches
    dT = sdim_query_backward(dout, q, table, R, tau)
    torch.cuda.synchronize()
    assert sdim_query_backward.launches == before + 1
    ref = sdim_query_backward_ref(dout, q, table, R, tau)
    n = torch.sqrt(torch.sum(table * table, -1, keepdim=True) + 1e-12)
    torch.testing.assert_close(dT * n, ref * n, **FP32)
    assert torch.equal(dT, sdim_query_backward(dout, q, table, R, tau))
    hits = torch.nn.functional.one_hot(simhash.signatures(q, R, tau).long(), 1 << tau)
    unselected = hits.sum(1) == 0                          # (B, G, U)
    assert not dT[unselected].view(torch.int32).any()      # +0: no sign bit
    if kind == "one-bucket":
        assert (hits.sum(1).gt(0).sum(-1) == 1).all()
    if kind == "masked":
        assert not table[-1].any() and dT[-1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("tau", [1, 2, 3, 4])
def test_sdim_query_backward_selects_the_forwards_buckets(tau, dev):
    """Unscreened candidates (two passes of them): the rows of dT the
    backward writes nonzero are exactly the buckets the forward kernel
    reads. A table whose row (g, u) is the unit vector e_{g U + u} (d >= G
    U) makes each answer of sdim_query show the candidate's bucket in every
    group (its nonzero columns)."""
    B, C, m = 32, 40, 48
    G, U = m // tau, 1 << tau
    d = max(128, G * U)
    gen = torch.Generator(device=dev).manual_seed(tau)
    q = torch.randn((B, C, d), generator=gen, device=dev)
    R = torch.randn((m, d), generator=gen, device=dev)
    dout = torch.randn((B, C, d), generator=gen, device=dev)
    table = torch.zeros((B, G, U, d), device=dev)
    k = torch.arange(G * U, device=dev)
    table.view(B, G * U, d)[:, k, k] = 1.0
    read = sdim_query(q, table, R, tau)[..., :G * U].reshape(B, C, G, U) > 0
    assert (read.sum(-1) == 1).all()
    dT = sdim_query_backward(dout, q, table, R, tau)
    assert torch.equal(dT.abs().sum(-1) > 0, read.any(1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [1, 3, 128])
@pytest.mark.parametrize("tau, m", [(5, 45), (10, 40)])
def test_sdim_query_large_tau_at_its_shapes(tau, m, C, dtype, dev):
    """sdim_query's tau 5..10 forward (sdim_fused_serve's gather body) at
    Table 4's width (d = 32) and phase 20's (d = 128) against its plain
    version, off fp32 and bf16 tables: the same bits on two launches and the
    same bits as sdim_fused_serve reading the same rows; with fp32 tables,
    decoupled (bse_encode's table read by sdim_query) equals inline
    (bse_serve) bit for bit."""
    for B, d in ((128, 32), (16, 128)):
        seq, q, mask, R = _phase20_inputs((B, 256, max(C, 2), d, m, tau), dev,
                                          torch.float32, seed=80 + tau)
        q = q[:, :C].contiguous()
        encoded = bse_encode(seq, mask, R, tau)
        table = encoded.to(dtype)
        before = sdim_query.launches
        out = sdim_query(q, table, R, tau)
        torch.testing.assert_close(out, sdim_query_ref(q, table, R, tau), **FP32)
        assert torch.equal(out, sdim_query(q, table, R, tau))
        slots = torch.arange(B, dtype=torch.int32, device=dev)
        assert torch.equal(out, sdim_fused_serve(table, slots, q, R, tau))
        torch.cuda.synchronize()
        assert sdim_query.launches == before + 2
        if dtype == torch.float32:
            assert torch.equal(out, bse_serve(q, seq, mask, R, tau))


def _target_backward_fp64(dout, q, seq, mask, out):
    """target_attention_flash_backward_ref's closed form summed in fp64 on
    the same fp32 inputs: (dq, dseq) fp64."""
    x, qf, do = seq.double(), q.double(), dout.double()
    scale = default_scale(q.shape[-1])
    valid = (mask > 0)[:, None, :]
    s = torch.einsum("bcd,bld->bcl", qf, x) * scale
    P = torch.softmax(torch.where(valid, s, torch.full((), -1e30, dtype=s.dtype,
                                                       device=s.device)), dim=-1)
    dP = torch.einsum("bcd,bld->bcl", do, x)
    dS = torch.where(valid, P * (dP - torch.sum(do * out.double(), dim=-1, keepdim=True)),
                     torch.zeros((), dtype=s.dtype, device=s.device))
    return (scale * torch.einsum("bcl,bld->bcd", dS, x),
            torch.einsum("bcl,bcd->bld", P, do) + scale * torch.einsum("bcl,bcd->bld", dS, qf))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CLUSTER_SHAPES + [(2, 70, 3, 256, 12, 2)])
def test_target_attention_flash_backward_kernel(shape, dtype, layout, dev):
    """dq and dseq against the plain version, at the training shape's C = 1
    and the shape's C, d up to 256; (B > 1) a fully masked last user:
    uniform weights, its rows get sum_c dout / L, its candidates nothing.
    dout comes from a generator of the test's own (the global CUDA
    generator's state depends on the tests run before), and the kernel and
    the plain version are each also held against the closed form summed in
    fp64."""
    seq, q, mask, _, rng = _inputs(shape, dev, dtype, seed=9)
    mask = _layout(mask, layout, rng)
    gen = torch.Generator(device=dev).manual_seed(9)
    tol = FP32 if dtype == torch.float32 else BF16_OUT
    for C in (1, shape[2]):
        qc = q[:, :C].contiguous()
        out = target_attention_flash(qc, seq, mask)
        dout = torch.randn(qc.shape, device=dev, generator=gen)
        before = target_attention_flash_backward.launches
        dq, dseq = target_attention_flash_backward(dout, qc, seq, mask, out)
        torch.cuda.synchronize()
        assert target_attention_flash_backward.launches == before + 1 and dseq.dtype == dtype
        rq, rseq = target_attention_flash_backward_ref(dout, qc, seq, mask, out)
        torch.testing.assert_close(dq, rq, **FP32)
        torch.testing.assert_close(dseq.float(), rseq.float(), **tol)
        eq, eseq = _target_backward_fp64(dout, qc, seq, mask, out)
        for name, got_q, got_seq in (("kernel", dq, dseq), ("plain", rq, rseq)):
            torch.testing.assert_close(got_q.double(), eq, **FP32, msg=lambda m: f"{name}: {m}")
            torch.testing.assert_close(got_seq.double(), eseq.to(dtype).double(), **tol,
                                       msg=lambda m: f"{name}: {m}")
        if shape[0] > 1:
            assert not dq[-1].any()


# the one-launch target attention backward (C = 1) at each way it splits a
# user: clusters of up to 8 (64 KB of rows a CTA; 128 KB at d = 256; 3 at
# d = 36), one user a CTA (the protocol's target kind), and 2, 4 or 8 users
# a CTA (folded retrieval; B = 2,049 leaves the last CTA short of users);
# bf16 at d = 36 with odd L: odd users' rows start off a 16-byte boundary
# and are copied 8 bytes at a time, an odd row count ends in an 8-byte tail
ONE_LAUNCH_SHAPES = [(32, 1024, 128), (128, 256, 32), (2048, 32, 128), (2049, 16, 32),
                     (512, 8, 32), (4, 1024, 256), (7, 301, 36), (2048, 33, 36)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["front", "prefix"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ONE_LAUNCH_SHAPES, ids=[str(s) for s in ONE_LAUNCH_SHAPES])
def test_target_attention_flash_backward_one_launch(shape, dtype, layout, dev):
    """The one-launch backward against the plain version at FP32 (BF16_OUT
    for a bf16 dseq), the same bits on two launches, at the split the
    wrapper takes: valid rows last (front-padded) or first (the retrieval
    kinds' top-k order), some users with one valid row, some with none
    (uniform weights, no gradient in the candidate)."""
    B, L, d = shape
    rng = np.random.default_rng(14)
    t = lambda x: torch.from_numpy(x).to(dev)
    seq = t(rng.standard_normal((B, L, d)).astype(np.float32)).to(dtype)
    q, dout = (t(rng.standard_normal((B, 1, d)).astype(np.float32)) for _ in range(2))
    n = rng.integers(0, L + 1, B)
    n[:3] = (0, 1, L)
    rows = np.arange(L)[None]
    mask = t(((rows >= L - n[:, None]) if layout == "front" else (rows < n[:, None]))
             .astype(np.float32))
    out = target_attention_flash(q, seq, mask)
    assert ta_launch_split(B, L, 1, d, seq.dtype, dev)[1] > 0
    before = target_attention_flash_backward.launches
    dq, dseq = target_attention_flash_backward(dout, q, seq, mask, out)
    again = target_attention_flash_backward(dout, q, seq, mask, out)
    torch.cuda.synchronize()
    assert target_attention_flash_backward.launches == before + 2
    assert torch.equal(dq, again[0]) and torch.equal(dseq, again[1]) and dseq.dtype == dtype
    rq, rseq = target_attention_flash_backward_ref(dout, q, seq, mask, out)
    torch.testing.assert_close(dq, rq, **FP32)
    torch.testing.assert_close(dseq.float(), rseq.float(),
                               **(FP32 if dtype == torch.float32 else BF16_OUT))
    assert not dq[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape, tau", [((32, 1024, 128), 1), ((32, 1024, 128), 2),
                                        ((32, 1024, 128), 3), ((32, 1024, 128), 4),
                                        ((128, 256, 32), 2), ((128, 256, 32), 3),
                                        ((128, 256, 32), 4), ((32, 1024, 36), 3)])
def test_bse_encode_backward_buckets_match_the_forward(shape, tau, dev):
    """On unscreened rows, the backward hashes every row into the bucket
    bse_encode puts it in, for every group: with dT[b, g, u, k] = u + 1
    where k = g (else 0), dseq[b, l, g] is the row's bucket in group g plus
    one, exactly (d >= G); the forward's bucket is the nonzero cell of
    bse_encode over one-row users."""
    B, L, d = shape
    m = tau * (48 // tau)
    G, U = m // tau, 1 << tau
    rng = np.random.default_rng(15)
    t = lambda x: torch.from_numpy(x).to(dev)
    R = t(rng.standard_normal((m, d)).astype(np.float32))
    seq = t(rng.standard_normal((B, L, d)).astype(np.float32))
    mask = torch.ones((B, L), device=dev)
    dT = torch.zeros((B, G, U, d), device=dev)
    g = torch.arange(G, device=dev)
    dT[:, g, :, g] = torch.arange(1, U + 1, dtype=torch.float32, device=dev)
    grad = bse_encode_backward(dT, seq, mask, R, tau)
    table = bse_encode(seq.reshape(B * L, 1, d), mask.reshape(B * L, 1), R, tau)
    bucket = table.abs().sum(-1).argmax(-1).reshape(B, L, G)
    assert torch.equal(grad[..., :G], (bucket + 1).float())


@pytest.mark.cuda
def test_backward_kernels_take_empty_shapes(dev):
    """L = 0 and C = 0: the wrappers return empty or zero gradients without
    a launch where there is nothing to do."""
    seq, q, mask, R, _ = _inputs((2, 0, 4, 32, 12, 2), dev)
    dT = torch.randn((2, 6, 4, 32), device=dev)
    assert bse_encode_backward(dT, seq, mask, R, 2).shape == (2, 0, 32)
    out = torch.zeros_like(q)
    dq, dseq = target_attention_flash_backward(torch.randn_like(q), q, seq, mask, out)
    assert not dq.any() and dseq.shape == (2, 0, 32)
    seq, q, mask, R, _ = _inputs((2, 40, 0, 32, 12, 2), dev)
    dq, dseq = target_attention_flash_backward(q, q, seq, mask, q)
    assert dq.shape == (2, 0, 32) and not dseq.any()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["bse_encode_backward", "sdim_query_backward",
                                    "target_attention_flash_backward"])
def test_backward_kernels_are_deterministic(kernel, dev):
    """No atomics: two launches on the same inputs agree bit for bit."""
    shape = (32, 1024, 128, 128, 48, 3)
    seq, q, mask, R, rng = _inputs(shape, dev, seed=10)
    mask = _layout(mask, "front", rng)
    if kernel == "bse_encode_backward":
        dT = torch.randn((32, 16, 8, 128), device=dev)
        run = lambda: bse_encode_backward(dT, seq, mask, R, 3)
    elif kernel == "sdim_query_backward":
        table, dout = bse_encode_ref(seq, mask, R, 3), torch.randn(q.shape, device=dev)
        run = lambda: sdim_query_backward(dout, q, table, R, 3)
    else:
        q1 = q[:, :1].contiguous()
        out, dout = target_attention_flash(q1, seq, mask), torch.randn(q1.shape, device=dev)
        run = lambda: torch.cat([g.reshape(-1) for g in target_attention_flash_backward(
            dout, q1, seq, mask, out)])
    assert torch.equal(run(), run())


@pytest.mark.cuda
def test_serving_wrappers_refuse_autograd(dev):
    """bse_serve, sdim_fused_serve and sdim_update have no backward: on the
    card they raise where autograd would record them, and run under
    no_grad or on inputs that need no gradient."""
    seq, q, mask, R, _ = _inputs((2, 64, 8, 32, 12, 2), dev)
    store = bse_encode_ref(seq, mask, R, 2)
    slots = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    events, ev_mask = seq[:, :5].contiguous(), mask[:, :5].contiguous()
    calls = {
        "bse_serve": lambda g: bse_serve(q, seq.clone().requires_grad_(g), mask, R, 2),
        "sdim_fused_serve": lambda g: sdim_fused_serve(store.clone().requires_grad_(g), slots,
                                                       q, R, 2),
        "sdim_update": lambda g: sdim_update(store.clone(), slots,
                                             events.clone().requires_grad_(g), ev_mask, R, 2),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}: the kernel has no backward"):
            call(True)
        with torch.no_grad():
            call(True)
        call(False)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sdim", "target"])
def test_ctr_loss_backward_reaches_item_emb_on_cuda(kind, dev):
    """CTRModel.loss(batch).backward() on the card (bse_encode + sdim_query,
    or target_attention_flash, and their backward kernels): every
    gradient, the item embeddings' through the long branch included, equals
    the same model's on the CPU (plain versions), with the item rows of
    what a step hashes margin-screened."""
    from repro_torch.data.synthetic import SyntheticCTRConfig, generate_batch_graded
    cfg = dataclasses.replace(sdim_paper.SMOKE, embed_dim=32, long_len=256,
                              interest=dataclasses.replace(sdim_paper.SMOKE.interest, kind=kind,
                                                           m=48, tau=3))
    dcfg = SyntheticCTRConfig(hist_len=256, n_items=cfg.n_items, n_cats=cfg.n_cats)
    batch = {k: torch.from_numpy(v) for k, v in generate_batch_graded(dcfg, 16, 5).items()}
    cpu = CTRModel(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    if kind == "sdim":
        screen_item_rows(cpu, [batch], torch.Generator().manual_seed(4))
        assert bool(item_rows_clear(cpu, *hashed_behaviors(cpu, batch)).all())
    gpu = CTRModel(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    counts = {f: f.launches for f in (bse_encode_backward, sdim_query_backward,
                                      target_attention_flash_backward)}
    for model, b in ((cpu, batch), (gpu, {k: v.to(dev) for k, v in batch.items()})):
        model.loss(b)[0].backward()
    torch.cuda.synchronize()
    launched = [f.__name__ for f, n in counts.items() if f.launches > n]
    assert launched == (["bse_encode_backward", "sdim_query_backward"] if kind == "sdim"
                        else ["target_attention_flash_backward"])
    for (name, p), (_, g) in zip(cpu.named_parameters(), gpu.named_parameters()):
        scale = float(p.grad.abs().max())
        torch.testing.assert_close(g.grad.cpu(), p.grad, atol=1e-4 * scale, rtol=1e-4,
                                   msg=name)
    short = set(batch["hist_items"][:, -cfg.short_len:].reshape(-1).tolist())
    short |= set(batch["cand_item"].tolist())
    long_only = sorted(set(batch["hist_items"][batch["hist_mask"] > 0].tolist()) - short)
    assert float(gpu.item_emb.weight.grad[long_only].abs().max()) > 0


# ---------------------------------------------------------------------------
# the Table 2/3 baselines on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("L", [16, 32])
def test_target_attention_flash_at_the_folded_retrieval_shape(L, dev):
    """Kernel 6 and its backward where the retrieval kinds call them: B·C =
    2,048 folded users of one candidate each over the L = k rows retrieved,
    valid rows first (top-k order), some with fewer than k (a masked tail)
    and some with none (fully masked: uniform over the k rows)."""
    rng = np.random.default_rng(L)
    n = 2048
    t = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev)
    q, seq = t(rng.standard_normal((n, 1, 128))), t(rng.standard_normal((n, L, 128)))
    found = rng.integers(0, L + 1, n)
    found[:3] = (0, L, 1)
    mask = t(np.arange(L)[None] < found[:, None])
    dout = t(rng.standard_normal((n, 1, 128)))
    before = (target_attention_flash.launches, target_attention_flash_backward.launches)
    out = target_attention_flash(q, seq, mask)
    dq, dseq = target_attention_flash_backward(dout, q, seq, mask, out)
    torch.cuda.synchronize()
    assert (target_attention_flash.launches, target_attention_flash_backward.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out, target_attention_flash_ref(q, seq, mask), **FP32)
    rq, rseq = target_attention_flash_backward_ref(dout, q, seq, mask, out)
    torch.testing.assert_close(dq, rq, **FP32)
    torch.testing.assert_close(dseq, rseq, **FP32)
    torch.testing.assert_close(out[0, 0], seq[0].mean(0), **FP32)


# the forward's folded body (C = 1, L <= 64: a warp a user): L 0..33 and
# 64, fp32 and bf16 rows at d = 128 and 36 (bf16 rows of 72 bytes), users
# of no, one and every valid row
FOLDED_LS = [0, 1, 2, 7, 8, 13, 16, 31, 32, 33, 64]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 36])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", FOLDED_LS)
def test_target_attention_flash_folded_body(L, dtype, d, dev):
    """target_attention_flash's folded body against its plain version at
    FP32 and against the cluster body (the same C entry point with no users
    a CTA), the same bits twice; a fully masked user attends uniformly
    over all L rows (L = 0: zeros)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.target_attn.target_attn import _scale

    n = 600
    rng = np.random.default_rng(L + d)
    t = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev)
    q = t(rng.standard_normal((n, 1, d)))
    seq = t(rng.standard_normal((n, L, d))).to(dtype)
    found = rng.integers(0, L + 1, n)
    found[:3] = (0, L, min(L, 1))
    mask = t(np.arange(L)[None] < found[:, None])
    assert ta_forward_split(n, L, 1, _build.sm_count(q.device)) > 0
    before = target_attention_flash.launches
    out = target_attention_flash(q, seq, mask)
    torch.cuda.synchronize()
    assert target_attention_flash.launches == before + 1
    torch.testing.assert_close(out, target_attention_flash_ref(q, seq, mask), **FP32)
    assert torch.equal(out, target_attention_flash(q, seq, mask))
    uniform = seq[0].float().mean(0) if L else torch.zeros(d, device=dev)
    torch.testing.assert_close(out[0, 0], uniform, **FP32)
    if L:
        cluster = torch.empty_like(out)
        err = _build.load().sdim_target_attention(
            q.data_ptr(), seq.data_ptr(), _build.DTYPE_CODES[dtype], mask.data_ptr(),
            cluster.data_ptr(), n, L, 1, d, _scale(d), 0, _build.stream(q.device))
        _build.check(err, "target_attention_flash (cluster body)")
        torch.testing.assert_close(out, cluster, **FP32)


@pytest.mark.cuda
def test_target_attention_flash_main_shape_keeps_the_cluster_body(dev):
    """The forward's split: the main path's burst (C = 128 over L = 1,024),
    the protocol's target kind (C = 1 over L = 256) and C > 1 over short
    histories run the cluster body; C = 1 over at most 64 rows the folded
    body; the main shape within FP32 of its plain version, the same bits
    twice."""
    from repro_torch.kernels import _build

    n_sm = _build.sm_count(torch.device("cuda", torch.cuda.current_device()))
    assert ta_forward_split(16, 1024, 128, n_sm) == 0
    assert ta_forward_split(128, 256, 1, n_sm) == 0
    assert ta_forward_split(2048, 32, 8, n_sm) == 0
    assert ta_forward_split(2048, 32, 1, n_sm) == 8 and ta_forward_split(128, 16, 1, n_sm) == 1
    seq, q, mask, _, rng = _inputs((16, 1024, 128, 128, 48, 3), dev, seed=35)
    mask = _layout(mask, "front", rng)
    out = target_attention_flash(q, seq, mask)
    torch.testing.assert_close(out, target_attention_flash_ref(q, seq, mask), **FP32)
    assert torch.equal(out, target_attention_flash(q, seq, mask))


def _interest_inputs(kind, R, rng, dev, B=4, C=16, L=256, d=128):
    """q, seq (hash-screened against R), a ragged mask with user 1 fully
    masked, and category ids, on the CPU and on ``dev``."""
    seq = screened_normal(rng, (B, L, d), R)
    q = screened_normal(rng, (B, C, d), R)
    lengths = rng.integers(L // 4, L + 1, B)
    lengths[1] = 0
    mask = (np.arange(L)[None] >= (L - lengths[:, None])).astype(np.float32)
    seq_cat = rng.integers(0, 8, (B, L)).astype(np.int32)
    q_cat = rng.integers(0, 8, (B, C)).astype(np.int32)
    host = [torch.from_numpy(x) for x in (q, seq, mask, seq_cat, q_cat)]
    return host, [x.to(dev) for x in host]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["avg", "sim_hard", "eta", "ubr4ctr", "din_mlp",
                                  "sdim_expected"])
def test_interest_kind_on_cuda_matches_cpu(kind, dev):
    """Each new interest kind on the card (the retrieval kinds through
    target_attention_flash and its backward kernel) against the same
    module on the CPU (plain versions): the output and the gradients in q
    and seq, at d = 128, L = 256, C = 16, k = 32. ETA's inputs clear the
    hash margin; ubr4ctr's top-k boundaries are apart (``topk_clear``)."""
    from repro_torch.core.interest import InterestConfig, InterestModule
    from repro_torch.kernels.screen import topk_clear

    cfg = InterestConfig(kind=kind, d=128, m=48, tau=3, top_k=32)
    cpu = InterestModule(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    gpu = InterestModule(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    R = (cpu.R if kind == "eta" else torch.randn(48, 128)).numpy()
    for _ in range(100):
        host, card = _interest_inputs(kind, R, rng, dev)
        if kind != "ubr4ctr":
            break
        with torch.no_grad():
            q, seq, mask = host[:3]
            s = torch.einsum("bcp,blp->bcl", cpu.ubr.wq(q), cpu.ubr.wk(seq)).double()
            s = torch.where(mask[:, None] > 0, s, float("-inf"))
        if topk_clear(s.numpy(), cfg.top_k).all():
            break
    retrieval = kind in ("sim_hard", "eta", "ubr4ctr")
    before = (target_attention_flash.launches, target_attention_flash_backward.launches)
    w = torch.from_numpy(rng.standard_normal((4, 16, 128)).astype(np.float32))
    grads = []
    for mod, (q, seq, mask, seq_cat, q_cat), ww in ((cpu, host, w), (gpu, card, w.to(dev))):
        q, seq = q.clone().requires_grad_(True), seq.clone().requires_grad_(True)
        out = mod(q, seq, mask, seq_cat=seq_cat, q_cat=q_cat)
        (out * ww).sum().backward()
        dq = torch.zeros_like(q) if q.grad is None else q.grad      # avg: q only broadcasts
        grads.append((out.detach().cpu(), dq.cpu(), seq.grad.cpu()))
    torch.cuda.synchronize()
    assert (target_attention_flash.launches > before[0]) == retrieval
    assert (target_attention_flash_backward.launches > before[1]) == retrieval
    for name, ours, ref in zip(("out", "dq", "dseq"), grads[1], grads[0]):
        torch.testing.assert_close(ours, ref, msg=name, **ATOMIC)


@pytest.mark.cuda
def test_srht_sdim_runs_kernels_1_and_4(dev):
    """An sdim engine of the SRHT family on the card: the same dense R as on
    the CPU, ``attend`` through bse_encode and sdim_query (and their
    backward kernels) against the CPU's plain versions."""
    from repro_torch.core.engine import EngineConfig, SDIMEngine

    cfg = EngineConfig(m=48, tau=3, d=128, family="srht")
    cpu, gpu = SDIMEngine(cfg, device="cpu"), SDIMEngine(cfg, device=dev)
    assert torch.equal(gpu.R.cpu(), cpu.R)
    rng = np.random.default_rng(2)
    host, card = _interest_inputs("sdim", cpu.R.numpy(), rng, dev, C=32)
    counts = {f: f.launches for f in (bse_encode, sdim_query, bse_encode_backward,
                                      sdim_query_backward)}
    res = []
    for eng, (q, seq, mask, _, _) in ((cpu, host), (gpu, card)):
        seq = seq.clone().requires_grad_(True)
        out = eng.attend(q, seq, mask)
        out.sum().backward()
        res.append((out.detach().cpu(), seq.grad.cpu()))
    torch.cuda.synchronize()
    assert all(f.launches == n + 1 for f, n in counts.items())
    torch.testing.assert_close(res[1][0], res[0][0], **ATOMIC)
    torch.testing.assert_close(res[1][1], res[0][1], **ATOMIC)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["none", "avg", "sim_hard", "eta", "ubr4ctr", "din_mlp",
                                  "sdim", "target"])
def test_table23_protocol_on_cuda_matches_cpu(kind, dev):
    """Five AdamW steps of the Table 2/3 protocol (``bench.common.train``,
    batch 128, L = 256) from one initialization on the card and on the CPU:
    the same losses at fp32 tolerance, then the same eval scores on one
    batch of 1,024. Rows that a hash or a top-k decides are screened on
    the CPU model first (the eval batch's too)."""
    from repro_torch.bench import common, table23_auc
    from repro_torch.data.pipeline import DeterministicStream
    from repro_torch.data.synthetic import generate_batch_graded
    from repro_torch.kernels.screen import screen_topk_rows

    kw = dict(table23_auc.BASELINES).get(kind, {})
    dcfg, cfg = common.paper_data_config(256), common.paper_model_config(kind, **kw)
    cpu = CTRModel(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    seeds = DeterministicStream(None, base_seed=0)          # bench.common.train's stream
    stream = [generate_batch_graded(dcfg, 128, seeds.seed_for(i)) for i in range(5)]
    stream.append(generate_batch_graded(dcfg, common.EVAL_BATCH, common.EVAL_SEED0))
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in stream]
    if kind in ("eta", "sdim"):
        screen_item_rows(cpu, batches, torch.Generator().manual_seed(1))
    if kind == "ubr4ctr":
        screen_topk_rows(cpu, batches, torch.Generator().manual_seed(1))
    gpu = CTRModel(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    runs = [common.train(m, dcfg, 5, 128, seed=0, lr=5e-3) for m in (cpu, gpu)]
    torch.testing.assert_close(torch.from_numpy(runs[1]["losses"]),
                               torch.from_numpy(runs[0]["losses"]), **FP32)
    scores = [common.evaluate(m, dcfg, common.EVAL_BATCH)[1] for m in (cpu, gpu)]
    torch.testing.assert_close(torch.from_numpy(scores[1]), torch.from_numpy(scores[0]), **FP32)


# ---------------------------------------------------------------------------
# the production runtime on the card: async ingest, copy on write, streams
# ---------------------------------------------------------------------------
RT_D, RT_M, RT_TAU, RT_ITEMS = 32, 12, 2, 64


def _runtime_parts(dev, seed=0):
    """(engine on ``dev``, embed_fn on ``dev``) over one margin-screened
    behavior table of RT_ITEMS rows (cats ignored)."""
    from repro_torch.core.engine import EngineConfig, SDIMEngine
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((RT_M, RT_D)).astype(np.float32)
    table = torch.from_numpy(screened_normal(rng, (RT_ITEMS, RT_D), R)).to(dev)
    engine = SDIMEngine(EngineConfig(m=RT_M, tau=RT_TAU, d=RT_D), R=torch.from_numpy(R).to(dev),
                        device=dev)

    def embed(params, items, cats):
        return table[torch.as_tensor(np.asarray(items) % RT_ITEMS, device=dev)]
    return engine, embed


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", ["fp32", "int8"])
def test_read_during_inflight_fold_returns_previous_version(table_dtype, dev):
    """A fold held up on the writer's stream (a device sleep ahead of it)
    and on the host (a gate inside the embedding): reads of the held view
    and fetches through the server return the previous committed bits
    meanwhile; after the commit the new version holds the fold."""
    import threading
    from repro_torch.serve.bse_server import BSEServer

    engine, embed = _runtime_parts(dev)
    gate, stall = threading.Event(), threading.Event()

    def slow_embed(params, items, cats):
        if stall.is_set():
            torch.cuda._sleep(200_000_000)        # ~0.1 s of the writer stream
            assert gate.wait(30)
        return embed(params, items, cats)

    srv = BSEServer(slow_embed, None, engine, wire_dtype=torch.float32,
                    table_dtype=table_dtype, async_ingest=True, device=dev)
    rt = srv.async_ingest
    users = [f"u{i}" for i in range(8)]
    srv.ingest_histories(users, np.arange(8 * 16).reshape(8, 16) % RT_ITEMS, np.zeros((8, 16)))
    rt.flush()
    before = srv.fetch_many(users).clone()
    view = rt.committed
    stall.set()
    srv.ingest_events(users * 4, np.arange(32) % RT_ITEMS, np.zeros(32))
    rt.start()                                    # one drain takes all 32
    while rt._q:                                  # until the writer holds them
        threading.Event().wait(0.001)
    during = srv.fetch_many(users)
    assert rt.committed is view
    assert torch.equal(during, before)
    gate.set()
    while rt.committed is view:                   # host side of the fold done
        threading.Event().wait(0.001)
    held = view.rows(view.lookup(users)[0])       # the device fold may still run
    assert torch.equal(held, before)
    assert rt.stop() is True and rt.error is None
    after = srv.fetch_many(users)
    assert not torch.equal(after, before)
    stall.clear()
    sync = BSEServer(embed, None, engine, wire_dtype=torch.float32, table_dtype=table_dtype,
                     device=dev)
    sync.ingest_histories(users, np.arange(8 * 16).reshape(8, 16) % RT_ITEMS, np.zeros((8, 16)))
    sync.ingest_events(users * 4, np.arange(32) % RT_ITEMS, np.zeros(32))
    assert torch.equal(after, sync.fetch_many(users))


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", ["fp32", "bf16", "int8", "fp8"])
def test_tiered_store_on_card_matches_cpu(table_dtype, dev, tmp_path):
    """One sequence through a tiered store (hot 4, warm 2, cold) on the card
    and on the CPU: the same tiers, TierStats and misses; rows within
    bse_encode's tolerance (fp32) or one storage step; a snapshot taken on
    the card restores on the CPU bit for bit."""
    from repro_torch.serve.bse_server import BSEServer

    servers = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        engine, embed = _runtime_parts(d)
        servers[name] = BSEServer(embed, None, engine, wire_dtype=torch.float32,
                                  table_dtype=table_dtype, hot_capacity=4, warm_capacity=2,
                                  store_dir=str(tmp_path / name), device=d)
    rng = np.random.default_rng(1)
    users = [f"u{i}" for i in range(10)]
    hist = rng.integers(0, RT_ITEMS, (10, 24))
    ev_users = [users[int(i)] for i in rng.integers(0, 10, 12)]
    ev = rng.integers(0, RT_ITEMS, (12, 3))
    outs = {}
    for name, srv in servers.items():
        srv.ingest_histories(users, hist, np.zeros_like(hist))
        srv.ingest_events(ev_users, ev, np.zeros_like(ev))
        outs[name] = [srv.fetch_many(users[:4]).cpu(), srv.fetch_many(users[4:8]).cpu()]
        srv.evict("u3")
        outs[name].append(srv.fetch_many(users).cpu())
    a, b = servers["cuda"].store, servers["cpu"].store
    assert {u: a.tier(u) for u in users} == {u: b.tier(u) for u in users}
    assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)
    tol = {"fp32": ATOMIC, "bf16": dict(atol=5e-2, rtol=2e-2)}.get(table_dtype)
    for x, y in zip(outs["cuda"], outs["cpu"]):
        if tol is None:                            # int8 / fp8: one storage step
            step = (1 / 127 if table_dtype == "int8" else 32 / 448) * 1.01
            assert torch.all((x - y).abs() <= step * y.abs().amax(-1, keepdim=True) + 1e-6)
        else:
            torch.testing.assert_close(x, y, **tol)
    snap = servers["cuda"].snapshot(str(tmp_path / "snap"))
    engine, embed = _runtime_parts(torch.device("cpu"))
    back = BSEServer.restore(snap, embed, None, engine, device="cpu",
                             store_dir=str(tmp_path / "restored"))
    for u in users:
        x, y = a.row(u), back.store.row(u)
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x.cpu().view(torch.uint8), y.view(torch.uint8)), u


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", ["fp32", "int8"])
def test_sharded_store_on_card_matches_single_device(table_dtype, dev):
    """Eight shards on one card (``(cuda:0,) * 8``) against one store on
    it, fed the same random ingest / event / evict sequence (the fp32 event
    fold through ``update_sharded``, one ``sdim_update`` a shard; int8
    through the read-modify-write), then fused reads with a miss through
    ``serve_fused_sharded`` (one ``sdim_fused_serve`` a shard): rows and
    interest bit for bit, since a masked launch adds nothing."""
    from repro_torch.serve.bse_server import BSEServer
    from torch_sharded_parity import ASK_MISS, apply, random_ops

    engine, embed = _runtime_parts(dev)
    mesh = (torch.device("cuda", torch.cuda.current_device()),) * 8
    single, sharded = (BSEServer(embed, None, engine, wire_dtype=torch.float32, capacity=4,
                                 table_dtype=table_dtype, mesh=m, device=dev)
                       for m in (None, mesh))
    ops, order = random_ops(0)
    apply(single, ops)
    before = sdim_update.launches
    apply(sharded, ops)
    folds = sum(op[0] == "events" for op in ops)
    if table_dtype == "fp32":
        assert sdim_update.launches - before == 8 * folds
    assert torch.equal(single.fetch_many(order), sharded.fetch_many(order))
    q = embed(None, np.random.default_rng(2).integers(0, RT_ITEMS, (5, 7)), None)
    ask = [order[3], ASK_MISS, order[-1], order[0], order[3]]
    before = sdim_fused_serve.launches
    got = sharded.serve_candidates(ask, q)
    assert sdim_fused_serve.launches - before == 8
    assert torch.equal(got, single.serve_candidates(ask, q)) and not got[1].any()
    assert max(sharded.store.shard_load()) - min(sharded.store.shard_load()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["none", "avg", "sim_hard", "ubr4ctr", "eta", "sdim",
                                  "sdim_expected", "target", "din_mlp"])
def test_training_on_the_card_is_bit_reproducible(kind, dev):
    """Fault C5, closed: two runs of 5 AdamW steps of the Table 2/3
    protocol's model (d = 32, L = 256, batch 128) from one seed end with
    parameters of equal bits; sdim_expected's where they are finite (its
    gradient is not, fault C2). The fault was PyTorch's embedding backward
    on CUDA, whose sums over an id repeated thousands of times (80
    categories in a batch of long histories) came out in another order
    from run to run."""
    from repro_torch.bench.common import bit_differences, trained_params
    from repro_torch.bench.table23_auc import BASELINES

    kw = dict(BASELINES).get(kind, {})
    a, b = (trained_params(kind, 5, device=dev, **kw) for _ in range(2))
    assert bit_differences(a, b) == []


@pytest.mark.cuda
@pytest.mark.parametrize("vocab", [80, 8000])
def test_embedding_backward_on_card_is_deterministic(vocab, dev):
    """The port's embedding lookup (``nn.layers.embedding``) at a batch of
    long histories' shape, 128 x 256 ids of a vocabulary of 80 (each id
    ~400 times) or 8,000: four backward passes give the same bits, within
    FP32 of the CPU's."""
    from repro_torch.nn.layers import embedding

    g = torch.Generator(device=dev).manual_seed(vocab)
    ids = torch.randint(0, vocab, (128, 256), device=dev, generator=g)
    dout = torch.randn((128, 256, 16), device=dev, generator=g)
    w = torch.randn((vocab, 16), device=dev, generator=g, requires_grad=True)
    grads = []
    for _ in range(4):
        w.grad = None
        (embedding(ids, w) * dout).sum().backward()
        grads.append(w.grad.clone())
    assert all(torch.equal(grads[0].view(torch.int32), x.view(torch.int32)) for x in grads[1:])
    wc = w.detach().cpu().requires_grad_()
    (embedding(ids.cpu(), wc) * dout.cpu()).sum().backward()
    torch.testing.assert_close(grads[0].cpu(), wc.grad, atol=1e-4, rtol=1e-5)


# the SDIM-KV read of LM decode: kernel 4 with one table row per (b, kv
# head) and that head's query heads as the candidates (B*Hkv, Gq, head_dim)
LM_LAYOUTS = [  # (B, Hkv, Gq, head_dim, S)
    (1, 8, 4, 128, 256),      # qwen3-8b
    (4, 8, 4, 128, 64),
    (2, 8, 4, 64, 64),        # granite-3-2b
    (1, 8, 12, 128, 64),      # command-r-plus-104b
]
# numpy seed per LM arch at SMOKE (weights, R and tokens; ``_numpy_lm``):
# every key and query the CPU run hashes over 8 tokens (B = 2) clears 1e-4
# (asserted)
LM_CARD_SEEDS = {"granite-3-2b": 24, "qwen3-8b": 23, "command-r-plus-104b": 29,
                 "deepseek-moe-16b": 20, "deepseek-v2-236b": 38}


@torch.no_grad()
def _numpy_lm(model, seed: int):
    """Redraw every matrix of an LM and its R from numpy's generator, whose
    numbers do not depend on the torch build: N(0, 1/fan_in) for
    projections (the experts' (E, d_in, d_out) stacks too), N(0, 0.02²) for
    the embedding, N(0, 1) for R; norm scales stay ones."""
    rng = np.random.default_rng(seed)
    for name, p in model.named_parameters():
        if p.ndim == 2:
            std = 0.02 if name.startswith("embed") else 1 / np.sqrt(p.shape[1])
            p.copy_(torch.from_numpy((rng.standard_normal(p.shape) * std).astype(np.float32)))
        elif p.ndim == 3:
            std = 1 / np.sqrt(p.shape[1])
            p.copy_(torch.from_numpy((rng.standard_normal(p.shape) * std).astype(np.float32)))
    model.R.copy_(torch.from_numpy(rng.standard_normal(model.R.shape).astype(np.float32)))
    model.R64.copy_(model.R)
    return rng


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LM_LAYOUTS)
def test_sdim_query_at_the_lm_decode_layout(layout, dev):
    """Kernel 4 against its plain version on tables folded from screened
    keys (``core/sdim.kv_bucket_table``), through ``sdim_decode_attention``
    (the kernel layout) against the tables repeated per query head on the
    plain version; the same bits on two launches."""
    from repro_torch.core import sdim

    B, Hkv, Gq, d, S = layout
    m, tau = 48, 3
    rng = np.random.default_rng(S + d)
    R = rng.standard_normal((m, d)).astype(np.float32)
    k = torch.from_numpy(screened_normal(rng, (B, S, Hkv, d), R)).to(dev)
    v = torch.from_numpy(rng.standard_normal((B, S, Hkv, d)).astype(np.float32)).to(dev)
    q = torch.from_numpy(screened_normal(rng, (B, 1, Hkv * Gq, d), R)).to(dev)
    Rt = torch.from_numpy(R).to(dev)
    vt, ct = sdim.kv_bucket_table(k, v, None, Rt, tau)
    before = sdim_query.launches
    out = sdim.sdim_decode_attention(q, vt, ct, Rt, tau)
    torch.cuda.synchronize()
    assert sdim_query.launches == before + 1 and out.shape == (B, 1, Hkv * Gq, d)
    qk = q.reshape(B, Hkv, Gq, d).reshape(B * Hkv, Gq, d).contiguous()
    table = vt.reshape(B * Hkv, m // tau, 1 << tau, d)
    torch.testing.assert_close(sdim_query(qk, table, Rt, tau),
                               sdim_query_ref(qk, table, Rt, tau), **FP32)
    assert torch.equal(sdim_query(qk, table, Rt, tau), sdim_query(qk, table, Rt, tau))
    rep = vt.repeat_interleave(Gq, dim=1).reshape(B * Hkv * Gq, m // tau, 1 << tau, d)
    want = sdim_query_ref(q.reshape(B * Hkv * Gq, 1, d), rep, Rt, tau)
    torch.testing.assert_close(out.reshape(-1, 1, d), want, **FP32)


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", list(LM_CARD_SEEDS))
def test_lm_smoke_decode_on_the_card_matches_the_cpu(arch_id, dev, monkeypatch):
    """An LM arch at SMOKE (weights and R from numpy, the same on both
    devices): 8 tokens (B = 2) of exact and SDIM-compressed decode on
    the card against the CPU, logits within 1e-4 at every step, caches
    within FP32, the count tables equal; the card's SDIM path launches
    sdim_query once a layer and step."""
    from repro_torch.configs import registry
    from repro_torch.core import sdim
    from repro_torch.kernels.screen import clears_margin
    from repro_torch.models.lm import LMModel

    seed = LM_CARD_SEEDS[arch_id]
    cfg = registry.get(arch_id).SMOKE
    cpu = LMModel(cfg, device="cpu")
    rng = _numpy_lm(cpu, seed)
    card = LMModel(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32))
    hashed = []
    fold, attend = sdim.kv_bucket_fold, sdim.sdim_decode_attention

    def rec_fold(vt, ct, k, v, R, tau):
        if k.device.type == "cpu":
            hashed.append(k.numpy().reshape(-1, k.shape[-1]))
        fold(vt, ct, k, v, R, tau)

    def rec_attend(q, *args, **kw):
        if q.device.type == "cpu":
            hashed.append(q.numpy().reshape(-1, q.shape[-1]))
        return attend(q, *args, **kw)

    monkeypatch.setattr(sdim, "kv_bucket_fold", rec_fold)
    monkeypatch.setattr(sdim, "sdim_decode_attention", rec_attend)
    runs = {}
    with torch.no_grad():
        for name, model in (("cpu", cpu), ("card", card)):
            t = toks.to(model.device)
            cache, scache = model.init_cache(2, 8, torch.float32), model.init_sdim_cache(2)
            logits, slogits = [], []
            before = sdim_query.launches
            for i in range(8):
                logits.append(model.decode_step(t[:, i:i + 1], cache, i)[0].cpu())
                slogits.append(model.sdim_decode_step(t[:, i:i + 1], scache)[0].cpu())
            runs[name] = (logits, slogits, cache, scache, sdim_query.launches - before)
    assert clears_margin(np.concatenate(hashed), cpu.R.numpy(), 1e-4).all()
    keys = runs["cpu"][2]["stack"].get("ckv", runs["cpu"][2]["stack"].get("k"))
    assert clears_margin(keys.reshape(-1, keys.shape[-1]).numpy(), cpu.R.numpy(), 1e-4).all()
    (lc, sc, cc, scc, _), (lg, sg, cg, scg, launched) = runs["cpu"], runs["card"]
    for i in range(8):
        torch.testing.assert_close(lg[i], lc[i], atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(sg[i], sc[i], atol=1e-4, rtol=1e-4)
    for name in cc["stack"]:
        torch.testing.assert_close(cg["stack"][name].cpu(), cc["stack"][name], **FP32)
    for got, want in zip(cg.get("dense", []), cc.get("dense", [])):
        for name in want:
            torch.testing.assert_close(got[name].cpu(), want[name], **FP32)
    assert torch.equal(scg["ct"].cpu(), scc["ct"])
    torch.testing.assert_close(scg["vt"].cpu(), scc["vt"], **FP32)
    assert launched == 8 * cfg.n_scan_layers
    enc = card.encode_sdim_cache_from_kv(cg)
    assert torch.equal(enc["ct"], card.encode_sdim_cache_from_kv(cg)["ct"])
    assert torch.equal(enc["vt"], card.encode_sdim_cache_from_kv(cg)["vt"])


# LM training at SMOKE (numpy-drawn weights, the same on both devices): the
# MoE archs' seeds put every token's top_k-th and (top_k + 1)-th router
# probabilities more than ROUTE_GAP apart in fp32 and bf16 compute, so the
# two devices route alike (asserted on the CPU)
LM_TRAIN_SEEDS = {"granite-3-2b": 24, "qwen3-8b": 23, "command-r-plus-104b": 29,
                  "deepseek-moe-16b": 3, "deepseek-v2-236b": 33}
ROUTE_GAP = 1e-2


def _lm_train_pair(arch_id, dev, **over):
    """(CPU model, card model) of an LM arch at SMOKE with ``over`` replaced,
    on numpy-drawn weights, and the numpy generator after the draw."""
    from repro_torch.configs import registry
    from repro_torch.models.lm import LMModel

    cfg = dataclasses.replace(registry.get(arch_id).SMOKE, **over)
    cpu = LMModel(cfg, device="cpu")
    rng = _numpy_lm(cpu, LM_TRAIN_SEEDS[arch_id])
    card = LMModel(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    return cpu, card, rng


def _loss_and_grads(model, toks):
    for p in model.parameters():
        p.grad = None
    t = toks.to(model.device)
    loss = model.loss(t[:, :-1], t[:, 1:])
    loss.backward()
    return loss.detach().cpu(), {n: p.grad.cpu() for n, p in model.named_parameters()}


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch_id", list(LM_TRAIN_SEEDS))
def test_lm_smoke_loss_and_gradients_on_the_card_match_the_cpu(arch_id, compute_dtype, dev,
                                                               monkeypatch):
    """An LM arch's loss and every parameter's gradient (remat "full") on
    the card against the CPU: fp32 within atol 1e-5 of the largest gradient
    and rtol 1e-5, bf16 compute within 2e-2 of the largest and rtol 2e-2;
    the MoE archs' routes apart by ROUTE_GAP on the CPU."""
    from repro_torch.nn.moe import MoELayer

    cpu, card, rng = _lm_train_pair(arch_id, dev, compute_dtype=compute_dtype, remat="full")
    toks = torch.from_numpy(rng.integers(0, cpu.cfg.vocab, (2, 9)).astype(np.int32))
    gaps, route = [], MoELayer._route

    def recorded(self, x):
        out = route(self, x)
        if x.device.type == "cpu":
            top = torch.sort(out[0].detach(), dim=-1, descending=True).values
            gaps.append(float((top[..., self.top_k - 1] - top[..., self.top_k]).min()))
        return out

    monkeypatch.setattr(MoELayer, "_route", recorded)
    loss, grads = _loss_and_grads(cpu, toks)
    card_loss, card_grads = _loss_and_grads(card, toks)
    assert (len(gaps) > 0) == (cpu.cfg.moe is not None) and min(gaps, default=1.0) > ROUTE_GAP
    rel = 1e-5 if compute_dtype == "float32" else 2e-2
    torch.testing.assert_close(card_loss, loss, atol=rel * float(loss.abs()), rtol=rel)
    atol = rel * max(float(g.abs().max()) for g in grads.values())
    for name, g in grads.items():
        assert bool(torch.isfinite(card_grads[name]).all()), name
        torch.testing.assert_close(card_grads[name], g, atol=atol, rtol=rel, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", list(LM_TRAIN_SEEDS))
def test_lm_remat_gives_the_same_bits_on_the_card(arch_id, dev):
    """Each remat policy's loss and gradients equal "none"'s bit for bit on
    the card, in fp32 and bf16 compute."""
    for compute_dtype in ("float32", "bfloat16"):
        runs = {}
        for remat in ("none", "full", "dots", "dots_no_batch"):
            _, card, rng = _lm_train_pair(arch_id, dev, compute_dtype=compute_dtype,
                                          remat=remat)
            toks = torch.from_numpy(rng.integers(0, card.cfg.vocab, (2, 33)).astype(np.int32))
            runs[remat] = _loss_and_grads(card, toks)
        loss, grads = runs.pop("none")
        for remat, (r_loss, r_grads) in runs.items():
            assert torch.equal(r_loss, loss), (remat, compute_dtype)
            for name, g in grads.items():
                assert torch.equal(r_grads[name], g), (remat, compute_dtype, name)


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", list(LM_TRAIN_SEEDS))
def test_lm_training_on_the_card_is_bit_reproducible(arch_id, dev):
    """Two trainings of 3 AdamW steps (``launch.train.lm_setup`` through
    ``train.loop.run``, remat "full", batches of 4 x 64 tokens of a
    128-token vocabulary: every id repeats) from the same weights end with
    parameters and moments of the same bits."""
    from repro_torch.launch.train import lm_setup
    from repro_torch.train.loop import LoopConfig, run

    states = []
    for _ in range(2):
        _, card, _ = _lm_train_pair(arch_id, dev, remat="full")
        loss_fn, stream, opt = lm_setup(card.cfg, 4, 64, 3)
        out = run(loss_fn, card, stream, opt, LoopConfig(n_steps=3, log_every=1))
        assert all(np.isfinite(m["loss"]) for _, m in out["history"])
        states.append(out["state"])
    a, b = states
    for (name, x), (_, y) in zip(a["model"].state_dict().items(), b["model"].state_dict().items()):
        assert torch.equal(x, y), name
    for moment in ("m", "v"):
        for name, x in a["opt"][moment].items():
            assert torch.equal(x, b["opt"][moment][name]), (moment, name)


# kernel 4's wide path (csrc/wide_query.cuh): (B, C, d, m, tau); the
# kernel's entry point takes it wherever the fused body's shared memory does
# not fit a CTA (every width here; d <= 256 at m = 48 keeps the fused body)
WIDE_SHAPES = [
    (1, 128, 512, 48, 3),     # deepseek-v2's SDIM-KV read: one table, 128 heads
    (8, 128, 512, 48, 3),     # B = 8
    (3, 300, 516, 48, 3),     # d % 8 == 4, ragged C (3 passes of 128, the last of 44)
    (2, 33, 1024, 48, 3),     # 32 float4 columns a CTA
    (4, 70, 512, 36, 3),      # G = 12
    (2, 5, 512, 48, 4),       # U = 16
]


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_sdim_query_wide_path(shape, table_dtype, dev):
    """The wide path against the plain version on screened candidates, a
    zero table (a user with no keys) reading zero, the same bits on two
    launches; C = 0 launches nothing."""
    B, C, d, m, tau = shape
    rng = np.random.default_rng(d + C)
    R = rng.standard_normal((m, d)).astype(np.float32)
    q = torch.from_numpy(screened_normal(rng, (B, C, d), R)).to(dev)
    table = torch.from_numpy(rng.standard_normal((B, m // tau, 1 << tau, d)).astype(
        np.float32)).to(dev).to(table_dtype)
    table[-1, :, 1] = 0                       # some empty buckets
    if B > 1:
        table[0] = 0
    Rt = torch.from_numpy(R).to(dev)
    before = sdim_query.launches
    out = sdim_query(q, table, Rt, tau)
    torch.cuda.synchronize()
    assert sdim_query.launches == before + 1
    torch.testing.assert_close(out, sdim_query_ref(q, table, Rt, tau), **FP32)
    if B > 1:
        assert not out[0].any()
    assert torch.equal(out, sdim_query(q, table, Rt, tau))
    empty = sdim_query(q[:, :0].contiguous(), table, Rt, tau)
    assert empty.shape == (B, 0, d)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [36, 128, 256])
def test_sdim_query_fused_path_is_kernel_3s_body(d, dev):
    """At every fused width kernel 4 takes the fused body unchanged: its
    output equals kernel 3's (sdim_fused_serve with user b on slot b, every
    user present) bit for bit, and the plain version within FP32."""
    B, C, m, tau = 4, 128, 48, 3
    rng = np.random.default_rng(d)
    R = rng.standard_normal((m, d)).astype(np.float32)
    q = torch.from_numpy(screened_normal(rng, (B, C, d), R)).to(dev)
    table = torch.from_numpy(rng.standard_normal((B, m // tau, 1 << tau, d)).astype(
        np.float32)).to(dev)
    Rt = torch.from_numpy(R).to(dev)
    out = sdim_query(q, table, Rt, tau)
    slots = torch.arange(B, dtype=torch.int32, device=dev)
    assert torch.equal(out, sdim_fused_serve(table, slots, q, Rt, tau))
    torch.testing.assert_close(out, sdim_query_ref(q, table, Rt, tau), **FP32)


@pytest.mark.cuda
def test_sdim_query_raises_where_no_path_launches(dev):
    """A width that overflows a CTA even on the wide path's smallest plan
    (d = 16,384: one candidate, R read from device memory and chunks of one
    group, 262 KB against a CTA's 227 KB of shared memory) raises; it never
    falls back to the plain version. (d = 8,192, which raised before the
    wide path read R from device memory, now launches it: held against the
    plain version.)"""
    B, C, m, tau = 1, 4, 48, 3
    launches = sdim_query.launches
    for d in (8192, 16384):
        q = torch.zeros((B, C, d), device=dev)
        q[..., ::3] = 1.0
        table = torch.ones((B, m // tau, 1 << tau, d), device=dev)
        R = torch.ones((m, d), device=dev)
        if d == 8192:
            torch.testing.assert_close(sdim_query(q, table, R, tau),
                                       sdim_query_ref(q, table, R, tau), **FP32)
            continue
        with pytest.raises(ValueError, match="does not fit the wide path"):
            sdim_query(q, table, R, tau)
    assert sdim_query.launches == launches + 1


# the GNN at SMOKE widths on the card (fp32): 4,096 edges over 512 nodes, so
# every node id repeats in the gathers and the segment sums
GNN_NODES, GNN_EDGES = 512, 4096


def _gnn_card(dev, remat=False, seed=0):
    """(GatedGCN at SMOKE on the card, seeded init; its full graph)."""
    from repro_torch.configs import registry
    from repro_torch.data.graph import random_graph
    from repro_torch.models.gnn import GatedGCN

    cfg = dataclasses.replace(registry.get("gatedgcn").SMOKE, remat=remat)
    model = GatedGCN(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    g = random_graph(GNN_NODES, GNN_EDGES, cfg.d_feat, seed=seed, n_classes=cfg.n_classes)
    g["edge_mask"] = (np.random.default_rng(seed).uniform(size=GNN_EDGES) > 0.2).astype(
        np.float32)
    return model, {k: torch.as_tensor(v, device=dev) for k, v in g.items()}


def _gnn_loss_and_grads(model, g, **kw):
    for p in model.parameters():
        p.grad = None
    loss = model.loss(g, **kw)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.cuda
def test_gnn_training_on_the_card_is_bit_reproducible(dev):
    """Two trainings of 3 AdamW steps of GatedGCN (SMOKE widths, ids
    repeating) from one seed end with parameters of the same bits (the
    gathers' and segment sums' gradients add without atomics); remat gives
    the loss and gradients of no remat bit for bit."""
    from repro_torch.data.pipeline import DeterministicStream
    from repro_torch.launch.train import gnn_setup
    from repro_torch.train.loop import LoopConfig, run

    states = []
    for _ in range(2):
        model, g = _gnn_card(dev)
        loss_fn, _, opt = gnn_setup(model.cfg)
        batch = {k: v.cpu().numpy() for k, v in g.items()}
        out = run(loss_fn, model, DeterministicStream(lambda seed: dict(batch), 0), opt,
                  LoopConfig(n_steps=3, log_every=1))
        assert all(np.isfinite(m["loss"]) for _, m in out["history"])
        states.append(out["state"]["model"].state_dict())
    for name, x in states[0].items():
        assert torch.equal(x, states[1][name]), name
    off = _gnn_loss_and_grads(*_gnn_card(dev, remat=False))
    on = _gnn_loss_and_grads(*_gnn_card(dev, remat=True))
    assert torch.equal(on[0], off[0])
    for name, g in off[1].items():
        assert torch.equal(on[1][name], g), name


@pytest.mark.cuda
@pytest.mark.parametrize("axes", [("data", "model"), ("model",)])
def test_gnn_edge_sharded_on_the_card_matches_one_device(axes, dev):
    """The edges over 8 (4) blocks on this one card against the one-device
    path: the loss within 1e-5, every gradient within 1e-4 of the
    largest."""
    from repro_torch.distributed.mesh_ctx import MeshCtx

    model, g = _gnn_card(dev)
    mesh = MeshCtx((dev,) * 4, data=2)
    loss, grads = _gnn_loss_and_grads(model, g)
    s_loss, s_grads = _gnn_loss_and_grads(model, g, mesh=mesh, axes=axes)
    assert abs(float(s_loss) - float(loss)) < 1e-5
    atol = 1e-4 * max(float(v.abs().max()) for v in grads.values())
    for name, v in grads.items():
        torch.testing.assert_close(s_grads[name], v, atol=atol, rtol=0, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", ["qwen3-8b", "deepseek-v2-236b"])
def test_sp_decode_on_the_card_matches_decode_step(arch_id, dev):
    """``sp_decode_step`` at SMOKE (numpy-drawn weights) over 8 sequence
    shards on this one card, the MoE experts over 4 expert shards, against
    ``decode_step`` at the same position after 11 steps: logits within 1e-4
    of the largest; the new rows within 1e-5 of what ``decode_step``
    writes; the cache untouched."""
    from repro_torch.configs import registry
    from repro_torch.distributed.mesh_ctx import MeshCtx
    from repro_torch.models.lm import LMModel

    cfg = registry.get(arch_id).SMOKE
    cpu = LMModel(cfg, device="cpu")
    rng = _numpy_lm(cpu, LM_TRAIN_SEEDS[arch_id])
    model = LMModel(cfg, device=dev)
    model.load_state_dict(cpu.state_dict())
    for layer in model.modules():
        if hasattr(layer, "capacity_factor"):          # nothing drops
            layer.capacity_factor = layer.n_experts / layer.top_k
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 12)).astype(np.int32)).to(dev)
    ctx = MeshCtx((dev,) * 4, data=2, data_axes=None, seq_axes=("data", "model"))
    with torch.no_grad():
        cache = model.init_cache(4, 16, torch.float32)
        for i in range(11):
            model.decode_step(toks[:, i:i + 1], cache, i)
        before = {k: v.clone() for k, v in cache["stack"].items()}
        logits, new = model.sp_decode_step(toks[:, 11:], cache, 11, ctx)
        for k, v in before.items():
            assert torch.equal(cache["stack"][k], v), k
        exact, cache = model.decode_step(toks[:, 11:], cache, 11)
    assert float((logits - exact).abs().max()) < 1e-4 * float(exact.abs().max())
    for name, rows in new["stack"].items():
        written = cache["stack"][name][:, :, :, 11] if name in ("k", "v") else \
            cache["stack"][name][:, :, 11]
        torch.testing.assert_close(rows[:, :, 0], written, **FP32)


@pytest.mark.cuda
def test_manual_tp_ffn_at_granite_width_on_the_card(dev):
    """``manual_tp_gated_ffn`` at granite-3-2b's FFN width (d 2048, d_ff
    8192) over a (2, 4) mesh of this card against the plain FFN: within
    2e-2 of the largest output (bf16 products and sums); its gradients
    reach x and every weight."""
    from repro_torch.distributed.manual_tp import manual_tp_gated_ffn
    from repro_torch.distributed.mesh_ctx import MeshCtx
    from repro_torch.nn.layers import GatedMLP

    g = torch.Generator(device=dev).manual_seed(0)
    ffn = GatedMLP(2048, 8192, device=dev, generator=g)
    x = torch.randn((2, 256, 2048), generator=g, device=dev, requires_grad=True)
    mesh = MeshCtx((dev,) * 4, data=2)
    y = manual_tp_gated_ffn(x, ffn, mesh)
    ref = ffn(x)
    assert y.dtype == torch.float32 and y.device == x.device
    scale = float(ref.detach().abs().max())
    assert float((y - ref).detach().abs().max()) < 2e-2 * scale
    y.sum().backward()
    assert x.grad is not None and all(p.grad is not None for p in ffn.parameters())


@pytest.mark.cuda
def test_compressed_psum_on_card_blocks(dev):
    """``compressed_psum`` over two data blocks on the card: every block
    of the result on the card, equal, within one int8 step of the mean."""
    from repro_torch.train.compression import compressed_psum

    g = torch.Generator(device=dev).manual_seed(1)
    blocks = [{"w": torch.randn((64, 48), generator=g, device=dev),
               "b": torch.randn(48, generator=g, device=dev)} for _ in range(2)]
    out = compressed_psum(blocks)
    for k in blocks[0]:
        mean = (blocks[0][k] + blocks[1][k]) / 2
        step = max(float(b[k].abs().max()) for b in blocks) / 127
        for o in out:
            assert o[k].device.type == "cuda"
            assert float((o[k] - mean).abs().max()) <= step
        assert torch.equal(out[0][k], out[1][k])
        assert out[0][k].data_ptr() != out[1][k].data_ptr()


@pytest.mark.cuda
def test_restore_on_mesh_places_card_blocks(dev, tmp_path):
    """An LM SMOKE tree saved whole restores onto a (2, 4) mesh of this
    card: every block on the card (no host copy left), every gathered
    leaf equal to the saved one."""
    from repro_torch.configs import registry
    from repro_torch.distributed.mesh_ctx import MeshCtx
    from repro_torch.distributed.sharding import flatten, gather, param_spec, valid_for_mesh
    from repro_torch.models.lm import LMModel
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.elastic import restore_on_mesh
    from repro_torch.weights import export_lm_params

    params = export_lm_params(LMModel(registry.get("deepseek-v2-236b").SMOKE, device="cpu",
                                      generator=torch.Generator().manual_seed(0)))
    ck.save(str(tmp_path), 0, {"params": params})
    mesh = MeshCtx((dev,) * 4, data=2)
    restored, _ = restore_on_mesh(
        str(tmp_path), {"params": params}, mesh,
        lambda path, shape: valid_for_mesh(param_spec("lm", path, shape), shape, mesh))
    placed, saved = flatten(restored), flatten({"params": params})
    assert placed.keys() == saved.keys()
    assert any(len(leaf.blocks) == 4 for leaf in placed.values())
    for path, leaf in placed.items():
        want = saved[path]
        assert all(b.device.type == "cuda" for b in leaf.blocks)
        assert torch.equal(gather(leaf).cpu(), torch.from_numpy(want))


# ---------------------------------------------------------------------------
# Every length, event count and table size the Pallas kernels take: the
# paths past the shared-memory lists and copies (sdim_update's chunks past
# UPDATE_LT_MAX_E events a row, bse_encode's spans past MAX_L behaviors,
# bse_encode_backward's spills past MAX_BWD_SMEM and its device-R layout,
# sdim_query_backward's chunks past MAX_BWD_CANDS candidates)
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E", [UPDATE_LT_MAX_E + 1, 20000])
@pytest.mark.parametrize("d", [128, 36])
@pytest.mark.parametrize("tau", [5, 10])
def test_large_tau_sdim_update_in_chunks(tau, d, E, dtype, dev):
    """Rows of more than UPDATE_LT_MAX_E events take the chunked fold: four
    batch rows on two slots (a duplicate slot) and slot 0 (a zero-mask row),
    against the plain version at FP32; the cells no weighted event reached
    keep their bits (-0.0 included); slot 0 is untouched; the same bits on
    two launches, one launch a call."""
    from repro_torch.kernels.sdim_update.sdim_update import update_large_tau_path

    assert update_large_tau_path(E) == "chunked" and update_large_tau_path(8192) == "sorted"
    store, slots, events, mask, R = _update_case((2, 16, 8, d, 4 * tau, tau), "dups", dev,
                                                 dtype, E=E, seed=60 + tau)
    assert len(set(slots.tolist()[1:])) < 3                 # a slot with two rows
    a, b, c = store.clone(), store.clone(), store.clone()
    before = sdim_update.launches
    sdim_update(a, slots, events, mask, R, tau)
    sdim_update(c, slots, events, mask, R, tau)
    torch.cuda.synchronize()
    assert sdim_update.launches == before + 2
    sdim_update_ref(b, slots, events, mask, R, tau)
    _check_update(store, a, b, slots, events, mask, R)
    assert torch.equal(a.view(torch.int32), c.view(torch.int32))
    assert torch.equal(a[0].view(torch.int32), store[0].view(torch.int32))


def _long_history(L, d, m, tau, dev, seed, B=2):
    """B users of L behaviors (screened, d = 128) whose masks hold wholly
    masked tiles: rows [1,000, 5,000) and [L - 3,000, L - 1,000) off, the
    rest valid at random; the last user fully masked."""
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((m, d)).astype(np.float32)
    seq = screened_normal(rng, (B, L, d), R)
    mask = (rng.random((B, L)) > 0.25).astype(np.float32)
    mask[:, 1000:5000] = 0
    mask[:, L - 3000:L - 1000] = 0
    mask[-1] = 0
    t = lambda x: torch.from_numpy(x).to(dev)
    return t(seq), t(mask), t(R), rng


def _exact_table(seq, mask, R, tau):
    """bse_encode's plain version (``core.sdim.bucket_table``'s one-hot
    product) with its sums in fp64 (the fp32 hash bits: screened rows),
    rounded to fp32 once. Over ~27,000 valid rows a user the fp32 plain
    version's own sums miss the fp64 sums past ATOMIC at tau 3 (|T| up to
    ~1,700), where the kernel's stay within it (chip_smoke's phase 21 (a)
    prints both)."""
    onehot = torch.nn.functional.one_hot(simhash.signatures(seq, R, tau).long(), 1 << tau)
    onehot = onehot.double() * mask.double()[..., None, None]
    return torch.einsum("blgu,bld->bgud", onehot, seq.double()).float()


@pytest.mark.cuda
@pytest.mark.parametrize("tau", [3, 5, 10])
@pytest.mark.parametrize("L", [MAX_L + 1, 40000])
def test_bse_encode_in_spans(L, tau, dev):
    """Users of more than MAX_L behaviors are listed in spans: the table
    against the plain version summed in fp64 (ATOMIC; ``_exact_table``),
    the fully masked user's all +0, the same bits on two launches, one
    launch a call; the backward takes the same L (FP32, same bits)."""
    from repro_torch.kernels.sdim_bucket.sdim_bucket import encode_spans

    assert encode_spans(L) == 2 and encode_spans(MAX_L) == 1
    m = 48 if tau == 3 else 4 * tau
    seq, mask, R, rng = _long_history(L, 128, m, tau, dev, seed=70 + tau)
    before = bse_encode.launches
    table = bse_encode(seq, mask, R, tau)
    torch.testing.assert_close(table, _exact_table(seq, mask, R, tau), **ATOMIC)
    assert torch.equal(table, bse_encode(seq, mask, R, tau))
    torch.cuda.synchronize()
    assert bse_encode.launches == before + 2
    assert not table[-1].view(torch.int32).any()
    dT = torch.from_numpy(rng.standard_normal(table.shape).astype(np.float32)).to(dev)
    dseq = bse_encode_backward(dT, seq, mask, R, tau)
    torch.testing.assert_close(dseq, bse_encode_backward_ref(dT, seq, mask, R, tau), **FP32)
    assert torch.equal(dseq, bse_encode_backward(dT, seq, mask, R, tau))


# bse_encode_backward where a user's dT and R exceed MAX_BWD_SMEM (tau <= 4:
# dT from device memory, "spill"; R too at m = 500, "spill_r") and where R and
# a round's ids do not fit a CTA (tau 5, m = 500: R alone is 256,000 B;
# LT_BWD_DEVICE), (m, tau, d, layout)
SPILL_CASES = [(96, 4, 128, "spill"), (192, 3, 128, "spill"), (500, 4, 128, "spill_r"),
               (500, 5, 128, "device")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SPILL_CASES, ids=[f"m{c[0]}-tau{c[1]}-{c[3]}"
                                                   for c in SPILL_CASES])
def test_bse_encode_backward_past_shared_memory(case, dtype, dev):
    """The spilled layouts against the plain version (FP32; one bf16 step
    where dseq is bf16) at every split the wrapper could take, ragged masks
    with a fully masked last user (+0), the same bits twice; then through
    autograd (bse_encode's BSEEncodeFn) on the card."""
    from repro_torch.kernels.sdim_bucket.sdim_bucket import (LT_BWD_DEVICE, backward_layout,
                                                             launch_large_tau_split,
                                                             launch_splits)

    m, tau, d, layout = case
    B, L = 4, 1024
    G, U = m // tau, 1 << tau
    seq, _, mask, R, rng = _inputs((B, L, 1, d, m, tau), dev, dtype, seed=80 + m)
    mask = _layout(mask, "random", rng)
    dT = torch.from_numpy(rng.standard_normal((B, G, U, d)).astype(np.float32)).to(dev)
    if tau <= 4:
        assert backward_layout(G, U, d, m) == layout
        splits = sorted({1, 2, launch_splits(B, L, G, d, tau, dtype, dev)})
    else:
        fits, S = launch_large_tau_split(B, L, G, d, tau, dtype, dev)
        assert fits == LT_BWD_DEVICE
        splits = sorted({1, 2, S})
    ref = bse_encode_backward_ref(dT, seq, mask, R, tau)
    tol = BF16_OUT if dtype == torch.bfloat16 else FP32
    for S in splits:
        before = bse_encode_backward.launches
        out = bse_encode_backward_cuda(dT, seq, mask, R, tau, S)
        torch.testing.assert_close(out.float(), ref.float(), **tol)
        assert torch.equal(out, bse_encode_backward_cuda(dT, seq, mask, R, tau, S))
        torch.cuda.synchronize()
        assert bse_encode_backward.launches == before + 2
        assert not out[-1].view(torch.int16 if dtype == torch.bfloat16 else torch.int32).any()
    leaf = seq.clone().requires_grad_(True)
    (bse_encode(leaf, mask, R, tau) * dT).sum().backward()
    torch.testing.assert_close(leaf.grad.float(), ref.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16385, 40000])
@pytest.mark.parametrize("tau", [5, 10])
def test_large_tau_sdim_query_backward_in_chunks(tau, C, dev):
    """More than MAX_BWD_CANDS candidates a user are listed in chunks: dT
    against the plain version (times each row's n: a zero row's gradient is
    g / 1e-6), the same bits twice, one launch a call, the rows no candidate
    selects exactly +0; half the candidates are the user's own behaviors,
    so many rows are selected by candidates of several chunks."""
    from repro_torch.kernels.sdim_query.sdim_query import (MAX_BWD_CANDS,
                                                           query_backward_large_tau_path)

    assert query_backward_large_tau_path(C) == "chunked"
    assert query_backward_large_tau_path(MAX_BWD_CANDS) == "lists"
    B, L, d, m = 2, 1024, 128, 4 * tau
    seq, q, mask, R, rng = _inputs((B, L, C, d, m, tau), dev, seed=90 + tau)
    own = torch.from_numpy(rng.integers(0, L, (B, C // 2))).to(dev)
    q[:, :C // 2] = seq[torch.arange(B, device=dev)[:, None], own]
    table = bse_encode_ref(seq, mask, R, tau)
    dout = torch.randn(q.shape, device=dev)
    before = sdim_query_backward.launches
    dT = sdim_query_backward(dout, q, table, R, tau)
    torch.cuda.synchronize()
    assert sdim_query_backward.launches == before + 1
    ref = sdim_query_backward_ref(dout, q, table, R, tau)
    n = torch.sqrt(torch.sum(table * table, -1, keepdim=True) + 1e-12)
    torch.testing.assert_close(dT * n, ref * n, **FP32)
    assert torch.equal(dT, sdim_query_backward(dout, q, table, R, tau))
    hits = torch.nn.functional.one_hot(simhash.signatures(q, R, tau).long(), 1 << tau)
    unselected = hits.sum(1) == 0                          # (B, G, U)
    assert not dT[unselected].view(torch.int32).any()      # +0: no sign bit
    sig = simhash.signatures(q, R, tau).long()             # rows selected in both chunks
    first, rest = (torch.zeros((B, m // tau, 1 << tau), dtype=torch.bool, device=dev)
                   for _ in range(2))
    b_, c_, g_ = torch.meshgrid(torch.arange(B, device=dev), torch.arange(C, device=dev),
                                torch.arange(m // tau, device=dev), indexing="ij")
    early = c_ < MAX_BWD_CANDS
    first[b_[early], g_[early], sig[early]] = True
    rest[b_[~early], g_[~early], sig[~early]] = True
    assert (first & rest).any()
