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
    sdim_update, sdim_update_cuda, sdim_update_ref, update_cells)
from repro_torch.kernels.target_attn.target_attn import (
    target_attention_flash, target_attention_flash_backward,
    target_attention_flash_backward_ref, target_attention_flash_ref)
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
]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", LARGE_TAU_SHAPES)
def test_large_tau_kernels(shape, dtype, layout, dev):
    """tau 5..10: bse_encode (fp32|bf16 behaviors), sdim_query (off the
    fp32 table and its bf16 wire copy) and both backward kernels against
    their plain versions; two launches give the same bits; a fully masked
    user gets a zero table and gradient."""
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
    torch.testing.assert_close(dT, sdim_query_backward_ref(dout, q, table, R, tau), **FP32)
    assert torch.equal(dT, sdim_query_backward(dout, q, table, R, tau))
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
    """bse_encode takes tau 1..10, d a multiple of 4 up to 128 (one float4
    column a lane) and L up to MAX_L (its batch list lives in shared
    memory); sdim_fused_serve takes tau 1..4 and sdim_query tau 1..10 (d up
    to 128 above tau 4), a user's table in whole 16-byte loads and 16-byte
    aligned operands; sdim_update takes
    tau 1..4, d a multiple of 4 up to 128, 1..G group slices that keep a
    CTA at update_cells(d) cells, and 16-byte aligned operands."""
    seq, q, mask, R, rng = _inputs((2, 64, 16, 136, 10, 5), dev)
    with pytest.raises(ValueError, match="d a multiple of 4 up to 128"):
        bse_encode(seq, mask, R[:8].contiguous(), 2)             # d = 136
    with pytest.raises(ValueError, match="tau 1..10"):
        bse_encode(seq[..., :128].contiguous(), mask, torch.zeros((11, 128), device=dev), 11)
    with pytest.raises(ValueError, match="d a multiple of 4"):
        bse_encode(seq[..., :10].contiguous(), mask, R[:8, :10].contiguous(), 2)
    long_seq = torch.zeros((1, MAX_L + 8, 16), device=dev)
    with pytest.raises(ValueError, match="L up to"):
        bse_encode(long_seq, torch.ones((1, MAX_L + 8), device=dev), R[:8, :16].contiguous(), 2)
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
    with pytest.raises(ValueError, match="d up to 128 above tau 4"):
        sdim_query(q[:2, :, :136].contiguous(), torch.zeros((2, 1, 32, 136), device=dev),
                   R[:5, :136].contiguous(), 5)
    table = torch.zeros((2, 4, 4, 8), device=dev)
    shifted_t = torch.empty(table.numel() + 1, device=dev)[1:].view(table.shape)
    with pytest.raises(ValueError, match="16-byte boundary"):
        sdim_query(q8, shifted_t, R[:8, :8].contiguous(), 2)
    # sdim_update: d = 10 and d = 136, tau 5, too few or too many slices, a shifted store
    ev = torch.zeros((2, 3, 8), device=dev)
    ev_mask = torch.ones((2, 3), device=dev)
    store8 = torch.zeros((4, 4, 4, 8), device=dev)
    with pytest.raises(ValueError, match="d a multiple of 4 up to 128"):
        sdim_update(torch.zeros((4, 4, 4, 10), device=dev), slots,
                    torch.zeros((2, 3, 10), device=dev), ev_mask, R[:8, :10].contiguous(), 2)
    with pytest.raises(ValueError, match="d a multiple of 4 up to 128"):
        sdim_update(torch.zeros((4, 4, 4, 136), device=dev), slots,
                    torch.zeros((2, 3, 136), device=dev), ev_mask, R[:8].contiguous(), 2)
    with pytest.raises(ValueError, match="tau 1..4"):
        sdim_update(torch.zeros((4, 2, 32, 8), device=dev), slots, ev, ev_mask,
                    R[:10, :8].contiguous(), 5)
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
    """Against the plain version: the wrapper's row chunks, one chunk a
    user and one per 8 rows; wholly masked leading rows, valid rows only at
    the end, and (B > 1) a fully masked last user, whose gradient is 0."""
    seq, _, mask, R, rng = _inputs(shape, dev, dtype, seed=7)
    B, L, tau = shape[0], shape[1], shape[-1]
    mask = _layout(mask, layout, rng)
    G, U, d = shape[4] // tau, 1 << tau, shape[3]
    dT = torch.randn((B, G, U, d), device=dev)
    S = {"auto": None, "one": 1, "rows": -(-L // 8)}[splits]
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


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CLUSTER_SHAPES + [(2, 70, 3, 256, 12, 2)])
def test_target_attention_flash_backward_kernel(shape, dtype, layout, dev):
    """dq and dseq against the plain version, at the training shape's C = 1
    and the shape's C, d up to 256; (B > 1) a fully masked last user:
    uniform weights, its rows get sum_c dout / L, its candidates nothing."""
    seq, q, mask, _, rng = _inputs(shape, dev, dtype, seed=9)
    mask = _layout(mask, layout, rng)
    for C in (1, shape[2]):
        qc = q[:, :C].contiguous()
        out = target_attention_flash(qc, seq, mask)
        dout = torch.randn(qc.shape, device=dev)
        before = target_attention_flash_backward.launches
        dq, dseq = target_attention_flash_backward(dout, qc, seq, mask, out)
        torch.cuda.synchronize()
        assert target_attention_flash_backward.launches == before + 1 and dseq.dtype == dtype
        rq, rseq = target_attention_flash_backward_ref(dout, qc, seq, mask, out)
        torch.testing.assert_close(dq, rq, **FP32)
        torch.testing.assert_close(dseq.float(), rseq.float(),
                                   **(FP32 if dtype == torch.float32 else BF16_OUT))
        if shape[0] > 1:
            assert not dq[-1].any()


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
    """A width whose column slices overflow a CTA even on the wide path (d =
    8,192: 512 KB of table columns a CTA) raises; it never falls back to
    the plain version."""
    B, C, d, m, tau = 1, 4, 8192, 48, 3
    q = torch.zeros((B, C, d), device=dev)
    table = torch.zeros((B, m // tau, 1 << tau, d), device=dev)
    with pytest.raises(RuntimeError, match="sdim_query: CUDA error"):
        sdim_query(q, table, torch.ones((m, d), device=dev), tau)


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
