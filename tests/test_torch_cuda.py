"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Imports torch and ``repro_torch`` only (no JAX), so it runs on a GPU
host that has no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test skips inside itself where there is no CUDA. Inputs are margin-
screened (``repro_torch.kernels.screen``), so kernel and plain version agree
on every hash bit. Tolerances: fp32 atol 1e-5 / rtol 1e-5 (sums in another
order); atol 1e-4 for sdim_update and for bse_encode once L is split over
blocks (global atomics add in any order); bf16 / int8 operands are read
identically by both, so fp32 tolerances hold there too.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.screen import screened_normal
from repro_torch.kernels.sdim_bucket.sdim_bucket import bse_encode, bse_encode_ref
from repro_torch.kernels.sdim_fused_serve.sdim_fused_serve import (
    sdim_fused_serve, sdim_fused_serve_ref)
from repro_torch.kernels.sdim_query.sdim_query import sdim_query, sdim_query_ref
from repro_torch.kernels.sdim_update.sdim_update import sdim_update, sdim_update_ref
from repro_torch.serve.quant import quantize_rows

SHAPES = [  # (B, L, C, d, m, tau)
    (1, 40, 8, 32, 12, 2),
    (3, 300, 70, 64, 24, 4),
    (4, 1024, 128, 128, 48, 3),
    (32, 16, 128, 128, 48, 3),   # an event fold's encode: L in one block per user
]
FP32 = dict(atol=1e-5, rtol=1e-5)
ATOMIC = dict(atol=1e-4, rtol=1e-5)


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
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_sdim_query_kernel(shape, table_dtype, dev):
    seq, q, mask, R, _ = _inputs(shape, dev)
    table = bse_encode_ref(seq, mask, R, shape[-1]).to(table_dtype)
    torch.testing.assert_close(sdim_query(q, table, R, shape[-1]),
                               sdim_query_ref(q, table, R, shape[-1]), **FP32)


@pytest.mark.cuda
@pytest.mark.parametrize("store_dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("shape", SHAPES)
def test_sdim_fused_serve_kernel(shape, store_dtype, dev):
    B, L, C, d, m, tau = shape
    _, q, _, R, rng = _inputs(shape, dev)
    N = 2 * B + 1
    rows = torch.from_numpy(rng.standard_normal((N, m // tau, 1 << tau, d)).astype(
        np.float32)).to(dev)
    scales = None
    if store_dtype == "int8":
        store, scales = quantize_rows(rows, dtype=torch.int8)
    else:
        store = rows.to(torch.bfloat16 if store_dtype == "bf16" else torch.float32)
    slots = torch.tensor(rng.integers(0, N, B), dtype=torch.int32, device=dev)
    present = torch.ones(B, device=dev)
    present[::2] = 0
    out = sdim_fused_serve(store, slots, q, R, tau, scales=scales, present=present)
    ref = sdim_fused_serve_ref(store, slots, q, R, tau, scales=scales, present=present)
    torch.testing.assert_close(out, ref, **FP32)
    assert not out[::2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_sdim_update_kernel(shape, dev):
    B, L, C, d, m, tau = shape
    E = min(L, 16)
    rng = np.random.default_rng(1)
    R = rng.standard_normal((m, d)).astype(np.float32)
    events = torch.from_numpy(screened_normal(rng, (2 * B, E, d), R)).to(dev)
    mask = torch.from_numpy((rng.random((2 * B, E)) > 0.2).astype(np.float32)).to(dev)
    mask[0] = 0                                              # zero-mask row at slot 0
    slots = torch.tensor(np.r_[0, rng.integers(1, B + 1, 2 * B - 1)], dtype=torch.int32,
                         device=dev)                         # duplicates accumulate
    store = torch.randn((B + 1, m // tau, 1 << tau, d), device=dev)
    a, b = store.clone(), store.clone()
    assert sdim_update(a, slots, events, mask, torch.from_numpy(R).to(dev), tau) is a
    sdim_update_ref(b, slots, events, mask, torch.from_numpy(R).to(dev), tau)
    torch.testing.assert_close(a, b, **ATOMIC)
    if not (slots[1:] == 0).any():
        assert torch.equal(a[0], store[0])


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernel_does_not_take(dev):
    seq, q, mask, R, _ = _inputs(SHAPES[0], dev)
    with pytest.raises(ValueError):
        bse_encode(seq, mask.cpu(), R, 2)                     # mixed devices
    with pytest.raises(ValueError):
        bse_encode(seq.transpose(1, 2).contiguous().transpose(1, 2), mask, R, 2)
    with pytest.raises(TypeError):
        sdim_query(q.double(), bse_encode_ref(seq, mask, R, 2), R, 2)
