"""Port parity, kernel modules: each of the four kernel wrappers' plain
PyTorch versions against the JAX package's Pallas kernel run in interpret
mode (as tests/test_kernels.py runs it), on margin-screened inputs; plus
the wrapper contract (CPU tensors run the plain version and count no
launch, CUDA is never faked). The CUDA kernels themselves are held against
the plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py.

Tolerances: fp32 atol 1e-5 / rtol 1e-5 (the same sums in another order);
bf16 inputs rtol 2e-2 / atol 1e-2, as tests/test_kernels.py:46-47.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sdim_bucket.sdim_bucket import bse_encode as jbse_encode
from repro.kernels.sdim_fused_serve.sdim_fused_serve import \
    sdim_fused_serve as jsdim_fused_serve
from repro.kernels.sdim_query.sdim_query import sdim_query as jsdim_query
from repro.kernels.sdim_update.sdim_update import sdim_update as jsdim_update
from repro.serve import quant as jquant
from repro_torch.kernels import _build
from repro_torch.kernels.screen import screened_normal
from repro_torch.kernels.sdim_bucket.sdim_bucket import bse_encode, bse_encode_ref
from repro_torch.kernels.sdim_fused_serve.sdim_fused_serve import (
    sdim_fused_serve, sdim_fused_serve_ref)
from repro_torch.kernels.sdim_query.sdim_query import sdim_query, sdim_query_ref
from repro_torch.kernels.sdim_update.sdim_update import sdim_update, sdim_update_ref

SHAPES = [
    # (B, L, C, d, m, tau, block_l, block_c): the two smallest of
    # tests/test_kernels.py SHAPES, then full width d=128, m=48, tau=3
    (1, 128, 8, 32, 12, 2, 64, 8),
    (2, 256, 128, 64, 48, 3, 128, 128),
    (2, 64, 16, 128, 48, 3, 64, 16),
]
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
FP32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=1e-2, rtol=2e-2)


def _inputs(B, L, C, d, m, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((m, d)).astype(np.float32)
    seq = screened_normal(rng, (B, L, d), R, dtype)
    q = screened_normal(rng, (B, C, d), R)
    mask = (rng.random((B, L)) > 0.25).astype(np.float32)
    return seq, q, mask, R, rng


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_bse_encode_plain_matches_pallas(shape, dtype):
    B, L, C, d, m, tau, block_l, _ = shape
    tdt, jdt = DTYPES[dtype]
    seq, _, mask, R, _ = _inputs(B, L, C, d, m, tdt)
    out = bse_encode_ref(_t(seq, tdt), _t(mask), _t(R), tau)
    ref = jbse_encode(jnp.asarray(seq, jdt), jnp.asarray(mask), jnp.asarray(R), tau,
                      block_l=block_l, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               **(FP32 if dtype == "fp32" else BF16))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_sdim_query_plain_matches_pallas(shape, dtype):
    B, L, C, d, m, tau, _, block_c = shape
    tdt, jdt = DTYPES[dtype]
    seq, q, mask, R, _ = _inputs(B, L, C, d, m, seed=1)
    table = np.asarray(bse_encode_ref(_t(seq), _t(mask), _t(R), tau))
    out = sdim_query_ref(_t(q), _t(table, tdt), _t(R), tau)
    ref = jsdim_query(jnp.asarray(q), jnp.asarray(table, jdt), jnp.asarray(R), tau,
                      block_c=block_c, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FP32)


@pytest.mark.parametrize("store_dtype", ["fp32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("shape", SHAPES)
def test_sdim_fused_serve_plain_matches_pallas(shape, store_dtype):
    B, L, C, d, m, tau, _, block_c = shape
    G, U = m // tau, 1 << tau
    _, q, _, R, rng = _inputs(B, L, C, d, m, seed=2)
    N = B + 3
    rows = rng.standard_normal((N, G, U, d)).astype(np.float32)
    slots = rng.integers(0, N, B).astype(np.int32)
    present = np.ones(B, np.float32)
    present[-1] = 0.0                               # ragged: last user absent
    scales = jscales = None
    if store_dtype in ("int8", "fp8"):
        jdt = jquant.TABLE_DTYPES[store_dtype]
        jstore, jscales = jquant.quantize_rows(jnp.asarray(rows), dtype=jdt)
        store = _t(np.asarray(jstore).view(np.uint8)).view(
            {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[store_dtype])
        scales = _t(np.asarray(jscales))
    else:
        tdt, jdt = DTYPES[store_dtype]
        store, jstore = _t(rows, tdt), jnp.asarray(rows, jdt)
    out = sdim_fused_serve_ref(store, _t(slots), _t(q), _t(R), tau, scales=scales,
                               present=_t(present))
    ref = jsdim_fused_serve(jstore, jnp.asarray(slots), jnp.asarray(q), jnp.asarray(R),
                            tau, scales=jscales, present=jnp.asarray(present),
                            block_c=block_c, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FP32)
    assert not out[-1].any()                        # absent user reads zero


UPDATE_SHAPES = [
    # (N, B, E, d, m, tau, block_e)
    (3, 4, 7, 32, 12, 2, 8),
    (5, 6, 9, 16, 24, 4, 8),
    (4, 6, 16, 128, 48, 3, 8),
]


@pytest.mark.parametrize("shape", UPDATE_SHAPES)
def test_sdim_update_plain_matches_pallas(shape):
    N, B, E, d, m, tau, block_e = shape
    G, U = m // tau, 1 << tau
    rng = np.random.default_rng(3)
    R = rng.standard_normal((m, d)).astype(np.float32)
    events = screened_normal(rng, (B, E, d), R)
    mask = (rng.random((B, E)) > 0.2).astype(np.float32)
    store = rng.standard_normal((N, G, U, d)).astype(np.float32)
    slots = rng.integers(1, N, B).astype(np.int32)
    slots[1] = slots[2]                              # duplicate slots accumulate
    slots[0], mask[0] = 0, 0.0                       # zero-mask row at slot 0: no-op
    out = _t(store.copy())
    res = sdim_update_ref(out, _t(slots), _t(events), _t(mask), _t(R), tau)
    assert res is out                                # in place
    ref = jsdim_update(jnp.asarray(store), jnp.asarray(slots), jnp.asarray(events),
                       jnp.asarray(mask), jnp.asarray(R), tau, block_e=block_e,
                       interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FP32)
    np.testing.assert_array_equal(out[0].numpy(), store[0])


def test_wrappers_run_plain_on_cpu_without_counting():
    B, L, C, d, m, tau = 2, 16, 4, 16, 12, 2
    seq, q, mask, R, _ = _inputs(B, L, C, d, m)
    wrappers = (bse_encode, sdim_query, sdim_fused_serve, sdim_update)
    before = [w.launches for w in wrappers]
    table = bse_encode(_t(seq), _t(mask), _t(R), tau)
    assert torch.equal(table, bse_encode_ref(_t(seq), _t(mask), _t(R), tau))
    assert torch.equal(sdim_query(_t(q), table, _t(R), tau),
                       sdim_query_ref(_t(q), table, _t(R), tau))
    slots = torch.tensor([1, 0], dtype=torch.int32)
    assert torch.equal(sdim_fused_serve(table, slots, _t(q), _t(R), tau),
                       sdim_fused_serve_ref(table, slots, _t(q), _t(R), tau))
    store = table.clone()
    sdim_update(store, torch.tensor([0, 1], dtype=torch.int32), _t(seq), _t(mask),
                _t(R), tau)
    assert torch.allclose(store, table * 2)
    assert [w.launches for w in wrappers] == before


def test_cuda_only_calls_raise_without_cuda():
    """On a host without CUDA, asking for the card raises; nothing falls
    back to the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the fall-back check needs one without")
    from repro_torch.core.engine import EngineConfig, SDIMEngine
    from repro_torch.serve.table_store import TableStore

    with pytest.raises(RuntimeError, match="CUDA"):
        SDIMEngine(EngineConfig(m=12, tau=2, d=16))
    with pytest.raises(RuntimeError, match="CUDA"):
        TableStore(6, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        _build.require_cuda("bse_encode", torch.zeros(3))
