"""Port parity, the two kernel modules of inline and target-attention
serving: ``bse_serve_ref`` and ``target_attention_flash_ref`` against the
JAX package's Pallas kernels run in interpret mode (as tests/test_kernels.py
runs them), on margin-screened inputs; plus the wrapper contract (CPU
tensors run the plain version and count no launch). The CUDA kernels are
held against the plain versions on the card by tests/test_torch_cuda.py
and chip_smoke.py.

Tolerances: fp32 atol 1e-5 / rtol 1e-5 (the same sums in another order);
bf16 behaviors: bse_serve rtol 2e-2 / atol 1e-2 (tests/test_kernels.py:46-47),
target attention 3e-2 (tests/test_kernels.py:69).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sdim_serve.sdim_serve import bse_serve as jbse_serve
from repro.kernels.target_attn.ref import target_attention_ref as jtarget_attention_ref
from repro.kernels.target_attn.target_attn import \
    target_attention_flash as jtarget_attention_flash
from repro_torch.kernels.sdim_serve.sdim_serve import bse_serve, bse_serve_ref
from repro_torch.kernels.target_attn.target_attn import (
    target_attention_flash, target_attention_flash_ref)
from test_torch_kernels import DTYPES, FP32, SHAPES, _inputs, _t

BF16 = {"bse_serve": dict(atol=1e-2, rtol=2e-2), "target": dict(atol=3e-2, rtol=3e-2)}


def _serve_both(seq, q, mask, R, tau, tdt, jdt, block_l):
    out = bse_serve_ref(_t(q), _t(seq, tdt), _t(mask), _t(R), tau)
    ref = jbse_serve(jnp.asarray(q), jnp.asarray(seq, jdt), jnp.asarray(mask),
                     jnp.asarray(R), tau, block_l=block_l, interpret=True)
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_bse_serve_plain_matches_pallas(shape, dtype):
    B, L, C, d, m, tau, block_l, _ = shape
    tdt, jdt = DTYPES[dtype]
    seq, q, mask, R, _ = _inputs(B, L, C, d, m, tdt, seed=4)
    out, ref = _serve_both(seq, q, mask, R, tau, tdt, jdt, block_l)
    assert out.dtype == np.float32 and out.shape == (B, C, d)
    np.testing.assert_allclose(out, ref, **(FP32 if dtype == "fp32" else BF16["bse_serve"]))


def test_bse_serve_all_masked_user_reads_zero():
    """A user with every behavior masked has a zero table: zero interest,
    not NaN (the eps inside the sqrt), as tests/test_engine.py:77-85."""
    B, L, C, d, m, tau = 3, 40, 12, 32, 12, 2
    seq, q, mask, R, _ = _inputs(B, L, C, d, m, seed=5)
    mask[1] = 0.0
    out, ref = _serve_both(seq, q, mask, R, tau, torch.float32, jnp.float32, 16)
    np.testing.assert_allclose(out, ref, **FP32)
    assert np.isfinite(out).all() and not out[1].any() and out[0].any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_target_attention_flash_plain_matches_pallas(shape, dtype):
    B, L, C, d, _, _, block_l, block_c = shape
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(6)
    seq = rng.standard_normal((B, L, d)).astype(np.float32)
    q = rng.standard_normal((B, C, d)).astype(np.float32)
    if dtype == "bf16":     # the values as bf16 holds them, on both sides
        seq, q = (_t(x, torch.bfloat16).float().numpy() for x in (seq, q))
    mask = (rng.random((B, L)) > 0.25).astype(np.float32)
    out = target_attention_flash_ref(_t(q), _t(seq, tdt), _t(mask))
    ref = jtarget_attention_flash(jnp.asarray(q, jdt), jnp.asarray(seq, jdt),
                                  jnp.asarray(mask), block_c=block_c, block_l=block_l,
                                  interpret=True)
    assert out.dtype == torch.float32 and out.shape == (B, C, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               **(FP32 if dtype == "fp32" else BF16["target"]))


def test_target_attention_flash_fully_masked_value():
    """A fully masked user attends uniformly over all L rows (masked ones
    included): the value, not only its finiteness, matches JAX's reference
    and its flash kernel."""
    B, L, C, d = 2, 64, 8, 16
    rng = np.random.default_rng(7)
    seq = rng.standard_normal((B, L, d)).astype(np.float32)
    q = rng.standard_normal((B, C, d)).astype(np.float32)
    mask = (rng.random((B, L)) > 0.5).astype(np.float32)
    mask[0] = 0.0
    out = target_attention_flash_ref(_t(q), _t(seq), _t(mask)).numpy()
    ref = np.asarray(jtarget_attention_ref(jnp.asarray(q), jnp.asarray(seq), jnp.asarray(mask)))
    flash = np.asarray(jtarget_attention_flash(jnp.asarray(q), jnp.asarray(seq),
                                               jnp.asarray(mask), block_l=32, interpret=True))
    np.testing.assert_allclose(out, ref, **FP32)
    np.testing.assert_allclose(out, flash, **FP32)
    np.testing.assert_allclose(out[0], np.broadcast_to(seq[0].mean(0), (C, d)), **FP32)


def test_serve_wrappers_run_plain_on_cpu_without_counting():
    B, L, C, d, m, tau = 2, 16, 4, 16, 12, 2
    seq, q, mask, R, _ = _inputs(B, L, C, d, m)
    before = (bse_serve.launches, target_attention_flash.launches)
    args = (_t(q), _t(seq), _t(mask))
    assert torch.equal(bse_serve(*args, _t(R), tau), bse_serve_ref(*args, _t(R), tau))
    assert torch.equal(target_attention_flash(*args), target_attention_flash_ref(*args))
    assert (bse_serve.launches, target_attention_flash.launches) == before
