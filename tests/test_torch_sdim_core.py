"""Port parity, core math: ``repro_torch.core`` and ``repro_torch.serve.quant``
against the JAX package on the same numpy inputs (CPU).

Signatures must be EQUAL on margin-screened inputs (every projection at
least 1e-3·‖r‖‖x‖ from 0, so the two frameworks' different summation orders
cannot flip a bit); bucket sums and queries agree to fp32 rounding (atol
1e-5, rtol 1e-5: sums of ≤ 64 unit-scale terms in another order);
quantization is bit-exact (same IEEE ops, round-half-even in both).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sdim as jsdim
from repro.core import simhash as jsimhash
from repro.core.target_attention import target_attention as jtarget_attention
from repro.serve import quant as jquant
from repro_torch.core import sdim, simhash
from repro_torch.core.target_attention import target_attention
from repro_torch.kernels.screen import clears_margin, screened_normal
from repro_torch.serve import quant

SHAPES = [  # (B, L, C, d, m, tau)
    (2, 16, 4, 16, 12, 2),
    (2, 64, 8, 32, 24, 4),
    (1, 32, 8, 128, 48, 3),
]
FP32 = dict(atol=1e-5, rtol=1e-5)


def _inputs(B, L, C, d, m, seed=0):
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((m, d)).astype(np.float32)
    seq = screened_normal(rng, (B, L, d), R)
    q = screened_normal(rng, (B, C, d), R)
    mask = (rng.random((B, L)) > 0.25).astype(np.float32)
    return seq, q, mask, R


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("shape", SHAPES)
def test_signatures_equal_jax(shape):
    B, L, C, d, m, tau = shape
    seq, q, _, R = _inputs(B, L, C, d, m)
    assert clears_margin(seq, R).all() and clears_margin(q, R).all()
    for x in (seq, q):
        ours = simhash.signatures(_t(x), _t(R), tau).numpy()
        ref = np.asarray(jsimhash.signatures(jnp.asarray(x), jnp.asarray(R), tau))
        np.testing.assert_array_equal(ours, ref)
        codes = simhash.hash_codes(_t(x), _t(R)).numpy()
        np.testing.assert_array_equal(
            codes, np.asarray(jsimhash.hash_codes(jnp.asarray(x), jnp.asarray(R))))


def test_sign_of_zero_is_one_and_packing_little_endian():
    codes = torch.tensor([[1, 0, 0, 1, 1, 0]], dtype=torch.int32)
    np.testing.assert_array_equal(simhash.pack_signatures(codes, 3).numpy(), [[1, 3]])
    zero = torch.zeros((1, 8))
    assert simhash.hash_codes(zero, torch.randn(4, 8)).tolist() == [[1, 1, 1, 1]]


def test_make_hashes_seeded():
    a = simhash.make_hashes(torch.Generator().manual_seed(3), 6, 5)
    b = simhash.make_hashes(torch.Generator().manual_seed(3), 6, 5)
    assert a.shape == (6, 5) and a.dtype == torch.float32
    assert torch.equal(a, b)


@pytest.mark.parametrize("shape", SHAPES)
def test_bucket_table_fused_query_match_jax(shape):
    B, L, C, d, m, tau = shape
    seq, q, mask, R = _inputs(B, L, C, d, m, seed=1)
    U = 1 << tau
    sig = simhash.signatures(_t(seq), _t(R), tau)
    table = sdim.bucket_table(_t(seq), sig, _t(mask), U)
    jtable = jsdim.bucket_table(jnp.asarray(seq), jnp.asarray(sig.numpy()),
                                jnp.asarray(mask), U)
    np.testing.assert_allclose(table.numpy(), np.asarray(jtable), **FP32)
    sig_q = simhash.signatures(_t(q), _t(R), tau)
    for s in (sig_q, sig_q[:, 0]):                  # (B, C, G) and (B, G)
        out = sdim.fused_query(table, s).numpy()
        ref = np.asarray(jsdim.fused_query(jtable, jnp.asarray(s.numpy())))
        np.testing.assert_allclose(out, ref, **FP32)
    out = sdim.sdim_attention(_t(q), _t(seq), _t(mask), _t(R), tau).numpy()
    ref = np.asarray(jsdim.sdim_attention(jnp.asarray(q), jnp.asarray(seq),
                                          jnp.asarray(mask), jnp.asarray(R), tau))
    np.testing.assert_allclose(out, ref, **FP32)


def test_l2_normalize_matches_jax_eps_inside_sqrt():
    rng = np.random.default_rng(2)
    v = rng.standard_normal((5, 7, 16)).astype(np.float32)
    v[0, 0] = 0.0                                  # zero row: 0 / sqrt(eps)
    v[1, 1] = 1e-7                                 # eps matters here
    np.testing.assert_allclose(sdim.l2_normalize(_t(v)).numpy(),
                               np.asarray(jsdim.l2_normalize(jnp.asarray(v))), **FP32)


def test_target_attention_matches_jax_incl_fully_masked_row():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, 4, 16)).astype(np.float32)
    seq = rng.standard_normal((3, 9, 16)).astype(np.float32)
    mask = (rng.random((3, 9)) > 0.3).astype(np.float32)
    mask[2] = 0.0                                  # uniform softmax, as in JAX
    for qq in (q, q[:, 0]):
        out = target_attention(_t(qq), _t(seq), _t(mask)).numpy()
        ref = np.asarray(jtarget_attention(jnp.asarray(qq), jnp.asarray(seq),
                                           jnp.asarray(mask)))
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["int8"])
def test_quantize_round_trip_equals_jax(name):
    rng = np.random.default_rng(4)
    rows = (rng.standard_normal((6, 4, 3, 16)) * 5).astype(np.float32)
    rows[0, 0, 0] = 0.0                            # zero row -> scale 0
    rows[1, 1, 1, 3] = np.inf                      # non-finite rows are zeroed
    rows[2, 2, 2, 0] = np.nan
    rows[3, 0, 1] = np.array([0.5, -0.5, 1.5, 2.5] * 4) * (127 / 2.5)  # half ties
    dt, jdt = quant.TABLE_DTYPES[name], jquant.TABLE_DTYPES[name]
    payload, scales, n_bad = quant.quantize_rows_checked(_t(rows), dtype=dt)
    jpayload, jscales, jn_bad = jquant.quantize_rows_checked(jnp.asarray(rows), dtype=jdt)
    np.testing.assert_array_equal(payload.numpy(), np.asarray(jpayload))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    assert int(n_bad) == int(jn_bad) == 2
    p2, s2 = quant.quantize_rows(_t(rows), dtype=dt)
    assert torch.equal(p2, payload) and torch.equal(s2, scales)
    np.testing.assert_array_equal(
        quant.dequantize_rows(payload, scales).numpy(),
        np.asarray(jquant.dequantize_rows(jpayload, jscales)))
    assert quant.is_quantized(dt) and not quant.is_quantized(torch.bfloat16)


@pytest.mark.parametrize("name", ["bf16", "int8", "fp32"])
def test_saturate_cast_equals_jax(name):
    rows = np.array([[1.0, -3e38, 3.4e38, 250.0, -200.0, np.nan]], np.float32)
    dt, jdt = quant.TABLE_DTYPES[name], jquant.TABLE_DTYPES[name]
    out, n = quant.saturate_cast(_t(rows), dtype=dt)
    jout, jn = jquant.saturate_cast(jnp.asarray(rows), dtype=jdt)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(jout).astype(np.float32))
    assert int(n) == int(jn)
