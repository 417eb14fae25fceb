"""CPU rehearsal of sdim_fused_serve and sdim_query' schedules
(fused_query.cuh's body and sdim_query's wide path): numpy emulations of
how the kernels split and merge their work, held against the JAX package on
seeded, margin-screened inputs (the emulations and the whole list:
tests/torch_schedules.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.sdim_fused_serve.ref import sdim_fused_serve_ref as jsdim_fused_serve_ref
from repro.kernels.sdim_query.ref import sdim_query_ref as jsdim_query_ref
from repro.serve import quant as jquant
from repro_torch.kernels.screen import screened_normal
from repro_torch.kernels.sdim_query.sdim_query import WIDE_MAX_CANDS, wide_tile
from torch_schedules import (FP32, card_ctas, sdim_fused_serve_schedule, sdim_query_wide_schedule,
                             wide_smem)


@pytest.mark.parametrize("store_dtype", ["fp32", "bf16", "int8", "fp8",
                                         "query-fp32", "query-bf16"])
@pytest.mark.parametrize("shape", [
    (3, 8, 32, 12, 2, 8),        # G*U = 24 rows: 3 a rank; one candidate a rank
    (3, 70, 64, 24, 4, 8),       # U = 16, ragged C
    (2, 128, 128, 48, 3, 8),     # the main shape: 16 rows and 16 candidates a rank
    (3, 100, 128, 36, 3, 8),     # G = 12 over 8 ranks, C = 100
    (2, 5, 128, 48, 3, 7),       # 7 ranks: uneven rows, ranks without candidates
    (3, 128, 36, 48, 3, 8),      # dien FULL: d = 36, 16 rows a rank
    (3, 70, 36, 10, 2, 8),       # d = 36, G*U = 20: 3 rows a rank rounded up to the loads
    (3, 33, 4, 12, 2, 8),        # d = 4: an int8 load spans 4 rows, 3 rows a rank -> 4
    (3, 40, 20, 12, 2, 8),       # d = 20: int8 loads straddle rows at offsets 4, 8, 12
    (2, 16, 44, 48, 3, 8),       # d = 44: int8 rows of 44 bytes, 16 rows a rank
], ids=["small", "U16", "full-width", "G12", "S7-C5", "dien-d36", "G5-d36", "G6-d4",
        "G6-d20", "d44"])
def test_sdim_fused_serve_schedule_matches_jax(shape, store_dtype):
    """The fused store read, and (``query-*``) sdim_query's identity slots:
    user b reads row b of a fetched fp32 or bf16 table, held against JAX's
    sdim_query oracle."""
    B, C, d, m, tau, S = shape
    G, U = m // tau, 1 << tau
    rng = np.random.default_rng(14)
    R = rng.standard_normal((m, d)).astype(np.float32)
    q = screened_normal(rng, (B, C, d), R)
    if store_dtype.startswith("query-"):
        tables = rng.standard_normal((B, G, U, d)).astype(np.float32)
        tables[0] = 0.0                           # a fully masked user's zero table
        jtable = jnp.asarray(tables, jnp.bfloat16 if store_dtype == "query-bf16"
                             else jnp.float32)
        table = np.asarray(jtable).astype(np.float32)  # the fetched values, exactly
        out = sdim_fused_serve_schedule(table, None, None, None, q, R, tau, S,
                                        itemsize=jtable.dtype.itemsize)
        # the kernel reads a bf16 table exactly into fp32; the oracle would
        # keep it in bf16, so it gets the same values in fp32
        ref = np.asarray(jsdim_query_ref(jnp.asarray(q), jnp.asarray(table), jnp.asarray(R),
                                         tau))
        np.testing.assert_allclose(out, ref, **FP32)
        assert not out[0].any()                   # the zero table reads zero
        return
    N = 2 * B + 1
    rows = rng.standard_normal((N, G, U, d)).astype(np.float32)
    rows *= rng.uniform(0.1, 10.0, (N, G, U, 1)).astype(np.float32)  # unlike row scales
    rows[0] = 0.0                                 # a fully masked user's zero table
    slots = rng.permutation(N)[:B].astype(np.int32)
    slots[0] = 0
    present = np.ones(B, np.float32)
    present[-1] = 0.0                             # the last user is absent
    jscales = None
    if store_dtype in ("int8", "fp8"):
        jstore, jscales = jquant.quantize_rows(jnp.asarray(rows),
                                               dtype=jquant.TABLE_DTYPES[store_dtype])
    else:
        jstore = jnp.asarray(rows, jnp.bfloat16 if store_dtype == "bf16" else jnp.float32)
    store = np.asarray(jstore).astype(np.float32)  # the stored values, exactly
    scales = None if jscales is None else np.asarray(jscales)
    out = sdim_fused_serve_schedule(store, scales, slots, present, q, R, tau, S,
                                    itemsize=jstore.dtype.itemsize)
    ref = np.asarray(jsdim_fused_serve_ref(jstore, jnp.asarray(slots), jnp.asarray(q),
                                           jnp.asarray(R), tau, scales=jscales,
                                           present=jnp.asarray(present)))
    np.testing.assert_allclose(out, ref, **FP32)
    assert not out[-1].any()                      # the absent user
    assert not out[0].any()                       # the zero table reads zero


@pytest.mark.parametrize("shape", [
    (1, 128, 512, 48, 3),        # deepseek-v2's SDIM-KV read: 128 CTAs of one candidate
    (2, 300, 516, 48, 3),        # d % 8 == 4: 129 float4 columns, 5 a lane, the last on one
    (2, 33, 512, 36, 3),         # G = 12
    (2, 5, 512, 48, 4),          # U = 16
    (8, 128, 512, 48, 3),        # B = 8: tiles of 4 (256 CTAs)
    (8, 70, 512, 48, 3),         # C not a multiple of the tile: 70 = 23 * 3 + 1
    (2, 0, 512, 48, 3),          # C = 0: no CTA
    (2, 9, 1024, 48, 3),         # d = 1,024: R alone 192 KB, one CTA an SM
], ids=["mla", "d516", "G12", "U16", "B8", "C70", "C0", "d1024"])
def test_sdim_query_wide_schedule_matches_jax(shape):
    """The wide path against JAX's sdim_query oracle, every answer written
    once, a zero table reading zero, and the tile the model card's one-wave
    choice."""
    B, C, d, m, tau = shape
    G, U = m // tau, 1 << tau
    rng = np.random.default_rng(d + C)
    R = rng.standard_normal((m, d)).astype(np.float32)
    q = screened_normal(rng, (B, C, d), R)
    table = rng.standard_normal((B, G, U, d)).astype(np.float32)
    table[0, :, 1] = 0.0                          # empty buckets
    if B > 1:
        table[-1] = 0.0                           # a user with no keys
    out, writes, tile = sdim_query_wide_schedule(q, table, R, tau)
    assert (writes == 1).all()
    assert tile == {(1, 128): 1, (8, 128): 4, (8, 70): 3}.get((B, C), tile)
    ref = np.asarray(jsdim_query_ref(jnp.asarray(q), jnp.asarray(table), jnp.asarray(R), tau))
    np.testing.assert_allclose(out, ref, **FP32)
    if B > 1:
        assert not out[-1].any()


@pytest.mark.parametrize("B, C, d, m, want", [
    (1, 128, 512, 48, 1),      # the MLA read: 128 CTAs, two an SM
    (8, 128, 512, 48, 4),      # 256 CTAs of 4 (tiles of 3 need 344)
    (8, 70, 512, 48, 3),       # 192 CTAs of 3 (tiles of 2 need 280)
    (3, 300, 516, 48, 4),      # 225 CTAs of 4
    (2, 33, 1024, 48, 1),      # one CTA an SM: 66 CTAs
    (64, 128, 1024, 48, 8),    # no tile fits one wave: the most candidates a CTA
    (1, 1, 512, 48, 1),
])
def test_wide_tile_fills_one_wave(B, C, d, m, want):
    """The wide path's tile (sdim_query.py wide_tile) on the model card:
    the fewest candidates a CTA whose B * ceil(C / tile) CTAs fit one wave
    of the 132 SMs, else WIDE_MAX_CANDS; a tile of one candidate fits a
    CTA's shared memory up to d = 1,184 at m = 48 and not at 1,188."""
    G = m // 3
    ctas = lambda t: card_ctas(wide_smem(G, d, m, t))
    tile = wide_tile(B, C, 132, ctas)
    assert tile == want and 1 <= tile <= WIDE_MAX_CANDS
    fits = B * -(-C // tile) <= 132 * ctas(tile)
    assert fits or tile == WIDE_MAX_CANDS
    assert tile == 1 or not B * -(-C // (tile - 1)) <= 132 * ctas(tile - 1)
    assert card_ctas(wide_smem(16, 1184, 48, 1)) > 0 and card_ctas(wide_smem(16, 1188, 48, 1)) == 0
