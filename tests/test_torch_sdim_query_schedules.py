"""CPU rehearsal of kernel 4's two redesigned kernels: the numpy emulations
of ``tests/torch_schedules.py`` (``sdim_query_backward_schedule``:
``sdim_query_backward.cu``'s tau <= 4 body; ``query_large_tau_schedule``:
``sdim_query_large_tau.cu``'s forward on sdim_fused_serve's gather body)
held against the JAX package on seeded, margin-screened inputs, at the
shapes the port's launches use and at the edges of the splits:

- the backward against ``jax.grad`` of the XLA formulation
  (``core/sdim.fused_query``) at the training step (B = 32, C = 1, d =
  128, m = 48, tau = 3), the Table 2/3 protocol's and Table 4's step (B =
  128, d = 32) and dien's d = 36, d = 4 and 20, U = 16 with C = 33 and 40
  (two candidate passes), C = 0, every candidate in one bucket and a fully
  masked user: every element written once, only the selected rows read,
  the others exactly +0;
- the forward against the JAX oracle ``sdim_query_ref`` at tau 5 and 10, C
  = 1, 3 and 128, off fp32 and bf16 tables.

Tolerance: atol 1e-5 / rtol 1e-5 in fp32 (the same sums in another order),
the backward compared times each row's n = sqrt(|t|^2 + 1e-12), as
``tests/test_torch_cuda.py`` does (a zero row's gradient is g / 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sdim as jsdim
from repro.core import simhash as jsimhash
from repro.kernels.sdim_bucket.ref import bse_encode_ref as jbse_encode_ref
from repro.kernels.sdim_query.ref import sdim_query_ref as jsdim_query_ref
from repro_torch.kernels.screen import screened_normal
from repro_torch.kernels.sdim_query.sdim_query import query_backward_splits
from torch_schedules import (FP32, _selected, query_large_tau_schedule,
                             sdim_query_backward_schedule)


def _encoded(rng, B, L, d, R, tau, masked_last=False):
    """Screened behaviors of B users, their (B, L) mask (the last user's all
    zero where ``masked_last``) and the JAX package's bucket table."""
    seq = screened_normal(rng, (B, L, d), R)
    mask = (rng.random((B, L)) > 0.25).astype(np.float32)
    if masked_last:
        mask[-1] = 0.0
    table = np.asarray(jbse_encode_ref(jnp.asarray(seq), jnp.asarray(mask), jnp.asarray(R), tau))
    return seq, mask, table


# (B, L, C, d, m, tau, kind)
BWD_CASES = {
    "train": (32, 64, 1, 128, 48, 3, "random"),        # the training step, C = 1
    "protocol": (128, 64, 1, 32, 48, 3, "random"),     # Table 2/3's and Table 4's step
    "d36": (32, 64, 1, 36, 48, 3, "random"),           # dien's width
    "d4": (4, 40, 3, 4, 12, 2, "random"),
    "d20": (4, 40, 5, 20, 24, 3, "random"),
    "U16-C33": (3, 60, 33, 32, 48, 4, "random"),       # two passes: 32 candidates, then 1
    "U16-C40": (3, 60, 40, 36, 48, 4, "random"),
    "C0": (3, 40, 0, 32, 48, 3, "random"),             # every row +0, none read
    "one-bucket": (3, 40, 20, 32, 48, 3, "one-bucket"),
    "masked": (3, 40, 8, 32, 48, 3, "masked"),         # the last user's table zero
}


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_query_backward_schedule_matches_jax(case):
    """sdim_query_backward's tau <= 4 schedule at the split the wrapper takes
    on a 132-SM card against jax.grad: every row written once, the selected
    rows read once, the unselected ones +0 unread."""
    B, L, C, d, m, tau, kind = BWD_CASES[case]
    rng = np.random.default_rng(41)
    R = rng.standard_normal((m, d)).astype(np.float32)
    _, _, table = _encoded(rng, B, L, d, R, tau, masked_last=kind == "masked")
    q = screened_normal(rng, (B, C, d), R)
    if kind == "one-bucket":                    # positive multiples of one candidate
        q = (q[:, :1] * rng.uniform(0.5, 2.0, (B, C, 1))).astype(np.float32)
    dout = rng.standard_normal((B, C, d)).astype(np.float32)
    sig = jsimhash.signatures(jnp.asarray(q), jnp.asarray(R), tau)
    jdT = np.asarray(jax.grad(lambda t: jnp.sum(jsdim.fused_query(t, sig) * jnp.asarray(dout)))(
        jnp.asarray(table)))
    dT, writes, reads = sdim_query_backward_schedule(dout, q, table, R, tau,
                                                     query_backward_splits(B, m // tau, 132))
    sel = _selected(q, R, tau)
    assert (writes == 1).all() and (reads == sel).all()
    assert not dT[~sel].any() and not np.signbit(dT[~sel]).any()
    n = np.sqrt(np.sum(table * table, -1, keepdims=True) + np.float32(1e-12))
    np.testing.assert_allclose(dT * n, jdT * n, **FP32)
    if kind == "one-bucket":
        assert (sel.sum(-1) == 1).all()
    if kind == "masked":
        assert not table[-1].any() and dT[-1].any()
    if C == 0:
        assert not sel.any()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("C", [1, 3, 128])
@pytest.mark.parametrize("tau, m", [(5, 45), (10, 40)])
def test_query_large_tau_schedule_matches_jax(tau, m, C, dtype):
    """sdim_query's tau 5..10 forward (the gather body: teams of eight lanes
    a (candidate, group), ``teams`` groups a pass, rows over their norms in
    g order, then / G) against the JAX oracle, off fp32 and bf16 (the wire)
    tables; half of each user's candidates are its own behaviors (at tau =
    10 random candidates read almost only empty buckets), a fully masked
    user reads zero."""
    B, L, d = 3, 64, 32
    rng = np.random.default_rng(43 + tau)
    R = rng.standard_normal((m, d)).astype(np.float32)
    seq, mask, table = _encoded(rng, B, L, d, R, tau, masked_last=True)
    q = screened_normal(rng, (B, C, d), R)
    for b in range(B - 1):
        own = rng.choice(np.flatnonzero(mask[b]), max(1, C // 2))
        q[b, :len(own)] = seq[b, own]
    if dtype == "bf16":
        table = torch.from_numpy(table).to(torch.bfloat16).float().numpy()
    out = query_large_tau_schedule(q, table, R, tau)
    ref = np.asarray(jsdim_query_ref(jnp.asarray(q), jnp.asarray(table), jnp.asarray(R), tau))
    np.testing.assert_allclose(out, ref, **FP32)
    assert not out[-1].any() and np.abs(out[:-1, 0]).sum(-1).all()   # own behaviors read
