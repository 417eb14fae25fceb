"""CPU rehearsal of the two cluster kernels' schedules: a numpy emulation
of how ``target_attn.cu`` and ``bse_serve.cu`` split their work over a
thread-block cluster and merge it, held against the JAX package on seeded,
margin-screened inputs. The CUDA kernels cannot run here; this pins the
merge algebra they implement.

- target attention: each of S ranks (8 or 7) runs the online softmax
  over its chunk of 32-row tiles, skipping wholly masked tiles unless the
  user has no valid row, and the partial (m, den, acc) are merged in rank
  order;
- bse_serve: each of S ranks streams 64-row tiles and builds the table of
  its own range of signature groups (uneven where S does not divide G),
  l2-normalizes it and sums its groups' buckets per candidate; the
  partials are summed in rank order and divided by G.

Tolerance: atol 1e-5 / rtol 1e-5 in fp32 (the same sums in another order),
as the reference's own tests (tests/test_kernels.py:46-58).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.sdim import sdim_attention as jsdim_attention
from repro.kernels.target_attn.ref import target_attention_ref as jtarget_attention_ref
from repro_torch.kernels.screen import screened_normal

FP32 = dict(atol=1e-5, rtol=1e-5)
MASKED = np.float32(-1e30)
LAYOUTS = ["random", "front", "last"]


def _mask(rng, B, L, layout):
    """(B, L) fp32 mask; with B > 1 the last user has every row masked."""
    if layout == "random":
        mask = (rng.random((B, L)) > 0.25).astype(np.float32)
    elif layout == "front":                       # leading chunks wholly masked
        lengths = rng.integers(1, max(L // 3, 1) + 1, B)
        mask = (np.arange(L)[None] >= L - lengths[:, None]).astype(np.float32)
    else:                                         # valid rows in the last chunk only
        mask = np.zeros((B, L), np.float32)
        mask[:, -5:] = 1.0
    if B > 1:
        mask[-1] = 0.0
    return mask


def target_attention_schedule(q, seq, mask, S=8, TC=64, TL=32):
    """target_attn.cu's schedule in numpy fp32."""
    B, C, d = q.shape
    L = seq.shape[1]
    scale = np.float32(1.0) / np.sqrt(np.float32(d))
    nt = -(-L // TL)
    per_rank = -(-nt // S)
    out = np.zeros((B, C, d), np.float32)
    for b in range(B):
        user_valid = bool((mask[b] > 0).any())
        for c0 in range(0, C, TC):
            qc = q[b, c0:c0 + TC]
            states = []
            for rank in range(S):
                m = np.full(len(qc), MASKED, np.float32)
                den = np.zeros(len(qc), np.float32)
                acc = np.zeros((len(qc), d), np.float32)
                for t in range(rank * per_rank, min(nt, (rank + 1) * per_rank)):
                    rows = slice(t * TL, min(L, (t + 1) * TL))
                    w, x = mask[b, rows], seq[b, rows]
                    if user_valid and not (w > 0).any():
                        continue                  # its weights are exactly 0
                    s = np.where(w[None] > 0, (qc @ x.T) * scale, MASKED)
                    m_new = np.maximum(m, s.max(1))
                    p = np.exp(s - m_new[:, None])
                    alpha = np.exp(m - m_new)
                    den = den * alpha + p.sum(1)
                    acc = acc * alpha[:, None] + p @ x
                    m = m_new
                states.append((m, den, acc))
            M = np.max([st[0] for st in states], axis=0)
            den = np.zeros_like(M)
            acc = np.zeros((len(qc), d), np.float32)
            for m_j, den_j, acc_j in states:      # rank order
                e = np.exp(m_j - M)
                den = den + den_j * e
                acc = acc + acc_j * e[:, None]
            out[b, c0:c0 + TC] = acc / (den + np.float32(1e-30))[:, None]
    return out


def _signatures(x, R_groups, tau):
    """(n, d) rows, (ng, tau, d) projections -> (n, ng) bucket ids."""
    bits = (np.einsum("nd,gtd->ngt", x, R_groups) >= 0).astype(np.int64)
    return (bits << np.arange(tau)).sum(-1)


def bse_serve_schedule(q, seq, mask, R, tau, S, TL=64, TC=64):
    """bse_serve.cu's schedule in numpy fp32: S ranks over G groups."""
    B, C, d = q.shape
    L = seq.shape[1]
    G, U = R.shape[0] // tau, 1 << tau
    Rg = R.reshape(G, tau, d)
    out = np.zeros((B, C, d), np.float32)
    for b in range(B):
        tables = []
        for rank in range(S):
            g0, g1 = rank * G // S, (rank + 1) * G // S
            table = np.zeros((g1 - g0, U, d), np.float32)
            for l0 in range(0, L, TL):
                w, x = mask[b, l0:l0 + TL], seq[b, l0:l0 + TL]
                if not (w != 0).any():
                    continue                      # a zero-weight tile adds nothing
                sig = _signatures(x, Rg[g0:g1], tau)
                for gl in range(g1 - g0):
                    onehot = (sig[:, gl, None] == np.arange(U)).astype(np.float32)
                    table[gl] += onehot.T @ (w[:, None] * x)
            norm = np.sqrt((table * table).sum(-1, keepdims=True) + np.float32(1e-12))
            tables.append((g0, g1, table / norm))
        for c0 in range(0, C, TC):
            qc = q[b, c0:c0 + TC]
            partials = []
            for g0, g1, tn in tables:
                sig = _signatures(qc, Rg[g0:g1], tau)
                partials.append(sum(tn[gl, sig[:, gl]] for gl in range(g1 - g0)))
            total = np.zeros_like(partials[0])
            for p in partials:                    # rank order
                total = total + p
            out[b, c0:c0 + TC] = total / np.float32(G)
    return out


@pytest.mark.parametrize("S", [8, 7])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", [(2, 40, 8, 32), (3, 300, 70, 64), (2, 1024, 128, 128)],
                         ids=["L-below-a-tile-per-rank", "ragged", "full-width"])
def test_target_attention_schedule_matches_jax(shape, layout, S):
    """S = 8 chunks, and S = 7 (the kernel's cluster at a 16-user burst on
    the H100): uneven chunks and candidate slices."""
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
@pytest.mark.parametrize("shape", [
    (2, 40, 8, 32, 12, 2, 4),        # G = 6 over S = 4: ranges 1, 2, 1, 2
    (3, 300, 70, 64, 24, 4, 4),      # G = 6, U = 16 over S = 4
    (2, 1024, 128, 128, 48, 3, 8),   # the main shape: G = 16, 2 groups a rank
    (2, 1000, 100, 128, 36, 3, 8),   # G = 12 over S = 8: ranges 1 or 2
], ids=["G6-S4", "G6-U16-S4", "full-width", "G12-S8"])
def test_bse_serve_schedule_matches_jax(shape, layout):
    B, L, C, d, m, tau, S = shape
    rng = np.random.default_rng(12)
    R = rng.standard_normal((m, d)).astype(np.float32)
    seq = screened_normal(rng, (B, L, d), R)
    q = screened_normal(rng, (B, C, d), R)
    mask = _mask(rng, B, L, layout)
    out = bse_serve_schedule(q, seq, mask, R, tau, S)
    ref = np.asarray(jsdim_attention(jnp.asarray(q), jnp.asarray(seq), jnp.asarray(mask),
                                     jnp.asarray(R), tau))
    np.testing.assert_allclose(out, ref, **FP32)
    assert not out[-1].any()                      # the fully masked user reads zero
