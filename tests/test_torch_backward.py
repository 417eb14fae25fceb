"""Port parity, the backward kernels' plain versions: the closed-form
gradients ``bse_encode_backward_ref``, ``sdim_query_backward_ref`` and
``target_attention_flash_backward_ref`` against autograd of the port's
plain forwards and against ``jax.grad`` of the JAX package's XLA
formulations (``core/simhash.py`` + ``core/sdim.py``, which
``SDIMEngine`` trains through, and ``core/target_attention.py``), on
margin-screened inputs, with ragged masks, fully masked users, bf16
behaviors and C = 0 / L = 0; plus the autograd wiring (``BSEEncodeFn``,
``SDIMQueryFn``, ``TargetAttentionFn``) that the wrappers record, the same
on the CPU as on the card. The CUDA kernels are held against these plain
versions on the card by tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: fp32 atol 1e-5 / rtol 1e-5 (the same sums in another order),
as the reference's own tests (tests/test_kernels.py:46-58); the bf16
gradient of bf16 behaviors rtol 2e-2 / atol 1e-2, as there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sdim as jsdim
from repro.core import simhash as jsimhash
from repro.core.target_attention import target_attention as jtarget_attention
from repro_torch.core.engine import EngineConfig, SDIMEngine
from repro_torch.kernels.screen import screened_normal
from repro_torch.kernels.sdim_bucket.sdim_bucket import (
    BSEEncodeFn, bse_encode, bse_encode_backward, bse_encode_backward_ref, bse_encode_ref)
from repro_torch.kernels.sdim_query.sdim_query import (
    SDIMQueryFn, sdim_query, sdim_query_backward, sdim_query_backward_ref, sdim_query_ref)
from repro_torch.kernels.sdim_serve.sdim_serve import bse_serve
from repro_torch.kernels.target_attn.target_attn import (
    TargetAttentionFn, target_attention_flash, target_attention_flash_backward,
    target_attention_flash_backward_ref, target_attention_flash_ref)

FP32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=1e-2, rtol=2e-2)
SHAPES = [  # (B, L, C, d, m, tau)
    (3, 40, 5, 32, 12, 2),
    (2, 70, 9, 64, 24, 4),
    (2, 64, 16, 128, 48, 3),
    (2, 0, 4, 32, 12, 2),        # L = 0
    (2, 33, 0, 32, 12, 2),       # C = 0
]


def _inputs(shape, seed=0, dtype=torch.float32):
    """Screened behaviors and candidates, a ragged mask whose last user
    (B > 1) is fully masked, R, and an upstream gradient of the output."""
    B, L, C, d, m, tau = shape
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((m, d)).astype(np.float32)
    seq = screened_normal(rng, (B, L, d), R, dtype)
    q = screened_normal(rng, (B, C, d), R)
    mask = (rng.random((B, L)) > 0.3).astype(np.float32)
    mask[-1] = 0
    dout = rng.standard_normal((B, C, d)).astype(np.float32)
    return seq, q, mask, R, dout


def _jax_sdim_grads(seq, q, mask, R, dout, tau):
    """jax.grad of <dout, query(q, encode(seq))> in seq and in the table."""
    sig_q = jsimhash.signatures(jnp.asarray(q), jnp.asarray(R), tau)

    def encode(s):
        return jsdim.bucket_table(s, jsimhash.signatures(s, jnp.asarray(R), tau),
                                  jnp.asarray(mask), 1 << tau)

    def query(t):
        return jnp.sum(jsdim.fused_query(t, sig_q) * jnp.asarray(dout))

    table = encode(jnp.asarray(seq))
    dT = jax.grad(query)(table)
    _, vjp = jax.vjp(encode, jnp.asarray(seq))
    return np.array(vjp(dT)[0]), np.array(dT), np.array(table)


@pytest.mark.parametrize("shape", SHAPES)
def test_sdim_backwards_match_jax_and_autograd(shape):
    B, L, C, d, m, tau = shape
    seq, q, mask, R, dout = _inputs(shape)
    jdseq, jdT, table = _jax_sdim_grads(seq, q, mask, R, dout, tau)
    t = torch.from_numpy
    dT = sdim_query_backward_ref(t(dout), t(q), t(table), t(R), tau)
    np.testing.assert_allclose(dT.numpy(), jdT, **FP32)
    dseq = bse_encode_backward_ref(t(jdT), t(seq), t(mask), t(R), tau)
    np.testing.assert_allclose(dseq.numpy(), jdseq, **FP32)
    # autograd of the plain forwards
    tb = t(table).requires_grad_()
    torch.sum(sdim_query_ref(t(q), tb, t(R), tau) * t(dout)).backward()
    np.testing.assert_allclose(dT.numpy(), tb.grad.numpy(), **FP32)
    sb = t(seq).requires_grad_()
    torch.sum(bse_encode_ref(sb, t(mask), t(R), tau) * t(jdT)).backward()
    np.testing.assert_allclose(dseq.numpy(), sb.grad.numpy(), **FP32)
    if B > 1 and L > 0:          # a fully masked user's behaviors get no gradient
        assert not dseq[-1].any()
    if C == 0:                   # no candidate reads the table
        assert not dT.any()


def test_sdim_backward_reads_zero_rows_as_the_normalize_does():
    """A bucket no behavior reached is a zero row, t / sqrt(0 + 1e-12): its
    gradient is g / 1e-6, as jax.grad of l2_normalize gives it."""
    shape = (2, 6, 8, 32, 12, 2)
    seq, q, mask, R, dout = _inputs(shape, seed=3)
    jdseq, jdT, table = _jax_sdim_grads(seq, q, mask, R, dout, 2)
    zero_rows = ~table.any(-1)
    assert zero_rows.any() and np.abs(jdT[zero_rows]).max() > 1e3
    dT = sdim_query_backward_ref(*(torch.from_numpy(x) for x in (dout, q, table, R)), 2)
    np.testing.assert_allclose(dT.numpy(), jdT, rtol=1e-5, atol=1e-5 * np.abs(jdT).max())


@pytest.mark.parametrize("shape", SHAPES)
def test_target_attention_backward_matches_jax_and_autograd(shape):
    """dq and dseq against jax.grad of the JAX target attention; a fully
    masked user attends uniformly, so its rows get sum_c dout / L and its
    candidates nothing."""
    B, L, C, d, m, tau = shape
    seq, q, mask, _, dout = _inputs(shape, seed=1)
    t = torch.from_numpy
    out = target_attention_flash_ref(t(q), t(seq), t(mask))
    dq, dseq = target_attention_flash_backward_ref(t(dout), t(q), t(seq), t(mask), out)
    jdq, jdseq = jax.grad(lambda a, b: jnp.sum(jtarget_attention(a, b, jnp.asarray(mask))
                                               * jnp.asarray(dout)), argnums=(0, 1))(
        jnp.asarray(q), jnp.asarray(seq))
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq), **FP32)
    np.testing.assert_allclose(dseq.numpy(), np.asarray(jdseq), **FP32)
    qa, sa = t(q).requires_grad_(), t(seq).requires_grad_()
    torch.sum(target_attention_flash_ref(qa, sa, t(mask)) * t(dout)).backward()
    np.testing.assert_allclose(dq.numpy(), qa.grad.numpy(), **FP32)
    np.testing.assert_allclose(dseq.numpy(), sa.grad.numpy(), **FP32)
    if B > 1 and L > 0:
        assert not dq[-1].any()
        np.testing.assert_allclose(dseq[-1].numpy(),
                                   np.broadcast_to(dout[-1].sum(0) / L, (L, d)), **FP32)


@pytest.mark.parametrize("kernel", ["encode", "target"])
def test_bf16_behaviors_get_a_bf16_gradient(kernel):
    """bf16 behaviors: the plain backwards return bf16 gradients, the fp32
    ones rounded (the JAX package's astype in the other direction)."""
    shape = (2, 40, 6, 64, 24, 3)
    seq, q, mask, R, dout = _inputs(shape, seed=2, dtype=torch.bfloat16)
    t = torch.from_numpy
    sb = t(seq).to(torch.bfloat16)
    if kernel == "encode":
        dT = t(np.random.default_rng(0).standard_normal((2, 8, 8, 64)).astype(np.float32))
        ours = bse_encode_backward_ref(dT, sb, t(mask), t(R), 3)
        ref = bse_encode_backward_ref(dT, t(seq), t(mask), t(R), 3)
    else:
        ours = target_attention_flash_backward_ref(
            t(dout), t(q), sb, t(mask), target_attention_flash_ref(t(q), sb, t(mask)))[1]
        ref = target_attention_flash_backward_ref(
            t(dout), t(q), t(seq), t(mask), target_attention_flash_ref(t(q), t(seq), t(mask)))[1]
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), ref.numpy(), **BF16)


def test_wrappers_record_the_autograd_functions():
    """With grad on, the wrappers go through the Functions (whose backward
    is the backward wrapper: plain here, the kernel on the card) and give
    the same gradients as autograd of the plain forwards; q and R get none;
    without grad they record nothing; a mask that requires grad is
    refused."""
    shape = (3, 40, 5, 32, 12, 2)
    seq, q, mask, R, dout = _inputs(shape, seed=4)
    t = torch.from_numpy
    sa, qa = t(seq).requires_grad_(), t(q).requires_grad_()
    table = bse_encode(sa, t(mask), t(R), 2)
    out = sdim_query(qa, table, t(R), 2)
    assert type(table.grad_fn).__name__ == "BSEEncodeFnBackward"
    assert type(out.grad_fn).__name__ == "SDIMQueryFnBackward"
    torch.sum(out * t(dout)).backward()
    assert qa.grad is None
    sb = t(seq).requires_grad_()
    torch.sum(sdim_query_ref(t(q), bse_encode_ref(sb, t(mask), t(R), 2), t(R), 2)
              * t(dout)).backward()
    np.testing.assert_allclose(sa.grad.numpy(), sb.grad.numpy(), **FP32)

    qa, sa = t(q).requires_grad_(), t(seq).requires_grad_()
    out = target_attention_flash(qa, sa, t(mask))
    assert type(out.grad_fn).__name__ == "TargetAttentionFnBackward"
    torch.sum(out * t(dout)).backward()
    qb, sb = t(q).requires_grad_(), t(seq).requires_grad_()
    torch.sum(target_attention_flash_ref(qb, sb, t(mask)) * t(dout)).backward()
    np.testing.assert_allclose(qa.grad.numpy(), qb.grad.numpy(), **FP32)
    np.testing.assert_allclose(sa.grad.numpy(), sb.grad.numpy(), **FP32)

    with torch.no_grad():
        assert bse_encode(t(seq).requires_grad_(), t(mask), t(R), 2).grad_fn is None
    with pytest.raises(ValueError, match="mask"):
        bse_encode(t(seq).requires_grad_(), t(mask).requires_grad_(), t(R), 2)
    with pytest.raises(ValueError, match="mask"):
        target_attention_flash(t(q), t(seq).requires_grad_(), t(mask).requires_grad_())
    for fn in (BSEEncodeFn, SDIMQueryFn, TargetAttentionFn):
        assert issubclass(fn, torch.autograd.Function)
    # the serving kernels have no backward: their CPU plain versions keep
    # autograd, their CUDA wrappers refuse it (tests/test_torch_cuda.py)
    assert bse_serve(t(q), t(seq).requires_grad_(), t(mask), t(R), 2).requires_grad


def test_backward_wrappers_run_the_plain_versions_on_cpu():
    """On CPU tensors the backward wrappers are their plain versions and
    count no launch."""
    shape = (2, 40, 5, 32, 12, 2)
    seq, q, mask, R, dout = _inputs(shape, seed=5)
    t = torch.from_numpy
    table = bse_encode_ref(t(seq), t(mask), t(R), 2)
    counts = (bse_encode_backward.launches, sdim_query_backward.launches,
              target_attention_flash_backward.launches)
    dT = sdim_query_backward(t(dout), t(q), table, t(R), 2)
    assert torch.equal(dT, sdim_query_backward_ref(t(dout), t(q), table, t(R), 2))
    assert torch.equal(bse_encode_backward(dT, t(seq), t(mask), t(R), 2),
                       bse_encode_backward_ref(dT, t(seq), t(mask), t(R), 2))
    out = target_attention_flash_ref(t(q), t(seq), t(mask))
    for a, b in zip(target_attention_flash_backward(t(dout), t(q), t(seq), t(mask), out),
                    target_attention_flash_backward_ref(t(dout), t(q), t(seq), t(mask), out)):
        assert torch.equal(a, b)
    assert counts == (bse_encode_backward.launches, sdim_query_backward.launches,
                      target_attention_flash_backward.launches)


def test_engine_attend_gradient_matches_jax():
    """SDIMEngine.attend (encode ∘ query, the training forward) on the CPU:
    d/d seq of <dout, attend> against jax.grad of the XLA formulation, for
    single candidates (B, d), the pointwise CTR shape."""
    shape = (4, 64, 1, 32, 48, 3)
    seq, q, mask, R, dout = _inputs(shape, seed=6)
    eng = SDIMEngine(EngineConfig(m=48, tau=3, d=32), R=torch.from_numpy(R), device="cpu")
    sa = torch.from_numpy(seq).requires_grad_()
    out = eng.attend(torch.from_numpy(q[:, 0]), sa, torch.from_numpy(mask))
    assert out.shape == (4, 32)
    torch.sum(out * torch.from_numpy(dout[:, 0])).backward()
    jdseq, _, _ = _jax_sdim_grads(seq, q, mask, R, dout, 3)
    np.testing.assert_allclose(sa.grad.numpy(), jdseq, **FP32)


@pytest.mark.parametrize("vocab, n", [(80, 4096), (8000, 4096), (6, 0)])
def test_embedding_gradient_is_summed_per_id(vocab, n):
    """The embedding lookup's backward of the card (``nn.layers.
    _EmbeddingFn``: gradient rows summed per id by ``index_put_(accumulate=
    True)``, one owner per id), run on the CPU, against autograd of
    ``F.embedding`` and ``jax.grad`` of the JAX package's ``table[ids]``,
    with ids repeated thousands of times (80 categories) and not (8,000
    items), and no lookup at all. FP32 tolerance: the same sums in another
    order."""
    from repro_torch.nn.layers import Embedding, _EmbeddingFn, embedding

    rng = np.random.default_rng(vocab)
    table = rng.standard_normal((vocab, 16)).astype(np.float32)
    ids = rng.integers(0, vocab, (n // 64, 64)) if n else np.zeros((0, 64), np.int64)
    dout = rng.standard_normal((*ids.shape, 16)).astype(np.float32)
    w = torch.tensor(table, requires_grad=True)
    (_EmbeddingFn.apply(w, torch.as_tensor(ids)) * torch.as_tensor(dout)).sum().backward()
    ours, w.grad = w.grad, None
    (torch.nn.functional.embedding(torch.as_tensor(ids), w) * torch.as_tensor(dout)).sum().backward()
    want = jax.grad(lambda t: jnp.sum(t[jnp.asarray(ids)] * dout))(jnp.asarray(table))
    torch.testing.assert_close(ours, w.grad, **FP32)
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), **FP32)
    # the CPU lookup keeps the native backward (one owner per id there too)
    assert embedding(torch.as_tensor(ids), w).grad_fn.name() == "EmbeddingBackward0"
    assert Embedding(vocab, 16)(torch.as_tensor(ids)).shape == (*ids.shape, 16)
