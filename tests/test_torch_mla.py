"""Port parity, multi-head latent attention (DeepSeek-V2):
``repro_torch.nn.attention.MLAttention`` against the JAX package's
``MLAttention`` on the CPU, from the JAX init carried across as numpy.

Its query and latent projections (``q``: ``wq_a``, ``q_a_norm``, ``wq_b``,
the nope/rope split, RoPE on ``q_rope``; ``kv_latent``: ``wkv_a``,
``kv_a_norm`` on c_kv, RoPE on the shared ``k_rope``); the absorbed
masked path (causal, and an explicit mask with a wholly masked query
row); the query-chunked causal path (a small ``q_chunk``) against JAX and
the masked path; eight decode steps into a cache written in place,
outputs and both caches ``ckv`` (B, S, r) and ``krope`` (B, S, dr)
compared axis for axis (the reference's layout); steps whose weighted sum
is split over rows (``DECODE_ROW_CHUNK`` patched to 2); FULL widths on
``device="meta"`` against ``jax.eval_shape``.

Tolerances: fp32 atol 1e-5 / rtol 1e-5 (the reference's own,
``tests/test_kernels.py:46-58``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as jattention
from repro_torch.nn import attention

FP32 = dict(atol=1e-5, rtol=1e-5)
SMOKE = dict(kv_lora_rank=32, q_lora_rank=48, nope_head_dim=16, rope_head_dim=8,
             v_head_dim=16)


def _t(x):
    return torch.from_numpy(np.array(x))


@torch.no_grad()
def _pair(seed=0, q_chunk=1024, d=64, H=4):
    """(JAX MLAttention, its params, the port's with them) at SMOKE widths."""
    jattn = jattention.MLAttention(d_model=d, n_heads=H, q_chunk=q_chunk, **SMOKE)
    p = jattn.init(jax.random.PRNGKey(seed))
    attn = attention.MLAttention(d, H, q_chunk=q_chunk, device="cpu", **SMOKE)
    for name in ("wq_a", "wq_b", "wkv_a", "wk_b", "wv_b", "wo"):
        getattr(attn, name).weight.copy_(_t(np.asarray(p[name]["w"]).T))
        assert getattr(attn, name).bias is None
    attn.q_a_norm.scale.copy_(_t(p["q_a_norm"]["scale"]))
    attn.kv_a_norm.scale.copy_(_t(p["kv_a_norm"]["scale"]))
    return jattn, p, attn


def test_query_and_latent_projections_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(100, 109)]).astype(np.int32)
    jattn, p, attn = _pair()
    jq_nope, jq_rope = jattn._q(p, jnp.asarray(x), jnp.asarray(pos))
    jc, jkr = jattn._kv_latent(p, jnp.asarray(x), jnp.asarray(pos))
    with torch.no_grad():
        q_nope, q_rope = attn.q(_t(x), _t(pos))
        c, kr = attn.kv_latent(_t(x), _t(pos))
    for got, want in ((q_nope, jq_nope), (q_rope, jq_rope), (c, jc), (kr, jkr)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    # the absorbed query, as the reference's _attend and sdim_decode_step form it
    wk_b = p["wk_b"]["w"].reshape(32, 4, 16)
    np.testing.assert_allclose(attn.absorb_q(q_nope).detach().numpy(),
                               np.asarray(jnp.einsum("bthd,rhd->bthr", jq_nope, wk_b)), **FP32)


def test_mlattention_masked_matches_jax():
    """Causal (T < 2 * q_chunk: the masked path) and an explicit random mask
    with a wholly masked query row."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    jattn, p, attn = _pair(seed=1)
    with torch.no_grad():
        got = attn(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jattn.apply(p, jnp.asarray(x))), **FP32)
    mask = rng.random((2, 9, 9)) > 0.4
    mask[1, 3] = False
    with torch.no_grad():
        got = attn(_t(x), mask=_t(mask))
    want = jattn.apply(p, jnp.asarray(x), mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


def test_mlattention_chunked_matches_jax_and_the_masked_path():
    """T = 16 >= 2 * q_chunk (4): both packages scan query chunks."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    jattn, p, attn = _pair(seed=2, q_chunk=4)
    with torch.no_grad():
        got = attn(_t(x))
        attn.q_chunk = 64                                     # now the masked path
        masked = attn(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jattn.apply(p, jnp.asarray(x))), **FP32)
    np.testing.assert_allclose(got.numpy(), masked.numpy(), **FP32)
    attn.q_chunk = 5
    pos = torch.arange(16)[None]
    with pytest.raises(ValueError, match="q_chunk"):
        attn._attend_chunked(*attn.q(_t(x), pos), *attn.kv_latent(_t(x), pos))


def test_mlattention_decode_step_matches_jax():
    """Eight tokens into an 8-row fp32 cache: outputs at every step and
    both caches; written in place."""
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((8, 2, 1, 64)).astype(np.float32)
    jattn, p, attn = _pair(seed=3)
    jc = jattn.init_cache(2, 8, jnp.float32)
    c = attn.init_cache(2, 8, torch.float32)
    assert {k: tuple(v.shape) for k, v in c.items()} == {k: v.shape for k, v in jc.items()}
    bufs = dict(c)
    for i, x in enumerate(xs):
        want, jc = jattn.decode_step(p, jnp.asarray(x), jc, i)
        with torch.no_grad():
            got, c = attn.decode_step(_t(x), c, i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32, err_msg=f"step {i}")
    assert all(c[k] is bufs[k] for k in bufs)
    for name in ("ckv", "krope"):                 # the reference's layout, axis for axis
        np.testing.assert_allclose(c[name].numpy(), np.asarray(jc[name]), **FP32)
    with pytest.raises(ValueError, match="position 8"):
        attn.decode_step(_t(xs[0]), c, 8)


def test_mlattention_decode_splits_long_caches_over_rows(monkeypatch):
    """With 2-row chunks, steps that attend to 4-8 rows sum their latent
    rows chunk by chunk: outputs against JAX."""
    rng = np.random.default_rng(4)
    xs = rng.standard_normal((8, 2, 1, 64)).astype(np.float32)
    jattn, p, attn = _pair(seed=4)
    jc = jattn.init_cache(2, 8, jnp.float32)
    c = attn.init_cache(2, 8, torch.float32)
    monkeypatch.setattr(attention, "DECODE_ROW_CHUNK", 2)
    for i, x in enumerate(xs):
        want, jc = jattn.decode_step(p, jnp.asarray(x), jc, i)
        with torch.no_grad():
            got, c = attn.decode_step(_t(x), c, i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32, err_msg=f"step {i}")


def test_mlattention_full_shapes_match_jax():
    """deepseek-v2-236b's widths on ``device="meta"``."""
    kw = dict(kv_lora_rank=512, q_lora_rank=1536, nope_head_dim=128, rope_head_dim=64,
              v_head_dim=128)
    shapes = jax.eval_shape(jattention.MLAttention(d_model=5120, n_heads=128, **kw).init,
                            jax.random.PRNGKey(0))
    flat = {".".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    attn = attention.MLAttention(5120, 128, device="meta", **kw)
    ours = {n.replace("weight", "w"): tuple(t.shape)[::-1] if n.endswith("weight")
            else tuple(t.shape) for n, t in attn.named_parameters()}
    assert ours == flat
    assert attn.scale == 1 / np.sqrt(192)
