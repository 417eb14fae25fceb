"""Port parity, the LM stack: ``repro_torch``'s layers, attention, blocks
and ``LMModel`` (the dense GQA archs granite-3-2b, qwen3-8b,
command-r-plus-104b; deepseek-moe-16b, MoE; deepseek-v2-236b, MLA and MoE)
against the JAX package on the CPU.

The layers first (RMSNorm, SiLU and the gated FFN, tied logits, RoPE at
θ = 1e6), then ``GQAttention`` with grouped kv heads and qk-norm on its
masked path, its query-chunked causal path (a small ``q_chunk``) and
``decode_step`` against a cache, then ``Block``, ``Stack`` and the model's
``forward`` (with the MoE aux loss), ``prefill`` and ``loss`` for each of
the five archs at SMOKE, all from the JAX package's own init carried
across by ``weights.load_jax_lm_params``. FULL is checked by shapes only:
the port's parameters on ``device="meta"`` against ``jax.eval_shape`` of
the reference's init (qwen3-8b: 8,190,735,360 parameters;
deepseek-moe-16b: 16,375,728,128; deepseek-v2-236b cut to 2 layers, as
chip_smoke.py runs it: 5,358,679,040). Last: the params round trip, the
registry, the serve launcher's LM branch and its refusals (the same flags
the JAX launcher refuses), the train launcher's refusal and the example.
The MoE FFN and MLA are held module by module in
``tests/test_torch_{moe,mla}.py``; decode with SDIM-compressed KV is in
``tests/test_torch_lm_decode.py``.

Tolerances: fp32 atol 1e-5 / rtol 1e-5 per module (the reference's own,
``tests/test_kernels.py:46-58``), atol 1e-4 / rtol 1e-4 for model logits
and loss (two layers of the same arithmetic in another order); bf16
compute rtol 2e-2 (the reference's bf16 tolerance).
"""
import dataclasses
import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.launch import serve as jlaunch_serve
from repro.models.lm import LMModel as JLMModel
from repro.nn import attention as jattention
from repro.nn import layers as jlayers
from repro.nn import transformer as jtransformer
from repro_torch.configs import registry
from repro_torch.examples import lm_decode_sdim
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models.lm import LMModel
from repro_torch.nn import attention
from repro_torch.nn.layers import ACTIVATIONS, Embedding, GatedMLP, RMSNorm
from repro_torch.nn.transformer import Block, Stack
from repro_torch.weights import _lm_leaves, export_lm_params, load_jax_lm_params

FP32 = dict(atol=1e-5, rtol=1e-5)
MODEL = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=1e-2, rtol=2e-2)
LM_IDS = ("granite-3-2b", "qwen3-8b", "command-r-plus-104b", "deepseek-moe-16b",
          "deepseek-v2-236b")
FULL_PARAMS = {"qwen3-8b": 8_190_735_360, "deepseek-moe-16b": 16_375_728_128}


def _t(x):
    return torch.from_numpy(np.array(x))                # a writable copy


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jmod(arch_id):
    return jregistry.get(arch_id)


@torch.no_grad()
def _load_linear(layer, p):
    layer.weight.copy_(_t(np.asarray(p["w"]).T))
    if layer.bias is not None:
        layer.bias.copy_(_t(np.asarray(p["b"])))


@torch.no_grad()
def _load_attn(attn, p):
    for name in ("wq", "wk", "wv", "wo"):
        _load_linear(getattr(attn, name), p[name])
    if attn.qk_norm:
        attn.q_norm.scale.copy_(_t(p["q_norm"]["scale"]))
        attn.k_norm.scale.copy_(_t(p["k_norm"]["scale"]))


def _model(arch_id, seed=0):
    """(JAX model, its params, the port's model with them and the
    reference's R) at SMOKE."""
    jm = JLMModel(_jmod(arch_id).SMOKE)
    params = jm.init(jax.random.PRNGKey(seed))
    model = LMModel(registry.get(arch_id).SMOKE, device="cpu")
    load_jax_lm_params(model, _np_tree(params), np.asarray(jm._sdim_R()))
    return jm, params, model


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 7, 24)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(24).astype(np.float32)
    norm = RMSNorm(24, device="cpu")
    with torch.no_grad():
        norm.scale.copy_(_t(scale))
    want = jlayers.RMSNorm(24).apply({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    np.testing.assert_allclose(norm(_t(x)).detach().numpy(), np.asarray(want), **FP32)
    assert [n for n, _ in norm.named_parameters()] == ["scale"] and norm.eps == 1e-6
    xb = _t(x).to(torch.bfloat16)                             # fp32 math, cast back
    assert norm(xb).dtype == torch.bfloat16


def test_silu_gated_mlp_and_tied_logits_match_jax():
    rng = np.random.default_rng(1)
    d, f, V = 16, 40, 30
    x = rng.standard_normal((3, 5, d)).astype(np.float32)
    np.testing.assert_allclose(ACTIVATIONS["silu"](_t(x)).numpy(),
                               np.asarray(jax.nn.silu(jnp.asarray(x))), **FP32)
    jmlp = jlayers.GatedMLP(d, f)
    p = jmlp.init(jax.random.PRNGKey(2))
    mlp = GatedMLP(d, f, device="cpu")
    for name in ("wi_gate", "wi_up", "wo"):
        _load_linear(getattr(mlp, name), p[name])
        assert getattr(mlp, name).bias is None
    with torch.no_grad():
        got = mlp(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jmlp.apply(p, jnp.asarray(x))), **FP32)

    jemb = jlayers.Embedding(V, d)
    pe = jemb.init(jax.random.PRNGKey(3))
    emb = Embedding(V, d, device="cpu")
    with torch.no_grad():
        emb.weight.copy_(_t(pe["table"]))
        got = emb.attend(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jemb.attend(pe, jnp.asarray(x))), **FP32)


def test_rope_at_theta_1e6_matches_jax():
    """qwen3's rope_theta; positions up to a 2k prefill."""
    rng = np.random.default_rng(4)
    pos = np.concatenate([np.arange(40), [511, 1024, 2047]])[None].astype(np.int32)
    x = rng.standard_normal((1, pos.shape[1], 3, 16)).astype(np.float32)
    jcos, jsin = jattention.rope_frequencies(16, jnp.asarray(pos), 1e6)
    cos, sin = attention.rope_frequencies(16, _t(pos), 1e6)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), **FP32)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), **FP32)
    np.testing.assert_allclose(attention.apply_rope(_t(x), cos, sin).numpy(),
                               np.asarray(jattention.apply_rope(jnp.asarray(x), jcos, jsin)),
                               **FP32)


# ---------------------------------------------------------------------------
# grouped-query attention
# ---------------------------------------------------------------------------
def _gqa_pair(qk_norm=True, q_chunk=1024, seed=5, H=4, Hkv=2, D=8, d=16):
    jattn = jattention.GQAttention(d, H, Hkv, D, qk_norm=qk_norm, rope_theta=1e6,
                                   q_chunk=q_chunk)
    p = jattn.init(jax.random.PRNGKey(seed))
    attn = attention.GQAttention(d, H, D, n_kv_heads=Hkv, qk_norm=qk_norm, use_bias=False,
                                 rope_theta=1e6, causal=True, q_chunk=q_chunk, device="cpu")
    _load_attn(attn, p)
    return jattn, p, attn


def test_causal_mask_matches_jax():
    for q_len, kv_len, off in ((4, 4, 0), (3, 9, 6), (1, 7, 6)):
        np.testing.assert_array_equal(attention._causal_mask(q_len, kv_len, off).numpy(),
                                      np.asarray(jattention._causal_mask(q_len, kv_len, off)))


@pytest.mark.parametrize("qk_norm", [True, False])
def test_gqattention_masked_matches_jax(qk_norm):
    """Causal (T < 2 * q_chunk: the masked path) and an explicit random mask
    with a wholly masked query row."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    jattn, p, attn = _gqa_pair(qk_norm)
    with torch.no_grad():
        got = attn(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jattn.apply(p, jnp.asarray(x))), **FP32)
    mask = rng.random((2, 9, 9)) > 0.4
    mask[1, 3] = False
    with torch.no_grad():
        got = attn(_t(x), mask=_t(mask))
    want = jattn.apply(p, jnp.asarray(x), mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


def test_gqattention_chunked_matches_jax_and_the_masked_path():
    """T = 16 >= 2 * q_chunk (4): both packages scan query chunks."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, 16)).astype(np.float32)
    jattn, p, attn = _gqa_pair(q_chunk=4)
    with torch.no_grad():
        got = attn(_t(x))
        attn.q_chunk = 64                                     # now the masked path
        masked = attn(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jattn.apply(p, jnp.asarray(x))), **FP32)
    np.testing.assert_allclose(got.numpy(), masked.numpy(), **FP32)
    attn.q_chunk = 5
    with pytest.raises(ValueError, match="q_chunk"):
        attn._attend_chunked(*attn.qkv(_t(x), torch.arange(16)[None]))


def test_gqattention_decode_step_matches_jax():
    """Six tokens into an 8-row fp32 cache: outputs and the cache; the
    cache is written in place."""
    rng = np.random.default_rng(8)
    xs = rng.standard_normal((6, 2, 1, 16)).astype(np.float32)
    jattn, p, attn = _gqa_pair()
    jc = jattn.init_cache(2, 8, jnp.float32)
    c = attn.init_cache(2, 8, torch.float32)
    k_buf = c["k"]
    for i, x in enumerate(xs):
        want, jc = jattn.decode_step(p, jnp.asarray(x), jc, i)
        with torch.no_grad():
            got, c = attn.decode_step(_t(x), c, i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    assert c["k"] is k_buf
    for name in ("k", "v"):                   # the port's cache is head-major
        np.testing.assert_allclose(c[name].numpy(), np.asarray(jc[name]).swapaxes(1, 2),
                                   **FP32)
    with pytest.raises(ValueError, match="position 8"):
        attn.decode_step(_t(xs[0]), c, 8)


def test_gqattention_decode_splits_long_caches_over_rows(monkeypatch):
    """With 2-row chunks, steps that attend to 4-7 rows sum their values
    chunk by chunk (with and without rows left over): outputs against JAX
    and against the one-product sum, and ``_weighted_values`` alone."""
    rng = np.random.default_rng(9)
    xs = rng.standard_normal((7, 2, 1, 16)).astype(np.float32)
    jattn, p, attn = _gqa_pair()
    jc = jattn.init_cache(2, 8, jnp.float32)
    c, whole = attn.init_cache(2, 8, torch.float32), attn.init_cache(2, 8, torch.float32)
    for i, x in enumerate(xs):
        want, jc = jattn.decode_step(p, jnp.asarray(x), jc, i)
        with torch.no_grad():
            one, _ = attn.decode_step(_t(x), whole, i)
            with monkeypatch.context() as m:
                m.setattr(attention, "DECODE_ROW_CHUNK", 2)
                got, c = attn.decode_step(_t(x), c, i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
        np.testing.assert_allclose(got.numpy(), one.numpy(), **FP32)
    monkeypatch.setattr(attention, "DECODE_ROW_CHUNK", 3)
    for n in (5, 6, 7, 13):
        pr = torch.softmax(torch.from_numpy(rng.standard_normal((2, 2, 3, n))).float(), -1)
        v = torch.from_numpy(rng.standard_normal((2, 2, n, 16))).float()
        np.testing.assert_allclose(attention._weighted_values(pr, v).numpy(),
                                   torch.matmul(pr, v).numpy(), **FP32)


def test_encoder_defaults_are_bidirectional_and_biased():
    """The CTR encoder's call (``models/ctr.py``): as many kv heads as
    query heads, biased projections, no causal mask."""
    attn = attention.GQAttention(16, 2, 8, device="cpu")
    assert attn.n_kv_heads == 2 and not attn.causal and attn.wk.bias is not None


# ---------------------------------------------------------------------------
# blocks, stack, model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch_id", LM_IDS)
def test_block_and_stack_match_jax(arch_id):
    jm, params, model = _model(arch_id, seed=1)
    jcfg = jm.stack.cfg
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 6, jcfg.d_model)).astype(np.float32)
    lp = jax.tree_util.tree_map(lambda a: a[0], params["stack"])
    want, jaux = jtransformer.Block(jcfg).apply(lp, jnp.asarray(x))
    with torch.no_grad():
        got, aux = model.stack[0](_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    np.testing.assert_allclose(float(aux), float(jaux), **FP32)    # 0 for a dense FFN
    want, jaux = jtransformer.Stack(jcfg, jm.cfg.n_scan_layers).apply(params["stack"],
                                                                       jnp.asarray(x))
    with torch.no_grad():
        got, aux = model.stack(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    np.testing.assert_allclose(float(aux), float(jaux), **FP32)
    for i, lp in enumerate(params.get("dense_blocks", [])):          # first_k_dense
        want, _ = jm.dense_block.apply(lp, jnp.asarray(x))
        with torch.no_grad():
            got, aux = model.dense_blocks[i](_t(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
        assert float(aux) == 0.0
    assert isinstance(model.stack, Stack) and isinstance(model.stack[-1], Block)


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_forward_prefill_and_loss_match_jax(arch_id):
    jm, params, model = _model(arch_id, seed=2)
    toks = np.random.default_rng(10).integers(0, jm.cfg.vocab, (2, 12)).astype(np.int32)
    jh, jaux = jm.forward(params, jnp.asarray(toks))
    with torch.no_grad():
        h, aux = model(_t(toks))
        logits = model.prefill(_t(toks))
        loss = model.loss(_t(toks[:, :-1]), _t(toks[:, 1:]))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **MODEL)
    np.testing.assert_allclose(float(aux), float(jaux), **FP32)      # 0 for a dense stack
    assert (float(aux) > 0.0) == (jm.cfg.moe is not None)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jm.prefill(params, jnp.asarray(toks))),
                               **MODEL)
    want = jm.loss(params, jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:]))
    np.testing.assert_allclose(float(loss), float(want), **MODEL)


def test_loss_in_bf16_compute_matches_jax():
    """``compute_dtype="bfloat16"``: the loss off a bf16 cast of the
    parameters (the reference's ``_cast_compute``); the fp32 parameters
    are left as they were."""
    jcfg = dataclasses.replace(_jmod("qwen3-8b").SMOKE, compute_dtype="bfloat16")
    jm = JLMModel(jcfg)
    params = jm.init(jax.random.PRNGKey(3))
    model = LMModel(dataclasses.replace(registry.get("qwen3-8b").SMOKE,
                                        compute_dtype="bfloat16"), device="cpu")
    load_jax_lm_params(model, _np_tree(params), np.asarray(jm._sdim_R()))
    toks = np.random.default_rng(11).integers(0, jcfg.vocab, (2, 10)).astype(np.int32)
    with torch.no_grad():
        loss = model.loss(_t(toks[:, :-1]), _t(toks[:, 1:]))
    want = jm.loss(params, jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:]))
    np.testing.assert_allclose(float(loss), float(want), **BF16)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def _flat_shapes(shapes) -> dict:
    """jax.eval_shape's tree as {dotted path: shape} (a list index is a
    number)."""
    key = lambda k: getattr(k, "key", getattr(k, "idx", None))
    return {".".join(str(key(k)) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}


def _port_shapes(model) -> dict:
    out = {}
    for path, (t, transpose) in _lm_leaves(model).items():
        one = t[0] if isinstance(t, list) else t
        shape = tuple(one.shape)[::-1] if transpose else tuple(one.shape)
        out[path] = (len(t), *shape) if isinstance(t, list) else shape
    return out


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_full_parameter_shapes_match_jax(arch_id):
    """FULL on ``device="meta"`` (no memory) against ``jax.eval_shape`` of
    the reference's init: every leaf's shape and the parameter count."""
    jm = JLMModel(_jmod(arch_id).FULL)
    flat = _flat_shapes(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    model = LMModel(registry.get(arch_id).FULL, device="meta")
    assert _port_shapes(model) == flat
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(s)) for s in flat.values())
    dk = jm.cfg.kv_lora_rank if jm.cfg.attention == "mla" else jm.cfg.head_dim
    assert model.R.shape == (jm.cfg.sdim_m, dk)
    if arch_id in FULL_PARAMS:
        assert n == FULL_PARAMS[arch_id]


def test_deepseek_v2_at_two_layers_has_the_shapes_chip_smoke_runs():
    """deepseek-v2-236b at full width cut to 2 layers (first_k_dense 1 and
    one MoE layer), on ``device="meta"`` against ``jax.eval_shape``."""
    jcfg = dataclasses.replace(_jmod("deepseek-v2-236b").FULL, n_layers=2)
    flat = _flat_shapes(jax.eval_shape(JLMModel(jcfg).init, jax.random.PRNGKey(0)))
    model = LMModel(dataclasses.replace(registry.get("deepseek-v2-236b").FULL, n_layers=2),
                    device="meta")
    assert _port_shapes(model) == flat
    assert sum(p.numel() for p in model.parameters()) == 5_358_679_040


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_lm_params_round_trip(arch_id):
    jm, params, model = _model(arch_id, seed=4)
    out = export_lm_params(model)
    ours, theirs = jax.tree_util.tree_flatten_with_path(out)[0], \
        jax.tree_util.tree_flatten_with_path(_np_tree(params))[0]
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    for (path, a), (_, b) in zip(ours, theirs):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    np.testing.assert_array_equal(model.R.numpy(), np.asarray(jm._sdim_R()))
    assert model.R64.equal(model.R.double())                # the keys' fp64 copy follows
    bad = _np_tree(params)
    ffn = bad["stack"]["ffn"]                                 # one layer short
    if "experts" in ffn:                                      # a mixture of experts
        ffn["experts"]["wo"] = ffn["experts"]["wo"][:-1]
    else:
        ffn["wo"]["w"] = ffn["wo"]["w"][:-1]
    with pytest.raises(ValueError, match="layers"):
        load_jax_lm_params(model, bad, np.asarray(jm._sdim_R()))
    extra = _np_tree(params)
    extra["spare"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="leaves"):
        load_jax_lm_params(model, extra, np.asarray(jm._sdim_R()))


# ---------------------------------------------------------------------------
# registry, launchers, example
# ---------------------------------------------------------------------------
def test_registry_holds_the_dense_lm_archs():
    for arch_id in LM_IDS:
        mod = registry.get(arch_id)
        assert mod.FAMILY == "lm" and arch_id in registry.ARCH_IDS
        for name in ("FULL", "SMOKE"):
            assert dataclasses.asdict(getattr(mod, name)) == \
                dataclasses.asdict(getattr(_jmod(arch_id), name))
    assert registry.LM_SHAPES == jregistry.LM_SHAPES
    with pytest.raises(KeyError, match="GNN slice"):
        registry.get("gatedgcn")
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get("gpt-5")


@pytest.mark.parametrize("sdim_kv", [False, True])
@pytest.mark.parametrize("arch_id", LM_IDS)
def test_serve_launcher_decodes_each_lm_arch_on_the_cpu(arch_id, sdim_kv, capsys):
    argv = ["--arch", arch_id, "--tokens", "4", "--device", "cpu"] + (["--sdim-kv"] if sdim_kv
                                                                      else [])
    launch_serve.main(argv)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    kind = "SDIM-compressed" if sdim_kv else "exact"
    assert last.startswith(f"decoded 4 tokens ({kind} KV); last token id ")
    assert 0 <= int(last.rsplit(" ", 1)[1]) < registry.get(arch_id).SMOKE.vocab


REFUSED = [["--shards", "2"], ["--mesh", "1x2"], ["--hot-capacity", "4"],
           ["--table-dtype", "int8"], ["--fused-serve", "--micro-batch", "2"],
           ["--async-ingest"], ["--rate-limit", "10"], ["--max-concurrency", "2"],
           ["--trace"], ["--profile"], ["--profile-dir", "x"]]


@pytest.mark.parametrize("flags", REFUSED, ids=lambda f: f[0].lstrip("-"))
def test_serve_launcher_refuses_recsys_flags_for_an_lm_arch_as_jax_does(flags, monkeypatch,
                                                                        capsys):
    argv = ["--arch", "qwen3-8b", "--tokens", "2"] + flags
    with pytest.raises(SystemExit) as ours:
        launch_serve.main(argv + ["--device", "cpu"])
    msg = capsys.readouterr().err
    assert ours.value.code == 2 and "is family 'lm'" in msg
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(SystemExit) as theirs:
        jlaunch_serve.main()
    assert theirs.value.code == 2 and "is family 'lm'" in capsys.readouterr().err


@pytest.mark.parametrize("flags", REFUSED[::2], ids=lambda f: f[0].lstrip("-"))
@pytest.mark.parametrize("arch_id", ["deepseek-moe-16b", "deepseek-v2-236b"])
def test_serve_launcher_refuses_recsys_flags_for_the_moe_and_mla_archs(arch_id, flags,
                                                                       monkeypatch, capsys):
    argv = ["--arch", arch_id, "--tokens", "2"] + flags
    with pytest.raises(SystemExit) as ours:
        launch_serve.main(argv + ["--device", "cpu"])
    assert ours.value.code == 2 and "is family 'lm'" in capsys.readouterr().err
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(SystemExit) as theirs:
        jlaunch_serve.main()
    assert theirs.value.code == 2 and "is family 'lm'" in capsys.readouterr().err


def test_train_launcher_refuses_an_lm_arch():
    for arch_id in ("granite-3-2b", "deepseek-moe-16b"):
        with pytest.raises(NotImplementedError, match="'lm'.*A3c"):
            launch_train.main(["--arch", arch_id, "--steps", "1", "--device", "cpu"])


def test_example_state_is_constant_in_the_context(capsys):
    short = lm_decode_sdim.main(["--ctx", "8", "--device", "cpu"])
    long = lm_decode_sdim.main(["--ctx", "24", "--device", "cpu"])
    assert short["sdim_bytes"] == long["sdim_bytes"]
    assert long["exact_bytes"] > short["exact_bytes"]
    assert 0.0 <= long["overlap"] <= 1.0 + 1e-6 and 0 <= long["top10"] <= 10
    assert "top-10 overlap" in capsys.readouterr().out
