"""Port parity, the four other CTR archs: ``wide_deep``, ``bst``, ``dien``
and ``bert4rec`` of ``repro_torch`` against the JAX package on the CPU.

The layers first (LayerNorm, the tanh GELU, RoPE, the bidirectional
attention and the post-LN encoder block with a wholly masked row, GRU and
AUGRU on front-padded masks), each from the JAX package's own init; then
each arch at its SMOKE config, plus ``dien`` with ``embed_dim=18`` so that
the behavior width d = 36 of ``dien`` FULL reaches the SDIM plain
versions: logits, loss and the whole gradient tree (``export_params(grad=
True)`` against ``jax.grad``), and ``score_candidates_many`` decoupled
(bucket tables), fused (precomputed interest) and inline, with
``sparse_ids`` for ``wide_deep``. The weights are the JAX init carried
across by ``load_jax_params``; the JAX side runs its XLA backend. The item
rows that a case hashes (every valid history row and every candidate) are
redrawn until each clears 1e-3·‖r‖‖x‖ (``kernels.screen``; asserted), so
both frameworks agree on every signature bit. User 0 of every batch has
no behavior at all: a zero bucket table, DIEN's state carried through
every step, and uniform attention in BERT4Rec's encoder. Last, the
launchers run each arch with ``--device cpu``.

Tolerance: fp32 atol 1e-5 / rtol 1e-5, as ``tests/test_torch_train.py``
(the same arithmetic in another order).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ctr import CTRModel as JCTRModel
from repro.models.ctr import EncoderBlock as JEncoderBlock
from repro.nn import attention as jattention
from repro.nn import layers as jlayers
from repro.nn import rnn as jrnn
from repro_torch.data import synthetic
from repro_torch.kernels.screen import hashed_behaviors, item_rows_clear, screen_item_rows
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models.ctr import CTRModel, EncoderBlock
from repro_torch.nn import attention
from repro_torch.nn.layers import ACTIVATIONS, LayerNorm
from repro_torch.nn.rnn import AUGRU, GRU
from repro_torch.weights import export_params, load_jax_params

FP32 = dict(atol=1e-5, rtol=1e-5)
ARCH_IDS = ("wide-deep", "bst", "dien", "bert4rec")
CASES = ARCH_IDS + ("dien-d36",)      # dien at its FULL behavior width d = 2 * 18
B, N_USERS, C = 8, 3, 5


def _t(x):
    return torch.from_numpy(np.array(x))                # a writable copy


def _flat(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_trees_close(ours, theirs, **tol):
    ours, theirs = _flat(ours), _flat(theirs)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], err_msg=k, **tol)


@torch.no_grad()
def _load_linear(layer, p):
    layer.weight.copy_(_t(np.asarray(p["w"]).T))
    if layer.bias is not None:
        layer.bias.copy_(_t(np.asarray(p["b"])))


@torch.no_grad()
def _load_norm(norm, p):
    norm.scale.copy_(_t(np.asarray(p["scale"])))
    norm.bias.copy_(_t(np.asarray(p["bias"])))


def _load_block(block, p):
    for name in ("wq", "wk", "wv", "wo"):
        _load_linear(getattr(block.attn, name), p["attn"][name])
    _load_norm(block.ln1, p["ln1"])
    _load_norm(block.ln2, p["ln2"])
    for i in range(2):
        _load_linear(getattr(block.mlp, f"fc{i}"), p["mlp"][f"fc{i}"])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_layernorm_and_tanh_gelu_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 7, 24)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(24).astype(np.float32),
         "bias": rng.standard_normal(24).astype(np.float32)}
    norm = LayerNorm(24, device="cpu")
    _load_norm(norm, p)
    want = jlayers.LayerNorm(24).apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    np.testing.assert_allclose(norm(_t(x)).detach().numpy(), np.asarray(want), **FP32)
    assert [n for n, _ in norm.named_parameters()] == ["scale", "bias"]
    np.testing.assert_allclose(ACTIVATIONS["gelu"](_t(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))), **FP32)


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 11, 2, 8)).astype(np.float32)
    pos = np.arange(11)[None].astype(np.int32)
    jcos, jsin = jattention.rope_frequencies(8, jnp.asarray(pos))
    cos, sin = attention.rope_frequencies(8, _t(pos))
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), **FP32)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), **FP32)
    np.testing.assert_allclose(attention.apply_rope(_t(x), cos, sin).numpy(),
                               np.asarray(jattention.apply_rope(jnp.asarray(x), jcos, jsin)),
                               **FP32)


def test_attention_and_encoder_block_with_a_wholly_masked_row_match_jax():
    """GQAttention (bidirectional, biased, RoPE) and the post-LN encoder
    block; batch row 1 has every key masked and attends uniformly."""
    rng = np.random.default_rng(2)
    d, H, T = 16, 2, 9
    x = rng.standard_normal((3, T, d)).astype(np.float32)
    mask = (rng.random((3, T)) > 0.3).astype(np.float32)
    mask[1] = 0
    jattn = jattention.GQAttention(d, H, H, d // H, use_bias=True, causal=False)
    p = jattn.init(jax.random.PRNGKey(3))
    attn = attention.GQAttention(d, H, d // H, device="cpu")
    for name in ("wq", "wk", "wv", "wo"):
        _load_linear(getattr(attn, name), p[name])
    amask = np.broadcast_to(mask[:, None, :] > 0, (3, T, T))
    want = jattn.apply(p, jnp.asarray(x), mask=jnp.asarray(amask))
    with torch.no_grad():
        got = attn(_t(x), mask=_t(amask))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)

    jblock = JEncoderBlock(d, H)
    pb = jblock.init(jax.random.PRNGKey(4))
    block = EncoderBlock(d, H, device="cpu")
    _load_block(block, pb)
    want = jblock.apply(pb, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got = block(_t(x), _t(mask))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


def test_gru_and_augru_on_front_padded_masks_match_jax():
    """Both recurrences carry the state through masked steps; AUGRU's
    update is (1 - a z) h + a z n. Row 0 is wholly masked."""
    rng = np.random.default_rng(5)
    Bg, T, d_in, H = 4, 10, 12, 6
    x = rng.standard_normal((Bg, T, d_in)).astype(np.float32)
    lengths = np.array([0, 3, 7, 10])
    mask = (np.arange(T)[None] >= T - lengths[:, None]).astype(np.float32)
    att = rng.random((Bg, T)).astype(np.float32)
    jgru, jaugru = jrnn.GRU(d_in, H), jrnn.AUGRU(H, H)
    pg, pa = jgru.init(jax.random.PRNGKey(6)), jaugru.init(jax.random.PRNGKey(7))
    gru, augru = GRU(d_in, H, device="cpu"), AUGRU(H, H, device="cpu")
    with torch.no_grad():
        for mod, p in ((gru, pg), (augru, pa)):
            for name in ("wx", "wh", "b"):
                getattr(mod, name).copy_(_t(np.asarray(p[name])))
        hs, h = gru(_t(x), mask=_t(mask))
        hs2, h2 = augru(hs, _t(att), mask=_t(mask))
    jhs, jh = jgru.apply(pg, jnp.asarray(x), mask=jnp.asarray(mask))
    jhs2, jh2 = jaugru.apply(pa, jhs, jnp.asarray(att), mask=jnp.asarray(mask))
    for got, want in ((hs, jhs), (h, jh), (hs2, jhs2), (h2, jh2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    assert not h[0].any() and not h2[0].any()


# ---------------------------------------------------------------------------
# the archs
# ---------------------------------------------------------------------------
def _configs(case):
    """(port config, JAX config, arch id) of a case, the JAX side on XLA."""
    arch_id = case.removesuffix("-d36")
    module = arch_id.replace("-", "_")
    cfg = importlib.import_module(f"repro_torch.configs.{module}").SMOKE
    jcfg = importlib.import_module(f"repro.configs.{module}").SMOKE
    jcfg = dataclasses.replace(jcfg, interest=dataclasses.replace(jcfg.interest, backend="xla"))
    if case.endswith("-d36"):
        cfg, jcfg = (dataclasses.replace(c, embed_dim=18) for c in (cfg, jcfg))
    assert dataclasses.asdict(cfg)["arch"] == jcfg.arch
    return cfg, jcfg, arch_id


def _inputs(cfg, seed):
    """A training batch of B and a serving burst of N_USERS users with C
    candidates each, as numpy; user 0 of both has no behavior."""
    dcfg = synthetic.SyntheticCTRConfig(hist_len=cfg.long_len, n_items=cfg.n_items,
                                        n_cats=cfg.n_cats)
    rng = np.random.default_rng(seed + 7)
    batch = synthetic.generate_batch(dcfg, B, seed)
    batch["hist_mask"][0] = 0
    users = synthetic.generate_batch(dcfg, N_USERS, seed + 1)
    users = {k: users[k] for k in ("hist_items", "hist_cats", "hist_mask")}
    users["hist_mask"][0] = 0
    serve = {"cand_item": rng.integers(0, cfg.n_items, (N_USERS, C)).astype(np.int32),
             "cand_cat": rng.integers(0, cfg.n_cats, (N_USERS, C)).astype(np.int32),
             "ctx": rng.integers(0, 2, (N_USERS, C, cfg.ctx_dim)).astype(np.float32)}
    if cfg.arch == "wide_deep":
        batch["sparse_ids"] = rng.integers(0, cfg.field_vocab, (B, cfg.n_sparse)).astype(np.int32)
        serve["sparse_ids"] = rng.integers(0, cfg.field_vocab,
                                           (N_USERS, C, cfg.n_sparse)).astype(np.int32)
    return batch, users, serve


@pytest.fixture(scope="module", params=CASES)
def arch_case(request):
    """(port config, JAX model, params as numpy, batch, users, serve): the
    JAX init with the item rows that the case hashes screened."""
    cfg, jcfg, _ = _configs(request.param)
    jmodel = JCTRModel(jcfg)
    params_np = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    batch, users, serve = _inputs(cfg, 3)
    model = load_jax_params(CTRModel(cfg, device="cpu"), params_np)
    hashed = [{k: _t(v) for k, v in batch.items()},
              {**{k: _t(v) for k, v in users.items()},
               "cand_item": _t(serve["cand_item"]), "cand_cat": _t(serve["cand_cat"])}]
    screen_item_rows(model, hashed, torch.Generator().manual_seed(0))
    for b in hashed:
        assert bool(item_rows_clear(model, *hashed_behaviors(model, b)).all())
    return cfg, jmodel, export_params(model), batch, users, serve


def _model(cfg, params_np):
    return load_jax_params(CTRModel(cfg, device="cpu"), params_np)


def _jparams(params_np):
    return jax.tree_util.tree_map(jnp.asarray, params_np)


def test_params_round_trip_and_cover_the_jax_tree(arch_case):
    """``load_jax_params`` then ``export_params`` gives the JAX tree back,
    leaf for leaf (the stacked field tables as field_tables.f{i})."""
    cfg, jmodel, params_np, *_ = arch_case
    _assert_trees_close(export_params(_model(cfg, params_np)), params_np, atol=0, rtol=0)


def test_logits_match_jax(arch_case):
    cfg, jmodel, params_np, batch, _, _ = arch_case
    want = jmodel.apply(_jparams(params_np), {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = _model(cfg, params_np).apply({k: _t(v) for k, v in batch.items()})
    assert got.shape == (B,) and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


def test_loss_and_gradient_tree_match_jax(arch_case):
    """The loss and every parameter's gradient (R's is zero on both sides)
    against jax.grad of the JAX model's loss."""
    cfg, jmodel, params_np, batch, _, _ = arch_case
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(_jparams(params_np))
    model = _model(cfg, params_np)
    loss, _ = model.loss({k: _t(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **FP32)
    grads = export_params(model, grad=True)
    _assert_trees_close(grads, jax.tree_util.tree_map(np.asarray, jgrads), **FP32)
    arch_leaf = {"wide_deep": ("field_tables", "f0"), "bst": ("pos_emb",),
                 "dien": ("gru", "wh"), "bert4rec": ("in_proj", "w")}[cfg.arch]
    node = grads
    for k in arch_leaf:
        node = node[k]
    assert np.abs(node).max() > 0            # the arch's own params learn


@pytest.mark.parametrize("mode", ["decoupled", "fused", "inline"])
def test_score_candidates_many_matches_jax(arch_case, mode):
    """A burst of N_USERS requests of C candidates: decoupled (bucket
    tables encoded by each side's engine), fused (each side's long-term
    interest of the tables handed in as ``interest``) and inline."""
    cfg, jmodel, params_np, _, users, serve = arch_case
    model, jparams = _model(cfg, params_np), _jparams(params_np)
    jusers = {k: jnp.asarray(v) for k, v in users.items()}
    tusers = {k: _t(v) for k, v in users.items()}
    sids = serve.get("sparse_ids")
    jkw, kw = {}, {}
    with torch.no_grad():
        if mode != "inline":
            jtables = jmodel.encode_bse_table(jparams, jusers)
            tables = model.encode_bse_table(tusers)
            np.testing.assert_allclose(tables.numpy(), np.asarray(jtables), **FP32)
            assert not tables[0].any()                      # user 0: no behavior
            jkw["bucket_tables"], kw["bucket_tables"] = jtables, tables
        if mode == "fused":
            jq = jmodel._embed_behaviors(jparams, jnp.asarray(serve["cand_item"]),
                                         jnp.asarray(serve["cand_cat"]))
            q = model._embed_behaviors(_t(serve["cand_item"]), _t(serve["cand_cat"]))
            jkw = {"interest": jmodel.engine.query(jq, jkw["bucket_tables"],
                                                   R=jparams["interest"]["buffers"]["R"])}
            kw = {"interest": model.engine.serve_fused(tables, np.arange(N_USERS), q)}
            np.testing.assert_allclose(kw["interest"].numpy(), np.asarray(jkw["interest"]),
                                       **FP32)
        got = model.score_candidates_many(
            tusers, _t(serve["cand_item"]), _t(serve["cand_cat"]), _t(serve["ctx"]),
            sparse_ids=None if sids is None else _t(sids), **kw)
    want = jmodel.score_candidates_many(
        jparams, jusers, jnp.asarray(serve["cand_item"]), jnp.asarray(serve["cand_cat"]),
        jnp.asarray(serve["ctx"]), sparse_ids=None if sids is None else jnp.asarray(sids),
        **jkw)
    assert got.shape == (N_USERS, C) and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


@pytest.fixture(scope="module")
def dien_target_case():
    """(port config, JAX model, params as numpy, batch): dien at its FULL
    behavior width d = 36 with interest kind "target" (the long branch is
    target attention, kernel 6 on the card), from the JAX init."""
    cfg, jcfg, _ = _configs("dien-d36")
    cfg, jcfg = (dataclasses.replace(c, interest=dataclasses.replace(c.interest, kind="target"))
                 for c in (cfg, jcfg))
    jmodel = JCTRModel(jcfg)
    params_np = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    batch, _, _ = _inputs(cfg, 5)
    assert cfg.behavior_dim == 36
    return cfg, jmodel, params_np, batch


def test_dien_d36_with_kind_target_logits_match_jax(dien_target_case):
    cfg, jmodel, params_np, batch = dien_target_case
    want = jmodel.apply(_jparams(params_np), {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = _model(cfg, params_np).apply({k: _t(v) for k, v in batch.items()})
    assert got.shape == (B,) and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


def test_dien_d36_with_kind_target_gradient_tree_matches_jax(dien_target_case):
    """The loss and every parameter's gradient through target attention at
    d = 36 (user 0 has no behavior: uniform weights) against jax.grad."""
    cfg, jmodel, params_np, batch = dien_target_case
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(_jparams(params_np))
    model = _model(cfg, params_np)
    loss, _ = model.loss({k: _t(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **FP32)
    grads = export_params(model, grad=True)
    _assert_trees_close(grads, jax.tree_util.tree_map(np.asarray, jgrads), **FP32)
    assert np.abs(grads["item_emb"]["table"]).max() > 0      # through the long branch too


def test_wide_deep_refuses_to_score_without_fields():
    cfg, _, _ = _configs("wide-deep")
    model = CTRModel(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    batch, _, _ = _inputs(cfg, 0)
    del batch["sparse_ids"]
    with pytest.raises(ValueError, match="sparse_ids"):
        model.apply({k: _t(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_serve_launcher_runs_each_arch_on_the_cpu(arch_id, capsys):
    launch_serve.main(["--arch", arch_id, "--requests", "3", "--candidates", "8",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    scores = [float(line.rsplit("score ", 1)[1].rstrip(")"))
              for line in out.splitlines() if line.startswith("req ")]
    assert len(scores) == 3 and np.isfinite(scores).all()
    assert "health: live=True ready=True" in out


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_train_launcher_runs_each_arch_on_the_cpu(arch_id):
    out = launch_train.main(["--arch", arch_id, "--steps", "3", "--batch", "8",
                             "--device", "cpu"])
    assert out["stopped_at"] == 3
    assert all(np.isfinite(m["loss"]) for _, m in out["history"])
