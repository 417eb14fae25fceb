"""Port parity of the sharded LM training state: the parameter-sharding
rules (``distributed/sharding.py``), the LM model under ``mesh=`` with the
residual constrained, the manual Megatron FFN (``distributed/manual_tp.py``)
and the MoE FFN's per-shard capacity, and the decode paths under a mesh.

The JAX package shards over a device mesh, so its side runs in ONE
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` and a
(2, 4) ``("data", "model")`` mesh, as ``tests/test_torch_mesh_paths.py``,
and writes its results to a pickle under ``tmp_path``; the port runs the
same numpy inputs over ``MeshCtx(("cpu",) * 4, data=2)``:

* (i) for every arch of ``ARCH_IDS`` (five LM, one GNN, five recsys), every
  leaf of the FULL tree (``jax.eval_shape`` of the reference's init against
  ``weights.reference_shapes`` of the port's model on ``device="meta"``):
  ``valid_for_mesh(param_spec(...))`` and ``zero1_spec`` on a (16, 16)
  mesh with ZeRO over ``("data",)``, a (2, 16, 16) one over ``("pod",
  "data")`` and the (2, 4) one; the reference's mesh is a stand-in with
  ``.shape``, the port's the same plain mapping;
* (ii) the reference test ``test_distributed.py:93-115``: 2 layers, d 64,
  ``act_seq_shard``, the parameters through ``shard_params`` (the port:
  placed as blocks and gathered back), remat "full": the loss and the whole
  gradient tree;
* (iii) the same with ``manual_tp``;
* (iv) deepseek-moe-16b SMOKE with dp = 2 where tokens drop (the batch's
  tokens drawn from two ids, so they crowd onto a few experts): the loss
  and aux loss equal the reference's mesh loss, not the one-device loss;
* (v) ``prefill``, ``decode_step`` and ``sdim_decode_step`` with ``mesh=``
  for deepseek-moe-16b and deepseek-v2-236b SMOKE (8 tokens, B = 2; the
  seeds whose hashed keys and queries clear 1e-4, as in
  ``tests/test_torch_lm_decode.py``).

In-process (vi): ``manual_tp_gated_ffn`` raises where B, T, d_ff or d do
not divide, and ``MeshCtx.constrain`` behaves as the reference's
``with_sharding_constraint`` under ``jit`` (found in the subprocess): a
vocab of 130 over 4 model blocks passes, an unknown axis or a spec longer
than the array raises.

Tolerances: the reference's: fp32 1e-5 (gradients 1e-5 of the largest),
bf16 ``manual_tp`` rtol 2e-2 (of the largest for gradients), decode logits
1e-4.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core import sdim
from repro_torch.distributed import sharding
from repro_torch.distributed.manual_tp import manual_tp_gated_ffn
from repro_torch.distributed.mesh_ctx import MeshCtx
from repro_torch.distributed.sharding import (gather_tree, param_spec, shard_params,
                                              spec_tree, valid_for_mesh, zero1_spec)
from repro_torch.kernels.screen import clears_margin
from repro_torch.models.ctr import CTRModel
from repro_torch.models.gnn import GatedGCN
from repro_torch.models.lm import LMConfig, LMModel
from repro_torch.nn.layers import GatedMLP
from repro_torch.weights import export_lm_params, load_jax_lm_params, reference_shapes

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))
CTX = MeshCtx(("cpu",) * 4, data=2)
MESHES = {"16x16": ({"data": 16, "model": 16}, ("data",)),
          "2x16x16": ({"pod": 2, "data": 16, "model": 16}, ("pod", "data")),
          "2x4": ({"data": 2, "model": 4}, ("data",))}
# the reference's test_distributed.py:97-98
LM_CFG = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
              d_ff=128, vocab=128, remat="full")
LM_B, LM_T = 8, 16
MOE_B, MOE_T, MOE_IDS = 4, 16, 2
# JAX init key and token seed per arch (tests/test_torch_lm_decode.py's SEEDS)
DECODE_SEEDS = {"deepseek-moe-16b": 0, "deepseek-v2-236b": 5}
DECODE_B, DECODE_TOKENS, HASH_MARGIN = 2, 8, 1e-4
FP32_REL, BF16_REL = 1e-5, 2e-2
LAYOUTS = {"seq": dict(act_seq_shard=True), "tp": dict(act_seq_shard=True, manual_tp=True)}

JAX_SIDE = r'''
import functools, pickle, re, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import registry
from repro.distributed.compat import make_auto_mesh
from repro.distributed.mesh_ctx import MeshCtx
from repro.distributed.sharding import param_spec, shard_params, valid_for_mesh, zero1_spec
from repro.models.ctr import CTRModel
from repro.models.gnn import GatedGCN
from repro.models.lm import LMConfig, LMModel

out_path = sys.argv[1]
(MESHES, LM_CFG, LM_B, LM_T, MOE_B, MOE_T, MOE_IDS, DECODE_SEEDS, DECODE_B, DECODE_TOKENS,
 LAYOUTS) = eval(sys.argv[2])
mesh = make_auto_mesh((2, 4), ("data", "model"))
np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
dotted = lambda key: ".".join(re.findall(r"\['?([^'\]]+)'?\]", key))
res = {}


class Shape:
    """A mesh for the rules: its .shape only."""
    def __init__(self, shape):
        self.shape = shape


# (i) every arch's FULL tree, every leaf's specs
CLASSES = {"lm": LMModel, "recsys": CTRModel, "gnn": GatedGCN}
specs = {}
for arch in registry.ARCH_IDS:
    mod = registry.get(arch)
    tree = jax.eval_shape(CLASSES[mod.FAMILY](mod.FULL).init, jax.random.PRNGKey(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = jax.tree_util.keystr(path)
        shape = tuple(leaf.shape)
        base = param_spec(mod.FAMILY, key, shape)
        for name, (sizes, data_axes) in MESHES.items():
            m = Shape(sizes)
            specs[(arch, name, dotted(key))] = (
                shape, key, tuple(valid_for_mesh(base, shape, m)),
                tuple(zero1_spec(base, shape, m, data_axes)))
res["specs"] = specs

# with_sharding_constraint at a dimension the axes do not divide, under jit
x = jnp.ones((2, 3, 130))
def wsc(*spec):
    try:
        with mesh:
            jax.jit(lambda x: jax.lax.with_sharding_constraint(
                x, NamedSharding(mesh, P(*spec))) * 2)(x).block_until_ready()
        return "passes"
    except Exception as e:
        return "raises"
res["constrain"] = {"uneven": wsc("data", None, "model"), "unknown": wsc("data", None, "pod"),
                    "long": wsc("data", None, "model", None)}

# (ii), (iii) the reference test's LM: loss and gradients under the mesh
cfg = LMConfig(**LM_CFG)
m = LMModel(cfg)
p = m.init(jax.random.PRNGKey(0))
rng = np.random.default_rng(1)
toks = rng.integers(0, cfg.vocab, (LM_B, LM_T)).astype(np.int32)
tgts = rng.integers(0, cfg.vocab, (LM_B, LM_T)).astype(np.int32)
lm = {"params": np_tree(p), "R": np.asarray(m._sdim_R()), "toks": toks, "tgts": tgts,
      "local": float(m.loss(p, jnp.asarray(toks), jnp.asarray(tgts)))}
with mesh:
    ps = shard_params(p, "lm", mesh)
lm["shard_specs"] = {dotted(jax.tree_util.keystr(path)): tuple(leaf.sharding.spec)
                     for path, leaf in jax.tree_util.tree_flatten_with_path(ps)[0]}
for name, kw in LAYOUTS.items():
    ctx = MeshCtx(mesh, data_axes=("data",), **kw)
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: m.loss(p, jnp.asarray(toks), jnp.asarray(tgts), mesh=ctx)))(ps)
    lm[name] = {"loss": float(loss), "grads": np_tree(grads)}
res["lm"] = lm

# (iv) deepseek-moe SMOKE with dp = 2, tokens of MOE_IDS ids: experts drop tokens
cfg = registry.get("deepseek-moe-16b").SMOKE
m = LMModel(cfg)
p = m.init(jax.random.PRNGKey(0))
toks = np.random.default_rng(0).integers(0, MOE_IDS, (MOE_B, MOE_T + 1)).astype(np.int32)
a, b = jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:])
ctx = MeshCtx(mesh)
with mesh:
    loss = jax.jit(lambda p: m.loss(p, a, b, mesh=ctx))(p)
    aux = jax.jit(lambda p: m.forward(p, a, mesh=ctx)[1])(p)
res["moe"] = {"params": np_tree(p), "R": np.asarray(m._sdim_R()), "toks": toks,
              "loss": float(loss), "aux": float(aux), "local": float(m.loss(p, a, b)),
              "local_aux": float(m.forward(p, a)[1])}

# (v) prefill, exact and SDIM decode under the mesh
for arch, seed in DECODE_SEEDS.items():
    cfg = registry.get(arch).SMOKE
    m = LMModel(cfg)
    p = m.init(jax.random.PRNGKey(seed))
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (DECODE_B, DECODE_TOKENS)).astype(np.int32)
    ctx = MeshCtx(mesh)
    exact = jax.jit(functools.partial(m.decode_step, mesh=ctx))
    compressed = jax.jit(functools.partial(m.sdim_decode_step, mesh=ctx))
    cache, scache = m.init_cache(DECODE_B, DECODE_TOKENS, jnp.float32), m.init_sdim_cache(DECODE_B)
    logits, slogits = [], []
    with mesh:
        prefill = np.asarray(jax.jit(lambda p, t: m.prefill(p, t, mesh=ctx))(p, jnp.asarray(toks)))
        for i in range(DECODE_TOKENS):
            lg, cache = exact(p, jnp.asarray(toks[:, i:i + 1]), cache, i)
            slg, scache = compressed(p, jnp.asarray(toks[:, i:i + 1]), scache)
            logits.append(np.asarray(lg))
            slogits.append(np.asarray(slg))
    res[arch] = {"params": np_tree(p), "R": np.asarray(m._sdim_R()), "toks": toks,
                 "prefill": prefill, "logits": logits, "slogits": slogits}

with open(out_path, "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX package's side on 8 faked host devices, in one subprocess."""
    out = tmp_path_factory.mktemp("jax_sharding") / "jax.pkl"
    consts = repr((MESHES, LM_CFG, LM_B, LM_T, MOE_B, MOE_T, MOE_IDS, DECODE_SEEDS, DECODE_B,
                   DECODE_TOKENS, LAYOUTS))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", JAX_SIDE, str(out), consts],
                         capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _t(x):
    return torch.from_numpy(np.array(x))


def _flat(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _assert_trees_close(ours, theirs, rel):
    """Every leaf within atol ``rel`` · the tree's largest |value| and rtol
    ``rel``."""
    ours, theirs = _flat(ours), _flat(theirs)
    assert sorted(ours) == sorted(theirs)
    atol = rel * max(float(np.abs(v).max()) for v in theirs.values())
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], atol=atol, rtol=rel, err_msg=k)


# ---------------------------------------------------------------------------
# (i) the rules on every arch's FULL tree
# ---------------------------------------------------------------------------
_CLASSES = {"lm": LMModel, "recsys": CTRModel, "gnn": GatedGCN}


@pytest.mark.parametrize("arch_id", registry.ARCH_IDS)
def test_specs_of_every_full_leaf_match_the_reference(jax_side, arch_id):
    family = registry.family(arch_id)
    shapes = reference_shapes(_CLASSES[family](registry.get(arch_id).FULL, device="meta"))
    want = {(name, path): v for (arch, name, path), v in jax_side["specs"].items()
            if arch == arch_id}
    assert {path for _, path in want} == set(shapes)
    for (name, path), (shape, keystr, valid, zero1) in want.items():
        sizes, data_axes = MESHES[name]
        assert shapes[path] == shape, path
        for p in (path, keystr):              # dotted and keystr paths alike
            base = param_spec(family, p, shape)
            assert valid_for_mesh(base, shape, sizes) == valid, (name, p)
            assert zero1_spec(base, shape, sizes, data_axes) == zero1, (name, p)


def test_the_rules_cover_stacked_transposed_and_uneven_leaves(jax_side):
    """Rank decides the spec: the stacked (L, in, out) leaf is not the port's
    per-layer (out, in) tensor; granite's 49,155-row vocab stays replicated
    at 4 and 16 model blocks; a MeshCtx is a mesh for the rules too."""
    specs = jax_side["specs"]
    shape, _, valid, _ = specs[("granite-3-2b", "2x4", "stack.attn.wq.w")]
    assert len(shape) == 3 and valid == (None, None, "model")
    assert param_spec("lm", "stack.attn.wq.w", shape[::-1][:2]) == (None, "model")
    for name in ("16x16", "2x4"):
        assert specs[("granite-3-2b", name, "embed.table")][2] == ()
    assert specs[("deepseek-moe-16b", "2x4", "dense_blocks.0.ffn.wo.w")][2] == ("model",)
    assert specs[("wide-deep", "2x4", "field_tables.f0")][2] == ("model",)   # one leaf a field
    assert valid_for_mesh(("model", None), (49155, 2048), CTX) == ()
    assert valid_for_mesh(("model", None), (49156, 2048), CTX) == ("model",)
    assert sharding.table_store_spec() == ("model", None, None, None, None)
    shape = specs[("granite-3-2b", "2x4", "stack.ffn.wo.w")][0]
    assert sharding.param_sharding_fn("lm", CTX)("stack/ffn/wo/w", shape) == \
        sharding.Placement(CTX, specs[("granite-3-2b", "2x4", "stack.ffn.wo.w")][2])
    assert sharding.opt_state_sharding_fn("lm", CTX)("stack/ffn/wo/w", shape).spec == \
        specs[("granite-3-2b", "2x4", "stack.ffn.wo.w")][3]


# ---------------------------------------------------------------------------
# (ii), (iii) the LM under the mesh
# ---------------------------------------------------------------------------
def _lm(jax_side, **over):
    model = LMModel(dataclasses.replace(LMConfig(**LM_CFG), **over), device="cpu")
    return load_jax_lm_params(model, jax_side["lm"]["params"], jax_side["lm"]["R"])


def test_shard_params_places_blocks_and_gathers_back(jax_side):
    model = _lm(jax_side)
    tree = export_lm_params(model)
    placed = shard_params(tree, "lm", CTX)
    assert {k.replace("/", "."): v for k, v in spec_tree(placed).items()} == \
        jax_side["lm"]["shard_specs"]
    wq = placed["stack"]["attn"]["wq"]["w"]                   # (L, in, out): out over model
    assert wq.grid == (1, 1, 4) and len(wq.blocks) == 4
    assert all(b.shape == (2, 64, 16) for b in wq.blocks)
    whole = _flat(gather_tree(placed))
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(whole[k], v, err_msg=k)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_lm_loss_and_gradients_under_the_mesh_match_the_reference(jax_side, layout):
    lm = jax_side["lm"]
    src = _lm(jax_side)
    gathered = gather_tree(shard_params(export_lm_params(src), "lm", CTX))
    model = load_jax_lm_params(LMModel(LMConfig(**LM_CFG), device="cpu"),
                               _to_numpy(gathered), lm["R"])
    ctx = dataclasses.replace(CTX, **LAYOUTS[layout])
    loss = model.loss(_t(lm["toks"]), _t(lm["tgts"]), mesh=ctx)
    loss.backward()
    rel = FP32_REL if layout == "seq" else BF16_REL
    want = lm[layout]
    np.testing.assert_allclose(float(loss.detach()), want["loss"], atol=rel, rtol=rel)
    _assert_trees_close(export_lm_params(model, grad=True), want["grads"], rel)
    if layout == "seq":
        assert abs(float(loss.detach()) - lm["local"]) < FP32_REL


def _to_numpy(tree):
    return sharding.map_tree(lambda _, t: t.numpy() if torch.is_tensor(t) else t, tree)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_remat_full_gives_the_bits_of_none_under_the_mesh(jax_side, layout):
    lm = jax_side["lm"]
    ctx = dataclasses.replace(CTX, **LAYOUTS[layout])
    runs = []
    for remat in ("full", "none"):
        model = _lm(jax_side, remat=remat)
        loss = model.loss(_t(lm["toks"]), _t(lm["tgts"]), mesh=ctx)
        loss.backward()
        runs.append((loss.detach(), {n: p.grad for n, p in model.named_parameters()}))
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)


def test_manual_tp_is_bf16_and_not_the_dense_ffn(jax_side):
    """The manual FFN's loss lies within bf16 of the fp32 one, not on it."""
    lm = jax_side["lm"]
    model = _lm(jax_side)
    with torch.no_grad():
        tp = float(model.loss(_t(lm["toks"]), _t(lm["tgts"]),
                              mesh=dataclasses.replace(CTX, **LAYOUTS["tp"])))
    assert tp != lm["local"] and abs(tp - lm["local"]) < BF16_REL * abs(lm["local"])
    assert abs(tp - lm["tp"]["loss"]) < BF16_REL * abs(lm["tp"]["loss"])


# ---------------------------------------------------------------------------
# (iv) MoE: one data shard's capacity
# ---------------------------------------------------------------------------
def test_moe_loss_under_the_mesh_drops_as_the_reference(jax_side):
    r = jax_side["moe"]
    model = load_jax_lm_params(LMModel(registry.get("deepseek-moe-16b").SMOKE, device="cpu"),
                               r["params"], r["R"])
    a, b = _t(r["toks"][:, :-1]), _t(r["toks"][:, 1:])
    seen = []
    hook = model.stack[0].ffn.register_forward_pre_hook(lambda mod, args: seen.append(args[0]))
    with torch.no_grad():
        loss = float(model.loss(a, b, mesh=CTX))
        aux = float(model(a, mesh=CTX)[1])
        local = float(model.loss(a, b))
        probs = model.stack[0].ffn._route(seen[0])[0].numpy()
    hook.remove()
    s = -np.sort(-probs, axis=-1)
    assert (s[..., 1] - s[..., 2] > 1e-5).all()               # routes apart: same choices
    np.testing.assert_allclose(loss, r["loss"], atol=FP32_REL, rtol=FP32_REL)
    np.testing.assert_allclose(aux, r["aux"], atol=FP32_REL, rtol=FP32_REL)
    np.testing.assert_allclose(local, r["local"], atol=FP32_REL, rtol=FP32_REL)
    assert abs(loss - local) > 100 * FP32_REL                   # tokens dropped differently
    assert abs(r["loss"] - r["local"]) > 100 * FP32_REL


# ---------------------------------------------------------------------------
# (v) decode under the mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch_id", list(DECODE_SEEDS))
def test_prefill_and_decode_under_the_mesh_match_the_reference(jax_side, arch_id, monkeypatch):
    r = jax_side[arch_id]
    model = load_jax_lm_params(LMModel(registry.get(arch_id).SMOKE, device="cpu"),
                               r["params"], r["R"])
    hashed = []
    fold, attend = sdim.kv_bucket_fold, sdim.sdim_decode_attention

    def rec_fold(vt, ct, k, v, R, tau):
        hashed.append(k.numpy().reshape(-1, k.shape[-1]))
        fold(vt, ct, k, v, R, tau)

    def rec_attend(q, *args, **kw):
        hashed.append(q.numpy().reshape(-1, q.shape[-1]))
        return attend(q, *args, **kw)

    monkeypatch.setattr(sdim, "kv_bucket_fold", rec_fold)
    monkeypatch.setattr(sdim, "sdim_decode_attention", rec_attend)
    toks = r["toks"]
    with torch.no_grad():
        np.testing.assert_allclose(model.prefill(_t(toks), mesh=CTX).numpy(), r["prefill"],
                                   atol=1e-4, rtol=1e-4)
        cache, scache = model.init_cache(DECODE_B, DECODE_TOKENS, torch.float32), \
            model.init_sdim_cache(DECODE_B)
        for i in range(DECODE_TOKENS):
            tok = _t(toks[:, i:i + 1])
            lg, cache = model.decode_step(tok, cache, i, mesh=CTX)
            slg, scache = model.sdim_decode_step(tok, scache, mesh=CTX)
            np.testing.assert_allclose(lg.numpy(), r["logits"][i], atol=1e-4, rtol=1e-4,
                                       err_msg=f"exact step {i}")
            np.testing.assert_allclose(slg.numpy(), r["slogits"][i], atol=1e-4, rtol=1e-4,
                                       err_msg=f"sdim step {i}")
    assert clears_margin(np.concatenate(hashed), r["R"], HASH_MARGIN).all()


# ---------------------------------------------------------------------------
# (vi) in process: refusals and constrain
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,d_ff,what", [((4, 6, 8), 16, "sequence"),
                                             ((4, 8, 8), 18, "FFN width"),
                                             ((3, 8, 8), 16, "batch"),
                                             ((4, 8, 9), 16, "model width")])
def test_manual_tp_raises_where_shapes_do_not_divide(shape, d_ff, what):
    ffn = GatedMLP(shape[-1], d_ff, device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match=what):
        manual_tp_gated_ffn(x, ffn, CTX)


def test_manual_tp_matches_the_dense_ffn_within_bf16():
    ffn = GatedMLP(16, 32, device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.randn((4, 8, 16), generator=torch.Generator().manual_seed(1), requires_grad=True)
    y = manual_tp_gated_ffn(x, ffn, CTX)
    ref = ffn(x)
    assert y.dtype == x.dtype and y.shape == ref.shape
    scale = float(ref.detach().abs().max())
    assert float((y - ref).detach().abs().max()) < BF16_REL * scale
    y.sum().backward()                       # differentiable: to x and every weight
    assert x.grad is not None and all(p.grad is not None for p in ffn.parameters())


def test_constrain_behaves_as_the_reference_under_jit(jax_side):
    found = jax_side["constrain"]
    assert found == {"uneven": "passes", "unknown": "raises", "long": "raises"}
    x = torch.ones((2, 3, 130))
    assert CTX.constrain(x, "data", None, "model") is x
    with pytest.raises(ValueError):
        CTX.constrain(x, "data", None, "pod")
    with pytest.raises(ValueError):
        CTX.constrain(x, "data", None, "model", None)
    seq = dataclasses.replace(CTX, act_seq_shard=True)
    assert seq.constrain_residual(x) is x and CTX.constrain_residual(x) is x
