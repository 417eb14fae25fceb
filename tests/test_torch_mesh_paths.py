"""Port parity of the model code's ``shard_map`` paths on ``MeshCtx`` shards:
GatedGCN's edge-sharded scatter, the MoE layer's expert parallelism and the
split-KV sequence-parallel LM decode (GQA and MLA), on the CPU.

The JAX package shards over a device mesh, so its side runs in ONE
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` and a
(2, 4) ``("data", "model")`` mesh, the reference's own distributed tests'
(``tests/test_distributed.py:34-90``), and writes its parameters, inputs and
outputs to a pickle under ``tmp_path``; the port runs the same numpy inputs
over ``MeshCtx(("cpu",) * 4, data=2)``:

* the GNN loss with the edges sharded over ``("data", "model")`` (8 blocks)
  and over ``("model",)`` (4 blocks), with and without an ``edge_mask``,
  and the sharded loss's gradient tree;
* the MoE layer's expert-parallel output and aux loss (B = 4 rows over the
  data axis, 8 experts over the model axis) at ``capacity_factor`` 64 and at
  1.0, where tokens drop: the port matches the reference's EP path, whose
  capacity is one data shard's;
* ``sp_decode_step``'s logits and new k/v (ckv/krope) with ``seq_axes=
  ("data", "model")`` and with ``data_axes=("data",), seq_axes=("model",)``
  for the reference test's GQA LM and for deepseek-v2-236b SMOKE (MLA, MoE
  and a dense first block), after 12 exact decode steps.

In-process: the port raises where the sequence, the batch, the edges or the
experts do not divide by their shard counts, as ``shard_map`` does, and the
cache given as a list of shards (``nn/attention.shard_seq``) reads the same.

Tolerances: the reference's, 1e-5 for the GNN loss and the MoE output
(gradients 1e-5 of the largest), 1e-4 for the decode's logits and 1e-5 for
its new k/v.
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
from repro_torch.distributed.mesh_ctx import MeshCtx
from repro_torch.models.gnn import GatedGCN, GatedGCNConfig
from repro_torch.models.lm import LMConfig, LMModel
from repro_torch.nn.attention import shard_seq
from repro_torch.nn.moe import MoELayer
from repro_torch.weights import export_gnn_params, load_jax_gnn_params, load_jax_lm_params

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))
CTX = MeshCtx(("cpu",) * 4, data=2)
GNN_CFG = dict(n_layers=3, d_hidden=16, d_feat=8, n_classes=4, remat=False)
GQA_CFG = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
               vocab=64, remat="none")
MOE_CFG = dict(d_model=32, d_ff=16, n_experts=8, top_k=2, n_shared=1)
LAYOUTS = {"long": dict(data_axes=None, seq_axes=("data", "model")),
           "batch": dict(data_axes=("data",), seq_axes=("model",))}
DECODE_STEPS, MAX_LEN, B = 12, 16, 4

JAX_SIDE = r'''
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import registry
from repro.data.graph import random_graph
from repro.distributed.compat import make_auto_mesh
from repro.distributed.mesh_ctx import MeshCtx
from repro.models.gnn import GatedGCN, GatedGCNConfig
from repro.models.lm import LMConfig, LMModel
from repro.nn.moe import MoELayer

out_path = sys.argv[1]
GNN_CFG, GQA_CFG, MOE_CFG, LAYOUTS, DECODE_STEPS, MAX_LEN, B = eval(sys.argv[2])
mesh = make_auto_mesh((2, 4), ("data", "model"))
np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
res = {}

# GatedGCN: the loss with the edges sharded, with and without an edge mask
model = GatedGCN(GatedGCNConfig(**GNN_CFG))
p = model.init(jax.random.PRNGKey(0))
g = random_graph(64, 256, 8, seed=0, n_classes=4)
g["edge_mask"] = (np.random.default_rng(1).uniform(size=256) > 0.3).astype(np.float32)
plain = {k: jnp.asarray(v) for k, v in g.items() if k != "edge_mask"}
masked = {k: jnp.asarray(v) for k, v in g.items()}
gnn = {"params": np_tree(p), "graph": g}
for name, graph, axes in (("dm", plain, ("data", "model")), ("m", plain, ("model",)),
                          ("dm_mask", masked, ("data", "model"))):
    with mesh:
        gnn[name] = float(jax.jit(lambda p, g: model.loss(p, g, mesh=mesh, axes=axes))(p, graph))
with mesh:
    gnn["grads"] = np_tree(jax.jit(jax.grad(
        lambda p: model.loss(p, plain, mesh=mesh, axes=("data", "model"))))(p))
res["gnn"] = gnn

# MoE: expert-parallel output and aux loss, nothing dropped and tokens dropped
# (a shared offset crowds the tokens onto a few experts)
rng = np.random.default_rng(3)
u = rng.standard_normal(32).astype(np.float32)
x = (rng.standard_normal((4, 8, 32)).astype(np.float32) + 2.0 * u).astype(np.float32)
res["moe"] = {"x": x}
for cf in (64.0, 1.0):
    layer = MoELayer(**MOE_CFG, capacity_factor=cf)
    p = layer.init(jax.random.PRNGKey(0))
    with mesh:
        y, aux = jax.jit(lambda p, x: layer.apply(p, x, mesh=mesh))(p, jnp.asarray(x))
    y_loc, _ = layer.apply(p, jnp.asarray(x))
    res["moe"][cf] = {"params": np_tree(p), "y": np.asarray(y), "aux": float(aux),
                      "y_local": np.asarray(y_loc)}

# split-KV decode after DECODE_STEPS exact steps
for arch, cfg in (("gqa", LMConfig(**GQA_CFG)), ("mla", registry.get("deepseek-v2-236b").SMOKE)):
    m = LMModel(cfg)
    p = m.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    caches = m.init_cache(B, MAX_LEN, jnp.float32)
    step = jax.jit(m.decode_step)
    for i in range(DECODE_STEPS):
        _, caches = step(p, jnp.asarray(rng.integers(0, cfg.vocab, (B, 1)), jnp.int32), caches, i)
    tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    lg_ref, _ = m.decode_step(p, jnp.asarray(tok), caches, DECODE_STEPS)
    out = {"params": np_tree(p), "R": np.asarray(m._sdim_R()), "caches": np_tree(caches),
           "tok": tok, "exact": np.asarray(lg_ref)}
    for name, kw in LAYOUTS.items():
        ctx = MeshCtx(mesh, **kw)
        with mesh:
            lg, new = jax.jit(lambda p, t, c: m.sp_decode_step(p, t, c, DECODE_STEPS, ctx))(
                p, jnp.asarray(tok), caches)
        out[name] = {"logits": np.asarray(lg), "new": np_tree(new)}
    res[arch] = out

with open(out_path, "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX package's mesh paths on 8 faked host devices, in one
    subprocess."""
    out = tmp_path_factory.mktemp("jax_mesh") / "jax.pkl"
    consts = repr((GNN_CFG, GQA_CFG, MOE_CFG, LAYOUTS, DECODE_STEPS, MAX_LEN, B))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", JAX_SIDE, str(out), consts],
                         capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _ctx(name):
    return dataclasses.replace(CTX, **LAYOUTS[name])


# ---------------------------------------------------------------------------
# GatedGCN, edge-sharded
# ---------------------------------------------------------------------------
def _gnn(jax_side):
    model = load_jax_gnn_params(GatedGCN(GatedGCNConfig(**GNN_CFG), device="cpu"),
                                jax_side["gnn"]["params"])
    g = {k: torch.as_tensor(v) for k, v in jax_side["gnn"]["graph"].items()}
    return model, g


@pytest.mark.parametrize("case,axes,masked", [("dm", ("data", "model"), False),
                                              ("m", ("model",), False),
                                              ("dm_mask", ("data", "model"), True)])
def test_gnn_edge_sharded_loss_matches_jax(jax_side, case, axes, masked):
    model, g = _gnn(jax_side)
    if not masked:
        g.pop("edge_mask")
    with torch.no_grad():
        loss = float(model.loss(g, mesh=CTX, axes=axes))
        local = float(model.loss(g))
    assert abs(loss - jax_side["gnn"][case]) < 1e-5
    assert abs(loss - local) < 1e-5


def test_gnn_edge_sharded_gradients_match_jax(jax_side):
    model, g = _gnn(jax_side)
    g.pop("edge_mask")
    model.loss(g, mesh=CTX, axes=("data", "model")).backward()
    ours, theirs = _flat(export_gnn_params(model, grad=True)), _flat(jax_side["gnn"]["grads"])
    atol = 1e-5 * max(float(np.abs(v).max()) for v in theirs.values())
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k], v, atol=atol, rtol=1e-5, err_msg=k)


def test_gnn_edges_that_do_not_divide_raise(jax_side):
    model, g = _gnn(jax_side)
    g["edge_index"] = g["edge_index"][:, :250]
    g.pop("edge_mask")
    with pytest.raises(ValueError, match="does not split into 8"):
        model.loss(g, mesh=CTX)
    model.loss(dict(g, edge_index=g["edge_index"][:, :248]), mesh=CTX, axes=("model",))


# ---------------------------------------------------------------------------
# MoE, expert-parallel
# ---------------------------------------------------------------------------
def _moe(jax_side, cf):
    p = jax_side["moe"][cf]["params"]
    layer = MoELayer(*MOE_CFG.values(), capacity_factor=cf, device="cpu")
    with torch.no_grad():
        layer.router.w.copy_(torch.as_tensor(p["router"]["w"]))
        for part in ("experts", "shared"):
            for name, w in p[part].items():
                getattr(getattr(layer, part), name).copy_(torch.as_tensor(w))
    return layer


@pytest.mark.parametrize("cf", [64.0, 1.0])
def test_moe_expert_parallel_matches_jax(jax_side, cf):
    """At 1.0 tokens overflow: the EP path dispatches each data group with
    one data shard's capacity, so it differs from the one-device path, in
    both packages alike."""
    layer = _moe(jax_side, cf)
    x = torch.as_tensor(jax_side["moe"]["x"])
    with torch.no_grad():
        probs = layer._route(x)[0].numpy()
        y, aux = layer(x, mesh=CTX)
        y_local, _ = layer(x)
    s = -np.sort(-probs, axis=-1)
    assert (s[..., 1] - s[..., 2] > 1e-5).all()              # routes apart from rounding
    ref = jax_side["moe"][cf]
    np.testing.assert_allclose(y.numpy(), ref["y"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux), ref["aux"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(y_local.numpy(), ref["y_local"], atol=1e-5, rtol=1e-5)
    drops = float(np.abs(ref["y"] - ref["y_local"]).max())
    assert (drops > 1e-3) == (cf == 1.0)


def test_moe_experts_that_do_not_divide_raise(jax_side):
    layer = _moe(jax_side, 64.0)
    x = torch.as_tensor(jax_side["moe"]["x"])
    with pytest.raises(ValueError, match="experts over 3"):
        layer(x, mesh=MeshCtx(("cpu",) * 3))
    with pytest.raises(ValueError, match="batch over 2"):
        layer(x[:3], mesh=CTX)


def test_moe_places_each_shards_experts_once_per_device(jax_side):
    """Shards on another device name (``cpu:0``) than the weights' take a
    placed copy, kept until the weights change."""
    layer = _moe(jax_side, 64.0)
    x = torch.as_tensor(jax_side["moe"]["x"])
    mesh = MeshCtx(("cpu:0",) * 4, data=2)
    with torch.no_grad():
        y1, _ = layer(x, mesh=mesh)
        placed = {k: v[1] for k, v in layer._placed.items()}
        y2, _ = layer(x, mesh=mesh)
        assert len(placed) == 12 and all(layer._placed[k][1] is v for k, v in placed.items())
        layer.experts.wo.mul_(2.0)
        y3, _ = layer(x, mesh=mesh)
    np.testing.assert_array_equal(y1.numpy(), y2.numpy())
    assert not np.array_equal(y1.numpy(), y3.numpy())
    np.testing.assert_allclose(y1.numpy(), jax_side["moe"][64.0]["y"], atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# split-KV decode
# ---------------------------------------------------------------------------
def _lm(jax_side, arch):
    ref = jax_side[arch]
    cfg = LMConfig(**GQA_CFG) if arch == "gqa" else registry.get("deepseek-v2-236b").SMOKE
    model = load_jax_lm_params(LMModel(cfg, device="cpu"), ref["params"], ref["R"])
    c = ref["caches"]
    if arch == "gqa":          # the port's cache is head-major
        stack = {k: torch.as_tensor(np.ascontiguousarray(v.swapaxes(2, 3)))
                 for k, v in c["stack"].items()}
    else:
        stack = {k: torch.as_tensor(v) for k, v in c["stack"].items()}
    caches = {"stack": stack}
    if "dense" in c:
        caches["dense"] = [{k: torch.as_tensor(v) for k, v in d.items()} for d in c["dense"]]
    return model, caches, torch.as_tensor(ref["tok"])


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ["gqa", "mla"])
def test_sp_decode_matches_jax(jax_side, arch, layout):
    model, caches, tok = _lm(jax_side, arch)
    ref = jax_side[arch]
    before = {k: v.clone() for k, v in caches["stack"].items()}
    with torch.no_grad():
        logits, new = model.sp_decode_step(tok, caches, DECODE_STEPS, _ctx(layout))
    scale = float(np.abs(ref["exact"]).max())
    np.testing.assert_allclose(logits.numpy(), ref[layout]["logits"], atol=1e-4 * scale, rtol=0)
    np.testing.assert_allclose(logits.numpy(), ref["exact"], atol=1e-4 * scale, rtol=0)
    ours, theirs = _flat({k: v for k, v in new.items() if k != "dense"}), _flat(
        {k: v for k, v in ref[layout]["new"].items() if k != "dense"})
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k], v, atol=1e-5, rtol=1e-5, err_msg=k)
    assert len(new.get("dense", [])) == len(ref[layout]["new"].get("dense", []))
    for d, jd in zip(new.get("dense", []), ref[layout]["new"].get("dense", [])):
        for k in jd:
            np.testing.assert_allclose(d[k].numpy(), jd[k], atol=1e-5, rtol=1e-5, err_msg=k)
    for k, v in before.items():                   # the step only reads the cache
        assert torch.equal(caches["stack"][k], v)


@pytest.mark.parametrize("arch", ["gqa", "mla"])
def test_sp_decode_new_kv_is_what_decode_step_writes(jax_side, arch):
    """The new rows match what ``decode_step`` writes at ``cache_len`` (1e-5;
    the first block's bit for bit), and a cache given as its list of shards reads as
    the tensor does."""
    model, caches, tok = _lm(jax_side, arch)
    ctx = _ctx("long")
    with torch.no_grad():
        logits, new = model.sp_decode_step(tok, caches, DECODE_STEPS, ctx)
        axis = 3 if arch == "gqa" else 2                      # S of (L, B, ...)
        sharded = {"stack": {k: shard_seq(v, ctx, ctx.seq_axes, axis)
                             for k, v in caches["stack"].items()}}
        if "dense" in caches:
            sharded["dense"] = [{k: shard_seq(v, ctx, ctx.seq_axes, axis - 1) for k, v in d.items()}
                                for d in caches["dense"]]
        logits2, _ = model.sp_decode_step(tok, sharded, DECODE_STEPS, ctx)
        exact, caches = model.decode_step(tok, caches, DECODE_STEPS)
    torch.testing.assert_close(logits2, logits, atol=0, rtol=0)
    assert float((logits - exact).abs().max()) < 1e-4 * float(exact.abs().max())
    # the first block sees the same input on both paths; later blocks the
    # attention output of the other path, equal up to rounding
    firsts = []
    for name, rows in new["stack"].items():
        written = caches["stack"][name][:, :, :, DECODE_STEPS] if arch == "gqa" else \
            caches["stack"][name][:, :, DECODE_STEPS]
        torch.testing.assert_close(rows[:, :, 0], written, atol=1e-5, rtol=1e-5)
        firsts.append((rows[0, :, 0], written[0]))
    if "dense" in new:
        firsts = [(new["dense"][0][name][:, 0], c[:, DECODE_STEPS])
                  for name, c in caches["dense"][0].items()]
    for rows, written in firsts:
        torch.testing.assert_close(rows, written, atol=0, rtol=0)


def test_sp_decode_refuses_what_does_not_divide(jax_side):
    model, caches, tok = _lm(jax_side, "gqa")
    short = {"stack": {k: v[:, :, :, :12] for k, v in caches["stack"].items()}}
    with torch.no_grad():
        with pytest.raises(ValueError, match="does not split into 8"):
            model.sp_decode_step(tok, short, 10, _ctx("long"))
        with pytest.raises(ValueError, match="batch over batch_axes"):
            model.sp_decode_step(tok[:3], {"stack": {k: v[:3] for k, v in
                                                     caches["stack"].items()}}, 10, _ctx("batch"))
        with pytest.raises(ValueError, match="seq_axes"):
            model.sp_decode_step(tok, caches, 10, CTX)
        with pytest.raises(ValueError, match="cache_len"):
            model.sp_decode_step(tok, caches, MAX_LEN + 1, _ctx("long"))
