"""Port parity, the GNN stack: GatedGCN, the graph generators and the
neighbor sampler, the segment sum, gatedgcn in the registry, the model-flops
yardstick and the launchers, against the JAX package on the CPU.

* The loss and the whole gradient tree (``weights.export_gnn_params(model,
  grad=True)``) against ``jax.value_and_grad(GatedGCN.loss)`` at SMOKE
  widths, for the three graph kinds the reference's smoke test builds
  (``tests/test_smoke_archs.py:103-145``: a full graph, a sampled block
  flattened into its union subgraph with ``edge_mask``, a molecule batch
  with edge features and the graph readout) and a node-masked graph, with
  ``remat`` on and off, on the reference's parameters (``PRNGKey(0)``);
  remat gives the bits of no remat.
* ``data/graph.py``: every generator, the CSR and the sampler give the
  reference's arrays bit for bit from the same seeds; ``flatten_block``
  gives the smoke test's union subgraph.
* ``nn/layers.segment_sum`` against ``jax.ops.segment_sum`` on unsorted ids
  with empty segments, and its gradient, a gather.
* The registry's ``gnn_config_for_shape``, ``sampled_subgraph_sizes``,
  ``cells()`` (40) and ``launch.flops.model_flops`` of the four GNN cells.
* The train launcher's ``gnn_setup``: 5 AdamW steps from the port's init
  carried to the reference's ``train.loop.run``; the launcher itself on the
  CPU; the serve launcher's refusal.

Tolerances: fp32 atol 1e-5 of the largest gradient (or parameter) and rtol
1e-5; losses atol / rtol 1e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.data import graph as jgraph
from repro.data.pipeline import DeterministicStream as JDeterministicStream
from repro.launch import flops as jflops
from repro.models.gnn import GatedGCN as JGatedGCN
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.configs import registry
from repro_torch.data import graph
from repro_torch.launch import flops
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models.gnn import GatedGCN, GatedGCNConfig
from repro_torch.nn.layers import segment_sum
from repro_torch.train.loop import LoopConfig, run
from repro_torch.weights import export_gnn_params, load_jax_gnn_params

REL = 1e-5
LOSS = dict(atol=1e-5, rtol=1e-5)
KINDS = ("full_graph", "sampled", "graph_batch", "node_mask")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _assert_trees_close(ours, theirs, rel=REL):
    """Every leaf within atol ``rel`` · the tree's largest |value| and rtol
    ``rel``."""
    ours, theirs = _flat(ours), _flat(theirs)
    assert sorted(ours) == sorted(theirs)
    atol = rel * max(float(np.abs(v).max()) for v in theirs.values())
    for k in theirs:
        assert np.isfinite(ours[k]).all(), k
        np.testing.assert_allclose(ours[k], theirs[k], atol=atol, rtol=rel, err_msg=k)


def _smoke_flatten(g, blk):
    """The reference smoke test's loop flattening a sampled block."""
    nodes = np.unique(np.concatenate(blk["all_nodes"]))
    remap = {n: i for i, n in enumerate(nodes)}
    srcs, dsts, masks = [], [], []
    frontier = blk["seeds"]
    for layer in blk["layers"]:
        srcs.append(np.array([remap[n] for n in layer["src_nodes"]]))
        dsts.append(np.array([remap[n] for n in frontier[layer["dst_pos"]]]))
        masks.append(layer["mask"])
        frontier = layer["src_nodes"]
    return {"x": g["x"][nodes],
            "edge_index": np.stack([np.concatenate(srcs), np.concatenate(dsts)]).astype(np.int32),
            "edge_mask": np.concatenate(masks), "y": g["y"][nodes]}


def _case(kind):
    """(the reference's SMOKE config for the graph kind, the graph as numpy),
    built as ``tests/test_smoke_archs.py:103-145`` builds them."""
    base = jregistry.get("gatedgcn").SMOKE
    if kind == "graph_batch":
        cfg = dataclasses.replace(base, d_feat=8, d_edge=4, n_classes=1, readout="graph")
        return cfg, jgraph.molecule_batch(batch=4, n_nodes=10, n_edges=16, d_feat=8, d_edge=4)
    cfg = dataclasses.replace(base, d_feat=16, n_classes=4, readout="node")
    g = jgraph.random_graph(100, 400, 16, seed=1, n_classes=4)
    if kind == "sampled":
        blk = jgraph.NeighborSampler(g["edge_index"], 100, [3, 2], seed=0).sample(np.arange(8))
        return cfg, _smoke_flatten(g, blk)
    if kind == "node_mask":
        g["node_mask"] = (np.random.default_rng(2).uniform(size=100) > 0.4).astype(np.float32)
    return cfg, g


@functools.lru_cache(maxsize=None)
def _jax_params(cfg):
    return jax.tree_util.tree_map(np.asarray, JGatedGCN(cfg).init(jax.random.PRNGKey(0)))


def _port(jcfg, params_np):
    """The port's model of the reference's config on its parameters."""
    model = GatedGCN(GatedGCNConfig(**dataclasses.asdict(jcfg)), device="cpu")
    return load_jax_gnn_params(model, params_np)


def _torch_graph(g):
    return {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in g.items()}


def _loss_and_grads(model, g):
    for p in model.parameters():
        p.grad = None
    loss = model.loss(_torch_graph(g))
    loss.backward()
    return float(loss.detach()), export_gnn_params(model, grad=True)


# ---------------------------------------------------------------------------
# the loss and its gradient
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_loss_and_gradient_tree_match_jax(kind, remat):
    jcfg, g = _case(kind)
    jcfg = dataclasses.replace(jcfg, remat=remat)
    params = _jax_params(dataclasses.replace(jcfg, remat=False))
    jm = JGatedGCN(jcfg)
    jg = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in g.items()}
    jloss, jgrads = jax.value_and_grad(jm.loss)(jax.tree_util.tree_map(jnp.asarray, params), jg)
    model = _port(jcfg, params)
    loss, grads = _loss_and_grads(model, g)
    np.testing.assert_allclose(loss, float(jloss), **LOSS)
    _assert_trees_close(grads, jax.tree_util.tree_map(np.asarray, jgrads))
    assert all(p.grad is not None for p in model.parameters())


@pytest.mark.parametrize("kind", KINDS)
def test_remat_gives_the_bits_of_no_remat(kind):
    jcfg, g = _case(kind)
    params = _jax_params(jcfg)
    off = _loss_and_grads(_port(dataclasses.replace(jcfg, remat=False), params), g)
    on = _loss_and_grads(_port(dataclasses.replace(jcfg, remat=True), params), g)
    assert on[0] == off[0]
    for k, v in _flat(off[1]).items():
        np.testing.assert_array_equal(_flat(on[1])[k], v, err_msg=k)


def test_forward_without_edge_attr_reads_a_column_of_ones():
    jcfg, g = _case("full_graph")
    model = _port(jcfg, _jax_params(jcfg))
    ones = dict(g, edge_attr=np.ones((g["edge_index"].shape[1], 1), np.float32))
    with torch.no_grad():
        np.testing.assert_array_equal(model(_torch_graph(g)).numpy(),
                                      model(_torch_graph(ones)).numpy())


def test_params_round_trip_and_refuse_a_wrong_tree():
    jcfg, _ = _case("graph_batch")
    params = _jax_params(jcfg)
    model = _port(jcfg, params)
    out = export_gnn_params(model)
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(_flat(out)[k], v, err_msg=k)
    assert out["layers"]["A"]["w"].shape == (jcfg.n_layers, jcfg.d_hidden, jcfg.d_hidden)
    with pytest.raises(ValueError, match="leaves"):
        load_jax_gnn_params(model, dict(params, extra={"w": np.zeros(1)}))
    short = jax.tree_util.tree_map(lambda a: a, params)
    short["layers"] = {k: {kk: vv[:2] for kk, vv in v.items()} for k, v in params["layers"].items()}
    with pytest.raises(ValueError, match="layers"):
        load_jax_gnn_params(model, short)


# ---------------------------------------------------------------------------
# the segment sum
# ---------------------------------------------------------------------------
def test_segment_sum_matches_jax_on_unsorted_ids_with_empty_segments():
    rng = np.random.default_rng(5)
    data = rng.standard_normal((40, 3, 5)).astype(np.float32)
    ids = rng.choice([0, 2, 3, 7, 8], size=40).astype(np.int32)       # 1, 4-6, 9 empty
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids), 10))
    x = torch.tensor(data, requires_grad=True)
    got = segment_sum(x, torch.as_tensor(ids), 10)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6, rtol=1e-6)
    assert not got[[1, 4, 5, 6, 9]].any()
    w = torch.randn(10, 3, 5)
    (got * w).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), w[torch.as_tensor(ids).long()].numpy())


def test_segment_sum_and_training_give_the_same_bits_twice():
    """A segment sum whose ids repeat (4,096 rows into 512) and two
    trainings of 3 AdamW steps give the same bits on every run."""
    rng = np.random.default_rng(6)
    data = torch.as_tensor(rng.standard_normal((4096, 16)).astype(np.float32))
    ids = torch.as_tensor(rng.integers(0, 512, 4096))
    first = segment_sum(data, ids, 512)
    assert all(torch.equal(segment_sum(data, ids, 512), first) for _ in range(10))
    cfg = registry.get("gatedgcn").SMOKE
    states = []
    for _ in range(2):
        model = GatedGCN(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        loss_fn, stream, opt = launch_train.gnn_setup(cfg)
        run(loss_fn, model, stream, opt, LoopConfig(n_steps=3, log_every=1))
        states.append(model.state_dict())
    for name, x in states[0].items():
        assert torch.equal(x, states[1][name]), name


# ---------------------------------------------------------------------------
# data/graph.py
# ---------------------------------------------------------------------------
def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("seed", [0, 3])
def test_generators_give_the_reference_arrays(seed):
    _assert_same(graph.random_graph(50, 300, 6, seed=seed, n_classes=5),
                 jgraph.random_graph(50, 300, 6, seed=seed, n_classes=5))
    _assert_same(graph.random_graph(50, 300, 6, seed=seed, d_edge=3),
                 jgraph.random_graph(50, 300, 6, seed=seed, d_edge=3))
    _assert_same(graph.cora_like(seed), jgraph.cora_like(seed))
    _assert_same(graph.molecule_batch(6, 9, 20, 4, 2, seed=seed),
                 jgraph.molecule_batch(6, 9, 20, 4, 2, seed=seed))


def test_csr_and_sampler_give_the_reference_arrays():
    g = graph.random_graph(300, 1500, 4, seed=2)
    ei = g["edge_index"].copy()
    ei[1, ei[1] == 17] = 18                                   # node 17: no incoming edge
    csr, jcsr = (graph.CSRGraph.from_edge_index(ei, 300),
                 jgraph.CSRGraph.from_edge_index(ei, 300))
    np.testing.assert_array_equal(csr.indptr, jcsr.indptr)
    np.testing.assert_array_equal(csr.indices, jcsr.indices)
    nodes = np.array([0, 17, 299])
    np.testing.assert_array_equal(csr.degree(nodes), jcsr.degree(nodes))
    ours = graph.NeighborSampler(ei, 300, [5, 3], seed=4)
    theirs = jgraph.NeighborSampler(ei, 300, [5, 3], seed=4)
    for seeds in (np.array([17, 3, 250, 9]), np.arange(20)):
        a, b = ours.sample(seeds), theirs.sample(seeds)
        for x, y in zip(a["all_nodes"], b["all_nodes"]):
            np.testing.assert_array_equal(x, y)
        for la, lb in zip(a["layers"], b["layers"]):
            _assert_same(la, lb)
        flat = graph.flatten_block(g, a)
        _assert_same(flat, _smoke_flatten(g, b))
    assert (a["layers"][0]["mask"][:5] == 1).all()


# ---------------------------------------------------------------------------
# registry, flops, launchers
# ---------------------------------------------------------------------------
def test_registry_holds_gatedgcn_and_the_40_cells():
    mod, jmod = registry.get("gatedgcn"), jregistry.get("gatedgcn")
    assert mod.FAMILY == jmod.FAMILY == "gnn" and registry.ARCH_IDS == jregistry.ARCH_IDS
    for name in ("FULL", "SMOKE"):
        assert dataclasses.asdict(getattr(mod, name)) == dataclasses.asdict(getattr(jmod, name))
    assert registry.cells() == jregistry.cells() and len(registry.cells()) == 40
    assert registry.cells(assigned_only=False) == jregistry.cells(assigned_only=False)
    for name, shape in registry.GNN_SHAPES.items():
        assert (dataclasses.asdict(registry.gnn_config_for_shape(mod.FULL, shape))
                == dataclasses.asdict(jregistry.gnn_config_for_shape(jmod.FULL, shape))), name
    shape = registry.GNN_SHAPES["minibatch_lg"]
    assert registry.sampled_subgraph_sizes(shape) == jregistry.sampled_subgraph_sizes(shape) \
        == (169984, 168960)


@pytest.mark.parametrize("shape", list(registry.GNN_SHAPES))
def test_model_flops_of_the_gnn_cells_match_the_reference(shape):
    assert flops.model_flops("gatedgcn", shape) == jflops.model_flops("gatedgcn", shape)


def test_five_adamw_steps_match_the_reference_run():
    """``gnn_setup`` + ``train.loop.run`` against the reference's ``run``
    with its launcher's GNN settings (AdamW 1e-3, clip 1, one full-batch
    graph), 5 steps from the port's init (the launcher's generator seed 0)
    carried to the reference: the loss of every step and the final
    parameters."""
    steps = 5
    cfg = registry.get("gatedgcn").SMOKE
    model = GatedGCN(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    params = jax.tree_util.tree_map(jnp.asarray, export_gnn_params(model))
    loss_fn, stream, opt = launch_train.gnn_setup(cfg)
    ours = run(loss_fn, model, stream, opt, LoopConfig(n_steps=steps, log_every=1))
    jopt_cfg = jopt.OptimizerConfig(kind="adamw", lr=1e-3)
    assert dataclasses.asdict(opt) == dataclasses.asdict(jopt_cfg)
    jm = JGatedGCN(jregistry.get("gatedgcn").SMOKE)
    g = jgraph.random_graph(256, 2048, cfg.d_feat, seed=0, n_classes=cfg.n_classes)
    theirs = jloop.run(lambda p_, b: jm.loss(p_, b), params,
                       JDeterministicStream(lambda seed: dict(g), 0), jopt_cfg,
                       jloop.LoopConfig(n_steps=steps, log_every=1))
    losses = [m["loss"] for _, m in ours["history"]]
    np.testing.assert_allclose(losses, [m["loss"] for _, m in theirs["history"]], **LOSS)
    assert losses[-1] < losses[0]
    _assert_trees_close(export_gnn_params(model),
                        jax.tree_util.tree_map(np.asarray, theirs["state"]["params"]))


def test_train_launcher_trains_gatedgcn_on_the_cpu(capsys):
    out = launch_train.main(["--arch", "gatedgcn", "--device", "cpu", "--steps", "3"])
    assert out["stopped_at"] == 3 and np.isfinite(out["history"][-1][1]["loss"])
    assert isinstance(out["state"]["model"], GatedGCN)
    printed = capsys.readouterr().out
    assert "gatedgcn [gnn] SMOKE on cpu" in printed and "finished at step 3" in printed


def test_serve_launcher_refuses_gatedgcn_as_the_reference():
    with pytest.raises(SystemExit, match="gatedgcn has no serving mode"):
        launch_serve.main(["--arch", "gatedgcn", "--device", "cpu"])
    with pytest.raises(SystemExit):
        launch_serve.build(["--arch", "gatedgcn", "--shards", "2", "--device", "cpu"])
