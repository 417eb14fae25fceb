"""Port parity of the dry-run tooling: ``launch/{mesh,specs,dryrun,report}``
and ``distributed/roofline.CellRooflineRecord``.

The JAX package's side runs in ONE subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=512`` and writes its
results to a pickle under ``tmp_path``:

* every cell: the 40 (arch x shape) cells on both production meshes
  ((16, 16) and (2, 16, 16)) and the single-pod mesh's variant cells (LM
  train x amp / opt / bf16params / manual_tp, LM decode x sdim_kv, recsys
  x bf16emb / target_attention), as ``repro.launch.specs.build_cell``
  gives them (nothing is compiled): every argument leaf's keystr, shape,
  dtype and ``tuple(PartitionSpec)``, the per-chip bytes
  ``sum(prod(shard_shape) x itemsize)``, and the cell's ``kind``, ``note``
  and ``donate``. The port's ``build_cell`` must give the same, exactly;
* one step per family and kind (LM train, prefill, split-KV decode,
  SDIM-KV decode; recsys train, serve, retrieval; GNN train): the
  reference builds the cell on a (2, 4) ``("data", "model")`` mesh with
  the arch's SMOKE config set as FULL and the family's shapes cut (here
  only), places the port's materialized arguments (``specs.materialize``,
  seeded; recsys item rows screened off the hash margin, as
  ``tests/test_torch_archs.py``) with the leaves' shardings and runs the
  jitted step. The port runs ``step_fn`` on the CPU on the same arguments
  under the folded ``MeshCtx`` of (2, 4). Tolerances: the family's parity
  tests' (``test_torch_lm_train.py``, ``test_torch_lm_decode.py``,
  ``test_torch_archs.py``, ``test_torch_gnn.py``): losses fp32 atol / rtol
  1e-5, state trees 1e-5 of the largest value, recsys scores 1e-5; the LM
  prefill and split-KV decode run on the cells' bf16 parameters, so in
  bf16 in both packages: rtol 2e-2 and atol 2e-2 of the largest logit
  (the bf16 tolerance of ``test_torch_lm_train.py``). The SDIM-KV step
  runs on fp32 parameters in both (a bf16 key from two packages' GEMMs
  differs in its last bit, which flips hashes); its logits within 1e-4, its
  tables within 1e-5 (counts exactly), its keys and queries clear the 1e-4
  hash margin (asserted; the seed was chosen for it).

In-process: ``run_cell`` / ``main`` / ``report`` on a handful of cells (the
JSON's keys, resume, ``fits_80gib``, the bottleneck), the cell roofline
record's terms by hand with the H100's constants, and the parameter
collectives counted by hand on a two-leaf tree.
"""
import dataclasses
import math
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core import sdim
from repro_torch.distributed import roofline as rl
from repro_torch.kernels.screen import clears_margin, screen_item_rows
from repro_torch.launch import dryrun, report
from repro_torch.launch.mesh import (ProductionMesh, all_axes, data_axes, fold_axes,
                                     make_production_mesh, step_ctx)
from repro_torch.launch.specs import (Leaf, P, build_cell, materialize, tree_leaves,
                                      tree_map)
from repro_torch.weights import export_tree

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))
LOSS = dict(atol=1e-5, rtol=1e-5)
REL = 1e-5
LOGITS = dict(atol=1e-4, rtol=1e-4)
BF16_REL = 2e-2
SCORES = dict(atol=1e-5, rtol=1e-5)
HASH_MARGIN = 1e-4

LM_IDS = [a for a in registry.ARCH_IDS if registry.family(a) == "lm"]
RECSYS_IDS = [a for a, _ in registry.cells() if registry.family(a) == "recsys"]
RECSYS_IDS = list(dict.fromkeys(RECSYS_IDS))
VARIANT_CELLS = (
    [(a, "train_4k", v) for a in LM_IDS for v in ("amp", "opt", "bf16params", "manual_tp")]
    + [(a, s, "sdim_kv") for a in LM_IDS for s in ("decode_32k", "long_500k")]
    + [(a, s, v) for a in RECSYS_IDS for s in registry.RECSYS_SHAPES
       for v in ("bf16emb", "target_attention")])
CELLS = ([(False, a, s, "baseline") for a, s in registry.cells()]
         + [(True, a, s, "baseline") for a, s in registry.cells()]
         + [(False, a, s, v) for a, s, v in VARIANT_CELLS])

# the step checks: (name, arch, shape, variant), the family's shapes cut
STEP_SHAPES = {
    "train_4k": dict(kind="train", seq=16, global_batch=4),
    "prefill_32k": dict(kind="prefill", seq=16, global_batch=2),
    "decode_32k": dict(kind="decode", seq=16, global_batch=4),
    "train_batch": dict(kind="train", global_batch=8),
    "serve_p99": dict(kind="serve", global_batch=8),
    "retrieval_cand": dict(kind="retrieval", global_batch=1, n_candidates=20),
    "molecule": dict(kind="graph_batch", n_nodes=6, n_edges=10, batch=4, d_feat=16,
                     d_edge=4, n_classes=1),
}
STEPS = [("lm_train", "granite-3-2b", "train_4k", "baseline"),
         ("lm_prefill", "granite-3-2b", "prefill_32k", "baseline"),
         ("lm_split_kv", "granite-3-2b", "decode_32k", "baseline"),
         ("lm_sdim_kv", "granite-3-2b", "decode_32k", "sdim_kv"),
         ("recsys_train", "bst", "train_batch", "baseline"),
         ("recsys_serve", "wide-deep", "serve_p99", "baseline"),
         ("recsys_retrieval", "dien", "retrieval_cand", "baseline"),
         ("gnn_train", "gatedgcn", "molecule", "baseline")]
STEP_SEED = 3
SDIM_SEED = 5          # the SDIM-KV step's: its hashed keys and queries clear HASH_MARGIN
FP32_STEPS = {"lm_sdim_kv"}
STEP_MESH = ProductionMesh(("data", "model"), (2, 4))

JAX_SIDE = r'''
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import registry
from repro.distributed.compat import make_auto_mesh
from repro.launch.mesh import make_production_mesh
from repro.launch.specs import build_cell
from repro.models.lm import LMModel

in_path, out_path = sys.argv[1], sys.argv[2]
with open(in_path, "rb") as f:
    CELLS, STEP_SHAPES, STEPS, FP32_STEPS, step_args = pickle.load(f)
res = {"cells": {}, "steps": {}}


def describe(cell, mesh):
    leaves = []
    nbytes = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(cell.abstract_args)[0]:
        block = leaf.sharding.shard_shape(leaf.shape)
        nbytes += int(np.prod(block)) * leaf.dtype.itemsize
        leaves.append((jax.tree_util.keystr(path), tuple(leaf.shape), str(leaf.dtype),
                       tuple(leaf.sharding.spec)))
    return {"leaves": leaves, "bytes": nbytes, "kind": cell.kind, "note": cell.note,
            "donate": tuple(cell.donate)}


meshes = {mp: make_production_mesh(multi_pod=mp) for mp in (False, True)}
for mp, arch, shape, variant in CELLS:
    res["cells"][(mp, arch, shape, variant)] = describe(
        build_cell(arch, shape, meshes[mp], variant=variant), meshes[mp])

# one step per family and kind: SMOKE as FULL, the shapes cut, a (2, 4) mesh
for name, entries in STEP_SHAPES.items():
    registry.FAMILY_SHAPES[{"train_4k": "lm", "prefill_32k": "lm", "decode_32k": "lm",
                            "molecule": "gnn"}.get(name, "recsys")][name] = entries
mesh = make_auto_mesh((2, 4), ("data", "model"))
for name, arch, shape, variant in STEPS:
    mod = registry.get(arch)
    mod.FULL = mod.SMOKE
    cell = build_cell(arch, shape, mesh, variant=variant)
    fp32 = name in FP32_STEPS          # float leaves as fp32, whatever the cell's dtype
    args = jax.tree_util.tree_map(
        lambda a, s: jax.device_put(jnp.asarray(a).astype(
            jnp.float32 if fp32 and jnp.issubdtype(s.dtype, jnp.floating) else s.dtype),
            s.sharding),
        step_args[name], cell.abstract_args)
    with mesh:
        out = jax.jit(cell.step_fn)(*args)
    out = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), out)
    if registry.family(arch) == "lm":
        out = (out, np.asarray(LMModel(mod.SMOKE)._sdim_R()))
    res["steps"][name] = out

with open(out_path, "wb") as f:
    pickle.dump(res, f)
'''


def _np(tree):
    return tree_map(lambda _, t: t.detach().float().cpu().numpy(), tree)


@pytest.fixture(scope="module")
def step_cells():
    """The port's step cells on the (2, 4) mesh (SMOKE as FULL, the shapes
    cut) and their materialized arguments; recsys item rows screened."""
    cells = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, entries in STEP_SHAPES.items():
            family = {"train_4k": "lm", "prefill_32k": "lm", "decode_32k": "lm",
                      "molecule": "gnn"}.get(name, "recsys")
            mp.setitem(registry.FAMILY_SHAPES[family], name, entries)
        for name, arch, shape, variant in STEPS:
            mod = registry.get(arch)
            mp.setattr(mod, "FULL", mod.SMOKE)
            cell = build_cell(arch, shape, STEP_MESH, variant=variant)
            g = torch.Generator().manual_seed(SDIM_SEED if name == "lm_sdim_kv" else STEP_SEED)
            args = materialize(cell, "cpu", g)
            if name in FP32_STEPS:
                args = tree_map(lambda _, t: t.float() if t.is_floating_point() else t, args)
            if registry.family(arch) == "recsys":
                _screen(cell, args, g)
            cells[name] = (cell, args)
    return cells


def _screen(cell, args, g):
    """Redraw the item rows a recsys step hashes until they clear the
    margin, in the arguments' params tree."""
    params = args[0]["params"] if cell.kind == "train" else args[0]
    model = cell.runner.bind(params)
    if cell.kind == "retrieval":
        user, ci, cc = args[1], args[2], args[3]
        batch = {**{k: v.expand(ci.shape[0], -1) for k, v in user.items()},
                 "cand_item": ci, "cand_cat": cc}
    else:
        batch = args[1]
    screen_item_rows(model, [batch], g)
    params["item_emb"]["table"].copy_(export_tree(model)["item_emb"]["table"])


@pytest.fixture(scope="module")
def jax_side(step_cells, tmp_path_factory):
    """The JAX package's side, in one subprocess."""
    d = tmp_path_factory.mktemp("jax_dryrun")
    step_args = {name: _np(args) for name, (_, args) in step_cells.items()}
    with open(d / "in.pkl", "wb") as f:
        pickle.dump((CELLS, STEP_SHAPES, STEPS, FP32_STEPS, step_args), f)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable, "-c", JAX_SIDE, str(d / "in.pkl"), str(d / "out.pkl")],
                         capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(d / "out.pkl", "rb") as f:
        return pickle.load(f)


def _dtype(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


# ---------------------------------------------------------------------------
# every cell, leaf for leaf
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("multi_pod,arch,shape,variant", CELLS,
                         ids=[f"{'2x16x16' if m else '16x16'}-{a}-{s}-{v}" for m, a, s, v in CELLS])
def test_cell_arguments_match_the_reference(jax_side, multi_pod, arch, shape, variant):
    want = jax_side["cells"][(multi_pod, arch, shape, variant)]
    mesh = make_production_mesh(multi_pod=multi_pod)
    cell = build_cell(arch, shape, mesh, variant=variant)
    got = [(leaf.path, leaf.shape, _dtype(leaf.dtype), leaf.spec)
           for leaf in tree_leaves(cell.abstract_args)]
    assert sorted(got) == sorted(want["leaves"])
    assert sum(leaf.block_bytes(mesh) for leaf in tree_leaves(cell.abstract_args)) == \
        want["bytes"]
    assert (cell.kind, cell.note, tuple(cell.donate)) == \
        (want["kind"], want["note"], want["donate"])


# ---------------------------------------------------------------------------
# one step per family and kind
# ---------------------------------------------------------------------------
def _flat(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _assert_trees_close(ours, theirs, rel=REL):
    ours, theirs = _flat(ours), _flat(theirs)
    assert sorted(ours) == sorted(theirs)
    atol = rel * max(float(np.abs(v).max()) for v in theirs.values())
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], atol=atol, rtol=rel, err_msg=k)


def _run(step_cells, name, **kw):
    cell, args = step_cells[name]
    args = tree_map(lambda _, t: t.clone(), args)      # a train step updates its state
    return cell, cell.step_fn(*args, **kw)


@pytest.mark.parametrize("name", ["lm_train", "recsys_train", "gnn_train"])
def test_train_step_matches_the_reference(jax_side, step_cells, name):
    want = jax_side["steps"][name]
    w_state, w_loss = want[0] if name == "lm_train" else want      # LM: (out, R)
    state, loss = _run(step_cells, name)[1]
    np.testing.assert_allclose(float(loss), float(w_loss), **LOSS)
    _assert_trees_close(_np(state["params"]), w_state["params"])
    for key in w_state["opt"]:
        if key != "count":
            _assert_trees_close(_np(state["opt"][key]), w_state["opt"][key])
    assert int(state["opt"]["count"]) == int(w_state["opt"]["count"]) == 1


def test_lm_prefill_and_split_kv_decode_match_the_reference(jax_side, step_cells):
    for name in ("lm_prefill", "lm_split_kv"):
        want, _ = jax_side["steps"][name]         # exact attention: no hash matrix
        _, out = _run(step_cells, name)
        logits = out if name == "lm_prefill" else out[0]
        want_logits = want if name == "lm_prefill" else want[0]
        assert logits.shape == want_logits.shape and logits.dtype == torch.bfloat16
        np.testing.assert_allclose(logits.float().numpy(), want_logits, rtol=BF16_REL,
                                   atol=BF16_REL * float(np.abs(want_logits).max()),
                                   err_msg=name)
    cell, args = step_cells["lm_split_kv"]
    assert cell.note == "split-KV decode, seq over ('model',), batch over ('data',)"


def test_lm_sdim_kv_decode_matches_the_reference(jax_side, step_cells, monkeypatch):
    (w_logits, w_cache), R = jax_side["steps"]["lm_sdim_kv"]
    hashed = []
    fold, attend = sdim.kv_bucket_fold, sdim.sdim_decode_attention

    def rec_fold(vt, ct, k, v, R64, tau):
        hashed.append(k.numpy().reshape(-1, k.shape[-1]))
        fold(vt, ct, k, v, R64, tau)

    def rec_attend(q, *a, **kw):
        hashed.append(q.numpy().reshape(-1, q.shape[-1]))
        return attend(q, *a, **kw)

    monkeypatch.setattr(sdim, "kv_bucket_fold", rec_fold)
    monkeypatch.setattr(sdim, "sdim_decode_attention", rec_attend)
    _, (logits, cache) = _run(step_cells, "lm_sdim_kv", R=torch.from_numpy(R))
    assert clears_margin(np.concatenate(hashed), R, HASH_MARGIN).all(), f"seed {SDIM_SEED}"
    np.testing.assert_allclose(logits.numpy(), w_logits, **LOGITS)
    np.testing.assert_array_equal(cache["ct"].numpy(), w_cache["ct"])
    np.testing.assert_allclose(cache["vt"].numpy(), w_cache["vt"], **LOSS)
    assert int(cache["len"]) == int(w_cache["len"])


@pytest.mark.parametrize("name", ["recsys_serve", "recsys_retrieval"])
def test_recsys_inference_step_matches_the_reference(jax_side, step_cells, name):
    want = jax_side["steps"][name]
    _, out = _run(step_cells, name)
    assert out.shape == want.shape
    np.testing.assert_allclose(out.numpy(), want, **SCORES)


def test_steps_leave_their_arguments_in_the_reference_layout(step_cells):
    """Materialized arguments have the abstract leaves' shapes and dtypes,
    integers within their vocabularies; a master copy equals its
    parameter."""
    for name, (cell, args) in step_cells.items():
        for leaf, t in zip(tree_leaves(cell.abstract_args), tree_leaves(args)):
            dtype = torch.float32 if name in FP32_STEPS and t.is_floating_point() else leaf.dtype
            assert tuple(t.shape) == leaf.shape and t.dtype == dtype, (name, leaf.path)
            if leaf.fill == "int":
                assert 0 <= int(t.min()) and int(t.max()) < max(leaf.high, 1), leaf.path
    mesh = STEP_MESH
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(registry.LM_SHAPES, "train_4k", STEP_SHAPES["train_4k"])
        mod = registry.get("granite-3-2b")
        mp.setattr(mod, "FULL", mod.SMOKE)
        cell = build_cell("granite-3-2b", "train_4k", mesh, variant="bf16params")
    state, _ = materialize(cell, "cpu", torch.Generator().manual_seed(0))
    for p, m in zip(tree_leaves(state["params"]), tree_leaves(state["opt"]["master"])):
        assert p.dtype == torch.bfloat16 and m.dtype == torch.float32
        assert torch.equal(p.float(), m)


# ---------------------------------------------------------------------------
# meshes, the dry run, the report, the roofline
# ---------------------------------------------------------------------------
def test_production_meshes_and_the_step_ctx():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (one.axis_names, one.sizes, one.n_chips, one.tag) == \
        (("data", "model"), (16, 16), 256, "pod16x16")
    assert (two.axis_names, two.sizes, two.n_chips, two.tag) == \
        (("pod", "data", "model"), (2, 16, 16), 512, "pod2x16x16")
    assert data_axes(one) == ("data",) and data_axes(two) == ("pod", "data")
    assert all_axes(two) == ("pod", "data", "model")
    assert fold_axes(("pod", "data", "model")) == ("data", "model") and fold_axes(None) is None
    ctx = step_ctx(two, "cpu", data_axes=("pod", "data"), seq_axes=("pod", "data", "model"))
    assert (ctx.n_shards, ctx.data, ctx.data_axes, ctx.seq_axes, ctx.dp) == \
        (16, 32, ("data",), ("data", "model"), 32)
    assert step_ctx(one).devices[0] == torch.device("meta")


def test_run_cell_main_and_report(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    argv = ["--arch", "granite-3-2b", "--shape", "train_4k"]
    dryrun.main(argv)
    dryrun.main(argv + ["--multi-pod"])
    dryrun.main(["--arch", "deepseek-v2-236b", "--shape", "long_500k", "--variant", "sdim_kv"])
    dryrun.main(["--arch", "bst", "--shape", "serve_p99"])
    dryrun.main(argv)                                      # resumes: skips the cached cell
    assert "skip (cached): granite-3-2b/train_4k [pod16x16]" in capsys.readouterr().out
    rows = report.load("pod16x16", str(tmp_path))
    assert [(r["arch"], r["variant"]) for r in rows] == [
        ("bst", "baseline"), ("deepseek-v2-236b", "sdim_kv"), ("granite-3-2b", "baseline")]
    r = rows[2]
    for key in ("name", "n_chips", "flops_per_chip", "hbm_bytes_per_chip",
                "collective_bytes_per_chip", "collective_breakdown", "peak_memory_per_chip",
                "model_flops", "t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
                "useful_flops_fraction", "roofline_fraction", "memory",
                "hbm_total_per_chip_gib", "fits_80gib", "kind", "mesh"):
        assert key in r, key
    assert r["useful_flops_fraction"] is None and r["memory"]["temp_bytes"] is None
    mem = r["memory"]
    assert mem["alias_bytes"] == mem["output_bytes"] - 4     # the state aliases; the loss does not
    assert r["hbm_total_per_chip_gib"] == round((mem["argument_bytes"] + 4) / 2**30, 3)
    assert r["fits_80gib"] and r["bottleneck"] == "compute" and r["n_chips"] == 256
    assert set(r["collective_breakdown"]) == set(rl.COLLECTIVE_OPS)
    assert rows[0]["bottleneck"] == "memory" and rows[0]["t_collective_s"] == 0
    table = report.roofline_table(rows)
    assert table.count("\n") == 4 and "fits 80GiB" in table
    dtab = report.dryrun_table(rows)
    assert "all-gather=" in dtab and "reduce-scatter=" in dtab
    assert report.fmt(None) == "-" and report.fmt(0) == "0" and report.fmt(123.4) == "123"
    two = report.load("pod2x16x16", str(tmp_path))
    assert two[0]["n_chips"] == 512 and two[0]["mesh"] == "pod2x16x16"


def test_cell_roofline_record_terms_and_bottleneck():
    """After ``tests/test_roofline.py::test_roofline_record_terms_and_bottleneck``,
    with the H100's constants."""
    r = rl.CellRooflineRecord(
        name="t", n_chips=256,
        flops_per_chip=rl.PEAK_FLOPS,            # exactly 1 s of fp32 compute
        hbm_bytes_per_chip=rl.HBM_BW / 2,        # 0.5 s
        collective_bytes_per_chip=rl.LINK_BW * 2,  # 2 s
        collective_breakdown={}, peak_memory_per_chip=0.0,
        model_flops=rl.PEAK_FLOPS * 256)         # ideal == compute term
    assert abs(r.t_compute - 1.0) < 1e-9
    assert abs(r.t_memory - 0.5) < 1e-9
    assert abs(r.t_collective - 2.0) < 1e-9
    assert r.bottleneck == "collective"
    assert abs(r.roofline_time - 2.0) < 1e-9
    assert abs(r.roofline_fraction - 0.5) < 1e-9
    assert r.useful_flops_fraction is None
    bf = dataclasses.replace(r, peak_flops=rl.peak_flops("bfloat16"))
    assert abs(bf.t_compute - 67e12 / 989e12) < 1e-12 and bf.bottleneck == "collective"
    assert rl.peak_flops("float32") == 67e12 and rl.HBM_BYTES == 80 * 2**30
    d = r.to_dict()
    assert d["t_compute_s"] == r.t_compute and d["bottleneck"] == "collective"


def test_parameter_collectives_by_hand():
    """A (64, 32) fp32 leaf split over data and model (a ZeRO-1 leaf) and a
    (10,) fp32 leaf replicated, on (16, 16)."""
    mesh = make_production_mesh()
    params = {"w": Leaf((64, 32), torch.float32, P("data", "model")),
              "b": Leaf((10,), torch.float32, ())}
    block = (64 // 16) * (32 // 16) * 4                  # 32 bytes a chip
    train = dryrun.param_collectives(params, mesh, train=True)
    assert train["all-gather"] == 2 * block * 15          # forward and backward
    assert train["reduce-scatter"] == block * 15
    assert train["all-reduce"] == 2 * 15 * 40 // 16        # 2 (n - 1) / n of 40 bytes
    assert train["all-to-all"] == train["collective-permute"] == 0
    infer = dryrun.param_collectives(params, mesh, train=False)
    assert infer == {**{op: 0 for op in rl.COLLECTIVE_OPS}, "all-gather": block * 15}
    two = make_production_mesh(multi_pod=True)
    zero = {"w": Leaf((64, 32), torch.float32, P(("pod", "data"), "model"))}
    assert dryrun.param_collectives(zero, two, train=False)["all-gather"] == \
        (64 // 32) * (32 // 16) * 4 * 31


def test_block_shapes_follow_placement():
    """A leaf's per-chip block is ``Placement.place``'s block on a
    ``MeshCtx`` of the same sizes."""
    from repro_torch.distributed.sharding import Placement

    mesh = ProductionMesh(("data", "model"), (2, 4))
    leaf = Leaf((8, 12, 3), torch.float32, P("data", "model"))
    placed = Placement(step_ctx(mesh, "cpu"), leaf.spec).place(torch.zeros(leaf.shape))
    assert tuple(placed.blocks[0].shape) == leaf.block_shape(mesh) == (4, 3, 3)
    assert placed.block_bytes == leaf.block_bytes(mesh) == 4 * 3 * 3 * 4
    with pytest.raises(ValueError):
        Leaf((6,), torch.float32, P("model")).block_shape(mesh)
    assert math.prod(Leaf((8, 12), torch.bfloat16, ()).block_shape(mesh)) * 2 == 192
