"""Port parity of elastic restore and the int8 gradient mean: a checkpoint
the JAX package saved, restored onto two meshes by the port
(``train/elastic.py``), and ``train/compression.py``'s tree and
data-parallel functions, on the CPU.

The JAX side runs in ONE subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (the reference's
``tests/test_distributed.py:116-163``): it saves the din CTR model of that
test with ``repro.train.checkpoint.save``, restores it onto a (2, 4) and a
(4, 2) ``("data", "model")`` mesh by the recsys rules and records each
leaf's ``NamedSharding.spec``, runs ``compressed_psum`` under
``shard_map`` over the data axis on an (8, 16) gradient, and
``compress_tree_int8`` on a small tree. The port restores that checkpoint
with ``restore_on_mesh`` onto ``MeshCtx(("cpu",) * 4, data=2)`` and
``MeshCtx(("cpu",) * 2, data=4)``, into a template of its own model's tree
(``weights.export_params``).

In-process: ``scale_batch_for_mesh`` and its refusal, and ``restore``'s
refusal to place a module's leaf.

Tolerances: restored leaves equal bit for bit; ``compressed_psum`` within
1e-6 of the reference's output and within the reference's 0.05 of the
blocks' mean; ``compress_tree_int8`` values equal, scales within 1e-6.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.interest import InterestConfig
from repro_torch.distributed.mesh_ctx import MeshCtx
from repro_torch.distributed.sharding import (ShardedLeaf, flatten, gather, map_tree,
                                              param_spec, spec_tree, valid_for_mesh)
from repro_torch.models.ctr import CTRConfig, CTRModel
from repro_torch.train import checkpoint as ck
from repro_torch.train.compression import (compress_tree_int8, compressed_psum,
                                           decompress_tree_int8)
from repro_torch.train.elastic import restore_on_mesh, scale_batch_for_mesh
from repro_torch.weights import export_params

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))
# the reference test's din config (test_distributed.py:128-129)
CTR_CFG = dict(arch="din", n_items=512, n_cats=16, long_len=32, short_len=8, mlp_hidden=(16,))
INTEREST = dict(kind="sdim", m=8, tau=2)
MESHES = {"2x4": (2, 4), "4x2": (4, 2)}
STEP = 3

JAX_SIDE = r'''
import pickle, re, sys
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.core.interest import InterestConfig
from repro.distributed.compat import make_auto_mesh
from repro.distributed.sharding import param_spec, valid_for_mesh
from repro.models.ctr import CTRConfig, CTRModel
from repro.train import checkpoint as ck
from repro.train.compression import compress_tree_int8, compressed_psum
from repro.train.elastic import restore_on_mesh

out_path, ckpt_dir = sys.argv[1], sys.argv[2]
CTR_CFG, INTEREST, MESHES, STEP = eval(sys.argv[3])
dotted = lambda key: ".".join(re.findall(r"\['?([^'\]]+)'?\]", key))
res = {}
model = CTRModel(CTRConfig(**CTR_CFG, interest=InterestConfig(**INTEREST)))
p = model.init(jax.random.PRNGKey(0))
ck.save(ckpt_dir, STEP, {"params": p})
res["params"] = jax.tree_util.tree_map(np.asarray, p)
for name, shape in MESHES.items():
    mesh = make_auto_mesh(shape, ("data", "model"))
    rules = lambda path, shape, mesh=mesh: valid_for_mesh(param_spec("recsys", path, shape),
                                                          shape, mesh)
    r, step = restore_on_mesh(ckpt_dir, {"params": p}, mesh, rules)
    res[name] = {dotted(jax.tree_util.keystr(path)): tuple(leaf.sharding.spec)
                 for path, leaf in jax.tree_util.tree_flatten_with_path(r["params"])[0]}

mesh = make_auto_mesh((2, 4), ("data", "model"))
g = jax.random.normal(jax.random.PRNGKey(0), (8, 16))
f = shard_map(lambda t: compressed_psum({"g": t}, "data")["g"], mesh=mesh,
              in_specs=(P("data", None),), out_specs=P("data", None), check_rep=False)
with mesh:
    out = jax.jit(f)(g)
res["psum"] = {"g": np.asarray(g), "out": np.asarray(out)}
rng = np.random.default_rng(2)
tree = {"a": rng.standard_normal((5, 7)).astype(np.float32),
        "b": (100 * rng.standard_normal(9)).astype(np.float32)}
q, s = compress_tree_int8({k: jnp.asarray(v) for k, v in tree.items()})
res["int8"] = {"tree": tree, "q": jax.tree_util.tree_map(np.asarray, q),
               "s": jax.tree_util.tree_map(np.asarray, s)}
with open(out_path, "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """(the JAX side's results, the directory of the checkpoint it saved)."""
    tmp = tmp_path_factory.mktemp("jax_elastic")
    out, ckpt_dir = tmp / "jax.pkl", tmp / "ckpt"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", JAX_SIDE, str(out), str(ckpt_dir),
                          repr((CTR_CFG, INTEREST, MESHES, STEP))],
                         capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f), str(ckpt_dir)


def _mesh(name) -> MeshCtx:
    data, model = MESHES[name]
    return MeshCtx(("cpu",) * model, data=data)


def _rules(mesh):
    return lambda path, shape: valid_for_mesh(param_spec("recsys", path, shape), shape, mesh)


def _template():
    model = CTRModel(CTRConfig(**CTR_CFG, interest=InterestConfig(**INTEREST)), device="cpu",
                     generator=torch.Generator().manual_seed(0))
    return {"params": export_params(model)}


@pytest.mark.parametrize("name", list(MESHES))
def test_a_reference_checkpoint_restores_onto_the_mesh(jax_side, name):
    res, ckpt_dir = jax_side
    mesh = _mesh(name)
    restored, step = restore_on_mesh(ckpt_dir, _template(), mesh, _rules(mesh))
    assert step == STEP
    leaves = flatten(restored["params"])
    want = flatten(res["params"])
    assert sorted(leaves) == sorted(want)
    for k, leaf in leaves.items():
        assert isinstance(leaf, ShardedLeaf), k
        assert all(dev == torch.device("cpu") for dev in leaf.devices)
        np.testing.assert_array_equal(gather(leaf).numpy(), want[k], err_msg=k)
    specs = spec_tree(restored["params"])
    assert specs == {k.replace(".", "/"): v for k, v in res[name].items()}
    assert "model" in specs["item_emb/table"]
    table = leaves["item_emb/table"]
    assert table.grid == (mesh.n_shards, 1)
    assert table.blocks[0].shape == (CTR_CFG["n_items"] // mesh.n_shards, table.shape[1])


def test_restores_onto_both_meshes_agree(jax_side):
    """(2, 4) then (4, 2): the elastic re-mesh of the reference's test."""
    _, ckpt_dir = jax_side
    first, second = (restore_on_mesh(ckpt_dir, _template(), _mesh(n), _rules(_mesh(n)))[0]
                     for n in MESHES)
    a, b = flatten(first), flatten(second)
    for k in a:
        assert torch.equal(gather(a[k]), gather(b[k])), k
    assert len(a["params/item_emb/table"].blocks) == 4
    assert len(b["params/item_emb/table"].blocks) == 2


def test_restore_without_a_sharding_fn_gives_arrays(jax_side):
    res, ckpt_dir = jax_side
    restored, _ = ck.restore(ckpt_dir, _template())
    got_all = flatten(restored["params"])
    for k, v in flatten(res["params"]).items():
        got = got_all[k]
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, v, err_msg=k)


def test_compressed_psum_matches_the_reference(jax_side):
    res, _ = jax_side
    g = torch.from_numpy(res["psum"]["g"])
    blocks = [{"g": g[:4]}, {"g": g[4:]}]
    out = compressed_psum(blocks)
    assert len(out) == 2 and torch.equal(out[0]["g"], out[1]["g"])
    want = res["psum"]["out"]
    np.testing.assert_allclose(out[0]["g"].numpy(), want[:4], atol=1e-6, rtol=0)
    np.testing.assert_allclose(out[1]["g"].numpy(), want[4:], atol=1e-6, rtol=0)
    mean = (g[:4] + g[4:]) / 2
    assert float((out[0]["g"] - mean).abs().max()) < 0.05
    step = float(g.abs().max()) / 127
    assert float((out[0]["g"] - mean).abs().max()) <= step
    again = compressed_psum(blocks)
    assert torch.equal(again[0]["g"], out[0]["g"])


def test_compress_tree_int8_matches_the_reference(jax_side):
    res, _ = jax_side
    r = res["int8"]
    q, s = compress_tree_int8({k: torch.from_numpy(v) for k, v in r["tree"].items()})
    for k in r["tree"]:
        assert q[k].dtype == torch.int8
        np.testing.assert_array_equal(q[k].numpy(), r["q"][k], err_msg=k)
        np.testing.assert_allclose(float(s[k]), float(r["s"][k]), rtol=1e-6)
    back = decompress_tree_int8(q, s)
    for k, v in r["tree"].items():
        assert float(np.abs(back[k].numpy() - v).max()) <= float(s[k]) / 2 + 1e-6


def test_scale_batch_for_mesh():
    assert scale_batch_for_mesh(256, MeshCtx(("cpu",) * 4, data=2)) == 128
    assert scale_batch_for_mesh(256, MeshCtx(("cpu",) * 2, data=4)) == 64
    assert scale_batch_for_mesh(256, MeshCtx(("cpu",) * 2, data=4), "model") == 128
    with pytest.raises(AssertionError):
        scale_batch_for_mesh(258, MeshCtx(("cpu",) * 2, data=4))


def test_restore_refuses_to_place_a_module_leaf(tmp_path):
    model = CTRModel(CTRConfig(**CTR_CFG, interest=InterestConfig(**INTEREST)), device="cpu",
                     generator=torch.Generator().manual_seed(0))
    ck.save(str(tmp_path), 1, {"model": model})
    mesh = _mesh("2x4")
    with pytest.raises(ValueError, match="module leaf"):
        restore_on_mesh(str(tmp_path), {"model": model}, mesh, _rules(mesh))
    # a sharding_fn that places nothing loads the module in place, as before
    restored, _ = ck.restore(str(tmp_path), {"model": model}, sharding_fn=lambda p, s: None)
    assert restored["model"] is model


def test_a_placed_tensor_leaf_keeps_its_dtype(tmp_path):
    tree = {"w": torch.arange(24, dtype=torch.float64).reshape(8, 3), "n": 5,
            "blocks": [{"b": np.ones(4, np.float32)}]}
    ck.save(str(tmp_path), 2, tree)
    mesh = _mesh("2x4")
    restored, _ = restore_on_mesh(str(tmp_path), tree, mesh, lambda p, s: ("model",))
    w = restored["w"]
    assert isinstance(w, ShardedLeaf) and w.blocks[0].dtype == torch.float64
    assert torch.equal(gather(w), tree["w"]) and restored["n"] == 5
    assert torch.equal(gather(restored["blocks"][0]["b"]), torch.ones(4))
    assert map_tree(lambda p, leaf: p, {"a": [1, {"b": 2}]}) == {"a": ["a/0", {"b": "a/1/b"}]}
