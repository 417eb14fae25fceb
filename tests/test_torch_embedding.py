"""Port parity of ``repro_torch.embedding`` against ``repro.embedding`` on
numpy inputs drawn from a seed: ``bag_lookup`` in its three modes, with and
without per-sample weights, with an empty bag (a max of -inf, as
``jax.ops.segment_max`` gives); ``multihot_lookup`` with and without a
mask, sum and mean; ``qr_embedding`` add and mul; ``EmbeddingCollection``
(one-hot and multi-hot fields, the reference's params loaded by
``weights.load_jax_embedding_collection``) and its ``partition_specs``;
the table's gradient against ``jax.grad`` for sum and mean.

Tolerance: fp32 atol 1e-6 (rtol 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.embedding import embedding_bag as jbag
from repro.embedding import sharded as jsharded
from repro_torch.embedding import embedding_bag as bag
from repro_torch.embedding.sharded import EmbeddingCollection, FieldSpec
from repro_torch.weights import load_jax_embedding_collection

TOL = dict(atol=1e-6, rtol=1e-6)
V, D, N, NUM_BAGS = 50, 8, 40, 7
EMPTY = 3                         # a bag no index falls into


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    idx = rng.integers(0, V, N).astype(np.int32)
    seg = rng.integers(0, NUM_BAGS - 1, N).astype(np.int32)
    seg[seg >= EMPTY] += 1                                  # bag EMPTY stays empty
    w = rng.uniform(0.5, 1.5, N).astype(np.float32)
    return table, idx, seg, w


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_bag_lookup_matches_jax(mode, weighted):
    table, idx, seg, w = _inputs()
    want = np.asarray(jbag.bag_lookup(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(seg),
                                      NUM_BAGS, mode, jnp.asarray(w) if weighted else None))
    got = bag.bag_lookup(torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(seg),
                         NUM_BAGS, mode, torch.from_numpy(w) if weighted else None).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    empty = {"sum": 0.0, "mean": 0.0, "max": -np.inf}[mode]
    assert np.all(want[EMPTY] == empty) and np.all(got[EMPTY] == empty)


def test_bag_lookup_rejects_an_unknown_mode():
    table, idx, seg, _ = _inputs()
    with pytest.raises(ValueError):
        bag.bag_lookup(torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(seg),
                       NUM_BAGS, "min")


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bag_lookup_gradient_matches_jax_grad(mode):
    table, idx, seg, w = _inputs(1)
    rng = np.random.default_rng(2)
    cot = rng.standard_normal((NUM_BAGS, D)).astype(np.float32)
    want = np.asarray(jax.grad(lambda t: jnp.sum(jbag.bag_lookup(
        t, jnp.asarray(idx), jnp.asarray(seg), NUM_BAGS, mode, jnp.asarray(w)) * cot))(
            jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_(True)
    out = bag.bag_lookup(t, torch.from_numpy(idx), torch.from_numpy(seg), NUM_BAGS, mode,
                         torch.from_numpy(w))
    torch.sum(out * torch.from_numpy(cot)).backward()
    np.testing.assert_allclose(t.grad.numpy(), want, **TOL)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("masked", [False, True])
def test_multihot_lookup_matches_jax(mode, masked):
    rng = np.random.default_rng(3)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(0, V, (4, 3, 5)).astype(np.int32)
    mask = (rng.random((4, 3, 5)) < 0.6).astype(np.float32)
    mask[0, 0] = 0.0                                       # an all-padded bag
    want = np.asarray(jbag.multihot_lookup(jnp.asarray(table), jnp.asarray(ids),
                                           jnp.asarray(mask) if masked else None, mode))
    got = bag.multihot_lookup(torch.from_numpy(table), torch.from_numpy(ids),
                              torch.from_numpy(mask) if masked else None, mode).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError):
        bag.multihot_lookup(torch.from_numpy(table), torch.from_numpy(ids),
                            torch.from_numpy(mask) if masked else None, "max")


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_multihot_lookup_gradient_matches_jax_grad(mode):
    rng = np.random.default_rng(4)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(0, 6, (5, 4)).astype(np.int32)      # ids repeat: rows add up
    mask = (rng.random((5, 4)) < 0.7).astype(np.float32)
    cot = rng.standard_normal((5, D)).astype(np.float32)
    want = np.asarray(jax.grad(lambda t: jnp.sum(jbag.multihot_lookup(
        t, jnp.asarray(ids), jnp.asarray(mask), mode) * cot))(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_(True)
    torch.sum(bag.multihot_lookup(t, torch.from_numpy(ids), torch.from_numpy(mask), mode)
              * torch.from_numpy(cot)).backward()
    np.testing.assert_allclose(t.grad.numpy(), want, **TOL)


@pytest.mark.parametrize("combine", ["add", "mul"])
def test_qr_embedding_matches_jax(combine):
    rng = np.random.default_rng(5)
    buckets = 7
    q = rng.standard_normal((-(-1000 // buckets), D)).astype(np.float32)
    r = rng.standard_normal((buckets, D)).astype(np.float32)
    ids = rng.integers(0, 1000, (6, 3)).astype(np.int32)
    want = np.asarray(jbag.qr_embedding(jnp.asarray(q), jnp.asarray(r), jnp.asarray(ids),
                                        buckets, combine))
    got = bag.qr_embedding(torch.from_numpy(q), torch.from_numpy(r), torch.from_numpy(ids),
                           buckets, combine).numpy()
    np.testing.assert_allclose(got, want, **TOL)


FIELDS = [("user", 30, 4, 1, "sum"), ("tags", 20, 6, 3, "mean"), ("genres", 12, 2, 4, "sum")]


def test_embedding_collection_matches_jax():
    jfields = [jsharded.FieldSpec(*f) for f in FIELDS]
    jcoll = jsharded.EmbeddingCollection(jfields)
    params = jax.tree_util.tree_map(np.asarray, jcoll.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(6)
    B = 5
    batch = {"user": rng.integers(0, 30, B).astype(np.int32),
             "tags": rng.integers(0, 20, (B, 3)).astype(np.int32),
             "tags_mask": (rng.random((B, 3)) < 0.7).astype(np.float32),
             "genres": rng.integers(0, 12, (B, 4)).astype(np.int32)}
    want = np.asarray(jcoll.apply(params, {k: jnp.asarray(v) for k, v in batch.items()}))
    coll = EmbeddingCollection([FieldSpec(*f) for f in FIELDS], device="cpu",
                               generator=torch.Generator().manual_seed(0))
    assert coll.total_dim == jcoll.total_dim == 12
    load_jax_embedding_collection(coll, params)
    got = coll.apply({k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (B, 12)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    specs = coll.partition_specs()
    assert specs == {"tables": {name: tuple(s) for name, s in
                                jcoll.partition_specs()["tables"].items()}}
    assert specs["tables"]["user"] == ("model", None)
    assert coll.partition_specs("m")["tables"]["tags"] == ("m", None)


def test_embedding_collection_init_and_loading():
    coll = EmbeddingCollection([FieldSpec(*f) for f in FIELDS], init_std=0.5, device="cpu",
                               generator=torch.Generator().manual_seed(1))
    again = EmbeddingCollection([FieldSpec(*f) for f in FIELDS], init_std=0.5, device="cpu",
                                generator=torch.Generator().manual_seed(1))
    for name, t in coll.tables.items():
        assert tuple(t.shape) == {f[0]: (f[1], f[2]) for f in FIELDS}[name]
        assert torch.equal(t, again.tables[name])          # the generator decides
    big = torch.cat([t.detach().reshape(-1) for t in coll.tables.values()])
    assert 0.35 < float(big.std()) < 0.65
    with pytest.raises(ValueError):
        load_jax_embedding_collection(coll, {"tables": {"user": np.zeros((30, 4), np.float32)}})
    with pytest.raises(ValueError):
        load_jax_embedding_collection(coll, {"tables": {
            "user": np.zeros((30, 5), np.float32), "tags": np.zeros((20, 6), np.float32),
            "genres": np.zeros((12, 2), np.float32)}})
