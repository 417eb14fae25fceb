"""Port parity of the sharded BSE table store (``ShardedTableStore``, the
engine's sharded dispatches, the sharded hot tier, ``CommittedView`` over
shards, the ledger, ``--shards``/``--mesh``) on the CPU.

The JAX package shards over a device mesh, so its side runs in ONE
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` and
the ``xla`` backend (as ``tests/test_sharded_store.py`` does) and writes
what it served to an ``.npz`` and a ``.json`` under ``tmp_path``; the port
replays the same numpy traffic (``torch_sharded_parity``) in-process over 8
shards on ``cpu``. The sequences are the reference's: a random ingest /
event / evict / re-ingest sequence with growth in fp32 and int8 followed
by fused serving with a miss (``tests/test_sharded_store.py:59``,
``tests/test_fused_serve.py:186``), ``serve_sharded`` against ``serve``
(``:109``), a recycled slot reads zero and ``clear`` empties the store
(``:129``), the sharded tiered store and its snapshot → restore
(``tests/test_tiered_store.py:384``), a committed view over shards, and
ledger conservation (``tests/test_profiler.py:273``); in-process, the
one-shard mesh (``:166``), the restore mismatch errors
(``tests/test_tiered_store.py:336``), the launcher's flag validation
(``:483``) and the roofline's collective term.

Tolerances: rtol 1e-5 and atol 1e-5, the reference's own. Handles, shard
loads, counters and ledger events are equal exactly, and the int8
payloads (and their scales) of the two sharded stores match bit for bit.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.compat import make_auto_mesh
from repro.serve.bse_server import BSEServer as JBSEServer
from repro_torch.distributed import roofline
from repro_torch.distributed.mesh_ctx import MeshCtx, owned, place
from repro_torch.kernels import cost
from repro_torch.serve.bse_server import BSEServer
from repro_torch.serve.profiler import KernelProfiler, MemoryLedger
from repro_torch.serve.table_store import ShardedTableStore
from repro_torch.serve.tiered_store import TieredTableStore
from torch_runtime_parity import behaviors, jax_embed, jax_engine, port_embed, port_engine
from torch_sharded_parity import (ASK_MISS, D, SHARDS, apply, candidates, random_ops,
                                  tiered_ops)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))
MESH = ("cpu",) * SHARDS
TOL = dict(rtol=1e-5, atol=1e-5)

JAX_SIDE = r'''
import json, os, sys
import jax, jax.numpy as jnp, numpy as np
from repro.distributed.compat import make_auto_mesh
from repro.core.engine import EngineConfig, SDIMEngine
from repro.serve.bse_server import BSEServer
from repro.serve.profiler import MemoryLedger
from repro.serve.table_store import ShardedTableStore
from torch_sharded_parity import (ASK_MISS, D, N_CATS, N_ITEMS, apply, candidates,
                                  random_ops, tiered_ops)

inp, out_dir = sys.argv[1], sys.argv[2]
with np.load(inp) as z:
    BEH, R = z["behaviors"], z["R"]
rows = lambda items, cats: BEH[np.asarray(items) % N_ITEMS, np.asarray(cats) % N_CATS]
embed = lambda params, items, cats: jnp.asarray(rows(items, cats))
eng = SDIMEngine(EngineConfig(m=12, tau=2, d=D, backend="xla"))
assert np.array_equal(np.asarray(eng.R), R)
mesh = make_auto_mesh((8,), ("model",))
arrays, meta = {}, {}

def store_state(tag, store):
    st = store.host_state()
    arrays[tag + "/data"] = np.asarray(st["data"])
    if "scales" in st:
        arrays[tag + "/scales"] = np.asarray(st["scales"])
    meta[tag] = {"index": st["index"], "load": store.shard_load(),
                 "grows": store.n_grows, "evictions": store.n_evictions}

# random sequence + fused serving with a miss, fp32 and int8
ops, order = random_ops(0)
ci, cc = candidates(1, (5, 3))
for dtype in ("fp32", "int8"):
    srv = BSEServer(embed, None, eng, wire_dtype=jnp.float32, capacity=4, mesh=mesh,
                    table_dtype=dtype)
    apply(srv, ops)
    arrays[f"random/{dtype}/fetch"] = np.asarray(srv.fetch_many(order))
    ask = [order[3], ASK_MISS, order[-1], order[0], order[3]]
    arrays[f"random/{dtype}/fused"] = np.asarray(
        srv.serve_candidates(ask, jnp.asarray(rows(ci, cc))))
    store_state(f"random/{dtype}", srv.store)

# serve_sharded against serve, with and without a mask (B = 5, not a multiple of 8)
qi, qc = candidates(2, (5, 3))
si, sc = candidates(3, (5, 7))
mask = (np.random.default_rng(4).uniform(size=(5, 7)) > 0.3).astype(np.float32)
q, seq = jnp.asarray(rows(qi, qc)), jnp.asarray(rows(si, sc))
arrays["serve_sharded/mask"] = np.asarray(eng.serve_sharded(q, seq, jnp.asarray(mask), mesh=mesh))
arrays["serve_sharded/nomask"] = np.asarray(eng.serve_sharded(q, seq, None, mesh=mesh))

# a recycled slot reads zero; clear empties the store
store = ShardedTableStore(3, 4, D, mesh, capacity=8)
h = store.assign(list(range(16)))
store.write(h, jnp.ones((16, 3, 4, D)))
k, l = store.slot(5)
store.evict(5)
h2 = store.assign(["fresh"])
meta["recycle"] = {"handles": np.asarray(h).tolist(), "evicted": [int(k), int(l)],
                   "fresh": np.asarray(h2).tolist(), "capacity": store.capacity,
                   "fresh_zero": float(jnp.abs(store.row("fresh")).max()) == 0.0,
                   "grows": store.n_grows, "evictions": store.n_evictions}
store.clear()
meta["recycle"]["after_clear"] = [len(store), store.capacity, store.n_grows,
                                  store.n_evictions, float(jnp.abs(store.data).max())]

# the sharded tiered store: demote, spill, promote; snapshot -> restore
ops_t, order_t = tiered_ops(0)
srv = BSEServer(embed, None, eng, wire_dtype=jnp.float32, mesh=mesh, hot_capacity=8,
                warm_capacity=8, store_dir=os.path.join(out_dir, "cold"))
apply(srv, ops_t)
arrays["tiered/fetch"] = np.concatenate(
    [np.asarray(srv.fetch_many(order_t[lo:lo + 8])) for lo in range(0, 24, 8)])
ts = srv.store.stats
meta["tiered"] = {"tiers": srv.store.tier_sizes(), "demotions": ts.demotions,
                  "spills": ts.spills, "warm_promotions": ts.warm_promotions,
                  "cold_promotions": ts.cold_promotions,
                  "hot_capacity": srv.store.hot_capacity,
                  "hot_index": [[u, list(map(int, s))] for u, s in srv.store.hot._slot_of.items()],
                  "load": srv.store.hot.shard_load()}
snap = srv.snapshot(os.path.join(out_dir, "snap"))
rest = BSEServer.restore(snap, embed, None, eng, mesh=mesh)
meta["tiered"]["restored_identical"] = all(
    bool(np.array_equal(np.asarray(srv.fetch_many(order_t[lo:lo + 8])),
                        np.asarray(rest.fetch_many(order_t[lo:lo + 8]))))
    for lo in range(0, 24, 8))
meta["tiered"]["manifest"] = {k: v for k, v in json.load(
    open(os.path.join(snap, "manifest.json"))).items() if k in ("sharded", "n_shards")}

# a committed view over shards, held across a fold
srv = BSEServer(embed, None, eng, wire_dtype=jnp.float32, capacity=4, mesh=mesh,
                async_ingest=True)
hi, hc = candidates(5, (6, 9))
srv.ingest_histories(list(range(6)), hi, hc)
srv.async_ingest.flush()
view = srv.async_ingest.committed
ask = [0, 3, ASK_MISS, 5]
handles, present = view.lookup(ask)
arrays["view/rows"] = np.asarray(view.rows(handles))
ei, ec = candidates(6, (4,))
srv.ingest_events([0, 3, 3, 5], ei, ec)
srv.async_ingest.flush()
arrays["view/rows_held"] = np.asarray(view.rows(handles))
arrays["view/rows_new"] = np.asarray(srv.async_ingest.committed.rows(handles))
meta["view"] = {"handles": np.asarray(handles).tolist(), "present": np.asarray(present).tolist(),
                "version": srv.async_ingest.committed.version}

# ledger conservation through growth, sharded folds and evictions
srv = BSEServer(embed, None, eng, wire_dtype=jnp.float32, capacity=8, mesh=mesh)
ledger = MemoryLedger()
ledger.attach(srv.store)
rng = np.random.default_rng(7)
errs = []
for lo in range(0, 24, 8):
    srv.ingest_histories(list(range(lo, lo + 8)), rng.integers(0, N_ITEMS, (8, 9)),
                         rng.integers(0, N_CATS, (8, 9)))
    errs += ledger.verify()
srv.ingest_events(list(range(8)), rng.integers(0, N_ITEMS, 8), rng.integers(0, N_CATS, 8))
errs += ledger.verify()
for u in range(6):
    srv.evict(u)
errs += ledger.verify()
snap = ledger.snapshot()
meta["ledger"] = {"errs": errs, "events": snap["events"], "hot_bytes": snap["hot_bytes"],
                  "by_key": snap["by_key"]}

np.savez(os.path.join(out_dir, "jax.npz"), **arrays)
with open(os.path.join(out_dir, "jax.json"), "w") as f:
    json.dump(meta, f)
'''


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX package's 8-device sharded store through every sequence, in
    one subprocess: (arrays, meta)."""
    out = tmp_path_factory.mktemp("jax_sharded")
    inp = out / "inp.npz"
    np.savez(inp, behaviors=behaviors(), R=np.asarray(jax_engine().R))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([SRC, HERE]), JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", JAX_SIDE, str(inp), str(out)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    with np.load(out / "jax.npz") as z:
        arrays = dict(z)
    with open(out / "jax.json") as f:
        return arrays, json.load(f)


def _server(**kw) -> BSEServer:
    return BSEServer(port_embed, None, port_engine(), wire_dtype=torch.float32, device="cpu",
                     **kw)


def _rows(items, cats) -> torch.Tensor:
    return port_embed(None, items, cats)


def _index(store) -> list:
    return [[u, [int(s[0]), int(s[1])]] for u, s in store._slot_of.items()]


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_random_sequence_and_fused_serving_match_jax(jax_side, dtype):
    """Ingest / event / evict / re-ingest with growth over 8 shards, then a
    fused read with a repeat and a miss: rows and interest within 1e-5 of
    the JAX package's sharded store; handles, shard loads, growth and
    eviction counts equal; int8 payloads and scales bit for bit."""
    arrays, meta = jax_side
    ops, order = random_ops(0)
    srv = _server(capacity=4, mesh=MESH, table_dtype=dtype)
    apply(srv, ops)
    store, ref = srv.store, meta[f"random/{dtype}"]
    assert isinstance(store, ShardedTableStore) and store.n_shards == SHARDS
    np.testing.assert_allclose(srv.fetch_many(order).numpy(),
                               arrays[f"random/{dtype}/fetch"], **TOL)
    ci, cc = candidates(1, (5, 3))
    ask = [order[3], ASK_MISS, order[-1], order[0], order[3]]
    fused = srv.serve_candidates(ask, _rows(ci, cc)).numpy()
    np.testing.assert_allclose(fused, arrays[f"random/{dtype}/fused"], **TOL)
    assert not fused[1].any()                                        # the miss
    assert _index(store) == ref["index"]
    assert store.shard_load() == ref["load"]
    assert max(ref["load"]) - min(ref["load"]) <= 1
    assert (store.n_grows, store.n_evictions) == (ref["grows"], ref["evictions"])
    assert ref["grows"] >= 1 and ref["evictions"] >= 1               # both exercised
    G, U = store.row_shape[:2]
    assert store.row_nbytes() == G * U * D * (1 if dtype == "int8" else 4) + \
        (G * U * 4 if dtype == "int8" else 0)
    state = store.host_state()
    if dtype == "int8":
        np.testing.assert_array_equal(state["data"], arrays[f"random/{dtype}/data"])
        np.testing.assert_array_equal(state["scales"].view(np.int32),
                                      arrays[f"random/{dtype}/scales"].view(np.int32))
    else:
        np.testing.assert_allclose(state["data"], arrays[f"random/{dtype}/data"], **TOL)


def test_sharded_matches_single_device_store_bit_for_bit():
    """The port's sharded store serves the single-device store's bits: a
    fold writes only owned rows and every other shard adds nothing."""
    ops, order = random_ops(0)
    single, sharded = _server(capacity=4), _server(capacity=4, mesh=MESH)
    for s in (single, sharded):
        apply(s, ops)
    assert torch.equal(single.fetch_many(order), sharded.fetch_many(order))
    ci, cc = candidates(1, (5, 3))
    q = _rows(ci, cc)
    ask = [order[3], ASK_MISS, order[-1], order[0], order[3]]
    assert torch.equal(single.serve_candidates(ask, q), sharded.serve_candidates(ask, q))


def test_serve_sharded_matches_serve(jax_side):
    """``serve_sharded`` (B = 5 padded to 8, one launch a shard) equals
    ``serve`` and the JAX package's ``serve_sharded``, masked and not."""
    arrays, _ = jax_side
    eng = port_engine()
    qi, qc = candidates(2, (5, 3))
    si, sc = candidates(3, (5, 7))
    mask = torch.as_tensor((np.random.default_rng(4).uniform(size=(5, 7)) > 0.3)
                           .astype(np.float32))
    q, seq = _rows(qi, qc), _rows(si, sc)
    for m, key in ((mask, "mask"), (None, "nomask")):
        got = eng.serve_sharded(q, seq, m, mesh=MESH)
        assert torch.equal(got, eng.serve(q, seq, m))
        np.testing.assert_allclose(got.numpy(), arrays[f"serve_sharded/{key}"], **TOL)


def test_recycled_slot_reads_zero_and_clear_empties(jax_side):
    """As the reference: one grow to 16, an evicted slot recycled to the
    next new user and read as zero, and ``clear`` resets everything; the
    handles are the JAX package's."""
    _, meta = jax_side
    ref = meta["recycle"]
    store = ShardedTableStore(3, 4, D, MESH, capacity=8, device="cpu")
    h = store.assign(list(range(16)))
    store.write(h, torch.ones((16, 3, 4, D)))
    k, l = store.slot(5)
    assert store.evict(5) and not store.evict(5)
    h2 = store.assign(["fresh"])
    assert h.tolist() == ref["handles"] and [k, l] == ref["evicted"]
    assert h2.tolist() == ref["fresh"] == [[k, l]]
    assert ref["fresh_zero"] and not store.row("fresh").any()
    assert (store.capacity, store.n_grows, store.n_evictions) == \
        (ref["capacity"], ref["grows"], ref["evictions"]) == (16, 1, 1)
    before = store.rows(store.slots([0, 7]))
    store.clear()
    assert [len(store), store.capacity, store.n_grows, store.n_evictions,
            max(float(b.abs().max()) for b in store.blocks)] == ref["after_clear"]
    store.write(store.assign([0, 7]), torch.ones((2, 3, 4, D)))     # reusable
    assert torch.equal(store.rows(store.slots([0, 7])), before)


def test_one_shard_mesh_in_process():
    """A one-shard mesh runs the whole sharded path against the JAX
    package's one-shard mesh in this process, and against the port's
    single-device store."""
    jmesh = make_auto_mesh((1,), ("model",))
    jsrv = JBSEServer(jax_embed, None, jax_engine(), wire_dtype=jnp.float32, capacity=2,
                      mesh=jmesh)
    srv, single = _server(capacity=2, mesh=("cpu",)), _server(capacity=2)
    rng = np.random.default_rng(0)
    items, cats = candidates(8, (3, 9))
    ev_i, ev_c = rng.integers(0, 48, 3), rng.integers(0, 8, 3)
    for s in (jsrv, srv, single):
        s.ingest_histories([0, 1, 2], items, cats)                  # grow 2 -> 4
        s.ingest_events([0, 2, 0], ev_i, ev_c)
    np.testing.assert_allclose(srv.fetch_many([0, 1, 2]).numpy(),
                               np.asarray(jsrv.fetch_many([0, 1, 2])), **TOL)
    assert torch.equal(srv.fetch_many([0, 1, 2]), single.fetch_many([0, 1, 2]))
    assert srv.store.n_grows == jsrv.store.n_grows == 1 and srv.store.n_shards == 1
    qi, qc = candidates(9, (2, 3))
    si, sc = candidates(10, (2, 5))
    eng = port_engine()
    q, seq = _rows(qi, qc), _rows(si, sc)
    assert torch.equal(eng.serve_sharded(q, seq, mesh=("cpu",)), eng.serve(q, seq))


def test_sharded_tiered_store_and_snapshot_restore(jax_side, tmp_path):
    """A tiered store over a sharded hot tier (hot 8 over 8 shards, warm 8,
    cold) serves the JAX package's rows through demote / spill / promote
    with the same tier sizes, stats and hot handles; snapshot → restore
    onto 8 shards answers bit for bit, and the manifest records the
    shards."""
    arrays, meta = jax_side
    ref = meta["tiered"]
    ops, order = tiered_ops(0)
    srv = _server(mesh=MESH, hot_capacity=8, warm_capacity=8,
                  store_dir=str(tmp_path / "cold"))
    apply(srv, ops)
    got = torch.cat([srv.fetch_many(order[lo:lo + 8]) for lo in range(0, 24, 8)])
    np.testing.assert_allclose(got.numpy(), arrays["tiered/fetch"], **TOL)
    ts = srv.store.stats
    assert srv.store.tier_sizes() == ref["tiers"]
    assert [ts.demotions, ts.spills, ts.warm_promotions, ts.cold_promotions] == \
        [ref["demotions"], ref["spills"], ref["warm_promotions"], ref["cold_promotions"]]
    assert ref["demotions"] > 0 and ref["spills"] > 0 and ref["cold_promotions"] > 0
    assert srv.store.hot_capacity == ref["hot_capacity"] == 8
    assert _index(srv.store.hot) == ref["hot_index"]
    assert srv.store.hot.shard_load() == ref["load"]
    snap = srv.snapshot(str(tmp_path / "snap"))
    man = json.load(open(os.path.join(snap, "manifest.json")))
    assert {k: man[k] for k in ("sharded", "n_shards")} == ref["manifest"] == \
        {"sharded": True, "n_shards": 8}
    back = BSEServer.restore(snap, port_embed, None, port_engine(), mesh=MESH, device="cpu")
    assert back.store.sharded and back.store.n_shards == 8 and ref["restored_identical"]
    for lo in range(0, 24, 8):
        assert torch.equal(srv.fetch_many(order[lo:lo + 8]), back.fetch_many(order[lo:lo + 8]))


def test_restore_refuses_a_mesh_that_does_not_match(tmp_path):
    """The reference's two mismatch errors, and a snapshot of 8 shards
    onto a mesh of 4."""
    flat = _server(hot_capacity=2)
    sharded = _server(hot_capacity=8, mesh=MESH)
    for s in (flat, sharded):
        s.ingest_histories([0, 1], *candidates(11, (2, 9)))
    a = flat.snapshot(str(tmp_path / "flat"))
    b = sharded.snapshot(str(tmp_path / "sharded"))
    with pytest.raises(ValueError, match="single-device"):
        TieredTableStore.restore(a, mesh=MESH, device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        TieredTableStore.restore(b, device="cpu")
    with pytest.raises(ValueError, match="8 shards, mesh has 4"):
        TieredTableStore.restore(b, mesh=("cpu",) * 4, device="cpu")


def test_committed_view_over_shards(jax_side):
    """Async ingest on a sharded store: the committed view's handles (a
    miss reads (0, 0)), presence and rows are the JAX package's; a view
    held across a fold keeps its rows while the new commit moves."""
    arrays, meta = jax_side
    srv = _server(capacity=4, mesh=MESH, async_ingest=True)
    hi, hc = candidates(5, (6, 9))
    srv.ingest_histories(list(range(6)), hi, hc)
    srv.async_ingest.flush()
    view = srv.async_ingest.committed
    handles, present = view.lookup([0, 3, ASK_MISS, 5])
    assert handles.tolist() == meta["view"]["handles"]
    assert present.tolist() == meta["view"]["present"]
    before = view.rows(handles)
    np.testing.assert_allclose(before.numpy(), arrays["view/rows"], **TOL)
    ei, ec = candidates(6, (4,))
    srv.ingest_events([0, 3, 3, 5], ei, ec)
    srv.async_ingest.flush()
    assert srv.async_ingest.committed.version == meta["view"]["version"]
    assert torch.equal(view.rows(handles), before)
    np.testing.assert_allclose(view.rows(handles).numpy(), arrays["view/rows_held"], **TOL)
    np.testing.assert_allclose(srv.async_ingest.committed.rows(handles).numpy(),
                               arrays["view/rows_new"], **TOL)


def test_ledger_conserves_on_sharded_store(jax_side):
    """Growth, sharded folds and evictions on 8 shards: ``verify()`` empty
    after each step, and events, hot bytes and the ledger's keys equal the
    JAX package's."""
    _, meta = jax_side
    srv = _server(capacity=8, mesh=MESH)
    ledger = MemoryLedger()
    ledger.attach(srv.store)
    rng = np.random.default_rng(7)
    for lo in range(0, 24, 8):
        srv.ingest_histories(list(range(lo, lo + 8)), rng.integers(0, 48, (8, 9)),
                             rng.integers(0, 8, (8, 9)))
        assert ledger.verify() == []
    srv.ingest_events(list(range(8)), rng.integers(0, 48, 8), rng.integers(0, 8, 8))
    assert ledger.verify() == []
    for u in range(6):
        assert srv.evict(u)
    assert ledger.verify() == []
    snap, ref = ledger.snapshot(), meta["ledger"]
    assert ref["errs"] == []
    assert snap["events"] == ref["events"] and snap["events"]["grow"] >= 1
    assert snap["hot_bytes"] == ref["hot_bytes"] == srv.store._nbytes() > 0
    assert snap["by_key"] == ref["by_key"]


def test_profiler_sums_the_shards_launches():
    """A profiled sharded fold or fused read counts the sum of its shards'
    launches: the single-device count plus, for each further shard, the
    inputs every shard reads (mask, slots and R; q, R, slots and present
    flags); flops equal. No bytes cross devices on one device."""
    eng = port_engine()
    prof = KernelProfiler().attach(eng).profiler
    srv = _server(capacity=4, mesh=MESH)
    srv.engine = srv.ingestor.engine = srv.fetcher.engine = eng
    ops, order = random_ops(0)
    apply(srv, ops[:1])
    users = ops[0][1]
    ei, ec = candidates(12, (len(users), 2))
    srv.ingest_events(users, ei, ec)                  # a compile: not timed
    blocks = [b.clone() for b in srv.store.blocks]
    srv.ingest_events(users, ei, ec)
    handles = torch.as_tensor(srv.store.slots(users), dtype=torch.int64)
    events = port_embed(None, ei, ec)
    mask = torch.ones(events.shape[:2])
    single = cost.update(torch.zeros((32, 6, 4, D)), torch.as_tensor(
        [k * 4 + l for k, l in handles.tolist()], dtype=torch.int32), events, mask,
        eng.R, tau=2)
    rec = prof.records["update_sharded"]
    assert rec.n_calls == 1 and rec.n_compiles == 1
    assert rec.flops == float(single.flops)
    extra = (SHARDS - 1) * (mask.numel() * 4 + len(users) * 4 + eng.R.numel() * 4)
    assert rec.bytes == float(single.bytes) + extra
    assert rec.collective == 0 and rec.predicted.t_collective == 0
    assert cost.settle(cost.update_sharded(tuple(blocks), handles, events, mask, eng.R,
                                           tau=2)) == (rec.flops, rec.bytes)
    q = _rows(*candidates(13, (len(users), 3)))
    for _ in range(2):
        srv.serve_candidates(users + [ASK_MISS], torch.cat([q, q[:1]]))
    rec = prof.records["serve_fused_sharded"]
    flat = cost.serve_fused(torch.zeros((32, 6, 4, D)), handles[:, 1], torch.cat([q, q[:1]]),
                            eng.R, tau=2, present=torch.tensor([1.] * len(users) + [0.]))
    assert rec.flops == float(flat.flops)
    B = len(users) + 1
    assert rec.bytes == float(flat.bytes) + (SHARDS - 1) * (B * 3 * D * 4 + eng.R.numel() * 4
                                                              + B * 8)
    assert "serve_fused_sharded" in prof.roofline_report()


def test_roofline_collective_term():
    """The bytes a sharded dispatch moves between distinct devices, by
    hand: each shard on another device than the caller's receives its
    inputs and (serving) returns its output; over 900 GB/s of NVLink."""
    q = torch.zeros((4, 3, D))
    R = torch.zeros((12, D))
    cpu, meta = torch.zeros((2, 6, 4, D)), torch.zeros((2, 6, 4, D), device="meta")
    handles = torch.tensor([[0, 0], [1, 1], [2, 0], [3, 1]])
    blocks = (cpu, meta, cpu, meta)
    moved = cost.collective_bytes("serve_fused_sharded", (blocks, handles, q, R), {})
    assert moved == 2 * (2 * 4 * 3 * D * 4 + 12 * D * 4 + 4 * 8)
    assert cost.n_devices("serve_fused_sharded", (blocks, handles, q, R), {}) == 2
    events, mask = torch.zeros((4, 2, D)), torch.ones((4, 2))
    assert cost.collective_bytes("update_sharded", (blocks, handles, events, mask, R), {}) == \
        2 * (4 * 2 * D * 4 + 4 * 2 * 4 + 12 * D * 4 + 4 * 4)
    assert cost.collective_bytes("serve_fused_sharded", ((cpu,) * 4, handles, q, R), {}) == 0
    r = roofline.analyze("x", 67e9, 3.35e9, collective_bytes=1.8e9, n_chips=2)
    assert (r.t_compute, r.t_memory, r.t_collective) == pytest.approx((5e-4, 5e-4, 2e-3))
    assert r.bottleneck == "collective" and r.roofline_time == pytest.approx(2e-3)
    assert roofline.analyze("x", 1.0, 3.35e9).t_collective == 0


def test_mesh_ctx_places_round_robin_and_masks_foreign_rows():
    mesh = MeshCtx(place(5, ["cpu", "meta"]), data=2)
    assert [d.type for d in mesh.devices] == ["cpu", "meta", "cpu", "meta", "cpu"]
    assert (mesh.n_shards, mesh.data, mesh.n_devices) == (5, 2, 2)
    assert MeshCtx.wrap(None) is None and MeshCtx.wrap(mesh) is mesh
    assert MeshCtx.wrap(["cpu"] * 3).n_shards == 3
    mine, local = owned(np.array([[0, 3], [1, 2], [0, 1]]), 0)
    assert mine.tolist() == [True, False, True] and local.tolist() == [3, 0, 1]
    with pytest.raises(ValueError):
        MeshCtx(())


def test_build_mesh_flag_validation(capsys):
    """The reference's flag errors (a non-positive count, a malformed
    ``DxM``; ``--shards 1`` serves unsharded), through ``err`` or as
    ``SystemExit``; more shards than devices are placed round-robin."""
    from repro_torch.launch.serve import build_mesh

    assert build_mesh(1, device="cpu") is None
    for shards, spec, frag in [(1, "3x", "--mesh"), (1, "axb", "--mesh"),
                               (1, "2x2x2", "--mesh"), (1, "0x4", "--mesh"),
                               (0, None, "--shards"), (-3, None, "--shards")]:
        with pytest.raises(SystemExit) as e:
            build_mesh(shards, spec, device="cpu")
        assert frag in str(e.value), (shards, spec, str(e.value))
    msgs = []

    def err(m):
        msgs.append(m)
        raise SystemExit(2)

    with pytest.raises(SystemExit):
        build_mesh(1, "bogus", err=err, device="cpu")
    assert msgs and "--mesh" in msgs[0]
    mesh = build_mesh(4096, device="cpu")
    assert mesh.n_shards == 4096 and mesh.n_devices == 1
    assert build_mesh(1, "2x4", device="cpu").shape == {"data": 2, "model": 4}


def test_serve_launcher_shards_on_the_cpu(capsys):
    """``python -m repro_torch.launch.serve --arch sdim-paper --shards 8
    --device cpu`` serves the same top candidates as the unsharded run, and
    prints the placement and the shard load; a mesh is refused where there
    is no table store (the reference's ``CTRServer.build`` check)."""
    from repro_torch.configs import sdim_paper
    from repro_torch.launch.serve import main
    from repro_torch.models.ctr import CTRModel
    from repro_torch.serve.ctr_server import CTRServer

    base = ["--arch", "sdim-paper", "--requests", "4", "--candidates", "16",
            "--micro-batch", "2", "--fused-serve", "--device", "cpu"]
    main(base)
    flat = [l for l in capsys.readouterr().out.splitlines() if l.startswith("req ")]
    main(base + ["--shards", "8"])
    out = capsys.readouterr().out
    assert "sharded over 8 shards" in out and "shard 7 -> cpu" in out
    assert "users per shard [1, 1, 1, 1, 0, 0, 0, 0]" in out
    assert [l for l in out.splitlines() if l.startswith("req ")] == flat
    model = CTRModel(sdim_paper.SMOKE, device="cpu")
    with pytest.raises(ValueError, match="mesh shards the BSE table store"):
        CTRServer.build(model, None, "inline", mesh=MESH, device="cpu")
