"""Port parity of the tiered BSE store (``serve/tiered_store.py``): one
sequence of history ingests, event folds, fetches and evictions through the
JAX package's ``BSEServer`` and the port's, both on a tiered store (hot 3,
warm 2, a cold directory) in fp32, bf16, int8 and fp8 under both eviction
policies; then what only the port can show: tier movement and
snapshot → restore bit for bit in every storage dtype (numpy has no bf16 or
fp8, so the host tiers hold raw bits), and the cold-tier breaker on a
virtual clock.

Tolerances (``torch_runtime_parity.assert_rows_close``): rows at fp32 atol
1e-5; bf16 at the reference's bf16 tolerance; int8/fp8 within one
quantization step. Tier placement, ``tier_sizes``, ``TierStats``, policy
state and miss counts are equal.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from conftest import VirtualClock
from repro_torch.serve.bse_server import BSEServer
from repro_torch.serve.table_store import host_dtype
from repro_torch.serve.tiered_store import ClockPolicy, TieredTableStore, WarmPool
from torch_runtime_parity import (DTYPES, as_np, assert_rows_close, bits, events,
                                  histories, pair, port_embed, port_engine)

USERS = [f"u{i}" for i in range(8)]


# the JAX package's cold segments lose bf16 and fp8 (np.savez writes them as
# void arrays, which it cannot promote: fault C3, pinned below), so those
# two dtypes run the parity sequence on hot + warm tiers only
COLD = {"fp32": True, "int8": True, "bf16": False, "fp8": False}


def _tiered_pair(tmp_path, dtype, policy, **kw):
    cold = COLD[dtype]
    jsrv, srv = pair(hot_capacity=3, warm_capacity=2, policy=policy, table_dtype=dtype,
                     store_dir=str(tmp_path / "shared") if cold else None, **kw)
    if cold:
        for s, sub in ((jsrv, "jax"), (srv, "port")):     # one cold directory each
            s.store.cold.dir = str(tmp_path / sub)
            os.makedirs(s.store.cold.dir)
    return jsrv, srv


def _state(srv, dtype):
    st = srv.store
    stats = dataclasses.asdict(st.stats)
    if dtype == "bf16":
        # the JAX package's bf16 event fold leaves fp32 rows in the hot tier
        # (tests/test_torch_serving.py), so it demotes 4 bytes a value
        del stats["demote_bytes"]
    return ({u: st.tier(u) for u in USERS + ["nobody"]}, st.tier_sizes(), stats,
            st.policy.state(), srv.stats.n_misses, srv.stats.n_updates,
            srv.stats.n_encodes, srv.stats.bytes_transmitted)


def _steps(rng):
    """The sequence: (method, args) pairs, the same for both packages."""
    hi, hc, hm = histories(rng, len(USERS))
    e1 = ["u0", "u5", "u0", "u7", "u1"]
    e2 = USERS[1:6]
    return [
        ("ingest_histories", (USERS[:3], hi[:3], hc[:3], hm[:3])),
        ("ingest_histories", (USERS[3:], hi[3:], hc[3:], hm[3:])),   # chunked: demote, spill
        ("ingest_events", (e1, *events(rng, e1))),                    # promote warm + cold
        ("fetch_many", (["u1", "u2", "u3"],)),
        ("evict", ("u4",)),
        ("evict", ("u0",)),
        ("ingest_events", (e2, *events(rng, e2, E=3),
                           (rng.random((len(e2), 3)) > 0.3).astype(np.float32))),
        ("fetch_many", (USERS + ["nobody"],)),                         # wider than hot
        ("ingest_histories", (["u2"], hi[:1], hc[:1], hm[:1])),        # re-encode, drop copies
        ("fetch_many", (["u6", "nobody", "u2"],)),
    ]


@pytest.mark.parametrize("policy", ["clock", "lru"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_tiered_sequence_matches_jax(dtype, policy, tmp_path):
    jsrv, srv = _tiered_pair(tmp_path, dtype, policy)
    for (name, args), (_, jargs) in zip(_steps(np.random.default_rng(0)),
                                        _steps(np.random.default_rng(0))):
        out, ref = getattr(srv, name)(*args), getattr(jsrv, name)(*jargs)
        if name == "fetch_many":
            assert_rows_close(out, ref, dtype)
        elif name == "evict":
            assert out == ref
        assert _state(srv, dtype) == _state(jsrv, dtype), name
    for u in USERS:
        row, jrow = srv.store.row(u), jsrv.store.row(u)
        assert (row is None) == (jrow is None), u
        if row is not None:
            assert_rows_close(row, jrow, dtype)
    assert srv.store.stats.warm_promotions > 0
    assert srv.store.stats.demote_bytes == srv.store.stats.demotions * srv.store.row_nbytes()
    if COLD[dtype]:
        assert srv.store.stats.cold_promotions > 0 and srv.store.cold.n_segments > 0
    assert len(srv.store.hot) <= 3 and srv.store.capacity == 3


def _filled(tmp_path, dtype, policy="clock", sub="cold", **kw):
    """A port server whose users sit in all three tiers: hot u5..u7, warm
    u3/u4, cold u0..u2 (rows from histories and an event burst)."""
    srv = BSEServer(port_embed, None, port_engine(), wire_dtype=torch.float32, hot_capacity=3,
                    warm_capacity=2, store_dir=str(tmp_path / sub), policy=policy,
                    table_dtype=dtype, device="cpu", **kw)
    rng = np.random.default_rng(3)
    hi, hc, hm = histories(rng, len(USERS))
    srv.ingest_histories(USERS, hi, hc, hm)
    srv.ingest_events(USERS[5:] * 2, *events(rng, USERS[5:] * 2))
    assert srv.store.tier_sizes() == {"hot": 3, "warm": 2, "cold": 3}
    return srv


@pytest.mark.parametrize("dtype", DTYPES)
def test_demote_promote_is_bit_exact(dtype, tmp_path):
    """Rows leave the hot tier as stored bytes and come back unchanged:
    raw bits (and scales) of every user, hot again after a full rotation,
    equal those before."""
    srv = _filled(tmp_path, dtype)
    st = srv.store
    hot_users = ["u5", "u6", "u7"]
    payload, scales = st.rows_raw(st.hot.slots(hot_users))
    before = {u: (bits(payload[i]).clone(), None if scales is None else scales[i].clone())
              for i, u in enumerate(hot_users)}
    srv.fetch_many(["u0", "u1", "u2"])                 # cold -> hot, hot -> warm
    srv.fetch_many(["u3", "u4", "u5"])                 # warm -> hot; u6/u7 spill cold
    assert st.tier("u6") in ("warm", "cold") and st.tier("u7") in ("warm", "cold")
    srv.fetch_many(hot_users)                          # back to hot
    payload, scales = st.rows_raw(st.hot.slots(hot_users))
    for i, u in enumerate(hot_users):
        assert torch.equal(bits(payload[i]), before[u][0]), u
        if scales is not None:
            assert torch.equal(scales[i], before[u][1]), u
    assert st.hot.data.dtype == st.dtype and st.warm.data.dtype == host_dtype(st.dtype)
    assert st.stats.n_hot_gathers <= st.stats.n_hot_scatters


@pytest.mark.parametrize("dtype", DTYPES)
def test_snapshot_restore_is_bit_exact(dtype, tmp_path):
    srv = _filled(tmp_path, dtype, policy="lru")
    snap = srv.snapshot(str(tmp_path / "snap"))
    back = BSEServer.restore(snap, port_embed, None, port_engine(), device="cpu",
                             store_dir=str(tmp_path / "relocated"))
    a, b = srv.store, back.store
    assert b.dtype == a.dtype and b.hot_capacity == a.hot_capacity
    assert {u: a.tier(u) for u in USERS} == {u: b.tier(u) for u in USERS}
    assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)
    assert a.policy.state() == b.policy.state()
    assert dataclasses.asdict(srv.stats) == dataclasses.asdict(back.stats)
    assert back.wire_dtype == srv.wire_dtype and torch.equal(back.R, srv.R)
    for u in USERS:                                   # every tier, as stored
        assert torch.equal(bits(a.row(u)), bits(b.row(u))), u
    assert torch.equal(bits(a.hot.data), bits(b.hot.data))
    assert np.array_equal(a.warm.data, b.warm.data)
    for srv_ in (srv, back):                           # both answer the same
        srv_.ingest_events(["u0", "u6"], np.array([1, 2]), np.array([3, 4]))
    out, ref = back.fetch_many(USERS), srv.fetch_many(USERS)
    assert torch.equal(bits(out), bits(ref))
    assert back.stats.n_fetches == srv.stats.n_fetches


def test_snapshot_manifest_records_the_storage_dtype(tmp_path):
    import json
    srv = _filled(tmp_path, "bf16")
    snap = srv.snapshot(str(tmp_path / "snap"))
    man = json.load(open(os.path.join(snap, "manifest.json")))
    assert (man["dtype"], man["host_dtype"]) == ("bf16", "int16")
    with np.load(os.path.join(snap, "tiers.npz")) as z:
        assert z["warm"].dtype == np.int16
    seg = sorted(os.listdir(os.path.join(snap, "cold")))[0]
    with np.load(os.path.join(snap, "cold", seg)) as z:
        assert str(z["dtype"]) == "bf16" and z["rows"].dtype == np.int16
    man["host_dtype"] = "float32"
    json.dump(man, open(os.path.join(snap, "manifest.json"), "w"))
    with pytest.raises(ValueError):
        TieredTableStore.restore(snap, device="cpu")


@pytest.mark.parametrize("dtype", ["bf16", "fp8"])
def test_jax_cold_tier_loses_bf16_and_fp8_c3(dtype, tmp_path):
    """Fault C3 of the reference (ROADMAP.md): its cold segments hold bf16
    and fp8 rows as numpy void arrays, and promoting them raises. The port
    keeps their raw bits and the dtype's name and promotes them as stored;
    its rows equal the JAX package's read before the spill."""
    jsrv, srv = pair(hot_capacity=2, warm_capacity=0, table_dtype=dtype,
                     store_dir=str(tmp_path / "shared"))
    for s, sub in ((jsrv, "jax"), (srv, "port")):
        s.store.cold.dir = str(tmp_path / sub)
        os.makedirs(s.store.cold.dir)
    hi, hc, hm = histories(np.random.default_rng(9), 4)
    for s in (jsrv, srv):
        s.ingest_histories(USERS[:2], hi[:2], hc[:2], hm[:2])
    ref = jsrv.fetch_many(USERS[:2])
    for s in (jsrv, srv):
        s.ingest_histories(USERS[2:4], hi[2:], hc[2:], hm[2:])   # u0, u1 spill cold
        assert s.store.tier("u0") == "cold"
    with pytest.raises(TypeError):
        jsrv.fetch_many(USERS[:2])
    assert_rows_close(srv.fetch_many(USERS[:2]), ref, dtype)
    assert srv.store.stats.cold_promotions == 2


class _SlowCold:
    """A ``ColdStore`` whose reads take ``delay`` virtual seconds."""

    def __init__(self, inner, clock, delay):
        self._inner, self._clock, self.delay, self.n_reads = inner, clock, delay, 0

    def load_remove(self, users):
        self.n_reads += 1
        self._clock.advance(self.delay)
        return self._inner.load_remove(users)

    def __contains__(self, user):
        return user in self._inner

    def __len__(self):
        return len(self._inner)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_cold_breaker_degrades_to_miss_like_jax(tmp_path):
    clocks = {"jax": VirtualClock(), "port": VirtualClock()}
    srvs = {}
    jsrv, srv = pair(hot_capacity=3, warm_capacity=0, store_dir=str(tmp_path / "shared"),
                     cold_deadline_s=0.05)
    for name, s in (("jax", jsrv), ("port", srv)):
        s.store.cold.dir = str(tmp_path / name)
        os.makedirs(s.store.cold.dir)
        s.store._clock = s.store.breaker._clock = clocks[name]
        hi, hc, hm = histories(np.random.default_rng(5), len(USERS))
        s.ingest_histories(USERS, hi, hc, hm)          # u0..u4 cold, u5..u7 hot
        s.store.cold = _SlowCold(s.store.cold, clocks[name], delay=0.5)
        srvs[name] = s
    outs = {}
    for name, s in srvs.items():
        first = as_np(s.fetch_many(["u0", "u1"]))      # slow read: served, breaker opens
        t0 = clocks[name]()
        second = as_np(s.fetch_many(["u2", "u3"]))     # open: degraded misses, no read
        assert clocks[name]() == t0 and s.store.cold.n_reads == 1
        clocks[name].advance(1.0)                      # reset timeout: half-open probe
        third = as_np(s.fetch_many(["u2"]))
        outs[name] = (first, second, third, s.store.breaker.snapshot(),
                      dataclasses.asdict(s.store.stats), s.stats.n_misses,
                      s.metrics.snapshot()["counters"])
    ours, ref = outs["port"], outs["jax"]
    assert_rows_close(ours[0], ref[0], "fp32")
    assert not ours[1].any() and not ref[1].any()
    assert_rows_close(ours[2], ref[2], "fp32")
    assert ours[3:] == ref[3:]
    assert ours[4]["n_degraded"] == 2 and ours[3]["n_opens"] == 2


def test_warm_pool_holds_raw_bits():
    pool = WarmPool((2, 4, 8), torch.float8_e4m3fn, capacity=1, quantized=True)
    rows = np.arange(3 * 64, dtype=np.uint8).reshape(3, 2, 4, 8)
    pool.put(["a", "b", "c"], rows, np.ones((3, 2, 4), np.float32))
    assert pool.data.dtype == np.uint8 and pool.data.shape[0] == 4
    got, scales = pool.take(["c", "a"])
    assert np.array_equal(got, rows[[2, 0]]) and scales.shape == (2, 2, 4)
    with pytest.raises(AssertionError):
        pool.put(["d"], rows[:1].astype(np.float32), np.ones((1, 2, 4), np.float32))
    policy = ClockPolicy()
    for u in "abc":
        policy.insert(u)
    assert policy.victims(2, exclude={"a"}) == ["b", "c"]
