"""Port parity of async ingestion (``serve/ingest.py``) and of the event
fold's per-slot sums (``serve/bse_server.py::slot_sums``).

- ``drain_once`` driven by hand (no thread) over one fixed submit order:
  ``IngestStats.as_dict()`` (wall-clock ``fold_time_s`` aside), commit
  versions and committed rows equal the JAX package's (rows at fp32 atol
  1e-5; other dtypes as ``torch_runtime_parity.assert_rows_close``).
- In the port, async equals sync bit for bit in every storage dtype, and
  for fp32 also when the drains cut the event stream elsewhere than the
  synchronous calls did (each fold adds a slot's events to the stored row
  one at a time in batch order).
- A ``CommittedView`` held across later folds, evictions, tier movement and
  a model push reads the same bits in every dtype (copy on write).
- Backpressure drops, history dedupe, the staleness bound and forced
  drains are counted as in the JAX package; a writer thread flushes
  everything on ``stop``; a writer that dies keeps its work queued, shows
  ``live: false`` and ``stop`` raises its error.
- Repeated users in one bf16/int8 event burst: equal bits on two runs, and
  the JAX package's rows within tolerance.
"""
import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

from repro_torch.serve.bse_server import BSEServer, slot_sums
from repro_torch.serve.health import health_snapshot
from repro_torch.serve.ingest import AsyncIngestor, CommittedView
from torch_runtime_parity import (DTYPES, assert_rows_close, bits, events, histories, pair,
                                  port_embed, port_engine)

USERS = [f"u{i}" for i in range(6)]


def _submits(rng, blocks=True):
    """One fixed submit order: histories, events with repeated users, a
    resubmitted history (dedupe), more events: blocks of two events a user
    with a mask, or (``blocks=False``) one event a user. The queue holds
    single events, so a block folds synchronously as one bucket sum added
    to the row and asynchronously event by event: the same sum to
    rounding, bit for bit only without blocks (as in the JAX package)."""
    hi, hc, hm = histories(rng, len(USERS))
    ev1 = ["u0", "u1", "u0", "u2", "u0", "u5"]
    ev2 = ["u3", "u3", "u4"]
    last = ((ev2, *events(rng, ev2, E=2), np.array([[1, 0], [1, 1], [0, 1]], np.float32))
            if blocks else (ev2, *events(rng, ev2)))
    return [("ingest_histories", (USERS[:4], hi[:4], hc[:4], hm[:4])),
            ("ingest_events", (ev1, *events(rng, ev1))),
            ("ingest_histories", (["u1", "u4"], hi[4:], hc[4:], hm[4:])),
            ("ingest_events", last)]


def _stats(rt):
    d = rt.stats.as_dict()
    del d["fold_time_s"]
    return d


@pytest.mark.parametrize("dtype", DTYPES)
def test_hand_driven_drains_match_jax(dtype):
    jsrv, srv = pair(async_ingest=True, drain_batch=3, table_dtype=dtype)
    for (name, args), (_, jargs) in zip(_submits(np.random.default_rng(1)),
                                        _submits(np.random.default_rng(1))):
        assert getattr(srv, name)(*args) == getattr(jsrv, name)(*jargs)
        assert _stats(srv.async_ingest) == _stats(jsrv.async_ingest)
    while True:
        n, jn = srv.async_ingest.drain_once(), jsrv.async_ingest.drain_once()
        assert n == jn
        assert _stats(srv.async_ingest) == _stats(jsrv.async_ingest)
        assert srv.async_ingest.committed.version == jsrv.async_ingest.committed.version
        assert_rows_close(srv.fetch_many(USERS), jsrv.fetch_many(USERS), dtype)
        if not n:
            break
    assert srv.async_ingest.stats.n_deduped > 0 and srv.async_ingest.stats.n_folds > 1
    assert dataclasses.asdict(srv.stats) | {"encode_time_s": 0} == \
        dataclasses.asdict(jsrv.stats) | {"encode_time_s": 0}


def _sync_async(dtype, drain_batch):
    sync = BSEServer(port_embed, None, port_engine(), wire_dtype=torch.float32,
                     table_dtype=dtype, device="cpu")
    asyn = BSEServer(port_embed, None, port_engine(), wire_dtype=torch.float32,
                     table_dtype=dtype, async_ingest=True, drain_batch=drain_batch,
                     device="cpu")
    return sync, asyn


@pytest.mark.parametrize("dtype", DTYPES)
def test_async_equals_sync_bit_for_bit(dtype):
    sync, asyn = _sync_async(dtype, drain_batch=256)
    for name, args in _submits(np.random.default_rng(2), blocks=False):
        getattr(sync, name)(*args)
        getattr(asyn, name)(*args)
        asyn.async_ingest.flush()         # one drain a call: the same batches
    assert torch.equal(bits(asyn.fetch_many(USERS)), bits(sync.fetch_many(USERS)))


def test_fp32_fold_is_bit_exact_across_drain_boundaries():
    """Events cut into drains of 2 and 3 against one synchronous call: an
    fp32 fold adds each event to its stored row in batch order, so the
    cuts change no bit."""
    rng = np.random.default_rng(3)
    users = [USERS[int(i)] for i in rng.integers(0, 4, 23)]
    ev = events(rng, users)
    for drain_batch in (2, 3):
        sync, asyn = _sync_async("fp32", drain_batch)
        sync.ingest_events(users, *ev)
        assert asyn.ingest_events(users, *ev) == len(users)
        asyn.async_ingest.flush()
        assert asyn.async_ingest.stats.n_folds > 1
        assert torch.equal(bits(asyn.fetch_many(USERS[:4])), bits(sync.fetch_many(USERS[:4])))


@pytest.mark.parametrize("dtype", DTYPES)
def test_held_view_is_unchanged_by_later_folds(dtype, tmp_path):
    srv = BSEServer(port_embed, None, port_engine(), wire_dtype=torch.float32,
                    table_dtype=dtype, async_ingest=True, hot_capacity=3,
                    warm_capacity=1, store_dir=str(tmp_path / "cold"), device="cpu")
    rt = srv.async_ingest
    rng = np.random.default_rng(4)
    hi, hc, hm = histories(rng, 3)
    srv.ingest_histories(USERS[:3], hi, hc, hm)
    rt.flush()
    view = rt.committed
    held = (bits(view.data).clone(), None if view.scales is None else view.scales.clone())
    rows = view.rows(view.lookup(USERS[:3])[0]).clone()
    srv.ingest_events(USERS[:3] * 2, *events(rng, USERS[:3] * 2))
    srv.ingest_events(USERS[3:], *events(rng, USERS[3:]))    # new users: demote, spill
    rt.flush()
    srv.fetch_many(USERS)                                      # touches: promotions
    rt.flush()
    srv.evict("u1")
    srv.refresh_params(None)
    assert rt.committed is not view and rt.committed.version > view.version
    assert torch.equal(bits(view.data), held[0])
    if held[1] is not None:
        assert torch.equal(view.scales, held[1])
    assert torch.equal(bits(view.rows(view.lookup(USERS[:3])[0])), bits(rows))
    assert len(srv.store) == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_copy_on_write_clones_once_per_commit(dtype, tmp_path):
    """One drain that demotes, spills, promotes and folds writes the hot
    tier many times but clones it once: the first write after the commit
    clones, the rest go into the clone in place."""
    srv = BSEServer(port_embed, None, port_engine(), wire_dtype=torch.float32,
                    table_dtype=dtype, async_ingest=True, hot_capacity=3,
                    warm_capacity=1, store_dir=str(tmp_path / "cold"), device="cpu")
    rt, hot = srv.async_ingest, srv.store.hot
    rng = np.random.default_rng(8)
    hi, hc, hm = histories(rng, 6)
    srv.ingest_histories(USERS[:3], hi[:3], hc[:3], hm[:3])
    rt.flush()
    view = rt.committed
    held = bits(view.data).clone()
    clones, inner = [], hot.writable

    def counted():
        before = hot.data
        out = inner()
        clones.append(out[0] is not before)
        return out
    hot.writable = counted
    srv.ingest_histories(USERS[3:], hi[3:], hc[3:], hm[3:])
    srv.ingest_events(USERS * 2, *events(rng, USERS * 2))
    folds = rt.stats.n_folds
    rt.flush()
    assert rt.stats.n_folds == folds + 1
    assert len(clones) > 3 and sum(clones) == 1 and clones[0]
    assert torch.equal(bits(view.data), held)
    clones.clear()
    srv.evict(USERS[5])                 # a commit of its own: one more clone
    assert clones == [True]


def test_inplace_store_would_change_a_held_view():
    """What copy on write prevents: with writes in place (a store the
    runtime did not set up), the fold changes the tensor a view holds."""
    srv = BSEServer(port_embed, None, port_engine(), wire_dtype=torch.float32, device="cpu")
    srv.ingest_events(["a"], np.array([1]), np.array([2]))
    view = CommittedView(1, srv.store)
    before = view.data.clone()
    srv.ingest_events(["a"], np.array([3]), np.array([4]))
    assert not torch.equal(view.data, before)


def test_backpressure_dedupe_and_staleness_count_like_jax():
    jsrv, srv = pair(async_ingest=True, queue_depth=5, max_staleness=3, drain_batch=2)
    results = []
    for s in (srv, jsrv):
        rt, out = s.async_ingest, []
        for k in range(12):
            out.append(rt.submit_event(f"u{k % 2}", k, k % 3))
        hi, hc, hm = histories(np.random.default_rng(5), 2)
        out.append(rt.submit_history("u0", hi[0], hc[0], hm[0]))
        out.append(rt.submit_history("u0", hi[1], hc[1], hm[1]))     # dedupes the first
        for k in range(8):
            out.append(rt.submit_event("u9", k, 1))                  # fills the queue
        out.append(rt.submit_touch("u9"))
        out.append((rt.staleness("u0"), rt.staleness("u9")))
        results.append((out, _stats(rt)))
        rt.flush()
        results.append((_stats(rt), s.stats.n_updates, s.stats.n_encodes))
    assert results[:2] == results[2:]
    st = srv.async_ingest.stats
    assert st.n_dropped > 0 and st.n_deduped > 0 and st.n_forced_drains > 0
    assert st.staleness_max() <= 3
    assert srv.metrics.snapshot()["counters"]["ingest.dropped"] == st.n_dropped


def test_writer_thread_flushes_everything():
    sync, asyn = _sync_async("fp32", drain_batch=4)
    rt = asyn.async_ingest
    rt.start()
    rt.start()                                    # idempotent
    for name, args in _submits(np.random.default_rng(6), blocks=False):
        getattr(sync, name)(*args)
        getattr(asyn, name)(*args)
    assert health_snapshot(asyn)["live"]
    assert rt.stop(flush=True) is True and rt.error is None
    assert rt.stats.queue_depth == 0 and rt._thread is None
    assert torch.equal(bits(asyn.fetch_many(USERS)), bits(sync.fetch_many(USERS)))


def test_dead_writer_keeps_its_work_and_stop_raises():
    """A fold that raises inside the writer thread is not swallowed: the
    entries it did not fold go back to the queue, the health probe says
    ``live: false``, and ``stop`` raises the writer's error."""
    broken = threading.Event()

    def embed(params, items, cats):
        if broken.is_set():
            raise RuntimeError("embedding table unavailable")
        return port_embed(params, items, cats)

    srv = BSEServer(embed, None, port_engine(), wire_dtype=torch.float32,
                    async_ingest=True, device="cpu")
    rt = srv.async_ingest
    srv.ingest_events(["a"], np.array([1]), np.array([1]))
    rt.flush()
    broken.set()
    rt.start()
    srv.ingest_events(["a", "b"], np.array([2, 3]), np.array([1, 1]))
    rt._thread.join(10)
    assert not rt._thread.is_alive() and isinstance(rt.error, RuntimeError)
    h = health_snapshot(srv)
    assert not h["live"] and not h["ready"] and h["checks"]["writer"]["ok"] is False
    assert rt.stats.queue_depth == 2 and rt.stats.n_events_folded == 1
    with pytest.raises(RuntimeError, match="writer thread died"):
        rt.stop()
    broken.clear()
    rt.flush()                                    # the work was kept
    assert rt.stats.n_events_folded == 3 and rt.stats.queue_depth == 0


def test_runtime_rejects_misconfiguration():
    srv = BSEServer(port_embed, None, port_engine(), device="cpu")
    for kw in ({"queue_depth": 0}, {"max_staleness": 0}, {"drain_batch": 0}):
        with pytest.raises(ValueError):
            AsyncIngestor(srv.ingestor, srv.store, **kw)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_repeated_users_fold_deterministically_and_match_jax(dtype):
    """One event burst with users repeated up to five times: the per-slot
    sums add each slot's rows in batch order, so two runs give the same
    bits, and the rows match the JAX package's ``segment_sum`` fold."""
    rng = np.random.default_rng(7)
    users = ["a", "b", "a", "a", "c", "b", "a", "a"]
    ev = events(rng, users, E=3)
    outs = []
    for _ in range(2):
        jsrv, srv = pair(table_dtype=dtype)
        for s in (srv, jsrv):
            s.ingest_events(users, *ev)
            s.ingest_events(users[::-1], *ev)
        outs.append(bits(srv.fetch_many(["a", "b", "c"])).clone())
        assert_rows_close(srv.fetch_many(["a", "b", "c"]), jsrv.fetch_many(["a", "b", "c"]),
                          dtype)
    assert torch.equal(outs[0], outs[1])
    deltas = torch.randn(9, 4, generator=torch.Generator().manual_seed(0))
    inv = np.array([2, 0, 2, 2, 1, 0, 2, 2, 1])
    sums = slot_sums(deltas, inv, 3)
    for s in range(3):                            # exactly the batch-order sum
        want = torch.zeros(4)
        for i in np.nonzero(inv == s)[0]:
            want = want + deltas[i]
        assert torch.equal(sums[s], want)
    assert torch.equal(slot_sums(deltas[:0], inv[:0], 2), torch.zeros(2, 4))
