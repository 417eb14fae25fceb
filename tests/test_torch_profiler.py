"""The port's kernel profiler and memory ledger (``serve/profiler.py``) on
the CPU, mirroring ``tests/test_profiler.py``, then against the JAX
package.

The profiler half is deterministic: a ``StepClock`` (every read advances
a fixed step) pins each timed dispatch to an exact duration, so warmup
exclusion and the mean/min/max are checked against known numbers. The
ledger half sweeps conservation (event-accumulated bytes equal the bytes
each tier holds) under hypothesis bursts of grow / evict / promote /
demote / spill / quantize / snapshot-restore on tiered stores in fp32,
bf16, int8 and fp8, with a fixed burst beside it, and under engine ingest,
synchronous and async.

Against the JAX package: the same store operations on both packages'
tiered stores give equal ``snapshot()`` hot and warm bytes, ``events`` and
``moved_bytes``; cold bytes in fp32 and int8 only (fault C3 stops the
JAX cold tier in bf16 and fp8), where each of the port's segments holds
one member more than the reference's (the storage dtype's name) and is
larger by exactly that member. The launcher's ``--profile --profile-dir`` at
SMOKE writes a ``profile.json`` that ``tools/bench_check.py::
check_profile`` accepts, with the JAX launcher's kernel names and
dispatches per kernel (calls + compiles).
"""
import importlib.util
import io
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import pytest
import torch

from conftest import given, settings, st
from repro_torch.core.engine import EngineConfig, SDIMEngine
from repro_torch.serve.metrics import MetricsRegistry
from repro_torch.serve.profiler import KernelProfiler, KernelRecord, MemoryLedger
from repro_torch.serve.tiered_store import TieredTableStore
from repro_torch.serve.tracing import Tracer

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
D = 16
DTYPES = ["fp32", "bf16", "int8", "fp8"]


def _engine():
    return SDIMEngine(EngineConfig(m=21, tau=3, d=D), device="cpu")


def _batch(b=3, l=11, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((b, l, D), generator=gen), torch.ones((b, l))


class StepClock:
    """Every read advances time by ``step``: a dispatch (two reads) always
    measures exactly ``step`` seconds."""

    def __init__(self, step: float = 0.25):
        self.t, self.step = 0.0, step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


# ---------------------------------------------------------------------------
# profiler: warmup exclusion, deterministic timing, cost capture
# ---------------------------------------------------------------------------
def test_warmup_excluded_and_timing_deterministic():
    eng = _engine()
    metrics = MetricsRegistry()
    KernelProfiler(clock=StepClock(0.25), metrics=metrics).attach(eng)
    seq, mask = _batch()
    for _ in range(3):
        eng.encode(seq, mask)
    rec = eng.profiler.records["encode"]
    assert rec.n_compiles == 1                # the first dispatch of the shapes
    assert rec.n_calls == 2                   # ...is not in the sample
    assert rec.time_ms == pytest.approx(250.0)
    assert rec.min_s == rec.max_s == pytest.approx(0.25)
    snap = metrics.snapshot()
    assert snap["counters"]["kernel.compiles"] == 1
    assert snap["histograms"]["kernel.encode_ms"]["count"] == 2
    eng.encode(*_batch(l=12))                 # new shapes: a compile again
    assert (rec.n_compiles, rec.n_calls) == (2, 2)


def test_cost_capture_and_report_render():
    eng = _engine()
    prof = KernelProfiler().attach(eng).profiler
    seq, mask = _batch()
    table = None
    for _ in range(2):
        table = eng.encode(seq, mask)
    d = prof.to_dict()["encode"]
    assert d["flops"] > 0 and d["bytes"] > 0
    assert d["ai"] == pytest.approx(d["flops"] / d["bytes"])
    assert 0.0 <= d["pct_peak"] <= 1.0
    pred = d["predicted"]
    assert pred["roofline_ms"] >= 0 and pred["bottleneck"] in ("compute", "memory")
    assert pred["roofline_ms"] == pytest.approx(max(pred["t_compute_ms"], pred["t_memory_ms"]))
    report = prof.roofline_report()
    assert "encode" in report and "pct_peak" in report
    q = torch.randn((3, D), generator=torch.Generator().manual_seed(9))
    eng.query(q, table)                       # a second kernel is its own row
    assert "query" in prof.roofline_report()


def test_cost_is_summed_over_the_timed_calls_per_kernel_and_signature():
    """Each timed call is counted on its own data: a record's flops and
    bytes are the mean over the calls its mean time covers, per kernel and
    per signature, and the first dispatch of a signature adds no cost."""
    from repro_torch.kernels import cost

    eng = _engine()
    prof = KernelProfiler(clock=StepClock(0.25)).attach(eng).profiler
    seq, _ = _batch(l=11)
    masks = [torch.ones((3, 11)), (torch.arange(11) < 4).float().expand(3, 11).contiguous(),
             torch.zeros((3, 11))]
    for mask in masks:
        eng.encode(seq, mask)
    short, short_mask = _batch(b=2, l=5, seed=1)
    for _ in range(3):
        eng.encode(short, short_mask)
    counts = [cost.encode(seq, m, eng.R, tau=eng.cfg.tau) for m in masks[1:]]
    counts += [cost.encode(short, short_mask, eng.R, tau=eng.cfg.tau)] * 2
    assert counts[0].flops != counts[1].flops != counts[2].flops
    rec = prof.records["encode"]
    assert (rec.n_calls, rec.n_compiles) == (4, 2)
    assert rec.flops == pytest.approx(sum(c.flops for c in counts) / 4)
    assert rec.bytes == pytest.approx(sum(c.bytes for c in counts) / 4)
    assert rec.predicted.t_memory == pytest.approx(rec.bytes / 3.35e12)
    long_sig, short_sig = prof.signatures.values()
    assert (long_sig.n_calls, short_sig.n_calls) == (2, 2)
    assert long_sig.flops == pytest.approx((counts[0].flops + counts[1].flops) / 2)
    assert short_sig.bytes == pytest.approx(counts[2].bytes)
    assert long_sig.time_ms == short_sig.time_ms == rec.time_ms == pytest.approx(250.0)


def test_profiled_dispatch_output_parity():
    """Attaching a profiler changes no output, bit for bit."""
    eng_p, eng_n = _engine(), _engine()
    KernelProfiler().attach(eng_p)
    seq, mask = _batch(seed=3)
    t_p, t_n = eng_p.encode(seq, mask), eng_n.encode(seq, mask)
    assert torch.equal(t_p, t_n)
    q = torch.randn((3, 5, D), generator=torch.Generator().manual_seed(4))
    assert torch.equal(eng_p.query(q, t_p), eng_n.query(q, t_n))
    assert torch.equal(eng_p.serve(q, seq, mask), eng_n.serve(q, seq, mask))
    store_p, store_n = torch.cat([t_p, t_p]), torch.cat([t_n, t_n])
    slots = np.array([4, 0, 2])
    assert torch.equal(eng_p.serve_fused(store_p, slots, q), eng_n.serve_fused(store_n, slots, q))
    eng_p.update(store_p, slots, seq, mask)
    eng_n.update(store_n, slots, seq, mask)
    assert torch.equal(store_p, store_n)
    records = eng_p.profiler.records
    assert set(records) == {"encode", "query", "serve", "serve_fused", "update"}
    assert all(r.n_compiles == 1 and r.predicted is None for r in records.values())
    eng_p.encode(seq, mask)                   # a second, timed dispatch of each
    eng_p.query(q, t_p)
    eng_p.serve(q, seq, mask)
    eng_p.serve_fused(store_p, slots, q)
    eng_p.update(store_p, slots, seq, mask)
    assert all(r.n_calls == 1 and r.predicted is not None and r.bytes > 0
               for r in records.values())


def test_kernel_spans_carry_cost_attrs():
    tracer = Tracer()
    eng = _engine()
    KernelProfiler(tracer=tracer).attach(eng)
    seq, mask = _batch(l=13, seed=5)
    with tracer.span("request"):
        eng.encode(seq, mask)
        eng.encode(seq, mask)
    (trace,) = tracer.traces()
    kernel_spans = [s for s in trace.spans if s.name == "kernel.encode"]
    assert len(kernel_spans) == 2
    first, second = kernel_spans
    assert first.attrs.get("compile") is True        # the warmup is marked
    assert "compile" not in (second.attrs or {})
    for s in kernel_spans:
        assert s.attrs["flops"] > 0 and s.attrs["bytes"] > 0
        assert s.attrs["ai"] == pytest.approx(s.attrs["flops"] / s.attrs["bytes"])
        assert s.attrs["time_ms"] >= 0


def test_empty_record_is_all_zero():
    rec = KernelRecord("x")
    assert rec.time_ms == 0.0 and rec.ai == 0.0 and rec.pct_peak == 0.0
    d = rec.to_dict()
    assert d["min_ms"] == 0.0 and "predicted" not in d
    assert "(no profiled dispatches)" in KernelProfiler().roofline_report()


# ---------------------------------------------------------------------------
# ledger: conservation under op bursts, four storage dtypes
# ---------------------------------------------------------------------------
def _tiered(dtype, store_dir):
    store = TieredTableStore(2, 4, 8, hot_capacity=3, dtype=dtype, warm_capacity=2,
                             store_dir=store_dir, device="cpu")
    ledger = MemoryLedger()
    ledger.attach(store)
    return store, ledger


def _rows(store, n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, *store.row_shape)).astype(np.float32)


def _write_users(store, users, seed):
    store.write(store.assign(users), torch.from_numpy(_rows(store, len(users), seed)))


def _run_conservation_ops(dtype, ops):
    """Apply an op burst to a fresh tiered store, asserting conservation
    after every op."""
    tmp = tempfile.mkdtemp(prefix="ledger-sweep-")
    try:
        store, ledger = _tiered(dtype, os.path.join(tmp, "cold"))
        live = set()
        for i, (op, x) in enumerate(ops):
            if op == "write":                 # grow + demote + spill chains
                users = [x, x + 1, x + 2]
                _write_users(store, users, seed=i)
                live.update(users)
            elif op == "touch" and live:      # promotes demoted users back
                store.assign(sorted(live)[:2])
            elif op == "evict" and live:
                u = sorted(live)[x % len(live)]
                store.evict(u)
                live.discard(u)
            elif op == "restore":             # snapshot -> a NEW store
                snap = os.path.join(tmp, f"snap{i}")
                store.snapshot(snap)
                store = TieredTableStore.restore(snap, device="cpu")
                ledger = MemoryLedger()       # a fresh ledger, a fresh baseline
                ledger.attach(store)
            assert ledger.verify() == [], f"after op {i}: {(op, x)}"
        snap = ledger.snapshot()
        assert snap["total_bytes"] == (snap["hot_bytes"] + snap["warm_bytes"]
                                       + snap["cold_bytes"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


_OPS = st.lists(st.tuples(st.sampled_from(["write", "touch", "evict", "restore"]),
                          st.integers(0, 17)), min_size=1, max_size=10)
FIXED_BURST = [("write", 0), ("write", 3), ("touch", 0), ("write", 6), ("evict", 2),
               ("restore", 0), ("write", 9), ("touch", 1), ("evict", 0), ("write", 12),
               ("restore", 0), ("touch", 2)]


@settings(max_examples=20, deadline=None, derandomize=True)
@given(dtype=st.sampled_from(DTYPES), ops=_OPS)
def test_ledger_conservation_sweep(dtype, ops):
    """Every grow / quantize / demote / spill / promote / evict /
    snapshot-restore burst leaves the ledger balanced against what the
    tiers hold (the port's cold tier keeps bf16 and fp8 too)."""
    _run_conservation_ops(dtype, ops)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ledger_conservation_fixed_burst(dtype):
    """One burst through every transition: grow, demote, spill, promote,
    evict, quantize and snapshot-restore."""
    _run_conservation_ops(dtype, FIXED_BURST)


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ledger_conserves_under_engine_ingest(dtype, mode, tmp_path):
    """History encodes, event folds (``sdim_update`` in place on an fp32
    store, encode-and-rewrite on the others) and fused reads through a
    tiered ``BSEServer``, synchronous and through the async writer thread
    (copy on write under committed views), keep the ledger balanced."""
    from repro_torch.serve.bse_server import BSEServer

    emb = torch.randn((64, D), generator=torch.Generator().manual_seed(7))
    srv = BSEServer(lambda params, items, cats: emb[torch.as_tensor(np.asarray(items)) % 64],
                    None, _engine(), wire_dtype=torch.float32, table_dtype=dtype,
                    hot_capacity=4, warm_capacity=2, store_dir=str(tmp_path),
                    async_ingest=mode == "async", metrics=MetricsRegistry(), device="cpu")
    ledger = MemoryLedger(metrics=srv.metrics)
    ledger.attach(srv.store)
    rng = np.random.default_rng(0)
    runtime = srv.async_ingest
    if runtime is not None:
        runtime.start()
    for lo in range(0, 12, 4):
        users = list(range(lo, lo + 4))
        srv.ingest_histories(users, rng.integers(0, 64, (4, 9)), rng.integers(0, 16, (4, 9)))
        if runtime is not None:
            runtime.flush()
        assert ledger.verify() == []
    srv.ingest_events(list(range(4)), rng.integers(0, 64, 4), rng.integers(0, 16, 4))
    if runtime is not None:
        runtime.flush()
    assert ledger.verify() == []
    q = emb[torch.as_tensor(rng.integers(0, 64, (4, 6)))]
    srv.serve_candidates(list(range(4)), q)
    if runtime is not None:
        runtime.stop(flush=True)
    assert ledger.verify() == []
    snap = ledger.snapshot()
    assert snap["events"].get("demote", 0) >= 1 and snap["events"].get("spill", 0) >= 1
    assert snap["hot_bytes"] == srv.store.hot._nbytes() > 0
    assert srv.metrics.snapshot()["gauges"]["mem.hot_bytes"] == snap["hot_bytes"]


def test_ledger_detects_missed_event():
    """A byte change that bypasses the event sites shows up in verify():
    the invariant is falsifiable, not vacuously true."""
    store, ledger = _tiered("fp32", None)
    _write_users(store, [0, 1], seed=0)
    assert ledger.verify() == []
    store.hot.ledger = None                   # double the device allocation unseen
    store.hot._grow()
    errs = ledger.verify()
    assert errs and "hot" in errs[0]


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
def _dtype_member_bytes(name: str) -> int:
    """How much larger a segment is for the port's extra member, the
    storage dtype's name (``ColdStore.spill``)."""
    sizes = []
    for extra in ({}, {"dtype": np.asarray(name)}):
        buf = io.BytesIO()
        np.savez(buf, rows=np.zeros(3, np.float32), **extra)
        sizes.append(len(buf.getvalue()))
    return sizes[1] - sizes[0]


@pytest.mark.parametrize("dtype", DTYPES)
def test_ledger_snapshots_match_jax(dtype, tmp_path):
    """The fixed burst on both packages' tiered stores (hot 3, warm 2):
    equal hot and warm bytes, events and moved bytes after every op; cold
    bytes in fp32 and int8 (JAX's cold tier and snapshots cannot hold bf16
    or fp8: fault C3, so those run without a cold tier and without
    restores)."""
    import jax.numpy as jnp
    from repro.serve.profiler import MemoryLedger as JMemoryLedger
    from repro.serve.tiered_store import TieredTableStore as JTieredTableStore

    cold = dtype in ("fp32", "int8")
    ops = [op for op in FIXED_BURST if cold or op[0] != "restore"]

    def make(pkg, tag):
        store_dir = str(tmp_path / tag / "cold") if cold else None
        if pkg == "jax":
            s = JTieredTableStore(2, 4, 8, hot_capacity=3, dtype=dtype, warm_capacity=2,
                                  store_dir=store_dir)
            led = JMemoryLedger()
        else:
            s = TieredTableStore(2, 4, 8, hot_capacity=3, dtype=dtype, warm_capacity=2,
                                 store_dir=store_dir, device="cpu")
            led = MemoryLedger()
        led.attach(s)
        return s, led

    stores = {pkg: make(pkg, pkg) for pkg in ("jax", "port")}
    live = set()
    for i, (op, x) in enumerate(ops):
        for pkg, (s, led) in list(stores.items()):
            if op == "write":
                users = [x, x + 1, x + 2]
                rows = _rows(s, len(users), seed=i)
                s.write(s.assign(users), jnp.asarray(rows) if pkg == "jax"
                        else torch.from_numpy(rows))
            elif op == "touch" and live:
                s.assign(sorted(live)[:2])
            elif op == "evict" and live:
                s.evict(sorted(live)[x % len(live)])
            elif op == "restore":
                snap = str(tmp_path / pkg / f"snap{i}")
                s.snapshot(snap)
                s = (JTieredTableStore.restore(snap) if pkg == "jax"
                     else TieredTableStore.restore(snap, device="cpu"))
                led = JMemoryLedger() if pkg == "jax" else MemoryLedger()
                led.attach(s)
                stores[pkg] = (s, led)
        if op == "write":
            live.update([x, x + 1, x + 2])
        elif op == "evict" and live:
            live.discard(sorted(live)[x % len(live)])
        (js, jled), (ps, pled) = stores["jax"], stores["port"]
        assert pled.verify() == [] and jled.verify() == []
        jsnap, psnap = jled.snapshot(), pled.snapshot()
        where = f"after op {i} {(op, x)}"
        for k in ("hot_bytes", "warm_bytes", "events", "moved_bytes"):
            assert psnap[k] == jsnap[k], (where, k, psnap[k], jsnap[k])
        assert {k.replace("cold", "-") for k in psnap["by_key"]} == \
            {k.replace("cold", "-") for k in jsnap["by_key"]}
        if cold:
            n_segments = ps.cold.n_segments
            assert n_segments == js.cold.n_segments
            assert psnap["cold_bytes"] - jsnap["cold_bytes"] == \
                n_segments * _dtype_member_bytes(dtype), where
    assert stores["port"][1].snapshot()["events"].get("demote", 0) >= 1


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_launcher_profile_matches_jax(tmp_path, monkeypatch, capsys):
    """``--profile --profile-dir`` at SMOKE, fused off a tiered store with a
    cold directory: the port's ``profile.json`` passes ``check_profile``,
    its kernels and their dispatches (calls + compiles) are the JAX
    launcher's, and its ledger conserves (printed, not raised)."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve

    def argv(tag):
        return ["--arch", "sdim-paper", "--requests", "6", "--candidates", "16",
                "--micro-batch", "2", "--fused-serve", "--hot-capacity", "2",
                "--warm-capacity", "2", "--store-dir", str(tmp_path / tag / "cold"),
                "--profile", "--profile-dir", str(tmp_path / tag)]

    tserve.main(argv("port") + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["serve"] + argv("jax"))
    jserve.main()
    out = capsys.readouterr().out
    assert "MISMATCH" not in out and out.count("conservation OK") == 2
    check = _load_tool("bench_check").check_profile
    prof = {}
    for tag in ("port", "jax"):
        with open(tmp_path / tag / "profile.json") as f:
            prof[tag] = json.load(f)
        check(prof[tag])
    count = lambda p: {k: v["calls"] + v["compiles"] for k, v in p["per_kernel"].items()}
    assert count(prof["port"]) == count(prof["jax"]) == {"encode": 3, "serve_fused": 3}
    for k in ("hot_bytes", "warm_bytes", "events", "moved_bytes"):
        assert prof["port"]["mem"][k] == prof["jax"]["mem"][k], k


def test_launcher_refuses_profile_without_the_decoupled_deployment():
    """As the JAX launcher: the profiler wraps the SDIM engine's dispatch
    sites, which only the decoupled (kind sdim) deployment has."""
    import dataclasses

    from repro_torch.configs import bst
    from repro_torch.launch import serve as tserve

    inline = dataclasses.replace(bst.SMOKE, interest=dataclasses.replace(bst.SMOKE.interest,
                                                                         kind="target"))
    for flag in (["--profile"], ["--profile-dir", "unused"]):
        with pytest.raises(SystemExit):
            tserve.build(["--arch", "bst", "--device", "cpu", *flag], cfg=inline)
