"""Port parity of the serving runtime's host-side modules and of the
production path as a whole: ``serve/{metrics,export,admission,tracing,
health}.py`` and ``core/bse.py`` against the JAX package's, on the same
inputs (numpy seeds) and the same virtual clock; then the decoupled
``CTRServer`` of ``sdim-paper`` SMOKE built with the tiered store, async
ingest, admission control, metrics and tracing, through both packages.

Tolerances: equality for every counter, decision, span tree, health dict
and Prometheus page; fp32 atol 1e-5 for ``core/bse.py`` (the reference's
own, on margin-screened behaviors); atol 1e-5 / rtol 1e-4 for scores over
an fp32 wire (``tests/test_torch_serving.py``).
"""
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import VirtualClock
from repro.configs import sdim_paper as jcfgs
from repro.core import bse as jbse
from repro.models.ctr import CTRModel as JCTRModel
from repro.serve import admission as jadmission
from repro.serve.ctr_server import CTRServer as JCTRServer
from repro.serve.export import render_prometheus as jrender
from repro.serve.health import health_snapshot as jhealth
from repro.serve.metrics import MetricsRegistry as JMetricsRegistry
from repro.serve.metrics import observe_ms as jobserve_ms
from repro.serve.tracing import Tracer as JTracer
from repro_torch.configs import sdim_paper
from repro_torch.core import bse
from repro_torch.kernels.screen import clears_margin, screened_normal
from repro_torch.models.ctr import CTRModel
from repro_torch.serve import admission
from repro_torch.serve.ctr_server import CTRServer
from repro_torch.serve.export import render_prometheus
from repro_torch.serve.health import health_snapshot
from repro_torch.serve.metrics import MetricsRegistry, observe_ms
from repro_torch.serve.tracing import Tracer
from torch_runtime_parity import pair

# ---------------------------------------------------------------------------
# metrics + Prometheus exposition
# ---------------------------------------------------------------------------
def _observe(reg, observe, rng):
    reg.counter("ctr.requests").inc(7)
    reg.counter("ctr.shed").inc(2)
    reg.gauge("ingest.queue_depth").set(3)
    reg.gauge("mem.cold_bytes").set(0)
    reg.histogram("kernel.never_observed_ms")
    for i, v in enumerate(rng.lognormal(0.0, 2.0, 200)):
        observe(reg, "ctr.request_ms", v / 1e3, exemplar=f"t{i:08x}")
    for v in (float("nan"), -1.0, 0.0, 3e7):          # poisoned and clamped
        reg.histogram("tier.cold_read_ms").observe(v)


def test_metrics_snapshot_and_prometheus_page_match_jax():
    ours, ref = MetricsRegistry(), JMetricsRegistry()
    _observe(ours, observe_ms, np.random.default_rng(0))
    _observe(ref, jobserve_ms, np.random.default_rng(0))
    assert ours.snapshot() == ref.snapshot()
    assert ours.export_state() == ref.export_state()
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        h, jh = ours.histogram("ctr.request_ms"), ref.histogram("ctr.request_ms")
        assert h.quantile(q) == jh.quantile(q)
        assert h.exemplar(q) == jh.exemplar(q)
    health = {"live": True, "ready": False,
              "checks": {"writer": {"ok": True}, "ingest.queue": {"ok": False}}}
    assert render_prometheus(ours, health=health) == jrender(ref, health=health)
    assert render_prometheus(ours, prefix="sdim") == jrender(ref, prefix="sdim")
    with pytest.raises(TypeError):
        ours.gauge("ctr.requests")
    with pytest.raises(ValueError):
        ours.counter("ctr.requests").inc(-1)


# ---------------------------------------------------------------------------
# admission: token bucket, circuit breaker, controller
# ---------------------------------------------------------------------------
def _admission_trace(mod, clock, rng):
    """Decisions of every primitive under one scripted virtual-clock run."""
    out = []
    tb = mod.TokenBucket(rate=10.0, burst=5, clock=clock)
    br = mod.CircuitBreaker(deadline_s=0.05, failure_threshold=2,
                            reset_timeout_s=1.0, clock=clock)
    ac = mod.AdmissionController(max_concurrency=2, rate=20.0, burst=6, clock=clock)
    for step in range(60):
        dt, n, dur = rng.uniform(0, 0.3), int(rng.integers(1, 9)), rng.uniform(0, 0.1)
        clock.advance(dt)
        out.append(("tb", tb.try_acquire(2), tb.acquire_upto(n), round(tb.tokens, 9)))
        allowed = br.allow()
        if allowed:
            br.record(dur)
        out.append(("br", allowed, br.state, br.snapshot()))
        entered = ac.enter()
        k = ac.admit(n) if entered else 0
        if not entered:
            ac.shed_all(n)
        out.append(("ac", entered, k, ac.inflight, dataclasses.asdict(ac.stats)))
        if entered and step % 3:
            ac.exit()
    return out


def test_admission_decisions_match_jax():
    ours = _admission_trace(admission, VirtualClock(), np.random.default_rng(4))
    ref = _admission_trace(jadmission, VirtualClock(), np.random.default_rng(4))
    assert ours == ref
    assert any(e[0] == "br" and e[2] == "open" for e in ours)
    assert any(e[0] == "ac" and not e[1] for e in ours)


@pytest.mark.parametrize("make", [
    lambda m: m.TokenBucket(rate=0), lambda m: m.TokenBucket(rate=1, burst=0.5),
    lambda m: m.CircuitBreaker(deadline_s=0), lambda m: m.CircuitBreaker(1, failure_threshold=0),
    lambda m: m.AdmissionController(max_concurrency=0)])
def test_admission_rejects_what_jax_rejects(make):
    for mod in (admission, jadmission):
        with pytest.raises(ValueError):
            make(mod)


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------
def _span_tree(tracer_cls):
    clock = VirtualClock()
    tr = tracer_cls(clock=clock, slow_ms=4.0, max_tail=2, max_sampled=2, seed=0)
    for r in range(5):
        with tr.span("ctr.request", n=r) as root:
            clock.advance(0.001 * r)
            with tr.span("ctr.admission") as a:
                a.set(offered=r, admitted=r)
                clock.advance(0.0005)
            with tr.span("bse.fetch_many", n=2):
                with tr.span("tier.promote", n_warm=1, n_cold=0):
                    clock.advance(0.002)
                ctx = tr.current()
            tr.add_span(ctx, "ingest.fold", clock(), clock() + 0.001, commit_version=r)
            if r == 3:
                tr.flag("shed")
            with tr.span("ctr.score") as sc:
                clock.advance(0.001)
                if r == 0:
                    sc.name = "ctr.jit_compile"
            root.set(request_ms=r)
    return tr


def _shape(tr):
    out = []
    for t in tr.traces():
        by_id = {s.span_id: s for s in t.spans}
        out.append((sorted(t.flags), [(s.name, None if s.parent_id is None
                                       else by_id[s.parent_id].name,
                                       s.t0, s.t1, s.attrs) for s in t.spans]))
    return out


def test_tracer_span_trees_retention_and_exports_match_jax():
    ours, ref = _span_tree(Tracer), _span_tree(JTracer)
    assert _shape(ours) == _shape(ref)
    assert ours.summary() == ref.summary()
    assert ours.report(3) == ref.report(3)
    assert ours.to_chrome_trace() == ref.to_chrome_trace()
    assert (ours.n_traces, ours.n_spans, ours.n_dropped) == \
        (ref.n_traces, ref.n_spans, ref.n_dropped)


# ---------------------------------------------------------------------------
# health
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("state", ["healthy", "full_queue", "dead_writer"])
def test_health_snapshot_matches_jax(state, tmp_path):
    jsrv, srv = pair(async_ingest=True, queue_depth=4, hot_capacity=2, warm_capacity=1,
                     store_dir=str(tmp_path / "cold"), cold_deadline_s=1.0)
    # the two stores live in one directory tree: give each its own cold dir
    for s, sub in ((jsrv, "jax"), (srv, "port")):
        s.store.cold.dir = str(tmp_path / sub)
        os.makedirs(s.store.cold.dir)
    for s in (jsrv, srv):
        rng = np.random.default_rng(0)
        s.ingest_histories(["a", "b", "c"], *rng.integers(0, 8, (2, 3, 5)))
        s.async_ingest.flush()
        if state == "full_queue":
            for i in range(6):
                s.async_ingest.submit_event("a", i, 0)
        elif state == "dead_writer":
            s.async_ingest.submit_event("a", 1, 2)
            s.async_ingest._thread = types.SimpleNamespace(is_alive=lambda: False)
    ours, ref = health_snapshot(srv), jhealth(jsrv)
    assert ours == ref
    assert ours["live"] == (state != "dead_writer")
    assert ours["ready"] == (state == "healthy")
    assert render_prometheus(MetricsRegistry(), health=ours) == \
        jrender(JMetricsRegistry(), health=ref)
    assert srv.metrics.snapshot()["counters"] == jsrv.metrics.snapshot()["counters"]


# ---------------------------------------------------------------------------
# core/bse.py
# ---------------------------------------------------------------------------
def test_bse_config_matches_jax():
    for kw in ({}, dict(m=12, tau=2, d=16), dict(m=48, tau=4, d=32)):
        ours, ref = bse.BSEConfig(**kw), jbse.BSEConfig(**kw)
        assert (ours.n_groups, ours.n_buckets, ours.table_bytes(), ours.table_bytes(4)) == \
            (ref.n_groups, ref.n_buckets, ref.table_bytes(), ref.table_bytes(4))


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "single"])
def test_bse_encode_update_query_match_jax(batched):
    m, tau, d, B, L, C, n = 24, 3, 16, 3, 20, 5, 4
    R = np.array(jax.random.normal(jax.random.PRNGKey(3), (m, d)))
    rng = np.random.default_rng(1)
    lead = (B,) if batched else ()
    seq = screened_normal(rng, (*lead, L, d), R)
    mask = (rng.random((*lead, L)) > 0.3).astype(np.float32)
    q = screened_normal(rng, ((B, C, d) if batched else (C, d)), R)
    new = screened_normal(rng, (n, d), R)
    assert clears_margin(np.concatenate([seq.reshape(-1, d), q.reshape(-1, d), new]), R).all()
    t = {k: torch.as_tensor(v) for k, v in dict(seq=seq, mask=mask, q=q, new=new, R=R).items()}
    fp32 = dict(atol=1e-5, rtol=1e-5)
    table = bse.encode_sequence(t["seq"], t["mask"], t["R"], tau)
    jtable = jbse.encode_sequence(jnp.asarray(seq), jnp.asarray(mask), jnp.asarray(R), tau)
    np.testing.assert_allclose(table.numpy(), np.asarray(jtable), **fp32)
    np.testing.assert_allclose(bse.encode_sequence(t["seq"], None, t["R"], tau).numpy(),
                               np.asarray(jbse.encode_sequence(jnp.asarray(seq), None,
                                                               jnp.asarray(R), tau)), **fp32)
    one, jone = (table[0], jtable[0]) if batched else (table, jtable)
    np.testing.assert_allclose(bse.update_table(one, t["new"], t["R"], tau).numpy(),
                               np.asarray(jbse.update_table(jone, jnp.asarray(new),
                                                            jnp.asarray(R), tau)), **fp32)
    np.testing.assert_allclose(bse.query_interest(table, t["q"], t["R"], tau).numpy(),
                               np.asarray(jbse.query_interest(jtable, jnp.asarray(q),
                                                              jnp.asarray(R), tau)), **fp32)
    if batched:                               # (B, d) candidates, one per user
        np.testing.assert_allclose(
            bse.query_interest(table, t["q"][:, 0], t["R"], tau).numpy(),
            np.asarray(jbse.query_interest(jtable, jnp.asarray(q[:, 0]), jnp.asarray(R), tau)),
            **fp32)


# ---------------------------------------------------------------------------
# the slice as a whole: the production CTR server of sdim-paper SMOKE
# ---------------------------------------------------------------------------
N_USERS, C = 6, 8


@pytest.fixture(scope="module")
def jax_smoke():
    cfg = jcfgs.SMOKE
    cfg = dataclasses.replace(cfg, interest=dataclasses.replace(cfg.interest, backend="xla"))
    model = JCTRModel(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return model, params, jax.tree_util.tree_map(np.asarray, params)


def _screened_ids(rng, shape, params_np):
    cfg = sdim_paper.SMOKE
    R = params_np["interest"]["buffers"]["R"]
    items, cats = rng.integers(0, cfg.n_items, shape), rng.integers(0, cfg.n_cats, shape)

    def rows(i, c):
        return np.concatenate([params_np["item_emb"]["table"][i],
                               params_np["cat_emb"]["table"][c]], axis=-1)
    while True:
        bad = ~clears_margin(rows(items, cats), R)
        if not bad.any():
            return items.astype(np.int32), cats.astype(np.int32)
        items[bad] = rng.integers(0, cfg.n_items, int(bad.sum()))
        cats[bad] = rng.integers(0, cfg.n_cats, int(bad.sum()))


def _traffic(params_np):
    cfg = sdim_paper.SMOKE
    rng = np.random.default_rng(2)
    L = cfg.long_len
    hi, hc = _screened_ids(rng, (N_USERS, L), params_np)
    mask = (np.arange(L)[None] >= rng.integers(0, L // 2, (N_USERS, 1))).astype(np.float32)
    ci, cc = _screened_ids(rng, (N_USERS, C), params_np)
    ctx = rng.integers(0, 2, (N_USERS, C, cfg.ctx_dim)).astype(np.float32)
    requests = [(f"u{u}", {"hist_items": hi[u:u + 1], "hist_cats": hc[u:u + 1],
                           "hist_mask": mask[u:u + 1]}, ci[u], cc[u], ctx[u])
                for u in range(N_USERS)]
    ev_users = ["u0", "u2", "u2", "u5", "u1"]
    ei, ec = _screened_ids(rng, (len(ev_users),), params_np)
    return requests, (ev_users, ei, ec)


def _drive(server, requests, events):
    """Bursts through admission (one burst over the token budget), async
    misses, flushes, an event burst and tier movement; every score list."""
    rt = server.bse.async_ingest
    out = [server.handle_requests(requests[:4])]      # misses: zero interest
    rt.flush()
    out.append(server.handle_requests(requests[:4]))  # committed now
    out.append(server.handle_requests(requests))      # 4 shed by the bucket
    server._test_clock.advance(10.0)
    server.bse.ingest_events(*events)
    rt.flush()
    out.append(server.handle_requests(requests[2:]))  # demotes, touches
    rt.flush()
    out.append(server.handle_requests(requests[2:]))
    return out


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_production_ctr_server_matches_jax(jax_smoke, fused, tmp_path):
    jmodel, jparams, params_np = jax_smoke
    requests, events = _traffic(params_np)
    common = dict(hot_capacity=4, warm_capacity=1, policy="clock", async_ingest=True,
                  max_concurrency=2, rate_limit=1.0, rate_burst=10, fused=fused)
    jclock, clock = VirtualClock(), VirtualClock()
    jtr, tr = JTracer(clock=jclock, slow_ms=0.0), Tracer(clock=clock, slow_ms=0.0)
    jserver = JCTRServer.build(jmodel, jparams, "decoupled", wire_dtype=jnp.float32,
                               store_dir=str(tmp_path / "jax"), clock=jclock, tracer=jtr,
                               **common)
    server = CTRServer.build(CTRModel(sdim_paper.SMOKE, device="cpu"), params_np, "decoupled",
                             wire_dtype=torch.float32, store_dir=str(tmp_path / "port"),
                             clock=clock, tracer=tr, device="cpu", **common)
    jserver._test_clock, server._test_clock = jclock, clock
    ours, ref = _drive(server, requests, events), _drive(jserver, requests, events)
    for burst, jburst in zip(ours, ref):
        assert [s is None for s in burst] == [s is None for s in jburst]
        for a, b in zip(burst, jburst):
            if a is not None:
                np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-4)
    assert sum(s is None for s in ours[2]) == 4
    assert not np.allclose(ours[0][0], ours[1][0])     # the history landed
    st, jst = server.bse.store, jserver.bse.store
    assert dataclasses.asdict(st.stats) == dataclasses.asdict(jst.stats)
    assert {u: st.tier(u) for u in st.users()} == {u: jst.tier(u) for u in jst.users()}
    assert dataclasses.asdict(server.admission.stats) == dataclasses.asdict(jserver.admission.stats)
    assert (server.stats.n_requests, server.stats.n_shed) == \
        (jserver.stats.n_requests, jserver.stats.n_shed)
    snap, jsnap = server.metrics.snapshot(), jserver.metrics.snapshot()
    skip = {"ctr.jit_compiles"}          # a jit cache the port does not have
    assert {k: v for k, v in snap["counters"].items() if k not in skip} == \
        {k: v for k, v in jsnap["counters"].items() if k not in skip}
    assert snap["gauges"] == jsnap["gauges"]
    assert {k: v["count"] for k, v in snap["histograms"].items()} == \
        {k: v["count"] for k, v in jsnap["histograms"].items()}

    def names(tracer):
        rename = {"ctr.jit_compile": "ctr.score"}
        out = []
        for t in tracer.traces():
            by_id = {s.span_id: s for s in t.spans}
            out.append((sorted(t.flags), [(rename.get(s.name, s.name),
                                           None if s.parent_id is None else
                                           rename.get(by_id[s.parent_id].name,
                                                      by_id[s.parent_id].name))
                                          for s in t.spans]))
        return out
    assert names(tr) == names(jtr)
    assert health_snapshot(server) == jhealth(jserver)
