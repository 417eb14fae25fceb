"""Table 5 — online serving ablation on the port: BSE-decoupled SDIM vs
inline SDIM vs exact target attention, at the paper's online scale (T=2000
behaviors, B candidates per request):

    python -m repro_torch.bench.table5_serving [--full] [--device cpu]

Counterpart of ``benchmarks/table5_serving.py``, section for section, with
the same rows and the same schema-4 dict (``tools/bench_check.py`` checks
either). The paper reports: long-seq TA undeployable (+50% latency, 25–30
ms); SDIM+BSE ≈ +1 ms (mostly transmission). Here: CTR-server wall time
per request and the decoupled/inline/TA ratios + the fixed transmission
size.

Where the reference measures every SDIM deployment on its two backends,
``xla`` and interpret-mode ``pallas``, the port's engine has no backend
flag (the data's device decides), and each section loops over two
devices: ``cuda`` (the hand-written kernels, at the sizes the reference
gives ``xla``) and ``cpu`` (the kernels' plain versions on the host, at
the sizes it gives interpret-mode ``pallas``). ``device="cpu"`` runs the
``cpu`` side only; ``backend_ratio`` is cpu/cuda. The ``cpu`` side is a
labelled measurement of its own, as the reference's ``pallas`` side: CUDA
data never falls back to a plain version.

Sections (each a function that takes its sizes as arguments):

* ``ablation_rows`` — Table 5 proper: decoupled (``sdim_query`` off the
  fetched table; ``bse_encode`` on first sight), inline (``bse_serve``) and
  target-attention (``target_attention_flash``) ``CTRServer``s.
* ``throughput_rows`` — the multi-user TableStore path: N users per
  ``handle_requests`` burst vs the per-user loop, batched
  ``ingest_events`` (one ``sdim_update``) vs the per-event loop.
* ``fused_rows`` — ``sdim_fused_serve`` (``BSEServer.serve_candidates``)
  against the two-dispatch path (``fetch_many`` + ``engine.query``), fp32
  and int8 stores: users/s, per-burst p50/p95/p99, the stored-bytes ratio
  and the roofline bytes of the three graphs. The reference reads the
  bytes from XLA's ``cost_analysis`` of compiled graphs; the port counts
  them with ``kernels/cost.py`` (each input read once, each output written
  once), the gather by the same rule.
* ``auc_parity_rows`` — a trained SDIM model served through the fp32
  unfused path and the int8 fused path: their AUC gap (bound 1e-3).
* ``sharded_rows`` — a ``ShardedTableStore`` of 8 shards (``MeshCtx`` of
  8 copies of the run's device: all on one card) against one
  ``TableStore``.
* ``ingest_rows`` — async ingestion under an open-loop read/write mix:
  read-only vs under-ingest fetch p95 (bound 1.2x), folded events/s,
  drops, staleness.
* ``pressure_rows`` — the tiered store under Zipf traffic over 4x the hot
  capacity: hit rate, promote/demote bytes, users/s vs unbounded.
* ``slo_rows`` — the production request path (admission, tiered store,
  cold breaker) under open-loop overload: p50/p95/p99, shed and degrade
  rates, conservation asserted.
* ``trace_rows`` — span coverage of a traced replay.
* ``profile_rows`` — ``KernelProfiler`` and ``MemoryLedger`` over a small
  tiered fused-serve workload, conservation asserted.

``run`` writes the dict to ``results/torch/BENCH_serving.json`` (the
repo-root ``BENCH_serving.json`` is the JAX run's) and appends one line
to ``results/torch/bench_history.jsonl``. Every model and embedding draws
from a seeded ``torch.Generator``; traffic from the reference's numpy
seeds, so the tier statistics of a section match the reference's.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.bench.common import (auc, block, paper_data_config,
                                      paper_model_config, sync, train)
from repro_torch.core.engine import EngineConfig, SDIMEngine
from repro_torch.core.interest import InterestConfig
from repro_torch.data.synthetic import (SyntheticCTRConfig, generate_batch,
                                        generate_batch_graded)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.mesh_ctx import MeshCtx
from repro_torch.kernels import cost
from repro_torch.models.ctr import CTRConfig, CTRModel
from repro_torch.serve.bse_server import BSEServer
from repro_torch.serve.ctr_server import CTRServer

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))
RESULTS_DIR = os.path.join(REPO_ROOT, "results", "torch")
SHARDS = 8


def devices(device: DeviceLike) -> dict:
    """The sections' backends: {"cuda": the run's card, "cpu": the host}
    on the card, {"cpu": the host} when the CPU is asked for. The first
    is the run's main device."""
    dev = resolve_device(device)
    cpu = torch.device("cpu")
    return {"cuda": dev, "cpu": cpu} if dev.type == "cuda" else {"cpu": cpu}


def _model(cfg: CTRConfig, dev: torch.device) -> CTRModel:
    return CTRModel(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))


def _embedder(d: int, dev: torch.device):
    """The sections' behavior embedding: item rows (4000) from seed 11 and
    category rows (50) from seed 12, d/2 wide each, concatenated."""
    rows = lambda seed, n: torch.randn((n, d // 2), generator=torch.Generator()
                                       .manual_seed(seed)).to(dev)
    emb_i, emb_c = rows(11, 4000), rows(12, 50)

    def embed(params, items, cats):
        i = torch.as_tensor(items, device=dev).long()
        c = torch.as_tensor(cats, device=dev).long()
        return torch.cat([emb_i[i % 4000], emb_c[c % 50]], dim=-1)
    return embed


def _pcts(lat: list) -> tuple:
    return tuple(1e3 * float(np.percentile(lat, q)) for q in (50, 95, 99))


def run(quick: bool = True, device: DeviceLike = "cuda", out_dir: str = RESULTS_DIR,
        sizes: Optional[dict] = None):
    """Every section, then the dict written to ``out_dir``. ``sizes`` maps
    a section's name (``ablation``, ``throughput``, ``fused``, ``auc``,
    ``sharded``, ``ingest``, ``pressure``, ``slo``, ``trace``,
    ``profile``) to keyword arguments of its function."""
    sizes = sizes or {}
    kw = lambda name: sizes.get(name, {})
    bench = {"schema": 4, "quick": bool(quick),
             "generated_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
             "backends": {}, "quantization": {}, "roofline": {},
             "hit_rate": {}, "ingest": {}, "slo": {}, "trace": {},
             "profile": {}}
    rows = ablation_rows(quick, device, **kw("ablation"))
    rows.extend(throughput_rows(quick, device, **kw("throughput")))
    rows.extend(fused_rows(quick, bench, device, **kw("fused")))
    rows.extend(auc_parity_rows(quick, bench, device, **kw("auc")))
    rows.extend(sharded_rows(quick, device, **kw("sharded")))
    rows.extend(ingest_rows(quick, bench, device, **kw("ingest")))
    rows.extend(pressure_rows(quick, bench, device, **kw("pressure")))
    rows.extend(slo_rows(quick, bench, device, **kw("slo")))
    rows.extend(trace_rows(quick, bench, device, **kw("trace")))
    rows.extend(profile_rows(quick, bench, device, **kw("profile")))
    write_bench_json(bench, out_dir)
    return rows


def ablation_server(mode: str, kind: str, dev: torch.device, T: int, B: int):
    """One Table 5 deployment on ``dev`` (``mode`` decoupled, inline or
    target_attention; ``kind`` sdim or target) and its request: one user
    of T behaviors scoring B candidates. Returns (server, the arguments of
    ``handle_request``)."""
    cfg = CTRConfig(arch="din", n_items=4000, n_cats=50, long_len=T,
                    short_len=16, mlp_hidden=(64, 32),
                    interest=InterestConfig(kind=kind, m=48, tau=3))
    server = CTRServer.build(_model(cfg, dev), None, mode, device=dev)
    rng = np.random.default_rng(0)
    raw = generate_batch(SyntheticCTRConfig(hist_len=T, n_items=4000, n_cats=50), 1, 0)
    user = {k: v for k, v in raw.items() if k.startswith("hist")}
    ci = rng.integers(0, 4000, B).astype(np.int32)
    cc = rng.integers(0, 50, B).astype(np.int32)
    return server, ("u", user, ci, cc, np.zeros((B, 4), np.float32))


@torch.no_grad()
def ablation_rows(quick: bool = True, device: DeviceLike = "cuda", T: int = 2000,
                  B: Optional[int] = None, n_req: Optional[int] = None) -> list[dict]:
    """Table 5 proper: ms/request of the decoupled and inline SDIM servers
    on every backend and of the target-attention server on the main
    device, one user of T behaviors scoring B candidates a request."""
    B = B or (256 if quick else 1024)
    n_req = n_req or (5 if quick else 20)
    devs = devices(device)
    main = next(iter(devs))
    rows = []
    servers = {}
    variants = ([("decoupled", "sdim", b) for b in devs]
                + [("inline", "sdim", b) for b in devs]
                + [("target_attention", "target", None)])
    for mode, kind, backend in variants:
        server, request = ablation_server(mode, kind, devs[backend or main], T, B)
        server.handle_request(*request)                 # warm (kernel build + encode)
        server.stats.n_requests = 0
        server.stats.total_time_s = 0.0
        for _ in range(n_req):
            scores = server.handle_request(*request)
        tag = f"{mode}[{backend}]" if backend else mode
        assert scores.shape == (B,) and np.isfinite(scores).all(), f"{tag}: scores not finite"
        servers[tag] = server
        rows.append({"name": f"table5/{tag}", "us_per_call":
                     1e3 * server.stats.ms_per_request,
                     "shards": 1 if mode == "decoupled" else "-",
                     "derived": f"ms_per_request={server.stats.ms_per_request:.2f}"})
    dec = servers[f"decoupled[{main}]"].stats.ms_per_request
    ta = servers["target_attention"].stats.ms_per_request
    inl = servers[f"inline[{main}]"].stats.ms_per_request
    rows.append({"name": "table5/latency_saved_vs_TA", "us_per_call": 0.0,
                 "derived": f"decoupled_saves={100 * (1 - dec / ta):.1f}%_of_TA_"
                            f"(paper:95%);inline/decoupled={inl / dec:.2f}x"})
    ratio = (f"{servers['decoupled[cpu]'].stats.ms_per_request / dec:.2f}x"
             if main == "cuda" else "not_measured")
    rows.append({"name": "table5/backend_ratio", "us_per_call": 0.0,
                 "derived": f"cpu/cuda_decoupled={ratio}(plain_versions_on_the_host)"})
    rows.append({"name": "table5/transmission_bytes", "us_per_call": 0.0,
                 "derived": f"{servers[f'decoupled[{main}]'].bse.table_bytes()}"
                            "B_fixed_(L-free,bf16_wire)"})
    return rows


@torch.no_grad()
def throughput_rows(quick: bool = True, device: DeviceLike = "cuda", n_users: int = 1024,
                    chunk: int = 256) -> list[dict]:
    """Multi-user TableStore throughput: batched fetch_many+serve vs the
    per-user loop at N users, and batched vs per-event ingest."""
    L, C = 256, 8
    rows = []
    for backend, dev in devices(device).items():
        # the plain versions on the host keep their user count bounded in
        # quick mode, as the reference's interpret-mode Pallas does
        n = n_users if backend == "cuda" or not quick else min(n_users, 128)
        ch = min(chunk, n)
        loop_n = min(n, 128 if backend == "cuda" else 16)
        dcfg = SyntheticCTRConfig(hist_len=L, n_items=4000, n_cats=50)
        cfg = CTRConfig(arch="din", n_items=4000, n_cats=50, long_len=L,
                        short_len=8, mlp_hidden=(32,), embed_dim=16,
                        interest=InterestConfig(kind="sdim", m=24, tau=3))
        ctr = CTRServer.build(_model(cfg, dev), None, "decoupled", capacity=n, device=dev)
        bse = ctr.bse
        rng = np.random.default_rng(0)
        raw = generate_batch(dcfg, n, 0)
        hists = {k: v for k, v in raw.items() if k.startswith("hist")}
        for lo in range(0, n, ch):                         # batched bootstrap
            hi = min(lo + ch, n)
            sl = slice(lo, hi)
            bse.ingest_histories(
                list(range(lo, hi)), raw["hist_items"][sl],
                raw["hist_cats"][sl], raw["hist_mask"][sl])
        ci = rng.integers(0, 4000, (n, C)).astype(np.int32)
        cc = rng.integers(0, 50, (n, C)).astype(np.int32)
        zctx = np.zeros((C, 4), np.float32)

        # requests carry HOST arrays (they arrive from the network in
        # production); both paths pay the same device upload
        def request(u):
            return (u, {k: v[u][None] for k, v in hists.items()},
                    ci[u], cc[u], zctx)

        reqs = [request(u) for u in range(n)]
        ctr.handle_request(*reqs[0])                       # warm per-user
        ctr.handle_requests(reqs[:ch])                     # warm batched
        if n % ch:
            ctr.handle_requests(reqs[-(n % ch):])          # warm tail shape
        t0 = time.perf_counter()
        for r in reqs[:loop_n]:
            ctr.handle_request(*r)
        loop_ups = loop_n / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        for lo in range(0, n, ch):
            ctr.handle_requests(reqs[lo:lo + ch])
        batch_ups = n / (time.perf_counter() - t0)

        ev_i = rng.integers(0, 4000, n)
        ev_c = rng.integers(0, 50, n)
        bse.ingest_event(0, int(ev_i[0]), int(ev_c[0]))    # warm both paths
        bse.ingest_events(list(range(ch)), ev_i[:ch], ev_c[:ch])
        if n % ch:                                         # warm tail shape
            bse.ingest_events(list(range(n % ch)),
                              ev_i[:n % ch], ev_c[:n % ch])
        # a fold returns before the card finishes: sync before reading the
        # clock, so events/sec measures compute, not the launch
        sync(dev)
        t0 = time.perf_counter()
        for u in range(loop_n):
            bse.ingest_event(u, int(ev_i[u]), int(ev_c[u]))
        sync(dev)
        loop_eps = loop_n / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        for lo in range(0, n, ch):
            hi = min(lo + ch, n)
            bse.ingest_events(list(range(lo, hi)),
                              ev_i[lo:hi], ev_c[lo:hi])
        sync(dev)
        batch_eps = n / (time.perf_counter() - t0)

        tag = f"throughput[{backend}]"
        rows.append({"name": f"table5/{tag}/users_per_sec",
                     "us_per_call": 1e6 / batch_ups, "shards": 1,
                     "derived": f"batched={batch_ups:.0f}/s_loop={loop_ups:.0f}/s"
                                f"_speedup={batch_ups / loop_ups:.1f}x_N={n}"})
        rows.append({"name": f"table5/{tag}/events_per_sec",
                     "us_per_call": 1e6 / batch_eps, "shards": 1,
                     "derived": f"batched={batch_eps:.0f}/s_loop={loop_eps:.0f}/s"
                                f"_speedup={batch_eps / loop_eps:.1f}x_N={n}"})
    return rows


def gather_bytes(store, n: int) -> int:
    """Bytes of the two-dispatch path's gather of ``n`` rows out of
    ``store`` into fp32 tables: each row (and its scales) read once, each
    fp32 table written once, the slots read."""
    G, U, d = store.row_shape
    return n * (store.row_nbytes() + G * U * d * 4 + 4)


@torch.no_grad()
def fused_rows(quick: bool = True, bench: Optional[dict] = None,
               device: DeviceLike = "cuda", n_users: Optional[int] = None,
               reps: Optional[int] = None) -> list[dict]:
    """Fused serve kernel vs the two-dispatch path, fp32 and int8 stores:
    users/sec + per-burst latency percentiles per backend, the
    stored-bytes ratio, and the roofline bytes of the three graphs. The
    int8 server runs the SAME ``serve_candidates`` call —
    dequantization happens inside the gather+query launch."""
    d, C, L = 32, 8, 64
    reps = reps or (3 if quick else 10)
    rows = []
    devs = devices(device)
    main = next(iter(devs))
    for backend, dev in devs.items():
        # the plain versions on the host serve fewer users, as the
        # reference's interpret-mode Pallas does
        N = n_users or (1024 if backend == "cuda" else (128 if quick else 512))
        bs = min(256, N)
        embed = _embedder(d, dev)
        eng = SDIMEngine(EngineConfig(m=24, tau=3, d=d), device=dev)
        rng = np.random.default_rng(0)
        hist_i = rng.integers(0, 4000, (N, L))
        hist_c = rng.integers(0, 50, (N, L))
        servers = {}
        for dt in ("fp32", "int8"):
            # fp32 wire so the two paths differ ONLY in fused-vs-two
            # dispatch (and the bytes row compares stored fp32 vs int8,
            # not the bf16 wire default)
            srv = BSEServer(embed, None, eng, capacity=N, wire_dtype=torch.float32,
                            table_dtype=dt, device=dev)
            for lo in range(0, N, bs):
                us = list(range(lo, lo + bs))
                srv.ingest_histories(us, hist_i[lo:lo + bs], hist_c[lo:lo + bs])
            servers[dt] = srv
        q = embed(None, rng.integers(0, 4000, (N, C)), rng.integers(0, 50, (N, C)))
        users = list(range(N))

        def two_dispatch(lo):
            tables = servers["fp32"].fetch_many(users[lo:lo + bs])
            return eng.query(q[lo:lo + bs], tables.float())

        def fused(lo):
            return servers["fp32"].serve_candidates(users[lo:lo + bs], q[lo:lo + bs])

        def fused_int8(lo):
            return servers["int8"].serve_candidates(users[lo:lo + bs], q[lo:lo + bs])

        variants = {"two_dispatch": two_dispatch, "fused": fused,
                    "fused_int8": fused_int8}
        stats, outs = {}, {}
        for name, fn in variants.items():
            outs[name] = fn(0).cpu().numpy()                 # warm
            lat = []
            t0 = time.perf_counter()
            for _ in range(reps):
                for lo in range(0, N, bs):
                    tb = time.perf_counter()
                    block(fn(lo))
                    lat.append(time.perf_counter() - tb)
            ups = reps * N / (time.perf_counter() - t0)
            p50, p95, p99 = _pcts(lat)
            stats[name] = {"users_per_sec": round(ups, 1), "p50_ms": round(p50, 3),
                           "p95_ms": round(p95, 3), "p99_ms": round(p99, 3)}
        for name, out in outs.items():
            assert np.isfinite(out).all(), f"fused[{backend}] {name}: not finite"
        speedup = (stats["fused"]["users_per_sec"]
                   / stats["two_dispatch"]["users_per_sec"])
        err_fused = float(np.abs(outs["fused"] - outs["two_dispatch"]).max())
        err_int8 = float(np.abs(outs["fused_int8"] - outs["two_dispatch"]).max())
        tag = f"fused[{backend}]"
        rows.append({"name": f"table5/{tag}/users_per_sec",
                     "us_per_call": 1e6 / stats["fused"]["users_per_sec"],
                     "shards": 1,
                     "derived": f"fused={stats['fused']['users_per_sec']:.0f}/s"
                                f"_two_dispatch="
                                f"{stats['two_dispatch']['users_per_sec']:.0f}/s"
                                f"_speedup={speedup:.2f}x_N={N}_burst={bs}"})
        rows.append({"name": f"table5/{tag}/latency",
                     "us_per_call": 1e3 * stats["fused"]["p50_ms"],
                     "shards": 1,
                     "derived": f"p50={stats['fused']['p50_ms']}ms"
                                f"_p95={stats['fused']['p95_ms']}ms"
                                f"_p99={stats['fused']['p99_ms']}ms"
                                f"_int8_p50={stats['fused_int8']['p50_ms']}ms"})
        rows.append({"name": f"table5/{tag}/parity",
                     "us_per_call": 0.0, "shards": 1,
                     "derived": f"max|fused-two_dispatch|={err_fused:.1e}"
                                f"_max|int8-fp32|={err_int8:.1e}"})
        if bench is not None:
            bench["backends"][backend] = {
                "n_users": N, "burst": bs, **stats,
                "speedup_fused_vs_two_dispatch": round(speedup, 3),
                "max_abs_err_fused_vs_two_dispatch": err_fused,
                "max_abs_err_int8_vs_fp32": err_int8,
            }

        if backend == main:
            b_fp32 = servers["fp32"].table_bytes()
            b_int8 = servers["int8"].table_bytes()
            ratio = b_fp32 / b_int8
            rows.append({"name": "table5/quantized/table_bytes",
                         "us_per_call": 0.0, "shards": 1,
                         "derived": f"fp32={b_fp32}B_int8={b_int8}B"
                                    f"_ratio={ratio:.2f}x_(payload+scales)"})
            if bench is not None:
                bench["quantization"].update({
                    "table_bytes_fp32": int(b_fp32),
                    "table_bytes_int8": int(b_int8),
                    "bytes_ratio": round(ratio, 3),
                })
            # roofline: the bytes each graph must move (kernels/cost.py) —
            # int8 shrinks the store operand ~4x. The fused-vs-two-dispatch
            # win is launch count + host round-trip, which the count does
            # not price; that shows up in the wall-clock rows above.
            st32, st8 = servers["fp32"].store, servers["int8"].store
            slots = torch.arange(bs, dtype=torch.int32, device=dev)
            qb = q[:bs].float().contiguous()
            tables = st32.rows(np.arange(bs)).float()
            nbytes = lambda c: cost.settle(c).bytes
            recs = {
                "two_dispatch": gather_bytes(st32, bs)
                + nbytes(cost.query(qb, tables, eng.R, tau=3)),
                "fused": nbytes(cost.serve_fused(st32.data, slots, qb, eng.R, tau=3)),
                "fused_int8": nbytes(cost.serve_fused(st8.data, slots, qb, eng.R, tau=3,
                                                      scales=st8.scales)),
            }
            rows.append({"name": "table5/fused/roofline_bytes",
                         "us_per_call": 0.0, "shards": 1,
                         "derived": "_".join(f"{k}={v:.0f}B"
                                             for k, v in recs.items())})
            if bench is not None:
                bench["roofline"] = {k: float(v) for k, v in recs.items()}
    return rows


def auc_parity_rows(quick: bool = True, bench: Optional[dict] = None,
                    device: DeviceLike = "cuda", steps: Optional[int] = None,
                    n_eval: Optional[int] = None) -> list[dict]:
    """AUC parity gate for int8 storage: train one SDIM CTR model on the
    graded synthetic data (table 2/3 smoke depth), then serve the SAME
    held-out examples through (a) the fp32 unfused oracle path and (b) the
    int8 fused path, and compare serving-path AUCs. Per-row scales cancel
    under Eq. 12's ℓ2-normalize, so the gap should sit well inside the 1e-3
    acceptance bound. Runs on the main device."""
    dev = resolve_device(device)
    steps = steps or (200 if quick else 400)
    n_eval = n_eval or (512 if quick else 2048)
    batch, burst, long_len = 128, 128, 64
    dcfg = paper_data_config(long_len)
    model = _model(paper_model_config("sdim", long_len, m=24), dev)
    train(model, dcfg, steps, batch, seed=0, lr=2e-3)

    servers = {
        "fp32_unfused": CTRServer.build(
            model, None, "decoupled", capacity=n_eval,
            wire_dtype=torch.float32, table_dtype="fp32", device=dev),
        "int8_fused": CTRServer.build(
            model, None, "decoupled", capacity=n_eval,
            wire_dtype=torch.float32, table_dtype="int8", fused=True, device=dev),
    }
    scores = {k: [] for k in servers}
    labels = []
    for lo in range(0, n_eval, burst):
        eb = generate_batch_graded(dcfg, burst, 10_000_000 + lo)
        labels.append(eb["label"])
        reqs = [(lo + i,
                 {k: eb[k][i][None] for k in ("hist_items", "hist_cats", "hist_mask")},
                 eb["cand_item"][i:i + 1], eb["cand_cat"][i:i + 1],
                 eb["ctx"][i][None])
                for i in range(burst)]
        for name, srv in servers.items():
            scores[name].extend(float(s[0]) for s in srv.handle_requests(reqs))
    labels = np.concatenate(labels)
    assert all(np.isfinite(v).all() for v in scores.values()), "auc parity: scores not finite"
    auc_fp32 = auc(labels, np.asarray(scores["fp32_unfused"]))
    auc_int8 = auc(labels, np.asarray(scores["int8_fused"]))
    gap = abs(auc_fp32 - auc_int8)
    if bench is not None:
        bench["quantization"].update({
            "auc_fp32_unfused": round(auc_fp32, 5),
            "auc_int8_fused": round(auc_int8, 5),
            "auc_gap": round(gap, 6),
            "train_steps": steps, "eval_examples": n_eval,
        })
    return [{"name": "table5/quantized/auc_parity", "us_per_call": 0.0,
             "shards": 1,
             "derived": f"fp32_unfused={auc_fp32:.4f}"
                        f"_int8_fused={auc_int8:.4f}_gap={gap:.1e}"
                        f"_(bound_1e-3)_steps={steps}_eval={n_eval}"}]


@torch.no_grad()
def profile_rows(quick: bool = True, bench: Optional[dict] = None,
                 device: DeviceLike = "cuda", n_bursts: Optional[int] = None) -> list[dict]:
    """Measured roofline + memory ledger (schema 4): a small tiered
    fused-serve workload with ``serve/profiler.py`` attached — the
    ``KernelProfiler`` on the engine times every dispatch (CUDA events on
    the card; the first dispatch of a signature, which carries the kernel
    build, excluded) and counts its flops and bytes (``kernels/cost.py``)
    for the roofline prediction per kernel; the ``MemoryLedger`` accounts
    device/host/disk bytes across every grow/evict/promote/demote/
    quantize/spill event, with conservation (ledger == tier-reported
    nbytes) asserted before anything is written. Runs on the main device."""
    from repro_torch.serve.metrics import MetricsRegistry
    from repro_torch.serve.profiler import KernelProfiler, MemoryLedger

    dev = resolve_device(device)
    d, L, C = 16, 32, 8
    H = 16                         # hot capacity
    W = 3 * H                      # working set: spills warm + cold
    n_bursts = n_bursts or (8 if quick else 32)
    embed = _embedder(d, dev)
    eng = SDIMEngine(EngineConfig(m=24, tau=3, d=d), device=dev)
    metrics = MetricsRegistry()
    prof = KernelProfiler(metrics=metrics)
    prof.attach(eng)
    tmp = tempfile.mkdtemp(prefix="bse-profile-")
    try:
        srv = BSEServer(embed, None, eng, wire_dtype=torch.float32,
                        hot_capacity=H, warm_capacity=H, store_dir=tmp,
                        metrics=metrics, device=dev)
        ledger = MemoryLedger(metrics=metrics)
        ledger.attach(srv.store)
        rng = np.random.default_rng(0)
        hist_i = rng.integers(0, 4000, (W, L))
        hist_c = rng.integers(0, 50, (W, L))
        for lo in range(0, W, H):                       # encode dispatches
            srv.ingest_histories(list(range(lo, lo + H)),
                                 hist_i[lo:lo + H], hist_c[lo:lo + H])
        p = 1.0 / (np.arange(1, W + 1) ** 1.1)          # Zipf(1.1) traffic
        p /= p.sum()
        for _ in range(n_bursts):                       # fused-serve bursts
            us = [int(u) for u in rng.choice(W, size=H, p=p)]
            uniq = list(dict.fromkeys(us))
            q = embed(None, rng.integers(0, 4000, (len(uniq), C)),
                      rng.integers(0, 50, (len(uniq), C)))
            block(srv.serve_candidates(uniq, q))
            srv.ingest_events(uniq, rng.integers(0, 4000, len(uniq)),
                              rng.integers(0, 50, len(uniq)))   # update path
        conservation = ledger.verify()
        assert not conservation, f"memory ledger broken: {conservation}"
        mem = ledger.snapshot()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    per_kernel = prof.to_dict()
    if bench is not None:
        bench["profile"] = {"per_kernel": per_kernel, "mem": mem}
    fused = per_kernel.get("serve_fused", {})
    pred = fused.get("predicted", {})
    return [
        {"name": "table5/profile/serve_fused", "us_per_call":
         1e3 * fused.get("time_ms", 0.0), "shards": 1,
         "derived": f"measured={fused.get('time_ms', 0.0):.4f}ms"
                    f"_predicted={pred.get('roofline_ms', 0.0):.4f}ms"
                    f"_bound={pred.get('bottleneck', '-')}"
                    f"_ai={fused.get('ai', 0.0):.2f}"
                    f"_pct_peak={fused.get('pct_peak', 0.0):.3f}"
                    f"_calls={fused.get('calls', 0)}"},
        {"name": "table5/profile/mem_ledger", "us_per_call": 0.0,
         "shards": 1,
         "derived": f"hot={mem['hot_bytes']}B_warm={mem['warm_bytes']}B"
                    f"_cold={mem['cold_bytes']}B_conservation=OK"},
    ]


def git_rev() -> str:
    """Short commit hash of the checkout the benchmark ran in, or
    ``"unknown"`` outside a git repo / without a git binary."""
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=REPO_ROOT,
                             capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    rev = out.stdout.strip()
    return rev if out.returncode == 0 and rev else "unknown"


def append_bench_history(bench: dict, out_dir: str) -> str:
    """Append a one-line summary of this run to ``bench_history.jsonl`` in
    ``out_dir`` — the per-commit trajectory that ``tools/bench_trend.py``
    renders. Append-only: each benchmark run adds one record; the full
    ``BENCH_serving.json`` keeps only the latest."""
    slo = bench.get("slo") or {}
    trace = bench.get("trace") or {}
    fused = {backend: d["fused"]["users_per_sec"]
             for backend, d in (bench.get("backends") or {}).items()}
    profile = bench.get("profile") or {}
    fused_kernel = (profile.get("per_kernel") or {}).get("serve_fused") or {}
    mem = profile.get("mem") or {}
    rec = {
        "git_rev": bench.get("git_rev", "unknown"),
        "generated_utc": bench.get("generated_utc"),
        "schema": bench.get("schema"),
        "quick": bench.get("quick"),
        "slo_p50_ms": slo.get("p50_ms"),
        "slo_p95_ms": slo.get("p95_ms"),
        "slo_p99_ms": slo.get("p99_ms"),
        "shed_rate": slo.get("shed_rate"),
        "fused_users_per_sec": fused,
        "span_coverage": trace.get("span_coverage"),
        "n_compile_spans": trace.get("n_compile_spans"),
        "fused_time_ms": fused_kernel.get("time_ms"),
        "hot_bytes": mem.get("hot_bytes"),
    }
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "bench_history.jsonl")
    with open(path, "a") as f:
        f.write(json.dumps(rec, sort_keys=True) + "\n")
    return path


def write_bench_json(bench: dict, out_dir: str = RESULTS_DIR) -> str:
    """Atomically write ``BENCH_serving.json`` in ``out_dir`` (schema
    validated by ``tools/bench_check.py``), stamped with the current git
    revision, and append this run's summary to the benchmark history."""
    bench.setdefault("git_rev", git_rev())
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "BENCH_serving.json")
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(bench, f, indent=2, sort_keys=True)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    append_bench_history(bench, out_dir)
    return path


@torch.no_grad()
def sharded_rows(quick: bool = True, device: DeviceLike = "cuda", n_users: int = 512,
                 chunk: int = 128) -> list[dict]:
    """``ShardedTableStore`` over ``SHARDS`` shards of the main device (the
    ``shards`` column; all 8 on one card): batched
    ingest_histories / fetch_many / ingest_events against the row-sharded
    store, with the single-device TableStore numbers inline for
    comparison. Launches one kernel per shard a fold; not a speed across
    cards."""
    dev = resolve_device(device)
    n = n_users
    ch = min(chunk, n)
    L = 128
    dcfg = SyntheticCTRConfig(hist_len=L, n_items=4000, n_cats=50)
    cfg = CTRConfig(arch="din", n_items=4000, n_cats=50, long_len=L,
                    short_len=8, mlp_hidden=(32,), embed_dim=16,
                    interest=InterestConfig(kind="sdim", m=24, tau=3))
    model = _model(cfg, dev)
    raw = generate_batch(dcfg, n, 0)
    rng = np.random.default_rng(0)
    ev_i = rng.integers(0, 4000, n)
    ev_c = rng.integers(0, 50, n)
    rows = []
    mesh = MeshCtx((dev,) * SHARDS)
    perf = {}
    for variant, m in (("single", None), ("sharded", mesh)):
        ctr = CTRServer.build(model, None, "decoupled", mesh=m, capacity=n, device=dev)
        bse = ctr.bse

        def ingest_all():
            for lo in range(0, n, ch):
                hi = min(lo + ch, n)
                sl = slice(lo, hi)
                bse.ingest_histories(
                    list(range(lo, hi)), raw["hist_items"][sl],
                    raw["hist_cats"][sl], raw["hist_mask"][sl])

        ingest_all()                                       # warm (kernel build)
        bse.store.clear()                                  # re-ingest from empty
        t0 = time.perf_counter()
        ingest_all()
        sync(dev)
        enc_ups = n / (time.perf_counter() - t0)

        users = list(range(n))
        bse.fetch_many(users[:ch])                         # warm
        t0 = time.perf_counter()
        for lo in range(0, n, ch):
            block(bse.fetch_many(users[lo:lo + ch]))
        fetch_ups = n / (time.perf_counter() - t0)

        bse.ingest_events(users[:ch], ev_i[:ch], ev_c[:ch])  # warm
        sync(dev)
        t0 = time.perf_counter()
        for lo in range(0, n, ch):
            hi = min(lo + ch, n)
            bse.ingest_events(users[lo:hi], ev_i[lo:hi], ev_c[lo:hi])
        sync(dev)
        perf[variant] = (enc_ups, fetch_ups, n / (time.perf_counter() - t0))

    enc, fetch, ev = perf["sharded"]
    enc1, fetch1, ev1 = perf["single"]
    rows.append({"name": "table5/sharded/fetch_users_per_sec",
                 "us_per_call": 1e6 / fetch, "shards": SHARDS,
                 "derived": f"sharded={fetch:.0f}/s_single={fetch1:.0f}/s"
                            f"_N={n}_chunk={ch}"})
    rows.append({"name": "table5/sharded/encode_users_per_sec",
                 "us_per_call": 1e6 / enc, "shards": SHARDS,
                 "derived": f"sharded={enc:.0f}/s_single={enc1:.0f}/s"})
    rows.append({"name": "table5/sharded/events_per_sec",
                 "us_per_call": 1e6 / ev, "shards": SHARDS,
                 "derived": f"sharded={ev:.0f}/s_single={ev1:.0f}/s"
                            f"_capacity_scales_{SHARDS}x"})
    return rows


@torch.no_grad()
def ingest_rows(quick: bool = True, bench: Optional[dict] = None,
                device: DeviceLike = "cuda", n_bursts: Optional[int] = None,
                gap_s: float = 0.03, linger_s: float = 0.5) -> list[dict]:
    """Async ingestion under a mixed read/write workload: the writer loop
    folds Poisson-arriving events while the main thread serves Zipf fetch
    bursts off the committed view. The workload is OPEN-LOOP — bursts are
    spaced by exponential think time (mean ``gap_s``) rather than issued
    back-to-back, which is the correct methodology for a latency claim (a
    closed loop saturates the host and measures throughput, not serving
    latency). The read-only baseline runs the identical request schedule
    with no events flowing. Reports read-only vs under-ingest fetch
    latency (the §4.4 claim: ingestion is latency-free for serving — reads
    never join a fold; bound: under-ingest p95 within 1.2x of read-only
    p95), folded events/sec, drops, and staleness. Runs on the main
    device: the contention measured is host thread + launch."""
    dev = resolve_device(device)
    d = 16
    N = 256                       # users, all device-hot (unbounded store)
    C = 64                        # Zipf fetch burst
    L = 32
    n_bursts = n_bursts or (80 if quick else 240)
    lam = 32                      # mean Poisson event arrivals per burst
    embed = _embedder(d, dev)
    eng = SDIMEngine(EngineConfig(m=24, tau=3, d=d), device=dev)
    srv = BSEServer(embed, None, eng, capacity=N, wire_dtype=torch.float32,
                    async_ingest=True, queue_depth=8192, max_staleness=512,
                    drain_batch=256, device=dev)
    rt = srv.async_ingest
    # linger: batch many bursts of arrivals per fold, so the serving path
    # contends with a handful of folds per run, not one per burst
    rt.linger_s = linger_s
    rng = np.random.default_rng(0)
    srv.ingest_histories(list(range(N)), rng.integers(0, 4000, (N, L)),
                         rng.integers(0, 50, (N, L)))
    rt.flush()                                      # bootstrap committed
    p = 1.0 / (np.arange(1, N + 1) ** 1.1)          # Zipf(1.1) fetch traffic
    p /= p.sum()
    bursts = [[int(u) for u in rng.choice(N, size=C, p=p)]
              for _ in range(n_bursts)]
    arrivals = rng.poisson(lam, n_bursts)           # events between bursts
    ev_users = [[int(u) for u in rng.choice(N, size=max(int(k), 1), p=p)]
                for k in arrivals]
    gaps = rng.exponential(gap_s, n_bursts)

    block(srv.fetch_many(bursts[0]))                         # warm fetch
    srv.ingest_events(ev_users[0], rng.integers(0, 4000, len(ev_users[0])),
                      rng.integers(0, 50, len(ev_users[0])))
    rt.flush()                                               # warm the folds

    lat = []                                                 # read-only
    for b, g in zip(bursts, gaps):
        tb = time.perf_counter()
        block(srv.fetch_many(b))
        lat.append(time.perf_counter() - tb)
        time.sleep(g)
    read_p50, read_p95, _ = _pcts(lat)

    rt.stats = type(rt.stats)()                              # mixed phase
    rt.start()
    submitted = 0
    lat = []
    t0 = time.perf_counter()
    try:
        for b, us, g in zip(bursts, ev_users, gaps):
            submitted += srv.ingest_events(
                us, rng.integers(0, 4000, len(us)), rng.integers(0, 50, len(us)))
            time.sleep(g)
            tb = time.perf_counter()
            block(srv.fetch_many(b))
            lat.append(time.perf_counter() - tb)
        wall = time.perf_counter() - t0
    finally:
        rt.stop(flush=True)
    mixed_p50, mixed_p95, _ = _pcts(lat)
    st = rt.stats
    assert st.n_events_folded + st.n_dropped >= submitted, \
        f"ingest balance: folded={st.n_events_folded} dropped={st.n_dropped} " \
        f"submitted={submitted}"
    eps = st.n_events_folded / wall
    ratio = mixed_p95 / max(read_p95, 1e-9)
    if bench is not None:
        bench["ingest"] = {
            "n_users": N, "burst": C, "n_bursts": n_bursts,
            "poisson_lambda": lam,
            "read_only": {"p50_ms": round(read_p50, 3),
                          "p95_ms": round(read_p95, 3)},
            "under_ingest": {"p50_ms": round(mixed_p50, 3),
                             "p95_ms": round(mixed_p95, 3)},
            "p95_ratio": round(ratio, 3),
            "events_per_sec": round(eps, 1),
            "events_submitted": int(submitted),
            "events_folded": int(st.n_events_folded),
            "n_dropped": int(st.n_dropped),
            "n_folds": int(st.n_folds),
            "max_queue_depth": int(st.max_queue_depth),
            "max_drain_batch": int(st.max_drain_batch),
            "staleness_p95": round(st.staleness_p95(), 2),
        }
    return [
        {"name": "table5/ingest/serve_latency",
         "us_per_call": 1e3 * mixed_p95, "shards": 1,
         "derived": f"under_ingest_p95={mixed_p95:.2f}ms"
                    f"_read_only_p95={read_p95:.2f}ms_ratio={ratio:.2f}x"
                    f"_(bound_1.2x)_p50={mixed_p50:.2f}ms"},
        {"name": "table5/ingest/events_per_sec",
         "us_per_call": 1e6 / max(eps, 1e-9), "shards": 1,
         "derived": f"folded={eps:.0f}/s_submitted={submitted}"
                    f"_dropped={st.n_dropped}_folds={st.n_folds}"
                    f"_max_queue={st.max_queue_depth}"
                    f"_staleness_p95={st.staleness_p95():.1f}"},
    ]


@torch.no_grad()
def pressure_rows(quick: bool = True, bench: Optional[dict] = None,
                  device: DeviceLike = "cuda", hot: Optional[int] = None,
                  L: Optional[int] = None, n_bursts: int = 16) -> list[dict]:
    """Capacity-pressure: the tiered store under Zipf traffic whose working
    set is 4x the hot capacity (the acceptance bound), vs the unbounded
    single-tier store. The serving path is ``fetch_many`` — the op the CTR
    server drives — so what's measured is gather + batched promote/demote,
    never per-user launches (the gather/scatter counters prove it)."""
    from repro_torch.serve.tiered_store import TierStats

    d = 16
    rows = []
    for backend, dev in devices(device).items():
        # the plain versions on the host keep their ingest volume bounded
        # in quick mode, as the reference's interpret-mode Pallas does
        H = hot or (32 if backend == "cuda" or not quick else 16)   # hot capacity
        W = 4 * H                                                   # working set
        Lb = L or (64 if backend == "cuda" else 32)
        embed = _embedder(d, dev)
        eng = SDIMEngine(EngineConfig(m=24, tau=3, d=d), device=dev)
        tmp = tempfile.mkdtemp(prefix="bse-cold-")
        try:
            tiered = BSEServer(embed, None, eng, hot_capacity=H,
                               warm_capacity=2 * H, store_dir=tmp,
                               policy="clock", device=dev)
            flat = BSEServer(embed, None, eng, capacity=W, device=dev)
            rng = np.random.default_rng(0)
            hist_i = rng.integers(0, 4000, (W, Lb))
            hist_c = rng.integers(0, 50, (W, Lb))
            for lo in range(0, W, H):                       # batched bootstrap
                us = list(range(lo, lo + H))
                for s in (tiered, flat):
                    s.ingest_histories(us, hist_i[lo:lo + H], hist_c[lo:lo + H])
            # Zipf(1.1) over the working set: a hot head the size of the
            # hot tier, a long tail that lives warm/cold
            p = 1.0 / (np.arange(1, W + 1) ** 1.1)
            p /= p.sum()
            bursts = [[int(u) for u in rng.choice(W, size=H, p=p)]
                      for _ in range(n_bursts)]
            for s in (tiered, flat):                        # warm
                s.fetch_many(bursts[0])
            tiered.store.stats = TierStats()                # serving-only
            t0 = time.perf_counter()
            for b in bursts:
                block(tiered.fetch_many(b))
            tiered_ups = n_bursts * H / (time.perf_counter() - t0)
            t0 = time.perf_counter()
            for b in bursts:
                block(flat.fetch_many(b))
            flat_ups = n_bursts * H / (time.perf_counter() - t0)
            ts = tiered.store.stats
            tiers = tiered.store.tier_sizes()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if bench is not None:
            bench["hit_rate"][backend] = round(float(ts.hit_rate), 4)
        tag = f"pressure[{backend}]"
        rows.append({
            "name": f"table5/{tag}/users_per_sec",
            "us_per_call": 1e6 / tiered_ups, "shards": 1,
            "derived": f"tiered={tiered_ups:.0f}/s_unbounded={flat_ups:.0f}/s"
                       f"_hot={H}_working_set={W}_zipf1.1"})
        rows.append({
            "name": f"table5/{tag}/hit_rate",
            "us_per_call": 0.0, "shards": 1,
            "derived": f"hit_rate={ts.hit_rate:.2f}"
                       f"_promote={ts.warm_promotions + ts.cold_promotions}"
                       f"(cold={ts.cold_promotions})_demote={ts.demotions}"
                       f"_tiers={tiers}".replace(" ", "")})
        rows.append({
            "name": f"table5/{tag}/bytes_moved",
            "us_per_call": 0.0, "shards": 1,
            "derived": f"promote={ts.promote_bytes}B_demote={ts.demote_bytes}B"
                       f"_spill={ts.spill_bytes}B_hot_gathers="
                       f"{ts.n_hot_gathers}_hot_scatters={ts.n_hot_scatters}"
                       f"_bursts={n_bursts}"})
    return rows


def _small_ctr(dev: torch.device) -> CTRModel:
    """The slo and trace sections' model: din, 200 items, 20 categories,
    L = 32, sdim m = 8, tau = 2."""
    return _model(CTRConfig(arch="din", n_items=200, n_cats=20, long_len=32,
                            short_len=8, mlp_hidden=(16,),
                            interest=InterestConfig(kind="sdim", m=8, tau=2)), dev)


@torch.no_grad()
def slo_rows(quick: bool = True, bench: Optional[dict] = None,
             device: DeviceLike = "cuda", n_bursts: Optional[int] = None,
             gap_s: float = 0.02) -> list[dict]:
    """Tail latency under overload through the FULL production request path:
    ``CTRServer.handle_requests`` with admission control (token-bucket rate
    limit + concurrency bound), a tiered store whose working set spills past
    the hot tier, and the cold-tier circuit breaker armed. The workload is
    OPEN-LOOP — Zipf(1.1) user popularity, Poisson request arrivals per
    burst, exponential think gaps (mean ``gap_s``) — and deliberately
    offers more traffic than the token bucket admits, so the shed path
    (explicit ``None`` scores, every one counted) is exercised at its real
    rate rather than never. Reports per-burst p50/p95/p99 over admitted
    bursts plus the shed and degrade rates into ``bench['slo']``.
    Conservation is asserted inline: offered == served + shed. Runs on the
    main device."""
    from repro_torch.serve.tiered_store import TierStats

    dev = resolve_device(device)
    dcfg = SyntheticCTRConfig(hist_len=32, n_items=200, n_cats=20)
    N = 96                        # working set (users)
    H = 32                        # device-hot capacity (rest spills cold)
    C = 8                         # requests per arriving burst (Poisson mean)
    CAND = 16                     # candidates per request
    n_bursts = n_bursts or (60 if quick else 200)
    rate_limit = 200.0            # admitted requests/sec
    rate_burst = 16.0
    tmp = tempfile.mkdtemp(prefix="bse-slo-")
    try:
        server = CTRServer.build(
            _small_ctr(dev), None, "decoupled", wire_dtype=torch.float32,
            hot_capacity=H, warm_capacity=0, store_dir=tmp,
            cold_deadline_s=0.05, rate_limit=rate_limit,
            rate_burst=rate_burst, max_concurrency=4, device=dev)
        rng = np.random.default_rng(0)
        raw = generate_batch(dcfg, 1, 0)
        ub = {k: v for k, v in raw.items() if k.startswith("hist")}
        hist_i = rng.integers(0, 200, (N, 32))
        hist_c = rng.integers(0, 20, (N, 32))
        for lo in range(0, N, H):                       # bootstrap all tiers
            server.bse.ingest_histories(list(range(lo, lo + H)),
                                        hist_i[lo:lo + H], hist_c[lo:lo + H])
        p = 1.0 / (np.arange(1, N + 1) ** 1.1)          # Zipf(1.1) popularity
        p /= p.sum()
        sizes = np.maximum(rng.poisson(C, n_bursts), 1)  # Poisson arrivals
        gaps = rng.exponential(gap_s, n_bursts)

        def burst(k):
            us = rng.choice(N, size=k, p=p)
            return [(int(u), ub,
                     rng.integers(0, 200, CAND).astype(np.int32),
                     rng.integers(0, 20, CAND).astype(np.int32),
                     np.zeros((CAND, 4), np.float32)) for u in us]

        # warm one burst per Poisson size with admission off, so no warm
        # burst sheds and the timed loop measures serving, not first use
        adm, server.admission = server.admission, None
        for k in sorted({int(s) for s in sizes}):
            server.handle_requests(burst(k))
        server.admission = adm
        server.stats = type(server.stats)()
        server.bse.store.stats = TierStats()
        lat, offered, shed = [], 0, 0
        t0 = time.perf_counter()
        for k, g in zip(sizes, gaps):
            reqs = burst(int(k))
            tb = time.perf_counter()
            scores = server.handle_requests(reqs)       # host arrays: synced
            live = [s for s in scores if s is not None]
            dt = time.perf_counter() - tb
            offered += len(reqs)
            shed += len(reqs) - len(live)
            if live:                    # fully-shed bursts cost ~0: excluded
                lat.append(dt)
            time.sleep(g)
        wall = time.perf_counter() - t0
        st = server.stats
        assert offered == st.n_requests + st.n_shed, \
            f"conservation: offered={offered} served={st.n_requests} " \
            f"shed={st.n_shed}"
        n_degraded = server.bse.store.stats.n_degraded
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    p50, p95, p99 = _pcts(lat)
    offered_rps = offered / max(wall, 1e-9)
    shed_rate = shed / max(offered, 1)
    degrade_rate = n_degraded / max(st.n_requests, 1)
    if bench is not None:
        bench["slo"] = {
            "n_requests": int(offered),
            "n_served": int(st.n_requests),
            "n_shed": int(shed),
            "n_degraded": int(n_degraded),
            "n_bursts": int(n_bursts),
            "offered_rps": round(offered_rps, 1),
            "admitted_rps_limit": rate_limit,
            "p50_ms": round(p50, 3),
            "p95_ms": round(p95, 3),
            "p99_ms": round(p99, 3),
            "shed_rate": round(shed_rate, 4),
            "degrade_rate": round(degrade_rate, 4),
            "hot_capacity": H, "working_set": N,
        }
    return [
        {"name": "table5/slo/tail_latency",
         "us_per_call": 1e3 * p99, "shards": 1,
         "derived": f"p50/p95/p99={p50:.2f}/{p95:.2f}/{p99:.2f}ms"
                    f"_over_{len(lat)}_admitted_bursts"},
        {"name": "table5/slo/overload",
         "us_per_call": 0.0, "shards": 1,
         "derived": f"offered={offered_rps:.0f}rps_limit={rate_limit:.0f}rps"
                    f"_shed={shed_rate:.1%}_degraded={degrade_rate:.1%}"
                    f"_conserved={offered}=={st.n_requests}+{shed}"},
    ]


@torch.no_grad()
def trace_rows(quick: bool = True, bench: Optional[dict] = None,
               device: DeviceLike = "cuda", n_bursts: Optional[int] = None) -> list[dict]:
    """Span coverage of the traced request path (schema 3): replay a small
    admission-controlled tiered-store workload with the request tracer
    (``serve/tracing.py``) enabled, then report what fraction of retained
    root-span wall time is accounted for by instrumented child stages
    (admission / assemble / fetch / score / tier movement) plus the number
    of compile spans (the scoring pass that built the kernel library).
    Runs on its OWN small server so the slo section above stays untraced.
    Writes ``bench['trace']``. Runs on the main device."""
    from repro_torch.serve.tracing import Tracer

    dev = resolve_device(device)
    dcfg = SyntheticCTRConfig(hist_len=32, n_items=200, n_cats=20)
    N = 48                        # working set spills past the hot tier
    H = 16
    CAND = 16
    n_bursts = n_bursts or (20 if quick else 80)
    tracer = Tracer(slow_ms=None)   # reservoir keeps this whole small run
    tmp = tempfile.mkdtemp(prefix="bse-trace-")
    try:
        server = CTRServer.build(
            _small_ctr(dev), None, "decoupled", wire_dtype=torch.float32,
            hot_capacity=H, warm_capacity=0, store_dir=tmp,
            cold_deadline_s=0.05, rate_limit=400.0, rate_burst=8.0,
            max_concurrency=4, tracer=tracer, device=dev)
        rng = np.random.default_rng(0)
        raw = generate_batch(dcfg, 1, 0)
        ub = {k: v for k, v in raw.items() if k.startswith("hist")}
        hist_i = rng.integers(0, 200, (N, 32))
        hist_c = rng.integers(0, 20, (N, 32))
        for lo in range(0, N, H):
            server.bse.ingest_histories(list(range(lo, lo + H)),
                                        hist_i[lo:lo + H], hist_c[lo:lo + H])
        p = 1.0 / (np.arange(1, N + 1) ** 1.1)
        p /= p.sum()
        for _ in range(n_bursts):
            us = rng.choice(N, size=4, p=p)
            reqs = [(int(u), ub,
                     rng.integers(0, 200, CAND).astype(np.int32),
                     rng.integers(0, 20, CAND).astype(np.int32),
                     np.zeros((CAND, 4), np.float32)) for u in us]
            server.handle_requests(reqs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    s = tracer.summary()
    if bench is not None:
        bench["trace"] = {
            "span_coverage": round(s["span_coverage"], 4),
            "n_compile_spans": int(s["n_compile_spans"]),
            "n_traces": int(s["n_traces"]),
            "n_spans": int(s["n_spans"]),
            "n_retained_tail": int(s["n_retained_tail"]),
            "n_retained_sampled": int(s["n_retained_sampled"]),
            "n_dropped": int(s["n_dropped"]),
            "n_bursts": int(n_bursts),
        }
    return [
        {"name": "table5/trace/span_coverage", "us_per_call": 0.0,
         "shards": 1,
         "derived": f"coverage={s['span_coverage']:.1%}"
                    f"_over_{s['n_finished']}_traces"
                    f"_{s['n_spans']}_spans"
                    f"_compile_spans={s['n_compile_spans']}"},
    ]


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--full", action="store_true",
                   help="the reference's full sizes (B = 1,024, 20 requests, ...)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    rows = run(quick=not args.full, device=args.device)
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
