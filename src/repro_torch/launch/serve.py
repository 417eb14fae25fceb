"""Serving launcher of the port:

    python -m repro_torch.launch.serve --arch ARCH --requests N \\
        --candidates C --micro-batch B [--fused-serve] \\
        [--shards N | --mesh DxM] \\
        [--table-dtype fp32|bf16|int8|fp8] [--hot-capacity K \\
        [--warm-capacity W --store-dir DIR] [--policy clock|lru] \\
        [--cold-deadline-ms T]] [--async-ingest [--queue-depth Q] \\
        [--max-staleness S]] [--rate-limit R [--rate-burst B]] \\
        [--max-concurrency K] [--trace [--trace-dir DIR] \\
        [--trace-slow-ms T]] [--profile [--profile-dir DIR]] \\
        [--device cuda|cpu]
    python -m repro_torch.launch.serve --arch LM_ARCH --tokens N [--sdim-kv] \
        [--device cuda|cpu]

Mirrors the recsys branch of ``repro/launch/serve.py``: the ``SMOKE``
config, random weights from a seeded ``torch.Generator``, a BSE + CTR
server pair in the decoupled deployment (an ``sdim`` model) or a CTR server
that scores raw histories inline (any other interest kind), and a loop over
synthetic requests (served one by one, or in micro-batches). The tiered
store, async ingest, admission control and tracing are ``CTRServer.build``'s
(``serve/``); at the end it prints the async-ingest stats, the tier sizes,
the admission summary, ``health_snapshot``, the metrics summary, the
trace report and, with ``--profile``, the measured roofline of the SDIM
engine's dispatches and the memory ledger of the BSE store
(``serve/profiler.py``; ``--profile-dir`` writes them as
``profile.json``, which ``tools/profile_report.py`` renders). ARCH is
any recsys id of ``configs.registry.ARCH_IDS`` (``wide-deep``, ``bst``,
``dien``, ``bert4rec``, ``sdim-paper``) or an LM id (below); as in the
reference,
``wide-deep`` (whose fields ``CTRServer`` does not take)
is scored by ``model.apply`` over the user's history broadcast to the
candidates, with field ids drawn from the request stream's generator.
Runs on the card unless ``--device cpu`` is given; without CUDA and
without that flag it fails.

``--shards N`` (or ``--mesh DxM``: a data axis of D and a model axis of M)
shards the BSE table store over the model axis (``ShardedTableStore``);
``--shards 1`` serves unsharded. One departure from the reference, which
refuses a mesh larger than its devices: the port places the shards
round-robin over the visible CUDA devices (the CPU under ``--device cpu``)
and prints the placement, so ``--shards 8`` runs the whole sharded path on
one card, as eight faked host devices do for the JAX package. It holds one
copy of each shard: the data axis is recorded, not replicated.

An LM arch (``granite-3-2b``, ``qwen3-8b``, ``command-r-plus-104b``,
``deepseek-moe-16b``, ``deepseek-v2-236b``) mirrors the reference's LM
branch: the ``SMOKE`` config with seeded random
weights decodes ``--tokens`` tokens greedily from a zero start token, with
an exact KV cache or, under ``--sdim-kv``, the SDIM bucket-compressed one,
and prints the last token id. As in the reference, the BSE-store, request-
path and profiling flags are refused for it.

``main`` is ``build`` (arguments, model, servers, profiler), ``run`` (the
synthetic requests, or the LM's decode loop) and ``report`` (the
printout); a caller that drives its own traffic, as ``chip_smoke.py`` does
at FULL, calls ``build`` with a config and ``report`` after it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.serve.quant import TABLE_DTYPES


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--candidates", type=int, default=128)
    p.add_argument("--micro-batch", type=int, default=1,
                   help="serve requests in bursts of this size: one "
                        "fetch_many + one scoring pass per burst")
    p.add_argument("--shards", type=int, default=1,
                   help="shard the BSE table store over this many shards, placed "
                        "round-robin over the visible devices (model-axis mesh)")
    p.add_argument("--mesh", default=None,
                   help='explicit mesh shape "DxM" (data x model); overrides --shards')
    p.add_argument("--fused-serve", action="store_true",
                   help="serve micro-batches through the fused "
                        "gather+dequant+query kernel")
    p.add_argument("--table-dtype", default="fp32", choices=sorted(TABLE_DTYPES),
                   help="BSE table STORAGE dtype (int8/fp8 quantize on write "
                        "with per-row scales)")
    p.add_argument("--hot-capacity", type=int, default=None,
                   help="tier the BSE store: at most this many users stay "
                        "device-resident; the rest demote to a host pool "
                        "(and to --store-dir segments)")
    p.add_argument("--store-dir", default=None,
                   help="cold-tier directory for spilled .npz segments "
                        "(enables the disk tier)")
    p.add_argument("--policy", default=None, choices=("clock", "lru"),
                   help="hot-tier eviction policy (default clock)")
    p.add_argument("--warm-capacity", type=int, default=None,
                   help="bound the host warm pool; overflow spills to "
                        "--store-dir")
    p.add_argument("--async-ingest", action="store_true",
                   help="run BSE ingestion off the request path: submits "
                        "enqueue onto a bounded queue drained by a writer "
                        "thread; reads serve the last committed version")
    p.add_argument("--queue-depth", type=int, default=1024,
                   help="async ingest queue bound; submits past it are "
                        "dropped and counted, never blocked on")
    p.add_argument("--max-staleness", type=int, default=64,
                   help="max un-folded entries per user before a submit "
                        "folds inline")
    p.add_argument("--rate-limit", type=float, default=None,
                   help="token-bucket admission: sustained requests/sec; "
                        "over-budget requests shed with an explicit None "
                        "score (counted)")
    p.add_argument("--rate-burst", type=float, default=None,
                   help="token-bucket burst headroom (defaults to "
                        "--rate-limit); needs --rate-limit")
    p.add_argument("--max-concurrency", type=int, default=None,
                   help="bound concurrent serving bursts; a burst arriving "
                        "at the bound sheds whole (explicit None scores)")
    p.add_argument("--cold-deadline-ms", type=float, default=None,
                   help="cold-tier circuit breaker deadline: cold reads "
                        "slower than this open the circuit and later cold "
                        "reads degrade to counted misses (needs the tiered "
                        "store)")
    p.add_argument("--trace", action="store_true",
                   help="per-request span tracing: prints the slowest-5 "
                        "trace breakdown at the end of the run")
    p.add_argument("--trace-dir", default=None,
                   help="write Chrome trace-event JSON to this directory as "
                        "trace.json (implies --trace)")
    p.add_argument("--trace-slow-ms", type=float, default=None,
                   help="always retain traces with root latency >= this "
                        "(ms) (implies --trace)")
    p.add_argument("--profile", action="store_true",
                   help="measured kernel profiling (serve/profiler.py): per-dispatch "
                        "time and analytical flops/bytes against the roofline, plus "
                        "the memory ledger of the BSE store; prints the measured "
                        "roofline at the end of the run")
    p.add_argument("--profile-dir", default=None,
                   help="write the profile as profile.json to this directory "
                        "(tools/profile_report.py renders it; implies --profile)")
    p.add_argument("--tokens", type=int, default=32, help="LM decode steps")
    p.add_argument("--sdim-kv", action="store_true",
                   help="LM: SDIM bucket-compressed KV decode")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p


def build_mesh(shards: int, mesh_spec: Optional[str] = None, err=None,
               device: Any = "cuda"):
    """``--mesh "DxM"`` ((data, model) axes) or ``--shards N`` ((model,)
    only) -> a ``MeshCtx`` whose model axis places its shards round-robin
    over the visible CUDA devices (the CPU for a CPU ``device``); ``None``
    when serving unsharded. Flag errors go through ``err`` (``parser.error``
    from ``build``) or raise ``SystemExit``, as in the reference."""
    from repro_torch.device import resolve_device
    from repro_torch.distributed.mesh_ctx import MeshCtx, place

    def fail(msg: str):
        if err is not None:
            err(msg)                       # parser.error raises SystemExit
        raise SystemExit(f"error: {msg}")

    if mesh_spec:
        try:
            dims = tuple(int(x) for x in mesh_spec.lower().split("x"))
        except ValueError:
            dims = ()
        if len(dims) != 2 or min(dims) < 1:
            fail(f'--mesh wants "DxM" (two positive ints, e.g. "2x4"), got {mesh_spec!r}')
        data, model = dims
    else:
        if shards < 1:
            fail(f"--shards must be a positive device count, got {shards}")
        if shards == 1:
            return None
        data, model = 1, shards
    dev = resolve_device(device)
    pool = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if dev.type == "cuda" else [dev])
    return MeshCtx(place(model, pool), data=data)


def _check(p: argparse.ArgumentParser, args, mode: str, tiered: bool) -> None:
    """The reference's argument checks (``repro/launch/serve.py``)."""
    if args.fused_serve and args.micro_batch < 2:
        p.error("--fused-serve rides the micro-batched path; give --micro-batch >= 2")
    if mode != "decoupled" and _profiling(args):
        p.error(f"--profile/--profile-dir wrap the SDIM engine dispatch sites, which "
                f"only the decoupled (sdim) deployment has; arch {args.arch!r} serves "
                f"{mode!r}")
    if mode != "decoupled":
        for on, flags in ((args.mesh or args.shards > 1, "--shards/--mesh shard"),
                          (args.table_dtype != "fp32" or args.fused_serve,
                           "--table-dtype/--fused-serve configure"),
                          (tiered, "--hot-capacity/--store-dir/--policy tier"),
                          (args.async_ingest, "--async-ingest decouples the write path of")):
            if on:
                p.error(f"{flags} the BSE table store, which only the decoupled (sdim) "
                        f"deployment has; arch {args.arch!r} serves {mode!r}")
    for name, v, lo in (("--queue-depth", args.queue_depth, 1),
                        ("--max-staleness", args.max_staleness, 1),
                        ("--max-concurrency", args.max_concurrency, 1),
                        ("--hot-capacity", args.hot_capacity, 1)):
        if v is not None and v < lo:
            p.error(f"{name} must be >= {lo}, got {v}")
    for name, v in (("--rate-limit", args.rate_limit), ("--rate-burst", args.rate_burst),
                    ("--cold-deadline-ms", args.cold_deadline_ms)):
        if v is not None and v <= 0:
            p.error(f"{name} must be > 0, got {v}")
    if args.rate_burst is not None and args.rate_limit is None:
        p.error("--rate-burst is token-bucket headroom over --rate-limit; "
                "give --rate-limit too")
    if args.cold_deadline_ms is not None and not tiered:
        p.error("--cold-deadline-ms arms the cold-tier circuit breaker, which needs "
                "the tiered store (give --hot-capacity/--store-dir/--policy/"
                "--warm-capacity)")
    if args.trace_slow_ms is not None and args.trace_slow_ms < 0:
        p.error(f"--trace-slow-ms must be >= 0, got {args.trace_slow_ms}")


def _check_family(p: argparse.ArgumentParser, args, family: str, tiered: bool) -> None:
    """The reference's refusals of the recsys-only flags for another
    family (``repro/launch/serve.py:204-263``)."""
    if family == "recsys":
        return
    tracing = args.trace or args.trace_dir is not None or args.trace_slow_ms is not None
    for on, msg in (
            (args.mesh or args.shards > 1, "--shards/--mesh shard the BSE table store"),
            (tiered, "--hot-capacity/--store-dir/--policy tier the BSE table store"),
            (args.table_dtype != "fp32" or args.fused_serve,
             "--table-dtype/--fused-serve configure the BSE table store"),
            (args.async_ingest, "--async-ingest decouples the BSE write path"),
            (args.rate_limit is not None or args.max_concurrency is not None
             or args.cold_deadline_ms is not None,
             "--rate-limit/--max-concurrency/--cold-deadline-ms harden the CTR request path"),
            (tracing, "--trace/--trace-dir/--trace-slow-ms trace the CTR request path"),
            (_profiling(args), "--profile/--profile-dir profile the SDIM serving kernels")):
        if on:
            p.error(f"{msg} (recsys serving only); arch {args.arch!r} is family {family!r}")
    if args.tokens < 1:
        p.error(f"--tokens must be >= 1, got {args.tokens}")


def _profiling(args) -> bool:
    return args.profile or args.profile_dir is not None


@torch.no_grad()
def _score_fields(model, req, sparse_ids: np.ndarray, device) -> np.ndarray:
    """wide_deep's scores of one request: ``model.apply`` over the user's
    history broadcast to the C candidates, with their field ids."""
    _, user, ci, cc, ctx = req
    C = len(ci)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=device)
    batch = {k: t(np.broadcast_to(v, (C, v.shape[-1]))) for k, v in user.items()}
    batch.update(cand_item=t(ci), cand_cat=t(cc), ctx=t(ctx), sparse_ids=t(sparse_ids))
    return model.apply(batch).cpu().numpy()


@dataclasses.dataclass
class Launch:
    """What ``build`` made of the arguments."""

    args: argparse.Namespace
    cfg: Any
    mode: str
    tiered: bool
    device: torch.device
    model: Any
    server: Any
    tracer: Any = None
    profiler: Any = None
    ledger: Any = None


def build(argv=None, cfg=None) -> Launch:
    """Parse ``argv`` and build the model (seeded random weights) and the
    servers on the device, with the profiler and the ledger attached under
    ``--profile``; async ingest is started. ``cfg`` replaces the arch's
    ``SMOKE`` config."""
    from repro_torch.device import resolve_device
    from repro_torch.models.ctr import CTRModel
    from repro_torch.serve.ctr_server import CTRServer
    from repro_torch.serve.profiler import KernelProfiler, MemoryLedger
    from repro_torch.serve.tiered_store import is_tiered
    from repro_torch.serve.tracing import Tracer

    p = _parser()
    args = p.parse_args(argv)
    mod = registry.get(args.arch)
    cfg = mod.SMOKE if cfg is None else cfg
    tiered = is_tiered(args.hot_capacity, args.store_dir, args.policy, args.warm_capacity)
    _check_family(p, args, mod.FAMILY, tiered)
    if mod.FAMILY == "lm":
        from repro_torch.models.lm import LMModel

        device = resolve_device(args.device)
        model = LMModel(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(0))
        print(f"{args.arch} [lm] {cfg.name} on {device}")
        return Launch(args, cfg, "lm", False, device, model, None)
    mode = "decoupled" if cfg.interest.kind == "sdim" else "inline"
    tracing = args.trace or args.trace_dir is not None or args.trace_slow_ms is not None
    _check(p, args, mode, tiered)
    device = resolve_device(args.device)
    mesh = (build_mesh(args.shards, args.mesh, err=p.error, device=device)
            if mode == "decoupled" else None)
    gen = torch.Generator(device=device).manual_seed(0)
    model = CTRModel(cfg, device=device, generator=gen)
    tracer = Tracer(slow_ms=args.trace_slow_ms) if tracing else None
    server = CTRServer.build(
        model, None, mode, mesh=mesh, hot_capacity=args.hot_capacity, store_dir=args.store_dir,
        policy=args.policy, warm_capacity=args.warm_capacity,
        table_dtype=args.table_dtype, fused=args.fused_serve,
        async_ingest=args.async_ingest, queue_depth=args.queue_depth,
        max_staleness=args.max_staleness, max_concurrency=args.max_concurrency,
        rate_limit=args.rate_limit, rate_burst=args.rate_burst,
        cold_deadline_s=None if args.cold_deadline_ms is None else args.cold_deadline_ms / 1e3,
        tracer=tracer, device=device)
    launch = Launch(args, cfg, mode, tiered, device, model, server, tracer)
    if _profiling(args):
        launch.profiler = KernelProfiler(metrics=server.metrics, tracer=tracer)
        launch.profiler.attach(server.bse.engine)
        launch.ledger = MemoryLedger(metrics=server.metrics)
        launch.ledger.attach(server.bse.store)
    if args.async_ingest:
        server.bse.async_ingest.start()
    print(f"SDIM engine on {device}"
          f"{' (' + torch.cuda.get_device_name(device) + ')' if device.type == 'cuda' else ''}")
    if mesh is not None:
        print(f"BSE table store sharded over {mesh.n_shards} shards (mesh {mesh.shape}) on "
              f"{mesh.n_devices} device(s): "
              + ", ".join(f"shard {k} -> {d}" for k, d in enumerate(mesh.devices)))
    return launch


def run(launch: Launch) -> None:
    """Serve ``--requests`` synthetic requests of ``--candidates`` each,
    one by one or in micro-batches, printing each one's top candidate; for
    an LM arch, decode (``decode``)."""
    from repro_torch.data.synthetic import SyntheticCTRConfig, generate_batch

    if launch.mode == "lm":
        decode(launch)
        return
    args, cfg, server = launch.args, launch.cfg, launch.server
    dcfg = SyntheticCTRConfig(hist_len=cfg.long_len, n_items=cfg.n_items,
                              n_cats=cfg.n_cats)
    rng = np.random.default_rng(0)
    pending = []  # micro-batch buffer of (req_id, request tuple)

    def show(r, scores):
        if scores is None:          # shed by admission control, counted
            print(f"req {r}: SHED (admission control)")
        else:
            print(f"req {r}: top candidate {int(np.argmax(scores))} "
                  f"(score {float(np.max(scores)):+.3f})")

    def flush():
        for (r, _), scores in zip(pending, server.handle_requests([q for _, q in pending])):
            show(r, scores)
        pending.clear()

    for r in range(args.requests):
        raw = generate_batch(dcfg, 1, r)
        user = {k: v for k, v in raw.items() if k.startswith("hist")}
        ci = rng.integers(0, cfg.n_items, args.candidates).astype(np.int32)
        cc = rng.integers(0, cfg.n_cats, args.candidates).astype(np.int32)
        req = (f"u{r}", user, ci, cc, np.zeros((args.candidates, cfg.ctx_dim), np.float32))
        if cfg.arch == "wide_deep":
            sids = rng.integers(0, cfg.field_vocab,
                                (args.candidates, cfg.n_sparse)).astype(np.int32)
            show(r, _score_fields(launch.model, req, sids, launch.device))
            continue
        if args.micro_batch > 1:
            pending.append((r, req))
            if len(pending) == args.micro_batch:
                flush()
            continue
        show(r, server.handle_request(*req))
    if pending:
        flush()


@torch.no_grad()
def decode(launch: Launch) -> int:
    """The LM branch of the reference (``repro/launch/serve.py:461-481``):
    ``--tokens`` greedy steps from a zero start token against an exact fp32
    KV cache (``--tokens + 1`` rows) or, under ``--sdim-kv``, the SDIM
    bucket tables; prints and returns the last token id."""
    args, model = launch.args, launch.model
    tok = torch.zeros((1, 1), dtype=torch.int32, device=launch.device)
    if args.sdim_kv:
        cache = model.init_sdim_cache(1)
        for _ in range(args.tokens):
            logits, cache = model.sdim_decode_step(tok, cache)
            tok = torch.argmax(logits, -1).to(torch.int32)
    else:
        cache = model.init_cache(1, args.tokens + 1, torch.float32)
        for i in range(args.tokens):
            logits, cache = model.decode_step(tok, cache, i)
            tok = torch.argmax(logits, -1).to(torch.int32)
    last = int(tok[0, 0])
    print(f"decoded {args.tokens} tokens "
          f"({'SDIM-compressed' if args.sdim_kv else 'exact'} KV); last token id {last}")
    return last


def report(launch: Launch) -> Optional[dict]:
    """Stop async ingest (flushing it), then print its stats, ms/request,
    the tiers, admission, health, metrics, the trace report and, under
    ``--profile``, the measured roofline and the ledger (a ledger mismatch
    is printed, not raised); with ``--profile-dir`` write ``profile.json``.
    Returns the profile (``{"per_kernel": ..., "mem": ...}``) or None."""
    from repro_torch.serve.health import health_snapshot

    if launch.mode == "lm":
        return None
    args, server, tracer = launch.args, launch.server, launch.tracer
    mode, tiered = launch.mode, launch.tiered
    bse = server.bse
    if bse is not None and bse.async_ingest is not None:
        bse.async_ingest.stop(flush=True)          # quiesce before reporting
        ist = bse.async_ingest.stats
        print(f"async ingest: {ist.n_enqueued} enqueued, "
              f"{ist.n_events_folded + ist.n_histories_folded} folded "
              f"in {ist.n_folds} drains (max batch {ist.max_drain_batch}, "
              f"max queue {ist.max_queue_depth}), {ist.n_dropped} dropped, "
              f"staleness p95 {ist.staleness_p95():.1f}")
    if bse is not None:
        print(f"{server.stats.ms_per_request:.1f} ms/request"
              f"{' (fused serve)' if args.fused_serve else ''} ({mode}); "
              f"table {bse.table_bytes()} B ({args.table_dtype} storage)")
        if bse.store.sharded:
            hot = bse.store.hot if tiered else bse.store
            print(f"sharded store: {hot.n_shards} shards of {hot.per_shard_capacity} slots, "
                  f"users per shard {hot.shard_load()}")
        if tiered:
            ts = bse.store.stats
            print(f"tiered store {bse.store.tier_sizes()} "
                  f"(hot cap {bse.store.hot_capacity}, policy {bse.store.policy.name}): "
                  f"hit-rate {ts.hit_rate:.2f}, promote {ts.promote_bytes} B, "
                  f"demote {ts.demote_bytes} B"
                  + (f", degraded {ts.n_degraded}" if ts.n_degraded else ""))
    else:
        print(f"{server.stats.ms_per_request:.1f} ms/request ({mode})")
    if server.admission is not None:
        ast = server.admission.stats
        print(f"admission: {ast.n_admitted} admitted, {ast.n_shed} shed of "
              f"{ast.n_offered} offered (rate {args.rate_limit or 'off'}/s, "
              f"concurrency {args.max_concurrency or 'unbounded'})")
    h = health_snapshot(server)
    print(f"health: live={h['live']} ready={h['ready']} ["
          + " ".join(f"{name}:{'ok' if c['ok'] else 'FAIL'}"
                     for name, c in sorted(h["checks"].items())) + "]")
    snap = server.metrics.snapshot()
    req = snap["histograms"].get("ctr.request_ms")
    if req and req["count"]:
        print(f"metrics: ctr.request_ms p50/p95/p99 "
              f"{req['p50']:.2f}/{req['p95']:.2f}/{req['p99']:.2f} ms (n={req['count']})")
    if snap["counters"]:
        print("counters: " + ", ".join(f"{k}={v}" for k, v in sorted(snap["counters"].items())))
    if tracer is not None:
        print(tracer.report(5))
        if args.trace_dir is not None:
            os.makedirs(args.trace_dir, exist_ok=True)
            out = tracer.save_chrome_trace(os.path.join(args.trace_dir, "trace.json"))
            print(f"chrome trace written to {out} (load in Perfetto / chrome://tracing)")
    if launch.profiler is None:
        return None
    print(launch.profiler.roofline_report())
    print(launch.ledger.report())
    errs = launch.ledger.verify()
    if errs:   # surfaced, not raised: a broken ledger must not mask the serve output
        print("memory ledger MISMATCH: " + "; ".join(errs))
    profile = {"per_kernel": launch.profiler.to_dict(), "mem": launch.ledger.snapshot()}
    if args.profile_dir is not None:
        os.makedirs(args.profile_dir, exist_ok=True)
        out = os.path.join(args.profile_dir, "profile.json")
        with open(out, "w") as f:
            json.dump(profile, f, indent=2)
        print(f"profile written to {out} (render with tools/profile_report.py)")
    return profile


def main(argv=None):
    launch = build(argv)
    run(launch)
    report(launch)


if __name__ == "__main__":
    main()
