#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU (written for the H100):

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails:

1. card  — CUDA must be available; prints the card's name and power limit.
2. build — compiles every ``src/repro_torch/kernels/*/csrc/*.cu`` with nvcc
   for sm_90a (one process per source, in parallel) into one library.
3. kernels — each of the four kernels against its plain PyTorch version on
   the card at the full width of ``sdim-paper`` (d=128, m=48, tau=3,
   L=1024, C=128, E=16), on margin-screened inputs, at B=32 and at every
   shape the main path gives it (history encode, query and fused serve
   of a 16-request burst; the encode and update of a 32-user event
   burst); times of kernel and plain version at the main path's shapes
   (CUDA events, median of 30 after 3 warm-up calls) and the bound from
   the bytes and FLOP this run's data needs.
4. main path — ``sdim-paper`` FULL (10M x 64 item table) with random
   weights from a seeded generator, served through ``CTRServer.
   handle_requests``: 64 requests of 128 candidates in bursts of 16,
   unfused (fetch_many + sdim_query), fused (sdim_fused_serve) and fused
   off an int8 store; then an ingest_events burst (sdim_update) and the
   same requests again. Scores must be finite, fused and unfused must
   agree within the bf16 wire tolerance, and every kernel's launch count
   (reset to 0 before this phase) must have risen.

Prints the kernels' JSON line, then as the last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from functools import partial

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
B, L, C, D, M, TAU, E = 32, 1024, 128, 128, 48, 3, 16
BURST, EV_USERS = 16, 32      # main path: requests per burst, users per event burst
G, U = M // TAU, 1 << TAU
FP32 = dict(atol=1e-5, rtol=1e-5)
ATOMIC = dict(atol=1e-4, rtol=1e-5)   # global atomics add in any order
WIRE_TOL = 5e-2                       # fused vs unfused: bf16 wire tables


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_close(name, out, ref, atol, rtol) -> float:
    import torch
    err = (out.float() - ref.float()).abs()
    limit = atol + rtol * ref.float().abs()
    if not bool(torch.isfinite(out).all()) or bool((err > limit).any()):
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {float(err.max()):.3g}, atol {atol}, rtol {rtol})")
    return float(err.max())


def kernel_phase(torch, dev):
    from repro_torch.kernels.screen import screened_normal
    from repro_torch.kernels.sdim_bucket.sdim_bucket import bse_encode, bse_encode_ref
    from repro_torch.kernels.sdim_fused_serve.sdim_fused_serve import (
        sdim_fused_serve, sdim_fused_serve_ref)
    from repro_torch.kernels.sdim_query.sdim_query import sdim_query, sdim_query_ref
    from repro_torch.kernels.sdim_update.sdim_update import sdim_update, sdim_update_ref
    from repro_torch.serve.quant import quantize_rows

    rng = np.random.default_rng(0)
    Rn = rng.standard_normal((M, D)).astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    R = t(Rn)

    def history(b, l, dtype=torch.float32):
        """Margin-screened behaviors (b, l, D) with front-padded ragged masks."""
        seq = t(screened_normal(rng, (b, l, D), Rn, dtype)).to(dtype)
        lengths = rng.integers(l // 4, l + 1, b)
        return seq, t((np.arange(l)[None] >= (l - lengths[:, None])).astype(np.float32))

    rows = []
    hash_flop = 2 * M * D + G * D          # per hashed row: projection + bucket add

    # bse_encode at B=32 (fp32, bf16), at the main path's history burst
    # (BURST users, L behaviors, L split over blocks) and at its int8 event
    # fold (EV_USERS users, E events: one block per user); timed at the burst.
    err = 0.0
    for b, l, dtype in ((B, L, torch.float32), (B, L, torch.bfloat16),
                        (EV_USERS, E, torch.float32), (BURST, L, torch.float32)):
        seq, mask = history(b, l, dtype)
        err = max(err, check_close(f"bse_encode {(b, l, D)} {dtype}",
                                   bse_encode(seq, mask, R, TAU),
                                   bse_encode_ref(seq, mask, R, TAU), **ATOMIC))
    valid = float(mask.sum())               # only valid rows need reading and hashing
    rows.append(("bse_encode", "src/repro_torch/kernels/sdim_bucket/csrc/bse_encode.cu",
                 "src/repro/kernels/sdim_bucket/sdim_bucket.py:117", err,
                 partial(bse_encode, seq, mask, R, TAU),
                 partial(bse_encode_ref, seq, mask, R, TAU),
                 bound(valid * D * 4 + mask.numel() * 4 + R.numel() * 4
                       + BURST * G * U * D * 4, valid * hash_flop)))

    # sdim_query (unfused decoupled path: bf16 wire tables) at B=32 and at
    # the main path's burst; timed at the burst
    err = 0.0
    for b in (B, BURST):
        table = bse_encode_ref(*history(b, L), R, TAU)
        wire = table.to(torch.bfloat16)
        q = t(screened_normal(rng, (b, C, D), Rn))
        for tb in (wire, table):
            err = max(err, check_close(f"sdim_query {(b, C, D)} {tb.dtype}",
                                       sdim_query(q, tb, R, TAU),
                                       sdim_query_ref(q, tb, R, TAU), **FP32))
    query_flop = BURST * C * hash_flop + BURST * G * U * 3 * D
    rows.append(("sdim_query", "src/repro_torch/kernels/sdim_query/csrc/sdim_query.cu",
                 "src/repro/kernels/sdim_query/sdim_query.py:52", err,
                 partial(sdim_query, q, wire, R, TAU),
                 partial(sdim_query_ref, q, wire, R, TAU),
                 bound(wire.numel() * 2 + 2 * q.numel() * 4 + R.numel() * 4, query_flop)))

    # sdim_fused_serve (fused path): fp32 / bf16 / int8 stores at B=32 with a
    # ragged present; fp32 / int8 at the main path's burst, every user
    # present; timed at the burst on the fp32 store
    errs = {}
    for b, ragged in ((B, True), (BURST, False)):
        table = bse_encode_ref(*history(b, L), R, TAU)
        q = t(screened_normal(rng, (b, C, D), Rn))
        store = torch.cat([table, torch.zeros_like(table)])
        slots = torch.randperm(2 * b, generator=torch.Generator().manual_seed(b))[:b].to(
            dev, torch.int32)
        present = torch.ones(b, device=dev)
        if ragged:
            present[3::4] = 0
        stores = [("fp32", store, None), ("int8", *quantize_rows(store, dtype=torch.int8))]
        if ragged:
            stores.insert(1, ("bf16", store.to(torch.bfloat16), None))
        for name, st, sc in stores:
            errs[name] = max(errs.get(name, 0.0), check_close(
                f"sdim_fused_serve {(b, C, D)} {name}",
                sdim_fused_serve(st, slots, q, R, TAU, scales=sc, present=present),
                sdim_fused_serve_ref(st, slots, q, R, TAU, scales=sc, present=present),
                **FP32))
    print(f"sdim_fused_serve max abs err by store dtype: {json.dumps(errs)}")
    n_present = int(present.sum())          # an absent user needs only its zero write
    rows.append(("sdim_fused_serve",
                 "src/repro_torch/kernels/sdim_fused_serve/csrc/sdim_fused_serve.cu",
                 "src/repro/kernels/sdim_fused_serve/sdim_fused_serve.py:86", max(errs.values()),
                 partial(sdim_fused_serve, store, slots, q, R, TAU, present=present),
                 partial(sdim_fused_serve_ref, store, slots, q, R, TAU, present=present),
                 bound(n_present * (G * U * D * 4 + C * D * 4) + q.numel() * 4
                       + R.numel() * 4 + BURST * 8,
                       n_present * C * hash_flop + n_present * G * U * 3 * D)))

    # sdim_update (event ingest, the main path's EV_USERS x E burst):
    # duplicate slots, a zero-mask row at slot 0
    events = t(screened_normal(rng, (EV_USERS, E, D), Rn))
    ev_mask = t((rng.random((EV_USERS, E)) > 0.2).astype(np.float32))
    ev_mask[0] = 0
    ev_slots = torch.tensor(np.r_[0, rng.integers(1, EV_USERS // 2, EV_USERS - 1)],
                            dtype=torch.int32, device=dev)
    base = torch.randn((2 * EV_USERS, G, U, D), device=dev)
    a, b = base.clone(), base.clone()
    sdim_update(a, ev_slots, events, ev_mask, R, TAU)
    sdim_update_ref(b, ev_slots, events, ev_mask, R, TAU)
    err = check_close("sdim_update", a, b, **ATOMIC)
    if not torch.equal(a[0], base[0]):
        raise AssertionError("sdim_update: a zero-mask row at slot 0 wrote to slot 0")
    touched = len(set(ev_slots[ev_mask.sum(1) > 0].tolist()))
    ev_valid = float(ev_mask.sum())
    rows.append(("sdim_update", "src/repro_torch/kernels/sdim_update/csrc/sdim_update.cu",
                 "src/repro/kernels/sdim_update/sdim_update.py:77", err,
                 partial(sdim_update, a, ev_slots, events, ev_mask, R, TAU),
                 partial(sdim_update_ref, b, ev_slots, events, ev_mask, R, TAU),
                 bound(2 * touched * G * U * D * 4 + ev_valid * D * 4 + ev_mask.numel() * 4
                       + EV_USERS * 4 + R.numel() * 4, ev_valid * hash_flop)))

    timed = []
    for name, source, replaces, err, kernel, plain, (bound_ms, bound_by) in rows:
        # kernel, plain, plain, kernel: both seen under the same clocks
        k1, p1, p2, k2 = time_ms(kernel), time_ms(plain), time_ms(plain), time_ms(kernel)
        timed.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                          max_abs_err=err, ms=min(k1, k2), plain_ms=min(p1, p2),
                          bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
        print(f"kernel {name}: {min(k1, k2):.4f} ms (runs {k1:.4f}/{k2:.4f}), plain "
              f"{min(p1, p2):.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"max abs err {err:.3g}")
    return timed


def request_stream(n_requests: int, cfg):
    from repro_torch.data.synthetic import SyntheticCTRConfig, generate_batch

    dcfg = SyntheticCTRConfig(hist_len=cfg.long_len, n_items=cfg.n_items, n_cats=cfg.n_cats)
    rng = np.random.default_rng(0)
    out = []
    for r in range(n_requests):
        raw = generate_batch(dcfg, 1, r)
        user = {k: v for k, v in raw.items() if k.startswith("hist")}
        ci = rng.integers(0, cfg.n_items, C).astype(np.int32)
        cc = rng.integers(0, cfg.n_cats, C).astype(np.int32)
        out.append((f"u{r}", user, ci, cc, np.zeros((C, cfg.ctx_dim), np.float32)))
    return out


def main_path_phase(torch, dev, wrappers):
    from repro_torch.configs import sdim_paper
    from repro_torch.models.ctr import CTRModel
    from repro_torch.serve.ctr_server import CTRServer

    cfg = sdim_paper.FULL
    t0 = time.perf_counter()
    model = CTRModel(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    print(f"model init: {time.perf_counter() - t0:.2f} s "
          f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters)")
    servers = {
        "unfused": CTRServer.build(model, None, "decoupled", device=dev),
        "fused": CTRServer.build(model, None, "decoupled", fused=True, device=dev),
        "fused-int8": CTRServer.build(model, None, "decoupled", fused=True,
                                      table_dtype="int8", device=dev),
    }
    requests = request_stream(64, cfg)
    ev_rng = np.random.default_rng(1)
    ev_users = [f"u{u}" for u in ev_rng.integers(0, len(requests), EV_USERS)]
    ev_items = ev_rng.integers(0, cfg.n_items, (EV_USERS, E)).astype(np.int32)
    ev_cats = ev_rng.integers(0, cfg.n_cats, (EV_USERS, E)).astype(np.int32)

    for w in wrappers:
        w.launches = 0
    scores, per_burst = {}, {}
    for rnd in ("before events", "after events"):
        if rnd == "after events":
            for srv in servers.values():
                srv.bse.ingest_events(ev_users, ev_items, ev_cats)
        for name, srv in servers.items():
            before = {w.__name__: w.launches for w in wrappers}
            srv.stats = type(srv.stats)()
            out = []
            for i in range(0, len(requests), BURST):
                out.extend(srv.handle_requests(requests[i:i + BURST]))
            torch.cuda.synchronize()
            scores[(rnd, name)] = np.stack(out)
            per_burst[(rnd, name)] = {w.__name__: (w.launches - before[w.__name__])
                                      / (len(requests) // BURST) for w in wrappers}
            print(f"serve {name} ({rnd}): {srv.stats.ms_per_request:.3f} ms/request over "
                  f"{srv.stats.n_requests} requests, launches per {BURST}-request burst "
                  f"{json.dumps(per_burst[(rnd, name)])}")
    launches = {w.__name__: w.launches for w in wrappers}

    for key, s in scores.items():
        if s.shape != (len(requests), C) or not np.isfinite(s).all():
            raise AssertionError(f"scores {key}: shape {s.shape}, finite {np.isfinite(s).all()}")
    for rnd in ("before events", "after events"):
        for name in ("fused", "fused-int8"):
            diff = float(np.abs(scores[(rnd, name)] - scores[(rnd, "unfused")]).max())
            print(f"|{name} - unfused| max ({rnd}): {diff:.3g}")
            if diff > WIRE_TOL:
                raise AssertionError(f"{name} vs unfused scores differ by {diff} ({rnd})")
    moved = float(np.abs(scores[("after events", "fused")]
                         - scores[("before events", "fused")]).max())
    if moved == 0.0:
        raise AssertionError("the event burst changed no score")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    print(f"main path launches: {json.dumps(launches)}")
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found next to this script", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing was run",
              file=sys.stderr)
        return 3
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False    # plain versions hash in IEEE fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from repro_torch.kernels import _build
    from repro_torch.kernels.sdim_bucket.sdim_bucket import bse_encode
    from repro_torch.kernels.sdim_fused_serve.sdim_fused_serve import sdim_fused_serve
    from repro_torch.kernels.sdim_query.sdim_query import sdim_query
    from repro_torch.kernels.sdim_update.sdim_update import sdim_update

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(lib, ROOT)}")
    for line in (lib.parent / "nvcc.log").read_text().splitlines():
        if "Used" in line or line.startswith("=="):
            print("  " + line.strip())

    timed = kernel_phase(torch, dev)
    wrappers = (bse_encode, sdim_update, sdim_fused_serve, sdim_query)
    launches = main_path_phase(torch, dev, wrappers)
    for k in timed:
        k["launches"] = launches[k["name"]]
    print(card)
    print(json.dumps({"kernels": timed}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
