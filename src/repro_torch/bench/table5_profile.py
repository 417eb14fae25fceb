"""Where a Table 5 request's time goes, deployment by deployment:

    python -m repro_torch.bench.table5_profile [--requests N] [--T 2000] [--B 1024]
                                               [--device cpu] [--out PATH]

For each deployment of ``table5_serving.ablation_rows`` (decoupled,
inline, target attention; one user of T behaviors scoring B candidates a
request) on the run's device:

1. N requests timed one by one: ms/request, median and mean;
2. N requests under ``torch.profiler`` (CPU and CUDA activities): the
   device time a request, split by device operation (the five largest),
   and the card's busy share of the window (the union of the device
   operations' intervals over the window's wall time). "not measured"
   where the profiler recorded no device time (always on the CPU);
3. N requests under ``cProfile``: the Python calls a request and the
   eight functions with the most own time.

Prints one JSON object and writes it to ``--out`` (default
``results/torch/table5_profile.json``).
"""
from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import time

import numpy as np
import torch

from repro_torch.bench.table5_serving import RESULTS_DIR, ablation_server
from repro_torch.device import DeviceLike, resolve_device

DEPLOYMENTS = (("decoupled", "sdim"), ("inline", "sdim"), ("target_attention", "target"))


def _wait(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_window(fn, n: int, dev: torch.device) -> dict:
    """``fn`` n times under torch.profiler: device ms a call (the device
    operations' summed durations), the busy share of the window and the
    five device operations that took the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        _wait(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start)
    if not spans:
        return {"device_ms_per_request": "not measured", "busy_share": "not measured",
                "wall_ms_per_request": wall_us / 1e3 / n}
    busy, end, by_name = 0.0, float("-inf"), {}
    for a, b, name in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"device_ms_per_request": sum(by_name.values()) / 1e3 / n,
            "busy_share": busy / wall_us,
            "device_ops_per_request": len(spans) / n,
            "wall_ms_per_request": wall_us / 1e3 / n,
            "top_device_ms_per_request": {name[:80]: us / 1e3 / n for name, us in top}}


def host_profile(fn, n: int, dev: torch.device) -> dict:
    """``fn`` n times under cProfile: Python calls a request and the eight
    functions with the most own time (ms a request)."""
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(n):
        fn()
    _wait(dev)
    prof.disable()
    stats = pstats.Stats(prof)
    calls = sum(v[1] for v in stats.stats.values())
    own = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:8]
    return {"python_calls_per_request": calls / n,
            "top_own_ms_per_request": {f"{os.path.basename(f)}:{line}:{name}": 1e3 * v[2] / n
                                       for (f, line, name), v in own}}


@torch.no_grad()
def run(device: DeviceLike = "cuda", T: int = 2000, B: int = 1024, n_req: int = 40) -> dict:
    dev = resolve_device(device)
    out = {"device": str(dev), "T": T, "B": B, "requests": n_req}
    for mode, kind in DEPLOYMENTS:
        server, request = ablation_server(mode, kind, dev, T, B)
        fn = lambda: server.handle_request(*request)
        fn()                                            # warm (kernel build + encode)
        _wait(dev)
        ms = []
        for _ in range(n_req):
            t0 = time.perf_counter()
            scores = fn()
            _wait(dev)
            ms.append(1e3 * (time.perf_counter() - t0))
        assert np.isfinite(scores).all(), f"{mode}: scores not finite"
        out[mode] = {"ms_per_request_median": float(np.median(ms)),
                     "ms_per_request_mean": float(np.mean(ms)),
                     **device_window(fn, n_req, dev), **host_profile(fn, n_req, dev)}
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--requests", type=int, default=40)
    p.add_argument("--T", type=int, default=2000)
    p.add_argument("--B", type=int, default=1024)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", default=os.path.join(RESULTS_DIR, "table5_profile.json"))
    args = p.parse_args(argv)
    out = run(args.device, args.T, args.B, args.requests)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
