"""Table 4 — τ sweep on the port:

    python -m repro_torch.bench.table4_tau [--smoke | --full] [--device cpu]

Counterpart of ``benchmarks/table4_tau.py``. τ controls attention
sharpness (entropy strictly ↓ in τ, Appendix A): τ=1 admits too much
noise, τ=10 attends only near-duplicates. Paper: best at 2 ≤ τ ≤ 5 (they
deploy τ=3). Each τ trains ``sdim`` through ``bench.common.train_and_eval``
(m the largest multiple of τ up to 48): on the card every τ trains
through the SDIM kernels (τ = 5 and 10 through their large-τ paths,
``kernels/sdim_bucket/csrc/large_tau.cuh``).
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.bench.common import train_and_eval
from repro_torch.device import DeviceLike, resolve_device

TAUS = [1, 2, 3, 5, 10]


def run(quick: bool = True, smoke: bool = False, device: DeviceLike = "cuda"):
    """``smoke``: pipeline-proof depth only (AUCs not meaningful)."""
    dev = resolve_device(device)
    steps = (60 if smoke else 400) if quick else 1500
    rows = []
    aucs = {}
    for tau in TAUS:
        m = 48 if 48 % tau == 0 else tau * (48 // tau)
        r = train_and_eval("sdim", steps=steps, batch=128,
                           eval_examples=1024 if smoke else 4096,
                           lr=5e-3, device=dev, m=m, tau=tau)
        aucs[tau] = r["auc"]
        # entropy of the expected attention kernel at this tau (Appendix A)
        cos = np.clip(np.random.default_rng(0).uniform(-0.9, 0.9, 512), -1, 1)
        w = (1 - np.arccos(cos) / np.pi) ** tau
        w = w / w.sum()
        ent = float(-(w * np.log(w + 1e-30)).sum())
        rows.append({"name": f"table4/tau{tau}", "us_per_call": r["us_per_step"],
                     "derived": f"auc={r['auc']};kernel_entropy={ent:.3f}"})
    best = max(aucs, key=aucs.get)
    rows.append({"name": "table4/best_tau", "us_per_call": 0.0,
                 "derived": f"best_tau={best}_(paper:2..5)"})
    return rows


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    depth = p.add_mutually_exclusive_group()
    depth.add_argument("--smoke", action="store_true", help="60 steps, 1,024 eval examples")
    depth.add_argument("--full", action="store_true", help="1,500 steps")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    rows = run(quick=not args.full, smoke=args.smoke, device=args.device)
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
