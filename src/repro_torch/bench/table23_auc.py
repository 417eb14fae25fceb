"""Tables 2/3 — AUC of SDIM against the baselines on planted-structure
data, on the port:

    python -m repro_torch.bench.table23_auc [--smoke | --full] [--device cpu]

Counterpart of ``benchmarks/table23_auc.py``: all models share the
embeddings, the short-term module and the head, and differ only in the
long-term interest module (the paper's setup). Expected ordering (paper
Table 2/3):

    DIN(short-only) < Avg-Pool < SIM(hard) ≈ UBR4CTR ≈ ETA < SDIM ≈ DIN(Long)

Depths: ``quick`` (the default) 600 steps and 4,096 eval examples;
``--full`` 2,000 and 16,384; ``--smoke`` 60 and 1,024 (proves the pipeline
runs; its AUCs mean nothing). Batch 128, L = 256, lr 5e-3, as the JAX
script. Prints one JSON row per kind and per derived claim on stdout;
writes no file.

``sdim_expected`` trains on non-finite gradients from its first step, in
the JAX package as here (ROADMAP.md §C, C2): its row says at which step.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.bench.common import train_and_eval
from repro_torch.device import DeviceLike

BASELINES = [
    ("none", {}),            # DIN (short-term only)
    ("avg", {}),             # DIN(Avg-Pooling long)
    ("sim_hard", {"top_k": 16}),
    ("ubr4ctr", {"top_k": 16}),
    ("eta", {"top_k": 16}),
    ("sdim", {"m": 48, "tau": 3}),
    ("sdim_expected", {}),   # m -> inf limit (Eq. 14)
    ("target", {}),          # DIN(Long Seq.) oracle
]
RETRIEVAL = ("sim_hard", "eta", "ubr4ctr")


def run(quick: bool = True, smoke: bool = False, device: DeviceLike = "cuda") -> list:
    """One row per kind ({"name", "us_per_call", "derived", "auc",
    "first_nonfinite_step"}), then the paper's two claims as derived rows."""
    steps = (60 if smoke else 600) if quick else 2000
    eval_examples = 1024 if smoke else (4096 if quick else 16384)
    rows, aucs = [], {}
    for kind, kw in BASELINES:
        r = train_and_eval(kind, steps=steps, batch=128, eval_examples=eval_examples,
                           lr=5e-3, device=device, **kw)
        aucs[kind] = r["auc"]
        rows.append({
            "name": f"table23/{kind}",
            "us_per_call": r["us_per_step"],
            "derived": f"auc={r['auc']}",
            "auc": r["auc"],
            "first_nonfinite_step": r["first_nonfinite"],
        })
    rows.append({
        "name": "table23/claim_sdim_matches_din_long",
        "us_per_call": 0.0,
        "derived": f"sdim-target_auc_gap={aucs['sdim'] - aucs['target']:+.4f}",
    })
    rows.append({
        "name": "table23/claim_sdim_beats_retrieval",
        "us_per_call": 0.0,
        "derived": (f"sdim_vs_best_retrieval="
                    f"{aucs['sdim'] - max(aucs[k] for k in RETRIEVAL):+.4f}"),
    })
    return rows


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    depth = p.add_mutually_exclusive_group()
    depth.add_argument("--smoke", action="store_true", help="60 steps, 1,024 eval examples")
    depth.add_argument("--full", action="store_true", help="2,000 steps, 16,384 eval examples")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    rows = run(quick=not args.full, smoke=args.smoke, device=args.device)
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
