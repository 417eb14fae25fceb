"""Benchmark harness of the port — one module per paper table/figure.

Usage:
    python -m repro_torch.bench.run [--full|--smoke] [--only table1,...] [--device cpu]

Counterpart of ``benchmarks/run.py``. ``--smoke`` runs EVERY module at
pipeline-proof depth: training benchmarks shrink to a few dozen steps, so
the whole suite finishes in minutes — numbers exist but are not meaningful;
the point is that no benchmark is rotten. Runs on the card unless
``--device cpu`` is given (the modules' plain versions on the host).

Prints ``name,us_per_call,shards,derived`` CSV (plus a roofline summary read
from the port's dry-run artifacts under ``results/dryrun_torch/``, if
present). ``shards`` is the shard count the row's table store was sharded
over (``-`` where sharding doesn't apply); table5's sharded rows say 8 (a
``MeshCtx`` of 8 shards of the run's device).
"""
from __future__ import annotations

import argparse
import glob
import importlib
import inspect
import json
import os
import sys
import time
import traceback
from typing import Optional

from repro_torch.launch.dryrun import RESULTS_DIR as DRYRUN_DIR

ALL = ["fig2", "table1", "table23", "table4", "fig5", "table5"]
MODULES = {
    "fig2": "repro_torch.bench.fig2_attention_patterns",
    "table1": "repro_torch.bench.table1_complexity",
    "table23": "repro_torch.bench.table23_auc",
    "table4": "repro_torch.bench.table4_tau",
    "fig5": "repro_torch.bench.fig5_m_sweep",
    "table5": "repro_torch.bench.table5_serving",
}


def roofline_rows(results_dir: Optional[str] = None) -> list[dict]:
    """One row per dry-run cell JSON under ``results_dir`` (default the
    port's ``results/dryrun_torch``)."""
    rows = []
    pattern = os.path.join(results_dir or DRYRUN_DIR, "*", "*.json")
    for f in sorted(glob.glob(pattern)):
        with open(f) as fh:
            r = json.load(fh)
        rf = r.get("roofline_fraction")
        rows.append({
            "name": f"roofline/{r['mesh']}/{r['arch']}/{r['shape']}"
                    + ("" if r.get("variant", "baseline") == "baseline"
                       else f"+{r['variant']}"),
            "us_per_call": 1e6 * max(r["t_compute_s"], r["t_memory_s"],
                                     r["t_collective_s"]),
            "derived": f"bottleneck={r['bottleneck']};"
                       f"hbm={r['hbm_total_per_chip_gib']}GiB;"
                       f"fits={r['fits_80gib']};"
                       f"roofline_frac={rf if rf is None else round(rf, 4)}",
        })
    return rows


def print_row(r: dict) -> None:
    print(f"{r['name']},{r['us_per_call']:.1f},{r.get('shards', '-')},{r['derived']}",
          flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--full", action="store_true", help="long training runs")
    p.add_argument("--smoke", action="store_true",
                   help="pipeline-proof depth: every module, minutes total")
    p.add_argument("--only", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.full and args.smoke:
        p.error("--full and --smoke are mutually exclusive")
    todo = args.only.split(",") if args.only else ALL
    unknown = [n for n in todo if n not in MODULES]
    if unknown:
        p.error(f"unknown module(s) {unknown}; have {ALL}")

    print("name,us_per_call,shards,derived", flush=True)
    failures = []
    for name in todo:
        t0 = time.time()
        try:
            run = importlib.import_module(MODULES[name]).run
            params = inspect.signature(run).parameters
            kw = {"smoke": True} if args.smoke and "smoke" in params else {}
            if "device" in params:
                kw["device"] = args.device
            for r in run(quick=not args.full, **kw):
                print_row(r)
        except Exception as e:
            traceback.print_exc(file=sys.stderr)
            failures.append((name, repr(e)))
        print(f"# {name} done in {time.time() - t0:.0f}s", file=sys.stderr)

    for r in roofline_rows():
        print_row(r)

    if failures:
        print(f"# FAILURES: {failures}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
