"""Render the dry run's roofline and memory tables from
``results/dryrun_torch`` JSONs (``launch/dryrun.py``).

Counterpart of ``repro/launch/report.py``; a chip is an 80 GiB H100.

    python -m repro_torch.launch.report [--mesh pod16x16] [--table {roofline,dryrun}]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import RESULTS_DIR


def fmt(x, nd=4):
    if x is None:
        return "-"
    if x == 0:
        return "0"
    if abs(x) >= 100:
        return f"{x:.0f}"
    return f"{x:.{nd}g}"


def load(mesh_tag: str, results_dir: str = RESULTS_DIR) -> list[dict]:
    rows = []
    for f in sorted(glob.glob(os.path.join(results_dir, mesh_tag, "*.json"))):
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def roofline_table(rows: list[dict]) -> str:
    out = ["| arch | shape | variant | kind | HBM GiB | fits 80GiB | t_comp s | t_mem s | t_coll s "
           "| bottleneck | MODEL_FLOPS | useful frac | roofline frac |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r.get('variant', 'baseline')} | {r['kind']} "
            f"| {r['hbm_total_per_chip_gib']} | {'Y' if r['fits_80gib'] else 'N'} "
            f"| {fmt(r['t_compute_s'])} | {fmt(r['t_memory_s'])} | {fmt(r['t_collective_s'])} "
            f"| {r['bottleneck']} | {fmt(r.get('model_flops'), 3)} "
            f"| {fmt(r.get('useful_flops_fraction'))} | {fmt(r.get('roofline_fraction'))} |")
    return "\n".join(out)


def dryrun_table(rows: list[dict]) -> str:
    out = ["| arch | shape | variant | per-chip HBM GiB | fits 80GiB "
           "| parameter collectives (per-chip bytes) | count s |",
           "|---|---|---|---|---|---|---|"]
    for r in rows:
        coll = ", ".join(f"{k}={v / 1e9:.2f}G" for k, v in
                         r["collective_breakdown"].items() if v)
        out.append(
            f"| {r['arch']} | {r['shape']} | {r.get('variant', 'baseline')} "
            f"| {r['hbm_total_per_chip_gib']} | {'Y' if r['fits_80gib'] else 'N'} "
            f"| {coll or '-'} | {r.get('count_s', '-')} |")
    return "\n".join(out)


def main(argv=None):
    p = argparse.ArgumentParser(description="Render the dry run's tables.")
    p.add_argument("--mesh", default="pod16x16")
    p.add_argument("--table", default="roofline", choices=["roofline", "dryrun"])
    args = p.parse_args(argv)
    rows = load(args.mesh)
    print(f"### mesh {args.mesh} — {len(rows)} cells\n")
    print(roofline_table(rows) if args.table == "roofline" else dryrun_table(rows))


if __name__ == "__main__":
    main()
