"""The dry run: every (architecture x input shape) cell, 40 in all, on the
single-pod (16 x 16 = 256 chips) and multi-pod (2 x 16 x 16 = 512 chips)
meshes, counted per chip from the cell's specs; nothing runs and nothing
is allocated.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell on faked TPU devices and reads XLA's ``memory_analysis()``,
``cost_analysis()`` and the collectives of the HLO. PyTorch has no such
compiler analysis, so the port counts (a departure):

* memory per chip: ``argument_bytes``, each argument leaf's block as
  ``Placement.place`` cuts it; ``output_bytes``, each output's block;
  ``alias_bytes``, the outputs that reuse donated arguments (a train
  cell's state, the SDIM-KV cache); ``temp_bytes`` null, compiler
  temporaries are not counted. ``hbm_total_per_chip_gib`` is argument +
  output - alias bytes, ``fits_80gib`` whether that is under one H100's
  80 GiB;
* flops: ``launch/flops.py``'s model flops, spread evenly over the chips;
* collectives: a lower bound over the parameters' traffic only. A
  parameter split over the data axes is all-gathered before use, forward
  and backward in a train cell, once in an inference cell, a chip
  receiving the bytes outside its own block; its gradient is
  reduce-scattered once (the same bytes). A parameter replicated over the
  data axes has its gradient all-reduced, ``2·(n-1)/n`` of its block's
  bytes for n data-parallel chips. Activation collectives (tensor and
  sequence parallelism, the experts' all-to-all, the split-KV combine) are
  not counted.

The roofline terms (``distributed/roofline.CellRooflineRecord``): compute
is the model flops per chip over the peak of the cell's compute dtype,
memory the argument and output bytes over the HBM rate, collective the
counted bytes over NVLink. The reference's reduced-depth unrolled passes
for cost extrapolation have nothing to do here.

Results go to ``results/dryrun_torch/<pod16x16|pod2x16x16>/<cell>.json``,
one file a cell; a rerun skips the cells already written.

Usage:
    python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--force]
    python -m repro_torch.launch.dryrun --arch deepseek-v2-236b --shape long_500k \\
        --variant sdim_kv
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

from repro_torch.configs import registry
from repro_torch.distributed import roofline as rl
from repro_torch.launch import flops as flops_lib
from repro_torch.launch.mesh import data_axes, make_production_mesh
from repro_torch.launch.specs import build_cell, tree_leaves

RESULTS_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "..",
                                           "results", "dryrun_torch"))


def out_path(mesh_tag: str, arch: str, shape: str, variant: str) -> str:
    d = os.path.join(RESULTS_DIR, mesh_tag)
    os.makedirs(d, exist_ok=True)
    v = "" if variant == "baseline" else f"__{variant}"
    return os.path.join(d, f"{arch}__{shape}{v}.json")


def _bytes(tree, mesh) -> int:
    return sum(leaf.block_bytes(mesh) for leaf in tree_leaves(tree))


def param_collectives(params, mesh, train: bool) -> dict:
    """The per-chip collective bytes of a parameter tree (``Leaf``s) on
    ``mesh`` (module docstring): by collective, every one of the
    reference's collective ops a key."""
    dp = data_axes(mesh)
    n = math.prod(mesh.shape[a] for a in dp)
    out = {op: 0 for op in rl.COLLECTIVE_OPS}
    for leaf in tree_leaves(params):
        named = [a for e in leaf.spec for a in ((e,) if isinstance(e, str) else e or ())]
        k = math.prod(mesh.shape[a] for a in named if a in dp)
        block = leaf.block_bytes(mesh)
        if k > 1:
            out["all-gather"] += block * (k - 1) * (2 if train else 1)
            if train:
                out["reduce-scatter"] += block * (k - 1)
        elif train and n > 1:
            out["all-reduce"] += 2 * (n - 1) * block // n
    return out


def count_cell(cell, mesh) -> dict:
    """The memory counts of a built cell on ``mesh`` (bytes per chip)."""
    args = cell.abstract_args
    arg = _bytes(args, mesh)
    out = _bytes(cell.outputs, mesh)
    alias = sum(_bytes(args[i], mesh) for i in cell.donate)
    return {"argument_bytes": arg, "output_bytes": out, "alias_bytes": alias,
            "temp_bytes": None}


def run_cell(arch: str, shape: str, multi_pod: bool, variant: str = "baseline",
             verbose: bool = True) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.perf_counter()
    cell = build_cell(arch, shape, mesh, variant=variant)
    memory = count_cell(cell, mesh)
    train = cell.kind == "train"
    params = cell.abstract_args[0]["params"] if train else cell.abstract_args[0]
    coll = param_collectives(params, mesh, train)
    mf = flops_lib.model_flops(arch, shape, variant)
    n = mesh.n_chips
    record = rl.CellRooflineRecord(
        name=cell.name, n_chips=n, flops_per_chip=mf / n,
        hbm_bytes_per_chip=float(memory["argument_bytes"] + memory["output_bytes"]),
        collective_bytes_per_chip=float(sum(coll.values())), collective_breakdown=coll,
        peak_memory_per_chip=float(memory["argument_bytes"] + memory["output_bytes"]
                                   - memory["alias_bytes"]),
        model_flops=mf, peak_flops=rl.peak_flops(cell.compute_dtype))
    out = record.to_dict()
    per_chip = record.peak_memory_per_chip
    out.update({
        "arch": arch, "shape": shape, "variant": variant, "mesh": mesh.tag,
        "kind": cell.kind, "note": cell.note, "compute_dtype": cell.compute_dtype,
        "donate": list(cell.donate), "n_leaves": len(tree_leaves(cell.abstract_args)),
        "count_s": round(time.perf_counter() - t0, 3),
        "memory": memory,
        "hbm_total_per_chip_gib": round(per_chip / 2**30, 3),
        "fits_80gib": per_chip < rl.HBM_BYTES,
    })
    if verbose:
        print(f"== {cell.name} [{mesh.tag}] {cell.kind} ==")
        print(f"   memory per chip: {memory}")
        print(f"   per-chip HBM: {out['hbm_total_per_chip_gib']} GiB "
              f"(fits 80 GiB: {out['fits_80gib']}; temporaries not counted)")
        print(f"   roofline: compute={out['t_compute_s']:.4g}s "
              f"memory={out['t_memory_s']:.4g}s "
              f"collective={out['t_collective_s']:.4g}s "
              f"-> bottleneck={out['bottleneck']}")
        print(f"   parameter collectives: {coll}")
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Count every cell's per-chip memory, "
                                            "flops and parameter collectives.")
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--variant", default="baseline")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--all", action="store_true", help="all 40 cells on this mesh")
    p.add_argument("--force", action="store_true")
    args = p.parse_args(argv)

    mesh_tag = make_production_mesh(multi_pod=args.multi_pod).tag
    if args.all:
        todo = list(registry.cells())
    else:
        if not (args.arch and args.shape):
            p.error("--arch and --shape (or --all)")
        todo = [(args.arch, args.shape)]

    failures = []
    for arch, shape in todo:
        path = out_path(mesh_tag, arch, shape, args.variant)
        if os.path.exists(path) and not args.force:
            print(f"skip (cached): {arch}/{shape} [{mesh_tag}]")
            continue
        try:
            rec = run_cell(arch, shape, args.multi_pod, args.variant)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
        except Exception as e:
            traceback.print_exc()
            failures.append((arch, shape, repr(e)))
    if failures:
        print("\nFAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nall requested cells counted OK")


if __name__ == "__main__":
    main()
