#!/usr/bin/env python3
"""Where the time of the split-work kernels goes, phase by phase, on one
NVIDIA GPU (written for the H100):

    python3 phase_clocks.py
    python3 phase_clocks.py table4 [--src DIR]
    python3 phase_clocks.py table23 [--src DIR]
    python3 phase_clocks.py query [--src DIR]
    python3 phase_clocks.py bwd_wide [--src DIR]
    python3 phase_clocks.py fold [--src DIR]
    python3 phase_clocks.py ta_bwd_err [N]
    python3 phase_clocks.py reads_past [--src DIR]
    python3 phase_clocks.py smoke_kernels [--src DIR]

Builds the port's kernels with ``-DSDIM_PHASE_CLOCKS`` (a library beside
the port's own, under ``build/``): thread 0 of every CTA then adds the SM
cycles of each phase that ``PHASE_MARK`` delimits in ``bse_encode.cu``,
``fused_query.cuh`` (``sdim_fused_serve`` and ``sdim_query``, each with
its own clocks), ``sdim_update.cu`` (the phase ends after the barrier
that closes it, so it includes the wait for the slowest thread) and the
large-tau serving paths (``bse_serve_large_tau.cu``'s two kernels and
``sdim_fused_serve_large_tau.cu``, at chip_smoke.py phase 20 (a)'s
shapes: tau 5 and 10, and tau = 1 at m = 48 for bse_serve), and the
large-tau training paths (``bse_encode_large_tau.cu``'s forward at Table
4's training shape and at the history ingest's, ``sdim_query_large_tau.cu``'s
backward at Table 4's; tau 5 and 10) and the two backward kernels of
the training steps (``target_attn_backward.cu``'s one launch at C = 1 and
``bse_encode_backward.cu`` at tau 3: chip_smoke.py phase 3's shapes, and
the Table 2/3 protocol's and Table 4's: B = 128, L = 256, d = 32, and the
retrieval kinds' 128 folded users of k = 16 rows, where it also times
each split of the target backward: 1, 2, 4 and 8 users a CTA and the
two-launch path), and kernel 4's ``sdim_query_backward.cu`` (tau 3 at
chip_smoke.py phase 3's training step, at d = 36, at C = 128 and at the
protocol's step) and large-tau forward (``sdim_query_large_tau.cu``:
Table 4's training step and phase 20's burst), and stamps %globaltimer
at the CTA's start and end. Runs each kernel at the main
path's burst shape of ``chip_smoke.py`` (B = 16, L = 1024 with front-padded
lengths uniform on [L/4, L], C = 128, d = 128, m = 48, tau = 3; fp32, and
a bf16 table for sdim_query), bse_encode at 8 and 16 group slices per user,
and sdim_update on the main path's event burst (32 batch rows of E = 16
events on random slots of 64, some duplicated) at 8 and 16 group
slices, on chip_smoke.py's duplicate-heavy burst and on 1024 batch rows at
the wrapper's choice, each after three warm-up launches, and prints for each phase the mean and the largest cycles over
CTAs and the cycles of the CTA that ends last, with the launch's span and
the spread of CTA start times.
The clocks change the code they time a little (a clock read per mark),
so each run also prints the device time of the port's own library, which
never has them (torch.profiler over 20 launches). Imports nothing of JAX.

``table4`` instead trains Table 4's model (``bench/table4_tau.py``: sdim,
batch 128, L = 256, d = 32) at tau 3, 5 and 10 with the port of ``--src``
(default this checkout's ``src``; another checkout's, to compare two trees
in one run) and prints ms/step (host clock over 20 steps, after 3
warm-up steps) and the device-busy share of 6 steps under torch.profiler
(the union of the device operations' intervals over the host's wall time).
``table23`` does the same for the Table 2/3 protocol's ``target``,
``sim_hard`` (top-k 16: 128 folded users of 16 rows) and ``sdim`` (m = 48,
tau = 3) kinds (``bench/table23_auc.py``: batch 128, L = 256, AdamW lr 5e-3);
both print the device ms per 6 steps of the SDIM backward kernels, the
target backward and sdim_query's large-tau forward (``STEP_KERNELS``).
``query`` prints the device ms (three rounds of 20 launches under
torch.profiler) of ``sdim_query_backward`` at ``BWD_QUERY_SHAPES`` and of
``sdim_query`` at ``LT_QUERY_SHAPES`` with the port of ``--src``, each with
its max abs error against its plain version, on inputs drawn from one seed,
so two trees run in one chip call see the same data. ``bwd_wide`` does the
same for ``bse_encode_backward`` at Table 4's tau 5 and 10 (B = 128, L =
256, d = 32, m = 45 and 40) and ``sdim_query``'s wide path at
``WIDE_SHAPES``, and, where the port under ``--src`` has them, times each
layout of the first (dT staged or gathered) and each tile of the second
(``WIDE_TILES``). The default run also clocks both (the large-tau
backward beside the large-tau training kernels, the wide path beside
kernel 4's other paths). ``fold`` does the same for
``target_attention_flash`` at the folded shapes of ``FOLD_SHAPES`` (and the
main path's burst, ``FOLD_MAIN``) and for ``sdim_update``'s large-tau
fold at chip_smoke.py phase 20 (a)'s event bursts (16 batch rows of E = 16
events on random slots of 64 users, a zero-mask row; tau 5 and 10, d =
128 and 36: chip_smoke.py's own draws, replayed, whose duplicate slots
give one CTA two or three rows to fold, and the same draws with their
duplicates moved to unused slots), with the event-timed ms of a wrapper
call (host work included, median of 30, three rounds), and, where the
port under ``--src`` has them, times each CTA shape of the folded body
(``FOLD_USERS`` users a CTA, and the cluster body) and prints both
kernels' phase cycles (``target_attn.cu``'s folded body,
``sdim_update_large_tau.cu``, whose owners of two rows are also reported
on their own).
``ta_bwd_err`` draws N (default 200) seeded ``dout`` for
``tests/test_torch_cuda.py``'s ``test_target_attention_flash_backward_kernel``
at (B, L, C, d) = (32, 16, 128, 128), fp32, front-padded rows (its inputs,
seed 9), and prints, at C = 1 and C = 128, how often and by how much dseq
misses the test's fp32 tolerance (atol 1e-5, rtol 1e-5): the kernel
against the plain version (the test's check), and each of the two against
the closed form summed in fp64. ``reads_past`` calls ``sdim_query`` and
``sdim_fused_serve`` (fp32) of the port under ``--src`` at the shapes past
the fused body's shared memory (``READS_PAST``: m = 500 at d = 128, R
alone 256,000 B; tau = 4 at d = 256) and prints, for each, its max abs
error against the plain version or the exception the call raised.
``smoke_kernels`` runs the kernel checks of the ``chip_smoke.py`` beside
``--src`` (phases 3, 20 (a), 21 (a) and, where that tree has them, 22
(a) and (b)) with that tree's port, and prints their figures as one JSON
line (``SMOKE_KERNELS_JSON``), so two trees' kernels can be compared in
one chip call (parent, change, change, parent).
"""
from __future__ import annotations

import ctypes
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
B, L, C, D, M, TAU, E = 16, 1024, 128, 128, 48, 3, 16
SLOTS, CTAS = 7, 8192        # tile_staging.cuh: kPhaseSlots, kPhaseCTAs
FUSED = ["row loads", "wait R, cands", "normalize", "cluster barrier", "push + hash",
         "rest of the copy", "answers"]
PHASES = {
    "bse_encode": ["batch list + R", "wait + hash (warp 0)", "scatter (warp 0)",
                   "merge + store"],
    "sdim_fused_serve": FUSED,
    "sdim_query": FUSED,
    "sdim_update": ["slot scan", "wait slice, R, events", "hash + cell masks", "sums",
                    "write", "stage next"],
    # the large-tau serving paths (bse_serve_large_tau.cu's two kernels,
    # sdim_fused_serve_large_tau.cu)
    "bse_serve_lt_table": ["staging (R, list, tile waits)", "hash (candidates, rows)",
                           "bucketing (bitmap, ranks, row masks)", "sums", "store",
                           "tile barriers"],
    "bse_serve_lt_gather": ["staging (none)", "rank reads", "row loads + norms",
                            "sums (+ barriers)", "store"],
    "sdim_fused_serve_lt": ["staging (candidates)", "hash", "row loads + norms",
                            "sums (+ barriers)", "store"],
    # the large-tau training paths (bse_encode_large_tau.cu's forward,
    # sdim_query_large_tau.cu's backward)
    "bse_encode_lt": ["staging (R)", "hash", "ranking (+ barrier)", "sums + stores"],
    "sdim_query_backward_lt": ["staging (R, rows)", "hash", "ranking (+ barriers)",
                               "selected rows", "zero stores"],
    "sdim_query_lt": ["staging (candidates)", "hash", "row loads + norms",
                      "sums (+ barriers)", "store"],
    # the backward kernels of the training steps (target_attn_backward.cu's
    # one launch, bse_encode_backward.cu at tau <= 4)
    "target_attention_backward": ["staging (mask scan, copies issued)",
                                  "logits (+ waits for rows)", "max/den exchange",
                                  "dS + dseq stores + dq sums", "dq exchange + store"],
    "bse_encode_backward": ["staging (rows, multicast wait)", "hash (warp 0)",
                            "gather + stores (warp 0)"],
    # the large-tau backward (bse_encode_backward_large_tau.cu) and kernel 4's wide
    # path (wide_query.cuh)
    "bse_encode_backward_lt": ["staging (R; first rows)", "hash", "wait for staged dT",
                               "gather + stores"],
    "sdim_query_wide": ["stage (R, candidates)", "hash + bits + first rows' copy",
                        "rows' copy waits", "norms + answers"],
    "sdim_query_backward": ["staging (R, q, dout)", "hash (+ barrier)",
                            "passes after the first (+ barriers)", "rows (selected, zeros)"],
    # kernel 6's folded body (target_attn.cu) and sdim_update's large-tau
    # fold (sdim_update_large_tau.cu); thread 0 of a CTA: its first user
    "target_attention_folded": ["mask, q, row list", "row loads + logits", "softmax",
                                "p x sums", "row-group merge + store"],
    "sdim_update_lt": ["loads (R, events land)", "owner barrier", "owner list", "hash",
                       "hash barrier", "sort (+ barrier)", "fold (+ barrier)"],
}
# the backward kernels' shapes: (B, L, d) of chip_smoke.py phase 3 (the
# training step, its folded retrieval shape, both at dien's d = 36 too) and
# of the Table 2/3 protocol and Table 4 (B = 128, L = 256, d = 32; the
# retrieval kinds' 128 users of one candidate over k = 16 rows)
BWD_TARGET_SHAPES = {"main": (32, 1024, 128), "folded": (2048, 32, 128),
                     "main d=36": (32, 1024, 36), "folded d=36": (2048, 32, 36),
                     "protocol target": (128, 256, 32), "protocol folded": (128, 16, 32)}
BWD_ENCODE_SHAPES = {"main": (32, 1024, 128), "main d=36": (32, 1024, 36),
                     "protocol": (128, 256, 32)}
BWD_SPLITS = ((1, 1), (2, 1), (4, 1), (8, 1), (0, 0))  # the protocol folded shape's candidates
# sdim_query_backward at tau 3 (m = 48), (B, C, d): chip_smoke.py phase 3's
# training step (and at dien's d = 36, and its check at C = 128) and the
# Table 2/3 protocol's and Table 4's step
BWD_QUERY_SHAPES = {"train": (32, 1, 128), "train d=36": (32, 1, 36),
                    "protocol": (128, 1, 32), "C=128": (32, 128, 128)}
BWD_QUERY_SPLITS = (2, 4, 8, 16)   # the group slices a user the query mode also times
# sdim_query's large-tau forward, (B, C, d, tau, m): Table 4's training step
# and chip_smoke.py phase 20's burst (the decoupled read of fetched tables)
LT_QUERY_SHAPES = {"table4 tau=5": (128, 1, 32, 5, 45), "table4 tau=10": (128, 1, 32, 10, 40),
                   "phase20 tau=5": (16, 128, 128, 5, 45),
                   "phase20 tau=10": (16, 128, 128, 10, 40)}
LT_SHAPES = ((5, 45), (10, 40), (1, 48))    # chip_smoke.py phase 20 (a): (tau, m) at d = 128
# the large-tau training kernels' shapes (B, L, C, d): Table 4's training
# step and the decoupled deployment's history ingest (chip_smoke.py phase
# 20 (a)), each at (tau, m) of LT_SHAPES[:2]
LT_TRAIN_SHAPES = {"table4": (128, 256, 1, 32), "ingest": (B, L, C, D)}
# kernel 4's wide path, (B, C, d): deepseek-v2's SDIM-KV read (the MLA
# latent, 128 heads) and chip_smoke.py phase 14's B = 8 check (m = 48, tau 3)
WIDE_SHAPES = {"mla": (1, 128, 512), "B=8": (8, 128, 512)}
WIDE_TILES = (1, 2, 4, 8)     # the candidates a CTA the bwd_wide mode also times
# kernel 6's folded body, (users, L, d): chip_smoke.py phase 3's retrieval
# shape (2,048 users of one candidate over k = 32 rows) at d = 128 and 36,
# and the Table 2/3 protocol's (128 users over k = 16 rows, d = 32)
FOLD_SHAPES = {"folded": (2048, 32, 128), "folded d=36": (2048, 32, 36),
               "protocol folded": (128, 16, 32)}
FOLD_MAIN = (16, 1024, 128, 128)   # (B, L, C, d): the main path's burst, the cluster body
FOLD_USERS = (1, 2, 4, 8)          # users a CTA the fold mode also times (0: cluster body)
LT_EV = 64                         # chip_smoke.py phase 20 (a): users whose rows the events hit


def read_phases(lib, reader: str, n_cta: int, first: int = 0) -> np.ndarray:
    rows = np.zeros((CTAS, SLOTS + 2), np.uint64)
    err = getattr(lib, reader)(ctypes.c_void_p(rows.ctypes.data), ctypes.c_int(rows.nbytes))
    if err != 0:
        raise RuntimeError(f"{reader}: CUDA error {err}")
    return rows[first:first + n_cta].astype(np.int64)


def report(name: str, rows: np.ndarray) -> None:
    begin, end = rows[:, SLOTS], rows[:, SLOTS + 1]
    done = end > 0                       # absent users' CTAs leave early
    # a CTA that leaves early keeps an earlier launch's row: keep the rows
    # of the last launch, the CTAs that overlap in time with its last start
    first = begin[done].max() if done.any() else 0
    while done.any():
        nxt = begin[done & (end >= first)].min()
        if nxt == first:
            break
        first = nxt
    done &= end >= first
    rows, begin, end = rows[done], begin[done], end[done]
    last = int(np.argmax(end))
    cycles = rows[:, :SLOTS].sum(1)
    ghz = float(np.median(cycles / np.maximum(end - begin, 1)))
    print(f"{name}: {len(rows)} CTAs, launch span {(end.max() - begin.min()) / 1e3:.2f} us, "
          f"CTA starts spread over {(begin.max() - begin.min()) / 1e3:.2f} us, "
          f"CTA time mean {(end - begin).mean() / 1e3:.2f} us max "
          f"{(end - begin).max() / 1e3:.2f} us, SM clock ~{ghz:.2f} GHz")
    base = name.split(" ")[0]
    for k, phase in enumerate(PHASES[base]):
        if k >= SLOTS:
            break
        col = rows[:, k]
        print(f"  {phase:18s} mean {col.mean():9.0f}  max {col.max():9d}  "
              f"last CTA {col[last]:9d} cycles")


def event_ms(fn, iters: int = 30) -> float:
    """Median over ``iters`` calls of a call's CUDA-event time, its host
    work included (chip_smoke.py's ``ms``), after three warm-up calls."""
    import torch

    for _ in range(3):
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
    return float(np.median(times))


def device_ms(fn, n: int = 20) -> float:
    """Summed device time of n launches under torch.profiler, over n."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == DeviceType.CUDA) / n / 1e3


def host_breakdown(lib, store, slots, q, R) -> None:
    """Median host time of the pieces of one sdim_fused_serve wrapper call
    (each piece run on its own, 200 times)."""
    import torch
    from repro_torch.kernels import _build

    dev = q.device
    out = torch.empty(q.shape, device=dev)
    B, C, d = q.shape
    G, U = store.shape[1], store.shape[2]
    args = (store.data_ptr(), 0, None, slots.data_ptr(), None, q.data_ptr(), R.data_ptr(),
            out.data_ptr(), B, C, G, U, d, R.shape[0], R.shape[0] // G, 0, G, 1,
            _build.stream(dev))
    pieces = {
        "shape and dtype checks + require_cuda + require_aligned": lambda: (
            _build.dtype_code("x", store, (torch.float32,)),
            _build.require_cuda("x", store, slots, q, R), _build.require_aligned("x", store, q, R)),
        "torch.empty of the output": lambda: torch.empty((B, C, d), device=dev),
        "stream + device guard": lambda: (_build.stream(dev), _build.on_device(dev)),
        "C entry point (ctypes + launch)": lambda: lib.sdim_fused_serve(*args),
    }
    for name, fn in pieces.items():
        times = []
        for _ in range(200):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        print(f"  host: {name}: median {1e6 * np.median(times):.1f} us")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("phase_clocks: torch.cuda.is_available() is False", file=sys.stderr)
        return 3
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from functools import partial

    from repro_torch.kernels import _build
    from repro_torch.kernels.screen import screened_normal
    from repro_torch.kernels.sdim_bucket.sdim_bucket import bse_encode_cuda, bse_encode_ref
    from repro_torch.kernels.sdim_fused_serve.sdim_fused_serve import sdim_fused_serve
    from repro_torch.kernels.sdim_query.sdim_query import sdim_query
    from repro_torch.kernels.sdim_update.sdim_update import sdim_update_cuda, update_splits

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    plain = _build.bind(_build.build())
    _build._lib = lib = _build.bind(_build.build(("-DSDIM_PHASE_CLOCKS",)))
    rng = np.random.default_rng(0)
    Rn = rng.standard_normal((M, D)).astype(np.float32)
    R = torch.from_numpy(Rn).to(dev)
    t = lambda x: torch.from_numpy(x).to(dev)
    for b in (B, 2):                     # the burst, and two users (little traffic)
        seq = t(screened_normal(rng, (b, L, D), Rn))
        lengths = rng.integers(L // 4, L + 1, b)
        if b < B:
            lengths[:] = L
        mask = t((np.arange(L)[None] >= L - lengths[:, None]).astype(np.float32))
        q = t(screened_normal(rng, (b, C, D), Rn))
        store = torch.cat([bse_encode_ref(seq, mask, R, TAU),
                           torch.zeros((b, M // TAU, 1 << TAU, D), device=dev)])
        slots = torch.randperm(2 * b, generator=torch.Generator().manual_seed(b))[:b].to(
            dev, torch.int32)
        print(f"B = {b}: valid rows per user {sorted(lengths.tolist())}")
        runs = [(f"bse_encode S={s} B={b}", partial(bse_encode_cuda, seq, mask, R, TAU, s),
                 "sdim_bse_encode_phases", b * s) for s in (8, 16)]
        runs.append((f"sdim_fused_serve B={b}",
                     partial(sdim_fused_serve, store, slots, q, R, TAU),
                     "sdim_fused_serve_phases", b * 8))
        runs.append((f"sdim_query B={b} bf16",
                     partial(sdim_query, q, store[:b].to(torch.bfloat16), R, TAU),
                     "sdim_query_phases", b * 8))
        for run in runs:
            clock(lib, plain, *run)
        host_breakdown(plain, store, slots, q, R)

    # sdim_update: the main path's event burst (32 rows on random slots of
    # 64), chip_smoke.py's duplicate-heavy one (31 rows on 15 slots, a
    # zero-mask row at slot 0), then a large one
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    G, U = M // TAU, 1 << TAU
    for name, bu, splits in (("random", 32, (8, 16)), ("duplicate-heavy", 32, (8, 16)),
                             ("random", 1024, (None,))):
        events = t(screened_normal(rng, (bu, E, D), Rn))
        ev_mask = t((rng.random((bu, E)) > 0.2).astype(np.float32))
        if name == "random":
            sl = rng.integers(0, 2 * bu, bu)
        else:
            sl = np.r_[0, rng.integers(1, bu // 2, bu - 1)]
            ev_mask[0] = 0
        ev_slots = t(sl.astype(np.int32))
        store = torch.randn((2 * bu, G, U, D), device=dev)
        print(f"sdim_update B = {bu}, {name} slots: {len(set(sl.tolist()))} distinct, "
              f"at most {np.bincount(sl).max()} rows on one; wrapper's choice "
              f"S = {update_splits(bu, G, U, D, n_sm)}")
        for s in splits:
            s = s or update_splits(bu, G, U, D, n_sm)
            clock(lib, plain, f"sdim_update S={s} B={bu} {name}",
                  partial(sdim_update_cuda, store, ev_slots, events, ev_mask, R, TAU, s),
                  "sdim_update_phases", bu * s)
    large_tau(lib, plain, dev, rng, n_sm)
    large_tau_training(lib, plain, dev, rng, n_sm)
    backward_kernels(lib, plain, dev, rng)
    query_kernels(lib, plain, dev, rng, n_sm)
    return 0


def backward_kernels(lib, plain, dev, rng) -> None:
    """target_attn_backward.cu's one launch (C = 1) and bse_encode_backward.cu
    (tau = 3, m = 48) at BWD_TARGET_SHAPES and BWD_ENCODE_SHAPES: front-padded
    histories with L/4..L valid rows (user 1 fully masked) as chip_smoke.py
    phase 3, the folded users' valid rows first (0..k of them, as the
    retrieval kinds' top-k). At the protocol's folded shape also the device
    time of each split the target backward could take there."""
    import torch
    from functools import partial

    from repro_torch.kernels import _build
    from repro_torch.kernels.screen import screened_normal
    from repro_torch.kernels.sdim_bucket.sdim_bucket import (bse_encode_backward,
                                                             launch_splits)
    from repro_torch.kernels.target_attn.target_attn import (
        _scale, launch_split, target_attention_flash, target_attention_flash_backward)

    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def front_mask(b, l):
        lengths = rng.integers(l // 4, l + 1, b)
        lengths[1] = 0
        return t((np.arange(l)[None] >= l - lengths[:, None]).astype(np.float32))

    for name, (b, l, d) in BWD_TARGET_SHAPES.items():
        seq = t(rng.standard_normal((b, l, d)).astype(np.float32))
        q, dout = (t(rng.standard_normal((b, 1, d)).astype(np.float32)) for _ in range(2))
        if name.startswith("folded") or name == "protocol folded":
            found = rng.integers(0, l + 1, b)
            mask = t((np.arange(l)[None] < found[:, None]).astype(np.float32))
        else:
            mask = front_mask(b, l)
        out = target_attention_flash(q, seq, mask)
        upc, S = launch_split(b, l, 1, d, seq.dtype, dev)
        print(f"target_attention_flash_backward {name} (B={b}, L={l}, d={d}, C=1): "
              f"{upc} users a CTA, clusters of {S}")
        clock(lib, plain, f"target_attention_backward {name}",
              partial(target_attention_flash_backward, dout, q, seq, mask, out),
              "sdim_target_attention_backward_phases", S * -(-b // upc))
        if name == "protocol folded":
            dq, dseq = torch.empty_like(q), torch.empty_like(seq)
            stats = torch.empty((b, 1, 4), device=dev)

            def split_call(upc, S):
                err = plain.sdim_target_attention_backward(
                    dout.data_ptr(), q.data_ptr(), seq.data_ptr(), 0, mask.data_ptr(),
                    out.data_ptr(), stats.data_ptr(), dq.data_ptr(), dseq.data_ptr(), b, l, 1,
                    d, _scale(d), upc, S, _build.stream(dev))
                _build.check(err, "target_attention_flash_backward")

            times = {f"{u},{s}": [] for u, s in BWD_SPLITS}
            for _ in range(3):  # the splits in turn, three times
                for u, s in BWD_SPLITS:
                    times[f"{u},{s}"].append(device_ms(partial(split_call, u, s)))
            print(f"  device ms a launch by (users a CTA, CTAs a user; 0,0: two launches), "
                  f"three rounds: {times}")
    for name, (b, l, d) in BWD_ENCODE_SHAPES.items():
        Rn = rng.standard_normal((M, d)).astype(np.float32)
        seq = t(screened_normal(rng, (b, l, d), Rn))
        mask = front_mask(b, l)
        dT = torch.randn((b, M // TAU, 1 << TAU, d), device=dev)
        S = launch_splits(b, l, M // TAU, d, TAU, seq.dtype, dev)
        print(f"bse_encode_backward {name} (B={b}, L={l}, d={d}, tau={TAU}): clusters of {S}")
        clock(lib, plain, f"bse_encode_backward {name}",
              partial(bse_encode_backward, dT, seq, mask, t(Rn), TAU),
              "sdim_bse_encode_backward_phases", S * b)


def query_inputs(torch, dev, rng, b, c, d, tau, m, own=False):
    """Candidates q (b, c, d), the table of b users' encoded histories (L =
    256, front-padded, 1..L valid rows, the last user fully masked), R and
    dout, margin-screened; with ``own`` half of each other user's
    candidates are its own valid behaviors (phase 20's burst)."""
    from repro_torch.kernels.screen import screened_normal
    from repro_torch.kernels.sdim_bucket.sdim_bucket import bse_encode_ref

    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    l = 256
    Rn = rng.standard_normal((m, d)).astype(np.float32)
    seq = screened_normal(rng, (b, l, d), Rn)
    mask = (np.arange(l)[None] >= rng.integers(0, l, b)[:, None]).astype(np.float32)
    mask[-1] = 0.0
    q = screened_normal(rng, (b, c, d), Rn)
    if own:
        for u in range(b - 1):
            q[u, :c // 2] = seq[u, rng.choice(np.flatnonzero(mask[u]), c // 2)]
    R = t(Rn)
    table = bse_encode_ref(t(seq), t(mask), R, tau)
    return t(q), table, R, t(rng.standard_normal((b, c, d)).astype(np.float32))


def wide_inputs(torch, dev, rng, b, c, d):
    """Screened candidates q (b, c, d) against random fp32 tables (b, 16, 8,
    d) with some empty buckets, and R (48, d): the wide path's inputs, as
    chip_smoke.py phase 14's B = 8 check."""
    from repro_torch.kernels.screen import screened_normal

    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    Rn = rng.standard_normal((M, d)).astype(np.float32)
    table = rng.standard_normal((b, M // TAU, 1 << TAU, d)).astype(np.float32)
    table[:, :, 1] = 0.0
    return t(screened_normal(rng, (b, c, d), Rn)), t(table), t(Rn)


def encode_backward_inputs(torch, dev, rng, tau, m):
    """Table 4's large-tau backward at (tau, m): dT from sdim_query_backward's
    plain version over one candidate a user (B = 128, L = 256, d = 32, up
    to L/2 leading rows masked, as chip_smoke.py phase 20 (a)), seq, mask
    and R."""
    from repro_torch.kernels.screen import screened_normal
    from repro_torch.kernels.sdim_bucket.sdim_bucket import bse_encode_ref
    from repro_torch.kernels.sdim_query.sdim_query import sdim_query_backward_ref

    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    b, l, d = 128, 256, 32
    Rn = rng.standard_normal((m, d)).astype(np.float32)
    R = t(Rn)
    seq, q = t(screened_normal(rng, (b, l, d), Rn)), t(screened_normal(rng, (b, 1, d), Rn))
    mask = t((np.arange(l)[None] >= rng.integers(0, l // 2, b)[:, None]).astype(np.float32))
    dout = t(rng.standard_normal((b, 1, d)).astype(np.float32))
    dT = sdim_query_backward_ref(dout, q, bse_encode_ref(seq, mask, R, tau), R, tau)
    return dT, seq, mask, R


def bwd_wide_times(src: str) -> int:
    """``bwd_wide`` mode (module docstring)."""
    import torch
    if not torch.cuda.is_available():
        print("phase_clocks: torch.cuda.is_available() is False", file=sys.stderr)
        return 3
    sys.path.insert(0, os.path.abspath(src))
    from functools import partial

    from repro_torch.kernels import _build
    from repro_torch.kernels.sdim_bucket import sdim_bucket
    from repro_torch.kernels.sdim_query import sdim_query as kq

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"bse_encode_backward (large tau) and sdim_query (wide path) with the port at "
          f"{os.path.abspath(src)}")
    rounds = lambda fn: [device_ms(fn) for _ in range(3)]
    line = lambda ms: (f"{ms[0]:.4f} {ms[1]:.4f} {ms[2]:.4f} (median {sorted(ms)[1]:.4f})")
    for tau, m in LT_SHAPES[:2]:
        args = encode_backward_inputs(torch, dev, np.random.default_rng(34), tau, m)
        err = float((sdim_bucket.bse_encode_backward(*args, tau)
                     - sdim_bucket.bse_encode_backward_ref(*args, tau)).abs().max())
        ms = rounds(partial(sdim_bucket.bse_encode_backward, *args, tau))
        print(f"bse_encode_backward table4 tau={tau} m={m} (B=128, L=256, d=32): device ms a "
              f"launch {line(ms)}; max abs err {err:.3g}")
        if hasattr(sdim_bucket, "launch_large_tau_split"):   # each layout and split
            dT, seq = args[0], args[1]
            G = m // tau
            staged, S = sdim_bucket.launch_large_tau_split(128, 256, G, 32, tau, seq.dtype, dev)
            fits = _build.clusters("sdim_bse_encode_backward_large_tau_ctas", dev, 0, G, 32,
                                   tau, 256, 1) > 0
            by = {f"{'staged' if st else 'gathered'} S={s_}": sorted(rounds(partial(
                sdim_bucket.bse_encode_backward_cuda, *args, tau, s_, st)))[1]
                for st in ((True, False) if fits else (False,)) for s_ in (1, 2)}
            print(f"  the wrapper's choice: {'staged' if staged else 'gathered'}, S = {S}; "
                  f"device ms by layout and CTAs a user: { {k: round(v, 4) for k, v in by.items()} }")
    for name, (b, c, d) in WIDE_SHAPES.items():
        q, table, R = wide_inputs(torch, dev, np.random.default_rng(35), b, c, d)
        err = float((kq.sdim_query(q, table, R, TAU) - kq.sdim_query_ref(q, table, R, TAU))
                    .abs().max())
        ms = rounds(partial(kq.sdim_query, q, table, R, TAU))
        print(f"sdim_query wide path {name} (B={b}, C={c}, d={d}, m={M}, tau={TAU}): device ms "
              f"a launch {line(ms)}; max abs err {err:.3g}")
        if hasattr(kq, "wide_tile"):                         # each tile
            lib = _build.load()
            out = torch.empty_like(q)
            G = M // TAU

            def tiled(tile):
                err = lib.sdim_query(table.data_ptr(), 0, q.data_ptr(), R.data_ptr(),
                                     out.data_ptr(), b, c, G, 1 << TAU, d, M, TAU, tile, G, 1,
                                     _build.stream(dev))
                _build.check(err, "sdim_query")

            choice = kq.launch_wide_tile(b, c, G, d, TAU, table.dtype, dev)
            by = {tile: sorted(rounds(partial(tiled, tile)))[1] for tile in WIDE_TILES}
            print(f"  the wrapper's tile: {choice}; device ms by candidates a CTA: "
                  f"{ {k: round(v, 4) for k, v in by.items()} }")
    return 0


def query_kernels(lib, plain, dev, rng, n_sm) -> None:
    """sdim_query_backward (tau 3, m = 48) at BWD_QUERY_SHAPES, sdim_query's
    large-tau forward at LT_QUERY_SHAPES and its wide path at WIDE_SHAPES
    (fp32 tables)."""
    import torch
    from functools import partial

    from repro_torch.kernels.sdim_query.sdim_query import (launch_wide_tile,
                                                           query_backward_splits, sdim_query,
                                                           sdim_query_backward)
    from repro_torch.kernels.sdim_serve.sdim_serve import gather_shape

    for name, (b, c, d) in BWD_QUERY_SHAPES.items():
        q, table, R, dout = query_inputs(torch, dev, rng, b, c, d, TAU, M)
        S = query_backward_splits(b, M // TAU, n_sm)
        print(f"sdim_query_backward {name} (B={b}, C={c}, d={d}, tau={TAU}): {S} slices")
        clock(lib, plain, f"sdim_query_backward {name}",
              partial(sdim_query_backward, dout, q, table, R, TAU),
              "sdim_query_backward_phases", b * S)
    for name, (b, c, d, tau, m) in LT_QUERY_SHAPES.items():
        q, table, R, _ = query_inputs(torch, dev, rng, b, c, d, tau, m,
                                      own=name.startswith("phase20"))
        cands, teams = gather_shape(b, c, m // tau, n_sm)
        print(f"sdim_query large tau {name} (B={b}, C={c}, d={d}): {cands} candidates and "
              f"{teams} groups a CTA")
        clock(lib, plain, f"sdim_query_lt {name}", partial(sdim_query, q, table, R, tau),
              "sdim_query_large_tau_phases", b * -(-c // cands))
    for name, (b, c, d) in WIDE_SHAPES.items():
        q, table, R = wide_inputs(torch, dev, rng, b, c, d)
        tile = launch_wide_tile(b, c, M // TAU, d, TAU, table.dtype, dev)
        print(f"sdim_query wide path {name} (B={b}, C={c}, d={d}): {tile} candidates a CTA")
        clock(lib, plain, f"sdim_query_wide {name}", partial(sdim_query, q, table, R, TAU),
              "sdim_query_phases", b * -(-c // tile))


def query_times(src: str) -> int:
    """``query`` mode (module docstring)."""
    import torch
    if not torch.cuda.is_available():
        print("phase_clocks: torch.cuda.is_available() is False", file=sys.stderr)
        return 3
    sys.path.insert(0, os.path.abspath(src))
    from functools import partial

    from repro_torch.kernels.sdim_query.sdim_query import (sdim_query, sdim_query_backward,
                                                           sdim_query_backward_cuda,
                                                           sdim_query_backward_ref,
                                                           sdim_query_ref)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"query kernels with the port at {os.path.abspath(src)}")
    runs = [(f"sdim_query_backward {name} (B={b}, C={c}, d={d}, tau={TAU})", TAU, M, b, c, d,
             False, sdim_query_backward, sdim_query_backward_ref)
            for name, (b, c, d) in BWD_QUERY_SHAPES.items()]
    runs += [(f"sdim_query {name} (B={b}, C={c}, d={d})", tau, m, b, c, d,
              name.startswith("phase20"), sdim_query, sdim_query_ref)
             for name, (b, c, d, tau, m) in LT_QUERY_SHAPES.items()]
    for label, tau, m, b, c, d, own, kernel, ref in runs:
        q, table, R, dout = query_inputs(torch, dev, np.random.default_rng(33), b, c, d, tau, m,
                                         own)
        args = (dout, q, table, R, tau) if kernel is sdim_query_backward else (q, table, R, tau)
        # the backward's rows compared times their n (a zero row's gradient is g / 1e-6)
        n = (torch.sqrt(torch.sum(table * table, -1, keepdim=True) + 1e-12)
             if kernel is sdim_query_backward else 1.0)
        err = float(((kernel(*args) - ref(*args)) * n).abs().max())
        ms = [device_ms(partial(kernel, *args)) for _ in range(3)]
        print(f"{label}: device ms a launch {ms[0]:.4f} {ms[1]:.4f} {ms[2]:.4f} (median "
              f"{sorted(ms)[1]:.4f}); max abs err {err:.3g}")
        if kernel is sdim_query_backward:   # each split the wrapper could take
            by_split = {S: device_ms(partial(sdim_query_backward_cuda, *args, S))
                        for S in BWD_QUERY_SPLITS if S <= m // tau}
            print(f"  device ms a launch by group slices a user: "
                  f"{ {S: round(v, 4) for S, v in by_split.items()} }")
    return 0


def large_tau_training(lib, plain, dev, rng, n_sm) -> None:
    """The large-tau training kernels at LT_TRAIN_SHAPES: bse_encode's
    forward (front-padded histories, as chip_smoke.py phase 20 (a): Table
    4's with 0..L/2 leading rows masked, the ingest's L/2..L valid rows and
    its last user masked) and, at Table 4's shape only (training), the
    backward of sdim_query in the table (one candidate a user) and
    bse_encode_backward's large-tau path on that gradient."""
    import torch
    from functools import partial

    from repro_torch.kernels.screen import screened_normal
    from repro_torch.kernels.sdim_bucket.sdim_bucket import (bse_encode_backward,
                                                             bse_encode_cuda, bse_encode_ref,
                                                             encode_large_tau_splits,
                                                             launch_large_tau_split)
    from repro_torch.kernels.sdim_query.sdim_query import (query_backward_large_tau_splits,
                                                           sdim_query_backward,
                                                           sdim_query_backward_ref)

    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    for shape, (b, l, c, d) in LT_TRAIN_SHAPES.items():
        for tau, m in LT_SHAPES[:2]:
            G, U = m // tau, 1 << tau
            Rn = rng.standard_normal((m, d)).astype(np.float32)
            R = t(Rn)
            seq = t(screened_normal(rng, (b, l, d), Rn))
            lo = (rng.integers(0, l // 2, b) if shape == "table4"
                  else l - rng.integers(l // 2, l + 1, b))
            mask = (np.arange(l)[None] >= lo[:, None]).astype(np.float32)
            if shape == "ingest":
                mask[-1] = 0.0
            mask = t(mask)
            Gs, slices, threads = encode_large_tau_splits(b, G, U, l, d, tau, n_sm)
            name = f"tau={tau} m={m} {shape} (B={b}, L={l}, d={d})"
            print(f"bse_encode large tau {name}: Gs = {Gs}, {slices} slices, {threads} threads")
            clock(lib, plain, f"bse_encode_lt {name}", partial(bse_encode_cuda, seq, mask, R, tau),
                  "sdim_bse_encode_large_tau_phases", b * slices)
            if shape != "table4":
                continue
            q = t(screened_normal(rng, (b, c, d), Rn))
            table = bse_encode_ref(seq, mask, R, tau)
            dout = t(rng.standard_normal((b, c, d)).astype(np.float32))
            Gs, slices, threads = query_backward_large_tau_splits(b, G, U, c, d, tau, n_sm)
            print(f"sdim_query_backward large tau {name}, C = {c}: Gs = {Gs}, {slices} slices, "
                  f"{threads} threads")
            clock(lib, plain, f"sdim_query_backward_lt {name}",
                  partial(sdim_query_backward, dout, q, table, R, tau),
                  "sdim_query_large_tau_phases", b * slices)
            dT = sdim_query_backward_ref(dout, q, table, R, tau)
            staged, S = launch_large_tau_split(b, l, G, d, tau, seq.dtype, dev)
            print(f"bse_encode_backward large tau {name}: dT {'staged' if staged else 'gathered'}"
                  f", {S} CTAs a user")
            clock(lib, plain, f"bse_encode_backward_lt {name}",
                  partial(bse_encode_backward, dT, seq, mask, R, tau),
                  "sdim_bse_encode_backward_large_tau_phases", b * S)


def large_tau(lib, plain, dev, rng, n_sm) -> None:
    """The large-tau serving paths at chip_smoke.py phase 20 (a)'s shapes
    (B = 16, L = 1024 with L/2..L valid rows, the last user masked, C = 128
    with half of each user's candidates its own behaviors, d = 128):
    bse_serve at tau 5, 10 and tau = 1, m = 48 (both kernels: kernel 2's
    rows from CTAS / 2 on), sdim_fused_serve at tau 5 and 10 off fp32 and
    int8 stores of the users' encoded histories (user 1 absent)."""
    import torch
    from functools import partial

    from repro_torch.kernels.screen import screened_normal
    from repro_torch.kernels.sdim_bucket.sdim_bucket import bse_encode_ref
    from repro_torch.kernels.sdim_fused_serve.sdim_fused_serve import sdim_fused_serve
    from repro_torch.kernels.sdim_serve.sdim_serve import (bse_serve, gather_shape,
                                                           serve_large_tau_splits)
    from repro_torch.serve.quant import quantize_rows

    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    gather_ctas = lambda G: B * -(-C // gather_shape(B, C, G, n_sm)[0])
    for tau, m in LT_SHAPES:
        G, U = m // tau, 1 << tau
        Rn = rng.standard_normal((m, D)).astype(np.float32)
        R = t(Rn)
        seq = screened_normal(rng, (B, L, D), Rn)
        mask = (np.arange(L)[None] >= rng.integers(0, L // 2, B)[:, None]).astype(np.float32)
        mask[-1] = 0.0
        q = screened_normal(rng, (B, C, D), Rn)
        for b in range(B - 1):
            q[b, :C // 2] = seq[b, rng.choice(np.flatnonzero(mask[b]), C // 2)]
        seq, mask, q = t(seq), t(mask), t(q)
        Gs, slices, K, chunks = serve_large_tau_splits(B, G, U, C, D, tau, n_sm)
        name = f"tau={tau} m={m} d={D}"
        print(f"bse_serve large tau {name}: kernel 1 Gs = {Gs}, {slices} slices, K = {K}, "
              f"{chunks} chunks")
        fn = partial(bse_serve, q, seq, mask, R, tau)
        clock(lib, plain, f"bse_serve_lt_table {name}", fn,
              "sdim_bse_serve_large_tau_phases", B * slices * chunks,
              also=[(f"bse_serve_lt_gather {name}", gather_ctas(G), CTAS // 2)])
        if tau < 5:
            continue
        rows = bse_encode_ref(seq, mask, R, tau)
        slots = torch.arange(B, dtype=torch.int32, device=dev)
        present = torch.ones(B, device=dev)
        present[1] = 0.0
        int8, scales = quantize_rows(rows, dtype=torch.int8)
        for label, store, sc in (("fp32", rows, None), ("int8", int8, scales)):
            clock(lib, plain, f"sdim_fused_serve_lt {name} {label}",
                  partial(sdim_fused_serve, store, slots, q, R, tau, scales=sc, present=present),
                  "sdim_fused_serve_large_tau_phases", gather_ctas(G))


def clock(lib, plain, name, fn, reader, n_cta, also=(), apart=()) -> None:
    """Phase cycles of one launch after three warm-up launches (``also``:
    (name, CTAs, first row) of a second kernel the call launches, reported
    from the same reader; ``apart``: (label, CTA indices) of CTAs also
    reported on their own), the device time a launch without the clocks,
    and the wrapper's host time a call."""
    import torch
    from repro_torch.kernels import _build

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    fn()
    torch.cuda.synchronize()
    rows = read_phases(lib, reader, n_cta)
    report(name, rows)
    for label, ctas in apart:
        report(f"{name} {label}", rows[ctas])
    for other, n, first in also:
        report(other, read_phases(lib, reader, n, first))
    _build._lib = plain          # the port's library: device time, no clocks
    print(f"  device time a launch without the clocks: {device_ms(fn):.4f} ms")
    _build._lib = lib
    host = []
    for _ in range(50):          # the wrapper's host time a launch
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    print(f"  wrapper host time a call: median {1e6 * np.median(host):.1f} us")


def fold_inputs(torch, dev, rng, n, l, d):
    """Folded users as chip_smoke.py phase 3 draws them: q (n, 1, d), seq
    (n, l, d), valid rows first (top-k order) with 0..l of them, the first
    user none and the second all."""
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    q = t(rng.standard_normal((n, 1, d)).astype(np.float32))
    seq = t(rng.standard_normal((n, l, d)).astype(np.float32))
    found = rng.integers(0, l + 1, n)
    found[:2] = (0, l)
    return q, seq, t((np.arange(l)[None] < found[:, None]).astype(np.float32))


def smoke_bursts() -> dict:
    """chip_smoke.py phase 20 (a)'s event bursts, replayed: its generator
    (seed 20) drawn in its order up to each burst (R, the served users'
    histories and candidates, the store's histories), as numpy arrays
    {(d, tau): (R, slots, events, mask)}; 16 batch rows of E = 16 screened
    events on random slots of LT_EV users, 20% of events masked, row 0
    wholly. The store's rows are not replayed (a fold's time does not
    depend on them)."""
    from repro_torch.kernels.screen import screened_normal

    rng, out = np.random.default_rng(20), {}
    for d in (D, 36):
        for tau, m in LT_SHAPES if d == D else LT_SHAPES[:2]:
            R = rng.standard_normal((m, d)).astype(np.float32)
            screened_normal(rng, (B, L, d), R)                      # the served histories
            valid = np.arange(L)[None] >= rng.integers(0, L // 2, B)[:, None]
            screened_normal(rng, (B, C, d), R)                      # the candidates
            for b in range(B - 1):                                  # half of them own rows
                rng.choice(np.flatnonzero(valid[b]), C // 2)
            if tau == 1:
                continue
            screened_normal(rng, (LT_EV, L, d), R)                  # the store's histories
            slots = rng.integers(0, LT_EV, B).astype(np.int32)
            events = screened_normal(rng, (B, E, d), R)
            mask = (rng.random((B, E)) > 0.2).astype(np.float32)
            mask[0] = 0.0
            out[d, tau] = (R, slots, events, mask)
    return out


def distinct_slots(slots: np.ndarray) -> np.ndarray:
    """``slots`` with every repeat of a slot moved to a slot no row uses."""
    out, free = slots.copy(), iter(sorted(set(range(LT_EV)) - set(slots.tolist())))
    seen = set()
    for b, s in enumerate(slots.tolist()):
        if s in seen:
            out[b] = next(free)
        seen.add(s)
    return out


def fold_times(src: str) -> int:
    """``fold`` mode (module docstring)."""
    import torch
    if not torch.cuda.is_available():
        print("phase_clocks: torch.cuda.is_available() is False", file=sys.stderr)
        return 3
    sys.path.insert(0, os.path.abspath(src))
    from functools import partial

    from repro_torch.kernels import _build
    from repro_torch.kernels.sdim_update import sdim_update as ku
    from repro_torch.kernels.target_attn import target_attn as ta

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"target_attention_flash (folded shapes) and sdim_update (large tau) with the port at "
          f"{os.path.abspath(src)}")
    rounds = lambda fn: [device_ms(fn) for _ in range(3)]
    line = lambda ms: (f"{ms[0]:.4f} {ms[1]:.4f} {ms[2]:.4f} (median {sorted(ms)[1]:.4f})")
    has_fold = hasattr(ta, "forward_split")
    clocked = []                     # (name, fn, reader, CTAs, apart): the phase cycles
    for name, (n, l, d) in FOLD_SHAPES.items():
        q, seq, mask = fold_inputs(torch, dev, np.random.default_rng(35), n, l, d)
        fn = partial(ta.target_attention_flash, q, seq, mask)
        err = float((fn() - ta.target_attention_flash_ref(q, seq, mask)).abs().max())
        print(f"target_attention_flash {name} ({n} users, L={l}, C=1, d={d}): device ms a launch "
              f"{line(rounds(fn))}; max abs err {err:.3g}")
        if has_fold:                 # each CTA shape of the folded body, and the cluster body
            lib, out = _build.load(), torch.empty_like(q)

            def shaped(upc):
                err = lib.sdim_target_attention(q.data_ptr(), seq.data_ptr(), 0, mask.data_ptr(),
                                                out.data_ptr(), n, l, 1, d, ta._scale(d), upc,
                                                _build.stream(dev))
                _build.check(err, "target_attention_flash")

            upc = ta.forward_split(n, l, 1, _build.sm_count(dev))
            by = {u: sorted(rounds(partial(shaped, u)))[1] for u in FOLD_USERS + (0,)}
            print(f"  the wrapper's users a CTA: {upc}; device ms by users a CTA (0: the cluster "
                  f"body): { {k: round(v, 4) for k, v in by.items()} }")
            clocked.append((f"target_attention_folded {name}", fn,
                            "sdim_target_attention_phases", -(-n // upc), ()))
    b, l, c, d = FOLD_MAIN
    q = torch.randn((b, c, d), device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    seq, mask = fold_inputs(torch, dev, np.random.default_rng(36), b, l, d)[1:]
    fn = partial(ta.target_attention_flash, q, seq, mask)
    print(f"target_attention_flash main burst (B={b}, L={l}, C={c}, d={d}): device ms a launch "
          f"{line(rounds(fn))}; max abs err "
          f"{float((fn() - ta.target_attention_flash_ref(q, seq, mask)).abs().max()):.3g}")
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    bursts = smoke_bursts()
    for d in (D, 36):
        for tau, m in LT_SHAPES[:2]:
            R, drawn, events, mask = (t(x) for x in bursts[d, tau])
            G = m // tau
            store = t(np.random.default_rng(37).standard_normal((LT_EV, G, 1 << tau, d))
                      .astype(np.float32))
            for label, slots in (("chip_smoke's draw", bursts[d, tau][1]),
                                 ("duplicates moved", distinct_slots(bursts[d, tau][1]))):
                args = (t(slots), events, mask, R, tau)
                err = float((ku.sdim_update(store.clone(), *args)
                             - ku.sdim_update_ref(store.clone(), *args)).abs().max())
                fn = partial(ku.sdim_update, store, *args)
                rows = {b: int((slots == s).sum()) for b, s in enumerate(slots.tolist())
                        if s not in slots[:b]}
                owners = {b: n for b, n in rows.items() if n > 1}
                print(f"sdim_update large tau tau={tau} m={m} d={d}, {label} (B={B}, E={E}, "
                      f"{len(rows)} slots; owners of several rows, b: rows {owners}): device ms a "
                      f"launch {line(rounds(fn))}; event ms a call (host work included) "
                      f"{line([event_ms(fn) for _ in range(3)])}; max abs err {err:.3g}")
                if d == D:
                    apart = tuple((f"owner of {n} rows (b={b})", [g * B + b for g in range(G)])
                                  for b, n in owners.items())
                    clocked.append((f"sdim_update_lt tau={tau} m={m} d={d} {label}", fn,
                                    "sdim_update_large_tau_phases", B * G, apart))
    if has_fold:                     # the phase cycles (the marks are this port's)
        plain = _build.load()
        clocks = _build.bind(_build.build(("-DSDIM_PHASE_CLOCKS",)))
        for name, fn, reader, n_cta, apart in clocked:
            _build._lib = clocks
            clock(clocks, plain, name, fn, reader, n_cta, apart=apart)
        _build._lib = plain
    return 0


# training-step modes: (label, interest kind, interest settings) of each model
TABLE4_CASES = tuple((f"table4 tau={tau} m={m}", "sdim", dict(m=m, tau=tau))
                     for tau, m in ((3, 48), (5, 45), (10, 40)))
TABLE23_CASES = (("table23 target", "target", {}),
                 ("table23 sim_hard", "sim_hard", dict(top_k=16)),
                 ("table23 sdim", "sdim", dict(m=48, tau=3)))
# device op names (substrings) whose device ms a step table4 and table23 print:
# the SDIM backward kernels, the target backward and sdim_query's large-tau forward
STEP_KERNELS = ("ta_bwd", "bse_encode_backward", "sdim_query_backward_kernel",
                "query_large_tau_kernel")


def train_steps(src: str, mode: str, cases, steps: int = 20) -> int:
    """``table4`` and ``table23`` modes (module docstring)."""
    import torch
    if not torch.cuda.is_available():
        print("phase_clocks: torch.cuda.is_available() is False", file=sys.stderr)
        return 3
    sys.path.insert(0, os.path.abspath(src))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.bench.common import paper_data_config, paper_model_config, train
    from repro_torch.models.ctr import CTRModel

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dcfg = paper_data_config(256)
    print(f"{mode} steps with the port at {os.path.abspath(src)}")
    for label, kind, interest in cases:
        model = CTRModel(paper_model_config(kind, 256, **interest), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
        train(model, dcfg, 3, 128, 0, 5e-3)
        ms = 1e3 * train(model, dcfg, steps + 1, 128, 1, 5e-3)["train_s"] / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            train(model, dcfg, 6, 128, 2, 5e-3)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6
        spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and e.time_range.end > e.time_range.start)
        busy, end, by_name = 0.0, float("-inf"), {}
        for a, b, name in spans:
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
            by_name[name] = by_name.get(name, 0.0) + (b - a)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        kernels = {k: sum(us for name, us in by_name.items() if k in name) / 1e3
                   for k in STEP_KERNELS}
        print(f"{label}: {ms:.3f} ms/step ({steps} steps, host clock); "
              f"6 steps under torch.profiler: wall {wall / 1e3:.3f} ms, device busy "
              f"{busy / 1e3:.3f} ms ({100 * busy / wall:.1f}%), {len(spans)} device ops; "
              f"device ms of {kernels}; top 5:")
        for name, us in top:
            print(f"  {us / 1e3:8.4f} ms  {100 * us / wall:5.1f}%  {name[:90]}")
        del model
    return 0


def smoke_kernels(src: str) -> int:
    """``smoke_kernels`` mode (module docstring)."""
    import json

    import torch
    if not torch.cuda.is_available():
        print("phase_clocks: torch.cuda.is_available() is False", file=sys.stderr)
        return 3
    tree = os.path.dirname(os.path.abspath(src))
    sys.path.insert(0, os.path.abspath(src))
    sys.path.insert(0, tree)
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"chip_smoke's kernel checks of {tree}; {cs.card_line()}")
    out = {"d128": cs.kernel_phase(torch, dev), "d36": cs.kernel_phase(torch, dev, cs.D36),
           "large_tau": cs.large_tau_kernel_checks(torch, dev),
           "spill": cs.spill_kernel_checks(torch, dev)}
    if hasattr(cs, "wide_kernel_checks"):
        out["wide"] = cs.wide_kernel_checks(torch, dev)
        out["wide_launches"] = cs.wide_phase(torch, dev, cs.all_wrappers()[:6])
    print("SMOKE_KERNELS_JSON " + json.dumps(out, default=str))
    return 0


READS_PAST = ((500, 4, 128), (48, 4, 256))   # (m, tau, d)


def reads_past(src: str) -> int:
    """``reads_past`` mode (module docstring)."""
    import torch
    if not torch.cuda.is_available():
        print("phase_clocks: torch.cuda.is_available() is False", file=sys.stderr)
        return 3
    sys.path.insert(0, os.path.abspath(src))
    from functools import partial

    from repro_torch.kernels.screen import screened_normal
    from repro_torch.kernels.sdim_fused_serve.sdim_fused_serve import (sdim_fused_serve,
                                                                       sdim_fused_serve_ref)
    from repro_torch.kernels.sdim_query.sdim_query import sdim_query, sdim_query_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"reads past the fused body with the port at {os.path.abspath(src)}")
    rng = np.random.default_rng(37)
    for m, tau, d in READS_PAST:
        R = rng.standard_normal((m, d)).astype(np.float32)
        q = torch.from_numpy(screened_normal(rng, (4, 70, d), R)).to(dev)
        store = torch.from_numpy(rng.standard_normal((6, m // tau, 1 << tau, d))
                                 .astype(np.float32)).to(dev)
        slots = torch.tensor([5, 0, 3, 3], dtype=torch.int32, device=dev)
        Rt = torch.from_numpy(R).to(dev)
        table = store[slots.long()].contiguous()
        calls = {"sdim_query": (partial(sdim_query, q, table, Rt, tau),
                                partial(sdim_query_ref, q, table, Rt, tau)),
                 "sdim_fused_serve": (partial(sdim_fused_serve, store, slots, q, Rt, tau),
                                      partial(sdim_fused_serve_ref, store, slots, q, Rt, tau))}
        for name, (kernel, plain) in calls.items():
            try:
                err = float((kernel() - plain()).abs().max())
                torch.cuda.synchronize()
                print(f"reads_past {name} m={m} tau={tau} d={d}: max abs err {err:.3g}")
            except (RuntimeError, ValueError) as e:
                print(f"reads_past {name} m={m} tau={tau} d={d}: {type(e).__name__}: {e}")
    return 0


def ta_bwd_errors(n_draws: int) -> int:
    """``ta_bwd_err`` mode (module docstring)."""
    import torch
    if not torch.cuda.is_available():
        print("phase_clocks: torch.cuda.is_available() is False", file=sys.stderr)
        return 3
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.target_attention import default_scale
    from repro_torch.kernels.screen import screened_normal
    from repro_torch.kernels.target_attn.target_attn import (target_attention_flash,
                                                             target_attention_flash_backward,
                                                             target_attention_flash_backward_ref)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    Bn, Ln, Cn, d, m = 32, 16, 128, 128, 48
    rng = np.random.default_rng(9)
    R = rng.standard_normal((m, d)).astype(np.float32)
    seq = torch.from_numpy(screened_normal(rng, (Bn, Ln, d), R)).to(dev)
    q = torch.from_numpy(screened_normal(rng, (Bn, Cn, d), R)).to(dev)
    rng.random((Bn, Ln))                        # the test's random mask, then re-drawn front
    lengths = torch.from_numpy(rng.integers(1, max(Ln // 3, 1) + 1, Bn))
    mask = (torch.arange(Ln)[None] >= Ln - lengths[:, None]).float().to(dev)
    mask[-1] = 0
    for C_ in (1, Cn):
        qc = q[:, :C_].contiguous()
        out = target_attention_flash(qc, seq, mask)
        x, qf = seq.double(), qc.double()
        scale = default_scale(d)
        valid = (mask > 0)[:, None, :]
        P = torch.softmax(torch.where(valid, torch.einsum("bcd,bld->bcl", qf, x) * scale,
                                      torch.full((), -1e30, dtype=x.dtype, device=dev)), -1)
        miss = {"kernel - plain": [], "kernel - fp64": [], "plain - fp64": []}
        for k in range(n_draws):
            dout = torch.randn(qc.shape, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(k))
            _, dseq = target_attention_flash_backward(dout, qc, seq, mask, out)
            _, rseq = target_attention_flash_backward_ref(dout, qc, seq, mask, out)
            do = dout.double()
            dS = torch.where(valid, P * (torch.einsum("bcd,bld->bcl", do, x)
                                         - torch.sum(do * out.double(), -1, keepdim=True)),
                             torch.zeros((), dtype=x.dtype, device=dev))
            exact = (torch.einsum("bcl,bcd->bld", P, do)
                     + scale * torch.einsum("bcl,bcd->bld", dS, qf))
            for key, got, want in (("kernel - plain", dseq.double(), rseq.double()),
                                   ("kernel - fp64", dseq.double(), exact),
                                   ("plain - fp64", rseq.double(), exact)):
                excess = float(((got - want).abs() - 1e-5 * want.abs()).max())
                miss[key].append(excess)
        torch.cuda.synchronize()
        for key, ex in miss.items():
            ex = np.asarray(ex)
            print(f"ta_bwd_err C={C_} {key}: {int((ex > 1e-5).sum())} of {n_draws} draws past "
                  f"atol 1e-5 + rtol 1e-5; largest |err| - 1e-5 |ref| {ex.max():.3g}, median "
                  f"{np.median(ex):.3g}")
    return 0


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    args = sys.argv[2:]
    src = args[args.index("--src") + 1] if "--src" in args else os.path.join(ROOT, "src")
    if mode == "table4":
        sys.exit(train_steps(src, "table4", TABLE4_CASES))
    if mode == "table23":
        sys.exit(train_steps(src, "table23", TABLE23_CASES))
    if mode == "query":
        sys.exit(query_times(src))
    if mode == "bwd_wide":
        sys.exit(bwd_wide_times(src))
    if mode == "fold":
        sys.exit(fold_times(src))
    if mode == "smoke_kernels":
        sys.exit(smoke_kernels(src))
    if mode == "reads_past":
        sys.exit(reads_past(src))
    if mode == "ta_bwd_err":
        sys.exit(ta_bwd_errors(int(args[0]) if args else 200))
    sys.exit(main())
