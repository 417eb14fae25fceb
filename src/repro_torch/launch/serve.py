"""Serving launcher of the port:

    python -m repro_torch.launch.serve --arch sdim-paper --requests N \\
        --candidates C --micro-batch B [--fused-serve] \\
        [--table-dtype fp32|bf16|int8|fp8] [--device cuda|cpu]

Mirrors the recsys branch of ``repro/launch/serve.py``: the ``SMOKE``
config, random weights from a seeded ``torch.Generator``, a BSE + CTR
server pair in the decoupled deployment (an ``sdim`` model) or a CTR server
that scores raw histories inline (any other interest kind), and a loop over
synthetic requests (served one by one, or in micro-batches). Runs on the card unless
``--device cpu`` is given; without CUDA and without that flag it fails.
Tiers, sharding, async ingest, admission, tracing and profiling are not
ported yet.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.serve.quant import TABLE_DTYPES


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--candidates", type=int, default=128)
    p.add_argument("--micro-batch", type=int, default=1,
                   help="serve requests in bursts of this size: one "
                        "fetch_many + one scoring pass per burst")
    p.add_argument("--fused-serve", action="store_true",
                   help="serve micro-batches through the fused "
                        "gather+dequant+query kernel")
    p.add_argument("--table-dtype", default="fp32", choices=sorted(TABLE_DTYPES),
                   help="BSE table STORAGE dtype (int8/fp8 quantize on write "
                        "with per-row scales)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if args.fused_serve and args.micro_batch < 2:
        p.error("--fused-serve rides the micro-batched path; give --micro-batch >= 2")

    from repro_torch.data.synthetic import SyntheticCTRConfig, generate_batch
    from repro_torch.device import resolve_device
    from repro_torch.models.ctr import CTRModel
    from repro_torch.serve.ctr_server import CTRServer

    device = resolve_device(args.device)
    cfg = registry.get(args.arch).SMOKE
    gen = torch.Generator(device=device).manual_seed(0)
    model = CTRModel(cfg, device=device, generator=gen)
    mode = "decoupled" if cfg.interest.kind == "sdim" else "inline"
    if mode != "decoupled" and (args.table_dtype != "fp32" or args.fused_serve):
        p.error(f"--table-dtype/--fused-serve configure the BSE table store, which "
                f"only the decoupled (sdim) deployment has; arch {args.arch!r} "
                f"serves {mode!r}")
    server = CTRServer.build(model, None, mode, table_dtype=args.table_dtype,
                             fused=args.fused_serve, device=device)
    print(f"SDIM engine on {device}"
          f"{' (' + torch.cuda.get_device_name(device) + ')' if device.type == 'cuda' else ''}")
    dcfg = SyntheticCTRConfig(hist_len=cfg.long_len, n_items=cfg.n_items,
                              n_cats=cfg.n_cats)
    rng = np.random.default_rng(0)
    pending = []  # micro-batch buffer of (req_id, request tuple)

    def report(r, scores):
        print(f"req {r}: top candidate {int(np.argmax(scores))} "
              f"(score {float(np.max(scores)):+.3f})")

    def flush():
        for (r, _), scores in zip(pending, server.handle_requests([q for _, q in pending])):
            report(r, scores)
        pending.clear()

    for r in range(args.requests):
        raw = generate_batch(dcfg, 1, r)
        user = {k: v for k, v in raw.items() if k.startswith("hist")}
        ci = rng.integers(0, cfg.n_items, args.candidates).astype(np.int32)
        cc = rng.integers(0, cfg.n_cats, args.candidates).astype(np.int32)
        req = (f"u{r}", user, ci, cc, np.zeros((args.candidates, cfg.ctx_dim), np.float32))
        if args.micro_batch > 1:
            pending.append((r, req))
            if len(pending) == args.micro_batch:
                flush()
            continue
        report(r, server.handle_request(*req))
    if pending:
        flush()
    table = ("" if server.bse is None else
             f"; table {server.bse.table_bytes()} B ({args.table_dtype} storage)")
    print(f"{server.stats.ms_per_request:.1f} ms/request"
          f"{' (fused serve)' if args.fused_serve else ''} ({mode}){table}")


if __name__ == "__main__":
    main()
