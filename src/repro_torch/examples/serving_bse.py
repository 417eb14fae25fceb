"""Serving scenario (paper §4.4 / Fig. 1): BSE server + CTR server,
batched candidate requests + real-time behavior events.

    PYTHONPATH=src python -m repro_torch.examples.serving_bse [--candidates 512] [--T 2000] [--device cpu]

Counterpart of ``examples/serving_bse.py``. Simulates the production flow:

1. users' histories are encoded into fixed-size bucket tables (BSE), all
   users in ONE batched ``ingest_histories`` dispatch into the TableStore
   (the ``bse_encode`` kernel on the card);
2. requests score candidates via hash + gather (``sdim_query``; the
   inline server, which re-reads the raw history, runs ``bse_serve``);
3. new behavior events fold into tables incrementally (``sdim_update``),
   and batched: ``ingest_events`` folds one event per user per dispatch;
4. a request burst is micro-batched: ``handle_requests`` turns N requests
   into one ``fetch_many`` gather + one scoring dispatch.

Asserts, as the reference: before a user's first event, decoupled and
inline scores agree within 0.1 (the bf16 wire); the micro-batched burst
agrees with per-user requests within 1e-4. Runs on the card unless
``--device cpu`` is given (``--device`` in place of the reference's
``--backend``: the device decides kernel or plain version).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.interest import InterestConfig
from repro_torch.data.synthetic import SyntheticCTRConfig, generate_batch
from repro_torch.device import resolve_device
from repro_torch.models.ctr import CTRConfig, CTRModel
from repro_torch.serve.ctr_server import CTRServer


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--candidates", type=int, default=512)
    p.add_argument("--T", type=int, default=2000, help="behavior history length")
    p.add_argument("--users", type=int, default=4)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    dcfg = SyntheticCTRConfig(hist_len=args.T, n_items=10000, n_cats=100)
    cfg = CTRConfig(arch="din", n_items=10000, n_cats=100, long_len=args.T,
                    short_len=50, mlp_hidden=(256, 128),
                    interest=InterestConfig(kind="sdim", m=48, tau=3))
    model = CTRModel(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    print(f"SDIM engine on {dev} ({'CUDA kernels' if dev.type == 'cuda' else 'plain versions'})")

    ctr = CTRServer.build(model, None, "decoupled", device=dev)
    bse = ctr.bse
    inline = CTRServer.build(model, None, "inline", device=dev)

    rng = np.random.default_rng(0)
    users = {}
    for u in range(args.users):
        raw = generate_batch(dcfg, 1, u)
        users[u] = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()
                    if k.startswith("hist")}
    # batched BSE bootstrap: every user's history in ONE encode dispatch
    bse.ingest_histories(
        list(users),
        np.concatenate([users[u]["hist_items"].cpu().numpy() for u in users]),
        np.concatenate([users[u]["hist_cats"].cpu().numpy() for u in users]),
        np.concatenate([users[u]["hist_mask"].cpu().numpy() for u in users]))
    print(f"BSE holds {len(bse.tables)} user tables, "
          f"{bse.table_bytes()} bytes each (L={args.T}; L-free); "
          f"store capacity {bse.store.capacity} slots")

    cand = lambda: (torch.as_tensor(rng.integers(0, 10000, args.candidates).astype(np.int32),
                                    device=dev),
                    torch.as_tensor(rng.integers(0, 100, args.candidates).astype(np.int32),
                                    device=dev),
                    torch.zeros((args.candidates, 4), device=dev))
    has_events, max_gap = set(), 0.0
    for r in range(args.requests):
        u = r % args.users
        ci, cc, ctx = cand()
        s1 = ctr.handle_request(u, users[u], ci, cc, ctx)
        s2 = inline.handle_request(u, users[u], ci, cc, ctx)
        top = int(np.argmax(s1))               # scores come back as host arrays
        if u not in has_events:
            # before live events fold in, decoupled == inline up to the bf16
            # wire quantization of the fetched table; afterwards the BSE
            # table is FRESHER than the static history
            gap = float(np.max(np.abs(s1 - s2)))
            assert gap < 0.1, gap
            max_gap = max(max_gap, gap)
        # real-time event: user clicks the top item -> fold into the table
        bse.ingest_event(u, int(ci[top]), int(cc[top]))
        has_events.add(u)
        print(f"req {r}: user {u} -> top candidate {int(ci[top])} "
              f"(score {float(s1[top]):+.3f}); event folded into BSE")

    print(f"\ndecoupled CTR server: {ctr.stats.ms_per_request:.1f} ms/request "
          f"(fetch {1e3 * ctr.stats.fetch_time_s / max(ctr.stats.n_requests, 1):.2f} ms)")
    print(f"inline (no BSE):      {inline.stats.ms_per_request:.1f} ms/request")
    print(f"bytes moved BSE->CTR: {bse.stats.bytes_transmitted} "
          f"({bse.stats.n_fetches} fetches); events ingested: {bse.stats.n_updates}")

    # ---- micro-batched burst: N requests -> 1 fetch_many + 1 dispatch ----
    burst = [(u, users[u], *cand()) for u in range(args.users)]
    ctr.handle_requests(burst)                        # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    batched_scores = ctr.handle_requests(burst)
    _sync(dev)
    dt = time.perf_counter() - t0
    burst_gap = 0.0
    for (u, _, ci, _, _), s in zip(burst, batched_scores):
        single = ctr.handle_request(u, users[u], ci, burst[u][3], burst[u][4])
        burst_gap = max(burst_gap, float(np.max(np.abs(s - single))))
        assert burst_gap < 1e-4, burst_gap             # batched == per-user
    print(f"burst of {len(burst)} requests micro-batched: "
          f"{1e3 * dt:.1f} ms total ({len(burst) / dt:.0f} users/sec), "
          f"scores match the per-user path")

    # ---- batched real-time events: one event per user, ONE dispatch ----
    ev_items = rng.integers(0, 10000, args.users)
    ev_cats = rng.integers(0, 100, args.users)
    bse.ingest_events(list(users), ev_items, ev_cats)  # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    bse.ingest_events(list(users), ev_items, ev_cats)
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"batched event ingest: {args.users} events in {1e3 * dt:.2f} ms "
          f"({args.users / dt:.0f} events/sec)")
    return {"decoupled_inline_gap": max_gap, "burst_gap": burst_gap,
            "events": bse.stats.n_updates, "fetches": bse.stats.n_fetches,
            "ms_per_request": ctr.stats.ms_per_request}


if __name__ == "__main__":
    main()
