"""Tiered BSE serving (paper §4.4 deployed for real): a bounded device-hot
tier backed by host-warm and disk-cold state, with snapshot-restore.

    PYTHONPATH=src python -m repro_torch.examples.tiered_serving [--hot 16] [--users 64] [--device cpu]

Counterpart of ``examples/tiered_serving.py``. Simulates the production
lifecycle the single-tier stores cannot survive:

1. a working set far larger than the hot tier is ingested (``bse_encode``
   on the card): older users demote to the host warm pool and spill to
   on-disk ``.npz`` segments;
2. Zipf request traffic is served in bursts: hot users hit, warm/cold
   users are batch-promoted (one gather + one scatter per burst), and
   real-time events fold in (``sdim_update``);
3. the FULL serving state (all tiers, indices, hash family and stats) is
   snapshotted, the "process" restarts, and the restored server answers
   bit-identically without re-ingesting a single history (asserted).

Runs on the card unless ``--device cpu`` is given (``--device`` in place
of the reference's ``--backend``). The embeddings come from seeded
generators on that device.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.core.engine import EngineConfig, SDIMEngine
from repro_torch.device import resolve_device
from repro_torch.serve.bse_server import BSEServer


@torch.no_grad()
def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--hot", type=int, default=16, help="device-resident user capacity")
    p.add_argument("--users", type=int, default=64, help="working set (ingested users)")
    p.add_argument("--T", type=int, default=256, help="history length")
    p.add_argument("--bursts", type=int, default=8)
    p.add_argument("--policy", default="clock", choices=("clock", "lru"))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if args.users < 2 * args.hot:
        p.error("the working set (--users) should be at least twice the hot tier (--hot)")
    dev = resolve_device(args.device)

    d = 32
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    emb_i = torch.randn((10000, d // 2), generator=gen(1), device=dev)
    emb_c = torch.randn((100, d // 2), generator=gen(2), device=dev)

    def embed(params, items, cats):
        items = torch.as_tensor(items, device=dev).long()
        cats = torch.as_tensor(cats, device=dev).long()
        return torch.cat([emb_i[items % 10000], emb_c[cats % 100]], dim=-1)

    engine = SDIMEngine(EngineConfig(m=48, tau=3, d=d), device=dev)
    root = tempfile.mkdtemp(prefix="tiered-bse-")
    try:
        bse = BSEServer(embed, None, engine, hot_capacity=args.hot,
                        warm_capacity=2 * args.hot, policy=args.policy,
                        store_dir=os.path.join(root, "cold"), device=dev)
        print(f"engine on {dev}; hot capacity {bse.store.hot_capacity} users, "
              f"policy {args.policy}, cold segments under {root}/cold")

        # ---- 1. ingest a working set that cannot fit the hot tier ----------
        rng = np.random.default_rng(0)
        for lo in range(0, args.users, args.hot):
            us = list(range(lo, min(lo + args.hot, args.users)))
            bse.ingest_histories(us, rng.integers(0, 10000, (len(us), args.T)),
                                 rng.integers(0, 100, (len(us), args.T)))
        print(f"ingested {args.users} users -> tiers {bse.store.tier_sizes()} "
              f"({bse.store.cold.n_segments} cold segments on disk)")

        # ---- 2. Zipf burst traffic: batched promote on miss ----------------
        zipf = 1.0 / (np.arange(1, args.users + 1) ** 1.1)
        zipf /= zipf.sum()
        for _ in range(args.bursts):
            users = [int(u) for u in rng.choice(args.users, args.hot, p=zipf)]
            bse.fetch_many(users)
            ev = rng.integers(0, 10000, len(users))
            bse.ingest_events(users, ev, ev % 100)      # real-time folds ride along
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ts = bse.store.stats
        print(f"{args.bursts} bursts x {args.hot} users: hit-rate "
              f"{ts.hit_rate:.2f}, promotions {ts.warm_promotions} warm / "
              f"{ts.cold_promotions} cold, demotions {ts.demotions}; "
              f"{ts.n_hot_gathers} hot gathers + {ts.n_hot_scatters} hot "
              f"scatters total (batched — never one per user)")
        print(f"bytes moved: promote {ts.promote_bytes}, demote "
              f"{ts.demote_bytes}, spilled {ts.spill_bytes}")

        # ---- 3. snapshot -> "restart" -> restore ---------------------------
        snap = os.path.join(root, "snapshot")
        bse.snapshot(snap)
        restored = BSEServer.restore(snap, embed, None, engine, device=dev)
        probe = [int(u) for u in rng.choice(args.users, args.hot, replace=False)]
        live = bse.fetch_many(probe).cpu()
        back = restored.fetch_many(probe).cpu()
        assert torch.equal(live, back), "restore must be bit-identical"
        print(f"snapshot -> restore: {len(restored.store)} users back "
              f"({restored.store.tier_sizes()}), fetch_many bit-identical, "
              f"zero histories re-encoded")
        return {"tiers": bse.store.tier_sizes(), "hit_rate": ts.hit_rate,
                "restored_users": len(restored.store), "cold_promotions": ts.cold_promotions,
                "warm_promotions": ts.warm_promotions}
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
