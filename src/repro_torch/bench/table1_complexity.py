"""Table 1 — time complexity of interest-modeling methods, on the port:

    python -m repro_torch.bench.table1_complexity [--full] [--device cpu]

Counterpart of ``benchmarks/table1_complexity.py``. Measures wall time of
the *user-interest op* alone at the paper's serving granularity: one
user's length-L sequence scored against B candidates (their system:
B≈10³, L=1024, m=48, d=128). Sweeps L and B to expose the complexity
classes:

    DIN   O(B·L·d)        — full target attention per candidate
    SIM   O(B·k·d)+filter — category top-k then TA
    ETA   O(B·L·m)+O(B·k·d) — hamming retrieval then TA
    SDIM  O(L·m·log d + B·m·log d), and with BSE decoupling the CTR-server
          part is O(B·m·log d) — L-FREE (the paper's headline property).

The same functions as the reference's, each the port's counterpart:
``core.target_attention.target_attention``, ``core.sdim.sdim_attention``,
``core.bse.encode_sequence`` / ``query_interest`` and
``core.retrieval.eta``. All but ``eta`` are the plain formulation, as the
reference's run under XLA; ``eta`` attends over its retrieved rows
through the ``target_attention_flash`` kernel on the card (the folded
(B, k) shape). Data and R come from seeded ``torch.Generator``s.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch

from repro_torch.bench.common import time_fn
from repro_torch.core import bse, retrieval, sdim, simhash
from repro_torch.core.target_attention import target_attention
from repro_torch.device import DeviceLike, resolve_device


def _normal(seed: int, shape, dev: torch.device) -> torch.Tensor:
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(dev)


@torch.no_grad()
def run(quick: bool = True, device: DeviceLike = "cuda",
        Ls: Optional[Sequence[int]] = None, Bs: Optional[Sequence[int]] = None):
    dev = resolve_device(device)
    d, m, tau, k = 128, 48, 3, 48
    Ls = Ls or ([256, 1024] if quick else [256, 1024, 4096, 16384])
    Bs = Bs or ([128, 1024] if quick else [128, 1024, 4096])
    R = simhash.make_hashes(torch.Generator().manual_seed(0), m, d).to(dev)

    ta = lambda q, s, mk: target_attention(q, s, mk)
    sd = lambda q, s, mk: sdim.sdim_attention(q, s, mk, R, tau)
    enc = lambda s, mk: bse.encode_sequence(s, mk, R, tau)
    qry = lambda t, q: bse.query_interest(t, q, R, tau)
    et = lambda q, s, mk: retrieval.eta(q, s, mk, R, k)

    rows = []
    for L in Ls:
        seq = _normal(1, (1, L, d), dev)
        mask = torch.ones((1, L), device=dev)
        table = enc(seq, mask)
        for B in Bs:
            q = _normal(2, (1, B, d), dev)
            t_ta = time_fn(ta, q, seq, mask)
            t_sdim = time_fn(sd, q, seq, mask)
            t_bse_q = time_fn(qry, table, q)       # CTR-server cost only
            t_eta = time_fn(et, q, seq, mask)
            rows += [
                {"name": f"table1/din_L{L}_B{B}", "us_per_call": t_ta,
                 "derived": "speedup_vs_din=1.0"},
                {"name": f"table1/sdim_L{L}_B{B}", "us_per_call": t_sdim,
                 "derived": f"speedup_vs_din={t_ta / t_sdim:.2f}"},
                {"name": f"table1/sdim_bse_query_L{L}_B{B}", "us_per_call": t_bse_q,
                 "derived": f"speedup_vs_din={t_ta / t_bse_q:.2f}"},
                {"name": f"table1/eta_L{L}_B{B}", "us_per_call": t_eta,
                 "derived": f"speedup_vs_din={t_ta / t_eta:.2f}"},
            ]
    # L-freeness: BSE-query time ratio between largest and smallest L at fixed B
    q_times = {L: [r for r in rows if r["name"] == f"table1/sdim_bse_query_L{L}_B{Bs[-1]}"][0]
               for L in Ls}
    ratio = q_times[Ls[-1]]["us_per_call"] / q_times[Ls[0]]["us_per_call"]
    rows.append({"name": "table1/bse_query_L_scaling", "us_per_call": 0.0,
                 "derived": f"t(L={Ls[-1]})/t(L={Ls[0]})={ratio:.2f}_(1.0=L-free)"})
    return rows


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--full", action="store_true", help="L up to 16,384, B up to 4,096")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    rows = run(quick=not args.full, device=args.device)
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
