"""Figure 5 — estimation quality vs number of hashes m, on the port:

    python -m repro_torch.bench.fig5_m_sweep [--smoke | --full] [--device cpu]

Counterpart of ``benchmarks/fig5_m_sweep.py``. Two measurements:
  * direct estimator error: cosine distance between sampled SDIM output and
    the closed-form expectation (Eq. 14) — converges as m grows, with the
    paper's observation that m/τ ≥ 16 (m ≥ 48 at τ=3) suffices;
  * AUC of trained models at each m (quick mode keeps the m-grid small).

The draws of seq, q and R come from a seeded ``torch.Generator`` (torch
cannot replay ``jax.random``); ``estimator_error_of`` takes them as
arguments, so a test can pass the JAX package's draws in.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.bench.common import train_and_eval
from repro_torch.core import sdim, simhash
from repro_torch.device import DeviceLike, resolve_device

MS = [6, 12, 24, 48, 96, 192]


def estimator_error_of(seq: torch.Tensor, q: torch.Tensor, R: torch.Tensor,
                       tau: int) -> float:
    """Mean cosine distance between sampled SDIM (``sdim_attention``) and
    its expectation (``sdim_expected_attention``, Eq. 14) for q (B, d)
    against seq (B, L, d) under the hash family R (m, d)."""
    out = sdim.sdim_attention(q, seq, None, R, tau)
    exp = sdim.sdim_expected_attention(q, seq, None, tau)
    o = sdim.l2_normalize(out)
    e = sdim.l2_normalize(exp)
    return float(torch.mean(1.0 - torch.sum(o * e, -1)))


def estimator_error(m: int, tau: int = 3, trials: int = 8,
                    device: DeviceLike = "cuda") -> float:
    dev = resolve_device(device)
    d, L, B = 32, 256, 16
    errs = []
    for t in range(trials):
        gen = torch.Generator().manual_seed(t)
        seq = torch.randn((B, L, d), generator=gen)
        q = torch.randn((B, d), generator=gen)
        R = simhash.make_hashes(gen, m, d)
        errs.append(estimator_error_of(seq.to(dev), q.to(dev), R.to(dev), tau))
    return float(np.mean(errs))


def run(quick: bool = True, smoke: bool = False, device: DeviceLike = "cuda"):
    """``smoke``: pipeline-proof depth only (AUCs not meaningful)."""
    dev = resolve_device(device)
    rows = []
    tau = 3
    steps = (60 if smoke else 400) if quick else 1500
    ev = 1024 if smoke else 4096
    for m in MS:
        err = estimator_error(m, tau, trials=2 if smoke else 8, device=dev)
        rows.append({"name": f"fig5/estimator_err_m{m}", "us_per_call": 0.0,
                     "derived": f"cos_dist_to_Eq14={err:.4f};groups={m // tau}"})
    train_ms = ([48] if smoke else [12, 48]) if quick else [12, 24, 48, 96]
    for m in train_ms:
        r = train_and_eval("sdim", steps=steps, batch=128,
                           eval_examples=ev, lr=5e-3, device=dev, m=m, tau=tau)
        rows.append({"name": f"fig5/auc_m{m}", "us_per_call": r["us_per_step"],
                     "derived": f"auc={r['auc']}"})
    r_inf = train_and_eval("sdim_expected", steps=steps,
                           batch=128, eval_examples=ev, lr=5e-3, device=dev)
    rows.append({"name": "fig5/auc_m_inf_eq14", "us_per_call": r_inf["us_per_step"],
                 "derived": f"auc={r_inf['auc']}_(m->inf_limit)",
                 "first_nonfinite_step": r_inf["first_nonfinite"]})
    return rows


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    depth = p.add_mutually_exclusive_group()
    depth.add_argument("--smoke", action="store_true", help="60 steps, 1,024 eval examples")
    depth.add_argument("--full", action="store_true", help="1,500 steps, m in 12..96")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    rows = run(quick=not args.full, smoke=args.smoke, device=args.device)
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
