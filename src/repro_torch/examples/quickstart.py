"""Quickstart: SDIM in 60 seconds.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Counterpart of ``examples/quickstart.py``:

1. hash a user's behavior sequence into a bucket table (BSE encode),
2. score candidates against it (hash + gather + ℓ2-combine),
3. check the estimator against exact target attention (Eq. 14 theory).

``core/bse.py`` is the plain math in both packages: no kernel runs. Runs
on the card unless ``--device cpu`` is given; the draws come from seeded
generators on that device.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import bse, sdim, simhash
from repro_torch.core.target_attention import target_attention
from repro_torch.device import resolve_device

m, tau, d, L, C = 48, 3, 128, 1024, 8


@torch.no_grad()
def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)

    R = simhash.make_hashes(gen(0), m, d)                    # the m hash functions
    seq = sdim.l2_normalize(torch.randn((1, L, d), generator=gen(1), device=dev))
    mask = torch.ones((1, L), device=dev)
    cands = sdim.l2_normalize(torch.randn((1, C, d), generator=gen(2), device=dev))

    # --- BSE server side: candidate-independent, once per user ---------------
    table = bse.encode_sequence(seq, mask, R, tau)           # (1, G=16, U=8, d)
    print(f"bucket table: {tuple(table.shape)}, {table.numel() * 2} bytes on the wire "
          f"(fixed — independent of L={L})")

    # --- CTR server side: O(C·m·log d), L-free --------------------------------
    interest = bse.query_interest(table, cands, R, tau)      # (1, C, d)
    print(f"user interest per candidate: {tuple(interest.shape)}")

    # --- compare attention patterns vs exact target attention -----------------
    ta = target_attention(cands, seq, mask)
    exp = sdim.sdim_expected_attention(cands, seq, mask, tau)
    cos_sampled = float(torch.mean(torch.sum(sdim.l2_normalize(interest)
                                             * sdim.l2_normalize(ta), -1)))
    cos_theory = float(torch.mean(torch.sum(sdim.l2_normalize(exp)
                                            * sdim.l2_normalize(ta), -1)))
    print(f"cos(SDIM sampled, exact TA)  = {cos_sampled:.4f}")
    print(f"cos(SDIM Eq.14,  exact TA)  = {cos_theory:.4f}")
    print("(paper Fig. 2: the collision kernel tracks the softmax kernel)")
    return {"table_shape": tuple(table.shape), "interest_shape": tuple(interest.shape),
            "cos_sampled": cos_sampled, "cos_theory": cos_theory}


if __name__ == "__main__":
    main()
