"""SDIM bucket-compressed KV cache for LM long-context decode:

    PYTHONPATH=src python -m repro_torch.examples.lm_decode_sdim [--ctx 256] [--device cpu]

Counterpart of ``examples/lm_decode_sdim.py``. One-token-query attention
over a long KV cache is target attention, so the paper's BSE trick carries
over: per (layer, kv head) the values are folded into (G × 2^τ) signature
buckets keyed on the keys' hashes. The decode state becomes O(G·U·d) a head,
whatever the context length, and a step hashes and reads buckets instead
of sweeping an O(S) cache.

Decodes ``--ctx`` tokens greedily with an exact cache and with SDIM
buckets side by side (the exact path picks the next token), then compares
the last next-token distributions and the two states' sizes. Runs on the
card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.device import resolve_device
from repro_torch.models.lm import LMConfig, LMModel

DEMO = LMConfig(name="demo", n_layers=4, d_model=128, n_heads=8, n_kv_heads=4,
                head_dim=16, d_ff=256, vocab=512, remat="none", sdim_m=96, sdim_tau=2)


@torch.no_grad()
def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ctx", type=int, default=256)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = DEMO
    model = LMModel(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))

    S = args.ctx
    caches = model.init_cache(1, S + 1, torch.float32)
    sdim_cache = model.init_sdim_cache(1)
    tok = torch.randint(0, cfg.vocab, (1, 1), dtype=torch.int32, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    for i in range(S):
        logits_e, caches = model.decode_step(tok, caches, i)
        logits_s, sdim_cache = model.sdim_decode_step(tok, sdim_cache)
        tok = torch.argmax(logits_e, -1).to(torch.int32)

    pe = torch.softmax(logits_e[0, 0].float(), -1)
    ps = torch.softmax(logits_s[0, 0].float(), -1)
    overlap = float(torch.minimum(pe, ps).sum())
    top = len(set(torch.topk(pe, 10).indices.tolist()) & set(torch.topk(ps, 10).indices.tolist()))
    exact_bytes = sum(t.numel() * t.element_size() for t in caches["stack"].values())
    sdim_bytes = sum(sdim_cache[k].numel() * sdim_cache[k].element_size() for k in ("vt", "ct"))
    print(f"context length: {S} on {dev}")
    print(f"exact KV cache: {exact_bytes / 1e6:.2f} MB (grows with S)")
    print(f"SDIM buckets:   {sdim_bytes / 1e6:.2f} MB (CONSTANT in S)")
    print(f"next-token distribution overlap (exact vs SDIM): {overlap:.3f}")
    print(f"top-10 overlap: {top}/10")
    print("(an approximation: the compressed path trades attention fidelity for a "
          "state and a step cost that do not grow with the context)")
    return {"overlap": overlap, "top10": top, "exact_bytes": exact_bytes,
            "sdim_bytes": sdim_bytes}


if __name__ == "__main__":
    main()
