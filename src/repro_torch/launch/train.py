"""Training launcher of the port:

    python -m repro_torch.launch.train --arch ARCH [--full] [--steps N]
        [--batch B] [--seq S] [--ckpt DIR] [--compress {int8,bf16}]
        [--device {cuda,cpu}]

Trains the arch's SMOKE configuration (``--full``: FULL) from a seeded
initialization through the whole loop: the deterministic restartable
stream, the optimizer, checkpoints and the watchdog, with the JAX
launcher's settings (``repro/launch/train.py``). ARCH is any id of
``configs.registry.ARCH_IDS``:

* the LM archs ``granite-3-2b``, ``command-r-plus-104b``, ``qwen3-8b``,
  ``deepseek-v2-236b`` and ``deepseek-moe-16b``: next-token cross entropy
  (plus the MoE aux loss) on ``lm_stream``'s batches of ``--batch`` rows of
  ``--seq`` uniform random tokens, AdamW with lr 3e-4 on a warmup-cosine
  schedule (10 warmup steps, ``--steps`` in all) and global-norm clipping
  at 1; the config's ``remat`` checkpoints each scanned block (FULL:
  ``"full"``) and its ``compute_dtype`` may run the loss off a bf16 cast;
* the recsys archs ``wide-deep``, ``bst``, ``dien``, ``bert4rec`` and
  ``sdim-paper``: batches of ``generate_batch_graded`` (for ``wide-deep``
  with field ids from ``np.random.default_rng(seed + 7)``), Adagrad with lr
  0.05 and global-norm clipping at 10. Interest kinds other than the
  config's (any of ``core.interest.INTEREST_KINDS``) are trained by
  building the model from a ``dataclasses.replace`` of the config's
  ``interest``; the launcher has no flag for them
  (``repro_torch.bench.table23_auc`` trains them all);
* the GNN arch ``gatedgcn``: node classification on one full-batch
  ``random_graph(256, 2048, d_feat)`` every step, AdamW with lr 1e-3
  (``gnn_setup``).

``--device`` defaults to cuda, where the kernels and their backward kernels
run; ``--device cpu`` runs their plain PyTorch versions.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.data.graph import random_graph
from repro_torch.data.pipeline import DeterministicStream
from repro_torch.data.synthetic import SyntheticCTRConfig, generate_batch_graded
from repro_torch.device import resolve_device
from repro_torch.train.loop import LoopConfig, run
from repro_torch.train.optimizer import OptimizerConfig


def recsys_setup(cfg, batch: int):
    """(loss_fn, stream, optimizer config) of the JAX launcher's recsys
    training (``repro/launch/train.py:60-78``)."""
    dcfg = SyntheticCTRConfig(hist_len=cfg.long_len, n_items=cfg.n_items, n_cats=cfg.n_cats)

    def make(seed):
        b = generate_batch_graded(dcfg, batch, seed)
        if cfg.arch == "wide_deep":
            rng = np.random.default_rng(seed + 7)
            b["sparse_ids"] = rng.integers(0, cfg.field_vocab,
                                           (batch, cfg.n_sparse)).astype(np.int32)
        return b

    stream = DeterministicStream(make, 0)
    opt = OptimizerConfig(kind="adagrad", lr=0.05, clip_norm=10.0)
    return (lambda model, b: model.loss(b)[0]), stream, opt


def lm_stream(cfg, batch: int, seq: int):
    """The JAX launcher's ``_lm_stream``: the batch of seed s is
    ``np.random.default_rng(s).integers(0, vocab, (batch, seq + 1))`` int32,
    ``tokens`` its first ``seq`` columns and ``targets`` its last ``seq``."""
    def make(seed):
        toks = np.random.default_rng(seed).integers(0, cfg.vocab, (batch, seq + 1),
                                                    dtype=np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    return make


def lm_setup(cfg, batch: int, seq: int, steps: int):
    """(loss_fn, stream, optimizer config) of the JAX launcher's LM
    training (``repro/launch/train.py:48-56``)."""
    stream = DeterministicStream(lm_stream(cfg, batch, seq), 0)
    opt = OptimizerConfig(kind="adamw", lr=3e-4, schedule="warmup_cosine", warmup_steps=10,
                          total_steps=steps)
    return (lambda model, b: model.loss(b["tokens"], b["targets"])), stream, opt


def gnn_setup(cfg):
    """(loss_fn, stream, optimizer config) of the JAX launcher's GNN
    training (``repro/launch/train.py:76-89``): the same full-batch graph
    every step."""
    g = random_graph(256, 2048, cfg.d_feat, seed=0, n_classes=cfg.n_classes)
    stream = DeterministicStream(lambda seed: dict(g), 0)
    return (lambda model, b: model.loss(b)), stream, OptimizerConfig(kind="adamw", lr=1e-3)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    p.add_argument("--full", action="store_true", help="the FULL config (default SMOKE)")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seq", type=int, default=64, help="LM sequence length")
    p.add_argument("--ckpt", default=None, help="checkpoint directory (restart from it)")
    p.add_argument("--compress", default=None, choices=["int8", "bf16"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    mod = registry.get(args.arch)
    cfg = mod.FULL if args.full else mod.SMOKE
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    if mod.FAMILY == "lm":
        from repro_torch.models.lm import LMModel

        model = LMModel(cfg, device=dev, generator=gen)
        loss_fn, stream, opt = lm_setup(cfg, args.batch, args.seq, args.steps)
    elif mod.FAMILY == "gnn":
        from repro_torch.models.gnn import GatedGCN

        model = GatedGCN(cfg, device=dev, generator=gen)
        loss_fn, stream, opt = gnn_setup(cfg)
    else:
        from repro_torch.models.ctr import CTRModel

        model = CTRModel(cfg, device=dev, generator=gen)
        loss_fn, stream, opt = recsys_setup(cfg, args.batch)
    n_params = sum(t.numel() for t in model.parameters())
    print(f"{args.arch} [{mod.FAMILY}] {'FULL' if args.full else 'SMOKE'} on {dev}: "
          f"{n_params / 1e6:.2f}M params")
    out = run(loss_fn, model, stream, opt,
              LoopConfig(n_steps=args.steps, log_every=10,
                         ckpt_every=max(args.steps // 2, 1), ckpt_dir=args.ckpt,
                         compress=args.compress),
              log_fn=lambda s, m: print(f"step {s:4d}  loss {m['loss']:.4f}  "
                                        f"{m['step_time_s'] * 1e3:.0f} ms"))
    print(f"finished at step {out['stopped_at']}")
    return out


if __name__ == "__main__":
    main()
