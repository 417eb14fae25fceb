"""Training launcher of the port:

    python -m repro_torch.launch.train --arch ARCH [--full] [--steps N]
        [--batch B] [--ckpt DIR] [--compress {int8,bf16}] [--device {cuda,cpu}]

Trains the arch's SMOKE configuration (``--full``: FULL) from a seeded
initialization through the whole loop: the deterministic restartable
stream, the optimizer, checkpoints and the watchdog. The recsys settings
are the JAX launcher's: batches of ``generate_batch_graded`` (for
``wide-deep`` with field ids from ``np.random.default_rng(seed + 7)``),
Adagrad with lr 0.05 and global-norm clipping at 10. ARCH is any id of
``configs.registry.ARCH_IDS``: ``wide-deep``, ``bst``, ``dien``,
``bert4rec`` or ``sdim-paper``. ``--device`` defaults to cuda,
where the kernels and their backward kernels run; ``--device cpu`` runs
their plain PyTorch versions. Interest kinds other than the config's
(any of ``core.interest.INTEREST_KINDS``) are trained by building the
model from a ``dataclasses.replace`` of the config's ``interest``; the
launcher has no flag for them (``repro_torch.bench.table23_auc`` trains
them all). Arch families the port has not ported raise
NotImplementedError (ROADMAP.md lists them).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import registry
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


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    p.add_argument("--full", action="store_true", help="the FULL config (default SMOKE)")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--ckpt", default=None, help="checkpoint directory (restart from it)")
    p.add_argument("--compress", default=None, choices=["int8", "bf16"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    mod = registry.get(args.arch)
    cfg = mod.FULL if args.full else mod.SMOKE
    if mod.FAMILY != "recsys":
        raise NotImplementedError(f"training family {mod.FAMILY!r} is not ported (LM training "
                                  f"waits for ROADMAP.md, A3b)")
    from repro_torch.models.ctr import CTRModel

    dev = resolve_device(args.device)
    model = CTRModel(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
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
