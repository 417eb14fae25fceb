"""End-to-end training script: the paper's CTR model (Fig. 3) with SDIM
long-term interest, the whole training substrate engaged: deterministic
restartable data stream, Adagrad, gradient accumulation, async atomic
checkpoints, the straggler watchdog, preemption.

    PYTHONPATH=src python -m repro_torch.examples.train_ctr \\
        --steps 200 --batch 256 --n-items 500000 [--ckpt DIR] [--device cpu]

Counterpart of ``examples/train_ctr.py``. Checkpoints go to ``--ckpt``
(default ``sdim_ctr_ckpt`` under the temporary directory, ``TMPDIR``).
Resume is automatic: re-run the same command after killing it (SIGTERM
finishes the step, saves and exits) and the loop restores the latest
checkpoint and skips the stream ahead. ``main(argv, stop_after=N)`` sets
the preemption event once this run has taken N steps, as SIGTERM would
(for a scripted kill-and-resume). Runs on the card (``bse_encode`` and
``sdim_query`` with their backward kernels) unless ``--device cpu`` is
given (``--device`` in place of the reference's backend choice).
"""
from __future__ import annotations

import argparse
import itertools
import os
import signal
import tempfile
import threading

import torch

from repro_torch.core.interest import InterestConfig
from repro_torch.data.pipeline import DeterministicStream
from repro_torch.data.synthetic import SyntheticCTRConfig, generate_batch_graded
from repro_torch.device import resolve_device
from repro_torch.models.ctr import CTRConfig, CTRModel
from repro_torch.train.loop import LoopConfig, run
from repro_torch.train.optimizer import OptimizerConfig


def main(argv=None, stop_after: int | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--n-items", type=int, default=500_000)
    p.add_argument("--embed-dim", type=int, default=64)
    p.add_argument("--long-len", type=int, default=512)
    p.add_argument("--grad-accum", type=int, default=2)
    p.add_argument("--compress", default=None, choices=[None, "int8", "bf16"])
    p.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "sdim_ctr_ckpt"))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    dcfg = SyntheticCTRConfig(n_items=args.n_items, n_cats=2000,
                              hist_len=args.long_len, short_len=50)
    mcfg = CTRConfig(
        arch="din", n_items=args.n_items, n_cats=2000,
        embed_dim=args.embed_dim, short_len=50, long_len=args.long_len,
        mlp_hidden=(1024, 512, 256), emb_init=0.05,
        interest=InterestConfig(kind="sdim", m=48, tau=3),
    )
    model = CTRModel(mcfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params / 1e6:.1f}M params ({args.n_items} items x {args.embed_dim}) "
          f"on {dev}")

    # graceful preemption: SIGTERM -> finish the step, save, exit
    preempt = threading.Event()
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, lambda *_: preempt.set())

    made = itertools.count(1)

    def make_batch(seed):
        if next(made) == stop_after:           # this run's last step: preempt after it
            preempt.set()
        return generate_batch_graded(dcfg, args.batch, seed)

    stream = DeterministicStream(make_batch, base_seed=17)

    def log(s, m):
        print(f"step {s:5d}  loss {m['loss']:.4f}  lr {m['lr']:.4f}  "
              f"{m['step_time_s'] * 1e3:.0f} ms/step")

    out = run(
        loss_fn=lambda model, b: model.loss(b)[0],
        model=model,
        stream=stream,
        opt_cfg=OptimizerConfig(kind="adagrad", lr=0.05, clip_norm=10.0),
        loop_cfg=LoopConfig(n_steps=args.steps, log_every=10, ckpt_every=50,
                            ckpt_dir=args.ckpt, grad_accum=args.grad_accum,
                            compress=args.compress),
        preempt_event=preempt,
        log_fn=log,
    )
    print(f"stopped at step {out['stopped_at']}; "
          f"straggler flags: {out['watchdog'].flags}")
    return {"stopped_at": out["stopped_at"], "history": out["history"], "model": model,
            "params": n_params}


if __name__ == "__main__":
    main()
