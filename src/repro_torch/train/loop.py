"""Fault-tolerant training loop.

The port's counterpart of ``repro/train/loop.py``: a train step with
optional microbatch gradient accumulation and error-feedback gradient
compression, a deterministic restartable data stream, async atomic
checkpoints, preemption handling and a straggler watchdog.

* preemption: set ``preempt_event``; the loop finishes the step, saves and
  returns;
* restart: ``run`` restores the latest checkpoint and skips the stream
  ahead to it, so the run continues bit-identically;
* stragglers: the ``Watchdog`` flags steps slower than ``straggler_factor``
  times the running median.

Autograd takes the place of ``jax.value_and_grad``. A step updates the
model's parameters and the optimizer state in place; the JAX loop's
``donate`` (reuse of the old state's buffers) has no PyTorch meaning, so
``LoopConfig`` has no such field.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

import torch
from torch import nn

from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.compression import ef_compress, init_error_feedback
from repro_torch.train.optimizer import (OptimizerConfig, apply_updates, init_opt_state,
                                         trainable_params)

LossFn = Callable[[nn.Module, dict], torch.Tensor]


@dataclasses.dataclass
class LoopConfig:
    n_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    grad_accum: int = 1
    compress: Optional[str] = None       # None | "int8" | "bf16"
    straggler_factor: float = 3.0


class Watchdog:
    """Rolling-median step timer; flags stragglers."""

    def __init__(self, factor: float = 3.0, window: int = 50):
        self.factor = factor
        self.window = window
        self.durations: list[float] = []
        self.flags: list[int] = []

    def observe(self, step: int, dt: float) -> bool:
        self.durations.append(dt)
        hist = self.durations[-self.window:]
        med = sorted(hist)[len(hist) // 2]
        slow = len(hist) >= 5 and dt > self.factor * med
        if slow:
            self.flags.append(step)
        return slow


def _split_microbatches(batch: dict, n: int) -> list:
    """``n`` microbatches of consecutive rows, as the JAX loop's reshape
    (n, B / n, ...)."""
    for k, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch {k} of {x.shape[0]} rows does not split into {n}")
    return [{k: x.reshape(n, x.shape[0] // n, *x.shape[1:])[i] for k, x in batch.items()}
            for i in range(n)]


def make_train_step(loss_fn: LossFn, opt_cfg: OptimizerConfig, grad_accum: int = 1,
                    compress: Optional[str] = None):
    """Returns (init_state(model) -> state, step(state, batch) -> (state,
    metrics)). The state is {"model", "opt"[, "ef"]}; a step averages loss
    and gradients over ``grad_accum`` microbatches (summed in order, then
    divided, as the JAX loop), compresses them with error feedback where
    asked, and applies one optimizer update. Metrics are 0-d tensors on the
    model's device: ``loss``, ``lr`` and, with clipping, ``grad_norm``."""
    def init_state(model: nn.Module) -> dict:
        state = {"model": model, "opt": init_opt_state(model, opt_cfg)}
        if compress:
            state["ef"] = init_error_feedback(trainable_params(model))
        return state

    def step(state: dict, batch: dict):
        model = state["model"]
        params = trainable_params(model)
        for p in params.values():
            p.grad = None
        if grad_accum == 1:
            loss = loss_fn(model, batch)
            loss.backward()
            loss = loss.detach()
        else:
            loss = 0.0
            for mb in _split_microbatches(batch, grad_accum):
                micro = loss_fn(model, mb)
                micro.backward()             # gradients add up in .grad, in order
                loss = loss + micro.detach()
            loss = loss / grad_accum
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
                 for k, p in params.items()}
        if grad_accum > 1:
            grads = {k: g / grad_accum for k, g in grads.items()}
        if compress:
            grads, state["ef"] = ef_compress(grads, state["ef"], compress)
        state["opt"], metrics = apply_updates(model, grads, state["opt"], opt_cfg)
        for p in params.values():
            p.grad = None                    # the dense embedding gradients are large
        metrics["loss"] = loss
        return state, metrics

    return init_state, step


def run(loss_fn: LossFn, model: nn.Module, stream, opt_cfg: OptimizerConfig,
        loop_cfg: LoopConfig, preempt_event: Optional[threading.Event] = None,
        log_fn: Callable[[int, dict], None] = lambda s, m: None) -> dict:
    """Train ``model`` on ``stream`` (a ``DeterministicStream`` of host
    numpy batches, moved to the model's device) with restart support.
    Returns {"state", "stopped_at", "history", "watchdog"}."""
    init_state, step_fn = make_train_step(loss_fn, opt_cfg, loop_cfg.grad_accum,
                                          loop_cfg.compress)
    state = init_state(model)
    device = next(model.parameters()).device
    start_step = 0

    saver = None
    if loop_cfg.ckpt_dir:
        saver = ckpt_lib.AsyncCheckpointer(loop_cfg.ckpt_dir)
        last = ckpt_lib.latest_step(loop_cfg.ckpt_dir)
        if last is not None:
            state, start_step = ckpt_lib.restore(loop_cfg.ckpt_dir, state, last)
            stream.skip_to(start_step)

    watchdog = Watchdog(loop_cfg.straggler_factor)
    history = []
    for step in range(start_step, loop_cfg.n_steps):
        t0 = time.perf_counter()
        batch = {k: torch.as_tensor(v, device=device) for k, v in next(stream).items()}
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])        # waits for the device
        dt = time.perf_counter() - t0
        watchdog.observe(step, dt)

        if (step + 1) % loop_cfg.log_every == 0 or step == loop_cfg.n_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["loss"], m["step_time_s"] = loss, dt
            history.append((step, m))
            log_fn(step, m)

        if saver and (step + 1) % loop_cfg.ckpt_every == 0:
            saver.save(step + 1, state)

        if preempt_event is not None and preempt_event.is_set():
            if saver:
                saver.save(step + 1, state)
                saver.wait()
            return {"state": state, "stopped_at": step + 1, "history": history,
                    "watchdog": watchdog}

    if saver:
        saver.save(loop_cfg.n_steps, state)
        saver.wait()
    return {"state": state, "stopped_at": loop_cfg.n_steps, "history": history,
            "watchdog": watchdog}
