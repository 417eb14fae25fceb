"""Optimizers written out in the JAX package's arithmetic.

The port's counterpart of ``repro/train/optimizer.py``: AdamW, Adagrad and
momentum SGD with

* learning-rate schedules (constant, warmup-cosine, warmup-rsqrt) computed
  in fp32 from the step count;
* global-norm gradient clipping, scale ``min(1, max / (norm + 1e-9))``;
* a trainability mask by name: buffers (the SDIM hash matrix R) are never
  updated nor decayed;
* a weight-decay mask by name: parameters of two or more dimensions whose
  name holds none of ln, norm, bias, scale;
* an optional fp32 master copy of the weights in the optimizer state.

Each update is written in the JAX package's order of operations (not
through ``torch.optim``), so one update matches it to fp32 rounding. The
model's parameters and the state's tensors are updated in place: PyTorch
has no buffer donation, and the 10M-row item table of ``sdim-paper`` FULL
should not be copied every step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adamw"                 # adamw | adagrad | sgd
    lr: float = 1e-3
    schedule: str = "constant"          # constant | warmup_cosine | warmup_rsqrt
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.9
    clip_norm: Optional[float] = 1.0
    # keep an fp32 master copy of the weights in the optimizer state; the
    # model's parameters get the updated values in their own dtype
    master_weights: bool = False


def schedule_fn(cfg: OptimizerConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (int or 0-d tensor) -> learning rate, a 0-d fp32 tensor."""
    def fn(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
        if cfg.schedule == "constant":
            return cfg.lr * warm
        if cfg.schedule == "warmup_cosine":
            t = torch.clamp((step - cfg.warmup_steps)
                            / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
            cos = 0.5 * (1 + torch.cos(math.pi * t))
            return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)
        if cfg.schedule == "warmup_rsqrt":
            return (cfg.lr * warm * torch.rsqrt(torch.clamp(step, min=cfg.warmup_steps * 1.0))
                    * torch.sqrt(torch.tensor(1.0 * max(cfg.warmup_steps, 1))))
        raise ValueError(cfg.schedule)

    return fn


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------
def trainable_mask(model: nn.Module) -> Dict[str, bool]:
    """Every parameter and buffer of ``model`` by name: True for
    parameters, False for buffers (the SDIM hash matrix R)."""
    mask = {name: True for name, _ in model.named_parameters()}
    mask.update({name: False for name, _ in model.named_buffers()})
    return mask


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """True where weight decay applies: parameters of two or more
    dimensions that are not norms, biases or scales."""
    mask = {name: p.ndim >= 2 and not any(t in name for t in ("ln", "norm", "bias", "scale"))
            for name, p in model.named_parameters()}
    mask.update({name: False for name, _ in model.named_buffers()})
    return mask


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tensors))


def clip_by_global_norm(grads: Tensors, max_norm: float) -> Tuple[Tensors, torch.Tensor]:
    norm = global_norm(grads.values())
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: (g * scale).to(g.dtype) for k, g in grads.items()}, norm


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def trainable_params(model: nn.Module) -> Dict[str, nn.Parameter]:
    """The parameters ``trainable_mask`` lets the optimizer update, by name."""
    mask = trainable_mask(model)
    return {name: p for name, p in model.named_parameters() if mask[name]}


def init_opt_state(model: nn.Module, cfg: OptimizerConfig) -> dict:
    """{"count": 0-d int32, the kind's moments by parameter name (fp32
    zeros), ["master": fp32 copies]}, on the parameters' devices."""
    params = trainable_params(model)
    zeros = lambda: {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for k, p in params.items()}
    device = next(iter(params.values())).device
    state: dict = {"count": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.master_weights:
        state["master"] = {k: p.detach().float().clone() for k, p in params.items()}
    if cfg.kind == "adamw":
        state["m"], state["v"] = zeros(), zeros()
    elif cfg.kind == "adagrad":
        state["v"] = zeros()
    elif cfg.kind == "sgd":
        state["m"] = zeros()
    else:
        raise ValueError(cfg.kind)
    return state


@torch.no_grad()
def apply_updates(model: nn.Module, grads: Tensors, state: dict,
                  cfg: OptimizerConfig) -> Tuple[dict, dict]:
    """One update of ``model``'s trainable parameters from ``grads`` (by
    parameter name), in place; returns (state, metrics) with metrics
    ``lr`` and, where clipping is on, ``grad_norm`` (0-d tensors)."""
    metrics = {}
    params = trainable_params(model)
    work = state["master"] if cfg.master_weights else params
    if cfg.clip_norm is not None:
        grads, metrics["grad_norm"] = clip_by_global_norm(grads, cfg.clip_norm)
    step = state["count"]
    lr = schedule_fn(cfg)(step)
    metrics["lr"] = lr
    decay = decay_mask(model)

    if cfg.kind == "adamw":
        t = (step + 1).to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=t.device), t)
        bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=t.device), t)
    for name, p in work.items():
        g = grads[name].float()
        if cfg.kind == "adamw":
            m, v = state["m"][name], state["v"][name]
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
            u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if cfg.weight_decay and decay[name]:
                u = u + cfg.weight_decay * p.float()
            new = p.float() - lr * u
        elif cfg.kind == "adagrad":
            v = state["v"][name]
            v.add_(g * g)
            new = p.float() - lr * g / (torch.sqrt(v) + cfg.eps)
        elif cfg.kind == "sgd":
            m = state["m"][name]
            m.copy_(cfg.momentum * m + g)
            new = p.float() - lr * m
        else:
            raise ValueError(cfg.kind)
        p.copy_(new)
        if cfg.master_weights:
            params[name].copy_(new)
    state["count"] = step + 1
    return state, metrics
