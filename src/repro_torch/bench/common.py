"""The paper's offline protocol on the port: AUC, the data and model
configurations of Tables 2/3, and the train-then-evaluate loop.

Counterpart of ``benchmarks/common.py`` (its ``auc``, ``paper_data_config``,
``paper_model_config`` and ``train_and_eval``; a copy, not an import): the
same planted-structure data (``generate_batch_graded`` through the port's
``DeterministicStream``), the same AdamW (clip 1.0, constant schedule with
100 warm-up steps), the same step counts, and evaluation on the seeds
``10_000_000 + i`` in batches of 1,024. Every interest kind shares the
embeddings, the short-term branch and the head; they differ only in the
long-term branch, as in the paper. Runs on the card unless the caller asks
for the CPU.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.interest import InterestConfig
from repro_torch.data.pipeline import DeterministicStream
from repro_torch.data.synthetic import SyntheticCTRConfig, generate_batch_graded
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.ctr import CTRConfig, CTRModel
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import OptimizerConfig

EVAL_SEED0 = 10_000_000
EVAL_BATCH = 1024


def auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Mann-Whitney AUC (tie-aware via average ranks)."""
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = scores[order]
    i = 0
    r = np.arange(1, len(scores) + 1, dtype=np.float64)
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        r[i : j + 1] = 0.5 * (i + 1 + j + 1)
        i = j + 1
    ranks[order] = r
    pos = labels > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def paper_data_config(long_len: int = 256) -> SyntheticCTRConfig:
    return SyntheticCTRConfig(
        n_items=8000, n_cats=80, hist_len=long_len, short_len=16,
        n_interests=5, session_len=16, label_noise=0.05,
    )


def paper_model_config(kind: str, long_len: int = 256, m: int = 48,
                       tau: int = 3, top_k: int = 32) -> CTRConfig:
    return CTRConfig(
        arch="din", n_items=8000, n_cats=80, embed_dim=16,
        short_len=16, long_len=long_len, mlp_hidden=(64, 32), ctx_dim=4,
        emb_init=0.25,  # organized-enough geometry for softmax TA to train
        interest=InterestConfig(kind=kind, m=m, tau=tau, top_k=top_k),
    )


def _to(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(model: CTRModel, dcfg: SyntheticCTRConfig, steps: int, batch: int,
          seed: int = 0, lr: float = 2e-3) -> dict:
    """``steps`` AdamW steps of ``model`` on the stream of
    ``generate_batch_graded`` batches from ``seed``: the first step outside
    the timed region (it warms up the kernels), the rest timed by the host
    clock, ending in a device sync. Returns {"losses" (numpy, one per
    step), "train_s", "first_nonfinite" (the first step whose loss or
    gradient norm was not finite, or None)}."""
    device = next(model.parameters()).device
    init_state, step_fn = make_train_step(lambda m, b: m.loss(b)[0],
                                          OptimizerConfig(kind="adamw", lr=lr))
    state = init_state(model)
    stream = DeterministicStream(lambda s: generate_batch_graded(dcfg, batch, s),
                                 base_seed=seed)
    losses, norms = [], []
    state, metrics = step_fn(state, _to(next(stream), device))
    losses.append(metrics["loss"])
    norms.append(metrics["grad_norm"])
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        state, metrics = step_fn(state, _to(next(stream), device))
        losses.append(metrics["loss"])
        norms.append(metrics["grad_norm"])
    _sync(device)
    train_s = time.perf_counter() - t0
    losses = torch.stack(losses).cpu().numpy()
    norms = torch.stack(norms).cpu().numpy()
    bad = np.flatnonzero(~(np.isfinite(losses) & np.isfinite(norms)))
    return {"losses": losses, "train_s": train_s,
            "first_nonfinite": int(bad[0]) if bad.size else None}


def trained_params(kind: str, steps: int, batch: int = 128, long_len: int = 256,
                   seed: int = 0, lr: float = 5e-3, device: DeviceLike = "cuda",
                   **interest_kw) -> dict:
    """The parameters of the protocol's model of ``kind`` after ``steps``
    AdamW steps of ``train`` from ``seed``: two calls must give the same
    bits (``bit_differences``)."""
    dev = resolve_device(device)
    model = CTRModel(paper_model_config(kind, long_len, **interest_kw), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(seed))
    train(model, paper_data_config(long_len), steps, batch, seed, lr)
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def bit_differences(a: dict, b: dict) -> list:
    """Names of the tensors of ``a`` and ``b`` whose raw bits differ where
    they are finite, or which are not finite at the same places (a NaN's
    payload is not compared)."""
    differ = []
    for name, x in a.items():
        y = b[name]
        fx, fy = torch.isfinite(x), torch.isfinite(y)
        bits = lambda t: torch.where(fx, t, 0).view(torch.int32)
        if not torch.equal(fx, fy) or not torch.equal(bits(x), bits(y)):
            differ.append(name)
    return differ


@torch.no_grad()
def evaluate(model: CTRModel, dcfg: SyntheticCTRConfig, eval_examples: int):
    """(labels, logits) of ``model`` on the held-out seeds, as numpy."""
    device = next(model.parameters()).device
    scores, labels = [], []
    for i in range(eval_examples // EVAL_BATCH):
        eb = generate_batch_graded(dcfg, EVAL_BATCH, EVAL_SEED0 + i)
        scores.append(model.apply(_to(eb, device)).float().cpu().numpy())
        labels.append(eb["label"])
    return np.concatenate(labels), np.concatenate(scores)


def train_and_eval(kind: str, steps: int = 300, batch: int = 128,
                   eval_examples: int = 8192, long_len: int = 256, seed: int = 0,
                   lr: float = 2e-3, device: DeviceLike = "cuda",
                   params: Optional[dict] = None, **interest_kw) -> dict:
    """Train one CTR model variant on the planted-structure data and
    evaluate it. ``params`` (the JAX package's params pytree as numpy
    arrays) replaces the seeded initialization. Returns dict(kind, auc,
    train_s, us_per_step, first_nonfinite)."""
    dev = resolve_device(device)
    dcfg = paper_data_config(long_len)
    model = CTRModel(paper_model_config(kind, long_len, **interest_kw), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(seed))
    if params is not None:
        from repro_torch.weights import load_jax_params
        load_jax_params(model, params)
    run = train(model, dcfg, steps, batch, seed, lr)
    a = auc(*evaluate(model, dcfg, eval_examples))
    return {
        "kind": kind,
        "auc": round(a, 4),
        "train_s": round(run["train_s"], 2),
        "us_per_step": round(1e6 * run["train_s"] / max(steps - 1, 1), 1),
        "first_nonfinite": run["first_nonfinite"],
    }
