"""Carry the JAX package's CTR params pytree into the port's modules, and
back out.

``params_np`` is ``repro.models.ctr.CTRModel.init``'s pytree with every leaf
converted to a numpy array (``jax.tree_util.tree_map(np.asarray, params)``):
``item_emb.table``, ``cat_emb.table``, ``interest.buffers.R`` and
``head.fc{i}.{w,b}``. JAX's ``Linear.w`` is (in, out); ``nn.Linear.weight``
is (out, in), so it is transposed. ``export_params`` is the inverse of
``load_jax_params``; with ``grad=True`` it exports the parameters'
gradients in the same tree (zeros for R, a buffer, as ``jax.grad`` gives
it), so tests compare whole gradient trees.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.ctr import CTRModel


def _copy(dst: torch.Tensor, src, name: str) -> None:
    src = torch.from_numpy(np.array(src, np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {tuple(src.shape)} does not fit "
                         f"{tuple(dst.shape)}")
    dst.copy_(src)


@torch.no_grad()
def load_jax_params(model: CTRModel, params_np: dict) -> CTRModel:
    """Copy ``params_np`` into ``model`` in place; returns the model."""
    _copy(model.item_emb.weight, params_np["item_emb"]["table"], "item_emb.table")
    _copy(model.cat_emb.weight, params_np["cat_emb"]["table"], "cat_emb.table")
    if model.cfg.interest.kind == "sdim":
        _copy(model.interest.R, params_np["interest"]["buffers"]["R"],
              "interest.buffers.R")
    head = params_np["head"]
    if len(head) != model.head.n_layers:
        raise ValueError(f"head has {len(head)} layers, the model "
                         f"{model.head.n_layers}")
    for i in range(model.head.n_layers):
        layer = getattr(model.head, f"fc{i}")
        _copy(layer.weight, np.asarray(head[f"fc{i}"]["w"]).T, f"head.fc{i}.w")
        _copy(layer.bias, head[f"fc{i}"]["b"], f"head.fc{i}.b")
    return model


def export_params(model: CTRModel, grad: bool = False) -> dict:
    """The JAX package's params pytree of ``model`` as numpy arrays (its
    ``.grad``s with ``grad=True``; zeros where a parameter has none),
    copied: later updates of the model do not reach them."""
    def arr(t: torch.Tensor, transpose: bool = False) -> np.ndarray:
        if grad:
            t = torch.zeros_like(t) if t.grad is None else t.grad
        x = t.detach().float().cpu().numpy()
        return np.array(x.T if transpose else x, order="C")    # a copy, never a view

    interest = {}
    if model.cfg.interest.kind == "sdim":
        R = model.interest.R
        interest["buffers"] = {"R": np.zeros(R.shape, np.float32) if grad
                               else R.detach().cpu().numpy().copy()}
    head = {}
    for i in range(model.head.n_layers):
        layer = getattr(model.head, f"fc{i}")
        head[f"fc{i}"] = {"w": arr(layer.weight, transpose=True), "b": arr(layer.bias)}
    return {"item_emb": {"table": arr(model.item_emb.weight)},
            "cat_emb": {"table": arr(model.cat_emb.weight)},
            "interest": interest, "head": head}
