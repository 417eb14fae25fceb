"""Carry the JAX package's CTR params pytree into the port's modules, and
back out.

``params_np`` is ``repro.models.ctr.CTRModel.init``'s pytree with every leaf
converted to a numpy array (``jax.tree_util.tree_map(np.asarray, params)``):
``item_emb.table``, ``cat_emb.table``, ``head.fc{i}.{w,b}`` and the interest
kind's own: ``interest.buffers.R`` (kinds ``sdim``, either family, and
``eta``), ``interest.mlp.fc{i}.{w,b}`` (``din_mlp``) and
``interest.{wq,wk}.w`` (``ubr4ctr``). JAX's ``Linear.w`` is (in, out);
``nn.Linear.weight`` is (out, in), so it is transposed. ``export_params`` is the inverse of
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
    for name, (t, transpose) in _interest_tensors(model).items():
        src = params_np["interest"]
        for key in name.split("."):
            src = src[key]
        _copy(t, np.asarray(src).T if transpose else src, f"interest.{name}")
    head = params_np["head"]
    if len(head) != model.head.n_layers:
        raise ValueError(f"head has {len(head)} layers, the model "
                         f"{model.head.n_layers}")
    for i in range(model.head.n_layers):
        layer = getattr(model.head, f"fc{i}")
        _copy(layer.weight, np.asarray(head[f"fc{i}"]["w"]).T, f"head.fc{i}.w")
        _copy(layer.bias, head[f"fc{i}"]["b"], f"head.fc{i}.b")
    return model


def _interest_tensors(model: CTRModel) -> dict:
    """The interest module's tensors by their name in the JAX package's
    ``interest`` subtree (dot-separated) -> (tensor, transposed there)."""
    interest, kind = model.interest, model.cfg.interest.kind
    if kind in ("sdim", "eta"):
        return {"buffers.R": (interest.R, False)}
    if kind == "din_mlp":
        mlp = interest.din.mlp
        out = {}
        for i in range(mlp.n_layers):
            layer = getattr(mlp, f"fc{i}")
            out[f"mlp.fc{i}.w"] = (layer.weight, True)
            out[f"mlp.fc{i}.b"] = (layer.bias, False)
        return out
    if kind == "ubr4ctr":
        return {"wq.w": (interest.ubr.wq.weight, True), "wk.w": (interest.ubr.wk.weight, True)}
    return {}


def export_params(model: CTRModel, grad: bool = False) -> dict:
    """The JAX package's params pytree of ``model`` as numpy arrays (its
    ``.grad``s with ``grad=True``; zeros where a parameter has none),
    copied: later updates of the model do not reach them."""
    def arr(t: torch.Tensor, transpose: bool = False) -> np.ndarray:
        if grad:
            t = torch.zeros_like(t) if t.grad is None else t.grad
        x = t.detach().float().cpu().numpy()
        return np.array(x.T if transpose else x, order="C")    # a copy, never a view

    interest: dict = {}
    for name, (t, transpose) in _interest_tensors(model).items():
        *path, leaf = name.split(".")
        node = interest
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = arr(t, transpose)      # R, a buffer, has no .grad: zeros
    head = {}
    for i in range(model.head.n_layers):
        layer = getattr(model.head, f"fc{i}")
        head[f"fc{i}"] = {"w": arr(layer.weight, transpose=True), "b": arr(layer.bias)}
    return {"item_emb": {"table": arr(model.item_emb.weight)},
            "cat_emb": {"table": arr(model.cat_emb.weight)},
            "interest": interest, "head": head}
