"""Carry the JAX package's CTR params pytree into the port's modules.

``params_np`` is ``repro.models.ctr.CTRModel.init``'s pytree with every leaf
converted to a numpy array (``jax.tree_util.tree_map(np.asarray, params)``):
``item_emb.table``, ``cat_emb.table``, ``interest.buffers.R`` and
``head.fc{i}.{w,b}``. JAX's ``Linear.w`` is (in, out); ``nn.Linear.weight``
is (out, in), so it is transposed.
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
