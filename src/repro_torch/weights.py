"""Carry the JAX package's CTR params pytree into the port's modules, and
back out.

``params_np`` is ``repro.models.ctr.CTRModel.init``'s pytree with every leaf
converted to a numpy array (``jax.tree_util.tree_map(np.asarray, params)``):
``item_emb.table``, ``cat_emb.table``, ``head.fc{i}.{w,b}``, the interest
kind's own (``interest.buffers.R`` for kinds ``sdim``, either family, and
``eta``; ``interest.mlp.fc{i}.{w,b}`` for ``din_mlp``;
``interest.{wq,wk}.w`` for ``ubr4ctr``) and the arch's own:
``field_tables.f{i}``, ``wide.f{i}`` and ``wide_bias`` (wide_deep, rows of
the port's stacked tables); ``pos_emb`` and the list ``blocks`` of
``{attn.{wq,wk,wv,wo}.{w,b}, ln1.{scale,bias}, mlp.fc{0,1}.{w,b},
ln2.{scale,bias}}`` (bst, bert4rec); ``in_proj.{w,b}`` (bert4rec);
``gru.{wx,wh,b}``, ``augru.{wx,wh,b}`` and ``att_proj.w`` (dien). JAX's
``Linear.w`` is (in, out); ``nn.Linear.weight`` is (out, in), so it is
transposed; the GRU matrices keep the JAX layout. ``export_params`` is the
inverse of ``load_jax_params``; with ``grad=True`` it exports the
parameters' gradients in the same tree (zeros for R, a buffer, as
``jax.grad`` gives it), so tests compare whole gradient trees.

``load_jax_lm_params`` / ``export_lm_params`` do the same for
``repro.models.lm.LMModel.init``'s pytree and the port's ``LMModel``:
``embed.table``, ``final_norm.{scale[,bias]}``, ``lm_head.w`` (untied
embeddings only), the ``stack.*`` leaves, which carry a leading n_layers
axis (the reference's vmapped init), row i for block i, and the list
``dense_blocks`` (``first_k_dense``) of the same leaves without it. A
block's leaves: ``{ln1,ln2}.{scale[,bias]}``; grouped-query attention
``attn.{wq,wk,wv,wo}.{w[,b]}`` and ``attn.{q_norm,k_norm}.scale``
(qk_norm); latent attention ``attn.{wq_a,wq_b,wkv_a,wk_b,wv_b,wo}.w`` and
``attn.{q_a_norm,kv_a_norm}.scale``; a dense FFN
``ffn.{wi_gate,wi_up,wo}.{w[,b]}``; a mixture of experts ``ffn.router.w``
(d, E), ``ffn.experts.{wi_gate,wi_up,wo}`` and ``ffn.shared.*``, kept in
the reference's layout (not transposed). The hash matrix R (sdim_m,
head_dim; kv_lora_rank for MLA) is no parameter there (``LMModel._sdim_R``
draws it from ``PRNGKey(1234)``), so the loader takes it beside the tree.
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


def _linear(out: dict, path: str, layer) -> None:
    out[f"{path}.w"] = (layer.weight, None, True)
    if layer.bias is not None:
        out[f"{path}.b"] = (layer.bias, None, False)


def _mlp(out: dict, path: str, mlp) -> None:
    for i in range(mlp.n_layers):
        _linear(out, f"{path}.fc{i}", getattr(mlp, f"fc{i}"))


def _leaves(model: CTRModel) -> dict:
    """Every tensor of ``model`` by its path in the JAX package's tree
    (dot-separated; a list index is a number) -> (tensor, row of its first
    axis or None, transposed there)."""
    out = {"item_emb.table": (model.item_emb.weight, None, False),
           "cat_emb.table": (model.cat_emb.weight, None, False)}
    interest, kind = model.interest, model.cfg.interest.kind
    if kind in ("sdim", "eta"):
        out["interest.buffers.R"] = (interest.R, None, False)
    elif kind == "din_mlp":
        _mlp(out, "interest.mlp", interest.din.mlp)
    elif kind == "ubr4ctr":
        _linear(out, "interest.wq", interest.ubr.wq)
        _linear(out, "interest.wk", interest.ubr.wk)
    _mlp(out, "head", model.head)
    arch = model.cfg.arch
    if arch == "wide_deep":
        for i in range(model.cfg.n_sparse):
            out[f"field_tables.f{i}"] = (model.field_tables, i, False)
            out[f"wide.f{i}"] = (model.wide, i, False)
        out["wide_bias"] = (model.wide_bias, None, False)
    elif arch in ("bst", "bert4rec"):
        out["pos_emb"] = (model.pos_emb, None, False)
        if arch == "bert4rec":
            _linear(out, "in_proj", model.in_proj)
        for j, block in enumerate(model.blocks):
            for name in ("wq", "wk", "wv", "wo"):
                _linear(out, f"blocks.{j}.attn.{name}", getattr(block.attn, name))
            for ln in ("ln1", "ln2"):
                norm = getattr(block, ln)
                out[f"blocks.{j}.{ln}.scale"] = (norm.scale, None, False)
                out[f"blocks.{j}.{ln}.bias"] = (norm.bias, None, False)
            _mlp(out, f"blocks.{j}.mlp", block.mlp)
    elif arch == "dien":
        for rnn in ("gru", "augru"):
            for name in ("wx", "wh", "b"):
                out[f"{rnn}.{name}"] = (getattr(getattr(model, rnn), name), None, False)
        _linear(out, "att_proj", model.att_proj)
    return out


def _get(tree, path: str):
    for key in path.split("."):
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) else tree[key]
    return tree


def _n_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_leaves(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_n_leaves(v) for v in tree)
    return 1


@torch.no_grad()
def load_jax_params(model: CTRModel, params_np: dict) -> CTRModel:
    """Copy ``params_np`` into ``model`` in place; returns the model. Raises
    where a leaf is missing, does not fit, or the tree holds leaves the
    model does not."""
    leaves = _leaves(model)
    for path, (t, row, transpose) in leaves.items():
        src = np.asarray(_get(params_np, path))
        _copy(t if row is None else t[row], src.T if transpose else src, path)
    if _n_leaves(params_np) != len(leaves):
        raise ValueError(f"params hold {_n_leaves(params_np)} leaves, the model "
                         f"{len(leaves)}")
    return model


def export_params(model: CTRModel, grad: bool = False) -> dict:
    """The JAX package's params pytree of ``model`` as numpy arrays (its
    ``.grad``s with ``grad=True``; zeros where a parameter has none),
    copied: later updates of the model do not reach them."""
    def arr(t: torch.Tensor, row, transpose: bool) -> np.ndarray:
        if grad:
            t = torch.zeros_like(t) if t.grad is None else t.grad
        x = (t if row is None else t[row]).detach().float().cpu().numpy()
        return np.array(x.T if transpose else x, order="C")    # a copy, never a view

    tree: dict = {"interest": {}}
    for path, (t, row, transpose) in _leaves(model).items():
        *keys, leaf = path.split(".")
        node = tree
        for key in keys:
            node = node.setdefault(key, {})
        node[leaf] = arr(t, row, transpose)    # R, a buffer, has no .grad: zeros
    if "blocks" in tree:                       # the reference keeps the blocks in a list
        tree["blocks"] = [tree["blocks"][str(j)] for j in range(len(tree["blocks"]))]
    return tree


MLA_LINEARS = ("wq_a", "wq_b", "wkv_a", "wk_b", "wv_b", "wo")


def _block_leaves(block) -> dict:
    """One LM block's tensors by their path within the reference's block
    -> (tensor, transposed there)."""
    from repro_torch.nn.attention import MLAttention
    from repro_torch.nn.moe import MoELayer

    leaves = {}
    for ln in ("ln1", "ln2"):
        for name in ("scale", "bias"):
            if hasattr(getattr(block, ln), name):
                leaves[f"{ln}.{name}"] = (getattr(getattr(block, ln), name), False)

    def linear(path, lin):
        leaves[f"{path}.w"] = (lin.weight, True)
        if lin.bias is not None:
            leaves[f"{path}.b"] = (lin.bias, False)

    attn, ffn = block.attn, block.ffn
    if isinstance(attn, MLAttention):
        for name in MLA_LINEARS:
            linear(f"attn.{name}", getattr(attn, name))
        for name in ("q_a_norm", "kv_a_norm"):
            leaves[f"attn.{name}.scale"] = (getattr(attn, name).scale, False)
    else:
        for name in ("wq", "wk", "wv", "wo"):
            linear(f"attn.{name}", getattr(attn, name))
        if attn.qk_norm:
            leaves["attn.q_norm.scale"] = (attn.q_norm.scale, False)
            leaves["attn.k_norm.scale"] = (attn.k_norm.scale, False)
    if isinstance(ffn, MoELayer):
        leaves["ffn.router.w"] = (ffn.router.w, False)
        for part in ("experts", "shared") if ffn.n_shared else ("experts",):
            for name in ("wi_gate", "wi_up", "wo"):
                leaves[f"ffn.{part}.{name}"] = (getattr(getattr(ffn, part), name), False)
    else:
        for name in ("wi_gate", "wi_up", "wo"):
            linear(f"ffn.{name}", getattr(ffn, name))
    return leaves


def _lm_leaves(model) -> dict:
    """Every parameter of an ``LMModel`` by its path in the reference's
    tree -> (tensor, or one tensor a layer for the stack's leaves;
    transposed there)."""
    out = {"embed.table": (model.embed.weight, False)}
    for name in ("scale", "bias"):
        if hasattr(model.final_norm, name):
            out[f"final_norm.{name}"] = (getattr(model.final_norm, name), False)
    if not model.cfg.tie_embeddings:
        out["lm_head.w"] = (model.lm_head.weight, True)
    for i, block in enumerate(model.dense_blocks):
        for path, leaf in _block_leaves(block).items():
            out[f"dense_blocks.{i}.{path}"] = leaf
    per_layer: dict = {}
    for block in model.stack:
        for path, (t, transpose) in _block_leaves(block).items():
            per_layer.setdefault(f"stack.{path}", ([], transpose))[0].append(t)
    out.update(per_layer)
    return out


@torch.no_grad()
def load_jax_lm_params(model, params_np: dict, R) -> "LMModel":
    """Copy ``params_np`` (the reference's LM params as numpy arrays) and
    the hash matrix ``R`` (sdim_m, head_dim or kv_lora_rank) into ``model``
    in place;
    returns the model. Raises where a leaf is missing, does not fit, or the
    tree holds leaves the model does not."""
    leaves = _lm_leaves(model)
    for path, (t, transpose) in leaves.items():
        src = np.asarray(_get(params_np, path))
        if isinstance(t, list):
            if src.shape[0] != len(t):
                raise ValueError(f"{path}: {src.shape[0]} layers for a stack of {len(t)}")
            for i, ti in enumerate(t):
                _copy(ti, src[i].T if transpose else src[i], f"{path}[{i}]")
        else:
            _copy(t, src.T if transpose else src, path)
    if _n_leaves(params_np) != len(leaves):
        raise ValueError(f"params hold {_n_leaves(params_np)} leaves, the model "
                         f"{len(leaves)}")
    _copy(model.R, R, "R")
    model.R64.copy_(model.R)
    return model


def export_lm_params(model) -> dict:
    """The reference's params pytree of an ``LMModel`` as numpy arrays
    (copies; the stack's leaves stacked on a leading n_layers axis), the
    inverse of ``load_jax_lm_params``. R is not in it."""
    def arr(t: torch.Tensor, transpose: bool) -> np.ndarray:
        x = t.detach().float().cpu().numpy()
        return np.array(x.T if transpose else x, order="C")

    tree: dict = {}
    for path, (t, transpose) in _lm_leaves(model).items():
        *keys, leaf = path.split(".")
        node = tree
        for key in keys:
            node = node.setdefault(key, {})
        node[leaf] = (np.stack([arr(ti, transpose) for ti in t]) if isinstance(t, list)
                      else arr(t, transpose))
    if "dense_blocks" in tree:                 # the reference keeps them in a list
        tree["dense_blocks"] = [tree["dense_blocks"][str(i)]
                                for i in range(len(tree["dense_blocks"]))]
    return tree
