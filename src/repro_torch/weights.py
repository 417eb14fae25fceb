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

``load_jax_gnn_params`` / ``export_gnn_params`` do the same for
``repro.models.gnn.GatedGCN.init``'s pytree and the port's ``GatedGCN``:
``node_enc.{w,b}``, ``edge_enc.{w,b}``, ``out.fc{0,1}.{w,b}`` and the
``layers.*`` leaves (``{A,B,C,U,V}.{w,b}``, ``{ln_h,ln_e}.{scale,bias}``),
which carry a leading n_layers axis (the reference's vmapped init), row i
for layer i; Linear weights transposed as everywhere here.

All of them go through one walk, ``load_tree`` / ``export_tree``, which
take and give the same trees with tensors as leaves (``launch/specs.py``'s
cells hold them so); the numpy functions above convert at the ends.

``reference_shapes`` lists a CTR, LM or GNN model's leaves by their paths
in the reference's tree with the reference's shapes (transposed, stacked,
per field), from the tensors' shapes only: on a model built on
``device="meta"`` it reads no data. ``distributed/sharding.py``'s rules
take these paths and shapes.
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


def load_jax_params(model: CTRModel, params_np: dict) -> CTRModel:
    """Copy ``params_np`` into ``model`` in place; returns the model. Raises
    where a leaf is missing, does not fit, or the tree holds leaves the
    model does not."""
    load_tree(model, params_np)
    return model


def export_params(model: CTRModel, grad: bool = False) -> dict:
    """The JAX package's params pytree of ``model`` as numpy arrays (its
    ``.grad``s with ``grad=True``; zeros where a parameter has none, R a
    buffer among them, as ``jax.grad`` gives it), copied: later updates of
    the model do not reach them."""
    tree = _numpy(export_tree(model, grad))
    tree.setdefault("interest", {})            # kind "none" keeps an empty node
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


def load_jax_lm_params(model, params_np: dict, R) -> "LMModel":
    """Copy ``params_np`` (the reference's LM params as numpy arrays) and
    the hash matrix ``R`` (sdim_m, head_dim or kv_lora_rank) into ``model``
    in place; returns the model. Raises where a leaf is missing, does not
    fit, or the tree holds leaves the model does not."""
    load_tree(model, params_np)
    with torch.no_grad():
        _copy(model.R, R, "R")
        model.R64.copy_(model.R)
    return model


def export_lm_params(model, grad: bool = False) -> dict:
    """The reference's params pytree of an ``LMModel`` as numpy arrays
    (copies; the stack's leaves stacked on a leading n_layers axis), the
    inverse of ``load_jax_lm_params``; with ``grad=True`` the parameters'
    ``.grad``s in the same tree (zeros where a parameter has none), the tree
    ``jax.grad`` of the reference's loss gives. R is not in it."""
    return _numpy(export_tree(model, grad))


def _gnn_leaves(model) -> dict:
    """Every parameter of a ``GatedGCN`` by its path in the reference's
    tree -> (tensor, or one tensor a layer for ``layers.*``; transposed
    there)."""
    out = {}
    for path, lin in (("node_enc", model.node_enc), ("edge_enc", model.edge_enc),
                      ("out.fc0", model.out.fc0), ("out.fc1", model.out.fc1)):
        out[f"{path}.w"], out[f"{path}.b"] = (lin.weight, True), (lin.bias, False)
    for layer in model.layers:
        per_layer = {f"{n}.{leaf}": (getattr(getattr(layer, n), attr), leaf == "w")
                     for n in ("A", "B", "C", "U", "V")
                     for leaf, attr in (("w", "weight"), ("b", "bias"))}
        per_layer.update({f"{n}.{leaf}": (getattr(getattr(layer, n), leaf), False)
                          for n in ("ln_h", "ln_e") for leaf in ("scale", "bias")})
        for path, (t, transpose) in per_layer.items():
            out.setdefault(f"layers.{path}", ([], transpose))[0].append(t)
    return out


def load_jax_gnn_params(model, params_np: dict):
    """Copy ``params_np`` (the reference's GatedGCN params as numpy arrays)
    into ``model`` in place; returns the model. Raises where a leaf is
    missing, does not fit, or the tree holds leaves the model does not."""
    load_tree(model, params_np)
    return model


def export_gnn_params(model, grad: bool = False) -> dict:
    """The reference's params pytree of a ``GatedGCN`` as numpy arrays
    (copies; ``layers.*`` stacked on a leading n_layers axis), the inverse of
    ``load_jax_gnn_params``; with ``grad=True`` the parameters' ``.grad``s in
    the same tree (zeros where a parameter has none)."""
    return _numpy(export_tree(model, grad))


def _model_leaves(model) -> dict:
    """path -> (tensor or per-layer list, row or None, transposed) of a
    CTR, LM or GNN model."""
    from repro_torch.models.gnn import GatedGCN
    from repro_torch.models.lm import LMModel

    if isinstance(model, CTRModel):
        return _leaves(model)
    if isinstance(model, LMModel):
        leaves = _lm_leaves(model)
    elif isinstance(model, GatedGCN):
        leaves = _gnn_leaves(model)
    else:
        raise TypeError(f"no reference tree for {type(model).__name__}")
    return {path: (t, None, transpose) for path, (t, transpose) in leaves.items()}


def reference_shapes(model) -> dict:
    """{dotted path in the reference's tree (a list index is a number):
    the leaf's shape there} for a ``CTRModel``, ``LMModel`` or
    ``GatedGCN``; no tensor is read."""
    out = {}
    for path, (t, row, transpose) in _model_leaves(model).items():
        if isinstance(t, list):
            one = tuple(t[0].shape)
            out[path] = (len(t), *(one[::-1] if transpose else one))
        else:
            one = tuple(t.shape if row is None else t.shape[1:])
            out[path] = one[::-1] if transpose else one
    return out


def _nest(flat: dict) -> dict:
    """{dotted path: leaf} -> the reference's tree: a node whose keys are
    all numbers is a list (``blocks``, ``dense_blocks``)."""
    tree: dict = {}
    for path, leaf in flat.items():
        *keys, last = path.split(".")
        node = tree
        for key in keys:
            node = node.setdefault(key, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return lists(tree)


@torch.no_grad()
def load_tree(model, tree) -> None:
    """Copy ``tree`` (the reference's params tree of a CTR, LM or GNN model
    with tensors, on any device, or numpy arrays as leaves, in any float
    dtype) into ``model`` in place, cast to each parameter's dtype; raises
    where a leaf is missing or does not fit, or the tree holds leaves the
    model does not."""
    leaves = _model_leaves(model)
    for path, (t, row, transpose) in leaves.items():
        src = _get(tree, path)
        if not isinstance(src, torch.Tensor):
            src = torch.from_numpy(np.array(src, np.float32))
        if isinstance(t, list):
            if src.shape[0] != len(t):
                raise ValueError(f"{path}: {src.shape[0]} layers for a stack of {len(t)}")
            parts = [(ti, src[i]) for i, ti in enumerate(t)]
        else:
            parts = [(t if row is None else t[row], src)]
        for dst, s in parts:
            s = s.T if transpose else s
            if tuple(s.shape) != tuple(dst.shape):
                raise ValueError(f"{path}: shape {tuple(s.shape)} does not fit "
                                 f"{tuple(dst.shape)}")
            dst.copy_(s)
    if _n_leaves(tree) != len(leaves):
        raise ValueError(f"the tree holds {_n_leaves(tree)} leaves, the model {len(leaves)}")


def export_tree(model, grad: bool = False) -> dict:
    """The reference's params tree of a CTR, LM or GNN model as tensors on
    the model's device (copies; a stacked leaf's layers on a leading axis),
    the inverse of ``load_tree``; with ``grad=True`` the ``.grad``s (zeros
    where a tensor has none)."""
    def one(t, row, transpose):
        if grad:
            t = torch.zeros_like(t) if t.grad is None else t.grad
        t = t if row is None else t[row]
        return (t.T if transpose else t).detach().clone(memory_format=torch.contiguous_format)

    flat = {}
    for path, (t, row, transpose) in _model_leaves(model).items():
        flat[path] = (torch.stack([one(ti, None, transpose) for ti in t])
                      if isinstance(t, list) else one(t, row, transpose))
    return _nest(flat)


def _numpy(tree):
    """``export_tree``'s tree with its leaves as fp32 numpy arrays."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.float().cpu().numpy()


@torch.no_grad()
def load_jax_embedding_collection(collection, params_np: dict):
    """Copy the reference's ``EmbeddingCollection`` params (``{"tables":
    {field name: (vocab, dim)}}`` as numpy arrays) into ``collection`` (the
    port's ``embedding/sharded.EmbeddingCollection``) in place; returns it.
    Raises where a table is missing or does not fit, or the tree holds
    tables the collection does not."""
    tables = params_np["tables"]
    if set(tables) != set(collection.tables):
        raise ValueError(f"tables {sorted(tables)} for fields {sorted(collection.tables)}")
    for name, t in collection.tables.items():
        _copy(t, tables[name], f"tables.{name}")
    return collection
