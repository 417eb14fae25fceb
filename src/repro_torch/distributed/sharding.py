"""Per-family parameter sharding rules, and parameters placed as blocks.

Counterpart of ``repro/distributed/sharding.py``. Mesh convention:
``("data", "model")`` on one pod, ``("pod", "data", "model")`` across pods
(the pod axis folds into data parallelism). The rules are path-substring
matchers over normalized parameter paths (``stack/attn/wq/w``) and adapt to
rank: a rule's spec matches the TRAILING dimensions, and leading ones (a
stacked layer axis) get None.

Layouts:

* LM: Megatron tensor parallelism on the model axis (attention heads, FFN
  width, vocab), the expert axis for a mixture of experts (the split of
  ``nn/moe.py``'s expert-parallel path), the shared experts' width split;
  embedding and lm_head split over the vocab;
* recsys: the embedding tables split by rows over the model axis (the
  tables ARE the model); the dense towers replicated;
* gnn: replicated; the edges split at the activation level
  (``models/gnn.py``).

``zero1_spec`` extends a parameter's spec by splitting its largest unsplit
dimension over the data axes, for the optimizer state (ZeRO-1).

The rules read the reference's tree: its paths and its shapes, the tree
``weights.export_{params,lm_params,gnn_params}`` give, checkpoints hold and
``weights.reference_shapes`` lists without data. They do not apply to the
port's own tensors: an ``nn.Linear.weight`` is the transpose of the
reference's ``w``, the stack's leaves carry a leading layer axis there
(rank decides the spec) and wide_deep's field tables are one leaf a field.
A path is the reference's keystr (``"['stack']['attn']['wq']['w']"``), a
path joined by ``/`` or by ``.`` (``dense_blocks.0.ffn.wo.w``).

A spec is the tuple ``tuple(PartitionSpec(...))`` gives: each entry None,
an axis name or a tuple of names. A mesh is anything with a ``.shape``
mapping of axis name to size (a ``MeshCtx``), or such a mapping itself
(``{"pod": 2, "data": 16, "model": 16}``).

Placement (``shard_params``, ``Placement``) needs a ``MeshCtx``. The port's
modules compute on whole tensors; a placed leaf is its blocks, what each
card of the mesh would hold: a dimension whose spec entry names axes is
split into ``prod(axis sizes)`` blocks, the blocks of all dimensions taken
in row-major order over the block grid, and block k goes on
``devices[k % n_shards]`` (``MeshCtx.axis_devices``' rule). One process
holds one copy of a block that the mesh replicates. ``gather`` rebuilds
the whole tensor.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import re
from collections.abc import Mapping
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.distributed.mesh_ctx import MeshCtx, block_size, canonical

# rule table: (substring, trailing spec)
LM_RULES: list[tuple[str, tuple]] = [
    ("embed/table", ("model", None)),
    ("lm_head/w", (None, "model")),
    ("attn/wq_a/w", (None, None)),
    ("attn/wkv_a/w", (None, None)),
    ("attn/wq_b/w", (None, "model")),
    ("attn/wk_b/w", (None, "model")),
    ("attn/wv_b/w", (None, "model")),
    ("attn/wq/w", (None, "model")),
    ("attn/wk/w", (None, "model")),
    ("attn/wv/w", (None, "model")),
    ("attn/wo/w", ("model", None)),
    ("ffn/experts/wi_gate", ("model", None, None)),
    ("ffn/experts/wi_up", ("model", None, None)),
    ("ffn/experts/wo", ("model", None, None)),
    ("ffn/shared/wi_gate", (None, None, "model")),
    ("ffn/shared/wi_up", (None, None, "model")),
    ("ffn/shared/wo", (None, "model", None)),
    ("ffn/router", (None, None)),
    ("ffn/wi_gate/w", (None, "model")),
    ("ffn/wi_up/w", (None, "model")),
    ("ffn/wo/w", ("model", None)),
]

RECSYS_RULES: list[tuple[str, tuple]] = [
    ("item_emb/table", ("model", None)),
    ("cat_emb/table", ("model", None)),
    ("field_tables", ("model", None)),
    ("wide/", ("model", None)),
]

GNN_RULES: list[tuple[str, tuple]] = []

FAMILY_RULES = {"lm": LM_RULES, "recsys": RECSYS_RULES, "gnn": GNN_RULES}


def table_store_spec(axis: str = "model") -> tuple:
    """The spec of the serving side's (S, C, G, U, d) BSE table store
    (``serve/table_store.ShardedTableStore``): slots over the model axis,
    the recsys rule of the embedding tables (the per-user tables ARE the
    model)."""
    return (axis, None, None, None, None)


def _norm(path: str) -> str:
    """A keystr, ``/``-joined or dotted path -> ``stack/attn/wq/w``."""
    parts = re.findall(r"\['?([^'\]]+)'?\]", path)
    if parts:
        return "/".join(parts)
    return path.replace(".", "/").strip("/")


def _sizes(mesh) -> Mapping:
    return mesh if isinstance(mesh, Mapping) else mesh.shape


def _names(entry) -> tuple:
    """A spec entry's axis names (None: none)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axis_sizes(mesh, axes) -> int:
    sizes = _sizes(mesh)
    return math.prod(sizes[a] for a in _names(axes))


def _pad(tail: tuple, ndim: int) -> tuple:
    if ndim < len(tail):
        return ()                     # a leaf of lower rank than the rule (a bias): replicated
    return (None,) * (ndim - len(tail)) + tuple(tail)


def param_spec(family: str, path: str, shape: tuple) -> tuple:
    """The first rule of ``family`` whose substring the normalized path
    holds, padded to the leaf's rank; () (replicated) where none does."""
    p = _norm(path)
    for sub, tail in FAMILY_RULES[family]:
        if sub in p:
            return _pad(tail, len(shape))
    return ()


def valid_for_mesh(spec: tuple, shape: tuple, mesh) -> tuple:
    """``spec`` with every entry whose axes do not divide its dimension
    replicated (8 kv heads over 16; a vocab of 49,155 over 4), trailing
    Nones stripped."""
    fixed = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        fixed.append(ax if ax is not None and dim % _axis_sizes(mesh, ax) == 0 else None)
    while fixed and fixed[-1] is None:
        fixed.pop()
    return tuple(fixed)


def zero1_spec(spec: tuple, shape: tuple, mesh, data_axes: Sequence[str] = ("data",)) -> tuple:
    """The optimizer state's spec: ``spec`` with its largest unsplit
    dimension that the data axes divide split over them too (ZeRO-1: m and
    v never replicated across data parallelism)."""
    tail = tuple(spec) + (None,) * (len(shape) - len(spec))
    dp = _axis_sizes(mesh, tuple(data_axes))
    best, best_dim = -1, -1
    for i, (dim, ax) in enumerate(zip(shape, tail)):
        if ax is None and dim % dp == 0 and dim > best_dim:
            best, best_dim = i, dim
    if best < 0:
        return valid_for_mesh(spec, shape, mesh)
    new = list(tail)
    new[best] = tuple(data_axes) if len(data_axes) > 1 else data_axes[0]
    return valid_for_mesh(tuple(new), shape, mesh)


@dataclasses.dataclass
class ShardedLeaf:
    """A tensor as the blocks of ``spec`` over a mesh: ``grid`` blocks
    along each dimension, ``blocks`` in row-major order over the grid, block
    k on ``devices[k]``."""
    spec: tuple
    shape: tuple
    grid: tuple
    blocks: list

    @property
    def devices(self) -> tuple:
        return tuple(b.device for b in self.blocks)

    @property
    def block_bytes(self) -> int:
        """What one card holds of this leaf: one block's bytes."""
        return self.blocks[0].numel() * self.blocks[0].element_size()


@dataclasses.dataclass(frozen=True)
class Placement:
    """The port's ``NamedSharding``: a ``MeshCtx`` and a spec."""
    mesh: MeshCtx
    spec: tuple

    def place(self, x) -> ShardedLeaf:
        """``x`` (a tensor or an array) as its blocks on the mesh's
        devices; raises where an entry's axes do not divide its dimension,
        as ``device_put`` does."""
        x = torch.as_tensor(x)
        spec = tuple(self.spec) + (None,) * (x.dim() - len(self.spec))
        if len(spec) > x.dim():
            raise ValueError(f"a spec of {len(self.spec)} entries for a leaf of rank {x.dim()}")
        grid = tuple(_axis_sizes(self.mesh, ax) for ax in spec)
        sizes = [block_size(n, g, f"dimension {i} (spec {spec[i]!r})")
                 for i, (n, g) in enumerate(zip(x.shape, grid))]
        blocks = []
        for k, idx in enumerate(itertools.product(*(range(g) for g in grid))):
            dev = self.mesh.devices[k % self.mesh.n_shards]
            sl = tuple(slice(j * s, (j + 1) * s) for j, s in zip(idx, sizes))
            blocks.append(x[sl].to(dev, copy=True).contiguous())
        return ShardedLeaf(tuple(self.spec), tuple(x.shape), grid, blocks)


def gather(leaf: ShardedLeaf, device=None) -> torch.Tensor:
    """The whole tensor of ``leaf`` on ``device`` (default: the first
    block's)."""
    first = leaf.blocks[0]
    dev = canonical(device) if device is not None else first.device
    out = torch.empty(leaf.shape, dtype=first.dtype, device=dev)
    sizes = [n // g for n, g in zip(leaf.shape, leaf.grid)]
    for idx, blk in zip(itertools.product(*(range(g) for g in leaf.grid)), leaf.blocks):
        out[tuple(slice(j * s, (j + 1) * s) for j, s in zip(idx, sizes))] = blk.to(dev)
    return out


def param_sharding_fn(family: str, mesh: MeshCtx):
    """(path, shape) -> the ``Placement`` of a parameter, for a restore or
    an init onto ``mesh``."""
    def fn(path: str, shape: tuple) -> Placement:
        return Placement(mesh, valid_for_mesh(param_spec(family, path, shape), shape, mesh))
    return fn


def opt_state_sharding_fn(family: str, mesh: MeshCtx, data_axes=("data",)):
    """The ZeRO-1 placement of an optimizer state tree (m, v: the
    parameters' paths)."""
    def fn(path: str, shape: tuple) -> Placement:
        base = param_spec(family, path, shape)
        return Placement(mesh, zero1_spec(base, shape, mesh, data_axes))
    return fn


def map_tree(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a tree of dicts and lists (a list index is a
    path component), the path joined by ``/``."""
    if isinstance(tree, Mapping):
        return {k: map_tree(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return fn(prefix.rstrip("/"), tree)


def shard_params(params, family: str, mesh: MeshCtx):
    """Every leaf of a reference-layout tree (``weights.export_*``; numpy
    arrays or tensors) as a ``ShardedLeaf`` of its valid spec over
    ``mesh``."""
    def place(path, leaf):
        shape = tuple(np.shape(leaf))
        return Placement(mesh, valid_for_mesh(param_spec(family, path, shape), shape,
                                              mesh)).place(leaf)
    return map_tree(place, params)


def gather_tree(tree, device=None):
    """Every ``ShardedLeaf`` of ``tree`` whole (``gather``); other leaves
    as they are."""
    return map_tree(lambda _, leaf: gather(leaf, device) if isinstance(leaf, ShardedLeaf)
                    else leaf, tree)


def flatten(tree) -> dict:
    """{``/``-joined path: leaf} of a tree of dicts and lists, in order."""
    out = {}

    def visit(path, leaf):
        out[path] = leaf

    map_tree(visit, tree)
    return out


def shard_bytes(tree) -> int:
    """The bytes one card of the mesh holds of a tree of ``ShardedLeaf``s."""
    return sum(leaf.block_bytes for leaf in flatten(tree).values())


def spec_tree(tree) -> dict:
    """The spec of every ``ShardedLeaf`` of ``tree``, by ``/``-joined path."""
    return {path: leaf.spec for path, leaf in flatten(tree).items()}
