"""Per-cell abstract arguments and step functions for the dry run.

Counterpart of ``repro/launch/specs.py``. ``build_cell(arch, shape, mesh,
variant)`` returns a ``Cell``: the port's step for that (arch x shape)
cell and its arguments as a tree of ``Leaf``s, the reference's argument
tree leaf for leaf (the same paths, as the reference's ``keystr``; the
same shapes, dtypes and specs). A ``Leaf`` is an abstract stand-in: shape,
``torch.dtype``, spec tuple (the reference's ``tuple(PartitionSpec)``) and
path; the trees are read off models built on ``device="meta"``
(``weights.reference_shapes``), so nothing is allocated. Specs come from
``distributed/sharding.py``: ``param_spec`` with ``zero1_spec`` (LM
parameters, every optimizer state) or ``valid_for_mesh``.

Layouts (the reference's):

* LM train / prefill: parameters fp32 (bf16 for prefill and decode)
  split ZeRO-1 x TP; tokens over the data axes;
* LM decode: the exact cache split on its sequence axis (decode_32k:
  batch over the data axes, sequence over ``model``; long_500k, B = 1:
  sequence over every axis); the ``sdim_kv`` variant swaps in the bucket
  tables;
* recsys: tables split by rows over ``model``, the batch over the data
  axes (train) or over every axis (serve, retrieval);
* gnn: parameters replicated, edges split over every axis.

Variants: ``amp`` (bf16 compute), ``opt`` (amp and four microbatches),
``bf16params`` (parameters stored bf16, an fp32 master in the optimizer
state), ``manual_tp`` (the manual Megatron FFN) for LM train;
``sdim_kv`` for LM decode; ``bf16emb`` (recsys parameters bf16) and
``target_attention`` (the interest kind ``target``) for recsys.

``step_fn`` runs the port's step on materialized arguments
(``materialize``): tensors in the reference's layout, on one device. It
loads the parameters into the port's model (built on the arguments'
device on the first call, ``Cell.runner.model``), runs it under the
``MeshCtx`` of ``launch/mesh.step_ctx`` (every block on that device, pod
folded into data) and, in a train cell, updates the state tree in place
(the reference donates it) through ``train/optimizer.apply_updates``.
The model's parameters take the tree's dtype: bf16 parameters (LM
inference, ``bf16params``, ``bf16emb``) compute in bf16, as the reference's
step does under ``jit``, and their gradients are bf16. The exact cache is head-major in the port (``models/lm.py``): a
decode step transposes it.

Departures: nothing is lowered or compiled, so ``unroll`` (the
reference's flat-loop lowering for cost analysis) is only recorded;
``depth_override`` cuts the LM's scanned depth, as in the reference.
``build_cell`` also takes ``overrides`` (the shape's entries, e.g. a
smaller ``global_batch``), for a cut step on one card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch
from torch import nn

from repro_torch.configs import registry
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import all_axes, data_axes, fold_axes, step_ctx
from repro_torch.train.optimizer import OptimizerConfig, apply_updates
from repro_torch.weights import _nest, export_tree, load_tree, reference_shapes


def P(*entries) -> tuple:
    """``tuple(PartitionSpec(*entries))``: a one-name tuple entry becomes
    the name, as JAX normalizes it."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


@dataclasses.dataclass(frozen=True)
class Leaf:
    """An abstract argument. ``fill`` says how ``materialize`` draws it:
    ``normal`` (N(0, std²)), ``ones``, ``zeros``, ``int`` (uniform in
    [0, high)), ``mask`` (1 with probability 0.8, else 0), ``label`` (0 or
    1), ``count`` (whole numbers in [0, 4]) or ``like`` (a copy of the
    leaf at path ``like``, in this dtype)."""
    shape: tuple
    dtype: torch.dtype
    spec: tuple = ()
    path: str = ""
    fill: str = "normal"
    std: float = 1.0
    high: int = 0
    like: str = ""

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def itemsize(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    def block_shape(self, mesh) -> tuple:
        """The block one chip holds (``Placement.place``'s cut; the
        reference's ``shard_shape``). Raises where an entry's axes do not
        divide its dimension."""
        sizes = mesh.shape
        spec = tuple(self.spec) + (None,) * (self.ndim - len(self.spec))
        out = []
        for n, entry in zip(self.shape, spec):
            k = math.prod(sizes[a] for a in shd._names(entry))
            if n % k:
                raise ValueError(f"{self.path}: {n} does not split into {k} blocks")
            out.append(n // k)
        return tuple(out)

    def block_bytes(self, mesh) -> int:
        return math.prod(self.block_shape(mesh)) * self.itemsize


def tree_leaves(tree) -> list:
    """The ``Leaf``s (or tensors) of a tree of tuples, lists and dicts, in
    order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, path: str = ""):
    """``fn(keystr, leaf)`` over a tree; the key string is the reference's
    ``keystr``: ``['name']`` for a dict key, ``[i]`` for a list or tuple
    index."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, f"{path}['{k}']") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, f"{path}[{i}]") for i, v in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(path, tree)


def _with_paths(args: tuple) -> tuple:
    return tree_map(lambda p, leaf: dataclasses.replace(leaf, path=p), args)


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    step_fn: Callable
    abstract_args: tuple
    donate: tuple = ()
    variant: str = "baseline"
    note: str = ""
    outputs: Any = ()            # the step's outputs as Leafs (counted by the dry run)
    compute_dtype: str = "float32"
    runner: Any = None
    unroll: bool = False
    depth_override: Optional[int] = None

    @property
    def name(self) -> str:
        v = "" if self.variant == "baseline" else f"+{self.variant}"
        return f"{self.arch}/{self.shape}{v}"


class Runner:
    """The port's model of a cell: built on the first call's device (a
    seeded init, then overwritten), its parameters loaded from each call's
    tree."""

    def __init__(self, build: Callable[[torch.device], nn.Module], mesh):
        self.build = build
        self.mesh = mesh
        self.model = None

    def bind(self, params, R=None) -> nn.Module:
        """The model on the tree's device, its parameters in the tree's
        float dtype (bf16 parameters compute in bf16, as under ``jit``),
        loaded from ``params``; ``R``, where given, replaces an LM's hash
        matrix (the reference draws it inside its model, outside the
        tree)."""
        leaves = tree_leaves(params)
        dev = leaves[0].device
        dtype = next(t.dtype for t in leaves if t.is_floating_point())
        if self.model is None or next(self.model.parameters()).device != dev:
            self.model = self.build(dev)
        for p in self.model.parameters():
            if p.dtype != dtype:
                p.data = p.data.to(dtype)
        if R is not None:
            with torch.no_grad():
                self.model.R.copy_(R)
                self.model.R64.copy_(self.model.R)
        load_tree(self.model, params)
        return self.model

    def ctx(self, device, **kw):
        return step_ctx(self.mesh, device, **kw)


def _generator(dev: torch.device) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(0)


_META: dict = {}


def _meta(cls, cfg) -> nn.Module:
    """``cls(cfg)`` on ``meta`` (shapes only), built once per config: the
    cells of one arch share it."""
    key = (cls.__name__, repr(cfg))
    if key not in _META:
        _META[key] = cls(cfg, device="meta")
    return _META[key]


# ---------------------------------------------------------------------------
# argument trees
# ---------------------------------------------------------------------------
def _param_leaves(model, family: str, mesh, dp, *, fsdp: bool, dtype=None) -> dict:
    """The reference's params tree of ``model`` (on meta) as Leafs with the
    parameter specs; ``dtype`` replaces every float leaf's."""
    def leaf(dotted, shape):
        key = "".join(f"[{k}]" if k.isdigit() else f"['{k}']" for k in dotted.split("."))
        spec = shd.param_spec(family, key, shape)
        spec = (shd.zero1_spec(spec, shape, mesh, dp) if fsdp
                else shd.valid_for_mesh(spec, shape, mesh))
        fill = "ones" if dotted.endswith(".scale") else "normal"
        return Leaf(shape, dtype or torch.float32, spec, fill=fill, std=0.02)
    return _nest({p: leaf(p, s) for p, s in reference_shapes(model).items()})


def _state_leaves(model, family: str, mesh, dp, opt_cfg: OptimizerConfig,
                  param_dtype=None) -> dict:
    """{"params", "opt"}: the optimizer state ZeRO-1 split, its paths the
    reference's (``init_opt_state`` of the params tree)."""
    params = _param_leaves(model, family, mesh, dp, fsdp=family == "lm", dtype=param_dtype)

    def moment(fill):
        def one(key, p):
            spec = shd.zero1_spec(shd.param_spec(family, key, p.shape), p.shape, mesh, dp)
            return Leaf(p.shape, torch.float32, spec, fill=fill)
        return one

    opt = {"count": Leaf((), torch.int32, (), fill="zeros")}
    names = {"adamw": ("m", "v"), "adagrad": ("v",), "sgd": ("m",)}[opt_cfg.kind]
    if opt_cfg.master_weights:
        opt["master"] = tree_map(lambda k, p: dataclasses.replace(
            moment("like")(f"['master']{k}", p), like=f"[0]['params']{k}"), params)
    for name in names:
        opt[name] = tree_map(lambda k, p, n=name: moment("zeros")(f"['{n}']{k}", p), params)
    return {"params": params, "opt": opt}


def _axes_size(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes or ())


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------
def _update(state: dict, grads: dict, opt_cfg: OptimizerConfig) -> None:
    """One optimizer update of the state tree in place: the reference's
    ``apply_updates`` through the port's, over a module whose parameters are
    the tree's leaves (``buffers`` leaves never updated)."""
    flat = shd.flatten(state["params"])
    holder = nn.Module()
    for name, t in flat.items():
        if "buffers" in name:
            holder.register_buffer(name, t)
        else:
            holder.register_parameter(name, nn.Parameter(t, requires_grad=False))
    trainable = [n for n in flat if "buffers" not in n]
    gflat = shd.flatten(grads)
    g = {n: gflat[n].to(flat[n].dtype) for n in trainable}     # jax.grad: the param's dtype
    opt = state["opt"]
    st = {"count": opt["count"]}
    for key in ("m", "v", "master"):
        if key in opt:
            moments = shd.flatten(opt[key])
            st[key] = {n: moments[n] for n in trainable}
    st, _ = apply_updates(holder, g, st, opt_cfg)
    opt["count"] = st["count"]


def _train_step(runner: Runner, opt_cfg: OptimizerConfig, loss_fn, micro: int = 1):
    """step(state, batch) -> (state, loss): loss and gradients (``micro``
    microbatches, summed in order), then one update of the state tree."""
    def step(state, batch):
        model = runner.bind(state["params"])
        for p in model.parameters():
            p.grad = None
        B = next(iter(batch.values())).shape[0]
        loss = None
        for i in range(micro):          # one microbatch: the batch (a graph) as it is
            mb = batch if micro == 1 else {k: v[i * B // micro:(i + 1) * B // micro]
                                           for k, v in batch.items()}
            l_i = loss_fn(model, mb)
            l_i.backward()
            loss = l_i.detach() if loss is None else loss + l_i.detach()
        grads = export_tree(model, grad=True)
        for p in model.parameters():
            p.grad = None
        if micro > 1:
            loss = loss / micro
            grads = tree_map(lambda _, g: g / micro, grads)
        _update(state, grads, opt_cfg)
        return state, loss
    return step


def _to_port_cache(cache: dict) -> dict:
    """The reference's exact cache (GQA k, v (.., S, Hkv, D)) in the port's
    head-major layout (.., Hkv, S, D); latent caches keep theirs."""
    def one(name, t):
        return t.transpose(-3, -2) if name in ("k", "v") else t
    out = {"stack": {n: one(n, t) for n, t in cache["stack"].items()}}
    if "dense" in cache:
        out["dense"] = [{n: one(n, t) for n, t in c.items()} for c in cache["dense"]]
    return out


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------
LM_FLAGS = {
    "baseline": dict(amp=False, micro=1),
    "amp": dict(amp=True, micro=1),
    "opt": dict(amp=True, micro=4),
    "bf16params": dict(amp=False, micro=1, bf16_params=True),
    "manual_tp": dict(amp=False, micro=1, manual_tp=True),
}


def _lm_cell(arch, shape_name, shape, mesh, variant, depth_override=None) -> Cell:
    from repro_torch.models.lm import LMModel

    cfg = registry.get(arch).FULL
    flags = LM_FLAGS.get(variant, LM_FLAGS["baseline"]) if shape["kind"] == "train" \
        else LM_FLAGS["baseline"]
    if flags["amp"]:
        cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    if depth_override is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth_override + cfg.first_k_dense)
    meta = _meta(LMModel, cfg)
    dp = data_axes(mesh)
    runner = Runner(lambda dev: LMModel(cfg, device=dev, generator=_generator(dev)), mesh)
    B, S = shape["global_batch"], shape["seq"]

    def logits(batch_ax) -> Leaf:       # (B, 1, V) fp32: B over batch_ax, V over model
        return Leaf((B, 1, cfg.vocab), torch.float32,
                    P(batch_ax, None, "model" if cfg.vocab % mesh.shape["model"] == 0 else None))

    if shape["kind"] == "train":
        opt_cfg = OptimizerConfig(kind="adamw", lr=3e-4, weight_decay=0.1,
                                  schedule="warmup_cosine",
                                  master_weights=flags.get("bf16_params", False))
        state = _state_leaves(meta, "lm", mesh, dp, opt_cfg,
                              param_dtype=torch.bfloat16 if flags.get("bf16_params") else None)
        tok = lambda: Leaf((B, S), torch.int32, P(dp, None), fill="int", high=cfg.vocab)
        batch = {"tokens": tok(), "targets": tok()}

        def loss_fn(model, mb):
            ctx = runner.ctx(mb["tokens"].device, data_axes=dp, act_seq_shard=True,
                             manual_tp=flags.get("manual_tp", False))
            return model.loss(mb["tokens"], mb["targets"], mesh=ctx)

        step = _train_step(runner, opt_cfg, loss_fn, flags["micro"])
        args = _with_paths((state, batch))
        return Cell(arch, shape_name, "train", step, args, donate=(0,), variant=variant,
                    outputs=(args[0], Leaf((), torch.float32)), compute_dtype=cfg.compute_dtype,
                    runner=runner)

    params = _param_leaves(meta, "lm", mesh, dp, fsdp=True, dtype=torch.bfloat16)
    if shape["kind"] == "prefill":
        tokens = Leaf((B, S), torch.int32, P(dp, None), fill="int", high=cfg.vocab)

        @torch.no_grad()
        def step(params, tokens):
            model = runner.bind(params)
            return model.prefill(tokens, mesh=runner.ctx(tokens.device, data_axes=dp))

        return Cell(arch, shape_name, "prefill", step, _with_paths((params, tokens)),
                    variant=variant, outputs=(logits(dp),), compute_dtype=cfg.compute_dtype,
                    runner=runner)

    long_ctx = B < _axes_size(mesh, dp)
    if variant == "sdim_kv":
        sc = meta.init_sdim_cache(B)
        cache_ax = dp if not long_ctx else None
        cache = {"vt": Leaf(tuple(sc["vt"].shape), torch.float32, P(None, cache_ax)),
                 "ct": Leaf(tuple(sc["ct"].shape), torch.float32, P(None, cache_ax),
                            fill="count"),
                 "len": Leaf((), torch.int32, P(), fill="int", high=S)}
        token = Leaf((B, 1), torch.int32, P(cache_ax, None), fill="int", high=cfg.vocab)

        @torch.no_grad()
        def step(params, token, cache, R=None):      # R: the hash matrix to use, if given
            model = runner.bind(params, R)
            port = {"vt": cache["vt"], "ct": cache["ct"], "len": int(cache["len"])}
            out, port = model.sdim_decode_step(
                token, port, mesh=runner.ctx(token.device, data_axes=None))
            cache["len"] = torch.tensor(port["len"], dtype=torch.int32, device=token.device)
            return out, cache

        args = _with_paths((params, token, cache))
        return Cell(arch, shape_name, "decode", step, args, donate=(2,), variant=variant,
                    note="SDIM bucket-compressed KV (paper technique)",
                    outputs=(logits(cache_ax), args[2]), compute_dtype=cfg.compute_dtype, runner=runner)

    if long_ctx:
        seq_ax, batch_ax = all_axes(mesh), None
    else:
        seq_ax, batch_ax = ("model",), dp
    port_cache = meta.init_cache(B, S, torch.bfloat16)

    def cache_leaf(name, t):
        shape_ = list(t.shape)
        if name in ("k", "v"):                  # head-major -> the reference's (.., S, H, D)
            shape_[-3], shape_[-2] = shape_[-2], shape_[-3]
        dims = [None] * len(shape_)
        si = shape_.index(S)
        dims[si] = seq_ax
        if batch_ax is not None and si >= 1 and shape_[si - 1] == B and \
                B % _axes_size(mesh, batch_ax) == 0:
            dims[si - 1] = batch_ax
        return Leaf(tuple(shape_), torch.bfloat16, P(*dims))

    cache = {"stack": {n: cache_leaf(n, t) for n, t in port_cache["stack"].items()}}
    if "dense" in port_cache:
        cache["dense"] = [{n: cache_leaf(n, t) for n, t in c.items()}
                          for c in port_cache["dense"]]
    token = Leaf((B, 1), torch.int32, P(batch_ax, None), fill="int", high=cfg.vocab)
    cache_len = Leaf((), torch.int32, P(), fill="int", high=S - 1)

    @torch.no_grad()
    def step(params, token, cache, cache_len):
        model = runner.bind(params)
        ctx = runner.ctx(token.device, data_axes=batch_ax, seq_axes=seq_ax)
        return model.sp_decode_step(token, _to_port_cache(cache), int(cache_len), ctx)

    def new_leaf(_, c: Leaf) -> Leaf:         # the new token's row of a cache leaf, fp32
        si = c.shape.index(S)
        return Leaf(c.shape[:si] + (1,) + c.shape[si + 1:], torch.float32,
                    tuple(None if i == si else e for i, e in enumerate(c.spec)))

    new_kv = tree_map(new_leaf, cache)
    return Cell(arch, shape_name, "decode", step, _with_paths((params, token, cache, cache_len)),
                variant=variant, outputs=(logits(batch_ax), new_kv), compute_dtype=cfg.compute_dtype,
                runner=runner,
                note=f"split-KV decode, seq over {seq_ax}, batch over {batch_ax}")


# ---------------------------------------------------------------------------
# recsys cells
# ---------------------------------------------------------------------------
def _recsys_batch(cfg, B, dp) -> dict:
    ids = lambda shape, spec, high: Leaf(shape, torch.int32, spec, fill="int", high=high)
    specs = {
        "hist_items": ids((B, cfg.long_len), P(dp, None), cfg.n_items),
        "hist_cats": ids((B, cfg.long_len), P(dp, None), cfg.n_cats),
        "hist_mask": Leaf((B, cfg.long_len), torch.float32, P(dp, None), fill="mask"),
        "cand_item": ids((B,), P(dp), cfg.n_items),
        "cand_cat": ids((B,), P(dp), cfg.n_cats),
        "ctx": Leaf((B, cfg.ctx_dim), torch.float32, P(dp, None)),
        "label": Leaf((B,), torch.float32, P(dp), fill="label"),
    }
    if cfg.arch == "wide_deep":
        specs["sparse_ids"] = ids((B, cfg.n_sparse), P(dp, None), cfg.field_vocab)
    return specs


def _recsys_cell(arch, shape_name, shape, mesh, variant) -> Cell:
    from repro_torch.models.ctr import CTRModel

    cfg = registry.get(arch).FULL
    emb_dtype = torch.bfloat16 if variant == "bf16emb" else None
    if variant == "target_attention":
        cfg = dataclasses.replace(cfg, interest=dataclasses.replace(cfg.interest, kind="target"))
    meta = _meta(CTRModel, cfg)
    dp = data_axes(mesh)
    runner = Runner(lambda dev: CTRModel(cfg, device=dev, generator=_generator(dev)), mesh)
    B = shape["global_batch"]

    if shape["kind"] == "train":
        opt_cfg = OptimizerConfig(kind="adagrad", lr=0.01, clip_norm=None)
        state = _state_leaves(meta, "recsys", mesh, dp, opt_cfg, param_dtype=emb_dtype)
        loss_fn = lambda model, b: model.loss(b)[0]
        step = _train_step(runner, opt_cfg, loss_fn)
        args = _with_paths((state, _recsys_batch(cfg, B, dp)))
        return Cell(arch, shape_name, "train", step, args, donate=(0,), variant=variant,
                    outputs=(args[0], Leaf((), torch.float32)), runner=runner)

    params = _param_leaves(meta, "recsys", mesh, dp, fsdp=False)   # bf16emb: train only
    serve_dp = all_axes(mesh)        # serving: the batch over every axis
    if shape["kind"] == "serve":
        batch = _recsys_batch(cfg, B, serve_dp)
        batch.pop("label")

        @torch.no_grad()
        def step(params, batch):
            return runner.bind(params).apply(batch)

        return Cell(arch, shape_name, "serve", step, _with_paths((params, batch)),
                    variant=variant, outputs=(Leaf((B,), torch.float32, P(serve_dp)),),
                    runner=runner)

    # retrieval_cand: one user's state against 1e6 candidates
    n_dev = _axes_size(mesh, serve_dp)
    C = ((shape["n_candidates"] + n_dev - 1) // n_dev) * n_dev       # padded to the chips
    ids = lambda shape_, spec, high: Leaf(shape_, torch.int32, spec, fill="int", high=high)
    user = {"hist_items": ids((1, cfg.long_len), P(None, None), cfg.n_items),
            "hist_cats": ids((1, cfg.long_len), P(None, None), cfg.n_cats),
            "hist_mask": Leaf((1, cfg.long_len), torch.float32, P(None, None), fill="mask")}
    args = [params, user, ids((C,), P(serve_dp), cfg.n_items), ids((C,), P(serve_dp), cfg.n_cats),
            Leaf((C, cfg.ctx_dim), torch.float32, P(serve_dp, None))]
    if cfg.arch == "wide_deep":
        args.append(ids((C, cfg.n_sparse), P(serve_dp, None), cfg.field_vocab))

    @torch.no_grad()
    def step(params, user, ci, cc, cx, sp=None):
        return runner.bind(params).score_candidates(user, ci, cc, cx, sparse_ids=sp)

    return Cell(arch, shape_name, "retrieval", step, _with_paths(tuple(args)), variant=variant,
                outputs=(Leaf((C,), torch.float32, P(serve_dp)),), runner=runner)


# ---------------------------------------------------------------------------
# gnn cells
# ---------------------------------------------------------------------------
def _gnn_cell(arch, shape_name, shape, mesh, variant) -> Cell:
    from repro_torch.models.gnn import GatedGCN

    cfg = registry.gnn_config_for_shape(registry.get(arch).FULL, shape)
    meta = _meta(GatedGCN, cfg)
    axes = all_axes(mesh)
    n_dev = _axes_size(mesh, axes)
    dp = data_axes(mesh)
    opt_cfg = OptimizerConfig(kind="adamw", lr=1e-3)
    runner = Runner(lambda dev: GatedGCN(cfg, device=dev, generator=_generator(dev)), mesh)

    if shape["kind"] == "sampled":
        n_nodes, n_edges = registry.sampled_subgraph_sizes(shape)
    elif shape["kind"] == "graph_batch":
        n_nodes, n_edges = shape["n_nodes"] * shape["batch"], shape["n_edges"] * shape["batch"]
    else:
        n_nodes, n_edges = shape["n_nodes"], shape["n_edges"]
    n_edges_pad = ((n_edges + n_dev - 1) // n_dev) * n_dev
    graph = {
        "x": Leaf((n_nodes, cfg.d_feat), torch.float32, P(None, None)),
        "edge_index": Leaf((2, n_edges_pad), torch.int32, P(None, axes), fill="int", high=n_nodes),
        "edge_mask": Leaf((n_edges_pad,), torch.float32, P(axes), fill="mask"),
    }
    n_graphs = None
    if shape["kind"] == "graph_batch":
        graph["edge_attr"] = Leaf((n_edges_pad, cfg.d_edge), torch.float32, P(axes, None))
        graph["graph_ids"] = Leaf((n_nodes,), torch.int32, P(None), fill="int",
                                  high=shape["batch"])
        graph["y"] = Leaf((shape["batch"], 1), torch.float32, P(None, None))
        n_graphs = shape["batch"]
    else:
        graph["y"] = Leaf((n_nodes,), torch.int32, P(None), fill="int", high=cfg.n_classes)
        graph["node_mask"] = Leaf((n_nodes,), torch.float32, P(None), fill="mask")
    state = _state_leaves(meta, "gnn", mesh, dp, opt_cfg)

    def loss_fn(model, g):
        if n_graphs is not None:
            g = dict(g, n_graphs=n_graphs)
        ctx = runner.ctx(g["x"].device)
        return model.loss(g, mesh=ctx, axes=fold_axes(axes))

    step = _train_step(runner, opt_cfg, loss_fn)
    args = _with_paths((state, graph))
    return Cell(arch, shape_name, "train", step, args, donate=(0,), variant=variant,
                outputs=(args[0], Leaf((), torch.float32)), runner=runner)


# ---------------------------------------------------------------------------
def build_cell(arch: str, shape_name: str, mesh, variant: str = "baseline",
               unroll: bool = False, depth_override: Optional[int] = None,
               overrides: Optional[dict] = None) -> Cell:
    """The cell of ``arch`` at the family shape ``shape_name`` on ``mesh``
    (``launch/mesh.make_production_mesh``). ``unroll`` is recorded only
    (nothing is lowered); ``depth_override`` (LM only) scans that many
    layers after the ``first_k_dense`` blocks; ``overrides`` replaces
    entries of the shape (a cut for one card)."""
    fam = registry.family(arch)
    shape = dict(registry.shapes_for(arch)[shape_name], **(overrides or {}))
    if fam == "lm":
        cell = _lm_cell(arch, shape_name, shape, mesh, variant, depth_override)
    elif fam == "recsys":
        cell = _recsys_cell(arch, shape_name, shape, mesh, variant)
    elif fam == "gnn":
        cell = _gnn_cell(arch, shape_name, shape, mesh, variant)
    else:
        raise ValueError(fam)
    cell.unroll, cell.depth_override = unroll, depth_override
    return cell


def has_scans(arch: str, shape_name: str) -> bool:
    """Whether the reference's lowered step holds trip-counted loops (LM
    and GNN stacks, DIEN's recurrences)."""
    return registry.family(arch) in ("lm", "gnn") or arch == "dien"


def lm_scan_depth(arch: str) -> int:
    """The scanned layers of the FULL config."""
    return registry.get(arch).FULL.n_scan_layers


# ---------------------------------------------------------------------------
def materialize(cell: Cell, device, generator: torch.Generator) -> tuple:
    """The cell's arguments as tensors on ``device``, drawn from
    ``generator`` (a generator on ``device``) leaf by leaf in order, each
    as its ``fill`` says (integers within their vocabularies)."""
    dev = torch.device(device)
    made: dict = {}

    def draw(path, leaf: Leaf):
        shape, kw = leaf.shape, dict(device=dev)
        if leaf.fill == "like":
            return made[leaf.like].to(leaf.dtype)
        if leaf.fill == "int":
            t = torch.randint(0, max(leaf.high, 1), shape, generator=generator, **kw)
        elif leaf.fill == "zeros":
            t = torch.zeros(shape, **kw)
        elif leaf.fill == "ones":
            t = torch.ones(shape, **kw)
        elif leaf.fill in ("mask", "label"):
            p = 0.8 if leaf.fill == "mask" else 0.5
            t = (torch.rand(shape, generator=generator, **kw) < p).float()
        elif leaf.fill == "count":
            t = torch.randint(0, 5, shape, generator=generator, **kw).float()
        else:
            t = torch.randn(shape, generator=generator, **kw) * leaf.std
        made[path] = t.to(leaf.dtype)
        return made[path]

    return tree_map(draw, cell.abstract_args)
