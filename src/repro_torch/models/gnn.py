"""GatedGCN [arXiv:1711.07553 / benchmarking-gnns 2003.00982].

Counterpart of ``repro/models/gnn.py`` (``GatedGCNConfig``, ``_layer_init``
/ ``_layer_apply`` as ``GatedGCNLayer``, ``GatedGCN.forward`` and
``loss``). Message passing is edge-list based; per layer

    e'_ij = e_ij + ReLU(LN(A h_i + B h_j + C e_ij))
    η_ij  = σ(e'_ij) / (Σ_{j→i} σ(e'_ij) + ε)          (gated, degree-normalized)
    h'_i  = h_i + ReLU(LN(U h_i + Σ_{j→i} η_ij ⊙ V h_j))

with LayerNorm where the original has BatchNorm, as the reference. The
gathers ``h[src]``, ``h[dst]`` are ``nn/layers.py::embedding`` and the sums
Σ_{j→i} are ``nn/layers.py::segment_sum``: neither adds with atomics, so a
training step gives the same bits on every run on the card (the reference's
``jax.ops.segment_sum``, "the system's GNN kernel", is no Pallas kernel, and
neither is this).

The edge-sharded path (``mesh=``, the reference's ``shard_map`` of
``gnn.py:77-88``) splits the E edges into ``prod(axis sizes)`` contiguous
blocks in row-major order over ``axes`` (``MeshCtx.axis_devices``: block k on
``devices[k % n_shards]``); each block scatters its messages and gates into
a full (N, d) node array on its device, and the partials are summed in block
order (``mesh_ctx.psum``, the reference's ``psum``). E must divide by the
block count.

``remat`` checkpoints each layer (``torch.utils.checkpoint``,
``use_reentrant=False``; the same bits as without it). ``unroll`` is the
reference's lowering choice between ``lax.scan`` and a Python loop; the
port's layers run in a Python loop either way, so it changes nothing.
Runs on the card unless ``device="cpu"`` is given.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.mesh_ctx import MeshCtx, block_size, psum
from repro_torch.nn.layers import MLP, LayerNorm, Linear, embedding, segment_sum


@dataclasses.dataclass(frozen=True)
class GatedGCNConfig:
    n_layers: int = 16
    d_hidden: int = 70
    d_feat: int = 1433
    d_edge: int = 0             # 0 -> learned constant edge init
    n_classes: int = 16
    readout: str = "node"       # "node" (classification) | "graph" (regression)
    remat: bool = True
    unroll: bool = False        # the reference's lowering; no effect here


def _scatter(msg, gate, dst, n_nodes: int, blocks):
    """(Σ msg, Σ gate) per destination node: whole, or per edge block
    (lo, hi, device) on its device with the partials summed in block order."""
    if blocks is None:
        return segment_sum(msg, dst, n_nodes), segment_sum(gate, dst, n_nodes)
    aggs, norms = [], []
    for lo, hi, dev in blocks:
        d = dst[lo:hi].to(dev)
        aggs.append(segment_sum(msg[lo:hi].to(dev), d, n_nodes))
        norms.append(segment_sum(gate[lo:hi].to(dev), d, n_nodes))
    return psum(aggs).to(msg.device), psum(norms).to(msg.device)


def _edge_blocks(mesh: MeshCtx, axes, n_edges: int):
    """[(lo, hi, device)] of the E edges split row-major over ``axes``."""
    devices = mesh.axis_devices(axes)
    size = block_size(n_edges, len(devices), f"the edges over axes {tuple(axes)}: E")
    return [(k * size, (k + 1) * size, dev) for k, dev in enumerate(devices)]


class GatedGCNLayer(nn.Module):
    """One layer: ``A``, ``B``, ``C``, ``U``, ``V`` (d -> d, biased) and the
    LayerNorms ``ln_h``, ``ln_e``."""

    def __init__(self, d: int, *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        for name in ("A", "B", "C", "U", "V"):
            self.add_module(name, Linear(d, d, device=device, generator=generator))
        self.ln_h = LayerNorm(d, device=device)
        self.ln_e = LayerNorm(d, device=device)

    def forward(self, h, e, src, dst, edge_mask, blocks=None):
        """h (N, d), e (E, d), src/dst (E,) int64, edge_mask (E,) or None
        -> (h, e)."""
        h_src, h_dst = embedding(src, h), embedding(dst, h)
        e_new = self.A(h_dst) + self.B(h_src) + self.C(e)
        e_new = e + F.relu(self.ln_e(e_new))
        gate = torch.sigmoid(e_new)
        if edge_mask is not None:
            gate = gate * edge_mask[:, None]
        msg = gate * self.V(h_src)
        agg, norm = _scatter(msg, gate, dst, h.shape[0], blocks)
        h_new = self.U(h) + agg / (norm + 1e-6)
        return h + F.relu(self.ln_h(h_new)), e_new


class GatedGCN(nn.Module):
    """``node_enc`` (d_feat -> d), ``edge_enc`` (max(d_edge, 1) -> d),
    ``layers`` and ``out``, the MLP d -> d -> n_classes with ReLU between."""

    def __init__(self, cfg: GatedGCNConfig, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        kw = dict(device=dev, generator=generator)
        d = cfg.d_hidden
        self.node_enc = Linear(cfg.d_feat, d, **kw)
        self.edge_enc = Linear(max(cfg.d_edge, 1), d, **kw)
        self.layers = nn.ModuleList([GatedGCNLayer(d, **kw) for _ in range(cfg.n_layers)])
        self.out = MLP(d, [d, cfg.n_classes], "relu", **kw)

    def forward(self, graph: dict, mesh=None, axes=("data", "model")) -> torch.Tensor:
        """graph: ``x`` (N, F), ``edge_index`` (2, E), optional ``edge_attr``
        (E, d_edge), ``edge_mask`` (E,), ``graph_ids`` (N,) and ``n_graphs``
        (graph readout). Returns node logits (N, C) or graph outputs
        (n_graphs, C). ``mesh`` (a ``MeshCtx``) shards the edges over
        ``axes``."""
        cfg = self.cfg
        x = graph["x"]
        src, dst = graph["edge_index"][0].long(), graph["edge_index"][1].long()
        h = self.node_enc(x)
        ea = graph.get("edge_attr")
        if ea is None:
            ea = torch.ones((src.shape[0], 1), dtype=h.dtype, device=h.device)
        e = self.edge_enc(ea)
        edge_mask = graph.get("edge_mask")
        blocks = None if mesh is None else _edge_blocks(MeshCtx.wrap(mesh), axes, src.shape[0])
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                h, e = checkpoint(layer, h, e, src, dst, edge_mask, blocks, use_reentrant=False)
            else:
                h, e = layer(h, e, src, dst, edge_mask, blocks)
        if cfg.readout == "graph":
            gid, n_graphs = graph["graph_ids"], int(graph["n_graphs"])
            pooled = segment_sum(h, gid, n_graphs)
            counts = segment_sum(torch.ones((h.shape[0], 1), dtype=h.dtype, device=h.device),
                                 gid, n_graphs)
            h = pooled / torch.clamp(counts, min=1.0)
        return self.out(h)

    def loss(self, graph: dict, mesh=None, axes=("data", "model")) -> torch.Tensor:
        """Graph readout: the MSE against ``y``; node readout: the NLL of
        ``y`` under the fp32 log-softmax, over the ``node_mask``ed nodes
        (all without one)."""
        out = self.forward(graph, mesh=mesh, axes=axes)
        if self.cfg.readout == "graph":
            return torch.mean(torch.square(out - graph["y"]))
        logp = torch.log_softmax(out.float(), dim=-1)
        nll = -torch.gather(logp, -1, graph["y"][:, None].long())[..., 0]
        node_mask = graph.get("node_mask")
        if node_mask is not None:
            return torch.sum(nll * node_mask) / (torch.sum(node_mask) + 1e-9)
        return torch.mean(nll)
