"""Graph generators and a neighbor sampler for the GNN family, numpy only.

Counterpart of ``repro/data/graph.py``, line for line: the same seeds give
the same arrays, bit for bit. Message passing is edge-list based
(``segment_sum`` over ``edge_index``): generators return ``{x: (N, F),
edge_index: (2, E), edge_attr, y}`` dicts with int32 indices.

``NeighborSampler`` implements GraphSAGE-style layered uniform fanout
sampling (the ``minibatch_lg`` shape: batch 1024, fanout 15·10) over a
host-side CSR, emitting fixed-shape padded blocks, so every minibatch has
the same shapes.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def random_graph(n_nodes: int, n_edges: int, d_feat: int, seed: int = 0,
                 n_classes: int = 16, d_edge: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges)
    dst = rng.integers(0, n_nodes, n_edges)
    g = {
        "x": rng.standard_normal((n_nodes, d_feat), dtype=np.float32),
        "edge_index": np.stack([src, dst]).astype(np.int32),
        "y": rng.integers(0, n_classes, n_nodes).astype(np.int32),
    }
    if d_edge:
        g["edge_attr"] = rng.standard_normal((n_edges, d_edge), dtype=np.float32)
    return g


def cora_like(seed: int = 0) -> dict:
    """full_graph_sm shape: 2708 nodes / 10556 edges / 1433 feats."""
    return random_graph(2708, 10556, 1433, seed, n_classes=7)


def molecule_batch(batch: int = 128, n_nodes: int = 30, n_edges: int = 64,
                   d_feat: int = 16, d_edge: int = 4, seed: int = 0) -> dict:
    """Disjoint union of ``batch`` small graphs + graph_ids for readout."""
    rng = np.random.default_rng(seed)
    xs, eis, eas, gids = [], [], [], []
    for g in range(batch):
        off = g * n_nodes
        src = rng.integers(0, n_nodes, n_edges) + off
        dst = rng.integers(0, n_nodes, n_edges) + off
        xs.append(rng.standard_normal((n_nodes, d_feat), dtype=np.float32))
        eis.append(np.stack([src, dst]))
        eas.append(rng.standard_normal((n_edges, d_edge), dtype=np.float32))
        gids.append(np.full(n_nodes, g))
    return {
        "x": np.concatenate(xs),
        "edge_index": np.concatenate(eis, axis=1).astype(np.int32),
        "edge_attr": np.concatenate(eas),
        "graph_ids": np.concatenate(gids).astype(np.int32),
        "y": rng.standard_normal((batch, 1), dtype=np.float32),  # regression target
        "n_graphs": batch,
    }


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray   # (N+1,)
    indices: np.ndarray  # (E,) neighbor ids

    @staticmethod
    def from_edge_index(edge_index: np.ndarray, n_nodes: int) -> "CSRGraph":
        src, dst = edge_index
        order = np.argsort(dst, kind="stable")       # CSR over incoming edges
        sorted_src = src[order]
        counts = np.bincount(dst, minlength=n_nodes)
        indptr = np.zeros(n_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSRGraph(indptr=indptr, indices=sorted_src.astype(np.int64))

    def degree(self, node: np.ndarray) -> np.ndarray:
        return self.indptr[node + 1] - self.indptr[node]


class NeighborSampler:
    """Layered uniform neighbor sampling with fixed fanouts (GraphSAGE).

    ``sample(seeds)`` returns, per layer ℓ (root-outward), a padded bipartite
    block: ``edge_index`` (2, seeds·fanout) from sampled source positions to
    target positions, plus the global node ids of every sampled node. Nodes
    with degree < fanout are padded by self-edges (mask provided).
    """

    def __init__(self, edge_index: np.ndarray, n_nodes: int, fanouts: list[int],
                 seed: int = 0):
        self.csr = CSRGraph.from_edge_index(edge_index, n_nodes)
        self.fanouts = fanouts
        self.rng = np.random.default_rng(seed)
        self.n_nodes = n_nodes

    def _sample_neighbors(self, nodes: np.ndarray, fanout: int):
        deg = self.csr.degree(nodes)
        # uniform-with-replacement fanout sample; degree-0 nodes self-loop
        r = self.rng.integers(0, 2**31 - 1, (len(nodes), fanout))
        idx = np.where(deg[:, None] > 0, r % np.maximum(deg, 1)[:, None], 0)
        flat = self.csr.indptr[nodes][:, None] + idx
        nbrs = np.where(
            deg[:, None] > 0, self.csr.indices[np.minimum(flat, len(self.csr.indices) - 1)],
            nodes[:, None],
        )
        mask = (deg[:, None] > 0).astype(np.float32) * np.ones((1, fanout), np.float32)
        return nbrs, mask

    def sample(self, seeds: np.ndarray) -> dict:
        """Returns a fixed-shape layered block structure for the seed batch."""
        layers = []
        frontier = seeds.astype(np.int64)
        all_nodes = [frontier]
        for fanout in self.fanouts:
            nbrs, mask = self._sample_neighbors(frontier, fanout)   # (F, fanout)
            n_targets = len(frontier)
            src_nodes = nbrs.reshape(-1)
            dst_pos = np.repeat(np.arange(n_targets), fanout)
            layers.append({
                "src_nodes": src_nodes.astype(np.int64),     # global ids
                "dst_pos": dst_pos.astype(np.int32),          # position in frontier
                "mask": mask.reshape(-1),
                "n_targets": n_targets,
            })
            frontier = src_nodes
            all_nodes.append(frontier)
        return {"seeds": seeds, "layers": layers, "all_nodes": all_nodes}


def flatten_block(graph: dict, block: dict) -> dict:
    """A layered block of ``NeighborSampler.sample`` flattened into its union
    subgraph, as the reference's GNN smoke test flattens it
    (``tests/test_smoke_archs.py:119-139``): the distinct sampled nodes in
    ascending id order, every layer's edges from each sampled source to its
    target remapped onto them, and the padding mask as ``edge_mask``. ``x``
    and ``y`` are ``graph``'s rows of those nodes."""
    nodes = np.unique(np.concatenate(block["all_nodes"]))
    srcs, dsts, masks = [], [], []
    frontier = block["seeds"]
    for layer in block["layers"]:
        srcs.append(np.searchsorted(nodes, layer["src_nodes"]))
        dsts.append(np.searchsorted(nodes, frontier[layer["dst_pos"]]))
        masks.append(layer["mask"])
        frontier = layer["src_nodes"]
    return {"x": graph["x"][nodes],
            "edge_index": np.stack([np.concatenate(srcs), np.concatenate(dsts)]).astype(np.int32),
            "edge_mask": np.concatenate(masks),
            "y": graph["y"][nodes]}
