"""Architecture registry of the port: ``--arch <id>`` resolves here. The
reference's registry (``repro/configs/registry.py``): the ten assigned
archs (five LM, ``gatedgcn``, four recsys) and the paper's own model in the
reference's order, their FULL/SMOKE configs, the family shape sets
``LM_SHAPES``, ``GNN_SHAPES`` and ``RECSYS_SHAPES``, and the 40 (arch x
shape) cells (``cells``). ``launch/flops.py`` reads them."""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = ["granite-3-2b", "command-r-plus-104b", "qwen3-8b",
            "deepseek-v2-236b", "deepseek-moe-16b", "gatedgcn",
            "wide-deep", "bst", "dien", "bert4rec", "sdim-paper"]

_MODULES = {"granite-3-2b": "granite_3_2b", "command-r-plus-104b": "command_r_plus_104b",
            "qwen3-8b": "qwen3_8b", "deepseek-v2-236b": "deepseek_v2_236b",
            "deepseek-moe-16b": "deepseek_moe_16b", "gatedgcn": "gatedgcn",
            "wide-deep": "wide_deep", "bst": "bst", "dien": "dien", "bert4rec": "bert4rec",
            "sdim-paper": "sdim_paper"}

# the LM family's shape set (``repro/configs/registry.py:41-48``)
LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq=32768, global_batch=128),
    # long-context decode: exact split-KV is the faithful baseline;
    # the "sdim" variant is the paper's technique (bucket-compressed KV)
    "long_500k": dict(kind="decode", seq=524288, global_batch=1),
}

# the GNN family's shape set (``repro/configs/registry.py:50-60``)
GNN_SHAPES = {
    "full_graph_sm": dict(kind="full_graph", n_nodes=2708, n_edges=10556,
                          d_feat=1433, n_classes=7),
    "minibatch_lg": dict(kind="sampled", n_nodes=232965, n_edges=114_615_892,
                         batch_nodes=1024, fanout=(15, 10), d_feat=602,
                         n_classes=41),
    "ogb_products": dict(kind="full_graph", n_nodes=2_449_029, n_edges=61_859_140,
                         d_feat=100, n_classes=47),
    "molecule": dict(kind="graph_batch", n_nodes=30, n_edges=64, batch=128,
                     d_feat=16, d_edge=4, n_classes=1),
}

# the recsys family's shape set (``repro/configs/registry.py:62-67``)
RECSYS_SHAPES = {
    "train_batch": dict(kind="train", global_batch=65536),
    "serve_p99": dict(kind="serve", global_batch=512),
    "serve_bulk": dict(kind="serve", global_batch=262144),
    "retrieval_cand": dict(kind="retrieval", global_batch=1, n_candidates=1_000_000),
}

FAMILY_SHAPES = {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES}


def get(arch_id: str):
    """Returns the arch module (FAMILY, FULL, SMOKE)."""
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def family(arch_id: str) -> str:
    return get(arch_id).FAMILY


def shapes_for(arch_id: str) -> dict[str, dict]:
    return FAMILY_SHAPES[family(arch_id)]


def gnn_config_for_shape(base, shape: dict):
    """Adapt d_feat / d_edge / n_classes / readout to the graph shape."""
    return dataclasses.replace(
        base,
        d_feat=shape["d_feat"],
        d_edge=shape.get("d_edge", 0),
        n_classes=shape["n_classes"],
        readout="graph" if shape["kind"] == "graph_batch" else "node",
    )


def cells(assigned_only: bool = True) -> list[tuple[str, str]]:
    """The 40 (arch x shape) cells (``sdim-paper`` is not assigned)."""
    return [(a, s) for a in ARCH_IDS if not (assigned_only and a == "sdim-paper")
            for s in shapes_for(a)]


def sampled_subgraph_sizes(shape: dict) -> tuple[int, int]:
    """(n_sub_nodes, n_sub_edges) of a fanout-sampled minibatch block."""
    n_nodes = frontier = shape["batch_nodes"]
    n_edges = 0
    for f in shape["fanout"]:
        n_edges += frontier * f
        frontier *= f
        n_nodes += frontier
    return n_nodes, n_edges
