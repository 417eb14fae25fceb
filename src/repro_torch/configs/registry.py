"""Architecture registry of the port: ``--arch <id>`` resolves here. The
recsys archs of the reference's registry (``repro/configs/registry.py``)
and the paper's own model; the LM and GNN archs are not ported yet."""
from __future__ import annotations

import importlib

ARCH_IDS = ["wide-deep", "bst", "dien", "bert4rec", "sdim-paper"]

_MODULES = {"wide-deep": "wide_deep", "bst": "bst", "dien": "dien", "bert4rec": "bert4rec",
            "sdim-paper": "sdim_paper"}


def get(arch_id: str):
    """Returns the arch module (FAMILY, FULL, SMOKE)."""
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
