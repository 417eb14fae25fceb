"""Architecture registry of the port: ``--arch <id>`` resolves here. Only
the paper's own model is ported so far."""
from __future__ import annotations

import importlib

ARCH_IDS = ["sdim-paper"]

_MODULES = {"sdim-paper": "sdim_paper"}


def get(arch_id: str):
    """Returns the arch module (FAMILY, FULL, SMOKE)."""
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
