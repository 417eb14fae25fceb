"""Architecture registry of the port: ``--arch <id>`` resolves here. The
recsys archs of the reference's registry (``repro/configs/registry.py``),
the paper's own model and the dense GQA LM archs; the LM shape set
``LM_SHAPES`` as data. ``deepseek-v2-236b`` (MLA) and ``deepseek-moe-16b``
(MoE) wait for the MoE/MLA slice; ``gatedgcn`` for the GNN slice."""
from __future__ import annotations

import importlib

ARCH_IDS = ["granite-3-2b", "command-r-plus-104b", "qwen3-8b",
            "wide-deep", "bst", "dien", "bert4rec", "sdim-paper"]

_MODULES = {"granite-3-2b": "granite_3_2b", "command-r-plus-104b": "command_r_plus_104b",
            "qwen3-8b": "qwen3_8b",
            "wide-deep": "wide_deep", "bst": "bst", "dien": "dien", "bert4rec": "bert4rec",
            "sdim-paper": "sdim_paper"}

_WAITING = {"deepseek-v2-236b": "the MoE/MLA slice (MLAttention)",
            "deepseek-moe-16b": "the MoE/MLA slice (nn/moe.py)",
            "gatedgcn": "the GNN slice"}

# the LM family's shape set (``repro/configs/registry.py:46-52``)
LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq=32768, global_batch=128),
    # long-context decode: exact split-KV is the faithful baseline;
    # the "sdim" variant is the paper's technique (bucket-compressed KV)
    "long_500k": dict(kind="decode", seq=524288, global_batch=1),
}


def get(arch_id: str):
    """Returns the arch module (FAMILY, FULL, SMOKE)."""
    if arch_id in _WAITING:
        raise KeyError(f"arch {arch_id!r} is not ported yet: it waits for "
                       f"{_WAITING[arch_id]}; known: {ARCH_IDS}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
