"""Device rule of the port's entry points: CUDA unless the caller asks for
the CPU, and never a quiet fall-back from one to the other."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``. Raises when
    CUDA is asked for and missing: the kernels only run on the card, and the
    plain PyTorch versions run only for a caller that passes ``"cpu"``.
    ``"meta"`` builds a model's shapes without memory; nothing runs there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"the port runs on 'cuda' or 'cpu' (shapes on 'meta'), not {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev
