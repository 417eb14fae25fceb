"""Margin-screened inputs for holding hash kernels against their plain
versions.

Two implementations sum the m×d projection r·x in different orders, so a
projection within rounding of 0 can get a different sign bit and send a row
to another bucket: a legitimate difference, not a fault. Inputs drawn here
keep every projection at least ``margin·‖r‖·‖x‖`` away from 0, measured in
float64 on the values as they are stored, so all implementations agree on
every bit.
"""
from __future__ import annotations

import numpy as np
import torch

MARGIN = 1e-3


def stored(x: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """float32 values of ``x`` after rounding to ``dtype``."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dtype).float().numpy()


def clears_margin(x: np.ndarray, R: np.ndarray, margin: float = MARGIN) -> np.ndarray:
    """Per row of x (..., d): every |r·x| >= margin·‖r‖·‖x‖ (float64)."""
    x64 = np.asarray(x, np.float64)
    R64 = np.asarray(R, np.float64)
    proj = np.abs(x64 @ R64.T)
    bound = margin * np.linalg.norm(x64, axis=-1)[..., None] * np.linalg.norm(R64, axis=-1)
    return np.all(proj >= bound, axis=-1)


def screened_normal(rng: np.random.Generator, shape, R: np.ndarray,
                    dtype: torch.dtype = torch.float32,
                    margin: float = MARGIN) -> np.ndarray:
    """Standard-normal rows (..., d), redrawn until every row clears the
    margin; returned as float32 holding the values exactly as ``dtype``
    stores them."""
    d = shape[-1]
    x = stored(rng.standard_normal(shape).reshape(-1, d), dtype)
    while True:
        bad = ~clears_margin(x, R, margin)
        if not bad.any():
            return x.reshape(shape)
        x[bad] = stored(rng.standard_normal((int(bad.sum()), d)), dtype)
