"""GRU and AUGRU recurrences for DIEN (interest extraction and evolution).

Counterpart of ``repro/nn/rnn.py``. The params keep the JAX package's
layout: ``wx`` (in, 3H), ``wh`` (H, 3H) and ``b`` (3H,), the bias on the
input side only, gates in the order r, z, n. Both recurrences carry the
state through masked steps (``where(m_t > 0, h_new, h)``), which
``torch.nn.GRU`` cannot do on front-padded rows, so the step loop is
written out; the input projection ``x @ wx + b`` of all T steps is one
product. As in the reference, GRU's update is ``(1 - z) n + z h`` and
AUGRU's ``(1 - z) h + z n`` with z scaled by the step's attention.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def _lecun(shape, device, generator) -> nn.Parameter:
    """LeCun normal over the first axis, truncated at ±2σ (the JAX
    package's ``lecun_normal`` with ``in_axis=-2``)."""
    std = 1.0 / math.sqrt(shape[0])
    w = torch.empty(shape, device=device)
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
    return nn.Parameter(w)


class GRU(nn.Module):
    def __init__(self, in_dim: int, hidden: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden = hidden
        self.wx = _lecun((in_dim, 3 * hidden), device, generator)
        self.wh = _lecun((hidden, 3 * hidden), device, generator)
        self.b = nn.Parameter(torch.zeros(3 * hidden, device=device))

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        """x (B, T, in), mask (B, T) -> (hs (B, T, H), h_T (B, H))."""
        return self._scan(x, mask, None)

    def _scan(self, x: torch.Tensor, mask: torch.Tensor, att: Optional[torch.Tensor]):
        """The recurrence from a zero state; with ``att`` (B, T) the AUGRU
        update."""
        h = x.new_zeros((x.shape[0], self.hidden))
        zx = x @ self.wx + self.b
        hs = []
        for t in range(x.shape[1]):
            xr, xz, xn = zx[:, t].chunk(3, dim=-1)
            hr, hz, hn = (h @ self.wh).chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            if att is None:
                h_new = (1.0 - z) * n + z * h
            else:
                z = att[:, t, None] * z
                h_new = (1.0 - z) * h + z * n
            h = torch.where(mask[:, t, None] > 0, h_new, h)
            hs.append(h)
        return torch.stack(hs, dim=1), h


class AUGRU(GRU):
    """GRU with an attentional update gate (DIEN's interest evolution): the
    update gate of each step is scaled by that step's attention score. Its
    params are GRU's."""

    def forward(self, x: torch.Tensor, att: torch.Tensor, mask: torch.Tensor):
        """x (B, T, in), att (B, T) in [0, 1], mask (B, T) -> (hs, h_T)."""
        return self._scan(x, mask, att)
