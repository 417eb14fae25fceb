"""Dense layers: Linear, Embedding, MLP as ``nn.Module``s.

Counterpart of ``repro/nn/layers.py``. Initialisation follows the JAX
package's distributions (Linear: LeCun normal truncated at ±2σ, zero bias;
Embedding: N(0, init_std²)) drawn from an explicit ``torch.Generator``;
the numbers differ from ``jax.random``'s, so parity tests load the JAX
package's weights (``repro_torch.weights.load_jax_params``). Weights keep
PyTorch's layout: ``Linear.weight`` is (out, in), the transpose of the JAX
package's ``w``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

ACTIVATIONS = {
    "relu": F.relu,
    "identity": lambda x: x,
}


class Linear(nn.Linear):
    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(in_dim, out_dim, bias=use_bias, device=device)
        std = 1.0 / math.sqrt(in_dim)
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            if self.bias is not None:
                self.bias.zero_()


class Embedding(nn.Embedding):
    def __init__(self, vocab: int, dim: int, init_std: float = 0.02, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(vocab, dim, device=device)
        with torch.no_grad():
            nn.init.normal_(self.weight, std=init_std, generator=generator)


class MLP(nn.Module):
    """Linear layers ``fc0``, ``fc1``, … with ``activation`` between them."""

    def __init__(self, in_dim: int, hidden: Sequence[int], activation: str = "relu",
                 final_activation: str = "identity", use_bias: bool = True, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [in_dim, *hidden]
        self.n_layers = len(dims) - 1
        for i in range(self.n_layers):
            self.add_module(f"fc{i}", Linear(dims[i], dims[i + 1], use_bias,
                                             device=device, generator=generator))
        self.act = ACTIVATIONS[activation]
        self.final_act = ACTIVATIONS[final_activation]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"fc{i}")(x)
            if i < self.n_layers - 1:
                x = self.act(x)
        return self.final_act(x)
