"""Dense layers: Linear, LayerNorm, RMSNorm, Embedding, PReLU, MLP,
GatedMLP as ``nn.Module``s.

Counterpart of ``repro/nn/layers.py``. Initialisation follows the JAX
package's distributions (Linear: LeCun normal truncated at ±2σ, zero bias;
Embedding: N(0, init_std²)) drawn from an explicit ``torch.Generator``;
the numbers differ from ``jax.random``'s, so parity tests load the JAX
package's weights (``repro_torch.weights.load_jax_params``). Weights keep
PyTorch's layout: ``Linear.weight`` is (out, in), the transpose of the JAX
package's ``w``.

``embedding`` is every embedding lookup of the port. Its gradient on the
card must give the same bits on every run: PyTorch's own embedding backward
on CUDA does not once an id repeats often (thousands of lookups of 80
categories: a batch of long histories), so on CUDA the gradient rows of one
id are summed by ``index_put_(accumulate=True)``, which sorts the ids and
gives each id one owner that adds its rows in order. On the CPU the native
backward already does that.

``segment_sum`` is the GNN's scatter, the counterpart of
``jax.ops.segment_sum``, with the same bits on every run: on CUDA the rows
of one segment are summed by ``index_put_(accumulate=True)``, the same
sort-and-own rule (CUDA's ``index_add_`` adds with atomics); on the CPU by
``index_add_``, which adds them in order (the CPU's accumulating
``index_put_`` does not give the same bits twice). Its gradient is a
gather.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

ACTIVATIONS = {
    "relu": F.relu,
    # jax.nn.gelu defaults to the tanh approximation; PyTorch's to erf
    "gelu": partial(F.gelu, approximate="tanh"),
    "silu": F.silu,
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


class LayerNorm(nn.Module):
    """Layer norm over the last axis with params ``scale`` (ones) and
    ``bias`` (zeros): computed in fp32 and cast back to the input's dtype,
    eps 1e-5, as the JAX package's ``LayerNorm``."""

    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = torch.square(xf - mu).mean(-1, keepdim=True)
        return ((xf - mu) * torch.rsqrt(var + 1e-5) * self.scale + self.bias).to(x.dtype)


class RMSNorm(nn.Module):
    """x / sqrt(mean(x²) + eps) · ``scale`` (ones) over the last axis,
    computed in fp32 and cast back to the input's dtype, eps 1e-6, as the
    JAX package's ``RMSNorm``."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        ms = torch.square(xf).mean(-1, keepdim=True)
        return (xf * torch.rsqrt(ms + self.eps) * self.scale).to(x.dtype)


class _EmbeddingFn(torch.autograd.Function):
    """``F.embedding`` whose weight gradient is summed per id by
    ``index_put_(accumulate=True)``: one owner per id, rows in order."""

    @staticmethod
    def forward(ctx, weight: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.n_rows = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (ids,) = ctx.saved_tensors
        dim = grad.shape[-1]
        gw = torch.zeros((ctx.n_rows, dim), dtype=grad.dtype, device=grad.device)
        gw.index_put_((ids.reshape(-1).long(),), grad.reshape(-1, dim), accumulate=True)
        return gw, None


def embedding(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Rows ``weight[ids]`` with a gradient that has the same bits on every
    run: ``_EmbeddingFn`` on CUDA under autograd, ``F.embedding`` otherwise
    (the CPU's native backward gives each id one owner already)."""
    if weight.is_cuda and torch.is_grad_enabled() and weight.requires_grad:
        return _EmbeddingFn.apply(weight, ids)
    return F.embedding(ids, weight)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, n_segments: int) -> torch.Tensor:
    """(n_segments, *data.shape[1:]): row s the sum of the rows of ``data``
    whose id is s; ids in any order, each in [0, n_segments); an empty
    segment is 0."""
    out = data.new_zeros((n_segments, *data.shape[1:]))
    if data.is_cuda:
        return out.index_put((segment_ids.long(),), data, accumulate=True)
    return out.index_add(0, segment_ids.long(), data)


class Embedding(nn.Embedding):
    def __init__(self, vocab: int, dim: int, init_std: float = 0.02, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(vocab, dim, device=device)
        with torch.no_grad():
            nn.init.normal_(self.weight, std=init_std, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return embedding(ids, self.weight)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Tied-embedding logits: x (..., dim) @ table.T -> (..., vocab)."""
        return F.linear(x, self.weight)


class PReLU(nn.Module):
    """x where x >= 0, else ``alpha`` · x, one slope a feature (``alpha``
    of ``dim``, 0.25), as the JAX package's ``PReLU`` of the DIN-family
    towers; neither package's models call it."""

    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((dim,), 0.25, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha * x)


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


class GatedMLP(nn.Module):
    """The LM family's SwiGLU/GeGLU FFN: ``wo(act(wi_gate x) * wi_up x)``."""

    def __init__(self, d_model: int, d_ff: int, activation: str = "silu",
                 use_bias: bool = False, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.wi_gate = Linear(d_model, d_ff, use_bias, **kw)
        self.wi_up = Linear(d_model, d_ff, use_bias, **kw)
        self.wo = Linear(d_ff, d_model, use_bias, **kw)
        self.act = ACTIVATIONS[activation]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(self.act(self.wi_gate(x)) * self.wi_up(x))
