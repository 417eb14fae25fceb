"""Mixture-of-Experts FFN (DeepSeek style: shared + fine-grained routed
experts).

Counterpart of ``repro/nn/moe.py``'s one-device path (``mesh=None``):
``dispatch_combine`` and ``MoELayer`` with the reference's fields and
parameter tree, ``router.w`` (d, E), ``experts.{wi_gate, wi_up}`` (E, d,
f), ``experts.wo`` (E, f, d) and ``shared.*`` (1, d, f·n_shared) /
(1, f·n_shared, d), in the reference's layout (no transpose). Its
expert-parallel ``shard_map`` path waits for the tooling slice (ROADMAP.md,
A5); ``dispatch_combine`` takes ``e0`` and E_loc < E so that path can call
it per shard.

Dispatch is sort-based, step for step as the reference: flatten the
(token, choice) pairs, a stable sort by owned expert id (unowned ids sort
last under the sentinel E_loc), each pair's rank within its expert from
``searchsorted``, pairs past ``capacity`` dropped (the reference's
``mode="drop"``), one batched FFN over the (E_loc, capacity, d) buffer,
then the weighted rows back onto their tokens. Every shape is fixed by
(T, k, E_loc, capacity): no ``.item()``, boolean indexing or ``nonzero``,
so a decode step issues its work without waiting on the card. Dropped and
unowned pairs go to one spare row past the buffer, which is never read.
The combine un-permutes the weighted rows into (T, k, d) and sums over k in
order: no atomics and no ``index_add_`` (whose CUDA sums are not the same
bits run to run), so two runs give the same bits. The reference adds them
with a scatter-add in sorted order: sums agree to fp32 rounding. Like the
reference, the FFN runs every expert over its whole buffer, empty slots
included.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.core.retrieval import top_k
from repro_torch.nn.layers import ACTIVATIONS


def _lecun(shape, in_axis: int, device, generator) -> nn.Parameter:
    """LeCun normal truncated at ±2σ over the fan-in ``shape[in_axis]``, as
    the reference's ``lecun_normal``."""
    std = 1.0 / math.sqrt(shape[in_axis])
    w = torch.empty(shape, device=device)
    if w.device.type != "meta":
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
    return nn.Parameter(w)


def _expert_ffn(w: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    """x (E, C, d) -> (E, C, d), expert e through its own gated FFN; ``w``
    maps ``wi_gate``, ``wi_up`` to (E, d, f) and ``wo`` to (E, f, d)."""
    act = ACTIVATIONS[activation]
    return torch.bmm(act(torch.bmm(x, w["wi_gate"])) * torch.bmm(x, w["wi_up"]), w["wo"])


class ExpertFFN(nn.Module):
    """E gated FFNs batched over a leading expert axis: ``wi_gate``,
    ``wi_up`` (E, d, f) and ``wo`` (E, f, d)."""

    def __init__(self, n_experts: int, d_model: int, d_ff: int, activation: str = "silu", *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.wi_gate = _lecun((n_experts, d_model, d_ff), -2, device, generator)
        self.wi_up = _lecun((n_experts, d_model, d_ff), -2, device, generator)
        self.wo = _lecun((n_experts, d_ff, d_model), -2, device, generator)
        self.activation = activation

    def weights(self) -> dict:
        return {"wi_gate": self.wi_gate, "wi_up": self.wi_up, "wo": self.wo}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _expert_ffn(self.weights(), x, self.activation)


class Router(nn.Module):
    def __init__(self, d_model: int, n_experts: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w = torch.empty((d_model, n_experts), device=device)
        if w.device.type != "meta":
            nn.init.normal_(w, std=0.02, generator=generator)
        self.w = nn.Parameter(w)


def dispatch_combine(x: torch.Tensor, topk_idx: torch.Tensor, topk_w: torch.Tensor,
                     expert_w: dict, e0: int, capacity: int, activation: str) -> torch.Tensor:
    """Capacity-bounded sort-based dispatch, the batched FFN of the E_loc
    experts ``expert_w`` (ids e0 .. e0 + E_loc - 1; ``_expert_ffn``'s
    weights) and the weighted combine. x (T, d), topk_idx (T, k) global
    expert ids, topk_w (T, k) -> the partial output (T, d): the owned
    experts' contributions only."""
    T, d = x.shape
    k = topk_idx.shape[1]
    E_loc = expert_w["wi_gate"].shape[0]
    N = T * k
    le = topk_idx.reshape(N).long() - e0
    owned = (le >= 0) & (le < E_loc)
    le = torch.where(owned, le, torch.full_like(le, E_loc))    # the sentinel sorts last
    se, order = torch.sort(le, stable=True)
    tok = torch.div(order, k, rounding_mode="floor")
    # rank within its expert: index minus the first index of its id
    pos = torch.arange(N, device=x.device) - torch.searchsorted(se, se, side="left")
    valid = (se < E_loc) & (pos < capacity)
    spare = E_loc * capacity
    slot = torch.where(valid, se * capacity + pos, torch.full_like(se, spare))
    buf = x.new_zeros((spare + 1, d))
    buf[slot] = x[tok]
    out_buf = _expert_ffn(expert_w, buf[:spare].view(E_loc, capacity, d),
                          activation).reshape(spare, d)
    y = out_buf[torch.where(valid, slot, torch.zeros_like(slot))]
    w = topk_w.reshape(N)[order, None].to(x.dtype)
    y = torch.where(valid[:, None], y, y.new_zeros(())) * w
    per_choice = torch.empty_like(y)
    per_choice[order] = y                                   # back to (token, choice) order
    return per_choice.view(T, k, d).sum(1)


class MoELayer(nn.Module):
    """Shared + routed experts; gates are the top-k of the softmax router
    probabilities (fp32), optionally renormalized, times
    ``routed_scaling``. ``forward`` returns (out, aux loss)."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, top_k: int, n_shared: int = 0,
                 activation: str = "silu", capacity_factor: float = 1.25,
                 routed_scaling: float = 1.0, norm_topk_prob: bool = False,
                 aux_loss_coef: float = 0.001, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d_model, self.d_ff, self.n_experts, self.top_k = d_model, d_ff, n_experts, top_k
        self.n_shared, self.activation = n_shared, activation
        self.capacity_factor, self.routed_scaling = capacity_factor, routed_scaling
        self.norm_topk_prob, self.aux_loss_coef = norm_topk_prob, aux_loss_coef
        kw = dict(device=device, generator=generator)
        self.router = Router(d_model, n_experts, **kw)
        self.experts = ExpertFFN(n_experts, d_model, d_ff, activation, **kw)
        if n_shared:
            self.shared = ExpertFFN(1, d_model, d_ff * n_shared, activation, **kw)

    def _route(self, x: torch.Tensor):
        """x (B, T, d) -> probs (B, T, E), topk_idx (B, T, k) int32,
        topk_w (B, T, k) and the switch-style aux loss, all fp32."""
        probs = torch.softmax(torch.einsum("btd,de->bte", x.float(), self.router.w), dim=-1)
        topk_w, topk_idx = top_k(probs, self.top_k)            # lax.top_k's tie order
        if self.norm_topk_prob:
            topk_w = topk_w / (torch.sum(topk_w, dim=-1, keepdim=True) + 1e-20)
        topk_w = topk_w * self.routed_scaling
        E = self.n_experts
        onehot = nn.functional.one_hot(topk_idx[..., 0], E).float()
        f = torch.mean(onehot, dim=(0, 1))                      # top-1 dispatch fraction
        p_mean = torch.mean(probs, dim=(0, 1))
        aux = self.aux_loss_coef * E * torch.sum(f * p_mean)
        return probs, topk_idx.to(torch.int32), topk_w, aux

    def _capacity(self, tokens: int) -> int:
        cap = int(tokens * self.top_k / self.n_experts * self.capacity_factor) + 1
        return max(8, ((cap + 7) // 8) * 8)                    # a multiple of 8

    def forward(self, x: torch.Tensor):
        """x (B, T, d) -> (out (B, T, d), aux loss)."""
        B, T, d = x.shape
        _, topk_idx, topk_w, aux = self._route(x)
        out = dispatch_combine(x.reshape(B * T, d), topk_idx.reshape(B * T, self.top_k),
                               topk_w.reshape(B * T, self.top_k).to(x.dtype),
                               self.experts.weights(), 0, self._capacity(B * T),
                               self.activation).reshape(B, T, d)
        if self.n_shared:
            out = out + self.shared(x.reshape(1, B * T, d)).reshape(B, T, d)
        return out, aux
