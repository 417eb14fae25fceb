"""Transformer block and layer stack of the dense LM family.

Counterpart of ``repro/nn/transformer.py`` for grouped-query attention and
a dense gated FFN: ``BlockConfig``, ``Block`` (pre-norm attention and FFN,
each added to the residual) and ``Stack``, n homogeneous blocks. The
reference runs the stack as a ``lax.scan`` over parameters stacked on a
leading layer axis, optionally rematerialized or unrolled; here it is an
``nn.ModuleList`` run in a loop, the same math. ``remat`` and
``scan_unroll`` are accepted and change nothing in serving. Latent
attention (``attention="mla"``) and mixture-of-experts FFNs (``moe``) wait
for the MoE/MLA slice (ROADMAP.md, A3b).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.nn.attention import GQAttention
from repro_torch.nn.layers import GatedMLP, LayerNorm, RMSNorm

REMAT_POLICIES = ("none", "full", "dots", "dots_no_batch")


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    attention: str = "gqa"         # "gqa" | "mla"
    norm: str = "rmsnorm"          # "rmsnorm" | "layernorm"
    qk_norm: bool = False
    use_bias: bool = False
    activation: str = "silu"
    rope_theta: float = 10000.0
    # MoE (None -> dense FFN)
    moe: Optional[dict] = None     # dict(n_experts, top_k, n_shared, d_ff)
    q_chunk_unroll: bool = False   # the reference's roofline lowering; no effect here

    def __post_init__(self):
        if self.attention != "gqa":
            raise NotImplementedError(
                f"attention {self.attention!r} (MLAttention) waits for the MoE/MLA slice "
                f"(ROADMAP.md, A3b); the port has grouped-query attention only")
        if self.moe is not None:
            raise NotImplementedError("mixture-of-experts FFNs (nn/moe.py) wait for the "
                                      "MoE/MLA slice (ROADMAP.md, A3b)")

    def attn_module(self, device=None, generator=None) -> GQAttention:
        return GQAttention(self.d_model, self.n_heads, self.head_dim,
                           n_kv_heads=self.n_kv_heads, qk_norm=self.qk_norm,
                           use_bias=self.use_bias, rope_theta=self.rope_theta, causal=True,
                           device=device, generator=generator)

    def norm_module(self, device=None) -> nn.Module:
        if self.norm == "rmsnorm":
            return RMSNorm(self.d_model, device=device)
        return LayerNorm(self.d_model, device=device)

    def ffn_module(self, device=None, generator=None) -> GatedMLP:
        return GatedMLP(self.d_model, self.d_ff, self.activation, self.use_bias,
                        device=device, generator=generator)


class Block(nn.Module):
    """x + attn(ln1(x)), then + ffn(ln2(x))."""

    def __init__(self, cfg: BlockConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = cfg.norm_module(device)
        self.attn = cfg.attn_module(device, generator)
        self.ln2 = cfg.norm_module(device)
        self.ffn = cfg.ffn_module(device, generator)

    def forward(self, x: torch.Tensor, positions: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None):
        """Returns (x, aux_loss); a dense block's aux loss is 0."""
        x = x + self.attn(self.ln1(x), positions=positions, mask=mask)
        return x + self.ffn(self.ln2(x)), torch.zeros((), device=x.device)

    def decode_step(self, x: torch.Tensor, cache: dict, cache_len: int):
        """One token against this layer's cache (written in place)."""
        h, cache = self.attn.decode_step(self.ln1(x), cache, cache_len)
        x = x + h
        return x + self.ffn(self.ln2(x)), cache


class Stack(nn.ModuleList):
    """``n_layers`` blocks of one config, run in order. Its exact KV cache
    holds every layer's rows in one tensor each, ``k`` and ``v`` of
    (n_layers, batch, n_kv_heads, max_len, head_dim): head-major, where the
    reference's is (n_layers, batch, max_len, n_kv_heads, head_dim), so
    that a decode step's scores and weighted sum are batched products over
    contiguous (rows, head_dim) slabs (``GQAttention.decode_step``); layer
    i reads and writes ``k[i]`` and ``v[i]`` in place."""

    def __init__(self, cfg: BlockConfig, n_layers: int, remat: str = "none",
                 unroll: bool = False, *, device=None,
                 generator: Optional[torch.Generator] = None):
        if remat not in REMAT_POLICIES:
            raise ValueError(f"remat {remat!r} not in {REMAT_POLICIES}")
        super().__init__([Block(cfg, device=device, generator=generator)
                          for _ in range(n_layers)])
        self.cfg, self.remat, self.unroll = cfg, remat, unroll

    def forward(self, x: torch.Tensor, positions: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None):
        aux = torch.zeros((), device=x.device)
        for block in self:
            x, aux_l = block(x, positions=positions, mask=mask)
            aux = aux + aux_l
        return x, aux

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> dict:
        shape = (len(self), batch, self.cfg.n_kv_heads, max_len, self.cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def decode_step(self, x: torch.Tensor, caches: dict, cache_len: int):
        for i, block in enumerate(self):
            x, _ = block.decode_step(x, {"k": caches["k"][i], "v": caches["v"][i]}, cache_len)
        return x, caches
