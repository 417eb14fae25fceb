"""Transformer block and layer stack of the LM family.

Counterpart of ``repro/nn/transformer.py``: ``BlockConfig``, ``Block``
(pre-norm attention and FFN, each added to the residual) and ``Stack``, n
homogeneous blocks. Attention is grouped-query (``GQAttention``) or latent
(``attention="mla"``: ``MLAttention``), the FFN dense (``GatedMLP``) or a
mixture of experts (``moe``: ``MoELayer``, whose aux loss ``Block``
returns and ``Stack`` sums). The reference runs the stack as a
``lax.scan`` over parameters stacked on a leading layer axis, optionally
rematerialized or unrolled; here it is an ``nn.ModuleList`` run in a loop,
the same math (``scan_unroll``, the reference's roofline lowering, changes
nothing). ``remat`` is the reference's activation checkpointing of each
scanned block (``REMAT_POLICIES``): under autograd, ``"full"`` keeps only a
block's input and runs the block again in the backward pass; ``"dots"``
keeps the outputs of its matrix products too and ``"dots_no_batch"`` those
of its products without a batch dimension, recomputing the rest;
``"none"`` keeps everything. Outside autograd (serving, decode) blocks run
plainly. The policies move memory and time, never the bits of the loss or
a gradient.

``mesh=`` (a ``MeshCtx``) runs a block as the reference's ``Block.apply``
under a mesh: the residual constrained after each add
(``MeshCtx.constrain_residual``, no value changed), a MoE FFN expert-parallel
with one data shard's capacity, and with ``manual_tp`` a bias-free dense
FFN through ``distributed/manual_tp.py`` (aux loss 0). In decode only a MoE
FFN reads the mesh.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from repro_torch.distributed.manual_tp import manual_tp_gated_ffn
from repro_torch.distributed.mesh_ctx import MeshCtx
from repro_torch.nn.attention import GQAttention, MLAttention
from repro_torch.nn.layers import GatedMLP, LayerNorm, RMSNorm
from repro_torch.nn.moe import MoELayer

_mm = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_bmm = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)
# remat -> the ops whose outputs a checkpointed block keeps (None: no
# checkpoint), as the reference's jax.checkpoint_policies: nothing_saveable,
# checkpoint_dots, checkpoint_dots_with_no_batch_dims. A Linear is an mm, an
# einsum over a batch axis (attention's scores, the experts) a bmm.
REMAT_POLICIES = {"none": None, "full": (), "dots": _mm + _bmm, "dots_no_batch": _mm}


def _save_only(ops, ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in ops else CheckpointPolicy.PREFER_RECOMPUTE


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
    # MLA
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    nope_head_dim: int = 128
    rope_head_dim: int = 64
    v_head_dim: int = 128
    # MoE (None -> dense FFN)
    moe: Optional[dict] = None     # dict(n_experts, top_k, n_shared, d_ff)
    q_chunk_unroll: bool = False   # the reference's roofline lowering; no effect here

    def attn_module(self, device=None, generator=None) -> nn.Module:
        if self.attention == "mla":
            return MLAttention(self.d_model, self.n_heads, kv_lora_rank=self.kv_lora_rank,
                               q_lora_rank=self.q_lora_rank, nope_head_dim=self.nope_head_dim,
                               rope_head_dim=self.rope_head_dim, v_head_dim=self.v_head_dim,
                               rope_theta=self.rope_theta, causal=True, device=device,
                               generator=generator)
        return GQAttention(self.d_model, self.n_heads, self.head_dim,
                           n_kv_heads=self.n_kv_heads, qk_norm=self.qk_norm,
                           use_bias=self.use_bias, rope_theta=self.rope_theta, causal=True,
                           device=device, generator=generator)

    def norm_module(self, device=None) -> nn.Module:
        if self.norm == "rmsnorm":
            return RMSNorm(self.d_model, device=device)
        return LayerNorm(self.d_model, device=device)

    def ffn_module(self, device=None, generator=None) -> nn.Module:
        if self.moe is not None:
            return MoELayer(self.d_model, self.moe["d_ff"], self.moe["n_experts"],
                            self.moe["top_k"], self.moe.get("n_shared", 0), self.activation,
                            device=device, generator=generator)
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

    def _ffn(self, x: torch.Tensor, mesh=None):
        """(ffn(x), aux loss): a dense FFN's aux loss is 0; a MoE FFN runs
        expert-parallel over ``mesh``."""
        if self.cfg.moe is not None:
            return self.ffn(x, mesh=mesh)
        return self.ffn(x), torch.zeros((), device=x.device)

    def forward(self, x: torch.Tensor, positions: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None, mesh=None):
        """Returns (x, aux_loss)."""
        ctx = mesh if isinstance(mesh, MeshCtx) else None
        x = x + self.attn(self.ln1(x), positions=positions, mask=mask)
        if ctx is not None:
            x = ctx.constrain_residual(x)
        ffn_in = self.ln2(x)
        if (self.cfg.moe is None and ctx is not None and ctx.manual_tp
                and not self.cfg.use_bias):
            h = manual_tp_gated_ffn(ffn_in, self.ffn, ctx, self.cfg.activation)
            aux = torch.zeros((), device=x.device)
        else:
            h, aux = self._ffn(ffn_in, mesh)
        x = x + h
        if ctx is not None:
            x = ctx.constrain_residual(x)
        return x, aux

    def decode_step(self, x: torch.Tensor, cache: dict, cache_len: int, mesh=None):
        """One token against this layer's cache (written in place)."""
        h, cache = self.attn.decode_step(self.ln1(x), cache, cache_len)
        x = x + h
        return x + self._ffn(self.ln2(x), mesh)[0], cache


class Stack(nn.ModuleList):
    """``n_layers`` blocks of one config, run in order. Its exact KV cache
    holds every layer's rows in one tensor a name, layer i reading and
    writing row i in place. Grouped-query attention: ``k`` and ``v`` of
    (n_layers, batch, n_kv_heads, max_len, head_dim), head-major where the
    reference's is (n_layers, batch, max_len, n_kv_heads, head_dim), so
    that a decode step's scores and weighted sum are batched products over
    contiguous (rows, head_dim) slabs (``GQAttention.decode_step``). Latent
    attention: ``ckv`` (n_layers, batch, max_len, kv_lora_rank) and
    ``krope`` (n_layers, batch, max_len, rope_head_dim), the reference's
    layout."""

    def __init__(self, cfg: BlockConfig, n_layers: int, remat: str = "none",
                 unroll: bool = False, *, device=None,
                 generator: Optional[torch.Generator] = None):
        if remat not in REMAT_POLICIES:
            raise ValueError(f"remat {remat!r} not in {tuple(REMAT_POLICIES)}")
        super().__init__([Block(cfg, device=device, generator=generator)
                          for _ in range(n_layers)])
        self.cfg, self.remat, self.unroll = cfg, remat, unroll

    def forward(self, x: torch.Tensor, positions: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None, mesh=None):
        """x (B, T, d_model) -> (x, the blocks' summed aux loss); each block
        checkpointed under ``remat`` where autograd records."""
        aux = torch.zeros((), device=x.device)
        remat = REMAT_POLICIES[self.remat] is not None and torch.is_grad_enabled()
        for block in self:
            if remat:
                x, aux_l = self._checkpointed(block, x, positions, mask, mesh)
            else:
                x, aux_l = block(x, positions=positions, mask=mask, mesh=mesh)
            aux = aux + aux_l
        return x, aux

    def _checkpointed(self, block: Block, x, positions, mask, mesh=None):
        """``block(x)`` under ``torch.utils.checkpoint`` with the remat
        policy. The block's parameters go in as explicit inputs and the block
        runs on them (``functional_call``): the backward pass runs it again
        after any outer ``functional_call`` (the bf16 cast of
        ``LMModel.loss``) has put the model's own parameters back, and must
        see the tensors the forward saw, through which the gradients reach
        the parameters."""
        names, tensors = zip(*block.named_parameters())

        def run(x, *tensors):
            return torch.func.functional_call(block, dict(zip(names, tensors)),
                                              (x, positions, mask), {"mesh": mesh})

        ops = REMAT_POLICIES[self.remat]
        context = (functools.partial(create_selective_checkpoint_contexts,
                                     functools.partial(_save_only, ops)) if ops
                   else noop_context_fn)
        return checkpoint(run, x, *tensors, use_reentrant=False, context_fn=context)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> dict:
        one = self[0].attn.init_cache(batch, max_len, dtype, device="meta")
        return {name: torch.zeros((len(self), *t.shape), dtype=dtype, device=device)
                for name, t in one.items()}

    def decode_step(self, x: torch.Tensor, caches: dict, cache_len: int, mesh=None):
        for i, block in enumerate(self):
            x, _ = block.decode_step(x, {name: t[i] for name, t in caches.items()}, cache_len,
                                     mesh)
        return x, caches
