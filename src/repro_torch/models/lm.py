"""The LM family: granite-3-2b, command-r-plus-104b, qwen3-8b,
deepseek-moe-16b and deepseek-v2-236b — one parameterized decoder-only
transformer, grouped-query or latent attention (MLA), dense or
mixture-of-experts FFNs, ``first_k_dense`` leading dense blocks before a
MoE stack.

Counterpart of ``repro/models/lm.py``'s training and serving paths:

* ``forward`` (hidden states and the MoE aux loss), ``loss`` (next-token
  cross entropy plus the aux loss; with ``compute_dtype="bfloat16"`` off a
  bf16 cast of the parameters, as the reference's ``_cast_compute``, whose
  gradients reach the fp32 parameters through the cast) and ``prefill``
  (last-position logits). ``loss.backward()`` gives the reference's
  ``jax.grad`` of its loss; the stack's blocks run under the config's
  ``remat`` (``nn/transformer.py``), which moves memory, not bits.
  ``launch/train.py`` trains it;
* exact KV decode: ``init_cache`` and ``decode_step``, one token against
  the caches of the dense blocks and the stack, written in place
  (``nn/attention.py``);
* SDIM-compressed KV decode, the paper's BSE idea applied to LM serving:
  ``init_sdim_cache``, ``sdim_decode_step`` and
  ``encode_sdim_cache_from_kv``. Per layer and kv head the values are
  folded into (G × 2^τ) buckets keyed on the keys' SimHash signatures, so
  the decode state is O(G·U·d) a head instead of O(S·d) and a step costs
  the same at any context length; each query reads its kv head's buckets
  with the ℓ2 combine through the ``sdim_query`` kernel. Keys are hashed
  after RoPE at their position, as in the exact cache, so an offline
  ``encode_sdim_cache_from_kv`` of an exact cache and the incremental path
  fold the same keys. For MLA the buckets live over the kv_lora_rank-wide
  latent c_kv, key and value at once, one table a layer; each head's query
  is absorbed into the latent (q_nope·wk_b) and all H heads read that one
  table as the candidates of one ``sdim_query`` row (at deepseek-v2's r =
  512, the kernel's wide path); the decoupled-RoPE score term is dropped,
  as in the reference.

As in the reference, the three SDIM functions cover the scanned stack only:
the ``first_k_dense`` blocks are neither run by ``sdim_decode_step`` nor
folded (ROADMAP.md, fault C6 of the reference, copied on purpose so that
parity holds).

The hash matrix R is a buffer (sdim_m, head_dim; kv_lora_rank for MLA)
drawn N(0, 1) from a ``torch.Generator`` seeded 1234 on the model's device,
beside its fp64 copy ``R64`` for hashing keys. Torch cannot replay the
reference's ``jax.random.PRNGKey(1234)``, so parity tests load the
reference's R (``weights.load_jax_lm_params``, which sets both).

* split-KV sequence-parallel decode: ``sp_decode_step``, the reference's
  flash-decoding across the mesh (``lm.py:332-432``): the exact cache stays
  split on its sequence axis over ``ctx.seq_axes`` and is only read; each
  layer combines per-shard partial softmaxes (``nn/attention.py``'s
  ``gqa_sp_decode_attention`` / ``mla_sp_decode_attention``), the MoE FFNs
  run expert-parallel with tokens replicated (``ctx.for_decode()``), and
  the new token's keys and values are returned for the caller to append.

* under a mesh (``mesh=``, a ``MeshCtx``; the reference's
  ``lm.py:121-233``): ``forward``, ``loss`` and ``prefill`` run each block
  under it (``nn/transformer.Block``: the residual constrained with
  ``act_seq_shard``, MoE FFNs expert-parallel with one data shard's
  capacity, with ``manual_tp`` the dense FFN as ``distributed/manual_tp``'s
  bf16 Megatron split), ``loss`` constrains the logits (B over data, V over
  model); ``decode_step`` and ``sdim_decode_step`` run their MoE FFNs
  expert-parallel with tokens replicated (``ctx.for_decode()``), so the
  SDIM path runs kernel 4 beside expert-parallel experts. The port
  computes on whole tensors: a constraint changes no value, and the
  parameters' placement as blocks is ``distributed/sharding.py``'s.

The model runs on the card unless ``device="cpu"`` is given.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.core import sdim, simhash
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.mesh_ctx import MeshCtx
from repro_torch.nn.attention import (MLAttention, gqa_sp_decode_attention,
                                      mla_sp_decode_attention)
from repro_torch.nn.layers import Embedding, LayerNorm, RMSNorm
from repro_torch.nn.transformer import Block, BlockConfig, Stack


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    attention: str = "gqa"              # "gqa" | "mla"
    qk_norm: bool = False
    use_bias: bool = False
    norm: str = "rmsnorm"
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # MoE
    moe: Optional[dict] = None          # {"n_experts","top_k","n_shared","d_ff"}
    first_k_dense: int = 0              # leading dense layers before MoE stack
    # MLA
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    nope_head_dim: int = 128
    rope_head_dim: int = 64
    v_head_dim: int = 128
    # training
    remat: str = "full"
    compute_dtype: str = "float32"   # "bfloat16": the loss runs off a bf16 cast
    scan_unroll: bool = False
    # SDIM-KV compression (long-context decode)
    sdim_m: int = 48
    sdim_tau: int = 3

    def block_cfg(self, moe: bool) -> BlockConfig:
        return BlockConfig(
            d_model=self.d_model, n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
            head_dim=self.head_dim, d_ff=self.d_ff, attention=self.attention,
            norm=self.norm, qk_norm=self.qk_norm, use_bias=self.use_bias,
            rope_theta=self.rope_theta, kv_lora_rank=self.kv_lora_rank,
            q_lora_rank=self.q_lora_rank, nope_head_dim=self.nope_head_dim,
            rope_head_dim=self.rope_head_dim, v_head_dim=self.v_head_dim,
            moe=self.moe if moe else None, q_chunk_unroll=self.scan_unroll,
        )

    @property
    def n_scan_layers(self) -> int:
        return self.n_layers - self.first_k_dense


class _Loss(nn.Module):
    """``model._loss`` as a module's forward, so ``torch.func.functional_call``
    can run it on other parameters (the bf16 cast)."""

    def __init__(self, model: "LMModel"):
        super().__init__()
        self.model = model

    def forward(self, tokens, targets, mesh=None):
        return self.model._loss(tokens, targets, mesh)


class LMModel(nn.Module):
    def __init__(self, cfg: LMConfig, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        kw = dict(device=dev, generator=generator)
        self.embed = Embedding(cfg.vocab, cfg.d_model, 0.02, **kw)
        self.stack = Stack(cfg.block_cfg(moe=cfg.moe is not None), cfg.n_scan_layers,
                           remat=cfg.remat, unroll=cfg.scan_unroll, **kw)
        # the leading dense blocks: dense FFN of d_ff, the arch's attention
        self.dense_blocks = nn.ModuleList([Block(cfg.block_cfg(moe=False), **kw)
                                           for _ in range(cfg.first_k_dense)])
        self.final_norm = (RMSNorm(cfg.d_model, device=dev) if cfg.norm == "rmsnorm"
                           else LayerNorm(cfg.d_model, device=dev))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Linear(cfg.d_model, cfg.vocab, bias=False, device=dev)
            with torch.no_grad():
                nn.init.normal_(self.lm_head.weight, std=0.02, generator=generator)
        dk = cfg.kv_lora_rank if cfg.attention == "mla" else cfg.head_dim
        if dev.type == "meta":
            R = torch.empty((cfg.sdim_m, dk), device=dev)
        else:
            R = simhash.make_hashes(torch.Generator(device=dev).manual_seed(1234),
                                    cfg.sdim_m, dk)
        self.register_buffer("R", R)
        # the keys' hash projects in fp64 (core/sdim.kv_signatures): its copy
        # of R, made once, not per layer and step; whoever writes R writes it
        self.register_buffer("R64", R.double())

    @property
    def device(self) -> torch.device:
        return self.R.device

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return self.embed.attend(x)
        return self.lm_head(x)

    # ---------------- forward / loss ----------------
    def forward(self, tokens: torch.Tensor, mesh=None):
        """tokens (B, T) -> (hidden (B, T, d_model) after the final norm,
        the summed MoE aux loss (0 for dense blocks)); ``mesh`` (a
        ``MeshCtx``) runs the blocks under it (``nn/transformer.Block``)."""
        x = self.embed(tokens)
        aux = torch.zeros((), device=x.device)
        for block in self.dense_blocks:
            x, aux_i = block(x, mesh=mesh)
            aux = aux + aux_i
        x, aux_s = self.stack(x, mesh=mesh)
        return self.final_norm(x), aux + aux_s

    def _loss(self, tokens: torch.Tensor, targets: torch.Tensor, mesh=None) -> torch.Tensor:
        ctx = mesh if isinstance(mesh, MeshCtx) else None
        x, aux = self(tokens, mesh=mesh)
        logits = self._logits(x)
        if ctx is not None:       # vocab-split logits: B over data, V over model
            logits = ctx.constrain(logits, ctx.data_axes, None, ctx.model_axis)
        logz = torch.logsumexp(logits.float(), dim=-1)
        gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
        return torch.mean(logz - gold.float()) + aux

    def _cast_compute(self) -> dict:
        """The parameters cast to bf16 (``compute_dtype="bfloat16"``)."""
        return {f"model.{n}": p.to(torch.bfloat16) if p.is_floating_point() else p
                for n, p in self.named_parameters()}

    def loss(self, tokens: torch.Tensor, targets: torch.Tensor, mesh=None) -> torch.Tensor:
        """Next-token cross entropy (targets: tokens shifted by the caller),
        a scalar; the log-sum-exp in fp32 over the compute dtype's logits.
        ``mesh``: a ``MeshCtx``, as ``forward``'s; the logits constrained B
        over the data axes, V over the model axis."""
        if self.cfg.compute_dtype == "float32":
            return self._loss(tokens, targets, mesh)
        return torch.func.functional_call(_Loss(self), self._cast_compute(), (tokens, targets),
                                          {"mesh": mesh})

    # ---------------- serving: exact KV ----------------
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> dict:
        """Zero caches on the model's device: ``{"stack": ...}`` of the
        scanned layers (``nn/transformer.Stack.init_cache``: for GQA ``k``,
        ``v`` (n_layers, batch, n_kv_heads, max_len, head_dim), head-major,
        the reference's axes 2 and 3 swapped; for MLA ``ckv``, ``krope``)
        and, with ``first_k_dense``, ``"dense"``: one such cache without the
        layer axis per dense block, as the reference's list."""
        caches = {"stack": self.stack.init_cache(batch, max_len, dtype, device=self.device)}
        if self.cfg.first_k_dense:
            caches["dense"] = [block.attn.init_cache(batch, max_len, dtype, device=self.device)
                               for block in self.dense_blocks]
        return caches

    def prefill(self, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
        """Full-sequence forward; returns the last position's logits (B, 1, V)."""
        x, _ = self(tokens, mesh=mesh)
        return self._logits(x[:, -1:, :])

    def decode_step(self, token: torch.Tensor, caches: dict, cache_len: int, mesh=None):
        """token (B, 1) at position ``cache_len`` -> (logits (B, 1, V),
        caches), exact attention against the cache's first ``cache_len``
        rows and the new one, which is written into the caches in place.
        ``mesh``: MoE FFNs expert-parallel with tokens replicated
        (``MeshCtx.for_decode``)."""
        ctx = MeshCtx.wrap(mesh)
        mesh = ctx.for_decode() if ctx is not None else None
        x = self.embed(token)
        for block, cache in zip(self.dense_blocks, caches.get("dense", ())):
            x, _ = block.decode_step(x, cache, cache_len, mesh)
        x, caches["stack"] = self.stack.decode_step(x, caches["stack"], cache_len, mesh)
        return self._logits(self.final_norm(x)), caches

    # ---------------- serving: split-KV sequence-parallel decode ----------------
    def _sp_attention(self, block, x, cache: dict, cache_len: int, ctx: MeshCtx):
        """x + one block's attention in split-KV form -> (x, the new
        token's {"k", "v"} (B, 1, Hkv, D) or {"ckv", "krope"} (B, 1, r / dr))."""
        attn = block.attn
        h_in = block.ln1(x)
        B = x.shape[0]
        positions = torch.full((B, 1), cache_len, dtype=torch.int32, device=x.device)
        if isinstance(attn, MLAttention):
            q_nope, q_rope = attn.q(h_in, positions)
            c_new, kr_new = attn.kv_latent(h_in, positions)
            out_lat = mla_sp_decode_attention(attn.absorb_q(q_nope), q_rope, cache["ckv"],
                                              cache["krope"], c_new, kr_new, cache_len, ctx,
                                              ctx.seq_axes, ctx.data_axes, attn.scale)
            h, new = attn.up_values(out_lat.to(x.dtype)), {"ckv": c_new, "krope": kr_new}
        else:
            q, k_new, v_new = attn.qkv(h_in, positions)
            h = gqa_sp_decode_attention(q, cache["k"], cache["v"], k_new, v_new, cache_len, ctx,
                                        ctx.seq_axes, ctx.data_axes).to(x.dtype)
            new = {"k": k_new, "v": v_new}
        return x + attn.wo(h), new

    @staticmethod
    def _layer(caches: dict, i: int) -> dict:
        """Layer i of the stack's caches: a row of each tensor, or of each
        shard of a list of shards (``nn/attention.shard_seq``)."""
        return {name: [blk[i] for blk in t] if isinstance(t, (list, tuple)) else t[i]
                for name, t in caches.items()}

    def sp_decode_step(self, token: torch.Tensor, caches: dict, cache_len: int, ctx: MeshCtx):
        """One token (B, 1) at position ``cache_len`` against exact caches
        (``init_cache``'s, holding ``cache_len`` valid rows) whose sequence
        axis is split over ``ctx.seq_axes`` (a cache tensor, or a list of its
        shards split on that axis), the batch over ``ctx.data_axes``. The
        dense blocks, then the stack; MoE FFNs expert-parallel under
        ``ctx.for_decode()``. Returns (logits (B, 1, V), new_kv):
        ``{"stack": {name: (n_scan_layers, B, 1, ...)}}`` of the new token's
        k and v (GQA, (B, 1, Hkv, D) a layer) or ckv and krope (MLA), and
        ``"dense"``, one such dict a dense block; ``caches`` is not written."""
        if not isinstance(ctx, MeshCtx) or not ctx.seq_axes:
            raise ValueError("sp_decode_step needs a MeshCtx with seq_axes")
        ffn_ctx = ctx.for_decode()
        x = self.embed(token)
        dense_new = []
        for block, cache in zip(self.dense_blocks, caches.get("dense", ())):
            x, new = self._sp_attention(block, x, cache, cache_len, ctx)
            x = x + block._ffn(block.ln2(x))[0]
            dense_new.append(new)
        stack_new = []
        for i, block in enumerate(self.stack):
            x, new = self._sp_attention(block, x, self._layer(caches["stack"], i), cache_len, ctx)
            ffn_in = block.ln2(x)
            x = x + (block.ffn(ffn_in, mesh=ffn_ctx)[0] if block.cfg.moe is not None
                     else block.ffn(ffn_in))
            stack_new.append(new)
        new_kv = {"stack": {name: torch.stack([n[name] for n in stack_new])
                            for name in stack_new[0]}}
        if dense_new:
            new_kv["dense"] = dense_new
        return self._logits(self.final_norm(x)), new_kv

    # ---------------- serving: SDIM-compressed KV ----------------
    def init_sdim_cache(self, batch: int) -> dict:
        """Bucket tables of every scanned layer: ``vt`` (n_scan_layers,
        batch, H, G, U, dv) and ``ct`` (n_scan_layers, batch, H, G, U), fp32
        zeros, and ``len``, the tokens folded in (0). H, dv: n_kv_heads,
        head_dim for GQA; 1, kv_lora_rank for MLA (one table of the
        latent)."""
        cfg = self.cfg
        G, U = cfg.sdim_m // cfg.sdim_tau, 1 << cfg.sdim_tau
        H, dv = (1, cfg.kv_lora_rank) if cfg.attention == "mla" else (cfg.n_kv_heads,
                                                                      cfg.head_dim)
        shape = (cfg.n_scan_layers, batch, H, G, U)
        return {"vt": torch.zeros((*shape, dv), device=self.device),
                "ct": torch.zeros(shape, device=self.device),
                "len": 0}

    def _sdim_attention(self, attn, h_in: torch.Tensor, positions: torch.Tensor, vt, ct):
        """One scanned layer's SDIM-KV attention (before ``wo``'s input is
        cast): fold the new key and value into the layer's tables in place,
        then read them with each query head -> (B, 1, H·dv)."""
        cfg = self.cfg
        B = h_in.shape[0]
        if cfg.attention == "mla":
            q_nope, _ = attn.q(h_in, positions)
            c_new, _ = attn.kv_latent(h_in, positions)          # the latent: key and value
            sdim.kv_bucket_fold(vt, ct, c_new, c_new, self.R64, cfg.sdim_tau)
            # the absorbed queries (B, 1, H, r): all H heads read the one table
            out_lat = sdim.sdim_decode_attention(attn.absorb_q(q_nope), vt, ct, self.R,
                                                 cfg.sdim_tau)
            return attn.up_values(out_lat.to(h_in.dtype))
        q, k_new, v_new = attn.qkv(h_in, positions)
        sdim.kv_bucket_fold(vt, ct, k_new[:, 0], v_new[:, 0], self.R64, cfg.sdim_tau)
        o = sdim.sdim_decode_attention(q, vt, ct, self.R, cfg.sdim_tau)
        return o.reshape(B, 1, cfg.n_heads * cfg.head_dim).to(h_in.dtype)

    def sdim_decode_step(self, token: torch.Tensor, sdim_cache: dict, mesh=None):
        """One token (B, 1) against the bucket-compressed KV. Per scanned
        layer: hash the new key and fold (k, v) into the layer's tables in
        place (``core/sdim.kv_bucket_fold``), then each query head reads its
        kv head's buckets with the ℓ2 combine (``sdim_decode_attention``, the
        ``sdim_query`` kernel on the card). The cost does not depend on the
        context length. The ``first_k_dense`` blocks are not run (the
        reference's C6). ``mesh``: MoE FFNs expert-parallel with tokens
        replicated (``MeshCtx.for_decode``). Returns (logits (B, 1, V),
        sdim_cache), the cache updated in place and its ``len`` advanced by
        one."""
        ctx = MeshCtx.wrap(mesh)
        mesh = ctx.for_decode() if ctx is not None else None
        B = token.shape[0]
        positions = torch.full((B, 1), sdim_cache["len"], dtype=torch.int32, device=token.device)
        x = self.embed(token)
        for i, block in enumerate(self.stack):
            h = self._sdim_attention(block.attn, block.ln1(x), positions,
                                     sdim_cache["vt"][i], sdim_cache["ct"][i])
            x = x + block.attn.wo(h)
            x = x + block._ffn(block.ln2(x), mesh)[0]
        sdim_cache["len"] += 1
        return self._logits(self.final_norm(x)), sdim_cache

    def encode_sdim_cache_from_kv(self, caches: dict, mask: Optional[torch.Tensor] = None) -> dict:
        """Offline BSE pass: compress an exact cache's scanned layers (its
        first axis the layers) into bucket tables ``{"vt", "ct"}``, the
        layout of ``init_sdim_cache`` — what a server does when it moves a
        long session to the compressed path. GQA folds the values keyed on
        the keys, MLA the latent ``ckv`` keyed on itself. ``mask`` (B, S)
        marks the valid rows (None: all)."""
        stack = caches["stack"]
        if self.cfg.attention == "mla":
            k = v = stack["ckv"][:, :, :, None]                 # (L, B, S, 1, r)
        else:
            k, v = stack["k"].transpose(2, 3), stack["v"].transpose(2, 3)   # (L, B, S, Hkv, D)
        tables = [sdim.kv_bucket_table(k[i], v[i], mask, self.R64, self.cfg.sdim_tau)
                  for i in range(k.shape[0])]
        return {"vt": torch.stack([t[0] for t in tables]),
                "ct": torch.stack([t[1] for t in tables])}
