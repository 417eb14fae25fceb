"""The dense LM family: granite-3-2b, command-r-plus-104b, qwen3-8b — one
parameterized decoder-only transformer with grouped-query attention.

Counterpart of ``repro/models/lm.py``'s serving path:

* ``forward`` (hidden states), ``loss`` (next-token cross entropy, its
  value; with ``compute_dtype="bfloat16"`` off a bf16 cast of the
  parameters, as the reference's ``_cast_compute``) and ``prefill``
  (last-position logits);
* exact KV decode: ``init_cache`` and ``decode_step``, one token against
  the cache, written in place (``nn/attention.py``);
* SDIM-compressed KV decode, the paper's BSE idea applied to LM serving:
  ``init_sdim_cache``, ``sdim_decode_step`` and
  ``encode_sdim_cache_from_kv``. Per layer and kv head the values are
  folded into (G × 2^τ) buckets keyed on the keys' SimHash signatures, so
  the decode state is O(G·U·d) a head instead of O(S·d) and a step costs
  the same at any context length; each query reads its kv head's buckets
  with the ℓ2 combine through the ``sdim_query`` kernel. Keys are hashed
  after RoPE at their position, as in the exact cache, so an offline
  ``encode_sdim_cache_from_kv`` of an exact cache and the incremental path
  fold the same keys.

The hash matrix R is a buffer (sdim_m, head_dim) drawn N(0, 1) from a
``torch.Generator`` seeded 1234 on the model's device, beside its fp64
copy ``R64`` for hashing keys. Torch cannot replay the reference's
``jax.random.PRNGKey(1234)``, so parity tests load the reference's R
(``weights.load_jax_lm_params``, which sets both).

Not here yet: MLA and MoE configs (``deepseek-v2-236b``,
``deepseek-moe-16b``; ROADMAP.md, A3b) and the sequence-parallel
``sp_decode_step`` (A5). The model runs on the card unless ``device="cpu"``
is given.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.core import sdim, simhash
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn.layers import Embedding, LayerNorm, RMSNorm
from repro_torch.nn.transformer import BlockConfig, Stack


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
            rope_theta=self.rope_theta, moe=self.moe if moe else None,
            q_chunk_unroll=self.scan_unroll,
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

    def forward(self, tokens, targets):
        return self.model._loss(tokens, targets)


class LMModel(nn.Module):
    def __init__(self, cfg: LMConfig, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.first_k_dense:
            raise NotImplementedError("leading dense blocks before a MoE stack wait for the "
                                      "MoE/MLA slice (ROADMAP.md, A3b)")
        dev = resolve_device(device)
        self.cfg = cfg
        kw = dict(device=dev, generator=generator)
        self.embed = Embedding(cfg.vocab, cfg.d_model, 0.02, **kw)
        self.stack = Stack(cfg.block_cfg(moe=cfg.moe is not None), cfg.n_scan_layers,
                           remat=cfg.remat, unroll=cfg.scan_unroll, **kw)
        self.final_norm = (RMSNorm(cfg.d_model, device=dev) if cfg.norm == "rmsnorm"
                           else LayerNorm(cfg.d_model, device=dev))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Linear(cfg.d_model, cfg.vocab, bias=False, device=dev)
            with torch.no_grad():
                nn.init.normal_(self.lm_head.weight, std=0.02, generator=generator)
        if dev.type == "meta":
            R = torch.empty((cfg.sdim_m, cfg.head_dim), device=dev)
        else:
            R = simhash.make_hashes(torch.Generator(device=dev).manual_seed(1234),
                                    cfg.sdim_m, cfg.head_dim)
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
    def forward(self, tokens: torch.Tensor):
        """tokens (B, T) -> (hidden (B, T, d_model) after the final norm,
        aux loss (0 for a dense stack))."""
        x, aux = self.stack(self.embed(tokens))
        return self.final_norm(x), aux

    def _loss(self, tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        x, aux = self(tokens)
        logits = self._logits(x)
        logz = torch.logsumexp(logits.float(), dim=-1)
        gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
        return torch.mean(logz - gold.float()) + aux

    def _cast_compute(self) -> dict:
        """The parameters cast to bf16 (``compute_dtype="bfloat16"``)."""
        return {f"model.{n}": p.to(torch.bfloat16) if p.is_floating_point() else p
                for n, p in self.named_parameters()}

    def loss(self, tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Next-token cross entropy (targets: tokens shifted by the caller),
        a scalar; the log-sum-exp in fp32 over the compute dtype's logits."""
        if self.cfg.compute_dtype == "float32":
            return self._loss(tokens, targets)
        return torch.func.functional_call(_Loss(self), self._cast_compute(), (tokens, targets))

    # ---------------- serving: exact KV ----------------
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> dict:
        """Zero caches ``{"stack": {"k", "v"}}`` of (n_layers, batch,
        n_kv_heads, max_len, head_dim) on the model's device: head-major
        (``nn/transformer.Stack``), the reference's axes 2 and 3 swapped."""
        return {"stack": self.stack.init_cache(batch, max_len, dtype, device=self.device)}

    def prefill(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence forward; returns the last position's logits (B, 1, V)."""
        x, _ = self(tokens)
        return self._logits(x[:, -1:, :])

    def decode_step(self, token: torch.Tensor, caches: dict, cache_len: int):
        """token (B, 1) at position ``cache_len`` -> (logits (B, 1, V),
        caches), exact attention against the cache's first ``cache_len``
        rows and the new one, which is written into the caches in place."""
        x = self.embed(token)
        x, caches["stack"] = self.stack.decode_step(x, caches["stack"], cache_len)
        return self._logits(self.final_norm(x)), caches

    # ---------------- serving: SDIM-compressed KV ----------------
    def init_sdim_cache(self, batch: int) -> dict:
        """Bucket tables of every layer: ``vt`` (n_layers, batch,
        n_kv_heads, G, U, head_dim) and ``ct`` (n_layers, batch, n_kv_heads,
        G, U), fp32 zeros, and ``len``, the tokens folded in (0)."""
        cfg = self.cfg
        G, U = cfg.sdim_m // cfg.sdim_tau, 1 << cfg.sdim_tau
        shape = (cfg.n_scan_layers, batch, cfg.n_kv_heads, G, U)
        return {"vt": torch.zeros((*shape, cfg.head_dim), device=self.device),
                "ct": torch.zeros(shape, device=self.device),
                "len": 0}

    def sdim_decode_step(self, token: torch.Tensor, sdim_cache: dict):
        """One token (B, 1) against the bucket-compressed KV. Per layer:
        hash the new key and fold (k, v) into the layer's tables in place
        (``core/sdim.kv_bucket_fold``), then each query head reads its kv
        head's buckets with the ℓ2 combine (``sdim_decode_attention``, the
        ``sdim_query`` kernel on the card). The cost does not depend on the
        context length. Returns (logits (B, 1, V), sdim_cache), the cache
        updated in place and its ``len`` advanced by one."""
        cfg = self.cfg
        B = token.shape[0]
        H, D = cfg.n_heads, cfg.head_dim
        positions = torch.full((B, 1), sdim_cache["len"], dtype=torch.int32, device=token.device)
        x = self.embed(token)
        for i, block in enumerate(self.stack):
            vt, ct = sdim_cache["vt"][i], sdim_cache["ct"][i]
            q, k_new, v_new = block.attn.qkv(block.ln1(x), positions)
            sdim.kv_bucket_fold(vt, ct, k_new[:, 0], v_new[:, 0], self.R64, cfg.sdim_tau)
            o = sdim.sdim_decode_attention(q, vt, ct, self.R, cfg.sdim_tau)
            x = x + block.attn.wo(o.reshape(B, 1, H * D).to(x.dtype))
            x = x + block.ffn(block.ln2(x))
        sdim_cache["len"] += 1
        return self._logits(self.final_norm(x)), sdim_cache

    def encode_sdim_cache_from_kv(self, caches: dict, mask: Optional[torch.Tensor] = None) -> dict:
        """Offline BSE pass: compress an exact cache (its first axis the
        layers) into bucket tables ``{"vt", "ct"}``, the layout of
        ``init_sdim_cache`` — what a server does when it moves a long
        session to the compressed path. ``mask`` (B, S) marks the valid
        rows (None: all)."""
        k, v = caches["stack"]["k"], caches["stack"]["v"]       # (L, B, Hkv, S, D)
        tables = [sdim.kv_bucket_table(k[i].transpose(1, 2), v[i].transpose(1, 2), mask,
                                       self.R64, self.cfg.sdim_tau)
                  for i in range(k.shape[0])]
        return {"vt": torch.stack([t[0] for t in tables]),
                "ct": torch.stack([t[1] for t in tables])}
