"""MODEL_FLOPS per cell: the "useful work" yardstick of a step.

The port's counterpart of ``repro/launch/flops.py``, the same counts:

* LM train:   6·N_active·D (D = tokens; an MoE counts its top-k and shared
  experts only) + 12·L·B·S²·(attention width), the causal attention term;
* LM prefill: 2·N_active·D + 4·L·B·S²·(attention width);
* LM decode:  2·N_active·B + the exact cache's reads (4·B·L·H·S·hd for GQA,
  4·B·L·H·S·r for MLA); the SDIM-KV variant reads G·U buckets instead of S
  rows;
* recsys:     6·B·N_dense + the SDIM / target-attention interest op's flops
  (embedding lookups are gathers, not flops);
* GNN train:  3 × (L·2·d²·(4E + N) + 2·N·(d_feat·d + d²)) over the step's
  N nodes and E edges (a sampled block's union sizes, a graph batch's
  sums).

Configs and shapes come from the port's registry (``configs/registry.py``:
FULL configs, ``LM_SHAPES``, ``GNN_SHAPES`` and ``RECSYS_SHAPES``).
"""
from __future__ import annotations

from repro_torch.configs import registry


def _lm_active_params(cfg) -> float:
    d = cfg.d_model
    if cfg.attention == "mla":
        attn = (d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.n_heads *
                (cfg.nope_head_dim + cfg.rope_head_dim)
                + d * (cfg.kv_lora_rank + cfg.rope_head_dim)
                + cfg.kv_lora_rank * cfg.n_heads * (cfg.nope_head_dim + cfg.v_head_dim)
                + cfg.n_heads * cfg.v_head_dim * d)
    else:
        attn = d * cfg.n_heads * cfg.head_dim * 2 + d * cfg.n_kv_heads * cfg.head_dim * 2
    dense_ffn = 3 * d * cfg.d_ff
    if cfg.moe:
        e_ffn = 3 * d * cfg.moe["d_ff"]
        moe_ffn = (e_ffn * (cfg.moe["top_k"] + cfg.moe.get("n_shared", 0))
                   + d * cfg.moe["n_experts"])
        n = cfg.first_k_dense * (attn + dense_ffn) + cfg.n_scan_layers * (attn + moe_ffn)
    else:
        n = cfg.n_layers * (attn + dense_ffn)
    n += cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    return float(n)


def _lm_total_params(cfg) -> float:
    d = cfg.d_model
    if cfg.moe:
        e_ffn = 3 * d * cfg.moe["d_ff"]
        extra = cfg.n_scan_layers * e_ffn * (cfg.moe["n_experts"] - cfg.moe["top_k"])
        return _lm_active_params(cfg) + extra
    return _lm_active_params(cfg)


def _recsys_dense_params(cfg) -> float:
    e = cfg.behavior_dim
    dims = [_recsys_head_in(cfg), *cfg.mlp_hidden, 1]
    n = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    if cfg.arch == "bst":
        n += (cfg.n_blocks * (4 * e * e + 2 * e * 4 * e))
    if cfg.arch == "dien":
        n += 3 * (e * cfg.gru_dim + cfg.gru_dim ** 2) * 2 + e * cfg.gru_dim
    if cfg.arch == "bert4rec":
        ed = cfg.embed_dim
        n += e * ed + cfg.n_blocks * (4 * ed * ed + 8 * ed * ed)
    return float(n)


def _recsys_head_in(cfg) -> int:
    """The CTR head's input width, from the model's shapes (built on
    ``device="meta"``: no memory)."""
    from repro_torch.models.ctr import CTRModel

    return CTRModel(cfg, device="meta")._head_in_dim()


def _interest_flops(cfg, B: int, L: int) -> float:
    e = cfg.behavior_dim
    k = cfg.interest
    if k.kind == "sdim":
        hash_seq = 2.0 * L * k.m * e
        scatter = 2.0 * L * (k.m // k.tau) * (1 << k.tau) * e
        hash_q = 2.0 * k.m * e
        gather = 2.0 * (k.m // k.tau) * (1 << k.tau) * e
        return B * (hash_seq + scatter + hash_q + gather)
    if k.kind == "target":
        return B * 4.0 * L * e
    return 0.0


def _attention_width(cfg) -> int:
    return cfg.n_heads * (cfg.head_dim if cfg.attention == "gqa" else cfg.nope_head_dim)


def model_flops(arch: str, shape_name: str, variant: str = "baseline") -> float:
    """The model flops of one step of ``arch``'s FULL config at the family
    shape ``shape_name``; ``variant="sdim_kv"``: LM decode off the
    bucket-compressed KV."""
    fam = registry.family(arch)
    cfg = registry.get(arch).FULL
    shape = registry.shapes_for(arch)[shape_name]

    if fam == "lm":
        n_act = _lm_active_params(cfg)
        B = shape["global_batch"]
        S = shape["seq"]
        if shape["kind"] == "train":
            return 6.0 * n_act * B * S + 12.0 * cfg.n_layers * B * S * S * _attention_width(cfg)
        if shape["kind"] == "prefill":
            return 2.0 * n_act * B * S + 4.0 * cfg.n_layers * B * S * S * _attention_width(cfg)
        # decode: one token
        base = 2.0 * n_act * B
        if variant == "sdim_kv":
            G, U = cfg.sdim_m // cfg.sdim_tau, 1 << cfg.sdim_tau
            dk = cfg.kv_lora_rank if cfg.attention == "mla" else cfg.head_dim
            return base + 4.0 * B * cfg.n_layers * cfg.n_heads * G * U * dk
        width = cfg.kv_lora_rank if cfg.attention == "mla" else cfg.head_dim
        return base + 4.0 * B * cfg.n_layers * cfg.n_heads * S * width

    if fam == "gnn":
        gcfg = registry.gnn_config_for_shape(cfg, shape)
        d = gcfg.d_hidden
        if shape["kind"] == "sampled":
            N, E = registry.sampled_subgraph_sizes(shape)
        elif shape["kind"] == "graph_batch":
            N, E = shape["n_nodes"] * shape["batch"], shape["n_edges"] * shape["batch"]
        else:
            N, E = shape["n_nodes"], shape["n_edges"]
        fwd = cfg.n_layers * 2.0 * d * d * (4 * E + N) + 2.0 * N * (gcfg.d_feat * d + d * d)
        return 3.0 * fwd

    nd = _recsys_dense_params(cfg)
    if shape["kind"] == "train":
        B = shape["global_batch"]
        return 6.0 * B * nd + 3.0 * _interest_flops(cfg, B, cfg.long_len)
    if shape["kind"] == "serve":
        B = shape["global_batch"]
        return 2.0 * B * nd + _interest_flops(cfg, B, cfg.long_len)
    C = shape["n_candidates"]
    # the user's sequence encoded once, then a query and the head per candidate
    enc = _interest_flops(cfg, 1, cfg.long_len)
    per_c = 2.0 * nd + 2.0 * cfg.interest.m * cfg.behavior_dim
    return enc + C * per_c
