"""deepseek-v2-236b [arXiv:2405.04434]: 60L d=5120 128H, MLA kv_lora=512,
MoE 160 routed top-6 + 2 shared (expert d_ff=1536), vocab=102400,
first layer dense (d_ff=12288). Counterpart of
``repro/configs/deepseek_v2_236b.py``, same numbers."""
from repro_torch.models.lm import LMConfig

FAMILY = "lm"

FULL = LMConfig(
    name="deepseek-v2-236b", n_layers=60, d_model=5120, n_heads=128,
    n_kv_heads=128, head_dim=128, d_ff=12288, vocab=102400, attention="mla",
    kv_lora_rank=512, q_lora_rank=1536, nope_head_dim=128, rope_head_dim=64,
    v_head_dim=128,
    moe=dict(n_experts=160, top_k=6, n_shared=2, d_ff=1536),
    first_k_dense=1, remat="full",
)

SMOKE = LMConfig(
    name="deepseek-v2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab=128, attention="mla", kv_lora_rank=32,
    q_lora_rank=48, nope_head_dim=16, rope_head_dim=8, v_head_dim=16,
    moe=dict(n_experts=8, top_k=2, n_shared=2, d_ff=32),
    first_k_dense=1, remat="none",
)
