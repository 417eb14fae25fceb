"""deepseek-moe-16b [arXiv:2401.06066]: 28L d=2048 16H (MHA kv=16),
MoE 64 routed top-6 + 2 shared (expert d_ff=1408), vocab=102400,
first layer dense (d_ff=10944), fine-grained experts. Counterpart of
``repro/configs/deepseek_moe_16b.py``, same numbers."""
from repro_torch.models.lm import LMConfig

FAMILY = "lm"

FULL = LMConfig(
    name="deepseek-moe-16b", n_layers=28, d_model=2048, n_heads=16,
    n_kv_heads=16, head_dim=128, d_ff=10944, vocab=102400, attention="gqa",
    moe=dict(n_experts=64, top_k=6, n_shared=2, d_ff=1408),
    first_k_dense=1, remat="full",
)

SMOKE = LMConfig(
    name="deepseek-moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab=128, attention="gqa",
    moe=dict(n_experts=8, top_k=2, n_shared=2, d_ff=32),
    first_k_dense=1, remat="none",
)
