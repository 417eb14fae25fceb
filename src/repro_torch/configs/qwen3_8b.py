"""qwen3-8b [hf:Qwen/Qwen3-8B]: 36L d=4096 32H (GQA kv=8) d_ff=12288
vocab=151936, qk_norm. Counterpart of ``repro/configs/qwen3_8b.py``, same
numbers."""
from repro_torch.models.lm import LMConfig

FAMILY = "lm"

FULL = LMConfig(
    name="qwen3-8b", n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    head_dim=128, d_ff=12288, vocab=151936, attention="gqa", qk_norm=True,
    rope_theta=1e6, remat="full",
)

SMOKE = LMConfig(
    name="qwen3-8b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab=128, attention="gqa", qk_norm=True, remat="none",
)
