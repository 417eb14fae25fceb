"""command-r-plus-104b [hf:CohereForAI/c4ai-command-r-v01; unverified]:
64L d=12288 96H (GQA kv=8) d_ff=33792 vocab=256000, no-bias, LayerNorm.
Counterpart of ``repro/configs/command_r_plus_104b.py``, same numbers."""
from repro_torch.models.lm import LMConfig

FAMILY = "lm"

FULL = LMConfig(
    name="command-r-plus-104b", n_layers=64, d_model=12288, n_heads=96,
    n_kv_heads=8, head_dim=128, d_ff=33792, vocab=256000, attention="gqa",
    norm="layernorm", use_bias=False, tie_embeddings=True, remat="full",
)

SMOKE = LMConfig(
    name="command-r-plus-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=192, vocab=128, attention="gqa", norm="layernorm",
    tie_embeddings=True, remat="none",
)
