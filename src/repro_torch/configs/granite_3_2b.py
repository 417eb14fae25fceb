"""granite-3-2b [hf:ibm-granite/granite-3.0-2b-base]: 40L d=2048 32H (GQA kv=8)
d_ff=8192 vocab=49155. Counterpart of ``repro/configs/granite_3_2b.py``,
same numbers."""
from repro_torch.models.lm import LMConfig

FAMILY = "lm"

FULL = LMConfig(
    name="granite-3-2b", n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
    head_dim=64, d_ff=8192, vocab=49155, attention="gqa", tie_embeddings=True,
    remat="full",
)

SMOKE = LMConfig(
    name="granite-3-2b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab=128, attention="gqa", tie_embeddings=True,
    remat="none",
)
