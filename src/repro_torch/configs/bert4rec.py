"""bert4rec [arXiv:1904.06690]: embed_dim=64, 2 blocks, 2 heads, bidirectional
seq_len=200 (encoder-only: no decode shapes). + SDIM long-term module.
Counterpart of ``repro/configs/bert4rec.py``, same numbers."""
from repro_torch.core.interest import InterestConfig
from repro_torch.models.ctr import CTRConfig

FAMILY = "recsys"

FULL = CTRConfig(
    arch="bert4rec", n_items=10_000_000, n_cats=100_000, embed_dim=64,
    short_len=200, long_len=1024, mlp_hidden=(1024, 512, 256),
    n_heads=2, n_blocks=2,
    interest=InterestConfig(kind="sdim", m=48, tau=3),
)

SMOKE = CTRConfig(
    arch="bert4rec", n_items=1000, n_cats=50, embed_dim=16, short_len=12,
    long_len=32, mlp_hidden=(32, 16), n_heads=2, n_blocks=2,
    interest=InterestConfig(kind="sdim", m=12, tau=2),
)
