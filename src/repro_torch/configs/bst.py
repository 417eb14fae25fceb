"""bst [arXiv:1905.06874 Alibaba]: embed_dim=32, short seq_len=20,
1 transformer block, 8 heads, MLP 1024-512-256. + SDIM long-term module.
Counterpart of ``repro/configs/bst.py``, same numbers."""
from repro_torch.core.interest import InterestConfig
from repro_torch.models.ctr import CTRConfig

FAMILY = "recsys"

FULL = CTRConfig(
    arch="bst", n_items=10_000_000, n_cats=100_000, embed_dim=32,
    short_len=20, long_len=1024, mlp_hidden=(1024, 512, 256),
    n_heads=8, n_blocks=1,
    interest=InterestConfig(kind="sdim", m=48, tau=3),
)

SMOKE = CTRConfig(
    arch="bst", n_items=1000, n_cats=50, embed_dim=8, short_len=10,
    long_len=32, mlp_hidden=(32, 16), n_heads=2, n_blocks=1,
    interest=InterestConfig(kind="sdim", m=12, tau=2),
)
