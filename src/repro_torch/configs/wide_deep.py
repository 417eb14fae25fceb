"""wide-deep [arXiv:1606.07792]: 40 sparse fields, embed_dim=32,
MLP 1024-512-256, concat interaction. + SDIM long-term module (paper §4.4:
architecture-free).
Counterpart of ``repro/configs/wide_deep.py``, same numbers."""
from repro_torch.core.interest import InterestConfig
from repro_torch.models.ctr import CTRConfig

FAMILY = "recsys"

FULL = CTRConfig(
    arch="wide_deep", n_items=10_000_000, n_cats=100_000, embed_dim=32,
    short_len=16, long_len=1024, mlp_hidden=(1024, 512, 256),
    n_sparse=40, field_vocab=1_000_000,
    interest=InterestConfig(kind="sdim", m=48, tau=3),
)

SMOKE = CTRConfig(
    arch="wide_deep", n_items=1000, n_cats=50, embed_dim=8, short_len=8,
    long_len=32, mlp_hidden=(32, 16), n_sparse=5, field_vocab=100,
    interest=InterestConfig(kind="sdim", m=12, tau=2),
)
