"""dien [arXiv:1809.03672]: embed_dim=18, short seq_len=100, GRU dim=108
(interest extraction) + AUGRU (interest evolution), MLP 200-80.
+ SDIM long-term module.
Counterpart of ``repro/configs/dien.py``, same numbers."""
from repro_torch.core.interest import InterestConfig
from repro_torch.models.ctr import CTRConfig

FAMILY = "recsys"

FULL = CTRConfig(
    arch="dien", n_items=10_000_000, n_cats=100_000, embed_dim=18,
    short_len=100, long_len=1024, mlp_hidden=(200, 80), gru_dim=108,
    interest=InterestConfig(kind="sdim", m=48, tau=3),
)

SMOKE = CTRConfig(
    arch="dien", n_items=1000, n_cats=50, embed_dim=8, short_len=12,
    long_len=32, mlp_hidden=(32, 16), gru_dim=24,
    interest=InterestConfig(kind="sdim", m=12, tau=2),
)
