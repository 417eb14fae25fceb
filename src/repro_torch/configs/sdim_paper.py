"""The paper's own online model (Fig. 3): DIN-style CTR tower with SDIM
long-term interest, m=48 τ=3, L=1024 long / 50 short (industrial setting).
Counterpart of ``repro/configs/sdim_paper.py``, same numbers."""
from repro_torch.core.interest import InterestConfig
from repro_torch.models.ctr import CTRConfig

FAMILY = "recsys"

FULL = CTRConfig(
    arch="din", n_items=10_000_000, n_cats=100_000, embed_dim=64,
    short_len=50, long_len=1024, mlp_hidden=(1024, 512, 256),
    interest=InterestConfig(kind="sdim", m=48, tau=3),
)

SMOKE = CTRConfig(
    arch="din", n_items=1000, n_cats=50, embed_dim=8, short_len=8,
    long_len=32, mlp_hidden=(32, 16),
    interest=InterestConfig(kind="sdim", m=12, tau=2),
)
