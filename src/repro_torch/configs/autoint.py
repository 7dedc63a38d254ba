"""autoint [arXiv:1810.11921; paper] — self-attention feature interaction
(``repro.configs.autoint``, field for field)."""
from repro_torch.configs.base import RecsysConfig
from repro_torch.configs.recsys_common import CRITEO39, SMOKE_39

FULL = RecsysConfig(
    name="autoint",
    model="autoint",
    n_sparse=39,
    embed_dim=16,
    vocab_sizes=CRITEO39,
    n_attn_layers=3,
    n_attn_heads=2,
    d_attn=32,
)

SMOKE = RecsysConfig(
    name="autoint-smoke",
    model="autoint",
    n_sparse=39,
    embed_dim=8,
    vocab_sizes=SMOKE_39,
    n_attn_layers=2,
    n_attn_heads=2,
    d_attn=8,
)
