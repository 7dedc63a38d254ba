"""xdeepfm [arXiv:1803.05170; paper] — CIN + deep MLP + linear
(``repro.configs.xdeepfm``, field for field)."""
from repro_torch.configs.base import RecsysConfig
from repro_torch.configs.recsys_common import CRITEO39, SMOKE_39

FULL = RecsysConfig(
    name="xdeepfm",
    model="xdeepfm",
    n_sparse=39,
    embed_dim=10,
    vocab_sizes=CRITEO39,
    mlp_dims=(400, 400),
    cin_layers=(200, 200, 200),
)

SMOKE = RecsysConfig(
    name="xdeepfm-smoke",
    model="xdeepfm",
    n_sparse=39,
    embed_dim=8,
    vocab_sizes=SMOKE_39,
    mlp_dims=(32, 32),
    cin_layers=(16, 16),
)
