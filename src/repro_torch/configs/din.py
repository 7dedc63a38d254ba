"""din [arXiv:1706.06978; paper] — target attention over behaviours
(``repro.configs.din``, field for field)."""
from repro_torch.configs.base import RecsysConfig
from repro_torch.configs.recsys_common import (
    AMAZON_CTX, ITEM_VOCAB, SMOKE_CTX, SMOKE_ITEMS,
)

FULL = RecsysConfig(
    name="din",
    model="din",
    n_sparse=len(AMAZON_CTX),
    embed_dim=18,
    vocab_sizes=AMAZON_CTX,
    mlp_dims=(200, 80),
    seq_len=100,
    item_vocab=ITEM_VOCAB,
    attn_mlp=(80, 40),
)

SMOKE = RecsysConfig(
    name="din-smoke",
    model="din",
    n_sparse=len(SMOKE_CTX),
    embed_dim=18,
    vocab_sizes=SMOKE_CTX,
    mlp_dims=(32, 16),
    seq_len=12,
    item_vocab=SMOKE_ITEMS,
    attn_mlp=(16, 8),
)
