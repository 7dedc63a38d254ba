"""dien [arXiv:1809.03672; unverified] — GRU + AUGRU interest evolution
(``repro.configs.dien``, field for field)."""
from repro_torch.configs.base import RecsysConfig
from repro_torch.configs.recsys_common import (
    AMAZON_CTX, ITEM_VOCAB, SMOKE_CTX, SMOKE_ITEMS,
)

FULL = RecsysConfig(
    name="dien",
    model="dien",
    n_sparse=len(AMAZON_CTX),
    embed_dim=18,
    vocab_sizes=AMAZON_CTX,
    mlp_dims=(200, 80),
    seq_len=100,
    item_vocab=ITEM_VOCAB,
    gru_dim=108,
)

SMOKE = RecsysConfig(
    name="dien-smoke",
    model="dien",
    n_sparse=len(SMOKE_CTX),
    embed_dim=18,
    vocab_sizes=SMOKE_CTX,
    mlp_dims=(32, 16),
    seq_len=12,
    item_vocab=SMOKE_ITEMS,
    gru_dim=36,
)
