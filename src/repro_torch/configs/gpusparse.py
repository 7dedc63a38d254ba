"""The gpusparse encoder configurations (``repro.configs.gpusparse``).

A SPLADE-style encoder with a BERT-base-shaped backbone and the 30,522-term
vocabulary; ``ENCODER_SMOKE`` is the reduced one the CPU tests run.
"""
from repro_torch.configs.base import TransformerConfig

ENCODER = TransformerConfig(
    name="splade-encoder",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=30522,
    act="gelu",
    tie_embeddings=True,
)

ENCODER_SMOKE = TransformerConfig(
    name="splade-encoder-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    act="gelu",
    tie_embeddings=True,
    dtype="float32",
    param_dtype="float32",
    remat=False,
)
