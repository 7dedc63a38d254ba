"""qwen2-0.5b [arXiv:2407.10671; hf] — dense, GQA kv=2, QKV bias
(``repro.configs.qwen2_0_5b``, field for field).

``rope_theta`` stays at the JAX config's default of 10,000, as in the
reference; the published Qwen2-0.5B ``config.json`` gives 1,000,000.
"""
from repro_torch.configs.base import (
    ArchSpec, LM_SHAPES, TransformerConfig, register,
)

FULL = TransformerConfig(
    name="qwen2-0.5b",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    act="swiglu",
    tie_embeddings=True,
)

SMOKE = TransformerConfig(
    name="qwen2-0.5b-smoke",
    n_layers=2,
    d_model=56,
    n_heads=7,
    n_kv_heads=1,
    d_ff=152,
    vocab_size=512,
    qkv_bias=True,
    act="swiglu",
    tie_embeddings=True,
    dtype="float32",
    param_dtype="float32",
)

register(
    ArchSpec(
        arch_id="qwen2-0.5b",
        family="lm",
        config=FULL,
        shapes=LM_SHAPES,
        smoke_config=SMOKE,
        source="arXiv:2407.10671; hf",
        skip_shapes=("long_500k",),
        notes="Pure full attention -> long_500k skipped (DESIGN.md §4).",
    )
)
