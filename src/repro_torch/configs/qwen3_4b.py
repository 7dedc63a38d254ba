"""qwen3-4b [hf:Qwen/Qwen3-8B family; hf] — dense, GQA kv=8, qk_norm.
(``repro.configs.qwen3_4b``, field for field)."""
from repro_torch.configs.base import (
    ArchSpec, LM_SHAPES, TransformerConfig, register,
)

FULL = TransformerConfig(
    name="qwen3-4b",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    act="swiglu",
    rope_theta=1_000_000.0,
)

SMOKE = TransformerConfig(
    name="qwen3-4b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=160,
    vocab_size=512,
    qk_norm=True,
    act="swiglu",
    dtype="float32",
    param_dtype="float32",
)

register(
    ArchSpec(
        arch_id="qwen3-4b",
        family="lm",
        config=FULL,
        shapes=LM_SHAPES,
        smoke_config=SMOKE,
        source="hf:Qwen/Qwen3-8B; hf",
        skip_shapes=("long_500k",),
        notes="Pure full attention -> long_500k skipped (DESIGN.md §4).",
    )
)
