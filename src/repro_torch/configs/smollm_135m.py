"""smollm-135m [hf:HuggingFaceTB/SmolLM-135M; hf] — llama-arch small.
(``repro.configs.smollm_135m``, field for field)."""
from repro_torch.configs.base import (
    ArchSpec, LM_SHAPES, TransformerConfig, register,
)

FULL = TransformerConfig(
    name="smollm-135m",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    act="swiglu",
)

SMOKE = TransformerConfig(
    name="smollm-135m-smoke",
    n_layers=2,
    d_model=48,
    n_heads=3,
    n_kv_heads=1,
    d_ff=128,
    vocab_size=512,
    act="swiglu",
    dtype="float32",
    param_dtype="float32",
)

register(
    ArchSpec(
        arch_id="smollm-135m",
        family="lm",
        config=FULL,
        shapes=LM_SHAPES,
        smoke_config=SMOKE,
        source="hf:HuggingFaceTB/SmolLM-135M; hf",
        skip_shapes=("long_500k",),
        notes="Pure full attention -> long_500k skipped (DESIGN.md §4).",
    )
)
