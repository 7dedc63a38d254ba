"""olmoe-1b-7b [arXiv:2409.02060; hf] — MoE 64e top-8, MHA (kv=16).
(``repro.configs.olmoe_1b_7b``, field for field)."""
from repro_torch.configs.base import (
    ArchSpec, LM_SHAPES, MoEConfig, TransformerConfig, register,
)

FULL = TransformerConfig(
    name="olmoe-1b-7b",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    qk_norm=True,
    moe=MoEConfig(num_experts=64, top_k=8),
    act="swiglu",
)

SMOKE = TransformerConfig(
    name="olmoe-1b-7b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=64,
    vocab_size=512,
    qk_norm=True,
    moe=MoEConfig(num_experts=8, top_k=2),
    act="swiglu",
    dtype="float32",
    param_dtype="float32",
)

register(
    ArchSpec(
        arch_id="olmoe-1b-7b",
        family="lm",
        config=FULL,
        shapes=LM_SHAPES,
        smoke_config=SMOKE,
        source="arXiv:2409.02060; hf",
        skip_shapes=("long_500k",),
        notes="Pure full attention -> long_500k skipped (DESIGN.md §4).",
    )
)
