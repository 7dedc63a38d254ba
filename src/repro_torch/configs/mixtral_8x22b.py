"""mixtral-8x22b [arXiv:2401.04088; hf] — MoE 8e top-2, GQA kv=8, SWA.

Sliding-window attention (window 4096) makes this the one assigned LM arch
that is sub-quadratic, so it carries the ``long_500k`` cell (ring-buffer KV
cache bounded by the window).  Copied from ``repro.configs.mixtral_8x22b``
field for field.
"""
from repro_torch.configs.base import (
    ArchSpec, LM_SHAPES, MoEConfig, TransformerConfig, register,
)

FULL = TransformerConfig(
    name="mixtral-8x22b",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab_size=32768,
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2),
    act="swiglu",
)

SMOKE = TransformerConfig(
    name="mixtral-8x22b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=512,
    sliding_window=16,
    moe=MoEConfig(num_experts=4, top_k=2),
    act="swiglu",
    dtype="float32",
    param_dtype="float32",
)

register(
    ArchSpec(
        arch_id="mixtral-8x22b",
        family="lm",
        config=FULL,
        shapes=LM_SHAPES,
        smoke_config=SMOKE,
        source="arXiv:2401.04088; hf",
        notes="SWA (4096) -> sub-quadratic; long_500k runs with ring cache.",
    )
)
