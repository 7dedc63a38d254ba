"""Sharding policies as DTensor placements and the collectives of the
sharded paths (``repro.sharding``)."""
from repro_torch.sharding.policies import (
    ShardingPolicy,
    lm_batch_specs,
    lm_param_specs,
    make_policy,
)

__all__ = [
    "ShardingPolicy",
    "lm_param_specs",
    "lm_batch_specs",
    "make_policy",
]
