"""schnet [arXiv:1706.08566; paper] — continuous-filter conv GNN
(``repro.configs.schnet``)."""
from repro_torch.configs.base import ArchSpec, GNN_SHAPES, SchNetConfig, register

FULL = SchNetConfig(
    name="schnet",
    n_interactions=3,
    d_hidden=64,
    n_rbf=300,
    cutoff=10.0,
    d_in=0,  # per-shape: full_graph_sm uses d_feat=1433 etc.
)

SMOKE = SchNetConfig(
    name="schnet-smoke",
    n_interactions=2,
    d_hidden=32,
    n_rbf=24,
    cutoff=10.0,
    d_in=16,
)

register(
    ArchSpec(
        arch_id="schnet",
        family="gnn",
        config=FULL,
        shapes=GNN_SHAPES,
        smoke_config=SMOKE,
        source="arXiv:1706.08566; paper",
        notes=(
            "Message passing = gather -> RBF filter -> segment_sum; "
            "non-molecular graphs get synthetic distances (DESIGN.md §4)."
        ),
    )
)
