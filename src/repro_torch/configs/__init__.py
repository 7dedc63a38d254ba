"""Model configurations of the port (copies of :mod:`repro.configs`) and
the architecture registry."""
from repro_torch.configs.base import (
    ArchSpec,
    MoEConfig,
    RecsysConfig,
    RetrievalArchConfig,
    SchNetConfig,
    ShapeSpec,
    TransformerConfig,
    get_arch,
    list_archs,
    register,
)

__all__ = [
    "ArchSpec",
    "MoEConfig",
    "RecsysConfig",
    "RetrievalArchConfig",
    "SchNetConfig",
    "ShapeSpec",
    "TransformerConfig",
    "get_arch",
    "list_archs",
    "register",
]
