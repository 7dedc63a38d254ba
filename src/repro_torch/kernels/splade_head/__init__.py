from repro_torch.kernels.splade_head.ops import splade_head
from repro_torch.kernels.splade_head.ref import splade_head_ref

__all__ = ["splade_head", "splade_head_ref"]
