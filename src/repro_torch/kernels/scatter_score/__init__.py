from repro_torch.kernels.scatter_score.ops import scatter_score
from repro_torch.kernels.scatter_score.ref import scatter_score_ref

__all__ = ["scatter_score", "scatter_score_ref"]
