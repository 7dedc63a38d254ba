from repro_torch.kernels.ell_gather.ops import ell_gather
from repro_torch.kernels.ell_gather.ref import ell_gather_ref

__all__ = ["ell_gather", "ell_gather_ref"]
