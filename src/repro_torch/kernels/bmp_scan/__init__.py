from repro_torch.kernels.bmp_scan.ops import bmp_scan, bmp_sweep
from repro_torch.kernels.bmp_scan.ref import bmp_scan_ref, bmp_sweep_ref

__all__ = ["bmp_scan", "bmp_sweep", "bmp_scan_ref", "bmp_sweep_ref"]
