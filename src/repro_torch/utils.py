"""Small shared utilities."""
from __future__ import annotations

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def ceil_to(x: int, m: int) -> int:
    """Round ``x`` up to the nearest multiple of ``m``."""
    return cdiv(x, m) * m


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.

    ``"cuda"`` (every entry point's default) raises when no card is
    present: the port never drops to the CPU on its own.  Callers that want
    the plain PyTorch path ask for ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
