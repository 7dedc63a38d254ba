"""Fixture: a launch whose code nobody checks and nobody counts, and an
entry point that defaults to the CPU.  device-contract must catch the
unbound launch (C4), the count that matches no launch (C4) and the
device="cpu" default (C6)."""
import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.uncounted.ref import uncounted_ref

NAME = "uncounted"
launches = 0


def uncounted(x, device="cpu"):
    global launches
    if x.device.type == "cpu":
        return uncounted_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {x.device}")
    build.expect(x, "x", torch.float32, device=x.device)
    out = torch.empty_like(x)
    launch = build.load_function(NAME, "uncounted_launch",
                                 (ctypes.c_void_p, ctypes.c_void_p))
    launch(x.data_ptr(), out.data_ptr())
    return out


def warm_up(x):
    global launches
    launches += 1  # counts a launch that never happened
    return x
