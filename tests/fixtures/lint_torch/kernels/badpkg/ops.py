"""Fixture: the port's counterpart of the interpret=True bug.

The CUDA branch hides behind the plain version: a refused launch, or a
build that fails on the card, quietly returns the CPU result and every
CPU test stays green.  device-contract must catch the try (C3), the
except handler's *_ref (C3), the missing raise for other devices (C2),
and the interpret parameter (C5).
"""
import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.badpkg.ref import badpkg_ref

NAME = "badpkg"
launches = 0


def badpkg(x, interpret=False):
    global launches
    if x.device.type == "cpu":
        return badpkg_ref(x)
    try:
        build.expect(x, "x", torch.float32, device=x.device)
        launch = build.load_function(NAME, "badpkg_launch",
                                     (ctypes.c_void_p,))
        err = launch(x.data_ptr())
        build.check(NAME, err)
        launches += 1
        return x
    except RuntimeError:
        return badpkg_ref(x)
