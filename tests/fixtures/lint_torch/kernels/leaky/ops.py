"""Fixture: a parameter whose pointer reaches C unchecked.  kernel-memory's
static half must flag ``index`` (the int32 ids the kernel trusts) and pass
``qw`` (checked) and ``out`` (allocated in the entry)."""
import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.leaky.ref import leaky_ref

NAME = "leaky"
launches = 0


def leaky(qw, index):
    global launches
    if qw.device.type == "cpu":
        return leaky_ref(qw, index)
    if qw.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {qw.device}")
    build.expect(qw, "qw", torch.float32, device=qw.device)
    out = torch.empty_like(qw)
    launch = build.load_function(NAME, "leaky_launch",
                                 (ctypes.c_void_p,) * 3)
    err = launch(qw.data_ptr(), index.data_ptr(), out.data_ptr())
    build.check(NAME, err)
    launches += 1
    return out
