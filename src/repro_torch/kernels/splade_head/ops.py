"""Entry of the fused SPLADE-max encoding head.

A CPU tensor runs :func:`splade_head_ref`; a CUDA tensor runs the CUDA
kernel in ``src/repro_torch/csrc/splade_head.cu`` (replacing the Pallas
``repro.kernels.splade_head.kernel.splade_head_kernel``) or raises.  The
kernel runs the product on the tensor cores in 3xTF32 (f32 accuracy) over
the token rows of nonzero mask only, masks the ragged vocabulary edge
itself, so nothing is padded, and reads ``w`` through its strides: the
tied head ``embed.T`` is passed as the [d, V] view it is, with no copy.  The kernel
has no backward: a call that would need a gradient raises.  ``launches``
counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.splade_head.ref import splade_head_ref

NAME = "splade_head"
launches = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _I, _P)


def splade_head(
    h: torch.Tensor,  # f32 [B, T, d]
    mask: torch.Tensor,  # f32 [B, T]
    w: torch.Tensor,  # f32 [d, V], any strides
    b: torch.Tensor,  # f32 [V]
) -> torch.Tensor:
    """SPLADE-max over tokens of log1p(relu(h @ w + b)) * mask: f32 [B, V]."""
    global launches
    if h.device.type == "cpu":
        return splade_head_ref(h, mask, w, b)
    if h.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {h.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (h, mask, w, b)):
        raise RuntimeError(f"{NAME}: the CUDA kernel has no backward; call "
                           f"it under torch.no_grad() or inference_mode()")
    dev = h.device
    bsz, t, d = h.shape
    if t == 0:
        raise ValueError(f"{NAME}: no tokens to pool over (T = 0)")
    v = w.shape[1]
    build.expect(h, "h", torch.float32, device=dev)
    build.expect(mask, "mask", torch.float32, (bsz, t), dev)
    build.expect(b, "b", torch.float32, (v,), dev)
    if w.dtype != torch.float32 or tuple(w.shape) != (d, v) or w.device != dev:
        raise ValueError(f"{NAME}: w is {w.dtype} {tuple(w.shape)} on "
                         f"{w.device}, expected float32 ({d}, {v}) on {dev}")
    out = torch.empty((bsz, v), dtype=torch.float32, device=dev)
    if bsz == 0 or v == 0:
        return out
    launch = build.load_function(NAME, "splade_head_launch", _ARGTYPES)
    err = launch(
        h.data_ptr(), mask.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), bsz, t, d, v, w.stride(0), w.stride(1),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(NAME, err)
    launches += 1
    return out
