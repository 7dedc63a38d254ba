"""Entry of the flash-attention forward.

A CPU tensor runs :func:`flash_attention_ref`; a CUDA tensor runs a CUDA
kernel in ``src/repro_torch/csrc/flash_attention.cu`` (replacing the Pallas
``repro.kernels.flash_attention.kernel.flash_attention_kernel``) or raises.
The dtype picks the kernel, and neither falls back to the other: bf16 runs
the wgmma route (TMA-fed tiles, bf16 products on the tensor cores, p kept
in f32 as two bf16 terms), f32 the SIMT route (f32 arithmetic throughout).
The layout is the JAX wrapper's, q [B, Sq, Hq, Dh] and k/v [B, Skv, Hkv,
Dh]: the kernels read the three through their strides and write the
output [B, Sq, Hq, Dh] themselves, so no head-major copy is made, and they
mask the ragged S edge, so nothing is padded.  Inputs f32 or bf16 (one
dtype for all three), Dh 64 or 128, each row 16-byte aligned; the output is
in q's dtype.  The kernels have no backward: a call that would need a
gradient raises.  ``launches`` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

NAME = "flash_attention"
launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # 0: SIMT route, 1: wgmma
HEAD_DIMS = (64, 128)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _I, _L, _I, _P)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{NAME}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; expected [B, S, H, Dh] each")
    b, _, hq, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or k.shape[2] == 0 \
            or hq % k.shape[2]:
        raise ValueError(f"{NAME}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)}: batch or Dh differ, or Hq is "
                         f"not a multiple of Hkv")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{NAME}: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                        f"expected one of {list(DTYPES)} for all three")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{NAME}: Dh {dh}; the kernel takes {HEAD_DIMS}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{NAME}: {name} on {t.device}, q on {q.device}")
        if (t.stride(3) != 1 or any(s % vec for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{NAME}: {name} rows must be contiguous in Dh "
                             f"and 16-byte aligned (strides {t.stride()})")


def flash_attention(
    q: torch.Tensor,  # [B, Sq, Hq, Dh]
    k: torch.Tensor,  # [B, Skv, Hkv, Dh]
    v: torch.Tensor,  # [B, Skv, Hkv, Dh]
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Causal / windowed GQA attention: [B, Sq, Hq, Dh] in q's dtype."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, window)
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(f"{NAME}: the CUDA kernel has no backward; call "
                           f"it under torch.no_grad() or inference_mode()")
    _check(q, k, v)
    dev = q.device
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, hq, dh), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    launch = build.load_function(NAME, "flash_attention_launch", _ARGTYPES)
    err = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPES[q.dtype], b, sq, skv, hq, hkv, dh,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), int(window is not None),
        0 if window is None else int(window),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(NAME, err)
    launches += 1
    return out
