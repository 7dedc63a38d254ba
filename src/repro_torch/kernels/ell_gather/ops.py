"""Entry of the doc-parallel ELL gather scoring kernel.

A CPU tensor runs :func:`ell_gather_ref`; a CUDA tensor runs the CUDA
kernel in ``src/repro_torch/csrc/ell_gather.cu`` (replacing the Pallas
``repro.kernels.ell_gather.kernel.ell_gather_kernel``) or raises.  The
kernel masks the ragged edges of the doc and slot axes itself, so the TPU
wrapper's halving of ``doc_block``/``k_chunk`` until they divide has no
counterpart.  ``launches`` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.ell_gather.ref import ell_gather_ref

NAME = "ell_gather"
QUERY_TILE = 64  # queries per CTA; csrc/ell_gather.cu's kQueryTile
launches = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _L, _I, _I, _P)


def ell_gather(
    qw: torch.Tensor,  # f32 [B, V]
    terms: torch.Tensor,  # int32 [N_pad, K], vocab_size at padding
    values: torch.Tensor,  # f32 [N_pad, K]
) -> torch.Tensor:
    """Exact f32 [B, N_pad] scores of an EllIndex."""
    global launches
    if qw.device.type == "cpu":
        return ell_gather_ref(qw, terms, values)
    if qw.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {qw.device}")
    dev = qw.device
    b, v = qw.shape
    n_pad, k = terms.shape
    build.expect(qw, "qw", torch.float32, device=dev)
    build.expect(terms, "terms", torch.int32, device=dev)
    build.expect(values, "values", torch.float32, (n_pad, k), dev)

    out = torch.empty((b, n_pad), dtype=torch.float32, device=dev)
    if b == 0 or n_pad == 0:
        return out
    b_pad = -(-b // QUERY_TILE) * QUERY_TILE
    qwt = F.pad(qw, (0, 0, 0, b_pad - b)).t().contiguous()  # [V, b_pad]
    launch = build.load_function(NAME, "ell_gather_launch", _ARGTYPES)
    err = launch(
        qwt.data_ptr(), terms.data_ptr(), values.data_ptr(), out.data_ptr(),
        b, b_pad, v, n_pad, k,
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(NAME, err)
    launches += 1
    return out
