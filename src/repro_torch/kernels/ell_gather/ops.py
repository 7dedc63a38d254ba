"""Entry of the doc-parallel ELL gather scoring kernel.

A CPU tensor runs :func:`ell_gather_ref`; a CUDA tensor runs the CUDA
kernel in ``src/repro_torch/csrc/ell_gather.cu`` (replacing the Pallas
``repro.kernels.ell_gather.kernel.ell_gather_kernel``) or raises.  The
kernel masks the ragged edges of the doc and slot axes itself, so the TPU
wrapper's halving of ``doc_block``/``k_chunk`` until they divide has no
counterpart.  The entry packs the query weights by tiles of 128 queries
first (:func:`repro_torch.kernels.query_tiles.pack_query_tiles`: torch ops
on the card, one host sync to size the entries).  ``launches`` counts
kernel launches, and nothing else.

Two routes by dtype: f32 ``qw`` and ``values`` give f32 scores; bf16 ones
give bf16 scores, each the f32 sum of the exact products of the bf16
inputs rounded once (``ell_gather_bf16_launch``; the plain version keeps
the same contract).  Mixed dtypes raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ell_gather.ref import ell_gather_ref
from repro_torch.kernels.query_tiles import pack_query_tiles

NAME = "ell_gather"
launches = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _I, _I, _P)


def ell_gather(
    qw: torch.Tensor,  # f32 or bf16 [B, V]
    terms: torch.Tensor,  # int32 [N_pad, K], vocab_size at padding
    values: torch.Tensor,  # qw's dtype [N_pad, K]
) -> torch.Tensor:
    """Exact [B, N_pad] scores of an EllIndex, in ``qw``'s dtype."""
    global launches
    dtype = build.score_dtype(NAME, qw, values)
    if qw.device.type == "cpu":
        return ell_gather_ref(qw, terms, values)
    if qw.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {qw.device}")
    dev = qw.device
    b, v = qw.shape
    n_pad, k = terms.shape
    build.expect(qw, "qw", dtype, device=dev)
    build.expect(terms, "terms", torch.int32, device=dev)
    build.expect(values, "values", dtype, (n_pad, k), dev)

    out = torch.empty((b, n_pad), dtype=dtype, device=dev)
    if b == 0 or n_pad == 0:
        return out
    records, entries, cw, dense = pack_query_tiles(qw)
    entry = ("ell_gather_launch" if dtype == torch.float32
             else "ell_gather_bf16_launch")
    launch = build.load_function(NAME, entry, _ARGTYPES)
    err = launch(
        records.data_ptr(), entries.data_ptr(), cw.data_ptr(),
        dense.data_ptr(), terms.data_ptr(), values.data_ptr(),
        out.data_ptr(), b, dense.numel(), v, n_pad, k,
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(NAME, err)
    launches += 1
    return out
