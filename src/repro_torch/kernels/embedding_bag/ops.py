"""Entry of the weighted bag lookup-reduce (``EmbeddingBag``, mode sum).

A CPU tensor runs :func:`embedding_bag_ref`; a CUDA tensor runs the CUDA
kernel in ``src/repro_torch/csrc/embedding_bag.cu`` (replacing the Pallas
``repro.kernels.embedding_bag.kernel.embedding_bag_kernel``) or raises.
The signature is the JAX ``ops.embedding_bag``'s without the TPU block
knobs: nothing is padded to a batch or vocabulary block, since the kernel
masks the ragged bag count itself.  An id of -1, or any id outside
[0, V), adds 0, as in the Pallas kernel.  The kernel has no backward: a
call that would need a gradient raises.  ``launches`` counts kernel
launches, and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

NAME = "embedding_bag"
launches = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = (_P, _P, _P, _P, _L, _I, _L, _I, _I, _I, _I, _P)


def _widest(count: int, ptrs, most: int) -> int:
    """The widest of ``most``, ..., 2, 1 that divides ``count`` and every
    pointer's byte address / 4."""
    w = most
    while w > 1 and not (count % w == 0
                         and all(p % (4 * w) == 0 for p in ptrs)):
        w //= 2
    return w


def pick_route(d: int, l: int, table_ptr: int, ids_ptr: int,
               weights_ptr: Optional[int] = None) -> tuple[int, int]:
    """(vec, ivec): the floats a lane loads of a row (4 when D % 4 == 0 and
    the table is 16-byte aligned, 2 when D is even and it is 8-byte
    aligned, else 1; a bag takes D / vec lanes), and the ids (and weights)
    a lane loads at once (2 when L is even and the ids and weights are
    8-byte aligned, else 1; 4 was slower at every measured shape).  A pure
    function of the shape and the pointers; nothing is tried and
    retried."""
    vec = _widest(d, [table_ptr], 4)
    ivec = _widest(l, [ids_ptr] + ([] if weights_ptr is None
                                   else [weights_ptr]), 2)
    return vec, ivec


def embedding_bag(
    ids: torch.Tensor,  # int32 [N, L], -1 = pad
    table: torch.Tensor,  # f32 [V, D], contiguous rows
    weights: Optional[torch.Tensor] = None,  # f32 [N, L]; None = all ones
) -> torch.Tensor:
    """out[n] = sum_l weights[n, l] * table[ids[n, l]]: f32 [N, D]."""
    global launches
    if ids.device.type == "cpu":
        return embedding_bag_ref(ids, weights, table)
    if ids.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {ids.device}")
    if torch.is_grad_enabled() and (table.requires_grad or (
            weights is not None and weights.requires_grad)):
        raise RuntimeError(f"{NAME}: the CUDA kernel has no backward; call "
                           f"it under torch.no_grad() or inference_mode()")
    dev = ids.device
    if ids.dim() != 2 or table.dim() != 2:
        raise ValueError(f"{NAME}: ids {tuple(ids.shape)}, table "
                         f"{tuple(table.shape)}; expected [N, L] and [V, D]")
    n, l = ids.shape
    v, d = table.shape
    build.expect(ids, "ids", torch.int32, device=dev)
    build.expect(table, "table", torch.float32, device=dev)
    if weights is not None:
        build.expect(weights, "weights", torch.float32, (n, l), dev)
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    if n == 0 or d == 0:
        return out
    vec, ivec = pick_route(d, l, table.data_ptr(), ids.data_ptr(),
                           None if weights is None else weights.data_ptr())
    launch = build.load_function(NAME, "embedding_bag_launch", _ARGTYPES)
    err = launch(
        ids.data_ptr(), None if weights is None else weights.data_ptr(),
        table.data_ptr(), out.data_ptr(), n, l, v, d, vec, ivec,
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(NAME, err)
    launches += 1
    return out
