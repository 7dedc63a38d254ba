"""Entry of the term-parallel scatter-add scoring kernel.

A CPU tensor runs :func:`scatter_score_ref`; a CUDA tensor runs the CUDA
kernel in ``src/repro_torch/csrc/scatter_score.cu`` (replacing the Pallas
``repro.kernels.scatter_score.kernel.scatter_score_kernel``) or raises.
The entry packs the query weights by tiles of 128 queries first
(:func:`repro_torch.kernels.query_tiles.pack_query_tiles`: torch ops on the
card, one host sync to size the entries) and finds each warp's slots of
each chunk (:func:`chunk_doc_bounds`, torch ops on the card).
``launches`` counts kernel launches, and nothing else.

Two routes by dtype: f32 ``qw`` and ``value`` give f32 scores; bf16 ones
give bf16 scores, each the f32 sum of the exact products of the bf16
inputs, in the f32 route's order, rounded once
(``scatter_score_bf16_launch``; the plain version keeps the same
contract).  Mixed dtypes raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.query_tiles import pack_query_tiles
from repro_torch.kernels.scatter_score.ref import scatter_score_ref

NAME = "scatter_score"
WARPS = 32  # csrc/scatter_score.cu's kWarps: warp w owns a doc block's
            # docs [w * ceil(D / 32), (w + 1) * ceil(D / 32))
launches = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
             _I, _I, _I, _I, _I, _I, _I, _L, _I, _P)


# Slots chunk_doc_bounds searches at once: bounds its copy of local_doc
# (the keys, padding made doc_block) to 2^26 slots whatever the index.
_BOUNDS_ELEMS = 1 << 26


def chunk_doc_bounds(local_doc: torch.Tensor, doc_block: int) -> torch.Tensor:
    """int32 [num_chunks, WARPS + 1]: ``bounds[c, w]`` is the first live
    slot of chunk ``c`` whose doc is at least ``min(w * ceil(doc_block /
    WARPS), doc_block)``, so warp ``w``'s slots are ``[bounds[c, w],
    bounds[c, w + 1])`` and ``bounds[c, WARPS]`` is the chunk's live count
    (its live slots are a prefix in ascending doc order).  A range of
    chunks at a time (``_BOUNDS_ELEMS``), each searched into the output."""
    per = -(-doc_block // WARPS)
    n_chunks, c = local_doc.shape
    edges = (torch.arange(WARPS + 1, device=local_doc.device) * per).clamp(
        max=doc_block).to(local_doc.dtype)
    step = max(1, _BOUNDS_ELEMS // max(c, 1))
    out = torch.empty((n_chunks, WARPS + 1), dtype=torch.int32,
                      device=local_doc.device)
    for s in range(0, n_chunks, step):
        ld = local_doc.narrow(0, s, min(step, n_chunks - s))
        keys = torch.where(ld >= 0, ld, doc_block)
        torch.searchsorted(keys, edges.expand(ld.shape[0], -1).contiguous(),
                           out_int32=True, out=out.narrow(0, s, ld.shape[0]))
    return out


def scatter_score(
    qw: torch.Tensor,  # f32 or bf16 [B, V_pad]
    local_term: torch.Tensor,  # int32 [num_chunks, C]
    local_doc: torch.Tensor,  # int32 [num_chunks, C]
    value: torch.Tensor,  # qw's dtype [num_chunks, C]
    chunk_term_block: torch.Tensor,  # int32 [num_chunks]
    chunk_doc_block: torch.Tensor,  # int32 [num_chunks]
    block_chunk_start: torch.Tensor,  # int32 [num_doc_blocks]
    block_chunk_count: torch.Tensor,  # int32 [num_doc_blocks]
    *,
    term_block: int,
    doc_block: int,
    num_doc_blocks: int,
) -> torch.Tensor:
    """Exact [B, num_doc_blocks * doc_block] scores, in ``qw``'s dtype, of
    the chunks in the runs ``block_chunk_start/count`` of a TiledIndex (0
    in blocks whose runs are empty)."""
    global launches
    dtype = build.score_dtype(NAME, qw, value)
    if qw.device.type == "cpu":
        return scatter_score_ref(
            qw, local_term, local_doc, value, chunk_term_block,
            chunk_doc_block, block_chunk_start, block_chunk_count,
            term_block=term_block, doc_block=doc_block,
            num_doc_blocks=num_doc_blocks,
        )
    if qw.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {qw.device}")
    dev = qw.device
    b, v_pad = qw.shape
    n_chunks, c = local_term.shape
    if v_pad % term_block or v_pad < term_block:
        raise ValueError(f"{NAME}: qw width {v_pad} is not a multiple of "
                         f"term_block {term_block}")
    i32 = torch.int32
    build.expect(qw, "qw", dtype, device=dev)
    for t, what in ((local_term, "local_term"), (local_doc, "local_doc")):
        build.expect(t, what, i32, (n_chunks, c), dev)
    build.expect(value, "value", dtype, (n_chunks, c), dev)
    build.expect(chunk_term_block, "chunk_term_block", i32, (n_chunks,), dev)
    for t, what in ((block_chunk_start, "block_chunk_start"),
                    (block_chunk_count, "block_chunk_count")):
        build.expect(t, what, i32, (num_doc_blocks,), dev)

    n_pad = num_doc_blocks * doc_block
    out = torch.empty((b, n_pad), dtype=dtype, device=dev)
    if b == 0 or num_doc_blocks == 0:
        return out
    records, entries, cw, dense = pack_query_tiles(qw)
    doc_bounds = chunk_doc_bounds(local_doc, doc_block)
    entry = ("scatter_score_launch" if dtype == torch.float32
             else "scatter_score_bf16_launch")
    launch = build.load_function(NAME, entry, _ARGTYPES)
    err = launch(
        records.data_ptr(), entries.data_ptr(), cw.data_ptr(),
        dense.data_ptr(), local_term.data_ptr(), local_doc.data_ptr(),
        value.data_ptr(), chunk_term_block.data_ptr(), doc_bounds.data_ptr(),
        block_chunk_start.data_ptr(), block_chunk_count.data_ptr(),
        out.data_ptr(), b, dense.numel(),
        v_pad, num_doc_blocks, term_block, doc_block, c, n_pad, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(NAME, err)
    launches += 1
    return out
