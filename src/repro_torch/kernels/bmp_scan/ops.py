"""Entries of the BMP sweep kernel.

:func:`bmp_sweep` is the low-level entry, the counterpart of the Pallas
``repro.kernels.bmp_scan.kernel.bmp_scan_kernel``: stacked groups ``[G,
b, ...]`` (any ``b``) and their schedules in, each group's whole sweep out.
A CPU tensor runs :func:`bmp_sweep_ref` group by group; a CUDA tensor runs
the CUDA kernel in ``src/repro_torch/csrc/bmp_scan.cu`` — one launch, one
CTA per group — or raises.  ``launches`` counts kernel launches, and
nothing else.

:func:`bmp_scan` is the fused engine's entry (``"tiled-bmp-fused"``,
:func:`repro.kernels.bmp_scan.ops.bmp_scan`): the demand-grouped sweep
with the groups of each power-of-two bucket stacked into one launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.bmp_scan.ref import bmp_sweep_ref

NAME = "bmp_scan"
launches = 0

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGTYPES = (_P,) * 16 + (_I, _I, _I, _L, _I, _I, _I, _I, _I, _I, _F, _L,
                          _I, _P)


def _query_tile(b: int) -> int:
    """Rows a CTA scores at once: 32 (one a lane) for small groups, else
    128 (four a lane); csrc/bmp_scan.cu's two instantiations."""
    return 32 if b <= 32 else 128


def bmp_sweep(
    qw: torch.Tensor,  # f32 [G, b, V_pad]
    order: torch.Tensor,  # int32 [G, b, n_db] descending-bound block order
    ub_sorted: torch.Tensor,  # f32 [G, b, n_db]
    tau0: torch.Tensor,  # f32 [G, b]
    block_chunk_start: torch.Tensor,  # int32 [n_db]
    block_chunk_count: torch.Tensor,  # int32 [n_db]
    chunk_term_block: torch.Tensor,  # int32 [num_chunks]
    chunk_doc_block: torch.Tensor,  # int32 [num_chunks]
    local_term: torch.Tensor,  # int32 [num_chunks, C]
    local_doc: torch.Tensor,  # int32 [num_chunks, C]
    value: torch.Tensor,  # f32 [num_chunks, C]
    alive_doc: Optional[torch.Tensor] = None,  # bool [num_docs]
    *,
    term_block: int,
    doc_block: int,
    k_eff: int,
    theta: float,
    num_docs: int,
):
    """Every group's BMP sweep -> ``(scores [G, b, n_pad] raw, heap [G, b,
    k_eff] descending, block_scored [G, n_db] int32, chunk_scored [G,
    num_chunks] int32, steps [G, 1] int32)``; see :func:`bmp_sweep_ref`
    for what one group's sweep computes.  The kernel's shared memory
    bounds ``doc_block`` to 256 (512 for groups of at most 32 rows) at
    ``chunk_size`` 512; a launch beyond that is refused and raises."""
    global launches
    g, b, v_pad = qw.shape
    n_db = order.shape[-1]
    kw = dict(term_block=term_block, doc_block=doc_block, k_eff=k_eff,
              theta=theta, num_docs=num_docs)
    runs = (block_chunk_start, block_chunk_count, chunk_term_block,
            chunk_doc_block, local_term, local_doc, value)
    if qw.device.type == "cpu":
        outs = [bmp_sweep_ref(qw[i], order[i], ub_sorted[i], tau0[i], *runs,
                              alive_doc, **kw) for i in range(g)]
        scores, heap, bsc, csc, steps = zip(*outs)
        i32 = torch.int32
        return (torch.stack(scores), torch.stack(heap),
                torch.stack(bsc).to(i32), torch.stack(csc).to(i32),
                torch.tensor(steps, dtype=i32).reshape(g, 1))
    if qw.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {qw.device}")
    dev = qw.device
    n_chunks, c = local_term.shape
    if v_pad % term_block or v_pad < term_block:
        raise ValueError(f"{NAME}: qw width {v_pad} is not a multiple of "
                         f"term_block {term_block}")
    if k_eff < 1:
        raise ValueError(f"{NAME}: k_eff must be >= 1, got {k_eff}")
    i32, f32 = torch.int32, torch.float32
    build.expect(qw, "qw", f32, device=dev)
    build.expect(order, "order", i32, (g, b, n_db), dev)
    build.expect(ub_sorted, "ub_sorted", f32, (g, b, n_db), dev)
    build.expect(tau0, "tau0", f32, (g, b), dev)
    for t, what in ((block_chunk_start, "block_chunk_start"),
                    (block_chunk_count, "block_chunk_count")):
        build.expect(t, what, i32, (n_db,), dev)
    build.expect(chunk_term_block, "chunk_term_block", i32, (n_chunks,), dev)
    for t, what in ((local_term, "local_term"), (local_doc, "local_doc")):
        build.expect(t, what, i32, (n_chunks, c), dev)
    build.expect(value, "value", f32, (n_chunks, c), dev)
    if alive_doc is not None:
        build.expect(alive_doc, "alive_doc", torch.bool, (num_docs,), dev)

    n_pad = n_db * doc_block
    scores = torch.zeros((g, b, n_pad), dtype=f32, device=dev)
    heap = torch.full((g, b, k_eff), float("-inf"), dtype=f32, device=dev)
    block_scored = torch.zeros((g, n_db), dtype=i32, device=dev)
    chunk_scored = torch.zeros((g, n_chunks), dtype=i32, device=dev)
    steps = torch.zeros((g, 1), dtype=i32, device=dev)
    if g == 0 or b == 0:
        return scores, heap, block_scored, chunk_scored, steps
    # Term-major, row-padded weights per group: a posting's weights for a
    # tile of rows are one contiguous run.
    tile = _query_tile(b)
    b_pad = -(-b // tile) * tile
    qwt = F.pad(qw, (0, 0, 0, b_pad - b)).transpose(1, 2).contiguous()
    launch = build.load_function(NAME, "bmp_scan_launch", _ARGTYPES)
    err = launch(
        qwt.data_ptr(), order.data_ptr(), ub_sorted.data_ptr(),
        tau0.data_ptr(), block_chunk_start.data_ptr(),
        block_chunk_count.data_ptr(), chunk_term_block.data_ptr(),
        local_term.data_ptr(), local_doc.data_ptr(), value.data_ptr(),
        None if alive_doc is None else alive_doc.data_ptr(),
        scores.data_ptr(), heap.data_ptr(), block_scored.data_ptr(),
        chunk_scored.data_ptr(), steps.data_ptr(),
        g, b, b_pad, v_pad, n_db, n_chunks, term_block, doc_block, c,
        k_eff, float(theta), num_docs,
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(NAME, err)
    launches += 1
    return scores, heap, block_scored, chunk_scored, steps


def bmp_scan(queries, index, k: int, groups=None, theta: float = 1.0,
             tau_init=None, return_stats: bool = False,
             return_tau: bool = False, top_m: int = 8,
             max_group: Optional[int] = None, min_share: float = 0.5,
             plan_cache=None, deleted_mask=None):
    """Fused demand-grouped BMP traversal: [B, N] scores, unvisited docs
    ``-inf``, ``out[, stats][, tau]`` — the semantics of
    ``score_tiled_bmp_grouped`` (any partition is exact, chunk work never
    exceeds the flat sweep's), with the groups of each power-of-two bucket
    (``planner.bucketed_group_rows``) stacked into one :func:`bmp_sweep`.

    The kernel keeps each group's heap and scores in device memory and
    takes the alive mask, so every bucket is a kernel launch, whatever its
    row count and under deletions too: ``SchedStats.kernel_launches`` is
    the number of buckets.  The JAX entry instead sends buckets above 128
    rows (its ``max_kernel_rows``) and every deletion-bearing call through
    its per-group oracle and counts one launch per group there; this is
    the one place where the two packages' stats differ.
    """
    from repro_torch.core import scoring

    return scoring.grouped_sweeps(
        queries, index, k, stacked=True, groups=groups, theta=theta,
        tau_init=tau_init, return_stats=return_stats, return_tau=return_tau,
        top_m=top_m, max_group=max_group, min_share=min_share,
        plan_cache=plan_cache, deleted_mask=deleted_mask,
    )
