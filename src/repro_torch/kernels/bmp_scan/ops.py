"""Entries of the BMP sweep kernel.

:func:`bmp_sweep` is the low-level entry, the counterpart of the Pallas
``repro.kernels.bmp_scan.kernel.bmp_scan_kernel``: stacked groups ``[G,
b, ...]`` (any ``b``) and their schedules in, each group's whole sweep out.
A CPU tensor runs :func:`bmp_sweep_ref` group by group; a CUDA tensor runs
the CUDA kernel in ``src/repro_torch/csrc/bmp_scan.cu`` — one launch — or
raises.  ``launches`` counts kernel launches, and nothing else.

The kernel has two routes, picked by :func:`pick_route` from the launch's
shape alone: groups of at most ``SMALL_MAX_ROWS`` rows run the small route
(``PIPE_WARPS`` workers a CTA, each scoring a step ahead of its retire
test; lanes over a chunk's postings, the group's nonzero query
weights packed by :func:`pack_small_weights` into shared memory); larger
groups, and small ones whose chunk geometry the small route cannot take,
run the wide route (1,024 threads, lanes over rows, term-major weights).  A launch of fewer groups than the card has SMs splits each
group over a thread-block cluster.  ``last_route`` holds the last launch's
route, with the cluster size the card accepted.  bf16 weights and values
take the bf16 route of either (:mod:`~repro_torch.kernels.bmp_scan.ref`:
the values and weights read as bf16, each complete window rounded once,
the retire test's wider margin); the scores and heaps stay f32.

:func:`bmp_scan` is the fused engine's entry (``"tiled-bmp-fused"``,
:func:`repro.kernels.bmp_scan.ops.bmp_scan`): the demand-grouped sweep
with the groups of each power-of-two bucket stacked into one launch.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.bmp_scan.ref import MARGIN_REL, bmp_sweep_ref

NAME = "bmp_scan"
launches = 0
last_route = None

SMALL_MAX_ROWS = 8  # the small route's cut-off: rows a lane carries
SMALL_MAX_CHUNK = 512  # and the chunk_size it takes (four 128-slot loads)
MAX_CLUSTER = 16  # non-portable on the H100 (portable: 8)
WIDE_MAX_CLUSTER = 8  # 1,024-thread CTAs, one an SM: a portable cluster
MAX_SMEM = 232_448  # bytes of shared memory a CTA may have (227 KB)
SMALL_SMEM_TARGET = 100 * 1024  # weights go to shared memory up to this
# Constants of csrc/bmp_scan.cu that the shared-memory sizes below mirror
# (its launcher refuses a size that differs from its own layout's).
_SCAN_ITERS = SMALL_MAX_CHUNK // 128  # 128-slot loads a chunk
PIPE_WARPS = 3  # small route: workers (warps) a CTA, each a step ahead
_PIPE_STAGES, _PIPE_STATE = 2, 20  # a worker's ring depth; state words
_WIDE_WARPS, _WIDE_STAGES = 32, 4

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGTYPES = ((_I, _I, _I, _L, _P, _I) + (_P,) * 20
             + (_I, _I, _I, _L, _I, _I, _I, _I, _I, _I, _F, _F, _L)
             + (_I, _I, _I, _I, _I) + (_P, _I) + (_I, _P))


class Route(NamedTuple):
    """How one ``bmp_sweep`` launch runs: ``name`` "small" (lanes over
    postings) or "wide" (lanes over rows); ``tile`` the rows a lane's
    registers carry at once (small: ``b`` rounded up to a power of two;
    wide: the query tile, 32 or 128); ``cluster`` the CTAs a group is
    split over (1: none); ``threads`` a CTA; ``smem`` bytes a CTA;
    ``weights_in_smem`` whether the small route's packed weights are staged
    in shared memory (else read from device memory)."""

    name: str
    tile: int
    cluster: int
    threads: int
    smem: int
    weights_in_smem: bool


def _pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def _round4(x: int) -> int:
    return (x + 3) & ~3


def _cluster(groups: int, sm_count: int, cap: int) -> int:
    """CTAs a group: 1 when the groups alone fill the SMs, else the largest
    power of two with groups x cluster <= SMs, between 2 and ``cap``."""
    if groups >= sm_count:
        return 1
    c = 1 << max((sm_count // max(groups, 1)).bit_length() - 1, 0)
    return max(2, min(cap, c))


def small_smem_words(tile: int, doc_block: int, chunk_size: int, v_pad: int,
                     term_block: int, max_run: int, weight_words: int) -> int:
    """4-byte words of the small route's shared memory (csrc/bmp_scan.cu
    ``PipeLayout``): the nonzero-term bitmap and its rank, the term-block
    mask, the packed weights and the group's state, then for each of
    ``PIPE_WARPS`` workers its chunk ring (also its heap-merge scratch),
    window, scan mask, carries, chunk list, candidates and mbarriers."""
    n_words = -(-v_pad // 32)
    shared = (2 * _round4(n_words) + _round4(v_pad // term_block)
              + _round4(weight_words) + _round4(_PIPE_STATE))
    per_warp = sum(_round4(x) for x in (
        max(_PIPE_STAGES * 3 * chunk_size, 2 * _pow2(doc_block)),
        doc_block * tile, 4 * _SCAN_ITERS + 1, 32 * tile + 32, 2 * max_run,
        SMALL_MAX_ROWS, 2 * (_PIPE_STAGES + 1)))
    return shared + PIPE_WARPS * per_warp


def wide_smem_words(tile: int, doc_block: int, chunk_size: int, b: int,
                    n_tb: int) -> int:
    """4-byte words of the wide route's shared memory (``WideLayout``):
    the [doc_block, tile + 1] window or the per-warp heap-merge buffers,
    the carries, the cp.async ring, the term-block mask and 8 b + 3 row
    and step words."""
    region = max(doc_block * (tile + 1), _WIDE_WARPS * 2 * _pow2(doc_block))
    return (region + _WIDE_WARPS * tile + _WIDE_WARPS
            + _WIDE_STAGES * 3 * chunk_size + 2 * _WIDE_STAGES + n_tb
            + 8 * b + 3)


def pick_route(groups: int, b: int, sm_count: int, doc_block: int,
               chunk_size: int, *, v_pad: int, term_block: int,
               nz_cap: int = 0, max_run: int = 1,
               elem_bytes: int = 4) -> Route:
    """The route and cluster size of a launch of ``groups`` groups of
    ``b`` rows: a pure function of the shapes (``nz_cap``: the most
    nonzero-weight terms of any group; ``max_run``: the longest block
    chunk run; ``elem_bytes``: 4 for f32 values and weights, 2 for bf16).
    Groups of at most ``SMALL_MAX_ROWS`` rows take the small route where it
    fits: a chunk_size that is a multiple of 4 and at most
    ``SMALL_MAX_CHUNK`` (it reads a chunk in 16-byte pieces, 128 slots a
    load) whose values fill whole 16-byte pieces too (bf16: a multiple of
    8), and its shared memory within ``MAX_SMEM``; else the wide route
    (bf16: an even chunk_size, its values copied 4 bytes at a time).
    Raises ``ValueError`` where no route fits; no route falls back to the
    plain version."""
    if (b <= SMALL_MAX_ROWS and chunk_size % 4 == 0
            and chunk_size * elem_bytes % 16 == 0
            and chunk_size <= SMALL_MAX_CHUNK):
        tile = _pow2(b)
        sizes = (tile, doc_block, chunk_size, v_pad, term_block, max_run)
        with_w = small_smem_words(*sizes,
                                  -(-max(nz_cap, 1) * tile * elem_bytes // 4))
        in_smem = 4 * with_w <= SMALL_SMEM_TARGET
        smem = 4 * (with_w if in_smem else small_smem_words(*sizes, 0))
        if smem <= MAX_SMEM:
            return Route("small", tile,
                         _cluster(groups, sm_count, MAX_CLUSTER),
                         32 * PIPE_WARPS, smem, in_smem)
    if chunk_size * elem_bytes % 4:
        raise ValueError(f"{NAME}: chunk_size {chunk_size} of {elem_bytes}-"
                         "byte values is no whole number of 4-byte words")
    tile = 32 if b <= 32 else 128
    smem = 4 * wide_smem_words(tile, doc_block, chunk_size, b,
                               v_pad // term_block)
    if smem > MAX_SMEM:
        raise ValueError(
            f"{NAME}: the wide route needs {smem} B of shared memory for "
            f"b={b}, doc_block={doc_block}, chunk_size={chunk_size}, over "
            f"the {MAX_SMEM} B a CTA may have (and the small route cannot "
            f"take it)")
    return Route("wide", tile, _cluster(groups, sm_count, WIDE_MAX_CLUSTER),
                 32 * _WIDE_WARPS, smem, False)


def nonzero_terms(qw: torch.Tensor) -> torch.Tensor:
    """bool [G, V_pad]: term t has a nonzero weight in some row of group g
    (a posting of any other term adds exactly 0 to every row's score)."""
    return (qw != 0).any(dim=1)


def term_block_mask(nz: torch.Tensor, term_block: int) -> torch.Tensor:
    """int32 [G, V_pad / term_block]: 1 where the term block holds a term
    of nonzero weight (a chunk of any other term block changes no score)."""
    g, v_pad = nz.shape
    return nz.view(g, v_pad // term_block, term_block).any(-1).to(
        torch.int32)


def launch_sizes(nz: torch.Tensor,
                 block_chunk_count: torch.Tensor) -> tuple[int, int]:
    """``(nz_cap, max_run)`` of a launch, each at least 1: the most terms of
    nonzero weight in any group (``nz`` from :func:`nonzero_terms`) and the
    longest block chunk run.  Both size the launch's shared memory, so both
    are read on the host here, in one transfer."""
    counts = [nz.sum(-1).max()]
    if block_chunk_count.numel():
        counts.append(block_chunk_count.max().to(nz.device, torch.int64))
    sizes = torch.stack(counts).tolist() + [1]  # lint: disable=host-sync -- the launch's shared memory is sized from these counts on the host
    return max(sizes[0], 1), max(sizes[1], 1)


def pack_small_weights(qw: torch.Tensor, tile: int, nz_cap: int):
    """The small route's compact weights of each group -> ``(bits [G, W]
    int32, rank [G, W] int32, weights [G, nz_cap, tile] in qw's dtype)``, W =
    ceil(V_pad / 32): bit t % 32 of word t // 32 is set iff term t has a
    nonzero weight in some row; ``rank`` counts the set bits of the words
    before; ``weights[g, rank(t) + popcount of the bits below t in its
    word, r] = qw[g, r, t]`` (rows b .. tile-1 are 0).  ``nz_cap`` is the
    most nonzero-weight terms of any group (:func:`launch_sizes`)."""
    g, b, v_pad = qw.shape
    nz = nonzero_terms(qw)
    n_words = -(-v_pad // 32)
    bit = F.pad(nz, (0, 32 * n_words - v_pad)).view(g, n_words, 32)
    words = (bit.to(torch.int64)
             << torch.arange(32, device=qw.device)).sum(-1)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    counts = bit.sum(-1)
    rank = torch.cumsum(counts, -1) - counts
    weights = torch.zeros((g, nz_cap, tile), dtype=qw.dtype,
                          device=qw.device)
    gi, ti = nz.nonzero(as_tuple=True)  # group-major, then term order  # lint: disable=host-sync -- the nonzero weights' slots, a count only the data gives
    slot = (torch.cumsum(nz, -1) - 1)[gi, ti]
    weights[gi, slot, :b] = qw.transpose(1, 2)[gi, ti]
    return words.to(torch.int32), rank.to(torch.int32), weights


def bmp_sweep(
    qw: torch.Tensor,  # f32 or bf16 [G, b, V_pad]
    order: torch.Tensor,  # int32 [G, b, n_db] descending-bound block order
    ub_sorted: torch.Tensor,  # f32 [G, b, n_db]
    tau0: torch.Tensor,  # f32 [G, b]
    block_chunk_start: torch.Tensor,  # int32 [n_db]
    block_chunk_count: torch.Tensor,  # int32 [n_db]
    chunk_term_block: torch.Tensor,  # int32 [num_chunks]
    chunk_doc_block: torch.Tensor,  # int32 [num_chunks]
    local_term: torch.Tensor,  # int32 [num_chunks, C]
    local_doc: torch.Tensor,  # int32 [num_chunks, C]
    value: torch.Tensor,  # qw's dtype [num_chunks, C]
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
    for what one group's sweep computes.  :func:`pick_route` chooses how
    the card runs it and raises where no route fits in shared memory."""
    global launches, last_route
    dtype = build.score_dtype(NAME, qw, value)
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
    build.expect(qw, "qw", dtype, device=dev)
    build.expect(order, "order", i32, (g, b, n_db), dev)
    build.expect(ub_sorted, "ub_sorted", f32, (g, b, n_db), dev)
    build.expect(tau0, "tau0", f32, (g, b), dev)
    for t, what in ((block_chunk_start, "block_chunk_start"),
                    (block_chunk_count, "block_chunk_count")):
        build.expect(t, what, i32, (n_db,), dev)
    build.expect(chunk_term_block, "chunk_term_block", i32, (n_chunks,), dev)
    for t, what in ((local_term, "local_term"), (local_doc, "local_doc")):
        build.expect(t, what, i32, (n_chunks, c), dev)
    build.expect(value, "value", dtype, (n_chunks, c), dev)
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
    nz = nonzero_terms(qw)
    tb_nz = term_block_mask(nz, term_block)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    nz_cap, max_run = launch_sizes(nz, block_chunk_count)
    route = pick_route(g, b, sm_count, doc_block, c, v_pad=v_pad,
                       term_block=term_block, nz_cap=nz_cap, max_run=max_run,
                       elem_bytes=qw.element_size())
    qwt = bits = rank = weights = spec = None
    b_pad, workers = b, 0
    if route.name == "small":
        bits, rank, weights = pack_small_weights(qw, route.tile, nz_cap)
        # Each worker's windows of the blocks it scores ahead of their step.
        workers = route.cluster * PIPE_WARPS
        spec = torch.empty((g, workers, route.tile,
                            doc_block * route.tile), dtype=f32, device=dev)
    else:
        # Term-major, row-padded weights per group: a posting's weights for
        # a tile of rows are one contiguous run.
        b_pad = -(-b // route.tile) * route.tile
        qwt = F.pad(qw, (0, 0, 0, b_pad - b)).transpose(1, 2).contiguous()

    def ptr(t):
        return None if t is None else t.data_ptr()

    used = ctypes.c_int(0)
    launch = build.load_function(NAME, "bmp_scan_launch", _ARGTYPES)
    err = launch(
        0 if route.name == "small" else 1, route.tile, route.cluster,
        route.smem, ctypes.addressof(used), dtype == torch.bfloat16,
        ptr(qwt), ptr(bits), ptr(rank), ptr(weights), tb_nz.data_ptr(),
        order.data_ptr(), ub_sorted.data_ptr(), tau0.data_ptr(),
        block_chunk_start.data_ptr(), block_chunk_count.data_ptr(),
        chunk_term_block.data_ptr(), local_term.data_ptr(),
        local_doc.data_ptr(), value.data_ptr(), ptr(alive_doc),
        scores.data_ptr(), heap.data_ptr(), block_scored.data_ptr(),
        chunk_scored.data_ptr(), steps.data_ptr(),
        g, b, b_pad, v_pad, n_db, n_chunks, term_block, doc_block, c,
        k_eff, theta, MARGIN_REL[dtype], num_docs,
        -(-v_pad // 32), 0 if weights is None else weights.shape[1],
        route.weights_in_smem,
        v_pad // term_block, max_run, ptr(spec), workers,
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(NAME, err)
    launches += 1
    last_route = route._replace(cluster=used.value)
    return scores, heap, block_scored, chunk_scored, steps


def bmp_scan(queries, index, k: int, groups=None, theta: float = 1.0,
             tau_init=None, return_stats: bool = False,
             return_tau: bool = False, top_m: int = 8,
             max_group: Optional[int] = None, min_share: float = 0.5,
             plan_cache=None, deleted_mask=None, obs=None):
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
    the one place where the two packages' stats differ.  ``obs`` traces
    the ``plan``, the ``bucket.assembly`` and one fenced ``kernel`` span a
    launch, and counts ``kernel.launches_total``
    (:func:`repro_torch.core.scoring.grouped_sweeps`).
    """
    from repro_torch.core import scoring

    return scoring.grouped_sweeps(
        queries, index, k, stacked=True, groups=groups, theta=theta,
        tau_init=tau_init, return_stats=return_stats, return_tau=return_tau,
        top_m=top_m, max_group=max_group, min_share=min_share,
        plan_cache=plan_cache, deleted_mask=deleted_mask, obs=obs,
    )
