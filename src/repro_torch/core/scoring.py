"""Batched scoring engines: ``scores[b, d] = <q_b, doc_d>``.

Exact, the full matrix:

  ``score_dense``      dense matmul, the f32 oracle.
  ``score_dense_f64``  the same in float64, the tie-break-free reference.
  ``score_tiled``      term-parallel scatter-add over a TiledIndex, through
                       the ``scatter_score`` kernel.
  ``score_ell``        doc-parallel gather over an EllIndex, through the
                       ``ell_gather`` kernel.

The paper's comparison points, plain PyTorch by design (each is what the
kernels above are measured against, not a kernel to write):

  ``score_bcoo``       the docs as a sparse CSR matrix times QW^T: one
                       library product (cuSPARSE SpMM on the card), the
                       JAX ``BCOO @ dense``.
  ``score_segment``    SPARe's iterative mode over a FlatIndex: one
                       slice and one ``index_add_`` per query term, in row
                       order (``segment_launches`` counts the adds).

Block-max pruned (docs provably outside the top-k come back ``-inf``), as
in :mod:`repro.core.scoring`:

  ``score_tiled_pruned``  two passes: a seed pass over the highest-bound
                          blocks fixes tau, then every block whose bound can
                          still beat it is scored (``scatter_score`` over
                          the kept blocks' chunk runs).
  ``score_tiled_bmp``     the BMP sweep: blocks visited per query in
                          descending-bound order while tau ratchets up,
                          with ``theta`` over-pruning and ``tau_init``
                          warm-start; one launch of the ``bmp_scan`` kernel.
  ``score_tiled_bmp_grouped``  the sweep per demand-planned micro-batch
                          (:mod:`repro_torch.sched.planner`): one
                          ``bmp_scan`` launch per padded group.

Scored docs carry exact scores; at ``theta = 1`` the top-k equals
``score_tiled``'s (see :mod:`repro.core.scoring` for the safety
arguments, which carry over unchanged).

TF32 is off for the whole package (set in ``repro_torch/__init__.py``), so
``score_dense`` and the bound products on the card are full-f32.

The compute dtype is the index's: an index whose values are bf16 (the
sharded steps' ``compute_dtype=torch.bfloat16``) scores through the
kernels' bf16 routes.  The query weights are rounded to bf16 (to nearest,
ties to even), each product of two bf16 numbers is exact in f32, the
products are summed in f32, and each score is rounded once to bf16; the
exact engines return bf16 scores, the BMP sweeps f32 ones holding the
rounded values.  The block bounds stay f32 over the f32 bound storage;
the prune and retire tests widen their margin to cover the roundings
(:data:`repro_torch.kernels.bmp_scan.ref.MARGIN_REL`), so every pruned
engine keeps the exact top-k of these scores, ties to the lower id.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import obs as obs_mod
from repro_torch.core import topk as topk_mod
from repro_torch.core.index import EllIndex, FlatIndex, TiledIndex
from repro_torch.core.sparse import SparseBatch
from repro_torch.kernels.bmp_scan import ops as bmp_ops
from repro_torch.kernels.bmp_scan import ref as bmp_ref
from repro_torch.kernels.ell_gather import ops as ell_ops
from repro_torch.kernels.scatter_score import ops as scatter_ops
from repro_torch.sched import planner as planner_mod

NEG_INF = float("-inf")

# ``index_add_`` calls of score_segment, one a valid query term: the
# per-term launches the fused kernels remove.
segment_launches = 0


def queries_to_dense(queries: SparseBatch, dtype=torch.float32) -> torch.Tensor:
    """[B, V] dense query-weight matrix QW (queries are few and short)."""
    return queries.to_dense(dtype)


def score_dense(
    queries: SparseBatch, docs: SparseBatch, dtype=torch.float32
) -> torch.Tensor:
    """Exact oracle: QW [B,V] @ D^T [V,N]. O(B*V*N) work, fully dense."""
    return queries.to_dense(dtype) @ docs.to_dense(dtype).T


def score_dense_f64(queries: SparseBatch, docs: SparseBatch) -> torch.Tensor:
    """Float64 ground truth on the batches' device."""
    return score_dense(queries, docs, dtype=torch.float64)


def docs_csr(docs: SparseBatch, dtype=torch.float64) -> torch.Tensor:
    """The docs as a sparse CSR [N, V] tensor on their device."""
    live = docs.term_ids >= 0
    crow = torch.zeros(docs.batch + 1, dtype=torch.int64, device=docs.device)
    crow[1:] = torch.cumsum(live.sum(dim=1), 0)
    return torch.sparse_csr_tensor(
        crow, docs.term_ids[live].long(), docs.values[live].to(dtype),
        size=(docs.batch, docs.vocab_size),
    )


# The float64 oracle's steps: at most 2^26 entries of float64 products
# (postings x queries) a step, and ranges of 2^26 / B docs whose [B, range]
# scores are selected from at once (512 MB each), so that the [B, N]
# float64 scores never materialize (35.4 GB at serve_8m's B = 500).
_ORACLE_ELEMS = 1 << 26


def _scores_f64(qw_t: torch.Tensor, docs: SparseBatch) -> torch.Tensor:
    """[B, R] float64 scores of the docs ``docs`` for the queries ``qw_t``
    ([V, B] float64): each posting's products ``v * q_t`` (exact in
    float64: two f32 factors), summed one doc at a time in slot order
    (``segment_reduce``: a doc's sum reads its own postings alone), so a
    score has the same bits whatever docs surround it, on either device.
    Steps of at most ``_ORACLE_ELEMS`` products, split on doc boundaries
    from the docs' posting counts (read on the host: the oracle is not on
    the serve path)."""
    b = qw_t.shape[1]
    live = docs.term_ids >= 0
    lengths = live.sum(dim=1)
    cols = docs.term_ids[live].long()  # the postings in slot order
    vals = docs.values[live].double()
    ends = torch.cumsum(lengths, 0).cpu()  # lint: disable=host-sync -- the float64 oracle (not the serve path) splits its steps on doc boundaries by posting counts
    out = torch.empty((b, docs.batch), dtype=torch.float64,
                      device=qw_t.device)
    per = max(1, _ORACLE_ELEMS // max(b, 1))
    d0 = 0
    while d0 < docs.batch:
        p0 = int(ends[d0 - 1]) if d0 else 0
        d1 = max(int(torch.searchsorted(ends, p0 + per, right=True)),
                 d0 + 1)
        p1 = int(ends[d1 - 1])
        prods = qw_t.index_select(0, cols[p0:p1]).mul_(vals[p0:p1, None])
        out[:, d0:d1] = torch.segment_reduce(
            prods, "sum", lengths=lengths[d0:d1], axis=0).T
        d0 = d1
    return out


def topk_f64(queries: SparseBatch, docs: SparseBatch, k: int):
    """Float64 top-k (values, ids) [B, min(k, N)] of the full batch, the
    exactness oracle at any corpus size; the [N, V] corpus is never
    densified (``score_dense_f64`` would be 244 GB at 1M docs x V =
    30,522).  A range of ``_ORACLE_ELEMS / B`` docs at a time: the range's
    float64 scores (:func:`_scores_f64`: one doc's sum over its own
    postings, in slot order), its top-k, merged into the running top-k,
    so the ranges change no value.  Ties at the k-th value go to the lower
    doc id, as ``lax.top_k`` breaks them; the values come in descending
    order, equal values by ascending id."""
    b, n = queries.batch, docs.batch
    k = min(k, n)
    qw_t = queries.to_dense(torch.float64).T.contiguous()
    vals = torch.empty((b, 0), dtype=torch.float64, device=qw_t.device)
    ids = torch.empty((b, 0), dtype=torch.int64, device=qw_t.device)
    step = max(1, _ORACLE_ELEMS // max(b, 1))
    for s in range(0, n, step):
        scores = _scores_f64(qw_t, docs.slice_rows(s, min(step, n - s)))
        v, i = topk_mod.topk(scores, k)
        del scores
        if s == 0:
            vals, ids = v, i
        else:  # the running list's ids are all lower: it goes first
            vals, ids = topk_mod.merge_topk(vals, ids, v, i + s, k)
    return vals, ids


def _pad_queries_to_term_blocks(queries: SparseBatch,
                                index: TiledIndex) -> torch.Tensor:
    """[B, V_pad] query weights in the index's compute dtype, the vocab
    padded up to a term-block multiple: every tile is whole."""
    qw = queries.to_dense()
    v_pad = index.num_term_blocks * index.term_block
    if v_pad > qw.shape[1]:
        qw = F.pad(qw, (0, v_pad - qw.shape[1]))
    return qw.to(index.value.dtype)


def _score_blocks(qw: torch.Tensor, index: TiledIndex,
                  blocks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, n_pad] ``scatter_score`` over the chunk runs of ``blocks``
    ([n_db] bool; None = every block), 0 in the other blocks."""
    count = index.block_chunk_count
    if blocks is not None:
        count = count * blocks.to(count.dtype)
    return scatter_ops.scatter_score(
        qw,
        index.local_term,
        index.local_doc,
        index.value,
        index.chunk_term_block,
        index.chunk_doc_block,
        index.block_chunk_start,
        count,
        term_block=index.term_block,
        doc_block=index.doc_block,
        num_doc_blocks=index.num_doc_blocks,
    )


def score_tiled(queries: SparseBatch, index: TiledIndex) -> torch.Tensor:
    qw = _pad_queries_to_term_blocks(queries, index)
    return _score_blocks(qw, index)[:, : index.num_docs]


def score_ell(queries: SparseBatch, index: EllIndex) -> torch.Tensor:
    """Doc-parallel: every document's full term list is gathered against
    the dense query matrix — bandwidth-friendly streaming, O(N*k*B)."""
    qw = queries.to_dense().to(index.values.dtype)
    out = ell_ops.ell_gather(qw, index.terms, index.values)
    return out[:, : index.num_docs]


# ---------------------------------------------------------------------------
# The paper's comparison points: a library product and the per-term loop


def score_bcoo(queries: SparseBatch, docs: SparseBatch) -> torch.Tensor:
    """cuSPARSE SpMV / SPARe "dot" analogue: the docs as CSR [N, V] times
    the dense QW^T [V, B], transposed to [B, N].  The CSR is built each
    call, as JAX builds its BCOO each call."""
    qw_t = queries.to_dense().T.contiguous()
    return torch.sparse.mm(docs_csr(docs, torch.float32), qw_t).T.contiguous()


def score_segment(queries: SparseBatch, index: FlatIndex) -> torch.Tensor:
    """SPARe-iterative analogue: for each query, for each of its terms in
    row order, one slice of the term's postings and one ``index_add_`` of
    ``w * values`` into the query's score row.

    JAX reads a fixed-size slice and masks it (``pos < padded_lengths``,
    ``doc >= 0``, ``t >= 0``); a list's real postings are its first
    ``lengths[t]`` slots, so the slice here is exactly those.  A list holds
    a doc once, so each add touches a cell once and the f32 sums follow
    JAX's order of adds.  The query's terms and the index's offsets come to
    the host once a call; the loop issues two launches a term (the product
    and the add), which is the structure the fused kernels remove.
    """
    global segment_launches
    ids, weights, offsets, lengths = (  # lint: disable=host-sync -- the comparison engine's loop runs on the host: its terms and the offsets come over once a call
        t.tolist() for t in (queries.term_ids, queries.values, index.offsets,
                             index.lengths))
    out = torch.zeros((queries.batch, index.num_docs), dtype=torch.float32,
                      device=index.device)
    for b in range(queries.batch):
        row = out[b]
        for t, w in zip(ids[b], weights[b]):
            if t < 0:
                continue
            start, n = offsets[t], lengths[t]
            docs = index.doc_ids[start:start + n]
            row.index_add_(0, docs, index.values[start:start + n] * w)
            segment_launches += 1
    return out


# ---------------------------------------------------------------------------
# Block-max bounds (shared by every pruned engine)


def _prune_margin(tau: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Rounding envelope of the skip test for scores of ``dtype``: the
    bound and the exact scores sum in different orders, so a tight bound
    can round a few ulps below tau in a near-tie, and bf16 scores are
    rounded where the bound is not; blocks within it are kept
    (:func:`repro_torch.kernels.bmp_scan.ref.prune_margin`)."""
    return bmp_ref.prune_margin(tau, dtype)


def query_block_mass(qw: torch.Tensor, term_block: int) -> torch.Tensor:
    """[B, n_term_blocks] per-term-block sum of |query weight|; ``qw`` is
    padded to a term-block multiple."""
    b, v_pad = qw.shape
    return qw.abs().reshape(b, v_pad // term_block, term_block).sum(dim=2)


# Entries of a step of the fine bounds: ranges of at most 2^25 / B doc
# blocks (a [B, doc blocks] step; its float64 temporaries are a few times
# that), and in each range groups of query terms whose u8 [B, terms, doc
# blocks] rows hold at most 2^25 entries, so that the [B, K, n_db] bound
# rows never materialize (500 x ~100 x 34,539 f32 at serve_8m, 6.9 GB).
_BOUND_ROW_ELEMS = 1 << 25

# A query whose weights |q_t| * scale_t sum below 2^20 times its smallest
# nonzero one adds each term's product g * w (g a u8 bound) to the f32
# bound exactly in float64: a step's addends are multiples of ulp(w) and
# ulp(acc), each at least 2^-24 of its value, and acc < 2^28 w and g * w <
# 2^28 acc keep the sum under 2^53 of the smaller, so one rounding of the
# float64 sum to f32 is the FMA's.  Synthetic queries stay under ~8,300
# (serve_1m's msmarco-like corpus).
_EXACT_SUM_RATIO = float(1 << 20)


def _fma_nonneg(a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as a fused multiply-add gives it,
    for nonnegative operands (``a`` u8 or f32, ``b`` and ``c`` f32): the
    product is exact in float64 (at most 48 bits), the sum is rounded to
    odd there (the sign of its exact error by Fast2Sum, the larger addend
    first), and rounding that once to f32 is correct (53 >= 24 + 2
    bits).  Ten elementwise passes, each operand widened where it is
    read."""
    p = a * b.double()
    s = p + c
    hi, lo = torch.maximum(p, c), torch.minimum(p, c)
    d = s - hi  # exact; the error is lo - d, also exact
    # Positive s: truncated toward zero, then the last bit set where the
    # sum was inexact.
    bits = (s.view(torch.int64) - (lo < d).view(torch.uint8)) \
        | (lo != d).view(torch.uint8)
    return bits.view(torch.float64).float()


def _bound_rows_at(index: TiledIndex, ids: torch.Tensor, d0: int,
                   d1: int) -> torch.Tensor:
    """u8 [*ids.shape, d1 - d0]: the quantized fine bounds of each term of
    ``ids`` over doc blocks [d0, d1).  Dense storage is a gather; CSR
    storage a gather of each row's entries at a fixed width (a row holds
    each doc block at most once, so at most n_db entries: no host sync)
    scattered into place, those outside the range into a spare column
    dropped after."""
    if index.term_block_max_q is not None:
        return index.term_block_max_q[ids, d0:d1]
    flat, dev = ids.reshape(-1), ids.device
    n = flat.shape[0]
    rows = torch.zeros((n, d1 - d0 + 1), dtype=torch.uint8, device=dev)
    width = min(index.num_doc_blocks, index.tbm_cols.numel())
    if width > 0:
        indptr = index.tbm_indptr.long()
        start = indptr[flat]
        j = torch.arange(width, device=dev)
        live = j < (indptr[flat + 1] - start)[:, None]
        pos = torch.where(live, start[:, None] + j, 0)
        cols = index.tbm_cols[pos].long() - d0
        cols = torch.where(live & (cols >= 0) & (cols < d1 - d0), cols,
                           d1 - d0)
        rows[torch.arange(n, device=dev)[:, None], cols] = \
            index.tbm_vals_q[pos]
    return rows[:, :-1].reshape(*ids.shape, d1 - d0)


def _fine_bounds(queries: SparseBatch, index: TiledIndex,
                 seeds: bool = False):
    """``(ub [B, n_db] f32, term_seeds [B, K] or None)`` from the fine
    bounds (either format): each doc block's bound ``sum_t |q_t| *
    scale_t * bound_q[t, db]`` summed over the query's terms in their
    order, each term's product added with one rounding, and with
    ``seeds`` each term's peak-contribution block (the first argmax over
    doc blocks of ``|q_t| * scale_t * bound_q[t, :]``).  A range of doc
    blocks and a group of terms at a time (``_BOUND_ROW_ELEMS``): the
    rows never materialize whole, and every entry has the same bits
    whatever the ranges and the device.  A step is one float64
    ``addcmul_`` into the f32 sum where every query's weights keep it
    exact (``_EXACT_SUM_RATIO``; one host read a call), else the FMA
    emulated (:func:`_fma_nonneg`): the same bits.  That order is the one
    JAX's ``einsum`` takes on the CPU (a GEMM accumulating with FMAs); a
    one-shot ``torch.einsum`` gives it on the CPU too, but cuBLAS's picks
    its kernel by shape and differs by up to 10 ulps in some
    (``scripts/kernel_turns.py``'s ``bounds`` block)."""
    q_ids = queries.term_ids
    scale = index.term_block_scale
    ids = q_ids.clamp(0, scale.shape[0] - 1).long()
    w = torch.where(q_ids >= 0, queries.values.abs(), 0.0) * scale[ids]
    w64 = w.double()
    smallest = torch.where(w > 0, w64, torch.inf).amin(dim=1)
    exact_sum = bool(  # lint: disable=host-sync -- one read a call picks the one-pass sum (every query's weights keep it exact) or the emulated FMA
        (w64.sum(dim=1) < _EXACT_SUM_RATIO * smallest).all())
    b, kq = ids.shape
    n_db = index.num_doc_blocks
    dev = w.device
    peak = term_seeds = None
    if seeds:
        peak = torch.full((b, kq), NEG_INF, dtype=torch.float32, device=dev)
        term_seeds = torch.zeros((b, kq), dtype=torch.int64, device=dev)
    parts = []
    step = max(1, _BOUND_ROW_ELEMS // max(b, 1))
    for d0 in range(0, n_db, step):
        d1 = min(d0 + step, n_db)
        acc = torch.zeros((b, d1 - d0), dtype=torch.float32, device=dev)
        group = max(1, _BOUND_ROW_ELEMS // max(b * (d1 - d0), 1))
        for t0 in range(0, kq, group):
            t1 = min(t0 + group, kq)
            rows = _bound_rows_at(index, ids[:, t0:t1], d0, d1)
            for t in range(t0, t1):
                if exact_sum:
                    acc.addcmul_(rows[:, t - t0], w64[:, t:t + 1])
                else:
                    acc = _fma_nonneg(rows[:, t - t0], w[:, t:t + 1], acc)
            if seeds:
                # Strictly above: an earlier range keeps a tie (argmax's
                # first maximum).
                m, arg = (rows * w[:, t0:t1, None]).max(dim=2)
                better = m > peak[:, t0:t1]
                peak[:, t0:t1] = torch.where(better, m, peak[:, t0:t1])
                term_seeds[:, t0:t1] = torch.where(
                    better, arg + d0, term_seeds[:, t0:t1])
        parts.append(acc)
    ub = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return ub, term_seeds


def block_upper_bounds(queries: SparseBatch, index: TiledIndex,
                       qw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, num_doc_blocks] per-query score upper bound of every doc block
    (the pruned engines' ``bounds`` seam): ``sum_t |q_t| * bound[t, db]``
    over the fine per-(term, doc_block) maxima where the index stores them
    (either format; :func:`_fine_bounds`), else the tile-level
    ``query_block_mass @ block_max``.  Both dominate every true doc score
    in the block."""
    if index.has_fine_bounds:
        return _fine_bounds(queries, index)[0]
    if qw is None:
        qw = _pad_queries_to_term_blocks(queries, index)
    return query_block_mass(qw.float(), index.term_block) @ index.block_max


@dataclasses.dataclass
class PruneStats:
    """Observability for the pruned paths (benchmarks / tuning)."""

    num_doc_blocks: int
    blocks_seeded: int  # batch-level doc blocks scored in the seed pass
    blocks_scored: int  # total batch-level doc blocks ever scored
    chunks_total: int
    chunks_scored: int
    # BMP sweep extras: rank steps taken before every query exited (the
    # two-pass path leaves this 0), and the bound scale (1.0 = exact).
    sweep_steps: int = 0
    theta: float = 1.0

    @property
    def block_skip_frac(self) -> float:
        return 1.0 - self.blocks_scored / max(self.num_doc_blocks, 1)

    @property
    def chunk_skip_frac(self) -> float:
        return 1.0 - self.chunks_scored / max(self.chunks_total, 1)


def prune_seed_count(num_docs: int, doc_block: int, k: int,
                     seed_blocks: Optional[int] = None) -> int:
    """Seed-block count: enough to guarantee >= min(k, num_docs) exactly
    scored real docs (even with the ragged last block seeded); defaults to
    8x the k-covering count."""
    n_db = max(-(-num_docs // doc_block), 1)
    k_eff = min(k, num_docs)
    tail_pad = n_db * doc_block - num_docs
    min_blocks = -(-(k_eff + tail_pad) // doc_block)
    if seed_blocks is None:
        m = max(min_blocks, 8 * -(-k_eff // doc_block))
    else:
        m = max(seed_blocks, min_blocks)
    return max(min(m, n_db), 1)


def _alive_from_deleted(deleted_mask, num_docs: int,
                        device) -> Optional[torch.Tensor]:
    """[num_docs] bool alive mask (True = alive) on ``device`` from a
    caller's deleted mask, or ``None`` when nothing is deleted."""
    if deleted_mask is None:
        return None
    alive = ~torch.as_tensor(deleted_mask, dtype=torch.bool, device=device)
    if tuple(alive.shape) != (num_docs,):
        raise ValueError(
            f"deleted_mask shape {tuple(alive.shape)} != ({num_docs},)"
        )
    return alive


def _doc_mask(blocks: torch.Tensor, doc_block: int, num_docs: int,
              alive: Optional[torch.Tensor]) -> torch.Tensor:
    """[..., num_docs] bool: the doc lies in a True block and is alive."""
    docs = blocks.repeat_interleave(doc_block, dim=-1)[..., :num_docs]
    return docs if alive is None else docs & alive


# ---------------------------------------------------------------------------
# Two-pass pruned scoring (seed, then sweep the survivors)


def _pruned_passes(qw, index: TiledIndex, ub, term_seeds, alive_doc, *,
                   k_eff: int, seed_m: int):
    """Two-pass pruned scoring core -> ``(masked scores [B, num_docs],
    seeded_any, scored_any, chunks_scored_mask)``; pruned and deleted docs
    are ``-inf``.  Deleted docs never seed tau.  The passes score disjoint
    blocks, so pass 2 is merged into pass 1's buffer by block, in place:
    every kept block carries exactly ``score_tiled``'s scores, and two
    [B, n_pad] buffers are the most that live at once.  The result is a
    view of pass 1's buffer."""
    b, n_db = ub.shape
    n_docs, d_blk = index.num_docs, index.doc_block
    # Pass 1 — seed: each query's top-m blocks by bound (lax.top_k's tie
    # order), plus each query term's peak-contribution block.
    _, seed_ids = topk_mod.topk(ub, seed_m)
    seeded = torch.zeros((b, n_db), dtype=torch.bool, device=ub.device)
    seeded.scatter_(1, seed_ids, True)
    if term_seeds is not None:
        seeded.scatter_(1, term_seeds, True)
    seeded_any = seeded.any(dim=0)
    out = _score_blocks(qw, index, seeded_any)[:, :n_docs]
    # Only seeded, live docs keep their scores (which are the output's
    # there): the k-th best of them is tau.
    out.masked_fill_(~_doc_mask(seeded_any, d_blk, n_docs, alive_doc),
                     NEG_INF)
    tau = topk_mod.partial_topk_threshold(out, k_eff).float()
    # Pass 2 — every unseeded block some query's bound can still beat tau
    # with (>=, and the margin keeps near-ties and the scores' roundings).
    margin = _prune_margin(tau, out.dtype)
    needed_any = (ub >= (tau - margin)[:, None]).any(dim=0) & ~seeded_any
    scores2 = _score_blocks(qw, index, needed_any)
    torch.where(_doc_mask(needed_any, d_blk, n_docs, alive_doc),
                scores2[:, :n_docs], out, out=out)
    del scores2
    scored_any = seeded_any | needed_any
    return out, seeded_any, scored_any, \
        scored_any[index.chunk_doc_block.long()]


def score_tiled_pruned(queries: SparseBatch, index: TiledIndex, k: int,
                       seed_blocks: Optional[int] = None,
                       return_stats: bool = False, deleted_mask=None):
    """Safe block-max pruned scoring, two passes: [B, N] with pruned docs
    at ``-inf`` (:func:`repro.core.scoring.score_tiled_pruned`).

    1. *Seed*: per query, the highest-bound doc blocks plus each query
       term's peak-contribution block are scored exactly; the k-th best
       seeded score is the per-query threshold tau.
    2. *Sweep*: every block some query's bound can still beat tau with is
       scored; the rest are skipped.

    ``deleted_mask`` ([num_docs] bool, True = deleted, index doc order)
    keeps deleted docs out of the seed and the output.
    """
    qw = _pad_queries_to_term_blocks(queries, index)
    k_eff = min(k, index.num_docs)
    m = prune_seed_count(index.num_docs, index.doc_block, k, seed_blocks)
    term_seeds = None
    if index.has_fine_bounds:
        # One pass over the bound rows feeds the bound and the seed pick.
        ub, term_seeds = _fine_bounds(queries, index, seeds=True)
    else:
        ub = block_upper_bounds(queries, index, qw=qw)
    out, seeded_any, scored_any, chunks_mask = _pruned_passes(
        qw, index, ub, term_seeds,
        _alive_from_deleted(deleted_mask, index.num_docs, qw.device),
        k_eff=k_eff, seed_m=m,
    )
    if not return_stats:
        return out
    seeded, scored, chunks = torch.stack((  # lint: disable=host-sync -- PruneStats are host numbers, read in one transfer when return_stats asks for them
        seeded_any.sum(), scored_any.sum(), chunks_mask.sum())).tolist()
    return out, PruneStats(
        num_doc_blocks=index.num_doc_blocks,
        blocks_seeded=seeded,
        blocks_scored=scored,
        chunks_total=index.num_chunks,
        chunks_scored=chunks,
    )


# ---------------------------------------------------------------------------
# The BMP sweep (descending-bound traversal with a running threshold)


def _require_runs(index: TiledIndex) -> None:
    if index.block_chunk_start is None or index.block_chunk_count is None:
        raise ValueError(
            "TiledIndex lacks block chunk runs; rebuild with "
            "repro_torch.core.index.build_tiled_index"
        )


def _sweep(qw, ub, tau0, index: TiledIndex, theta: float, k_eff: int,
           alive_doc):
    """Stacked groups' BMP sweeps through one ``bmp_scan`` launch.

    ``qw`` [G, b, V_pad], ``ub`` [G, b, n_db], ``tau0`` [G, b] -> ``(out
    [G, b, num_docs] with unvisited and deleted docs at -inf, tau [G, b],
    block_scored [G, n_db] bool, chunk_scored [G, num_chunks] bool, steps
    [G])``.  The visit order is the stable descending sort of each row's
    bounds (``jnp.argsort``'s order), built here and consumed by the
    kernel.  The scores buffer is masked in place."""
    order = torch.argsort(-ub, dim=-1, stable=True)
    ub_sorted = ub.gather(-1, order)
    scores, heap, bsc, csc, steps = bmp_ops.bmp_sweep(
        qw, order.to(torch.int32), ub_sorted, tau0,
        index.block_chunk_start, index.block_chunk_count,
        index.chunk_term_block, index.chunk_doc_block,
        index.local_term, index.local_doc, index.value, alive_doc,
        term_block=index.term_block, doc_block=index.doc_block,
        k_eff=k_eff, theta=theta, num_docs=index.num_docs,
    )
    bsc = bsc.bool()
    out = scores[..., : index.num_docs]
    out.masked_fill_(~_doc_mask(bsc, index.doc_block, index.num_docs,
                                alive_doc)[:, None, :], NEG_INF)
    tau = torch.maximum(tau0, heap[..., -1])
    return out, tau, bsc, csc.bool(), steps[:, 0]


def _tau0(tau_init, b: int, device) -> torch.Tensor:
    if tau_init is None:
        return torch.full((b,), NEG_INF, dtype=torch.float32, device=device)
    return torch.as_tensor(tau_init, dtype=torch.float32).to(
        device).contiguous()


def score_tiled_bmp(queries: SparseBatch, index: TiledIndex, k: int,
                    theta: float = 1.0, tau_init=None,
                    return_stats: bool = False, return_tau: bool = False,
                    deleted_mask=None):
    """The BMP sweep over the whole batch as one group (one ``bmp_scan``
    launch): [B, N] scores with unvisited docs at ``-inf``
    (:func:`repro.core.scoring.score_tiled_bmp`).

    ``theta < 1`` scales the bounds before the retire test (unsafe,
    bounded recall).  ``tau_init`` [B] warm-starts the threshold and must
    be certified by the caller (at least k already retrieved docs of the
    same query stream score ``>=`` it).  ``return_tau`` appends the final
    per-query tau.  ``deleted_mask`` ([num_docs] bool, True = deleted)
    keeps deleted docs from certifying tau and out of the output.
    """
    _require_runs(index)
    qw = _pad_queries_to_term_blocks(queries, index)
    k_eff = max(min(k, index.num_docs), 1)
    ub = block_upper_bounds(queries, index, qw=qw)
    tau0 = _tau0(tau_init, qw.shape[0], qw.device)
    out, tau, bsc, csc, steps = _sweep(
        qw[None], ub[None], tau0[None], index, theta, k_eff,
        _alive_from_deleted(deleted_mask, index.num_docs, qw.device),
    )
    ret = [out[0]]
    if return_stats:
        scored, chunks, n_steps = torch.stack((  # lint: disable=host-sync -- PruneStats are host numbers, read in one transfer when return_stats asks for them
            bsc.sum(), csc.sum(), steps[0].long())).tolist()
        ret.append(PruneStats(
            num_doc_blocks=index.num_doc_blocks,
            blocks_seeded=0,  # no seed pass: tau grows from the sweep
            blocks_scored=scored,
            chunks_total=index.num_chunks,
            chunks_scored=chunks,
            sweep_steps=n_steps,
            theta=theta,
        ))
    if return_tau:
        ret.append(tau[0])
    return ret[0] if len(ret) == 1 else tuple(ret)


# ---------------------------------------------------------------------------
# Demand-grouped BMP sweeps (engines "tiled-bmp-grouped" and, through
# repro_torch.kernels.bmp_scan.ops.bmp_scan, "tiled-bmp-fused")


@dataclasses.dataclass
class SchedStats:
    """Observability for the grouped sweeps (per group and aggregate), as
    :class:`repro.core.scoring.SchedStats`.

    ``chunk_work`` counts chunk executions weighted by *live* group size,
    comparable with ``PruneStats.chunks_scored * B`` of the flat sweep;
    ``padded_chunk_work`` weights by the power-of-two rows a launch
    actually runs.  ``kernel_launches`` is 0 for the grouped engine (one
    launch per group) and the launch count (one per bucket) for the fused
    one.
    """

    num_doc_blocks: int
    chunks_total: int
    group_sizes: tuple[int, ...]
    blocks_scored_per_group: tuple[int, ...]
    chunks_scored_per_group: tuple[int, ...]
    blocks_scored_union: int
    chunks_scored_union: int
    sweep_steps: int  # summed over groups
    theta: float = 1.0
    padded_group_sizes: tuple[int, ...] = ()
    kernel_launches: int = 0

    @property
    def num_groups(self) -> int:
        return len(self.group_sizes)

    @property
    def launches(self) -> int:
        """Sweep launches: ``kernel_launches`` if set, else one a group."""
        return self.kernel_launches or self.num_groups

    @property
    def chunk_work(self) -> int:
        return sum(c * s for c, s in
                   zip(self.chunks_scored_per_group, self.group_sizes))

    @property
    def padded_chunk_work(self) -> int:
        sizes = self.padded_group_sizes or self.group_sizes
        return sum(c * s for c, s in
                   zip(self.chunks_scored_per_group, sizes))

    def flat_chunk_work(self, chunks_scored: int) -> int:
        """What the flat batch pays for the same demand."""
        return chunks_scored * sum(self.group_sizes)

    @property
    def union(self) -> PruneStats:
        """Flat-comparable aggregate (the ``prune_stats`` seam's type)."""
        return PruneStats(
            num_doc_blocks=self.num_doc_blocks,
            blocks_seeded=0,
            blocks_scored=self.blocks_scored_union,
            chunks_total=self.chunks_total,
            chunks_scored=self.chunks_scored_union,
            sweep_steps=self.sweep_steps,
            theta=self.theta,
        )


def grouped_sweeps(queries: SparseBatch, index: TiledIndex, k: int, *,
                   stacked: bool, groups=None, theta: float = 1.0,
                   tau_init=None, return_stats: bool = False,
                   return_tau: bool = False, top_m: int = 8,
                   max_group: Optional[int] = None, min_share: float = 0.5,
                   plan_cache=None, deleted_mask=None, obs=None, ub=None):
    """The BMP sweep per micro-batch group: [B, N] scores, unvisited docs
    ``-inf``; the top-k equals the flat sweep's for any partition, and the
    chunk work never exceeds it.

    ``groups`` (row-index arrays) default to the demand planner's plan
    (knobs ``top_m``/``max_group``/``min_share``, memoized in
    ``plan_cache``).  Groups are padded to powers of two
    (:func:`repro_torch.sched.planner.padded_group_rows`; pad rows carry
    ``PAD_TAU`` and retire at once).  ``stacked=False`` launches one sweep
    a group (``score_tiled_bmp_grouped``); ``stacked=True`` stacks the
    groups of each power-of-two bucket into one launch
    (``bmp_scan.ops.bmp_scan``) and counts the launches in
    ``SchedStats.kernel_launches``.  ``obs`` (``repro_torch.obs.Obs`` or
    None) traces the ``plan``, the ``bucket.assembly`` of a stacked call
    and one fenced ``kernel`` span per launch, and counts
    ``kernel.launches_total``, with the JAX engines' names.  ``ub`` is
    the batch's :func:`block_upper_bounds` where the caller has them
    already.  Returns ``out[, stats][, tau]``.
    """
    _require_runs(index)
    qw = _pad_queries_to_term_blocks(queries, index)
    dev = qw.device
    b = qw.shape[0]
    k_eff = max(min(k, index.num_docs), 1)
    if ub is None:
        ub = block_upper_bounds(queries, index, qw=qw)
    if groups is None:
        groups = planner_mod.plan_with_cache(  # lint: disable=host-sync -- the demand planner is numpy on the host: the bounds and chunk counts go to it once a call (PERF.md section 5, bottleneck 1)
            plan_cache, queries, index,
            lambda: planner_mod.plan_micro_batches(
                ub.cpu().numpy(), index.block_chunk_count.cpu().numpy(),
                top_m=top_m, max_group=max_group, min_share=min_share,
            ),
            knobs=(top_m, max_group, min_share),
            obs=obs,
        ).groups
    groups = planner_mod.validate_groups(groups, b)
    tau0 = _tau0(tau_init, b, "cpu").numpy()  # lint: disable=host-sync -- the planner pads each group's rows with their tau on the host
    alive = _alive_from_deleted(deleted_mask, index.num_docs, dev)
    if stacked:
        with obs_mod.span(obs, "bucket.assembly") as sp:
            batches = list(planner_mod.bucketed_group_rows(groups, tau0))
            if sp is not None:
                sp.attrs["buckets"] = len(batches)
    else:
        batches = (
            (len(sel), [(gi, g)], sel[None], tau_g[None])
            for gi, (g, sel, tau_g) in enumerate(
                planner_mod.padded_group_rows(groups, tau0))
        )
    n = len(groups)
    out = torch.empty((b, index.num_docs), dtype=torch.float32, device=dev)
    tau_out = torch.tensor(tau0, device=dev)
    blocks_g, chunks_g, padded, steps_g = [0] * n, [0] * n, [0] * n, [0] * n
    block_union = torch.zeros(index.num_doc_blocks, dtype=torch.bool,
                              device=dev)
    chunk_union = torch.zeros(index.num_chunks, dtype=torch.bool, device=dev)
    launches = 0
    for size, entries, sel, tau_sel in batches:
        sel_t = torch.from_numpy(sel).to(dev)
        attrs = (dict(bucket=size, groups=len(entries)) if stacked
                 else dict(rows=size, live=len(entries[0][1])))
        with obs_mod.span(obs, "kernel", **attrs):
            out_g, tau_g, bsc, csc, steps = _sweep(
                qw[sel_t], ub[sel_t], torch.from_numpy(tau_sel).to(dev),
                index, theta, k_eff, alive,
            )
            if obs is not None:
                obs.counter("kernel.launches_total").inc()
                obs_mod.fence((out_g, tau_g))
        launches += 1
        if return_stats:
            nb, nc, steps = torch.stack((  # lint: disable=host-sync -- SchedStats are host numbers, read in one transfer a launch when return_stats asks for them
                bsc.sum(dim=1), csc.sum(dim=1), steps.long())).tolist()
            block_union |= bsc.any(dim=0)
            chunk_union |= csc.any(dim=0)
        for slot, (gi, g) in enumerate(entries):
            rows = torch.from_numpy(g).to(dev)
            out[rows] = out_g[slot, : len(g)]
            tau_out[rows] = tau_g[slot, : len(g)]
            if return_stats:
                blocks_g[gi], chunks_g[gi] = nb[slot], nc[slot]
                padded[gi], steps_g[gi] = size, steps[slot]
        del out_g
    ret = [out]
    if return_stats:
        blocks_union, chunks_union = torch.stack((  # lint: disable=host-sync -- SchedStats are host numbers, read in one transfer when return_stats asks for them
            block_union.sum(), chunk_union.sum())).tolist()
        ret.append(SchedStats(
            num_doc_blocks=index.num_doc_blocks,
            chunks_total=index.num_chunks,
            group_sizes=tuple(len(g) for g in groups),
            blocks_scored_per_group=tuple(blocks_g),
            chunks_scored_per_group=tuple(chunks_g),
            blocks_scored_union=blocks_union,
            chunks_scored_union=chunks_union,
            sweep_steps=sum(steps_g),
            theta=theta,
            padded_group_sizes=tuple(padded),
            kernel_launches=launches if stacked else 0,
        ))
    if return_tau:
        ret.append(tau_out)
    return ret[0] if len(ret) == 1 else tuple(ret)


def score_tiled_bmp_grouped(queries: SparseBatch, index: TiledIndex, k: int,
                            **kw):
    """Demand-grouped BMP traversal, one ``bmp_scan`` launch per padded
    group (:func:`repro.core.scoring.score_tiled_bmp_grouped`); the
    keywords and returns of :func:`grouped_sweeps`."""
    return grouped_sweeps(queries, index, k, stacked=False, **kw)


def score_with_engine(engine: str, queries: SparseBatch, docs: SparseBatch,
                      index=None, k: int = 10,
                      theta: float = 1.0) -> torch.Tensor:
    """Deprecated string dispatcher — use :mod:`repro_torch.core.registry`
    (``get_engine(name).score``) or :class:`repro_torch.core.session.
    Retriever` (:func:`repro.core.scoring.score_with_engine`).

    Routed through the registry on the batches' device: ``k`` only affects
    the pruned engines, whose output masks documents provably outside the
    top-``k`` to ``-inf``, and ``theta`` only an engine that honours it.
    The two-pass-capable pruned engine seeds and sweeps; every other
    pruned engine is a BMP traversal.  ``index`` is built from ``docs``
    unless it is of the engine's index type.
    """
    warnings.warn(
        "score_with_engine is deprecated; dispatch through "
        "repro_torch.core.registry.get_engine or "
        "repro_torch.core.session.Retriever",
        DeprecationWarning, stacklevel=2,
    )
    from repro_torch.core import registry
    from repro_torch.core.engine import RetrievalConfig

    spec = registry.get_engine(engine)  # unknown names list the registry
    cfg = RetrievalConfig(
        engine=engine, k=k,
        theta=theta if spec.supports_theta else 1.0,
        traversal="two-pass" if spec.supports_two_pass else "bmp",
    )
    if spec.index_type is None or not isinstance(index, spec.index_type):
        index = spec.build_index(docs, cfg)
    return spec.score(queries, index, cfg, k=k)
