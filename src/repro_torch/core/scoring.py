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


def topk_f64(queries: SparseBatch, docs: SparseBatch, k: int):
    """Float64 top-k (values, ids) [B, k] of the full batch, the exactness
    oracle at any corpus size: the scores [B, N] come from the docs as CSR,
    so the [N, V] corpus is never densified (``score_dense_f64`` would be
    244 GB at 1M docs x V = 30,522)."""
    scores = torch.sparse.mm(docs_csr(docs, torch.float64),
                             queries.to_dense(torch.float64).T).T
    return torch.topk(scores, min(k, docs.batch), dim=1)


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
    ids = queries.term_ids.cpu().numpy()
    weights = queries.values.cpu().numpy()
    offsets = index.offsets.cpu().numpy()
    lengths = index.lengths.cpu().numpy()
    out = torch.zeros((queries.batch, index.num_docs), dtype=torch.float32,
                      device=index.device)
    for b in range(queries.batch):
        row = out[b]
        for t, w in zip(ids[b].tolist(), weights[b].tolist()):
            if t < 0:
                continue
            start, n = int(offsets[t]), int(lengths[t])
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


def _csr_bound_rows(q_ids: torch.Tensor, index: TiledIndex) -> torch.Tensor:
    """[B, K, n_db] f32 quantized fine-bound rows of the query's terms,
    scattered on the device from CSR storage: the same entries the dense
    gather ``term_block_max_q[ids]`` gives, and the full [V, n_db] matrix
    never materializes (a CSR row holds each doc block at most once)."""
    b, kq = q_ids.shape
    n_db = index.num_doc_blocks
    indptr = index.tbm_indptr.long()
    ids = q_ids.clamp(0, indptr.numel() - 2).long().reshape(-1)
    start = indptr[ids]
    length = indptr[ids + 1] - start
    rows = torch.zeros((b * kq, n_db), dtype=torch.float32,
                       device=q_ids.device)
    owner = torch.repeat_interleave(
        torch.arange(b * kq, device=q_ids.device), length
    )
    first = torch.cumsum(length, 0) - length
    pos = start[owner] + torch.arange(owner.numel(), device=q_ids.device) \
        - first[owner]
    rows[owner, index.tbm_cols[pos].long()] = index.tbm_vals_q[pos].float()
    return rows.reshape(b, kq, n_db)


def _fine_bound_rows(queries: SparseBatch, index: TiledIndex):
    """(rows [B, K, n_db] f32 quantized bounds, w [B, K] |q| * scale): the
    operands of the fine bound and the per-term seed pick.  Dense storage
    is a device gather, CSR storage a device scatter of the same
    entries."""
    q_ids = queries.term_ids
    scale = index.term_block_scale
    ids = q_ids.clamp(0, scale.shape[0] - 1).long()
    if index.term_block_max_q is not None:
        rows = index.term_block_max_q[ids].float()
    else:
        rows = _csr_bound_rows(q_ids, index)
    w = torch.where(q_ids >= 0, queries.values.abs(), 0.0) * scale[ids]
    return rows, w


def block_upper_bounds(queries: SparseBatch, index: TiledIndex,
                       qw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, num_doc_blocks] per-query score upper bound of every doc block
    (the pruned engines' ``bounds`` seam): ``sum_t |q_t| * bound[t, db]``
    over the fine per-(term, doc_block) maxima where the index stores them
    (either format), else the tile-level ``query_block_mass @
    block_max``.  Both dominate every true doc score in the block."""
    if index.has_fine_bounds:
        rows, w = _fine_bound_rows(queries, index)
        return torch.einsum("bkd,bk->bd", rows, w)
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
    blocks, so pass 2 is merged into pass 1 by block: every kept block
    carries exactly ``score_tiled``'s scores."""
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
    scores1 = _score_blocks(qw, index, seeded_any)
    masked1 = torch.where(_doc_mask(seeded_any, d_blk, n_docs, alive_doc),
                          scores1[:, :n_docs], NEG_INF)
    tau = topk_mod.partial_topk_threshold(masked1, k_eff).float()
    del masked1
    # Pass 2 — every unseeded block some query's bound can still beat tau
    # with (>=, and the margin keeps near-ties and the scores' roundings).
    margin = _prune_margin(tau, scores1.dtype)
    needed_any = (ub >= (tau - margin)[:, None]).any(dim=0) & ~seeded_any
    scores2 = _score_blocks(qw, index, needed_any)
    scores = torch.where(seeded_any.repeat_interleave(d_blk)[None, :],
                         scores1, scores2)
    del scores1, scores2
    scored_any = seeded_any | needed_any
    out = torch.where(_doc_mask(scored_any, d_blk, n_docs, alive_doc),
                      scores[:, :n_docs], NEG_INF)
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
        # One rows build feeds the bound and the seed pick.
        rows, w = _fine_bound_rows(queries, index)
        ub = torch.einsum("bkd,bk->bd", rows, w)
        term_seeds = (w[..., None] * rows).argmax(dim=-1)
        del rows
    else:
        ub = block_upper_bounds(queries, index, qw=qw)
    out, seeded_any, scored_any, chunks_mask = _pruned_passes(
        qw, index, ub, term_seeds,
        _alive_from_deleted(deleted_mask, index.num_docs, qw.device),
        k_eff=k_eff, seed_m=m,
    )
    if not return_stats:
        return out
    return out, PruneStats(
        num_doc_blocks=index.num_doc_blocks,
        blocks_seeded=int(seeded_any.sum()),
        blocks_scored=int(scored_any.sum()),
        chunks_total=index.num_chunks,
        chunks_scored=int(chunks_mask.sum()),
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
        ret.append(PruneStats(
            num_doc_blocks=index.num_doc_blocks,
            blocks_seeded=0,  # no seed pass: tau grows from the sweep
            blocks_scored=int(bsc.sum()),
            chunks_total=index.num_chunks,
            chunks_scored=int(csc.sum()),
            sweep_steps=int(steps[0]),
            theta=float(theta),
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
        groups = planner_mod.plan_with_cache(
            plan_cache, queries, index,
            lambda: planner_mod.plan_micro_batches(
                ub.cpu().numpy(), index.block_chunk_count.cpu().numpy(),
                top_m=top_m, max_group=max_group, min_share=min_share,
            ),
            knobs=(top_m, max_group, min_share),
            obs=obs,
        ).groups
    groups = planner_mod.validate_groups(groups, b)
    tau0 = _tau0(tau_init, b, "cpu").numpy()
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
    tau_out = tau0.copy()
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
        tau_g = tau_g.cpu().numpy()
        if return_stats:
            nb, nc = bsc.sum(dim=1).tolist(), csc.sum(dim=1).tolist()
            steps = steps.tolist()
            block_union |= bsc.any(dim=0)
            chunk_union |= csc.any(dim=0)
        for slot, (gi, g) in enumerate(entries):
            out[torch.from_numpy(g).to(dev)] = out_g[slot, : len(g)]
            tau_out[g] = tau_g[slot, : len(g)]
            if return_stats:
                blocks_g[gi], chunks_g[gi] = nb[slot], nc[slot]
                padded[gi], steps_g[gi] = size, steps[slot]
        del out_g
    ret = [out]
    if return_stats:
        ret.append(SchedStats(
            num_doc_blocks=index.num_doc_blocks,
            chunks_total=index.num_chunks,
            group_sizes=tuple(len(g) for g in groups),
            blocks_scored_per_group=tuple(blocks_g),
            chunks_scored_per_group=tuple(chunks_g),
            blocks_scored_union=int(block_union.sum()),
            chunks_scored_union=int(chunk_union.sum()),
            sweep_steps=sum(steps_g),
            theta=float(theta),
            padded_group_sizes=tuple(padded),
            kernel_launches=launches if stacked else 0,
        ))
    if return_tau:
        ret.append(torch.from_numpy(tau_out).to(dev))
    return ret[0] if len(ret) == 1 else tuple(ret)


def score_tiled_bmp_grouped(queries: SparseBatch, index: TiledIndex, k: int,
                            **kw):
    """Demand-grouped BMP traversal, one ``bmp_scan`` launch per padded
    group (:func:`repro.core.scoring.score_tiled_bmp_grouped`); the
    keywords and returns of :func:`grouped_sweeps`."""
    return grouped_sweeps(queries, index, k, stacked=False, **kw)
