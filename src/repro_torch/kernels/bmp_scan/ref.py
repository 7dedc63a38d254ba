"""Plain PyTorch version of the BMP sweep kernel.

:func:`bmp_sweep_ref` is one group's sweep, the port's counterpart of
:func:`repro.core.scoring._bmp_sweep_impl` written as plain torch: a host
loop over rank steps; in each, the retire test, the deduplicated demand
set, the chunk runs of the demanded blocks (scored through
``scatter_score``'s plain version, in the same order), the window fold
into the top-k value heap (``update_topk_heap``) and the ratchet of tau.
It returns the kernel's outputs for one group — raw scores, heap, the
scored block and chunk masks and the step count — from which the callers
derive the masked scores and ``tau = max(tau0, heap[:, -1])``, as
``_bmp_sweep_impl`` returns them.

:func:`bmp_scan_ref` runs it per padded group of a plan and returns the
per-group fetch sets (``repro.kernels.bmp_scan.ref.bmp_scan_ref``).

bf16 weights and values follow the scoring kernels' contract: widened to
f32 (every product exact), summed in f32, and each block's window rounded
once to bf16 when it is complete, before it enters the f32 heap; the
retire test then takes the wider margin of :data:`MARGIN_REL`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.topk import update_topk_heap
from repro_torch.kernels.scatter_score.ref import run_chunks, scatter_chunks

NEG_INF = float("-inf")

# The retire and prune tests keep a block while theta * ub >= tau -
# (MARGIN_REL * |tau| + 1e-6).  f32: the bound and the scores sum the same
# products in different orders, a few ulps apart in a near-tie.  bf16 adds
# three roundings a bound built from the f32 values does not see: a value
# rounded to bf16 grows by up to 2^-8 of itself, a query weight is rounded
# before the bound is formed (so the bound sees it), and a score rounded
# once to bf16 grows by up to 2^-8.  So a score is at most (1 + 2^-8)^2 (1
# + d) ub, d the f32 error the 1e-4 covers, and a block whose every doc
# could tie tau or beat it (a tie with a lower id enters the top-k) has ub
# >= tau / (1 + 2^-8)^2 (1 + d) > tau - (2^-7 + 2^-15 + 1e-4) |tau|; 2^-6
# covers that with room to spare.
MARGIN_REL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}


def prune_margin(tau: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """The keep test's envelope below ``tau`` for scores of ``dtype``."""
    return MARGIN_REL[dtype] * tau.abs() + 1e-6


def round_scores(scores: torch.Tensor, dtype) -> torch.Tensor:
    """f32 ``scores`` as the ``dtype`` route keeps them: bf16 rounds each
    once to the nearest bf16 (ties to even), held in f32."""
    if dtype == torch.bfloat16:
        return scores.to(torch.bfloat16).float()
    return scores


def bmp_sweep_ref(
    qw: torch.Tensor,  # f32 or bf16 [b, V_pad]
    order: torch.Tensor,  # int32 [b, n_db] descending-bound block order
    ub_sorted: torch.Tensor,  # f32 [b, n_db] bounds in that order
    tau0: torch.Tensor,  # f32 [b]
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
    """One group's BMP sweep -> ``(scores [b, n_pad] raw, heap [b, k_eff]
    descending, block_scored [n_db] bool, chunk_scored [num_chunks] bool,
    steps)``.

    While some row is alive (at most ``n_db`` steps), step ``i``: rows
    whose scaled bound ``theta * ub_sorted[:, i]`` falls below ``tau -
    prune_margin(tau)`` retire for good; the alive rows' rank-i blocks not
    scored yet are scored for every row (bf16: and rounded); each alive row
    folds its rank-i block's window (``-inf`` outside real, alive docs)
    into its heap, and tau rises to the heap's k-th value."""
    dtype = qw.dtype
    qw, value = qw.float(), value.float()
    dev = qw.device
    b, n_db = order.shape
    n_pad = n_db * doc_block
    real = torch.arange(n_pad, device=dev) < num_docs
    if alive_doc is not None:
        real[:num_docs] &= alive_doc
    scores = torch.zeros((b, n_pad), dtype=torch.float32, device=dev)
    heap = torch.full((b, k_eff), NEG_INF, dtype=torch.float32, device=dev)
    tau = tau0.to(torch.float32).clone()
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    # Index n_db is the invalid-block sentinel: always "scored".
    block_scored = torch.zeros(n_db + 1, dtype=torch.bool, device=dev)
    block_scored[n_db] = True
    chunk_scored = torch.zeros(local_term.shape[0], dtype=torch.bool,
                               device=dev)
    win = torch.arange(doc_block, device=dev)
    steps = 0
    while steps < n_db and bool(alive.any()):
        i = steps
        alive &= theta * ub_sorted[:, i] >= tau - prune_margin(tau, dtype)
        blk = order[:, i].long()
        fresh = alive & ~block_scored[torch.where(alive, blk, n_db)]
        demand = torch.unique(blk[fresh])
        if demand.numel():
            count = torch.zeros_like(block_chunk_count)
            count[demand] = block_chunk_count[demand]
            chunks = run_chunks(block_chunk_start, count)
            scatter_chunks(scores, qw, local_term, local_doc, value,
                           chunk_term_block, chunk_doc_block, chunks,
                           term_block=term_block, doc_block=doc_block)
            if dtype != torch.float32:
                done = (demand[:, None] * doc_block + win).reshape(-1)
                scores[:, done] = round_scores(scores[:, done], dtype)
            block_scored[demand] = True
            chunk_scored[chunks] = True
        cols = (torch.where(alive, blk, 0) * doc_block)[:, None] + win
        w = torch.where(alive[:, None] & real[cols], scores.gather(1, cols),
                        NEG_INF)
        heap, kth = update_topk_heap(heap, w)
        tau = torch.maximum(tau, kth)
        steps = i + 1
    return scores, heap, block_scored[:n_db], chunk_scored, steps


def bmp_scan_ref(queries, index, k: int, groups, theta: float = 1.0,
                 tau_init=None):
    """Per-group sweep of a plan -> ``(out [B, N], tau [B], per_group)``,
    where ``per_group`` lists (in ``groups`` order) each group's ``rows``,
    ``block_scored``/``chunk_scored`` bool masks and ``steps`` — the fetch
    sets the kernel must reproduce exactly."""
    from repro_torch.core import scoring
    from repro_torch.sched import planner as planner_mod

    qw = scoring._pad_queries_to_term_blocks(queries, index)
    b = qw.shape[0]
    k_eff = max(min(k, index.num_docs), 1)
    ub = scoring.block_upper_bounds(queries, index, qw=qw)
    groups = planner_mod.validate_groups(groups, b)
    tau0 = scoring._tau0(tau_init, b, "cpu").numpy()
    out = torch.full((b, index.num_docs), NEG_INF, device=qw.device)
    tau_out = tau0.copy()
    per_group = []
    for g, sel, tau_g in planner_mod.padded_group_rows(groups, tau0):
        sel_t = torch.from_numpy(sel).to(qw.device)
        u = ub[sel_t]
        order = torch.argsort(-u, dim=-1, stable=True)
        scores, heap, bsc, csc, steps = bmp_sweep_ref(
            qw[sel_t], order, u.gather(-1, order),
            torch.from_numpy(tau_g).to(qw.device),
            index.block_chunk_start, index.block_chunk_count,
            index.chunk_term_block, index.chunk_doc_block,
            index.local_term, index.local_doc, index.value,
            term_block=index.term_block, doc_block=index.doc_block,
            k_eff=k_eff, theta=theta, num_docs=index.num_docs,
        )
        mask = scoring._doc_mask(bsc, index.doc_block, index.num_docs, None)
        rows = torch.from_numpy(g).to(qw.device)
        out[rows] = torch.where(mask, scores[: len(g), : index.num_docs],
                                NEG_INF)
        tau = torch.maximum(torch.from_numpy(tau_g), heap[:, -1].cpu())
        tau_out[g] = tau[: len(g)].numpy()
        per_group.append(dict(rows=g, block_scored=bsc.cpu().numpy(),
                              chunk_scored=csc.cpu().numpy(), steps=steps))
    return out, tau_out, per_group
