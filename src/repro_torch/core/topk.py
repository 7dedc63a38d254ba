"""Exact top-k selection with ``lax.top_k``'s tie order.

``jax.lax.top_k`` returns values in descending order and breaks ties
towards the lower index; ``torch.topk`` promises no order among equal
values (on CUDA it varies).  Every selection here therefore takes
``torch.topk``'s candidates, repairs the set where the k-th value is tied
beyond k, and orders the result by (value descending, index ascending)
with two stable sorts — so the port returns the JAX package's ids.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils import cdiv

NEG_INF = float("-inf")


def _by_value_then_key(x: torch.Tensor, pos: torch.Tensor, key: torch.Tensor):
    """Reorder candidate positions ``pos`` of rows ``x`` by (value desc,
    ``key`` asc), with two stable sorts."""
    pos = pos.gather(-1, torch.argsort(key.gather(-1, pos), dim=-1,
                                       stable=True))
    order = torch.argsort(x.gather(-1, pos), dim=-1, descending=True,
                          stable=True)
    return pos.gather(-1, order)


# Rows of a selection by position done at once: bounds its scratch (a
# mask of the row's entries at or above its k-th value) to 2^27 entries a
# step whatever the row length ([500, 8.8M] scores at serve_8m).
_TIE_ELEMS = 1 << 27


def _positions_at_or_above(x: torch.Tensor, kth: torch.Tensor,
                           k: int) -> torch.Tensor:
    """[R, k] positions of each row's top-k set, ties at the row's k-th
    value ``kth`` [R, 1] to the lower position: every entry above it, then
    the first entries equal to it.  Ascending positions.  One pass over the
    rows: their entries at or above ``kth`` (about k of them a row, more
    where the k-th value ties, as bf16 scores do in most rows), a few rows
    at a time."""
    rows, n = x.shape
    out = torch.empty((rows, k), dtype=torch.long, device=x.device)
    step = max(1, _TIE_ELEMS // max(n, 1))
    for s in range(0, rows, step):
        xs, ks = x[s:s + step], kth[s:s + step]
        r, p = (xs >= ks).nonzero(as_tuple=True)  # row-major: p ascends  # lint: disable=host-sync -- the tie repair: each row's entries at or above its k-th value, a count only the data gives
        m = xs.shape[0]
        gt = xs[r, p] > ks[r, 0]
        eq = ~gt
        # Each tied entry's rank among its row's tied entries.
        per_row = torch.bincount(r, weights=eq.double(), minlength=m).long()
        before = torch.cumsum(per_row, 0) - per_row
        rank = torch.cumsum(eq.long(), 0) - before[r]
        need = k - torch.bincount(r[gt], minlength=m)
        keep = gt | (eq & (rank <= need[r]))
        out[s:s + step] = p[keep].view(m, k)
    return out


def _topk_lower_key(scores: torch.Tensor, k: int, key=None,
                    ordered: bool = True):
    """(values, positions) of the top ``k`` along the last axis, ties to
    the lower ``key`` (the position when None), as ``lax.top_k`` does;
    ``k <= scores.shape[-1]``.  ``ordered=False`` returns the exact set in
    no particular order."""
    *lead, n = scores.shape
    x = scores.reshape(-1, n)
    by_position = key is None
    key = (torch.arange(n, device=x.device).expand_as(x) if key is None
           else key.reshape(-1, n))
    vals, pos = torch.topk(x, k, dim=-1, sorted=False)
    if x.shape[0] and k and not x.is_meta:  # meta holds no value to tie
        kth = vals.min(dim=-1, keepdim=True).values
        if by_position:
            # The exact set by position, tied or not: topk may have picked
            # an arbitrary subset of a tie at the k-th value.
            pos = _positions_at_or_above(x, kth, k)
        else:
            # Rows where more than k entries reach the k-th value: take
            # the tie's lowest keys.
            tied = torch.nonzero((x >= kth).sum(dim=-1) > k).squeeze(1)  # lint: disable=host-sync -- the tie repair: the rows whose k-th value ties, a count only the data gives
            if tied.numel():
                full = torch.arange(n, device=x.device).expand(
                    tied.numel(), n)
                pos[tied] = _by_value_then_key(x[tied], full,
                                               key[tied])[:, :k]
    if ordered:
        pos = _by_value_then_key(x, pos, key)
    return x.gather(-1, pos).reshape(*lead, k), pos.reshape(*lead, k)


def topk(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain exact top-k over the last axis -> (values, indices)."""
    return _topk_lower_key(scores, min(k, scores.shape[-1]))


def partial_topk_threshold(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row k-th best score over a subset of the collection (others
    masked to ``-inf``): at least k documents score ``>=`` it, so a
    document provably below it cannot enter the exact top-k
    (:func:`repro.core.topk.partial_topk_threshold`)."""
    k = min(k, scores.shape[-1])
    return torch.topk(scores, k, dim=-1).values[..., -1]


def update_topk_heap(heap_vals: torch.Tensor, new_vals: torch.Tensor,
                     k: int | None = None):
    """Fold newly scored values [..., m] into a descending top-k value heap
    [..., k] (``-inf`` in unfilled slots) -> (heap, its k-th value), the
    running threshold of the BMP sweep
    (:func:`repro.core.topk.update_topk_heap`).  Values only: any exact
    selection returns ``lax.top_k``'s values, whatever its tie order."""
    if k is None:
        k = heap_vals.shape[-1]
    merged = torch.cat([heap_vals, new_vals], dim=-1)
    heap = torch.topk(merged, k, dim=-1).values
    return heap, heap[..., -1]


def certify_tau(vals, k_req: int, prev=None) -> np.ndarray:
    """Advance a per-query certified threshold from a top-k result.

    ``vals`` [B, k_ret] are sorted top-k values over everything a query
    stream has seen so far; the threshold moves up to the ``k_req``-th
    best value only when it exists and is finite.  Returns
    ``max(prev, certified k-th)`` as f32 numpy (host-side serving state),
    as :func:`repro.core.topk.certify_tau`.
    """
    vals = vals.cpu().numpy() if torch.is_tensor(vals) else np.asarray(vals)
    b = vals.shape[0]
    prev = (np.full((b,), -np.inf, np.float32) if prev is None
            else np.asarray(prev, np.float32))
    if vals.shape[1] >= k_req:
        kth = vals[:, k_req - 1]
    else:
        kth = np.full((b,), -np.inf, np.float32)
    tau = np.maximum(prev, np.where(np.isfinite(kth), kth, -np.inf))
    return tau.astype(np.float32)


def topk_two_stage(
    scores: torch.Tensor, k: int, block: int = 4096
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise top-k then merge: stage 1 reduces each length-``block``
    slab to its top-k, stage 2 takes the top-k of the survivors.  Ties go
    to the lower index in both stages: stage 1 picks each slab's exact set
    (lowest indices among a tie at its k-th value), stage 2 breaks ties on
    the survivors' global indices — so the result equals :func:`topk`, and
    ``repro.core.topk.topk_two_stage``, whose stage 2 breaks ties on
    position in stage 1's ordered output."""
    *lead, n = scores.shape
    k = min(k, n)
    if n <= block:
        return _topk_lower_key(scores, k)
    nb = cdiv(n, block)
    pad = nb * block - n
    if pad:
        scores = torch.cat(
            [scores, scores.new_full((*lead, pad), NEG_INF)], dim=-1
        )
    blocked = scores.reshape(*lead, nb, block)
    kb = min(k, block)
    vals, idx = _topk_lower_key(blocked, kb, ordered=False)  # [..., nb, kb]
    base = torch.arange(nb, device=scores.device)[:, None] * block
    vals = vals.reshape(*lead, nb * kb)
    gidx = (idx + base).reshape(*lead, nb * kb)
    mvals, mpos = _topk_lower_key(vals, k, key=gidx)
    return mvals, gidx.gather(-1, mpos)


def merge_topk(
    vals_a: torch.Tensor,
    ids_a: torch.Tensor,
    vals_b: torch.Tensor,
    ids_b: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two (value, id) top-k lists into one; ties keep list a's
    entries first, then position order."""
    vals = torch.cat([vals_a, vals_b], dim=-1)
    ids = torch.cat([ids_a, ids_b], dim=-1)
    mv, mp = _topk_lower_key(vals, min(k, vals.shape[-1]))
    return mv, ids.gather(-1, mp)


def topk_with_ids(scores: torch.Tensor, ids: torch.Tensor, k: int):
    v, p = _topk_lower_key(scores, min(k, scores.shape[-1]))
    return v, ids.gather(-1, p)


def local_topk(scores: torch.Tensor, doc_offset: int, k: int):
    """A shard's local top-k over [B, N_s] scores -> (values [B, kk],
    global ids [B, kk] int32), kk = min(k, N_s): positions shifted by the
    shard's first global id, ties to the lower id."""
    kk = min(k, scores.shape[-1])
    lv, li = _topk_lower_key(scores, kk)
    return lv, li.to(torch.int32) + doc_offset


def gather_shards(x: torch.Tensor, group=None) -> torch.Tensor:
    """[S, ...] every rank's ``x`` in rank order over ``group``
    (``torch.distributed``'s list ``all_gather``, which gloo and NCCL both
    take); ``x[None]`` at world size 1 with no process group."""
    import torch.distributed as dist

    if group is None and not (dist.is_available() and dist.is_initialized()):
        return x[None]
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


def merge_gathered(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """Merge gathered per-shard top-ks ``vals``/``ids`` [S, B, kk] into the
    global top-k [B, min(k, S * kk)]: the concatenation in shard order,
    ties to the lower global id (shard order, then each shard's own order:
    the lower position ``lax.top_k`` gives in
    :func:`repro.core.topk.local_then_global_topk`)."""
    s, b, kk = vals.shape
    av = vals.permute(1, 0, 2).reshape(b, s * kk)
    ai = ids.permute(1, 0, 2).reshape(b, s * kk)
    mv, mp = _topk_lower_key(av, min(k, s * kk), key=ai)
    return mv, ai.gather(-1, mp)


def local_then_global_topk(local_scores: torch.Tensor, doc_offset: int,
                           k: int, group=None, hierarchical: bool = True):
    """Local top-k -> the collective -> merge: the replicated global
    ([B, k] values, [B, k] global ids) of document-sharded scoring
    (:func:`repro.core.topk.local_then_global_topk`).  Exact: a merge of
    exact per-shard top-ks is an exact top-k.  ``hierarchical`` merges one
    mesh axis at a time in JAX; a process group is one flat axis, where it
    changes nothing."""
    del hierarchical  # one flat group: a single gather either way
    lv, gi = local_topk(local_scores, doc_offset, k)
    return merge_gathered(gather_shards(lv, group), gather_shards(gi, group),
                          k)
