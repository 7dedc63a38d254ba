"""Demand planner: cluster queries by which doc blocks they will demand.

The BMP sweep visits doc blocks per query in descending upper-bound order,
so a query's near-term *demand set* is readable before any scoring happens:
it is the prefix of its bound-sorted block list.  Two queries whose demand
sets overlap can share one sweep almost for free (a block demanded by both
is scored once for the pair); two queries with disjoint demand force each
other to ride along through chunks they never wanted.

:func:`plan_micro_batches` turns that observation into micro-batches:

1. **Signature** — each query's top-``m`` demanded blocks by upper bound
   (:func:`demand_signatures`), the same ``ub`` the sweep itself sorts.
2. **Cost model** — a block costs ``block_chunk_count[block]`` chunk
   executions (the index's per-block chunk runs), so overlap is measured
   in the unit the sweep actually pays: shared chunk work.
3. **Greedy grouping** — queries are visited in descending demand cost;
   each joins the open group sharing the largest chunk cost with it
   (requiring at least ``min_share`` of its own cost to be shared, and
   respecting ``max_group``), else opens a new group.

The plan is host-side numpy over the already-computed ``[B, n_db]`` bound
matrix (copied to the host by the caller) — no device work, and
deterministic for a given input.  Any partition of the batch is *correct* (per-query BMP trajectories are
cohort-independent; see ``score_tiled_bmp_grouped``); the planner only
decides how much chunk work the partition saves.

A numpy copy of :mod:`repro.sched.planner`, with the same semantics, tie
rules and :data:`PAD_TAU`; the port imports nothing of ``repro``.  Not
here yet: the ``obs`` span of :func:`plan_with_cache` (with the obs
slice) and ``store_plan_token`` (with the store slice).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Hashable, Optional, Sequence

import numpy as np


# Monotonic tokens stamped onto index objects by PlanCache.stream_key:
# unlike id(), a token dies with its index, so object-id recycling can
# never alias a stale plan.
_INDEX_TOKENS = itertools.count()


def demand_signatures(
    ub: np.ndarray, top_m: int = 8
) -> list[np.ndarray]:
    """Per-query demand signature: the top-``m`` doc blocks by upper bound.

    ``ub`` [B, n_db] is the planner's view of the sweep's own visit order.
    Blocks with bound ``<= 0`` are excluded while the row has positively
    bounded demand: a zero bound cannot beat a *positive* threshold, so
    they are visited only if the query's running tau goes (or stays)
    negative — possible with signed weights, where the true k-th score can
    be below zero.  A row with NO positive bound therefore keeps its raw
    top-``m`` visit-order prefix instead of an empty signature: such a
    query may demand every block, and calling it demand-free would bolt it
    onto an arbitrary group.  Either way only grouping quality and the
    ``DemandPlan`` forecast are at stake — any partition scores exactly.
    """
    ub = np.asarray(ub)
    b, n_db = ub.shape
    m = max(min(top_m, n_db), 1)
    order = np.argsort(-ub, axis=1, kind="stable")[:, :m]
    sigs = []
    for row in range(b):
        blocks = order[row]
        sig = np.sort(blocks[ub[row, blocks] > 0.0]).astype(np.int32)
        if sig.size == 0:
            sig = np.sort(blocks).astype(np.int32)
        sigs.append(sig)
    return sigs


@dataclasses.dataclass
class DemandPlan:
    """A micro-batch partition of a query batch, with its cost forecast.

    ``groups`` is an exact partition of rows ``0..B-1`` (every row in
    exactly one group, original row order preserved within a group).  The
    ``est_*`` fields forecast chunk work under the signature cost model:
    *flat* pays every demanded chunk for all ``B`` queries, *grouped* pays
    each group's union only for its own members.  The real saving is
    measured post-hoc by ``SchedStats.chunk_work`` — the forecast only
    ranks partitions.
    """

    groups: list[np.ndarray]  # row-index arrays, a partition of range(B)
    signatures: list[np.ndarray]  # per-query demanded block ids
    est_chunks_flat: int  # |union of all signatures| cost x B
    est_chunks_grouped: int  # sum_g |union of group signatures| cost x b_g

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    @property
    def group_sizes(self) -> tuple[int, ...]:
        return tuple(len(g) for g in self.groups)

    @property
    def est_reduction(self) -> float:
        """Forecast fraction of flat chunk work the grouping saves."""
        if self.est_chunks_flat <= 0:
            return 0.0
        return 1.0 - self.est_chunks_grouped / self.est_chunks_flat


def _union_cost(blocks: np.ndarray, block_cost: np.ndarray) -> int:
    return int(block_cost[blocks].sum()) if blocks.size else 0


def plan_micro_batches(
    ub: np.ndarray,
    block_cost: np.ndarray,
    top_m: int = 8,
    max_group: Optional[int] = None,
    min_share: float = 0.5,
) -> DemandPlan:
    """Greedy signature grouping -> :class:`DemandPlan`.

    ``ub`` [B, n_db] per-query block upper bounds (any layout the caller
    likes — the single-index ``block_upper_bounds`` or the sharded path's
    shard-concatenated bounds); ``block_cost`` [n_db] chunk executions per
    block (``TiledIndex.block_chunk_count``, flattened for sharded).

    ``min_share`` is the join threshold: a query joins an existing group
    only if the group already demands at least that fraction of the
    query's own signature cost (0.0 = always join the best open group —
    one flat group; 1.0 = join only on full containment).  ``max_group``
    caps members per group (``None`` = uncapped).  Rows with no positive
    bound carry their raw visit-order prefix (see
    :func:`demand_signatures`), so they cluster with each other instead of
    inflating a real group's union; a degenerate empty signature still
    joins the first open group, since the plan must stay a partition.
    """
    ub = np.asarray(ub)
    block_cost = np.asarray(block_cost)
    if ub.ndim != 2:
        raise ValueError(f"ub must be [B, n_db], got shape {ub.shape}")
    if block_cost.shape != (ub.shape[1],):
        raise ValueError(
            f"block_cost must be [n_db={ub.shape[1]}], got "
            f"{block_cost.shape}"
        )
    if max_group is not None and max_group < 1:
        raise ValueError(f"max_group must be >= 1, got {max_group}")
    if not 0.0 <= min_share <= 1.0:
        raise ValueError(f"min_share must be in [0, 1], got {min_share}")
    b = ub.shape[0]
    sigs = demand_signatures(ub, top_m=top_m)
    costs = np.asarray([_union_cost(s, block_cost) for s in sigs])

    # Greedy pass, costliest queries first: they anchor the groups the
    # cheaper queries then snap onto.  Ties broken by row id (stable).
    visit = np.argsort(-costs, kind="stable")
    members: list[list[int]] = []
    unions: list[np.ndarray] = []
    for row in visit:
        sig = sigs[row]
        best, best_share = -1, -1
        for gi, gsig in enumerate(unions):
            if max_group is not None and len(members[gi]) >= max_group:
                continue
            share = _union_cost(np.intersect1d(sig, gsig), block_cost)
            if share > best_share:
                best, best_share = gi, share
        if best >= 0 and best_share >= min_share * costs[row]:
            members[best].append(int(row))
            unions[best] = np.union1d(unions[best], sig)
        else:
            members.append([int(row)])
            unions.append(sig)

    groups = [np.asarray(sorted(m), dtype=np.int64) for m in members]
    groups.sort(key=lambda g: int(g[0]))  # deterministic group order
    all_union = (
        np.unique(np.concatenate([s for s in sigs if s.size]))
        if any(s.size for s in sigs) else np.zeros(0, np.int32)
    )
    est_flat = _union_cost(all_union, block_cost) * b
    est_grouped = 0
    for g in groups:
        gsigs = [sigs[int(r)] for r in g if sigs[int(r)].size]
        gu = np.unique(np.concatenate(gsigs)) if gsigs else np.zeros(0, np.int32)
        est_grouped += _union_cost(gu, block_cost) * len(g)
    return DemandPlan(
        groups=groups, signatures=sigs,
        est_chunks_flat=est_flat, est_chunks_grouped=est_grouped,
    )


class PlanCache:
    """Memoized demand plans, keyed by query-stream signature.

    A serving tier replays the same query streams continuously, so
    planning from scratch on every call repeats work.  The cache keys a :class:`DemandPlan` on the
    query batch's content signature plus the index object it was planned
    against; :meth:`set_epoch` clears everything when the retriever's
    ``epoch`` bumps (a destructive rebuild invalidates every plan, the
    same contract as the session tau cache).

    ``max_entries`` bounds the cache with LRU eviction — a serving tier
    sees unboundedly many distinct query batches, so per-stream state
    must not grow with them (the same argument as
    ``SearchSession(max_entries=)``); an evicted stream simply replans.

    Staleness is only ever a *performance* event: any partition of the
    batch scores exactly (the grouped/fused engines' cohort-independence
    argument), so a plan reused against a mutated-but-same-id index can
    waste chunk work but never change the top-k.  Appends
    (``add_docs``) build new segments — new index objects, new keys — so
    they miss rather than go stale.
    """

    def __init__(self, max_entries: int = 256):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        import collections

        self.max_entries = max_entries
        self._plans: "collections.OrderedDict" = collections.OrderedDict()
        self._epochs: dict = {}  # per-owner last-seen epoch
        self.plans_computed = 0  # observability: cold plans built
        self.hits = 0  # observability: serve calls that reused a plan
        self.evictions = 0  # observability: replans forced by the bound

    def __len__(self) -> int:
        return len(self._plans)

    def set_epoch(self, epoch: Hashable, owner=None) -> None:
        """Invalidate everything when ``owner``'s lifecycle token *changes*.

        ``epoch`` is any hashable lifecycle token compared by equality —
        the scheduler passes ``(retriever.epoch, retriever.mutation)`` so
        both destructive rebuilds *and* deletions flush memoized plans
        (deletion staleness is perf-only, but a pre-deletion demand plan
        keeps scheduling mostly-dead blocks).

        ``owner`` (e.g. ``id(retriever)``) keeps two retrievers sharing
        one cache from thrashing it: a clear happens only when a given
        owner's epoch moves, not whenever two owners' stable epochs
        merely differ.  Conservative by design — one owner's rebuild
        clears every owner's plans (entries are not owner-tagged), which
        costs a replan, never correctness.
        """
        known = owner in self._epochs
        if known and self._epochs[owner] == epoch:
            return
        if known:  # this owner's epoch moved: its plans are stale
            self._plans.clear()
        # First sight of an owner never clears — nothing of its making is
        # cached yet, and wiping other owners' plans here is exactly the
        # alternating-scheduler thrash this method must avoid.
        self._epochs[owner] = epoch

    @staticmethod
    def stream_key(queries, index, extra: tuple = ()) -> tuple:
        """Signature of (query stream, index[, knobs]) a plan is valid for.

        The index is identified by a token stamped on the object itself
        (monotonic counter, assigned on first use) — unlike ``id()``, a
        token dies with its index, so a recycled object id can never
        alias a stale plan.  ``extra`` folds in whatever else the plan
        depends on (the call sites pass their planner knobs).
        """
        tok = getattr(index, "_plan_cache_token", None)
        if tok is None:
            tok = next(_INDEX_TOKENS)
            try:
                index._plan_cache_token = tok
            except AttributeError:  # slotted/frozen index: fall back
                tok = id(index)
        ids = queries.term_ids.cpu().numpy()
        vals = queries.values.cpu().numpy()
        return (
            tok, ids.shape,
            hash(ids.tobytes()), hash(vals.tobytes()), extra,
        )

    def get_or_plan(self, key, plan_fn) -> DemandPlan:
        """Return the cached plan for ``key`` or compute-and-remember."""
        plan = self._plans.get(key)
        if plan is not None:
            self.hits += 1
            self._plans.move_to_end(key)
            return plan
        plan = plan_fn()
        self.plans_computed += 1
        self._plans[key] = plan
        while len(self._plans) > self.max_entries:
            self._plans.popitem(last=False)
            self.evictions += 1
        return plan


def plan_with_cache(plan_cache, queries, index, plan_fn,
                    knobs: tuple = ()) -> DemandPlan:
    """The one memoization idiom every planning call site shares.

    ``plan_fn`` builds the :class:`DemandPlan` cold; ``knobs`` are the
    planner parameters the plan depends on (part of the cache key, so one
    cache can serve differently-configured callers); ``plan_cache=None``
    means plan every call.
    """
    if plan_cache is None:
        return plan_fn()
    return plan_cache.get_or_plan(
        plan_cache.stream_key(queries, index, extra=knobs), plan_fn
    )


def bucketed_group_rows(groups: Sequence[np.ndarray], tau0: np.ndarray):
    """:func:`padded_group_rows` grouped by padded size, stacked.

    Yields ``(size, entries, sel_stack, tau_stack)`` per power-of-two
    bucket in ascending size order, where ``entries`` is a list of
    ``(group_index, rows)`` and ``sel_stack``/``tau_stack`` are the
    ``[G, size]`` stacked row selectors / warm-start thresholds: one
    ``bmp_scan`` kernel launch per bucket
    (``repro_torch.kernels.bmp_scan.ops.bmp_scan``).
    """
    buckets: dict = {}
    for gi, (g, sel, tau_g) in enumerate(padded_group_rows(groups, tau0)):
        buckets.setdefault(len(sel), []).append((gi, g, sel, tau_g))
    for size in sorted(buckets):
        rows = buckets[size]
        yield (
            size,
            [(gi, g) for gi, g, _, _ in rows],
            np.stack([sel for _, _, sel, _ in rows]),
            np.stack([t for _, _, _, t in rows]),
        )


# Finite "retire immediately" threshold for batch-padding rows in a
# grouped sweep: large enough that no real bound beats it, finite so the
# retire test's tau-margin arithmetic stays NaN-free (inf - inf).
PAD_TAU = float(np.finfo(np.float32).max) / 4


def padded_group_rows(groups: Sequence[np.ndarray], tau0: np.ndarray):
    """Yield ``(rows, sel, tau_g)`` per group, padded for sweep execution.

    The one group-iteration protocol both grouped paths (single-index
    ``score_tiled_bmp_grouped`` and the sharded serve factory) share, so
    the padding contract lives in exactly one place: each group's row
    selector ``sel`` is padded to the next power of two with row-0 clones
    whose ``tau_g`` entry is :data:`PAD_TAU` — they retire before
    demanding a single block, and power-of-two buckets bound both the
    compile count (one sweep shape per bucket) and the executed pad work
    (< 2x the live rows).  Callers keep rows ``sel[:len(rows)]`` of each
    result and drop the pad rows.
    """
    for g in groups:
        g = np.asarray(g, dtype=np.int64)
        size = 1 << (len(g) - 1).bit_length()
        pad = size - len(g)
        sel = np.concatenate([g, np.zeros(pad, np.int64)])
        tau_g = np.concatenate(
            [np.asarray(tau0, np.float32)[g],
             np.full(pad, PAD_TAU, np.float32)]
        )
        yield g, sel, tau_g


def validate_groups(groups: Sequence[np.ndarray], batch: int) -> list[np.ndarray]:
    """Check that ``groups`` is an exact partition of ``range(batch)``.

    Shared by the grouped scorer and the sharded serve step so a malformed
    caller-supplied grouping fails loudly instead of silently dropping or
    double-scoring queries.
    """
    groups = [np.asarray(g, dtype=np.int64).reshape(-1) for g in groups]
    flat = np.concatenate(groups) if groups else np.zeros(0, np.int64)
    if (len(flat) != batch or len(np.unique(flat)) != batch
            or (batch and (flat.min() < 0 or flat.max() >= batch))):
        raise ValueError(
            f"groups must partition the {batch} query rows exactly; got "
            f"{[g.tolist() for g in groups]}"
        )
    if any(g.size == 0 for g in groups):
        raise ValueError("empty groups are not allowed")
    return groups
