"""Adapters folding the serve path's stat islands into one registry
(a copy of :mod:`repro.obs.collect`, with the same metric names).

Before this module the serve path's observability lived in five
disconnected places: ``PruneStats`` / ``SchedStats`` (scoring),
``SegmentPager.stats()`` (store), ``PlanCache`` hit/eviction counters
(sched), ``SearchSession.evictions`` (session), and the queue's
depth/late accounting.  Each adapter here copies one island into a
:class:`~repro_torch.obs.metrics.MetricsRegistry` so a single
``obs_snapshot()`` tells the whole story.

Folding rule: islands keep their own *cumulative* counters, and a
snapshot may be taken many times, so adapters publish island values as
**gauges** (set-latest; snapshot merge takes max, which for cumulative
readings is the newest).  Obs-native live events (kernel launches,
deadline misses) are counters incremented at the event site instead —
never both, so nothing double-counts.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs.metrics import MetricsRegistry

__all__ = [
    "collect_plan_cache",
    "collect_pager",
    "collect_session",
    "collect_queue",
    "collect_prune_stats",
    "collect_sched_stats",
]

#: keys `SegmentPager.stats()` reports; zeroed when not store-backed so
#: a snapshot always carries the pager metric family.
_PAGER_KEYS = (
    "hits", "misses", "evictions", "prefetches", "prefetch_skipped",
    "bytes_loaded", "bytes_evicted", "resident_bytes",
    "resident_segments", "budget_bytes",
)


def collect_plan_cache(reg: MetricsRegistry, cache) -> None:
    """Fold ``repro_torch.sched.planner.PlanCache`` counters (no-op on None)."""
    if cache is None:
        return
    hits = int(getattr(cache, "hits", 0))
    computed = int(getattr(cache, "plans_computed", 0))
    reg.gauge("plan.cache.hits").set(hits)
    reg.gauge("plan.cache.computed").set(computed)
    reg.gauge("plan.cache.evictions").set(getattr(cache, "evictions", 0))
    reg.gauge("plan.cache.size").set(len(cache))
    total = hits + computed
    reg.gauge("plan.cache.hit_rate").set(hits / total if total else 0.0)


def collect_pager(reg: MetricsRegistry, stats: Optional[dict]) -> None:
    """Fold ``SegmentPager.stats()`` (zeros when not store-backed)."""
    stats = stats or {}
    for key in _PAGER_KEYS:
        reg.gauge(f"pager.{key}").set(stats.get(key, 0))
    for key in stats:  # forward-compat: keep keys this module predates
        if key not in _PAGER_KEYS:
            reg.gauge(f"pager.{key}").set(stats[key])


def collect_session(reg: MetricsRegistry, session) -> None:
    """Fold ``SearchSession`` cache occupancy / evictions / demotions."""
    if session is None:
        return
    reg.gauge("session.cache.entries").set(len(session))
    reg.gauge("session.cache.evictions").set(getattr(session, "evictions", 0))
    reg.gauge("session.cache.demotions").set(getattr(session, "demotions", 0))


def collect_queue(reg: MetricsRegistry, scheduler) -> None:
    """Fold ``QueryScheduler`` queue state (depth is a live reading)."""
    if scheduler is None:
        return
    reg.gauge("sched.queue_depth").set(len(scheduler.queue))
    reg.gauge("sched.served_total").set(getattr(scheduler, "served", 0))


def collect_prune_stats(reg: MetricsRegistry, stats) -> None:
    """Fold a ``PruneStats`` (flat BMP sweep skip accounting)."""
    if stats is None:
        return
    reg.gauge("prune.num_doc_blocks").set(stats.num_doc_blocks)
    reg.gauge("prune.blocks_scored").set(stats.blocks_scored)
    reg.gauge("prune.chunks_total").set(stats.chunks_total)
    reg.gauge("prune.chunks_scored").set(stats.chunks_scored)
    reg.gauge("prune.block_skip_frac").set(stats.block_skip_frac)
    reg.gauge("prune.chunk_skip_frac").set(stats.chunk_skip_frac)


def collect_sched_stats(reg: MetricsRegistry, stats) -> None:
    """Fold a ``SchedStats`` (grouped/fused engine dispatch accounting)."""
    if stats is None:
        return
    reg.gauge("sched.groups").set(len(stats.group_sizes))
    reg.gauge("sched.kernel_launches").set(stats.launches)
    reg.gauge("sched.chunk_work").set(stats.chunk_work)
    reg.gauge("sched.chunks_scored_union").set(stats.chunks_scored_union)
