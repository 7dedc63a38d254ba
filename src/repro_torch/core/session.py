"""Stateful serving API: :class:`Retriever` + :class:`SearchSession`
(:mod:`repro.core.session` on PyTorch).

The ROADMAP's "warm-start beyond streams" item: the serving tier — not the
caller — owns the index, the compiled scoring step, and the per-query-
stream thresholds that make BMP-style pruning pay off across batches
(Mallia et al., *Faster Learned Sparse Retrieval with Block-Max Pruning*,
2024; guided traversal shows threshold estimation belongs to the server).

``Retriever`` holds a growable segmented index: the initial corpus is
segment 0, every ``add_docs`` batch appends as a fresh segment whose
documents occupy whole new doc blocks (the tiled builders pad each
segment's tail block, so existing blocks are never rewritten).  ``search``
sweeps the segments with the stream's running certified threshold and
merges per-segment top-ks — when every segment's size is a multiple of
``config.doc_block`` this is *bit-identical* to a cold-start
:class:`~repro_torch.core.engine.RetrievalEngine` over the concatenated corpus
(same chunk contents, same accumulation order, same tie-breaks); unaligned
segments differ only in f32 association order.

``SearchSession`` is the per-stream cache keyed by query id: it remembers
each query's merged top-k, the certified tau, and the index
``version``/``epoch``/``mutation`` it searched under.

The mutation contract — which operations keep what certified
=============================================================

A cached tau is *certified* when >= k exactly-scored **surviving**
documents of the stream score >= tau.  Each mutation preserves or breaks
that differently:

* ``add_docs`` (bumps ``version``): appended documents can only *raise*
  the true k-th score, so every cached tau stays certified and every
  cached top-k stays the exact top-k of the segments it merged through.
  A repeat search scores only the new segments, warm-started at the
  cached tau, and merges — bit-identical to a cold search.

* ``delete_docs`` (bumps ``mutation``): deletions can *lower* the true
  k-th score, so a stale tau may over-prune.  Tombstoned docs are masked
  inside every engine's traversal (the registry's ``deleted_mask`` seam
  — a deleted doc never certifies a threshold) and the session applies a
  per-entry de-certification policy: an entry none of whose cached ids
  were deleted keeps its full warm state (deleting a doc outside the
  top-k can change neither the surviving top-k nor the tau those k
  cached docs certify); an entry holding a deleted id is *demoted* — the
  deleted rows are dropped, tau is re-certified from the k-th surviving
  cached value (or reset to ``-inf`` with fewer than k survivors), and
  the stream re-searches **all** segments warm-started at that still-
  certified threshold (merge-only: the cached rows are not merged back,
  avoiding duplicate ids).  Either way a warm search never prunes a doc
  a cold search would return.

* ``compact()`` (bumps nothing): rebuilds only segments whose tombstone
  fraction exceeds a threshold, re-tightening block bounds; global ids
  are preserved through each segment's ``id_map``, results are
  unchanged, so every cached entry — results and tau — stays valid.

* ``rebuild`` (bumps ``epoch``): destructive re-index; every cached
  entry is invalidated (documents may be gone and old ids renumbered).

Device: a ``Retriever`` holds one engine per segment on ``device``
(default ``"cuda"``, which raises without a card); queries may come on
any device, and results come back as numpy, as the JAX session returns
them.  Cached and demoted thresholds are the JAX ``np.float32`` values.
A store-backed segment is paged in by the ``SegmentPager``, which copies
the next segment's index on a stream of its own while this one is
searched (:mod:`repro_torch.store.pager`).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Hashable, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch.core import metrics as metrics_mod
from repro_torch.core import registry, scoring
from repro_torch.core import topk as topk_mod
from repro_torch.core.engine import RetrievalConfig, RetrievalEngine
from repro_torch.core.sparse import SparseBatch
from repro_torch.core.index import TiledIndex
from repro_torch.utils import resolve_device


@dataclasses.dataclass
class _Segment:
    """One append unit: its own engine/index over a doc-id range.

    ``count`` is the segment's *logical id span* — it never shrinks, so
    the global id space (and later segments' offsets) survives deletion
    and compaction.  After ``compact()`` the engine holds only surviving
    docs and ``id_map`` (ascending) maps its local positions back to
    global ids; before compaction ``id_map`` is ``None`` and the map is
    ``offset + local``.
    """

    engine: RetrievalEngine
    offset: int  # global id of this segment's first document
    count: int  # logical id span (immutable once appended)
    id_map: Optional[np.ndarray] = None  # local pos -> global id (compacted)

    def global_ids(self, local_ids: np.ndarray) -> np.ndarray:
        """Globalize engine-local ids (callers mask invalid slots)."""
        if self.id_map is None:
            return local_ids + self.offset
        return self.id_map[np.clip(local_ids, 0, len(self.id_map) - 1)]

    # Unified segment interface, shared with ``_PagedSegment``: the
    # Retriever answers every metadata question through these — never
    # through ``.engine`` directly — so a store-backed segment can reply
    # from its manifest without paging itself onto the device.
    @property
    def num_alive(self) -> int:
        return self.engine.num_alive

    @property
    def vocab_size(self) -> int:
        return self.engine.vocab_size

    @property
    def num_physical(self) -> int:
        """Physical rows the engine holds (== ``count`` until compaction
        shrinks the engine under an unchanged logical span)."""
        return self.engine.num_docs

    @property
    def deleted_mask(self) -> Optional[np.ndarray]:
        return self.engine.deleted_mask

    @property
    def physical_docs(self) -> SparseBatch:
        return self.engine.docs

    def index_bytes(self) -> int:
        return self.engine.index_bytes()

    def mapped_bytes(self) -> int:
        return 0  # fully device-resident; nothing spilled

    def is_resident(self) -> bool:
        return True

    def prefetch(self) -> None:
        pass  # already device-resident

    def bounds_memory_entry(self) -> Optional[dict]:
        idx = self.engine._index
        return idx.bounds_memory() if isinstance(idx, TiledIndex) else None

    def delete_local(self, local_ids: np.ndarray) -> int:
        return self.engine.delete_docs(local_ids)

    def replace_engine(
        self, docs: SparseBatch, config: RetrievalConfig,
        id_map: np.ndarray,
    ) -> None:
        """Swap in a compacted engine over ``docs`` (compaction's seam)."""
        self.engine = RetrievalEngine(docs, config,
                                      device=self.engine.device)
        self.id_map = id_map


class _PagedSegment:
    """A store-backed segment: manifest metadata host-side, the engine
    paged onto the device on demand through the Retriever's
    :class:`~repro_torch.store.pager.SegmentPager`.

    Implements the ``_Segment`` interface.  Metadata (spans, tombstone
    counts, byte sizes, bounds-memory) is answered from the on-disk
    manifest; touching ``.engine`` is what pages the segment in.
    Tombstone writes go through to disk immediately (the mask must
    survive eviction), and compaction rewrites the segment in place with
    a generation bump that drops its residency and its cached plans.
    """

    def __init__(self, retriever: "Retriever", handle, offset: int):
        self._r = retriever
        self.handle = handle
        self.offset = offset
        self.count = handle.count
        self._id_map_loaded = False
        self._id_map: Optional[np.ndarray] = None

    @property
    def engine(self) -> RetrievalEngine:
        return self._r._pager.acquire(self.handle)

    @property
    def id_map(self) -> Optional[np.ndarray]:
        if not self._id_map_loaded:
            self._id_map = self.handle.reader().id_map()
            self._id_map_loaded = True
        return self._id_map

    def global_ids(self, local_ids: np.ndarray) -> np.ndarray:
        if self.id_map is None:
            return local_ids + self.offset
        return self.id_map[np.clip(local_ids, 0, len(self.id_map) - 1)]

    @property
    def num_alive(self) -> int:
        return self.handle.num_docs - self.handle.deleted_count()

    @property
    def vocab_size(self) -> int:
        return self.handle.vocab_size

    @property
    def num_physical(self) -> int:
        return self.handle.num_docs

    @property
    def deleted_mask(self) -> Optional[np.ndarray]:
        return self.handle.reader().deleted_mask()

    @property
    def physical_docs(self) -> SparseBatch:
        return self.handle.reader().docs()  # mmap-backed, host-side

    def index_bytes(self) -> int:
        # Device-side truth: what this segment occupies right now.
        return self._r._pager.resident_bytes_for(self.handle)

    def mapped_bytes(self) -> int:
        return self.handle.mapped_bytes()

    def is_resident(self) -> bool:
        return self._r._pager.is_resident(self.handle)

    def prefetch(self) -> None:
        self._r._pager.prefetch(self.handle)

    def bounds_memory_entry(self) -> Optional[dict]:
        return self.handle.bounds_memory()  # recorded at write time

    def delete_local(self, local_ids: np.ndarray) -> int:
        # The acquired engine owns the authoritative mask; persisting it
        # after every effective delete is what lets eviction (and the
        # next process) reload the tombstones.  Deleting in a spilled
        # segment pages it in — acceptable: the alternative (patching
        # the mask on disk only) would still force a reload to search.
        eng = self.engine
        newly = eng.delete_docs(local_ids)
        if newly:
            self.handle.write_deleted(eng.deleted_mask)
        return newly

    def replace_engine(
        self, docs: SparseBatch, config: RetrievalConfig,
        id_map: np.ndarray,
    ) -> None:
        eng = RetrievalEngine(docs, config, device=self._r.device)
        self._r._store.rewrite_segment(
            self.handle, docs, config, count=self.count,
            engine=eng, id_map=id_map,
        )
        # The rewrite bumped the generation: drop the stale residency
        # (and, through the generation-keyed plan token, cached plans).
        self._r._pager.invalidate(self.handle)
        self._id_map_loaded = False


def _rows(queries: SparseBatch, rows: Sequence[int]) -> SparseBatch:
    """Rows ``rows`` of a batch, on the batch's device."""
    idx = torch.as_tensor(np.asarray(rows, dtype=np.int64),
                          device=queries.device)
    return SparseBatch(queries.term_ids[idx], queries.values[idx],
                       queries.vocab_size)


def _merge(run_v, run_i, v, i, k: int, device):
    """``topk.merge_topk`` of two host results on ``device`` (where the
    JAX session merges too), back on the host."""
    mv, mi = topk_mod.merge_topk(
        *(torch.from_numpy(x).to(device) for x in (run_v, run_i, v, i)), k,
    )
    return mv.cpu().numpy(), mi.cpu().numpy()


class Retriever:
    """Owns the (growable) index and the compiled scoring step.

    ``version`` counts index segments (monotone, bumped by ``add_docs``);
    ``epoch`` counts destructive rebuilds; ``mutation`` counts effective
    ``delete_docs`` calls.  Sessions key their tau cache on all three:
    appends keep cached thresholds valid, deletions trigger the per-entry
    de-certification policy (see the module docstring), rebuilds
    invalidate everything.

    Every segment's engine lives on ``device`` (default ``"cuda"``).
    """

    def __init__(
        self,
        docs: Optional[SparseBatch] = None,
        config: Optional[RetrievalConfig] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.config = config or RetrievalConfig()
        self.spec = registry.get_engine(self.config.engine)
        self._segments: list[_Segment] = []
        self.epoch = 0
        self.mutation = 0  # effective delete_docs calls this epoch
        self._deleted_ids: set[int] = set()  # global ids ever tombstoned
        self._store = None  # store.SegmentStore when store-backed
        self._pager = None  # store.SegmentPager when store-backed
        if docs is not None and docs.batch:
            self._append(docs)

    @classmethod
    def from_store(
        cls,
        path: str,
        device_budget_bytes: Optional[int] = None,
        config: Optional[RetrievalConfig] = None,
        prefetch: bool = True,
        verify_checksums: bool = True,
        device="cuda",
    ) -> "Retriever":
        """Serve a :class:`~repro_torch.store.SegmentWriter`-built store
        (or one that ``repro.store.SegmentWriter`` wrote: the format is
        the same).

        Segments stay on disk (mmap) until searched; at most
        ``device_budget_bytes`` of them are device-resident at a time
        (LRU, ``None`` = unbounded), so corpus size is independent of
        device memory.  Search results — top-k, tau, evaluate metrics —
        are bit-identical to a fully-resident :class:`Retriever` over
        the same corpus (``tests/test_torch_store.py``).  The budget
        counts CUDA bytes of the resident segments' indices.

        ``config`` defaults to the store's committed config snapshot; a
        caller-supplied one may change serving knobs (``k``,
        ``query_chunk``, scheduling) but must keep the engine and index
        geometry the persisted arrays were built for.  A snapshot's JAX
        keys with no port field (``pad_to``, ``use_f32_scores``) must hold
        JAX's defaults, and a JAX engine with no port name (``pallas``,
        ``pallas_ell``) raises (see :mod:`repro_torch.store.format`).
        """
        from repro_torch.store import SegmentPager, SegmentStore
        from repro_torch.store import format as store_fmt

        store = SegmentStore.open(path, verify_checksums)
        snap = store_fmt.config_from_manifest(store.config_snapshot)
        if config is None:
            config = RetrievalConfig(**snap)
        else:
            frozen = ("engine", "reorder_docs",
                      "reorder_method") + store_fmt.GEOMETRY_KEYS
            for key in frozen:
                if getattr(config, key) != snap[key]:
                    raise ValueError(
                        f"config.{key}={getattr(config, key)!r} does not "
                        f"match the store's {snap[key]!r}: the persisted "
                        "index arrays are built for that geometry"
                    )
        r = cls(config=config, device=device)
        r._store = store
        r._pager = SegmentPager(device_budget_bytes, config=config,
                                prefetch=prefetch, device=r.device)
        offset = 0
        for handle in store.segments:
            seg = _PagedSegment(r, handle, offset)
            r._segments.append(seg)
            offset += seg.count
            mask = seg.deleted_mask
            if mask is not None:
                pos = np.flatnonzero(mask)
                r._deleted_ids.update(
                    int(g) for g in seg.global_ids(pos)
                )
        return r

    # -- index state ------------------------------------------------------
    @property
    def version(self) -> int:
        """Index version: the number of segments (grows with add_docs)."""
        return len(self._segments)

    @property
    def num_docs(self) -> int:
        """The global id span (tombstoned ids stay reserved; see
        ``num_alive`` for the surviving count)."""
        return sum(s.count for s in self._segments)

    @property
    def num_alive(self) -> int:
        """Documents not tombstoned (what search/evaluate can return)."""
        return sum(s.num_alive for s in self._segments)

    @property
    def vocab_size(self) -> int:
        if not self._segments:
            raise ValueError("empty Retriever has no vocabulary yet")
        return self._segments[0].vocab_size

    def index_bytes(self) -> int:
        """Device-resident index bytes.  For a store-backed Retriever
        this counts only paged-in segments — the spilled remainder shows
        up as ``mapped_bytes`` in :meth:`bounds_memory`."""
        return sum(s.index_bytes() for s in self._segments)

    def bounds_memory(self) -> dict:
        """Fine-bound storage totals over all segments (both layouts;
        see ``TiledIndex.bounds_memory``), plus the resident-vs-spilled
        breakdown: ``device_bytes`` (paged-in index bytes),
        ``mapped_bytes`` (on-disk mmap bytes of store-backed segments),
        and a per-segment ``segments`` residency list."""
        agg = {"format": "none", "stored": 0, "dense": 0, "csr": 0}
        formats = set()
        per_seg = []
        device_total = mapped_total = 0
        for seg in self._segments:
            bm = seg.bounds_memory_entry()
            if bm is not None:
                if bm["format"] != "none":
                    formats.add(bm["format"])
                for key in ("stored", "dense", "csr"):
                    agg[key] += bm[key]
            dev = seg.index_bytes()
            mapped = seg.mapped_bytes()
            device_total += dev
            mapped_total += mapped
            per_seg.append({
                "offset": seg.offset, "count": seg.count,
                "resident": seg.is_resident(),
                "device_bytes": dev, "mapped_bytes": mapped,
            })
        # Segments can mix layouts (e.g. add_docs after a bounds_format
        # config change): reporting the last segment's format would
        # misdescribe the aggregate byte totals.
        if len(formats) == 1:
            agg["format"] = formats.pop()
        elif formats:
            agg["format"] = "mixed"
        agg["device_bytes"] = device_total
        agg["mapped_bytes"] = mapped_total
        agg["segments"] = per_seg
        return agg

    def pager_stats(self) -> Optional[dict]:
        """Pager hit/miss/evict/bytes counters (store-backed only)."""
        return None if self._pager is None else self._pager.stats()

    def obs_snapshot(self) -> Optional[obs_mod.ObsSnapshot]:
        """One snapshot of everything this retriever can observe.

        Folds the stat islands this layer owns (pager counters — zeroed
        when not store-backed — plan-cache hit rate, index shape) into
        ``config.obs``'s registry and freezes it.  ``None`` when obs is
        disabled (``config.obs = None``).  Serving layers add their own
        islands on top: see ``QueryScheduler.obs_snapshot``.
        """
        obs = getattr(self.config, "obs", None)
        if obs is None:
            return None
        from repro_torch.obs import collect

        collect.collect_plan_cache(obs.metrics,
                                   getattr(self.config, "plan_cache", None))
        collect.collect_pager(obs.metrics, self.pager_stats())
        obs.metrics.gauge("index.segments").set(self.version)
        obs.metrics.gauge("index.num_docs").set(self.num_docs)
        obs.metrics.gauge("index.deleted_docs").set(len(self._deleted_ids))
        return obs.snapshot()

    def _append(self, docs: SparseBatch) -> None:
        if self._store is not None:
            # Store-backed growth: seal the batch as an on-disk segment
            # (it pages in on first search, like any other segment).
            handle = self._store.append_segment(docs, self.config,
                                                device=self.device)
            self._segments.append(
                _PagedSegment(self, handle, self.num_docs)
            )
            return
        self._segments.append(
            _Segment(RetrievalEngine(docs, self.config, device=self.device),
                     self.num_docs, docs.batch)
        )

    def add_docs(self, docs: SparseBatch) -> int:
        """Append a document batch as a fresh index segment.

        The new documents start at global id ``num_docs`` (before the
        call) and occupy whole new doc blocks; existing segments — and
        any session's cached thresholds — stay valid.  Returns the new
        ``version``.
        """
        if not docs.batch:
            return self.version
        if self._segments and docs.vocab_size != self.vocab_size:
            raise ValueError(
                f"vocab mismatch: index has {self.vocab_size}, "
                f"batch has {docs.vocab_size}"
            )
        self._append(docs)
        return self.version

    def delete_docs(self, global_ids) -> int:
        """Tombstone documents by global id (no index rewrite).

        Records per-segment tombstones on each segment's engine (a
        device-resident doc mask threaded through the registry's
        ``deleted_mask`` seam, so pruned traversals mask *in-sweep* and a
        deleted doc can never certify a pruning threshold).  Tombstoned
        docs vanish from every subsequent ``search`` / ``evaluate`` /
        ``prune_stats``; their global ids stay reserved (``num_docs`` is
        the id span, ``num_alive`` the surviving count).

        Bumps ``mutation`` when at least one doc is *newly* deleted —
        the signal sessions use to run the tau de-certification policy
        (see the module docstring).  Idempotent; returns the newly
        deleted count.  Raises on out-of-range ids.
        """
        if not self._segments:
            raise ValueError("Retriever holds no documents; add_docs first")
        ids = np.unique(np.asarray(global_ids, np.int64).reshape(-1))
        if ids.size and (ids[0] < 0 or ids[-1] >= self.num_docs):
            raise ValueError(
                f"doc ids must be in [0, {self.num_docs}); got range "
                f"[{ids[0]}, {ids[-1]}]"
            )
        newly = 0
        for seg in self._segments:
            in_seg = ids[(ids >= seg.offset) & (ids < seg.offset + seg.count)]
            if not in_seg.size:
                continue
            if seg.id_map is None:
                local = in_seg - seg.offset
            else:
                # Compacted segment: ids already removed by compaction
                # are prior deletions — idempotent no-ops.
                pos = np.searchsorted(seg.id_map, in_seg)
                pos = np.clip(pos, 0, len(seg.id_map) - 1)
                local = pos[seg.id_map[pos] == in_seg]
            if local.size:
                newly += seg.delete_local(local)
        self._deleted_ids.update(int(g) for g in ids)
        if newly:
            self.mutation += 1
        return newly

    def is_deleted(self, global_ids) -> np.ndarray:
        """Elementwise tombstone check over global ids (survives
        compaction: once deleted, always reported deleted)."""
        arr = np.asarray(global_ids, np.int64).reshape(-1)
        if not self._deleted_ids:
            return np.zeros(arr.shape, bool)
        return np.fromiter(
            (int(g) in self._deleted_ids for g in arr), bool, len(arr)
        )

    def compact(self, threshold: float = 0.25) -> int:
        """Rebuild segments whose tombstone fraction exceeds ``threshold``.

        A background maintenance pass: each qualifying segment's engine is
        rebuilt over its surviving documents only (re-tightening block
        bounds and shedding the dead docs' chunks), with an ascending
        ``id_map`` preserving global ids — so results, tie-breaks, and
        every session cache entry are unchanged and nothing is bumped.
        A fully-tombstoned segment is left as-is (an empty index cannot
        be built; its mask already hides everything).  Returns the number
        of segments rebuilt.
        """
        if not 0.0 <= threshold < 1.0:
            raise ValueError(
                f"threshold must be in [0, 1), got {threshold}"
            )
        rebuilt = 0
        for seg in self._segments:
            dead = seg.deleted_mask
            if dead is None:
                continue
            if dead.sum() / max(seg.num_physical, 1) <= threshold:
                continue
            alive_pos = np.flatnonzero(~dead)
            if not alive_pos.size:
                continue
            old_map = (
                seg.id_map if seg.id_map is not None
                else seg.offset + np.arange(seg.num_physical,
                                            dtype=np.int64)
            )
            # alive_pos ascending x old_map ascending => the new map is
            # ascending: lower local id still means lower global id, so
            # per-segment tie-breaking matches the uncompacted index.
            # Store-backed segments additionally rewrite themselves on
            # disk (new file generation, atomic manifest flip) and drop
            # their device residency.
            seg.replace_engine(_rows(seg.physical_docs, alive_pos),
                               self.config, old_map[alive_pos])
            rebuilt += 1
        return rebuilt

    def rebuild(self, docs: SparseBatch) -> int:
        """Destructively replace the corpus (re-index from scratch).

        Bumps ``epoch``: every session cache entry — results *and* tau —
        is invalidated, because documents may have been removed and an old
        tau is no longer certified by k surviving documents.  Deletion
        state (tombstones, ``is_deleted``) resets with the new corpus.
        """
        if self._store is not None:
            raise NotImplementedError(
                "rebuild() on a store-backed Retriever would orphan its "
                "on-disk segments; build a fresh store with "
                "repro_torch.store.SegmentWriter and reopen it with "
                "Retriever.from_store instead"
            )
        self._segments = []
        self.epoch += 1
        self._deleted_ids = set()
        if docs is not None and docs.batch:
            self._append(docs)
        return self.version

    # -- search -----------------------------------------------------------
    def _search_segments(
        self,
        queries: SparseBatch,
        segments: Sequence[_Segment],
        k: int,
        tau_init: Optional[np.ndarray] = None,
        merge_with: Optional[tuple[np.ndarray, np.ndarray]] = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sweep ``segments`` with the stream recurrence.

        Each segment is searched warm-started at the running certified
        threshold (when the engine consumes one), its finite ids are
        globalized by the segment offset, and the per-segment top-ks are
        merged in segment order — which preserves cold-start tie-breaking
        (lower global ids win ties, exactly as one big top-k would).
        ``merge_with`` seeds the merge with an already-searched prefix
        (the session's cached result).  Returns ``(vals, ids, tau)``.
        """
        warm = registry.config_supports_tau(self.config)
        obs = getattr(self.config, "obs", None)
        queries = queries.to(self.device)  # once, not once a segment
        tau = (np.full((queries.batch,), -np.inf, np.float32)
               if tau_init is None else np.asarray(tau_init, np.float32))
        run_v = run_i = None
        if merge_with is not None:
            run_v, run_i = merge_with
            tau = topk_mod.certify_tau(run_v, k, tau)
        for pos, seg in enumerate(segments):
            with obs_mod.span(obs, "segment.search", segment=pos):
                eng = seg.engine  # pages a store-backed segment in
                # Stage the next segment's page-in before searching this
                # one: the pager reads, checks and copies it on a thread
                # and a stream of its own, which overlap the sweep run
                # here (the engine's stream waits on the copy's event at
                # acquire).  No-op for device-resident segments; the
                # pager skips it rather than evict the segment being
                # searched.
                if pos + 1 < len(segments):
                    segments[pos + 1].prefetch()
                v, i = eng.search(queries, k=k,
                                  tau_init=tau if warm else None)
                i = np.where(np.isfinite(v), seg.global_ids(i), -1)
            if run_v is None:
                run_v, run_i = v, i
                tau = topk_mod.certify_tau(run_v, k, tau)
                continue
            # the merge's copy back to numpy ends it on the host, so the
            # span is real wall-clock
            with obs_mod.span(obs, "topk.merge"):
                run_v, run_i = _merge(run_v, run_i, v, i, k, self.device)
            tau = topk_mod.certify_tau(run_v, k, tau)
        if self._pager is not None:
            self._pager.release()  # the search ended on the host
        # Column width is the id-span contract min(k, num_docs): after
        # compaction a segment engine can return fewer columns than the
        # span allows, so pad with masked slots (exactly how a pruned
        # engine reports below-top-k positions).
        k_cols = min(k, self.num_docs)
        if run_v is not None and run_v.shape[1] < k_cols:
            pad = k_cols - run_v.shape[1]
            run_v = np.pad(run_v, ((0, 0), (0, pad)),
                           constant_values=-np.inf)
            run_i = np.pad(run_i, ((0, 0), (0, pad)), constant_values=-1)
        return run_v, run_i, tau

    def search(
        self,
        queries: SparseBatch,
        k: Optional[int] = None,
        tau_init: Optional[np.ndarray] = None,
        return_tau: bool = False,
    ):
        """Top-k over the full (all-segment) corpus -> (vals, ids[, tau]).

        Matches ``RetrievalEngine.search`` over the concatenated corpus
        (bit-identical for doc-block-aligned segments); pruned engines
        return id ``-1`` in masked slots.
        """
        if not self._segments:
            raise ValueError("Retriever holds no documents; add_docs first")
        if tau_init is not None:
            # Same contract as RetrievalEngine.search: a warm threshold
            # the engine cannot consume is a caller bug, not a no-op.
            if not self.spec.supports_tau:
                raise ValueError(
                    "tau_init is only meaningful for pruned engines, "
                    f"not engine={self.config.engine!r}"
                )
            if not registry.config_supports_tau(self.config):
                raise ValueError(
                    "tau warm-start needs traversal='bmp' "
                    "(the two-pass sweep re-seeds per call)"
                )
        k_req = k or self.config.k
        vals, ids, tau = self._search_segments(
            queries, self._segments, k_req, tau_init=tau_init
        )
        if return_tau:
            return vals, ids, tau
        return vals, ids

    def open_session(
        self, k: Optional[int] = None, max_entries: Optional[int] = None
    ) -> "SearchSession":
        """A per-query-stream session over this retriever's index.

        ``max_entries`` bounds the session's tau/result cache (LRU
        eviction; evicted streams simply cold-start on their next
        search)."""
        return SearchSession(self, k=k, max_entries=max_entries)

    # -- observability ----------------------------------------------------
    def prune_stats(self, queries: SparseBatch, k: Optional[int] = None):
        """Aggregate block/chunk skip statistics over all segments
        (pruned engines only; ``None`` otherwise) — the public seam the
        serve benchmark reads instead of the index internals."""
        if not self.spec.pruned:
            return None
        agg = None
        for seg in self._segments:
            st = seg.engine.prune_stats(queries, k=k)
            if agg is None:
                agg = st
            else:
                agg = scoring.PruneStats(
                    num_doc_blocks=agg.num_doc_blocks + st.num_doc_blocks,
                    blocks_seeded=agg.blocks_seeded + st.blocks_seeded,
                    blocks_scored=agg.blocks_scored + st.blocks_scored,
                    chunks_total=agg.chunks_total + st.chunks_total,
                    chunks_scored=agg.chunks_scored + st.chunks_scored,
                    sweep_steps=agg.sweep_steps + st.sweep_steps,
                    theta=st.theta,
                )
        return agg

    # -- evaluation -------------------------------------------------------
    def _exact_topk(self, queries: SparseBatch, k: int):
        """Exhaustive tiled top-k over all segments (theta ground truth)."""
        cfg = self.config
        run_v = run_i = None
        for seg in self._segments:
            eng = seg.engine
            out_v, out_i = [], []
            for s in range(0, queries.batch, cfg.query_chunk):
                q = queries.slice_rows(s, min(cfg.query_chunk,
                                              queries.batch - s))
                sc = scoring.score_tiled(q.to(eng.device), eng._index)
                if eng._doc_unperm is not None:
                    sc = sc[:, eng._doc_unperm]
                if eng.deleted_mask is not None:
                    # Ground truth excludes tombstoned docs too —
                    # otherwise theta-mode recall would be judged against
                    # documents no engine is allowed to return.
                    sc = sc.masked_fill(
                        torch.from_numpy(eng.deleted_mask).to(sc.device)[
                            None, :], float("-inf"))
                v, i = topk_mod.topk_two_stage(
                    sc, min(k, eng.num_docs), block=cfg.topk_block
                )
                out_v.append(v.cpu().numpy())
                out_i.append(i.cpu().numpy())
            v = np.concatenate(out_v, axis=0)
            i = np.where(np.isfinite(v),
                         seg.global_ids(np.concatenate(out_i, axis=0)), -1)
            if run_v is None:
                run_v, run_i = v, i
            else:
                run_v, run_i = _merge(run_v, run_i, v, i, k, self.device)
        return run_v, run_i

    def evaluate(
        self,
        queries: SparseBatch,
        qrels: list[set[int]],
        k: int = 1000,
    ) -> dict[str, float]:
        """Qrels metrics over the full corpus; ``tiled-pruned-approx``
        with ``theta < 1`` adds recall vs the exact top-k (as
        ``RetrievalEngine.evaluate`` does).

        Tombstoned documents are excluded from the qrels denominators:
        no engine is allowed to return a deleted doc, so leaving one in
        a relevance set would cap recall below 1.0 for every engine —
        a measurement artifact, not a retrieval miss."""
        if self._deleted_ids:
            qrels = [set(q) - self._deleted_ids for q in qrels]
        _, ids = self.search(queries, k=k)
        out = {
            "mrr@10": metrics_mod.mrr_at_k(ids, qrels, 10),
            "ndcg@10": metrics_mod.ndcg_at_k(ids, qrels, 10),
            f"recall@{k}": metrics_mod.recall_at_k(ids, qrels, k),
        }
        if self.spec.supports_theta and self.config.theta < 1.0:
            _, exact_ids = self._exact_topk(queries, k)
            out[f"recall_vs_exact@{k}"] = metrics_mod.recall_vs_ids(
                ids, exact_ids, k
            )
        return out


@dataclasses.dataclass
class _QueryState:
    """What the session remembers per query stream."""

    version: int  # index version the cached result has merged through
    epoch: int  # retriever epoch it was computed under
    mutation: int  # retriever mutation counter it was (re)validated at
    k: int
    vals: np.ndarray  # [k_cols] merged top-k values (sorted desc)
    ids: np.ndarray  # [k_cols] global doc ids (-1 in masked slots)
    tau: np.float32  # certified threshold over everything searched


class SearchSession:
    """Per-query-stream serving cache over a :class:`Retriever`.

    Repeat searches for the same ``query_ids`` after ``add_docs`` score
    only the *new* index segments, warm-started at each stream's cached
    certified tau, and merge into the cached top-k — returning exactly
    what a cold-start search over the full corpus would (appends can only
    raise the true k-th score, so the carried tau remains a valid lower
    bound).  A retriever ``rebuild`` bumps its ``epoch`` and silently
    invalidates every cache entry; entries cached at a different ``k``
    are also treated as cold.

    ``delete_docs`` bumps the retriever's ``mutation`` counter and
    triggers the per-entry tau de-certification policy: an entry whose
    cached ids all survive stays fully warm (its tau is certified exactly
    by those k surviving docs); an entry holding a since-deleted id is
    demoted — deleted rows dropped, tau re-certified from the k-th
    surviving cached value (``-inf`` with fewer than k survivors), and
    the stream re-searched over all segments warm-started at that
    threshold.  Either way the result bit-matches a cold session (see
    the module docstring's mutation contract).

    ``max_entries`` bounds the cache (a serving tier sees unboundedly many
    query streams; per-stream state must not grow with them): when a
    search would exceed it, the least-recently-searched streams are
    evicted.  Eviction is purely a performance event — an evicted
    stream's next search runs cold over all segments and returns exactly
    what the warm path would have (the bounded-eviction contract,
    property-tested in ``tests/test_session.py``).
    """

    def __init__(
        self,
        retriever: Retriever,
        k: Optional[int] = None,
        max_entries: Optional[int] = None,
    ):
        if max_entries is not None and max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.retriever = retriever
        self.k = k or retriever.config.k
        self.max_entries = max_entries
        self._cache: "collections.OrderedDict[Hashable, _QueryState]" = (
            collections.OrderedDict()
        )
        self.evictions = 0  # observability: cold starts forced by the bound
        self.demotions = 0  # observability: tau de-certified by deletions

    def __len__(self) -> int:
        return len(self._cache)

    def cached_tau(self, query_id: Hashable) -> Optional[float]:
        """The stream's certified threshold, or ``None`` when the cache
        holds nothing certified (unknown stream, stale epoch, or a tau
        de-certified by deletions of cached docs)."""
        st = self._cache.get(query_id)
        if st is None or st.epoch != self.retriever.epoch:
            return None
        if self._demotion_tau(st) is not None:
            return None
        return float(st.tau)

    def _demotion_tau(self, st: _QueryState) -> Optional[np.float32]:
        """``None`` when the entry's tau is still certified; otherwise
        the demoted warm-start threshold — the k-th surviving cached
        value (certified by those survivors) or ``-inf``.

        The cached tau is certified exactly by the cached top-k rows
        (``certify_tau`` sets it to their k-th value whenever >= k are
        finite), so "tau could have been certified by since-deleted
        docs" reduces to "some cached id is deleted".
        """
        if st.mutation == self.retriever.mutation:
            return None
        live = st.ids >= 0
        if not live.any():
            return None
        deleted = self.retriever.is_deleted(st.ids[live])
        if not deleted.any():
            return None
        surv = st.vals[live][~deleted]
        if surv.size >= st.k:
            return np.float32(surv[st.k - 1])
        return np.float32(-np.inf)

    def invalidate(self, query_id: Optional[Hashable] = None) -> None:
        if query_id is None:
            self._cache.clear()
        else:
            self._cache.pop(query_id, None)

    def search(
        self,
        queries: SparseBatch,
        query_ids: Optional[Sequence[Hashable]] = None,
        k: Optional[int] = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Incremental top-k for a batch of query streams.

        ``query_ids`` names each row's stream (defaults to the row index,
        i.e. "the i-th stream of this session").  Rows are grouped by how
        far their cache has already searched; each group scores only its
        missing segments (tau warm-started) and merges with its cached
        result.  Entries de-certified by deletions re-search all segments
        at their demoted threshold (see :meth:`_demotion_tau`).  Returns
        ``(vals [B, k'], ids [B, k'])`` with ``k' = min(k, num_docs)``,
        identical to ``Retriever.search``.

        Duplicate ``query_ids`` within one batch are served as a single
        stream when their query rows are identical (one search, one cache
        write, the result copied to every duplicate row); duplicates with
        *differing* rows raise ``ValueError`` — they would race for one
        cache slot, and the silent last-wins the session used to do
        poisoned the stream's next warm search with another query's
        top-k and tau.
        """
        r = self.retriever
        if not r._segments:
            raise ValueError("Retriever holds no documents; add_docs first")
        k_req = k or self.k
        b = queries.batch
        if query_ids is None:
            query_ids = list(range(b))
        if len(query_ids) != b:
            raise ValueError(
                f"{len(query_ids)} query_ids for a batch of {b} queries"
            )

        q_tids = queries.term_ids.cpu().numpy()
        q_vals = queries.values.cpu().numpy()
        first_row: dict[Hashable, int] = {}
        alias: dict[int, int] = {}  # duplicate row -> representative row
        unique_rows: list[int] = []
        for row, qid in enumerate(query_ids):
            rep = first_row.get(qid)
            if rep is None:
                first_row[qid] = row
                unique_rows.append(row)
            elif (np.array_equal(q_tids[row], q_tids[rep])
                  and np.array_equal(q_vals[row], q_vals[rep])):
                alias[row] = rep
            else:
                raise ValueError(
                    f"duplicate query_id {qid!r} with differing query "
                    "rows in one batch: rows of one stream must be "
                    "identical (a stream has one query), otherwise they "
                    "would race for the same cache entry"
                )

        # Group rows by the version their cache has merged through (0 =
        # cold or demoted); every group ends at the current version, so
        # all outputs share min(k_req, num_docs) columns.
        groups: dict[int, list[int]] = {}
        demoted_tau: dict[int, np.float32] = {}
        for row in unique_rows:
            st = self._cache.get(query_ids[row])
            usable = (
                st is not None
                and st.epoch == r.epoch
                and st.k == k_req
                and st.version <= r.version
            )
            if usable and st.mutation != r.mutation:
                tau_d = self._demotion_tau(st)
                if tau_d is not None:
                    # A deleted doc backed this entry's tau/top-k: drop
                    # to a full re-search, warm-started at the threshold
                    # the surviving cached docs still certify.  No
                    # merge-back: the survivors will be found again by
                    # the re-search (merging would duplicate their ids).
                    demoted_tau[row] = tau_d
                    usable = False
                    self.demotions += 1
                # else: no cached id deleted — the cached top-k is still
                # the exact top-k over survivors and its tau is certified
                # by those k cached (surviving) docs; stays fully warm.
            groups.setdefault(st.version if usable else 0, []).append(row)

        k_cols = min(k_req, r.num_docs)
        out_v = np.full((b, k_cols), -np.inf, np.float32)
        out_i = np.full((b, k_cols), -1, np.int64)
        for from_version, rows in sorted(groups.items()):
            sub = _rows(queries, rows)
            segs = r._segments[from_version:]
            if from_version > 0:
                cached = [self._cache[query_ids[row]] for row in rows]
                merge_with = (
                    np.stack([st.vals for st in cached]),
                    np.stack([st.ids for st in cached]),
                )
                tau0 = np.asarray([st.tau for st in cached], np.float32)
            else:
                merge_with = None
                tau0 = np.asarray(
                    [demoted_tau.get(row, -np.inf) for row in rows],
                    np.float32,
                )
            if segs:
                v, i, tau = r._search_segments(
                    sub, segs, k_req, tau_init=tau0, merge_with=merge_with
                )
            else:  # cache already current: serve straight from it
                v, i = merge_with
                tau = tau0
            out_v[rows] = v
            out_i[rows] = i
            with obs_mod.span(getattr(r.config, "obs", None),
                              "cache.write", rows=len(rows)):
                for j, row in enumerate(rows):
                    self._cache[query_ids[row]] = _QueryState(
                        version=r.version, epoch=r.epoch,
                        mutation=r.mutation,
                        k=k_req, vals=v[j].copy(), ids=i[j].copy(),
                        tau=np.float32(tau[j]),
                    )
                    self._cache.move_to_end(query_ids[row])
        for row, rep in alias.items():
            out_v[row] = out_v[rep]
            out_i[row] = out_i[rep]
        # Bounded cache: evict least-recently-searched streams.  Purely a
        # perf event — the evicted stream's next search cold-starts and
        # still returns the exact result.
        while (self.max_entries is not None
               and len(self._cache) > self.max_entries):
            self._cache.popitem(last=False)
            self.evictions += 1
        return out_v, out_i
