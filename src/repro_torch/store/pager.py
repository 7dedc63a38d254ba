"""LRU device-residency manager for store-backed segments
(:mod:`repro.store.pager` on PyTorch).

:class:`SegmentPager` keeps at most ``budget_bytes`` of segment indices
resident on ``device`` (CUDA bytes, :func:`engine_device_bytes`).
``acquire`` returns a ready :class:`~repro_torch.core.engine.
RetrievalEngine` for a segment — a cache hit if it is already resident at
the current generation, otherwise a page-in (mmap -> pinned buffer ->
device, :class:`~repro_torch.store.reader.Upload`) followed by LRU
eviction until the budget holds again.

``prefetch`` stages the *next* segment's page-in while the current one
is being scored.  The JAX pager counts on JAX's asynchronous dispatch for
that overlap; here a search returns numpy, so it ends on the host, and
the page-in's host work (reading and CRC-checking every mapped file,
filling the pinned buffers) would otherwise run before the current
sweep is even queued.  So a prefetch runs the whole page-in on a worker
thread of its own, its copies on the pager's copy stream; ``acquire``
takes the staged engine (waiting for the thread if it has not finished)
and makes the current stream wait on the copies' event before the
engine's first use.  Without the wait the search would race the copy;
without the stream the copy would queue behind the search.  A demand
miss pages in the same way on the caller's thread.  Every pager state
change happens on the caller's thread; the worker only builds the
engine.

Two deliberate properties:

* **A single segment may exceed the budget.**  The pager never evicts
  its way below one resident segment — you cannot search a segment that
  is not resident — so the budget is a working-set bound, not a hard
  allocator limit.  Size segments below the budget (the writer's
  ``segment_docs`` knob) to make the bound tight.
* **Eviction is correctness-free.**  Segments are immutable at a given
  generation, so an evicted segment reloads bit-identically; callers
  holding a Python reference to an evicted engine keep its tensors
  alive until they drop it.  A page-in's tensors are allocated on the
  copy stream and marked as used by the consumer's stream at
  ``acquire``, so dropping one before or after its first use never lets
  the allocator hand its blocks out early.  A prefetch is admitted into
  the LRU (and the budget enforced) when it is acquired, so the device
  holds at most the budget plus the one staged segment, as a demand
  miss does between its load and its evictions.

Counters (``stats()``): hits, misses, evictions, prefetches,
bytes_loaded, bytes_evicted, resident_bytes — the JAX pager's keys.
"""
from __future__ import annotations

from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

from repro_torch.store.reader import Upload
from repro_torch.utils import resolve_device


def engine_device_bytes(engine) -> int:
    """Device-side footprint of one segment engine: its index's bytes,
    else (the ``dense`` engine, whose index is the docs batch) the doc
    arrays it holds."""
    n = engine.index_bytes()
    if n:
        return n
    return int(engine.docs.term_ids.nbytes + engine.docs.values.nbytes)


def _device_tensors(engine) -> list:
    """The CUDA tensors a page-in made for ``engine``: its index's, its
    docs' (the ``dense`` engine's index) and its reorder permutation."""
    parts = [getattr(engine, "_index", None), getattr(engine, "docs", None)]
    found = [getattr(engine, "_doc_unperm", None)]
    found += [v for p in parts if p is not None for v in vars(p).values()]
    return [t for t in found if isinstance(t, torch.Tensor) and t.is_cuda]


class SegmentPager:
    """LRU of device-resident segment engines under a byte budget."""

    def __init__(
        self,
        budget_bytes: Optional[int] = None,
        config=None,
        prefetch: bool = True,
        device="cuda",
    ):
        if budget_bytes is not None and budget_bytes < 1:
            raise ValueError(
                f"budget_bytes must be >= 1 (or None for unbounded), "
                f"got {budget_bytes}"
            )
        self.budget_bytes = budget_bytes
        self.config = config
        self.prefetch_enabled = prefetch
        self.device = resolve_device(device)
        self._stream = None  # the copy stream, made at the first page-in
        self._worker = None  # the prefetch thread, made at the first one
        # key (seg_dir) -> (generation, engine, device_bytes, upload);
        # insertion order == recency order (LRU at the front).  ``upload``
        # is the page-in's Upload until acquire has waited on it.
        self._resident: "OrderedDict[str, tuple]" = OrderedDict()
        # key -> (generation, future of (engine, upload)): staged prefetches
        self._pending: dict[str, tuple] = {}
        self._inflight: list[Upload] = []  # holding pinned buffers
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.prefetches = 0
        self.prefetch_skipped = 0
        self.bytes_loaded = 0
        self.bytes_evicted = 0

    # -- residency ---------------------------------------------------------
    def resident_bytes(self) -> int:
        return sum(e[2] for e in self._resident.values())

    def resident_segments(self) -> list:
        return list(self._resident.keys())

    def is_resident(self, handle) -> bool:
        entry = self._resident.get(handle.seg_dir)
        return entry is not None and entry[0] == handle.generation

    def resident_bytes_for(self, handle) -> int:
        """Device bytes ``handle`` currently occupies (0 when spilled)."""
        entry = self._resident.get(handle.seg_dir)
        if entry is None or entry[0] != handle.generation:
            return 0
        return entry[2]

    def _drop(self, key: str) -> None:
        _, _, nbytes, _ = self._resident.pop(key)
        self.evictions += 1
        self.bytes_evicted += nbytes

    def _evict_to_budget(self, keep: str) -> None:
        if self.budget_bytes is None:
            return
        while (self.resident_bytes() > self.budget_bytes
               and len(self._resident) > 1):
            key = next(iter(self._resident))
            if key == keep:
                # The just-acquired segment is the LRU (it was prefetched
                # long ago): rotate it to MRU instead of evicting what
                # the caller is about to search.
                self._resident.move_to_end(key)
                continue
            self._drop(key)

    def _copy_stream(self):
        if self.device.type != "cuda":
            return None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _stage(self, handle, stream):
        """One page-in: -> (engine, finished upload).  Runs on the caller's
        thread (a demand miss) or the prefetch thread; touches no pager
        state.  Everything it queues, the docs-kind rebuild included, goes
        on the copy stream."""
        with torch.cuda.stream(stream):
            upload = Upload(self.device, stream)
            engine = handle.load_engine(self.config, upload)
            upload.finish()
        return engine, upload

    def _admit(self, handle, engine, upload) -> None:
        self.release()
        self._inflight.append(upload)
        nbytes = engine_device_bytes(engine)
        self._resident[handle.seg_dir] = (
            handle.generation, engine, nbytes, upload
        )
        self._resident.move_to_end(handle.seg_dir)
        self.bytes_loaded += nbytes

    def release(self) -> None:
        """Drop the pinned buffers of every page-in whose copies have
        completed (a search calls it when it ends on the host)."""
        self._inflight = [u for u in self._inflight if not u.done()]

    def acquire(self, handle):
        """Ready engine for ``handle``, paging it in if needed; the
        current stream waits on its copies."""
        if self.config is None:
            raise ValueError(
                "SegmentPager.config is unset; assign the Retriever's "
                "RetrievalConfig before acquiring segments"
            )
        key = handle.seg_dir
        entry = self._resident.get(key)
        if entry is not None and entry[0] == handle.generation:
            self._resident.move_to_end(key)
            self.hits += 1
        else:
            staged = self._pending.get(key)
            if staged is not None and staged[0] == handle.generation:
                # A prefetched segment: the JAX pager counts this a hit.
                del self._pending[key]
                self._admit(handle, *staged[1].result())
                self.hits += 1
            else:
                # Stale generation (rewritten segment): drop, then reload.
                self.invalidate(handle)
                self._admit(handle, *self._stage(handle,
                                                 self._copy_stream()))
                self.misses += 1
            self._evict_to_budget(keep=key)
        gen, engine, nbytes, upload = self._resident[key]
        if upload is not None:
            upload.wait(_device_tensors(engine))
            self._resident[key] = (gen, engine, nbytes, None)
        return engine

    def prefetch(self, handle) -> None:
        """Start paging ``handle`` in on the prefetch thread, without
        blocking.

        Its host work and its copies (on the copy stream) overlap with
        whatever the caller does next, the current segment's sweep.
        Skipped — and counted as ``prefetch_skipped`` — when loading it
        would evict the most recently acquired segment (prefetching must
        never cannibalize the working segment); not counted when the
        segment is resident or already staged.
        """
        if not self.prefetch_enabled or self.config is None:
            return
        key = handle.seg_dir
        entry = self._resident.get(key)
        staged = self._pending.get(key)
        if any(e is not None and e[0] == handle.generation
               for e in (entry, staged)):
            return
        if self.budget_bytes is not None and self._resident:
            incoming = handle.mapped_bytes()  # upper bound on device size
            spare = self.budget_bytes - self.resident_bytes()
            mru_bytes = next(reversed(self._resident.values()))[2]
            if spare + (self.resident_bytes() - mru_bytes) < incoming:
                # Even evicting everything but the MRU segment cannot fit
                # the prefetch without touching the working segment.
                self.prefetch_skipped += 1
                return
        self.invalidate(handle)
        if self._worker is None:
            self._worker = ThreadPoolExecutor(
                1, thread_name_prefix="segment-prefetch")
        self._pending[key] = (handle.generation, self._worker.submit(
            self._stage, handle, self._copy_stream()))
        self.prefetches += 1

    # -- invalidation ------------------------------------------------------
    def invalidate(self, handle) -> None:
        """Drop one segment's residency (after an in-place rewrite), and
        its staged prefetch once that has finished (raising its error)."""
        staged = self._pending.pop(handle.seg_dir, None)
        if staged is not None:
            staged[1].result()
        if handle.seg_dir in self._resident:
            self._drop(handle.seg_dir)

    def evict_all(self) -> None:
        for key in list(self._pending):
            self._pending.pop(key)[1].result()
        for key in list(self._resident.keys()):
            self._drop(key)

    # -- observability -----------------------------------------------------
    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "prefetches": self.prefetches,
            "prefetch_skipped": self.prefetch_skipped,
            "bytes_loaded": self.bytes_loaded,
            "bytes_evicted": self.bytes_evicted,
            "resident_bytes": self.resident_bytes(),
            "resident_segments": len(self._resident),
            "budget_bytes": self.budget_bytes,
        }
