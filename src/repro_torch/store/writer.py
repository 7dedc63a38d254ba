"""Streaming segment builder: corpus size independent of host memory
(:mod:`repro.store.writer`; the stores it writes open in either package).

:class:`SegmentWriter` ingests document batches and seals them into
on-disk segments of ``segment_docs`` rows each — peak host memory is
bounded by **one segment** (the buffered rows plus that segment's index
build), never the corpus.  Each sealed segment is written with
:func:`write_segment`; the store is committed by ``finalize()`` writing
``STORE.json`` (see :mod:`repro_torch.store.format` for the crash-safety
contract).

What gets persisted per segment depends on the configured engine:

* engines whose index is a :class:`~repro_torch.core.index.TiledIndex`
  (``tiled``, the pruned/BMP family) persist **every index
  array** — posting chunks, per-block chunk runs, coarse + quantized
  fine bounds in the configured layout — so loading a segment is an
  mmap + device put, not a rebuild (``kind="tiled"``);
* every other engine persists the documents only (``kind="docs"``) and
  rebuilds its index at load time — index construction is a pure
  function of (docs, config), so the reload is still bit-identical.

Both kinds also persist the documents themselves (padded ``SparseBatch``
arrays): compaction and destructive rebuilds need them, and they stay
host-side (mmap) at serve time — only index arrays page onto device.

A segment's index is built on ``device`` (default ``"cuda"``) and copied
back to the host to be written; the buffered rows are numpy.
"""
from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.core.index import (
    TILED_ARRAY_FIELDS, TILED_OPTIONAL_ARRAY_FIELDS, TiledIndex,
)
from repro_torch.core.sparse import SparseBatch
from repro_torch.store import format as fmt
from repro_torch.utils import resolve_device


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _segment_kind(config) -> str:
    spec = registry.get_engine(config.engine)
    return "tiled" if spec.index_type is TiledIndex else "docs"


def write_segment(
    seg_dir: str,
    docs: SparseBatch,
    config,
    *,
    count: Optional[int] = None,
    generation: int = 0,
    engine=None,
    deleted: Optional[np.ndarray] = None,
    id_map: Optional[np.ndarray] = None,
    device="cuda",
) -> dict:
    """Write one segment directory and commit it (atomic manifest).

    ``count`` is the segment's *logical id span* (defaults to
    ``docs.batch``; a compacted rewrite passes the original span so the
    global id space survives).  ``engine`` may pass an already-built
    :class:`~repro_torch.core.engine.RetrievalEngine` over ``docs`` (the
    compaction path has one in hand); otherwise tiled-kind segments
    build one on ``device`` here and drop it after serialization.
    Returns the committed manifest.
    """
    from repro_torch.core.engine import RetrievalEngine

    os.makedirs(seg_dir, exist_ok=True)
    kind = _segment_kind(config)
    arrays: dict[str, dict] = {}

    ids = _host(docs.term_ids)
    vals = _host(docs.values)
    arrays["docs_term_ids"] = fmt.write_array(
        seg_dir, "docs_term_ids", ids.astype(np.int32, copy=False),
        generation)
    arrays["docs_values"] = fmt.write_array(
        seg_dir, "docs_values", vals.astype(np.float32, copy=False),
        generation)

    bounds_memory = None
    if kind == "tiled":
        if engine is None:
            engine = RetrievalEngine(docs, config, device=device)
        index = engine._index
        if not isinstance(index, TiledIndex):  # registry contract
            raise ValueError(
                f"engine {config.engine!r} declared a TiledIndex but "
                "built none"
            )
        for name in TILED_ARRAY_FIELDS:
            arr = getattr(index, name)
            if arr is None:
                raise ValueError(
                    f"TiledIndex field {name!r} is unset; the store "
                    "format requires the full chunk-run payload"
                )
            arrays[name] = fmt.write_array(seg_dir, name, _host(arr),
                                           generation)
        for name in TILED_OPTIONAL_ARRAY_FIELDS:
            arr = getattr(index, name)
            if arr is not None:
                arrays[name] = fmt.write_array(
                    seg_dir, name, _host(arr), generation)
        if engine._doc_unperm is not None:
            # int32, as the JAX engine holds it
            arrays["doc_unperm"] = fmt.write_array(
                seg_dir, "doc_unperm",
                _host(engine._doc_unperm).astype(np.int32), generation)
        if index.has_fine_bounds:
            bounds_memory = index.bounds_memory()
    # Docs-kind segments rebuild at load, re-deriving any permutation
    # deterministically — nothing extra to persist.

    if deleted is not None and np.asarray(deleted).any():
        arrays["deleted"] = fmt.write_array(
            seg_dir, "deleted", np.asarray(deleted, dtype=bool), generation)
    if id_map is not None:
        arrays["id_map"] = fmt.write_array(
            seg_dir, "id_map", np.asarray(id_map, dtype=np.int64),
            generation)

    manifest = {
        "format_version": fmt.FORMAT_VERSION,
        "kind": kind,
        "engine": config.engine,
        "num_docs": docs.batch,
        "count": int(count if count is not None else docs.batch),
        "vocab_size": docs.vocab_size,
        "generation": generation,
        "geometry": fmt.geometry_from_config(config),
        "bounds_memory": bounds_memory,
        "arrays": arrays,
    }
    fmt.atomic_write_json(os.path.join(seg_dir, fmt.MANIFEST_NAME),
                          manifest)
    # The manifest is committed: reclaim any previous generation's files.
    fmt.prune_stale_generations(seg_dir, manifest)
    return manifest


class SegmentWriter:
    """Streaming out-of-core index builder.

    ::

        writer = SegmentWriter(path, config, segment_docs=4096)
        writer.ingest(doc_batches)          # any iterable of SparseBatch
        r = Retriever.from_store(path, device_budget_bytes=...)

    ``add_docs`` buffers rows and seals a segment every ``segment_docs``
    documents; ``finalize`` seals the tail and commits ``STORE.json``.
    Peak host memory is one segment's rows plus its index build —
    ``max_buffered_docs`` records the high-water mark so tests (and
    capacity planning) can verify the bound.  For tiled-family engines
    ``segment_docs`` must be a multiple of ``config.doc_block``: aligned
    segments are what makes the paged search bit-identical to the
    fully-resident path (see ``repro_torch.core.session``).  Indices are
    built on ``device`` (default ``"cuda"``).
    """

    def __init__(self, path: str, config=None, segment_docs: int = 4096,
                 device="cuda"):
        from repro_torch.core.engine import RetrievalConfig

        self.device = resolve_device(device)
        self.path = str(path)
        self.config = config or RetrievalConfig()
        if segment_docs < 1:
            raise ValueError(
                f"segment_docs must be >= 1, got {segment_docs}")
        if (_segment_kind(self.config) == "tiled"
                and segment_docs % self.config.doc_block != 0):
            raise ValueError(
                f"segment_docs={segment_docs} must be a multiple of "
                f"doc_block={self.config.doc_block}: doc-block-aligned "
                "segments are the bit-exactness contract of the paged "
                "search path"
            )
        if os.path.exists(os.path.join(self.path,
                                       fmt.STORE_MANIFEST_NAME)):
            raise ValueError(
                f"{self.path!r} already holds a committed store; open it "
                "with Retriever.from_store / SegmentStore.open and "
                "add_docs to append"
            )
        os.makedirs(self.path, exist_ok=True)
        self.segment_docs = segment_docs
        self._buffer: list[tuple[np.ndarray, np.ndarray]] = []
        self._buffered = 0
        self._vocab_size: Optional[int] = None
        self._segments: list[dict] = []  # STORE.json entries
        self.docs_written = 0
        self.max_buffered_docs = 0  # streaming-bound observability
        self._finalized = False

    @property
    def segments_written(self) -> int:
        return len(self._segments)

    def add_docs(self, docs: SparseBatch) -> None:
        """Buffer a document batch, sealing full segments as they fill.

        Batches are consumed in segment-sized slices, so the buffer —
        and with it peak host memory — never exceeds ``segment_docs``
        rows (``max_buffered_docs`` is the tested witness).
        """
        if self._finalized:
            raise ValueError("writer is finalized; open the store to "
                             "append further segments")
        if not docs.batch:
            return
        if self._vocab_size is None:
            self._vocab_size = docs.vocab_size
        elif docs.vocab_size != self._vocab_size:
            raise ValueError(
                f"vocab mismatch: store has {self._vocab_size}, batch "
                f"has {docs.vocab_size}"
            )
        ids = _host(docs.term_ids)
        vals = _host(docs.values)
        row, n = 0, docs.batch
        while row < n:
            take = min(self.segment_docs - self._buffered, n - row)
            self._buffer.append(
                (ids[row:row + take], vals[row:row + take])
            )
            self._buffered += take
            row += take
            self.max_buffered_docs = max(self.max_buffered_docs,
                                         self._buffered)
            if self._buffered == self.segment_docs:
                self._seal(self.segment_docs)

    def ingest(self, doc_batches: Iterable[SparseBatch]) -> str:
        """Stream ``doc_batches`` into the store and commit it.

        The iterable is consumed lazily — a generator over a corpus that
        never fits in memory is the intended caller.  Returns the store
        path.
        """
        for docs in doc_batches:
            self.add_docs(docs)
        return self.finalize()

    def _take_rows(self, n: int) -> SparseBatch:
        """Pop the first ``n`` buffered rows as one padded batch (host
        tensors; ``write_segment`` moves them to the device)."""
        taken: list[tuple[np.ndarray, np.ndarray]] = []
        remaining = n
        while remaining > 0:
            ids, vals = self._buffer[0]
            if len(ids) <= remaining:
                taken.append(self._buffer.pop(0))
                remaining -= len(ids)
            else:
                taken.append((ids[:remaining], vals[:remaining]))
                self._buffer[0] = (ids[remaining:], vals[remaining:])
                remaining = 0
        self._buffered -= n
        kmax = max(t[0].shape[1] for t in taken)
        out_ids = np.full((n, kmax), -1, np.int32)
        out_vals = np.zeros((n, kmax), np.float32)
        row = 0
        for ids, vals in taken:
            out_ids[row:row + len(ids), : ids.shape[1]] = ids
            out_vals[row:row + len(ids), : ids.shape[1]] = vals
            row += len(ids)
        return SparseBatch(torch.from_numpy(out_ids),
                           torch.from_numpy(out_vals), self._vocab_size)

    def _seal(self, n: int) -> None:
        docs = self._take_rows(n)
        name = fmt.segment_dir_name(len(self._segments))
        manifest = write_segment(
            os.path.join(self.path, name), docs, self.config,
            device=self.device,
        )
        self._segments.append({
            "dir": name,
            "count": manifest["count"],
            "generation": manifest["generation"],
        })
        self.docs_written += n

    def finalize(self) -> str:
        """Seal the tail segment and commit ``STORE.json``."""
        if self._finalized:
            return self.path
        if self._buffered:
            self._seal(self._buffered)
        if self._vocab_size is None:
            raise ValueError("no documents were ingested")
        fmt.atomic_write_json(
            os.path.join(self.path, fmt.STORE_MANIFEST_NAME),
            {
                "format_version": fmt.FORMAT_VERSION,
                "config": fmt.config_to_manifest(self.config),
                "vocab_size": self._vocab_size,
                "generation": 0,
                "segments": self._segments,
            },
        )
        self._finalized = True
        return self.path
