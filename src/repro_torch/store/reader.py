"""mmap-backed segment reading: zero-copy host views, explicit H2D copies
(:mod:`repro.store.reader` on PyTorch; it reads the stores either package
writes).

:class:`SegmentReader` opens one committed segment directory, validates
it against its manifest (size always, CRC-32 by default), and exposes the
persisted arrays as read-only ``np.memmap`` views — nothing is pulled
into host RAM until a consumer touches it, and nothing reaches the
device until :meth:`SegmentReader.load_engine` reconstructs the index
through an :class:`Upload`: each mmap'd array is copied into pinned host
memory, then to the device with ``non_blocking=True`` on the upload's
stream, and an event recorded after the last copy tells the consumer's
stream when to start.  That load is the **only** H2D transfer of the
paging path, which is what makes the
:class:`~repro_torch.store.pager.SegmentPager` byte accounting exact.
The documents stay on the host, as copy-on-write maps of their files.

:class:`SegmentStore` is the store-level view: the ordered segment list
from ``STORE.json``, plus the two mutations the lifecycle needs —
``append_segment`` (spill a sealed segment) and ``rewrite_segment``
(compaction's in-place generation bump).  Both commit through the atomic
manifest protocol in :mod:`repro_torch.store.format`.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from repro_torch.core.index import (
    TILED_ARRAY_FIELDS, TILED_OPTIONAL_ARRAY_FIELDS, TiledIndex,
)
from repro_torch.core.sparse import SparseBatch
from repro_torch.sched.planner import store_plan_token
from repro_torch.store import format as fmt
from repro_torch.store.writer import write_segment
from repro_torch.utils import resolve_device


class Upload:
    """The H2D copies of one segment's index.

    On a CUDA ``device``, :meth:`put` copies an mmap'd array into a pinned
    host buffer, then to a device tensor with ``non_blocking=True``, the
    tensor allocated and the copy queued on ``stream`` (default: the
    current stream).  A tensor allocated on the copy stream comes from
    that stream's own blocks, so no block that another stream's queued
    work still reads is written early.  :meth:`finish` records
    :attr:`event` after the last copy.  A consumer's stream waits on it
    before touching the tensors (:meth:`wait`), and the pinned buffers
    stay referenced until the event has completed (:meth:`done`), after
    which PyTorch's pinned-memory cache hands them to the next page-in.
    On the CPU, :meth:`put` is a plain copy (a read-only mmap cannot back
    a tensor).
    """

    def __init__(self, device, stream=None):
        self.device = resolve_device(device)
        self.stream = stream
        self.pinned: list[torch.Tensor] = []
        self.event = None
        if self.device.type == "cuda" and stream is None:
            self.stream = torch.cuda.current_stream(self.device)

    def put(self, arr: np.ndarray) -> torch.Tensor:
        if self.device.type != "cuda":
            return torch.from_numpy(np.array(arr))
        dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
        host = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
        host.numpy()[...] = arr
        self.pinned.append(host)
        with torch.cuda.stream(self.stream):
            out = torch.empty(arr.shape, dtype=dtype, device=self.device)
            out.copy_(host, non_blocking=True)
        return out

    def finish(self) -> "Upload":
        if self.device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record(self.stream)
        return self

    def wait(self, tensors=()) -> None:
        """Make the current stream wait for the copies, and mark
        ``tensors`` (the consumer's view of what this upload made) as used
        by it, so the allocator does not reuse their blocks while its
        queued work still reads them."""
        if self.event is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(self.event)
        for t in tensors:
            t.record_stream(cur)

    def done(self) -> bool:
        """Whether the copies have completed (the pinned buffers are then
        released)."""
        if self.event is not None and not self.event.query():
            return False
        self.pinned.clear()
        return True


class SegmentReader:
    """Validated, lazy, zero-copy view of one committed segment."""

    def __init__(self, seg_dir: str, verify_checksums: bool = True):
        self.seg_dir = str(seg_dir)
        self.verify_checksums = verify_checksums
        self.manifest = fmt.read_manifest(self.seg_dir)

    # -- manifest scalars --------------------------------------------------
    @property
    def kind(self) -> str:
        return self.manifest["kind"]

    @property
    def num_docs(self) -> int:
        return int(self.manifest["num_docs"])

    @property
    def count(self) -> int:
        return int(self.manifest["count"])

    @property
    def vocab_size(self) -> int:
        return int(self.manifest["vocab_size"])

    @property
    def generation(self) -> int:
        return int(self.manifest["generation"])

    def mapped_bytes(self) -> int:
        return fmt.mapped_bytes(self.manifest)

    def validate(self) -> None:
        """Check every committed array (existence, size, checksum) without
        mapping any of them — the cheap open-time integrity gate."""
        for name, entry in self.manifest["arrays"].items():
            fmt.check_array(self.seg_dir, name, entry,
                            self.verify_checksums)

    # -- arrays ------------------------------------------------------------
    def array(self, name: str, private: bool = False) -> np.ndarray:
        """Validated read-only (``private``: copy-on-write) memmap of one
        committed array."""
        return fmt.load_array(self.seg_dir, name,
                              self.manifest["arrays"][name],
                              self.verify_checksums, private=private)

    def optional_array(self, name: str) -> Optional[np.ndarray]:
        if name not in self.manifest["arrays"]:
            return None
        return self.array(name)

    def docs(self) -> SparseBatch:
        """The segment's documents as an mmap-backed (host-side) batch:
        CPU tensors over copy-on-write maps, nothing copied."""
        return SparseBatch(
            torch.from_numpy(self.array("docs_term_ids", private=True)),
            torch.from_numpy(self.array("docs_values", private=True)),
            self.vocab_size,
        )

    def deleted_mask(self) -> Optional[np.ndarray]:
        """Materialized tombstone mask (engines mutate theirs in place, so
        handing out the read-only mmap would crash the first delete)."""
        arr = self.optional_array("deleted")
        return None if arr is None else np.array(arr, dtype=bool)

    def id_map(self) -> Optional[np.ndarray]:
        """local position -> global doc id, present on compacted segments."""
        arr = self.optional_array("id_map")
        return None if arr is None else np.array(arr, dtype=np.int64)

    # -- reconstruction ----------------------------------------------------
    def load_index(self, upload: Upload) -> Optional[TiledIndex]:
        """TiledIndex on ``upload.device``, bit-identical to the one that
        was persisted (``kind="tiled"`` only; ``None`` for docs-kind
        segments).

        Every array goes through one ``upload.put`` — this loop *is* the
        segment's H2D transfer; the caller finishes the upload and waits
        on it before use.  The index carries a stable PlanCache token
        (:func:`repro_torch.sched.planner.store_plan_token`), so an
        evict/reload cycle keeps its cached demand plans while a
        compaction (generation bump) drops them.
        """
        if self.kind != "tiled":
            return None
        geom = self.manifest["geometry"]
        fields = {
            name: upload.put(self.array(name))
            for name in TILED_ARRAY_FIELDS
        }
        for name in TILED_OPTIONAL_ARRAY_FIELDS:
            arr = self.optional_array(name)
            fields[name] = None if arr is None else upload.put(arr)
        idx = TiledIndex(
            num_docs=self.num_docs,
            vocab_size=self.vocab_size,
            term_block=int(geom["term_block"]),
            doc_block=int(geom["doc_block"]),
            chunk_size=int(geom["chunk_size"]),
            bounds_format=geom["bounds_format"],
            **fields,
        )
        idx._plan_cache_token = store_plan_token(self.seg_dir,
                                                 self.generation)
        return idx

    def load_engine(self, config, upload: Upload):
        """A :class:`~repro_torch.core.engine.RetrievalEngine` on
        ``upload.device`` for this segment — bit-identical to one built
        fresh over the same docs.

        ``kind="tiled"``: persisted arrays -> ``upload``, no rebuild (the
        engine is ready once the caller's stream waits on the upload).
        ``kind="docs"``: deterministic rebuild from the mmap'd documents
        on the current stream (index construction is a pure function of
        (docs, config)).  Tombstones are restored either way.
        """
        from repro_torch.core.engine import RetrievalEngine

        if config.engine != self.manifest["engine"]:
            raise ValueError(
                f"segment {self.seg_dir!r} was written for engine "
                f"{self.manifest['engine']!r}, not {config.engine!r}; "
                "geometry and persisted arrays are engine-specific"
            )
        deleted = self.deleted_mask()
        if self.kind == "tiled":
            unperm = self.optional_array("doc_unperm")
            return RetrievalEngine.from_prebuilt(
                self.docs(), config, self.load_index(upload),
                doc_unperm=None if unperm is None else np.array(unperm),
                deleted=deleted, device=upload.device,
            )
        eng = RetrievalEngine(self.docs(), config, device=upload.device)
        if deleted is not None:
            eng._deleted = deleted
        return eng


class SegmentHandle:
    """One store segment: metadata without residency.

    Everything a :class:`~repro_torch.core.session.Retriever` needs to *plan*
    around a segment — logical span, tombstone count, on-disk and
    device-side byte sizes — is answered from the manifest, so a spilled
    segment costs zero device memory until the pager actually pages it
    in through :meth:`load_engine`.
    """

    def __init__(self, store: "SegmentStore", name: str):
        self.store = store
        self.name = name
        self.seg_dir = os.path.join(store.path, name)
        self._reader: Optional[SegmentReader] = None

    def reader(self) -> SegmentReader:
        if self._reader is None:
            self._reader = SegmentReader(
                self.seg_dir, self.store.verify_checksums
            )
        return self._reader

    def refresh(self) -> None:
        """Drop the cached manifest view (after an in-place rewrite)."""
        self._reader = None

    @property
    def count(self) -> int:
        return self.reader().count

    @property
    def num_docs(self) -> int:
        return self.reader().num_docs

    @property
    def generation(self) -> int:
        return self.reader().generation

    @property
    def vocab_size(self) -> int:
        return self.reader().vocab_size

    def mapped_bytes(self) -> int:
        return self.reader().mapped_bytes()

    def bounds_memory(self) -> Optional[dict]:
        return self.reader().manifest.get("bounds_memory")

    def deleted_count(self) -> int:
        mask = self.reader().deleted_mask()
        return 0 if mask is None else int(mask.sum())

    def load_engine(self, config, upload: Upload):
        return self.reader().load_engine(config, upload)

    def write_deleted(self, mask: np.ndarray) -> None:
        """Persist an updated tombstone mask.

        Tombstones are monotone until compaction, so this commits
        without a generation bump — but never by overwriting a committed
        file: the new mask gets a fresh revision-tagged filename, the
        manifest commit flips to it, and the superseded file is pruned
        afterwards.  A crash at any point leaves the old manifest
        pointing at the old, intact array.
        """
        reader = self.reader()
        manifest = dict(reader.manifest)
        rev = int(manifest.get("deleted_rev", 0)) + 1
        arrays = dict(manifest["arrays"])
        arrays["deleted"] = fmt.write_array(
            self.seg_dir, "deleted", np.asarray(mask, dtype=bool),
            reader.generation, tag=f".r{rev}",
        )
        manifest["arrays"] = arrays
        manifest["deleted_rev"] = rev
        fmt.atomic_write_json(
            os.path.join(self.seg_dir, fmt.MANIFEST_NAME), manifest
        )
        fmt.prune_stale_generations(self.seg_dir, manifest)
        self.refresh()


class SegmentStore:
    """The on-disk store: ordered segments + ``STORE.json`` commit point."""

    def __init__(self, path: str, verify_checksums: bool = True):
        self.path = str(path)
        self.verify_checksums = verify_checksums
        self.manifest = fmt.read_store_manifest(self.path)
        self.segments = [
            SegmentHandle(self, entry["dir"])
            for entry in self.manifest["segments"]
        ]

    @classmethod
    def open(cls, path: str,
             verify_checksums: bool = True) -> "SegmentStore":
        return cls(path, verify_checksums)

    @property
    def vocab_size(self) -> int:
        return int(self.manifest["vocab_size"])

    @property
    def generation(self) -> int:
        return int(self.manifest["generation"])

    @property
    def config_snapshot(self) -> dict:
        return self.manifest["config"]

    def validate(self) -> None:
        """Integrity-check every segment (manifest + array sizes/CRCs)."""
        for handle in self.segments:
            handle.reader().validate()

    def _commit(self) -> None:
        self.manifest["generation"] = self.generation + 1
        self.manifest["segments"] = [
            {"dir": h.name, "count": h.count, "generation": h.generation}
            for h in self.segments
        ]
        fmt.atomic_write_json(
            os.path.join(self.path, fmt.STORE_MANIFEST_NAME), self.manifest
        )

    def append_segment(self, docs: SparseBatch, config,
                       device="cuda") -> SegmentHandle:
        """Spill one sealed segment (its index built on ``device``) and
        commit the extended store."""
        if docs.vocab_size != self.vocab_size:
            raise ValueError(
                f"vocab mismatch: store has {self.vocab_size}, batch has "
                f"{docs.vocab_size}"
            )
        name = fmt.segment_dir_name(len(self.segments))
        write_segment(os.path.join(self.path, name), docs, config,
                      device=device)
        handle = SegmentHandle(self, name)
        self.segments.append(handle)
        self._commit()
        return handle

    def rewrite_segment(
        self,
        handle: SegmentHandle,
        docs: SparseBatch,
        config,
        *,
        count: int,
        engine=None,
        id_map: Optional[np.ndarray] = None,
    ) -> SegmentHandle:
        """Rewrite one segment in place (compaction).

        Writes a full new file generation, commits by replacing the
        segment manifest, prunes the old generation's files, then
        commits the store manifest — crash-safe at every step (see
        :mod:`repro_torch.store.format`).
        """
        write_segment(
            handle.seg_dir, docs, config,
            count=count, generation=handle.generation + 1,
            engine=engine, id_map=id_map,
        )
        handle.refresh()
        self._commit()
        return handle
