"""repro_torch.store — out-of-core segment lifecycle (build, spill, page),
the port of :mod:`repro.store` in the same on-disk format.

Streaming segment builder (:class:`SegmentWriter`), validated mmap
reader (:class:`SegmentReader` / :class:`SegmentStore`), and LRU device
pager (:class:`SegmentPager`, its budget in CUDA bytes, its page-ins
pinned and non-blocking on a copy stream of its own) behind a versioned,
checksummed, crash-safe on-disk format (:mod:`repro_torch.store.format`).
The serving entry point is ``repro_torch.core.session.Retriever.
from_store(path, device_budget_bytes=...)``.
"""
from repro_torch.store.format import (
    FORMAT_VERSION, StoreCorruptionError,
)
from repro_torch.store.pager import SegmentPager, engine_device_bytes
from repro_torch.store.reader import (
    SegmentHandle, SegmentReader, SegmentStore, Upload,
)
from repro_torch.store.writer import SegmentWriter, write_segment

__all__ = [
    "FORMAT_VERSION",
    "StoreCorruptionError",
    "SegmentHandle",
    "SegmentPager",
    "SegmentReader",
    "SegmentStore",
    "SegmentWriter",
    "Upload",
    "engine_device_bytes",
    "write_segment",
]
