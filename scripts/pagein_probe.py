#!/usr/bin/env python3
"""A store segment's page-in split into its parts, and a paged search with
the pager's prefetch off and on, at phase 8e's size (``chip_smoke.py``):
serve_1m's corpus (1,000,000 docs, V = 30,522, 500 queries, k = 1000)
written by ``SegmentWriter`` in segments of 262,144 docs to a temporary
directory, removed at the end.  ``--engines`` takes ``tiled`` (the
msmarco-like corpus, as 8e) and ``tiled-bmp-fused`` (the reordered topical
corpus, as phase 3b).

For each engine:

1. The resident ``Retriever`` over the same four segments: one search,
   synchronised (the sweeps a prefetch can hide behind).
2. The first segment's page-in, part by part on the host clock (its files
   were just written, so they are read from the page cache): the CRC-32
   pass over every file it maps (index arrays and documents); pinned
   buffers for its index arrays from fresh pinned memory, then again from
   PyTorch's pinned cache; the mmap reads into them; the H2D copies
   (CUDA events).  Then one whole ``SegmentPager.acquire`` of it.
3. The first search of the store opened with no budget, prefetch off and
   on in turns (off, on, on, off), each from a new
   ``Retriever.from_store``, held bitwise to the resident retriever, with
   the pager's counters; after one warm-up paged search, so that every
   turn draws its pinned buffers from PyTorch's pinned cache.
   ``--crc library read`` runs each turn (and part 2's CRC pass) once
   with the store's own CRC pass (a read-only map, 64 MiB a
   ``zlib.crc32`` call) and once reading the file in 1 MiB chunks, as
   the JAX package's ``repro.store.format.crc32_file`` does; the order
   alternates from turn to turn.

Run from the root of a checkout with one CUDA card:

    python3 scripts/pagein_probe.py [--engines tiled tiled-bmp-fused]
        [--crc library read]

It prints the card's name and power limit and, as its last line, one JSON
object with every number.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import zlib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def wall(fn, dev):
    """``fn()`` on the synchronised host clock -> (result, ms)."""
    import torch

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, 1e3 * (time.perf_counter() - t0)


def crc32_read(path: str, chunk: int = 1 << 20) -> int:
    """CRC-32 of a file read ``chunk`` bytes at a time (JAX's way)."""
    crc = 0
    with open(path, "rb") as f:
        while buf := f.read(chunk):
            crc = zlib.crc32(buf, crc)
    return crc & 0xFFFFFFFF


def use_crc(variant: str) -> None:
    """Make the store's CRC pass the library's own (``library``) or
    :func:`crc32_read` (``read``)."""
    from repro_torch.store import format as fmt

    if not hasattr(fmt, "_probe_crc32_file"):
        fmt._probe_crc32_file = fmt.crc32_file
    fmt.crc32_file = {"library": fmt._probe_crc32_file,
                      "read": crc32_read}[variant]


def split_page_in(handle, cfg, dev, variants) -> dict:
    """Part 2: one segment's page-in, part by part."""
    import numpy as np
    import torch

    from repro_torch.core.index import (
        TILED_ARRAY_FIELDS, TILED_OPTIONAL_ARRAY_FIELDS,
    )
    from repro_torch.store import SegmentPager
    from repro_torch.store import format as fmt

    reader = handle.reader()
    entries = reader.manifest["arrays"]
    crc_bytes = sum(entry["nbytes"] for entry in entries.values())
    crc_ms = {}
    for variant in variants:
        use_crc(variant)
        t0 = time.perf_counter()
        for entry in entries.values():
            fmt.crc32_file(os.path.join(reader.seg_dir, entry["file"]))
        crc_ms[variant] = 1e3 * (time.perf_counter() - t0)
    use_crc("library")
    names = [n for n in TILED_ARRAY_FIELDS + TILED_OPTIONAL_ARRAY_FIELDS
             if n in entries]
    arrays = [np.load(os.path.join(reader.seg_dir, entries[n]["file"]),
                      mmap_mode="r") for n in names]
    index_bytes = sum(a.nbytes for a in arrays)

    def pin():
        return [torch.empty(a.shape, dtype=torch.from_numpy(
            np.empty(0, a.dtype)).dtype, pin_memory=True) for a in arrays]

    t0 = time.perf_counter()
    host = pin()
    fresh_ms = 1e3 * (time.perf_counter() - t0)
    del host
    t0 = time.perf_counter()
    host = pin()
    cached_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for h, a in zip(host, arrays):
        h.numpy()[...] = a
    fill_ms = 1e3 * (time.perf_counter() - t0)
    outs = [torch.empty(h.shape, dtype=h.dtype, device=dev) for h in host]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for o, h in zip(outs, host):
        o.copy_(h, non_blocking=True)
    end.record()
    torch.cuda.synchronize(dev)
    h2d_ms = start.elapsed_time(end)
    del outs, host
    pager = SegmentPager(config=cfg, device=dev)
    _, acquire_ms = wall(lambda: pager.acquire(handle), dev)
    return dict(crc_ms=crc_ms, crc_bytes=crc_bytes,
                crc_gbs={c: crc_bytes / ms / 1e6 for c, ms in crc_ms.items()},
                index_bytes=index_bytes,
                pin_fresh_ms=fresh_ms, pin_cached_ms=cached_ms,
                fill_ms=fill_ms, fill_gbs=index_bytes / fill_ms / 1e6,
                h2d_ms=h2d_ms, h2d_gbs=index_bytes / h2d_ms / 1e6,
                acquire_ms=acquire_ms)


def probe(engine: str, dev, sizes, variants) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import RetrievalConfig, Retriever
    from repro_torch.data.synthetic import (
        make_msmarco_like, make_topical_corpus,
    )
    from repro_torch.store import SegmentStore, SegmentWriter

    import chip_smoke as cs

    make = make_msmarco_like if engine == "tiled" else make_topical_corpus
    corpus = make(sizes.docs, sizes.queries, vocab_size=sizes.vocab, seed=0,
                  device=dev)
    extra = ({} if engine == "tiled"
             else dict(reorder_docs=True, reorder_method="df-signature"))
    cfg = RetrievalConfig(engine=engine, k=sizes.k, **extra)
    pieces = cs.segments(corpus.docs, sizes)
    resident = Retriever(config=cfg, device=dev)
    for p in pieces:
        resident.add_docs(p)
    resident.search(corpus.queries)  # warm-up: the kernels' first launch
    want, resident_ms = wall(lambda: resident.search(corpus.queries), dev)
    out = dict(engine=engine, resident_ms=resident_ms, turns=[])
    cs.log(f"{engine}: resident search over {len(pieces)} segments "
           f"{resident_ms!r} ms")
    with tempfile.TemporaryDirectory(prefix="pagein_probe_") as d:
        path = os.path.join(d, "store")
        w = SegmentWriter(path, cfg, segment_docs=sizes.state_segment_docs,
                          device=dev)
        for p in pieces:
            w.add_docs(p)
        w.finalize()
        del pieces, resident
        torch.cuda.empty_cache()
        out["split"] = split_page_in(SegmentStore.open(path).segments[0],
                                     cfg, dev, variants)
        cs.log(f"{engine}: page-in of segment 0: {out['split']}")
        # A first paged search allocates fresh pinned memory; the turns
        # then draw from PyTorch's pinned cache alike.
        paged = Retriever.from_store(path, device=dev)
        _, out["warmup_ms"] = wall(lambda: paged.search(corpus.queries), dev)
        cs.log(f"{engine}: warm-up paged search {out['warmup_ms']!r} ms")
        del paged
        for turn, prefetch in enumerate((False, True, True, False)):
            for variant in variants[::-1] if turn % 2 else variants:
                use_crc(variant)
                paged = Retriever.from_store(path, prefetch=prefetch,
                                             device=dev)
                got, ms = wall(lambda: paged.search(corpus.queries), dev)
                if not all(np.array_equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{engine}: paged search (prefetch "
                                         f"{prefetch}) differs from resident")
                st = paged.pager_stats()
                out["turns"].append(dict(prefetch=prefetch, crc=variant,
                                         ms=ms, stats=st))
                cs.log(f"{engine}: first paged search, prefetch {prefetch}, "
                       f"CRC {variant}: {ms!r} ms, {st}")
                del paged
                torch.cuda.empty_cache()
        use_crc("library")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engines", nargs="+",
                    default=["tiled", "tiled-bmp-fused"])
    ap.add_argument("--crc", nargs="+", choices=("library", "read"),
                    default=["library"])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("pagein_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke as cs
    from repro_torch.kernels import build

    build.build(("scatter_score", "bmp_scan"))
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    rows = [probe(e, dev, cs.Sizes(), args.crc) for e in args.engines]
    print(card)
    print(json.dumps({"card": card, "pagein_probe": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
