"""On-disk segment format for out-of-core corpora (:mod:`repro.store.
format`, the same format: version, file names, manifests and checksums).

One **segment** is one directory::

    seg_00000/
      MANIFEST.json          # commit point: written atomically, carries
                             # format version + per-array size/checksum
      docs_term_ids.g0.npy   # the segment's documents (padded SparseBatch)
      docs_values.g0.npy
      local_term.g0.npy ...  # kind="tiled": every TiledIndex array
      deleted.g0.npy         # optional: tombstone mask (bool [num_docs])
      id_map.g0.npy          # optional: local pos -> global id (compacted)
      doc_unperm.g0.npy      # optional: reorder_docs inverse permutation

and one **store** is a directory of segments plus ``STORE.json`` (the
ordered segment list, the config snapshot, and a monotone store
generation).  Arrays are plain ``.npy`` files so readers get zero-copy
``np.memmap`` views via ``np.load(..., mmap_mode="r")``; the ``.g<N>``
infix is the segment *generation* — an in-place rewrite (compaction)
writes a full new generation of files and commits by atomically
replacing ``MANIFEST.json``, so a crash at any point leaves either the
old or the new generation fully readable, never a mix.

Crash-safety contract
=====================

* Every manifest write is write-temp + ``fsync`` + ``os.replace`` (POSIX
  atomic rename) + directory ``fsync``: the manifest is the single
  commit point of a segment.
* The manifest records each array's exact file size and CRC-32; a
  truncated, missing, or bit-flipped array file raises
  :class:`StoreCorruptionError` at open instead of mmap'ing garbage.
* A segment directory without a readable manifest (crash mid-build) is
  itself a :class:`StoreCorruptionError` — partial segments are never
  silently skipped.

Interop with the JAX package
============================

A store written by either package opens in the other: the arrays are the
``TILED_ARRAY_FIELDS`` / ``TILED_OPTIONAL_ARRAY_FIELDS`` of ``TiledIndex``
(field for field the same in both), the docs and the optional
tombstones, id map and reorder inverse, with the JAX dtypes.  The config
snapshot in ``STORE.json`` holds every config field, ``pad_to`` included
(a ``segment`` store rebuilds its ``FlatIndex`` at that pad), and one JAX
key the port's ``RetrievalConfig`` has no field for: ``use_f32_scores``
(read by nothing).  :func:`config_to_manifest` writes it at JAX's
default; :func:`config_from_manifest` requires that default and drops it,
and refuses the JAX engines the port does not register under that name
(``pallas`` -> ``tiled``, ``pallas_ell`` -> ``ell``: the same kernels,
other names).
"""
from __future__ import annotations

import json
import mmap
import os
import zlib
from typing import Optional

import numpy as np

FORMAT_VERSION = 1
MANIFEST_NAME = "MANIFEST.json"
STORE_MANIFEST_NAME = "STORE.json"
SEGMENT_PREFIX = "seg_"

# TiledIndex scalar geometry carried in every tiled segment manifest.
GEOMETRY_KEYS = ("term_block", "doc_block", "chunk_size", "bounds_format")

# The JAX config snapshot's keys with no field in the port's config, at
# the only values the port serves: JAX's defaults.
JAX_ONLY_CONFIG = {"use_f32_scores": True}
# JAX engine names the port registers under another name.
JAX_ENGINE_NAMES = {"pallas": "tiled", "pallas_ell": "ell"}


class StoreCorruptionError(RuntimeError):
    """A segment/store directory failed validation (missing manifest,
    format-version mismatch, truncated array file, or checksum failure).

    Raised *before* any array is handed to a consumer, so a damaged
    store can never flow garbage into an index."""


def crc32_file(path: str, chunk: int = 1 << 26) -> int:
    """CRC-32 of a file, over a read-only map of it, ``chunk`` bytes a
    ``zlib.crc32`` call.  No copy: the checksum reads the page cache once.
    ``zlib.crc32`` releases the GIL, so a page-in's CRC pass on the pager's
    prefetch thread takes the GIL back once a chunk and does not queue
    behind a search's host work."""
    size = os.path.getsize(path)
    if size == 0:
        return 0
    crc = 0
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0,
                                           access=mmap.ACCESS_READ) as mm:
        view = memoryview(mm)
        try:
            for start in range(0, size, chunk):
                crc = zlib.crc32(view[start:start + chunk], crc)
        finally:
            view.release()
    return crc & 0xFFFFFFFF


def fsync_dir(path: str) -> None:
    """Flush a directory entry (the rename durability half of
    write-temp + rename)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_json(path: str, obj) -> None:
    """Crash-safe JSON write: temp file + fsync + atomic rename + dir
    fsync.  Readers see either the old file or the new one, never a
    partial write."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))


def write_array(seg_dir: str, name: str, arr: np.ndarray,
                generation: int, tag: str = "") -> dict:
    """Persist one array as ``<name>.g<generation><tag>.npy`` -> manifest
    entry.

    The entry records the exact on-disk size and CRC-32 so the reader
    can detect truncation (size) and bit rot (checksum) before mmap'ing.
    ``tag`` disambiguates same-generation rewrites of one array (the
    tombstone mask, whose updates are monotone and therefore commit
    without a full generation bump): the store protocol never overwrites
    a committed file in place — a new file is written, the manifest
    commit flips to it, and the orphan is pruned.
    """
    arr = np.asarray(arr)
    fname = f"{name}.g{generation}{tag}.npy"
    path = os.path.join(seg_dir, fname)
    with open(path, "wb") as f:
        np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())
    return {
        "file": fname,
        "dtype": str(arr.dtype),
        "shape": list(arr.shape),
        "nbytes": os.path.getsize(path),
        "crc32": crc32_file(path),
    }


def check_array(seg_dir: str, name: str, entry: dict,
                verify_checksums: bool = True) -> str:
    """Validate one manifest array entry; returns the array path.

    Size is always checked (truncation is the common crash artifact);
    the CRC pass is optional because it reads the whole file — the
    default everywhere in this repo, but a multi-GB production open may
    choose mmap-speed over bit-rot detection.
    """
    path = os.path.join(seg_dir, entry["file"])
    if not os.path.exists(path):
        raise StoreCorruptionError(
            f"segment {seg_dir!r}: array {name!r} file {entry['file']!r} "
            "is missing (partial write or deleted file)"
        )
    size = os.path.getsize(path)
    if size != entry["nbytes"]:
        raise StoreCorruptionError(
            f"segment {seg_dir!r}: array {name!r} is {size} bytes on disk "
            f"but the manifest recorded {entry['nbytes']} (truncated or "
            "partially written file)"
        )
    if verify_checksums and crc32_file(path) != entry["crc32"]:
        raise StoreCorruptionError(
            f"segment {seg_dir!r}: array {name!r} failed its CRC-32 check "
            "(bit rot or an overwrite outside the store protocol)"
        )
    return path


def load_array(seg_dir: str, name: str, entry: dict,
               verify_checksums: bool = True,
               private: bool = False) -> np.ndarray:
    """mmap one validated array (zero-copy, read-only; ``private``: a
    copy-on-write map, writable without touching the file, which
    ``torch.from_numpy`` wraps without a copy or a warning)."""
    path = check_array(seg_dir, name, entry, verify_checksums)
    arr = np.load(path, mmap_mode="c" if private else "r")
    if str(arr.dtype) != entry["dtype"] or list(arr.shape) != entry["shape"]:
        raise StoreCorruptionError(
            f"segment {seg_dir!r}: array {name!r} header says "
            f"{arr.dtype}{arr.shape} but the manifest recorded "
            f"{entry['dtype']}{tuple(entry['shape'])}"
        )
    return arr


def read_manifest(seg_dir: str) -> dict:
    """Load + sanity-check a segment manifest (the commit point)."""
    path = os.path.join(seg_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        raise StoreCorruptionError(
            f"segment {seg_dir!r} has no {MANIFEST_NAME} — the segment "
            "was never committed (crash mid-build) or is not a segment "
            "directory"
        )
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise StoreCorruptionError(
            f"segment {seg_dir!r}: unreadable {MANIFEST_NAME}: {e}"
        ) from e
    version = manifest.get("format_version")
    if version != FORMAT_VERSION:
        raise StoreCorruptionError(
            f"segment {seg_dir!r}: format_version {version!r} != "
            f"supported {FORMAT_VERSION}"
        )
    if "arrays" not in manifest or "kind" not in manifest:
        raise StoreCorruptionError(
            f"segment {seg_dir!r}: manifest is missing required keys"
        )
    return manifest


def read_store_manifest(path: str) -> dict:
    """Load + sanity-check ``STORE.json`` for a store directory."""
    mpath = os.path.join(path, STORE_MANIFEST_NAME)
    if not os.path.exists(mpath):
        raise StoreCorruptionError(
            f"{path!r} has no {STORE_MANIFEST_NAME} — not a segment store "
            "(or the writer crashed before finalize())"
        )
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise StoreCorruptionError(
            f"{path!r}: unreadable {STORE_MANIFEST_NAME}: {e}"
        ) from e
    if manifest.get("format_version") != FORMAT_VERSION:
        raise StoreCorruptionError(
            f"{path!r}: store format_version "
            f"{manifest.get('format_version')!r} != supported "
            f"{FORMAT_VERSION}"
        )
    for key in ("segments", "config", "vocab_size", "generation"):
        if key not in manifest:
            raise StoreCorruptionError(
                f"{path!r}: {STORE_MANIFEST_NAME} is missing {key!r}"
            )
    return manifest


def prune_stale_generations(seg_dir: str, manifest: dict) -> int:
    """Delete ``.npy`` files not referenced by the committed manifest.

    Called after an in-place rewrite commits: the previous generation's
    files are garbage the moment the new manifest is in place.  Safe to
    crash before/at any point — unreferenced files are re-collected on
    the next rewrite.  Returns the number of files removed.
    """
    live = {entry["file"] for entry in manifest["arrays"].values()}
    removed = 0
    for fname in os.listdir(seg_dir):
        if fname.endswith(".npy") and fname not in live:
            os.remove(os.path.join(seg_dir, fname))
            removed += 1
    return removed


def config_to_manifest(config) -> dict:
    """A JSON-able snapshot of a RetrievalConfig (serving-layer state —
    ``plan_cache``, ``obs`` — excluded; it is process-local by
    definition), with the JAX-only key at JAX's default."""
    import dataclasses

    out = dict(JAX_ONLY_CONFIG)
    for f in dataclasses.fields(config):
        if f.name in ("plan_cache", "obs"):
            continue
        out[f.name] = getattr(config, f.name)
    return out


def config_from_manifest(snap: dict) -> dict:
    """The port's ``RetrievalConfig`` keywords of a ``STORE.json`` config
    snapshot, written by either package.  Raises ``ValueError`` where the
    snapshot asks for what the port does not serve: a JAX-only key off
    its default, or a JAX engine the port registers under another name.
    """
    out = dict(snap)
    for key, want in JAX_ONLY_CONFIG.items():
        got = out.pop(key, want)
        if got != want:
            raise ValueError(
                f"store config {key}={got!r}: the port serves only "
                f"{key}={want!r} (JAX's default; nothing in the port "
                "reads another value)"
            )
    engine = out.get("engine")
    if engine in JAX_ENGINE_NAMES:
        raise ValueError(
            f"store engine {engine!r} is a JAX-only name: its kernel is "
            f"the port's {JAX_ENGINE_NAMES[engine]!r}; rewrite the store "
            f"with engine={JAX_ENGINE_NAMES[engine]!r}"
        )
    return out


def geometry_from_config(config) -> dict:
    return {key: getattr(config, key) for key in GEOMETRY_KEYS}


def segment_dir_name(index: int) -> str:
    return f"{SEGMENT_PREFIX}{index:05d}"


def mapped_bytes(manifest: dict) -> int:
    """Total on-disk bytes of a segment's committed arrays."""
    return sum(e["nbytes"] for e in manifest["arrays"].values())


def optional_entry(manifest: dict, name: str) -> Optional[dict]:
    return manifest["arrays"].get(name)
