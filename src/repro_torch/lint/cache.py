"""Incremental lint cache: skip files whose findings cannot have moved.

A cache entry replays a file's findings (check-file *and* finalize,
both post-suppression) when nothing that could change them has changed:

* the file's content hash (sha256 of its bytes),
* the *linter fingerprint* — the selected pass roster, the sources of
  every module under ``src/repro_torch/lint/`` (edit a pass, lose the
  whole cache), and the Python and torch versions the fake-tensor layer
  runs under, and
* the *tree* — the content hashes of every walked file.  ``host-sync``
  follows calls across files, so a file's findings can move when another
  file changes: any change in the walk drops every entry (the warm run is
  the run over an unchanged tree, as a CI rerun is).

Cached files are excluded from the walk entirely, so the expensive tier
(``kernel-shape``'s fake-tensor runs of each entry's CUDA branch) never
runs for them — that is where the warm-run speedup comes from.  The
cache covers the static passes only: ``--device cuda`` runs the kernels
every time.  The cache file is JSON, safe to delete at any
time, and ``.gitignore``\\ d.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
from typing import Iterable, Optional

from repro_torch.lint.core import Finding

DEFAULT_CACHE_PATH = ".lint-cache-torch.json"
_VERSION = 1


def _torch_version() -> str:
    import torch

    return torch.__version__


def linter_fingerprint(pass_ids: Iterable[str]) -> str:
    """Hash everything that can change a finding besides the linted
    file itself."""
    h = hashlib.sha256()
    h.update(",".join(sorted(pass_ids)).encode())
    h.update(sys.version.encode())
    h.update(_torch_version().encode())
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    for root, dirs, names in os.walk(pkg_dir):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for name in sorted(names):
            if not name.endswith(".py"):
                continue
            full = os.path.join(root, name)
            h.update(os.path.relpath(full, pkg_dir).encode())
            try:
                with open(full, "rb") as f:
                    h.update(f.read())
            except OSError:
                h.update(b"?")
    return h.hexdigest()


class LintCache:
    """Content-hash keyed findings store for :func:`run_passes`."""

    def __init__(self, path: str, pass_ids: Iterable[str]):
        self.path = path
        self.fingerprint = linter_fingerprint(pass_ids)
        self._files: dict[str, dict] = {}
        self._tree: Optional[str] = None
        self._dirty = False
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path, encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, ValueError):
            return
        if (data.get("version") == _VERSION
                and data.get("linter") == self.fingerprint
                and isinstance(data.get("files"), dict)):
            self._files = data["files"]
            self._tree = data.get("tree")

    def bind_tree(self, paths) -> None:
        """Drop every entry unless the walk's files are the ones the cache
        was written over, byte for byte."""
        h = hashlib.sha256()
        for path in sorted(os.path.abspath(p) for p in paths):
            h.update(path.encode() + b"\0" + (self.file_key(path) or "?")
                     .encode())
        tree = h.hexdigest()
        if self._tree != tree:
            self._files = {}
            self._tree = tree
            self._dirty = True

    def file_key(self, path: str) -> Optional[str]:
        try:
            with open(path, "rb") as f:
                return hashlib.sha256(f.read()).hexdigest()
        except OSError:
            return None

    def lookup(self, path: str,
               key: Optional[str]) -> Optional[tuple[list[Finding], int]]:
        entry = self._files.get(os.path.abspath(path))
        if key is None or entry is None or entry.get("sha") != key:
            return None
        findings = [
            Finding(d["pass_id"], d["path"], d["line"], d["message"])
            for d in entry.get("findings", [])
        ]
        return findings, int(entry.get("suppressed", 0))

    def store(self, path: str, key: Optional[str],
              findings: list[Finding], suppressed: int) -> None:
        if key is None:
            return
        self._files[os.path.abspath(path)] = {
            "sha": key,
            "findings": [f.as_dict() for f in findings],
            "suppressed": suppressed,
        }
        self._dirty = True

    def save(self) -> None:
        if not self._dirty:
            return
        data = {
            "version": _VERSION,
            "linter": self.fingerprint,
            "tree": self._tree,
            "files": self._files,
        }
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(data, f)
            os.replace(tmp, self.path)
        except OSError:
            pass  # a cache that cannot be written is just a cold cache
        self._dirty = False
