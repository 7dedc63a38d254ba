"""Sparse-vector batch format used throughout the retrieval stack.

A batch of learned sparse vectors (SPLADE-style) is stored in padded
term-major form, as in :mod:`repro.core.sparse`:

  ``term_ids``: int32 [B, K]  — vocabulary ids, ``-1`` marks padding
  ``values``:   f32   [B, K]  — non-negative weights, ``0.0`` at padding

Both tensors live on one device; the index builders in
:mod:`repro_torch.core.index` consume them there.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.utils import resolve_device

PAD_ID = -1


@dataclasses.dataclass
class SparseBatch:
    """Padded batch of sparse vectors over a vocabulary."""

    term_ids: torch.Tensor  # int32 [B, K], PAD_ID at padding slots
    values: torch.Tensor  # float32 [B, K], 0 at padding slots
    vocab_size: int

    @property
    def batch(self) -> int:
        return int(self.term_ids.shape[0])

    @property
    def max_terms(self) -> int:
        return int(self.term_ids.shape[1])

    @property
    def device(self) -> torch.device:
        return self.term_ids.device

    def nnz_per_row(self) -> torch.Tensor:
        return (self.term_ids >= 0).sum(dim=-1)

    def to_dense(self, dtype=torch.float32) -> torch.Tensor:
        """Densify to [B, vocab_size]; duplicate ids accumulate."""
        valid = self.term_ids >= 0
        ids = torch.where(valid, self.term_ids, 0).long()
        vals = torch.where(valid, self.values, 0.0).to(dtype)
        rows = torch.arange(self.batch, device=self.device)[:, None]
        out = torch.zeros(
            (self.batch, self.vocab_size), dtype=dtype, device=self.device
        )
        return out.index_put_(
            (rows.expand_as(ids), ids), vals, accumulate=True
        )

    def astype(self, dtype) -> "SparseBatch":
        return SparseBatch(self.term_ids, self.values.to(dtype),
                           self.vocab_size)

    def slice_rows(self, start: int, size: int) -> "SparseBatch":
        return SparseBatch(
            self.term_ids[start: start + size],
            self.values[start: start + size],
            self.vocab_size,
        )

    def to(self, device) -> "SparseBatch":
        return SparseBatch(self.term_ids.to(device), self.values.to(device),
                           self.vocab_size)

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"SparseBatch(B={self.batch}, K={self.max_terms}, "
            f"V={self.vocab_size}, device={self.device})"
        )


def from_lists(
    term_ids: list[np.ndarray],
    values: list[np.ndarray],
    vocab_size: int,
    pad_to: Optional[int] = None,
    device="cuda",
) -> SparseBatch:
    """Build a :class:`SparseBatch` from ragged per-row id/value lists.

    Each row's terms are sorted (stably), as :func:`repro.core.sparse.
    from_lists` sorts them: the index builders' posting order follows.
    """
    dev = resolve_device(device)
    if len(term_ids) != len(values):
        raise ValueError(f"{len(term_ids)} id rows but {len(values)} value rows")
    maxk = max((len(t) for t in term_ids), default=1)
    maxk = max(maxk, 1)
    if pad_to is not None:
        maxk = max(maxk, pad_to)
    b = len(term_ids)
    ids = np.full((b, maxk), PAD_ID, dtype=np.int32)
    vals = np.zeros((b, maxk), dtype=np.float32)
    for i, (t, v) in enumerate(zip(term_ids, values)):
        k = len(t)
        if k:
            order = np.argsort(t, kind="stable")
            ids[i, :k] = np.asarray(t, dtype=np.int32)[order]
            vals[i, :k] = np.asarray(v, dtype=np.float32)[order]
    return SparseBatch(torch.from_numpy(ids).to(dev),
                       torch.from_numpy(vals).to(dev), vocab_size)


def to_numpy_rows(
    batch: SparseBatch,
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Inverse of :func:`from_lists` (drops padding)."""
    ids = batch.term_ids.cpu().numpy()
    vals = batch.values.cpu().numpy()
    out_ids, out_vals = [], []
    for i in range(ids.shape[0]):
        m = ids[i] >= 0
        out_ids.append(ids[i][m])
        out_vals.append(vals[i][m])
    return out_ids, out_vals


def dense_to_sparse(
    dense, pad_to: Optional[int] = None, device="cuda"
) -> SparseBatch:
    """Convert a dense [B, V] matrix (numpy or tensor) into a SparseBatch.

    Built on ``device`` with one ``nonzero`` and a per-row count: each row's
    nonzero ids ascending, values cast to f32, padded to the longest row
    (at least 1, and at least ``pad_to``) as :func:`from_lists` pads.
    """
    dev = resolve_device(device)
    x = dense if torch.is_tensor(dense) else torch.from_numpy(np.asarray(dense))
    x = x.to(dev)
    b, v = x.shape
    nz = x != 0
    counts = nz.sum(dim=1)
    maxk = max(int(counts.max()) if b else 0, 1, pad_to or 0)
    rows, cols = nz.nonzero(as_tuple=True)  # row-major: ids ascending per row
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(rows.numel(), device=dev) - starts[rows]
    ids = torch.full((b, maxk), PAD_ID, dtype=torch.int32, device=dev)
    vals = torch.zeros((b, maxk), dtype=torch.float32, device=dev)
    ids[rows, slot] = cols.to(torch.int32)
    vals[rows, slot] = x[rows, cols].to(torch.float32)
    return SparseBatch(ids, vals, vocab_size=v)
