"""Exact batched scoring engines: ``scores[b, d] = <q_b, doc_d>``.

  ``score_dense``      dense matmul, the f32 oracle.
  ``score_dense_f64``  the same in float64, the tie-break-free reference.
  ``score_tiled``      term-parallel scatter-add over a TiledIndex, through
                       the ``scatter_score`` kernel.
  ``score_ell``        doc-parallel gather over an EllIndex, through the
                       ``ell_gather`` kernel.

TF32 is off for the whole package (set in ``repro_torch/__init__.py``), so
``score_dense`` on the card is a full-f32 product.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.index import EllIndex, TiledIndex
from repro_torch.core.sparse import SparseBatch
from repro_torch.kernels.ell_gather import ops as ell_ops
from repro_torch.kernels.scatter_score import ops as scatter_ops


def queries_to_dense(queries: SparseBatch, dtype=torch.float32) -> torch.Tensor:
    """[B, V] dense query-weight matrix QW (queries are few and short)."""
    return queries.to_dense(dtype)


def score_dense(
    queries: SparseBatch, docs: SparseBatch, dtype=torch.float32
) -> torch.Tensor:
    """Exact oracle: QW [B,V] @ D^T [V,N]. O(B*V*N) work, fully dense."""
    return queries.to_dense(dtype) @ docs.to_dense(dtype).T


def score_dense_f64(queries: SparseBatch, docs: SparseBatch) -> torch.Tensor:
    """Float64 ground truth on the batches' device."""
    return score_dense(queries, docs, dtype=torch.float64)


def score_tiled(queries: SparseBatch, index: TiledIndex) -> torch.Tensor:
    qw = queries.to_dense()
    # Pad vocab up to a term-block multiple: every tile is whole.
    v_pad = index.num_term_blocks * index.term_block
    if v_pad > qw.shape[1]:
        qw = F.pad(qw, (0, v_pad - qw.shape[1]))
    out = scatter_ops.scatter_score(
        qw,
        index.local_term,
        index.local_doc,
        index.value,
        index.chunk_term_block,
        index.chunk_doc_block,
        index.block_chunk_start,
        index.block_chunk_count,
        term_block=index.term_block,
        doc_block=index.doc_block,
        num_doc_blocks=index.num_doc_blocks,
    )
    return out[:, : index.num_docs]


def score_ell(queries: SparseBatch, index: EllIndex) -> torch.Tensor:
    """Doc-parallel: every document's full term list is gathered against
    the dense query matrix — bandwidth-friendly streaming, O(N*k*B)."""
    out = ell_ops.ell_gather(queries.to_dense(), index.terms, index.values)
    return out[:, : index.num_docs]
