"""Plain PyTorch version of the term-parallel scatter-add scoring kernel."""
from __future__ import annotations

import torch

# Postings scattered per index_add_ call, times the batch: bounds the
# [B, postings] product to 2^24 floats.
_SLAB_ELEMS = 1 << 24


def scatter_score_ref(
    qw: torch.Tensor,  # f32 [B, V_pad]
    local_term: torch.Tensor,  # int32 [num_chunks, C]
    local_doc: torch.Tensor,  # int32 [num_chunks, C]
    value: torch.Tensor,  # f32 [num_chunks, C]
    chunk_term_block: torch.Tensor,  # int32 [num_chunks]
    chunk_doc_block: torch.Tensor,  # int32 [num_chunks]
    *,
    term_block: int,
    doc_block: int,
    num_doc_blocks: int,
) -> torch.Tensor:
    """out[b, db*D + ld] += qw[b, tb*T + lt] * v over every valid posting
    (``repro.kernels.scatter_score.ref``): f32 [B, num_doc_blocks * D].

    A slot is valid when ``local_doc >= 0`` and ``0 <= local_term <
    term_block``: the padding value of ``local_term`` is ``chunk_size``,
    which is a real local term whenever ``chunk_size < term_block``."""
    b = qw.shape[0]
    out = torch.zeros((b, num_doc_blocks * doc_block), dtype=torch.float32,
                      device=qw.device)
    valid = (local_doc >= 0) & (local_term >= 0) & (local_term < term_block)
    ch, sl = torch.nonzero(valid, as_tuple=True)
    t = chunk_term_block[ch].long() * term_block + local_term[ch, sl]
    d = chunk_doc_block[ch].long() * doc_block + local_doc[ch, sl]
    v = value[ch, sl]
    step = max(1, _SLAB_ELEMS // max(b, 1))
    for s in range(0, t.numel(), step):
        out.index_add_(1, d[s:s + step], qw[:, t[s:s + step]] * v[s:s + step])
    return out
