"""Plain PyTorch version of the term-parallel scatter-add scoring kernel."""
from __future__ import annotations

import torch

# Postings scattered per index_add_ call, times the batch: bounds the
# [B, postings] product to 2^24 floats.
_SLAB_ELEMS = 1 << 24


def run_chunks(block_chunk_start: torch.Tensor,
               block_chunk_count: torch.Tensor) -> torch.Tensor:
    """int64 ids of the chunks inside the runs ``[start[b], start[b] +
    count[b])``, block by block in ascending order — the chunks the CUDA
    kernel walks."""
    count = block_chunk_count.long()
    start = block_chunk_start.long()
    owner = torch.repeat_interleave(
        torch.arange(count.numel(), device=count.device), count
    )
    first = torch.cumsum(count, 0) - count
    return start[owner] + torch.arange(owner.numel(), device=count.device) \
        - first[owner]


def scatter_chunks(
    out: torch.Tensor,  # f32 [B, n_pad], accumulated in place
    qw: torch.Tensor,  # f32 [B, V_pad]
    local_term: torch.Tensor,
    local_doc: torch.Tensor,
    value: torch.Tensor,
    chunk_term_block: torch.Tensor,
    chunk_doc_block: torch.Tensor,
    chunks: torch.Tensor,  # int64 [n] chunk ids, in order
    *,
    term_block: int,
    doc_block: int,
) -> torch.Tensor:
    """Add the valid postings of ``chunks`` into ``out``, in chunk then
    slot order.

    A slot is valid when ``local_doc >= 0`` and ``0 <= local_term <
    term_block``: the padding value of ``local_term`` is ``chunk_size``,
    which is a real local term whenever ``chunk_size < term_block``."""
    lt, ld = local_term[chunks], local_doc[chunks]
    valid = (ld >= 0) & (lt >= 0) & (lt < term_block)
    row, sl = torch.nonzero(valid, as_tuple=True)
    ch = chunks[row]
    t = chunk_term_block[ch].long() * term_block + lt[row, sl]
    d = chunk_doc_block[ch].long() * doc_block + ld[row, sl]
    v = value[ch, sl]
    step = max(1, _SLAB_ELEMS // max(qw.shape[0], 1))
    for s in range(0, t.numel(), step):
        out.index_add_(1, d[s:s + step], qw[:, t[s:s + step]] * v[s:s + step])
    return out


def scatter_score_ref(
    qw: torch.Tensor,  # f32 or bf16 [B, V_pad]
    local_term: torch.Tensor,  # int32 [num_chunks, C]
    local_doc: torch.Tensor,  # int32 [num_chunks, C]
    value: torch.Tensor,  # qw's dtype [num_chunks, C]
    chunk_term_block: torch.Tensor,  # int32 [num_chunks]
    chunk_doc_block: torch.Tensor,  # int32 [num_chunks]
    block_chunk_start: torch.Tensor,  # int32 [num_doc_blocks]
    block_chunk_count: torch.Tensor,  # int32 [num_doc_blocks]
    *,
    term_block: int,
    doc_block: int,
    num_doc_blocks: int,
) -> torch.Tensor:
    """out[b, db*D + ld] += qw[b, tb*T + lt] * v over every valid posting
    of the chunks inside the runs ``block_chunk_start/count``
    (``repro.kernels.scatter_score.ref`` restricted to those chunks):
    [B, num_doc_blocks * D] in ``qw``'s dtype, 0 in blocks whose runs are
    empty.  Runs that cover every chunk score the whole index.  bf16
    operands are widened to f32 (every product exact), summed in f32 and
    each score rounded once to bf16, the kernel's contract."""
    if qw.dtype == torch.bfloat16:
        return scatter_score_ref(
            qw.float(), local_term, local_doc, value.float(),
            chunk_term_block, chunk_doc_block, block_chunk_start,
            block_chunk_count, term_block=term_block, doc_block=doc_block,
            num_doc_blocks=num_doc_blocks).to(torch.bfloat16)
    out = torch.zeros((qw.shape[0], num_doc_blocks * doc_block),
                      dtype=torch.float32, device=qw.device)
    return scatter_chunks(
        out, qw, local_term, local_doc, value, chunk_term_block,
        chunk_doc_block, run_chunks(block_chunk_start, block_chunk_count),
        term_block=term_block, doc_block=doc_block,
    )
