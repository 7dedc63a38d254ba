"""Query weights packed by tiles of 128 queries for the exact scoring kernels.

``scatter_score`` and ``ell_gather`` give each CTA one tile of
``QUERY_TILE`` queries.  A SPLADE query holds ~48 of 30,522 terms, so of a
tile's 128 weights for a posting's term ~19 are nonzero where any is (and
none are for about a third of the postings).  :func:`pack_query_tiles`
lays the weights out per (tile, term) so that a kernel reads only those:

* ``records`` int32 [n_tiles, V, 2]: (offset, count) of the term's weights;
* ``entries`` int32 [E, 2]: the sparse tiles' nonzero weights, a (query in
  the tile, weight's f32 bits) pair each, tile-major, then term, then
  query; the sparse route reads them;
* ``cw`` f32 [n_dense * V * 128]: the dense tiles' (:func:`dense_tiles`)
  whole [V, 128] slabs, zeros and padding queries included, in tile order;
  a dense tile's records are (its slab's offset + 128 t, 128), and the
  dense route reads term ``t``'s row at ``records[tile, 0, 0] + 128 t``
  without a record load.

A bf16 ``qw`` (the bf16 routes) packs the same records; each entry is one
int32 word, the query in bits 0-15 and the weight's bf16 bits in bits
16-31, and ``cw`` is bf16.  The weights are rounded before they come here,
so the nonzero counts and the routes are those of the rounded weights.

The route is a pure function of the tile's nonzero count, and either route
gives the same bits (a zero weight adds +0 to a finite sum).  On the
encoder's nearly dense tiles the dense route is the faster (``PERF.md``
§6, from ``chip_smoke.py``'s phase 4).

The packing runs as torch ops on the tensors' device, inside the kernel
entries; its one host sync reads the tiles' routes and the entries' count.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

QUERY_TILE = 128  # queries a CTA; the kernels' kQueryTile
# A tile is dense when at least this share of its real queries' weights is
# nonzero (encoder output thresholded at 0.05 is ~2/3 nonzero; an MS MARCO
# SPLADE query ~0.16 %).
DENSE_SHARE = 0.5


def tile_rows(b: int) -> torch.Tensor:
    """int64 [n_tiles]: the real queries of each tile (the last one ragged)."""
    n_tiles = -(-b // QUERY_TILE)
    return (b - torch.arange(n_tiles) * QUERY_TILE).clamp(max=QUERY_TILE)


def dense_tiles(counts: torch.Tensor, rows: torch.Tensor,
                width: int) -> torch.Tensor:
    """bool [n_tiles]: a tile of ``rows`` real queries and ``counts``
    nonzero weights over ``width`` terms takes the dense route."""
    rows = rows.to(counts.device)
    return counts.double() >= DENSE_SHARE * rows.double() * width


def pack_query_tiles(qw: torch.Tensor):
    """f32 ``qw`` [B, V] -> ``(records [n_tiles, V, 2] int32, entries [E, 2]
    int32, cw [n_dense * V * 128] f32, dense [n_tiles] int32)``; bf16
    ``qw`` -> entries [E] int32 and bf16 ``cw`` (see the module doc): for a sparse tile ``g``, ``records[g, t] = (off, cnt)``
    and ``entries[off:off + cnt]`` are the queries ``j`` of the tile
    (query ``g * 128 + j < B``) with ``qw[g * 128 + j, t] != 0``,
    ascending, with their weights; for the ``r``-th dense tile,
    ``records[g, t] = ((r * V + t) * 128, 128)`` and ``cw`` there holds the
    weights of every ``j``.  Raises where the offsets overflow the
    kernels' int32."""
    b, v = qw.shape
    n_tiles = -(-b // QUERY_TILE)
    dev = qw.device
    nz = torch.zeros((n_tiles * QUERY_TILE, v), dtype=torch.bool, device=dev)
    nz[:b] = qw != 0
    nz = nz.view(n_tiles, QUERY_TILE, v)
    dense = dense_tiles(nz.sum((1, 2)), tile_rows(b), v)
    sparse_cnt = torch.where(dense[:, None], 0, nz.sum(1)).view(-1)
    is_dense = dense.repeat_interleave(v)
    slab_off = (torch.cumsum(is_dense, 0) - 1) * QUERY_TILE
    off = torch.where(is_dense, slab_off,
                      torch.cumsum(sparse_cnt, 0) - sparse_cnt)
    cnt = torch.where(is_dense, QUERY_TILE, sparse_cnt)
    records = torch.stack((off, cnt), -1).view(n_tiles, v, 2)
    head = torch.cat((dense.long(), sparse_cnt.sum().view(1))).tolist()  # lint: disable=host-sync -- the one transfer: the tiles' routes and the entries' count size the packed arrays
    dense_ids = [g for g in range(n_tiles) if head[g]]
    n_entries = head[-1]
    if max(n_entries, len(dense_ids) * v * QUERY_TILE) >= 1 << 31:
        raise ValueError(f"{n_entries} packed weights or {len(dense_ids)} "
                         f"dense tiles overflow the kernels' int32 offsets")
    # The sparse tiles' nonzero weights in (tile, term, query) order: the
    # n-th lies where their running count reaches n.
    keep = (nz & ~dense[:, None, None]).transpose(1, 2).reshape(-1)
    kept = torch.searchsorted(torch.cumsum(keep, 0, dtype=torch.int32),
                              torch.arange(1, n_entries + 1, device=dev,
                                           dtype=torch.int32))
    tile, rest = kept // (v * QUERY_TILE), kept % (v * QUERY_TILE)
    j = rest % QUERY_TILE
    w = qw[tile * QUERY_TILE + j, rest // QUERY_TILE]
    if qw.dtype == torch.bfloat16:
        word = (w.view(torch.int16).to(torch.int64) & 0xFFFF) << 16 | j
        entries = torch.where(word >= 1 << 31, word - (1 << 32),
                              word).to(torch.int32)
    else:
        entries = torch.stack((j.to(torch.int32), w.view(torch.int32)), -1)
    if dense_ids:
        x = F.pad(qw, (0, 0, 0, n_tiles * QUERY_TILE - b))
        cw = x.view(n_tiles, QUERY_TILE, v)[dense_ids].transpose(1, 2).reshape(-1)
    else:
        cw = qw.new_empty(0)
    return (records.to(torch.int32), entries, cw, dense.to(torch.int32))
