"""Document-sharded serving over ``torch.distributed``.

The port of :mod:`repro.core.distributed`.  The corpus is cut into S
contiguous doc partitions of equal size (:func:`~repro_torch.core.index.
shard_docs`); shard s is served by rank s of a process group, and a rank
needs only its own shard on its card (``keep_shard``).  Queries are
replicated; every rank scores its shard through the kernel entries its
single-index engine calls (``scatter_score``, ``ell_gather``,
``bmp_scan``), takes its local top-k, and the global top-k comes from one
gather of the per-shard top-ks and a merge (:mod:`repro_torch.core.topk`):
a payload of O(S * B * k), the device-side merge of the paper's sharded
design.

One factory, :func:`make_serve_step`, builds every step through the engine
registry (``engine=`` picks the per-shard scorer: ``ell``, ``tiled``,
``tiled-pruned`` (BMP sweep or two-pass), ``tiled-pruned-approx``,
``tiled-bmp-grouped``, ``tiled-bmp-fused``).  Every step returns
``(values [B, k], global ids [B, k], tau [B])``.

Where the port differs from the JAX module, on purpose:

* A process group replaces the mesh.  ``group=None`` with no process
  group initialised is world size 1.  A step whose index has another
  shard count than the group has ranks raises ``ValueError``: the JAX
  step on a mesh with fewer devices than shards serves shard 0 alone,
  without an error.
* The grouped and fused steps plan from every shard's block bounds, each
  rank computing its own and gathering the rest, so every rank feeds the
  deterministic planner the same array and issues the same collectives
  in the same order.  They merge once a step, not once a group or bucket:
  every selection is row by row, so the rows come out the same.
* ``compute_dtype`` is float32 or bfloat16; any other dtype raises
  ``NotImplementedError`` (JAX computes in any dtype; no caller uses
  another).  ``block`` and ``unroll`` (XLA compile knobs) are not
  arguments.
* Under bfloat16 every engine follows one contract: the query weights and
  the index values are rounded to bf16 (to nearest, ties to even), each
  product is exact in f32, the products are summed in f32, each [B, N]
  score is rounded to bf16 once, and the top-k runs over those values,
  lower id first on ties; the step returns them as f32, and tau is taken
  from them in f32.  That is JAX's ``ell`` step up to the order of the f32
  sums ("scores accumulate in f32"); JAX's tiled and BMP steps round more
  often (every product, each chunk's sum, the running scores).  The
  pruned steps stay exact under it (the wider margin of
  :data:`repro_torch.kernels.bmp_scan.ref.MARGIN_REL`).  JAX casts the
  index inside the step on every call; here a shard's values are cast
  once for each (index, dtype) and kept beside the f32 ones
  (``cast_bytes`` counts the bytes those casts read and write).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch.core import registry, scoring
from repro_torch.core import topk as topk_mod
from repro_torch.core.engine import RetrievalConfig
from repro_torch.core.index import (
    EllIndex, TiledIndex, _block_chunk_runs, build_tiled_index,
    fill_ell_rows, shard_docs,
)
from repro_torch.core.sparse import SparseBatch
from repro_torch.kernels.ell_gather import ops as ell_ops
from repro_torch.sched import planner as planner_mod
from repro_torch.utils import cdiv, ceil_to, resolve_device

NEG_INF = float("-inf")
# Bytes read and written by the casts of index values to a compute dtype,
# each (index, dtype) cast once (a serve step reads the cached copy).
cast_bytes = 0
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


class _Stacked:
    """Arrays stacked over shards on a leading axis, or one shard of them.

    ``held`` is None while every shard is stacked; :meth:`keep_shard`
    leaves a copy holding only one rank's shard on that rank's device,
    and ``held`` names it."""

    def _row(self, shard: int) -> int:
        if self.held is None:
            if not 0 <= shard < self.num_shards:
                raise ValueError(f"shard {shard} of {self.num_shards}")
            return shard
        if shard != self.held:
            raise ValueError(f"this copy holds shard {self.held} only, not "
                             f"shard {shard}; keep_shard({shard}) of the "
                             "whole index")
        return 0

    def keep_shard(self, rank: int, device="cuda"):
        """A copy holding only shard ``rank``, on ``device``."""
        dev = resolve_device(device)
        i = self._row(rank)
        cut = {f.name: getattr(self, f.name)[i:i + 1].to(dev)
               for f in dataclasses.fields(self)
               if f.init and torch.is_tensor(getattr(self, f.name))}
        return dataclasses.replace(self, **cut, held=rank)

    def _in(self, name: str, dtype) -> torch.Tensor:
        """Field ``name`` (the index values) in ``dtype``: the field itself
        for float32, else its cast, made on the first call and kept."""
        global cast_bytes
        t = getattr(self, name)
        if dtype == t.dtype:
            return t
        if dtype not in self.casts:
            self.casts[dtype] = t.to(dtype)
            cast_bytes += t.numel() * (t.element_size()
                                       + self.casts[dtype].element_size())
        return self.casts[dtype]


@dataclasses.dataclass
class ShardedEllIndex(_Stacked):
    """ELL index stacked over shards: leading dim = shard."""

    terms: torch.Tensor  # int32 [S, N_s, K], vocab_size at padding
    values: torch.Tensor  # f32   [S, N_s, K]
    docs_per_shard: int
    num_docs: int
    vocab_size: int
    # Optional per-shard (term_block x doc_block) maxima of |value|, as
    # ``TiledIndex.block_max``.
    block_max: Optional[torch.Tensor] = None  # f32 [S, n_tb, n_db]
    term_block: int = 512
    doc_block: int = 64
    num_shards: int = 0  # 0: the leading dim
    held: Optional[int] = None
    # values cast to a compute dtype, by dtype (made once, on first use)
    casts: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

    def __post_init__(self):
        self.num_shards = self.num_shards or int(self.terms.shape[0])

    @property
    def device(self) -> torch.device:
        return self.terms.device

    def shard(self, s: int, dtype=torch.float32) -> EllIndex:
        """Shard ``s`` as an :class:`EllIndex` whose values are in the
        compute ``dtype``."""
        i = self._row(s)
        return EllIndex(self.terms[i], self._in("values", dtype)[i],
                        self.docs_per_shard, self.vocab_size)


def _shard_block_max(shard: SparseBatch, term_block: int,
                     doc_block: int) -> torch.Tensor:
    """[n_tb, n_db] per-tile max |value| of one shard's docs."""
    n_tb = max(cdiv(shard.vocab_size, term_block), 1)
    n_db = max(cdiv(shard.batch, doc_block), 1)
    rows, cols = torch.nonzero(shard.term_ids >= 0, as_tuple=True)
    cell = (shard.term_ids[rows, cols].long() // term_block) * n_db \
        + rows // doc_block
    out = torch.zeros(n_tb * n_db, dtype=torch.float32, device=shard.device)
    out.scatter_reduce_(0, cell, shard.values[rows, cols].abs(), "amax")
    return out.view(n_tb, n_db)


def _require_sparse_batch(docs) -> None:
    """The sharded build functions take a concrete corpus, never a Retriever: a
    store-backed Retriever's corpus lives on disk, and reading it is the
    caller's explicit step (:func:`snapshot_paged`)."""
    if hasattr(docs, "_segments"):
        raise TypeError(
            "build_sharded_* takes a SparseBatch, not a Retriever; for a "
            "store-backed (paged) retriever call snapshot_paged(r) to "
            "materialize (docs, global_ids) explicitly — no silent host "
            "sync"
        )


def snapshot_paged(retriever) -> tuple[SparseBatch, np.ndarray]:
    """Host copy of a :class:`~repro_torch.core.session.Retriever`'s corpus
    for the sharded build functions (:func:`repro.core.distributed.
    snapshot_paged`): every segment's rows in global-id order, read from
    the device or from a stored segment's mmap without paging it in, as a
    CPU ``SparseBatch``, and ``global_ids[row]``, each row's id in the
    retriever's numbering (compaction leaves gaps, and sharded serving
    renumbers rows, so results map back through it).

    Pending tombstones raise: sharded steps serve a static snapshot and
    take no deletion mask, so ``compact(threshold=0.0)`` first."""
    segments = getattr(retriever, "_segments", None)
    if segments is None:
        raise TypeError(
            "snapshot_paged expects a repro_torch.core.session.Retriever, "
            f"got {type(retriever).__name__}"
        )
    if not segments:
        raise ValueError("Retriever holds no documents; add_docs first")
    for seg in segments:
        mask = seg.deleted_mask
        if mask is not None and mask.any():
            raise NotImplementedError(
                "snapshot_paged with pending tombstones would bake "
                "deleted documents into the sharded index; compact() the "
                "retriever (threshold=0.0) first"
            )
    ids_rows, val_rows, gid_rows = [], [], []
    for seg in segments:
        docs = seg.physical_docs
        ids_rows.append(docs.term_ids.cpu().numpy())
        val_rows.append(docs.values.cpu().numpy())
        gid_rows.append(
            seg.id_map if seg.id_map is not None
            else seg.offset + np.arange(seg.num_physical, dtype=np.int64)
        )
    width = max(a.shape[1] for a in ids_rows)
    total = sum(a.shape[0] for a in ids_rows)
    out_ids = np.full((total, width), -1, np.int32)
    out_vals = np.zeros((total, width), np.float32)
    row = 0
    for ids, vals in zip(ids_rows, val_rows):
        out_ids[row:row + len(ids), : ids.shape[1]] = ids
        out_vals[row:row + len(ids), : ids.shape[1]] = vals
        row += len(ids)
    return (SparseBatch(torch.from_numpy(out_ids), torch.from_numpy(out_vals),
                        retriever.vocab_size),
            np.concatenate(gid_rows))


def _stack(parts: list) -> torch.Tensor:
    return parts[0][None] if len(parts) == 1 else torch.stack(parts)


def build_sharded_ell(
    docs: SparseBatch,
    num_shards: int,
    k_pad: int = 8,
    store_block_max: bool = False,
    term_block: int = 512,
    doc_block: int = 64,
) -> ShardedEllIndex:
    """Equal contiguous doc partitions with a uniform K, built on
    ``docs``' device: each shard's ELL rows (left-packed term lists),
    padded with term ``vocab_size`` and value 0 to the widest doc's K.
    The rows go straight from ``docs`` into the stacked arrays, a bounded
    number at a time: the corpus and the index are all it holds."""
    _require_sparse_batch(docs)
    per = cdiv(docs.batch, num_shards)
    v = docs.vocab_size
    k = ceil_to(max(int(docs.nnz_per_row().max()) if docs.batch else 1, 1),
                k_pad)
    terms = torch.full((num_shards, per, k), v, dtype=torch.int32,
                       device=docs.device)
    vals = torch.zeros((num_shards, per, k), dtype=torch.float32,
                       device=docs.device)
    for si in range(num_shards):
        start = si * per
        rows = max(min(per, docs.batch - start), 0)
        fill_ell_rows(docs.slice_rows(start, rows), terms[si], vals[si])
    block_max = None
    if store_block_max:
        block_max = _stack([
            _shard_block_max(shard_docs(docs, num_shards, s)[0], term_block,
                             doc_block) for s in range(num_shards)])
    return ShardedEllIndex(terms, vals, per, docs.batch, v,
                           block_max=block_max, term_block=term_block,
                           doc_block=doc_block)


@dataclasses.dataclass
class ShardedTiledIndex(_Stacked):
    """TiledIndex stacked over shards, with fine block-max bounds.

    Every shard is padded to the same chunk count: the pad chunks sit at
    the tail (local_term ``chunk_size``, local_doc -1, value 0) and no
    block's chunk run (``block_chunk_start/count``, from each shard's
    unpadded stream) reaches them.  Fine bounds follow ``bounds_format``:
    ``"dense"`` stores u8 [S, V, n_db]; ``"csr"`` each shard's nonzero
    (term, doc_block) entries, padded to the largest shard's count
    (beyond every row's ``indptr`` range, never addressed)."""

    local_term: torch.Tensor  # int32 [S, C_n, C]
    local_doc: torch.Tensor  # int32 [S, C_n, C]
    value: torch.Tensor  # f32   [S, C_n, C]
    chunk_term_block: torch.Tensor  # int32 [S, C_n]
    chunk_doc_block: torch.Tensor  # int32 [S, C_n]
    term_block_max_q: Optional[torch.Tensor]  # u8 [S, V, n_db] (dense)
    term_block_scale: torch.Tensor  # f32 [S, V]
    docs_per_shard: int
    num_docs: int
    vocab_size: int
    term_block: int
    doc_block: int
    chunk_size: int
    block_chunk_start: Optional[torch.Tensor] = None  # int32 [S, n_db]
    block_chunk_count: Optional[torch.Tensor] = None  # int32 [S, n_db]
    bounds_format: str = "dense"
    tbm_indptr: Optional[torch.Tensor] = None  # int32 [S, V + 1]
    tbm_cols: Optional[torch.Tensor] = None  # int32 [S, nnz_max]
    tbm_vals_q: Optional[torch.Tensor] = None  # u8 [S, nnz_max]
    csr_row_cap: int = 0  # most stored nonzeros in any term's row
    num_shards: int = 0  # 0: the leading dim
    held: Optional[int] = None
    # values cast to a compute dtype, by dtype (made once, on first use)
    casts: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

    def __post_init__(self):
        self.num_shards = self.num_shards or int(self.local_term.shape[0])

    @property
    def device(self) -> torch.device:
        return self.local_term.device

    @property
    def num_doc_blocks(self) -> int:
        return cdiv(self.docs_per_shard, self.doc_block)

    def geometry(self) -> dict:
        geo = dict(chunk_size=self.chunk_size, doc_block=self.doc_block,
                   term_block=self.term_block,
                   n_doc_blocks=self.num_doc_blocks)
        if self.bounds_format == "csr":
            geo["bounds_format"] = "csr"
            geo["csr_row_cap"] = self.csr_row_cap
        return geo

    def bounds_memory(self) -> dict:
        """Fine-bound storage of the shards held, both layouts
        (:meth:`repro.core.distributed.ShardedTiledIndex.bounds_memory`)."""
        s = int(self.term_block_scale.shape[0])
        v = self.vocab_size
        scale = 4 * v * s

        def nbytes(*ts):
            return sum(t.numel() * t.element_size() for t in ts)

        dense = v * self.num_doc_blocks * s + scale
        if self.bounds_format == "csr":
            nnz = int(self.tbm_indptr[:, -1].sum())
            stored = nbytes(self.tbm_indptr, self.tbm_cols, self.tbm_vals_q,
                            self.term_block_scale)
        else:
            nnz = int(torch.count_nonzero(self.term_block_max_q))
            stored = nbytes(self.term_block_max_q, self.term_block_scale)
        csr = 4 * (v + 1) * s + 4 * nnz + nnz + scale
        return {"format": self.bounds_format, "stored": stored,
                "dense": dense, "csr": csr}

    def shard(self, s: int, dtype=torch.float32) -> TiledIndex:
        """Shard ``s`` as a :class:`TiledIndex` of ``docs_per_shard`` docs
        (views, no copy), its values in the compute ``dtype``.
        ``chunk_first``, ``tile_max`` and ``block_max`` are None: the
        sharded layout does not carry them, and the scoring paths with fine
        bounds read none of them."""
        i = self._row(s)

        def at(t):
            return None if t is None else t[i]

        return TiledIndex(
            local_term=at(self.local_term), local_doc=at(self.local_doc),
            value=at(self._in("value", dtype)),
            chunk_term_block=at(self.chunk_term_block),
            chunk_doc_block=at(self.chunk_doc_block), chunk_first=None,
            tile_max=None, block_max=None, num_docs=self.docs_per_shard,
            vocab_size=self.vocab_size, term_block=self.term_block,
            doc_block=self.doc_block, chunk_size=self.chunk_size,
            bounds_format=self.bounds_format,
            term_block_max_q=at(self.term_block_max_q),
            term_block_scale=at(self.term_block_scale),
            tbm_indptr=at(self.tbm_indptr), tbm_cols=at(self.tbm_cols),
            tbm_vals_q=at(self.tbm_vals_q),
            block_chunk_start=at(self.block_chunk_start),
            block_chunk_count=at(self.block_chunk_count),
        )


def build_sharded_tiled(
    docs: SparseBatch,
    num_shards: int,
    term_block: int = 512,
    doc_block: int = 64,
    chunk_size: int = 128,
    bounds_format: str = "dense",
) -> ShardedTiledIndex:
    """Each shard's ``build_tiled_index`` with fine bounds, on ``docs``'
    device, its chunk arrays padded at the tail to the most chunks of any
    shard and stacked.  The defaults are JAX ``build_sharded_tiled``'s, not
    ``RetrievalConfig``'s."""
    _require_sparse_batch(docs)
    shards = [shard_docs(docs, num_shards, s)[0] for s in range(num_shards)]
    built = [
        build_tiled_index(s, term_block=term_block, doc_block=doc_block,
                          chunk_size=chunk_size, store_term_block_max=True,
                          bounds_format=bounds_format)
        for s in shards
    ]
    c_n = max(b.num_chunks for b in built)

    def pad(arr, n, fill):
        if arr.shape[0] == n:
            return arr
        tail = arr.new_full((n - arr.shape[0],) + tuple(arr.shape[1:]), fill)
        return torch.cat([arr, tail])

    def chunks(field, fill):
        return _stack([pad(getattr(b, field), c_n, fill) for b in built])

    def whole(field):
        return _stack([getattr(b, field) for b in built])

    fine = dict(term_block_max_q=None, csr_row_cap=0)
    if bounds_format == "csr":
        nnz_max = max(max(int(b.tbm_cols.shape[0]) for b in built), 1)
        row_cap = max(max(int(torch.diff(b.tbm_indptr).max())
                          if b.tbm_indptr.shape[0] > 1 else 0
                          for b in built), 1)
        fine = dict(
            term_block_max_q=None, tbm_indptr=whole("tbm_indptr"),
            tbm_cols=_stack([pad(b.tbm_cols, nnz_max, 0) for b in built]),
            tbm_vals_q=_stack([pad(b.tbm_vals_q, nnz_max, 0)
                               for b in built]),
            csr_row_cap=row_cap,
        )
    else:
        fine["term_block_max_q"] = whole("term_block_max_q")
    return ShardedTiledIndex(
        local_term=chunks("local_term", chunk_size),
        local_doc=chunks("local_doc", -1),
        value=chunks("value", 0.0),
        chunk_term_block=chunks("chunk_term_block", 0),
        chunk_doc_block=chunks("chunk_doc_block", 0),
        term_block_scale=whole("term_block_scale"),
        block_chunk_start=whole("block_chunk_start"),
        block_chunk_count=whole("block_chunk_count"),
        docs_per_shard=shards[0].batch, num_docs=docs.batch,
        vocab_size=docs.vocab_size, term_block=term_block,
        doc_block=doc_block, chunk_size=chunk_size,
        bounds_format=bounds_format, **fine,
    )


# ---------------------------------------------------------------------------
# The steps


class _Group(NamedTuple):
    """The process group a step serves over, this process's place in it
    (shard ``rank`` is served here), and the step's compute dtype."""

    group: object
    rank: int
    size: int
    dtype: torch.dtype = torch.float32


def group_rank_size(group=None) -> tuple[int, int]:
    """(rank, world size) in ``group``; (0, 1) with ``group=None`` and no
    process group initialised."""
    import torch.distributed as dist

    if group is None and not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _advance_tau(mv: torch.Tensor, tau0, k: int, num_real_docs: int):
    """The step's tau: the merged k-th best where finite, never below the
    carried value.  Uncertified (tau carried unchanged) with fewer than k
    *real* documents: padded docs score a finite 0 no real doc certifies
    (:func:`repro.core.distributed._advance_tau`)."""
    b = mv.shape[0]
    tau0 = (torch.full((b,), NEG_INF, dtype=torch.float32, device=mv.device)
            if tau0 is None else
            torch.as_tensor(tau0, dtype=torch.float32).to(mv.device))
    if mv.shape[-1] < k or num_real_docs < k:
        return tau0
    kth = mv[:, k - 1]
    return torch.maximum(tau0, torch.where(torch.isfinite(kth), kth,
                                           NEG_INF))


def _reject_deleted(deleted_mask) -> None:
    """Sharded steps serve a static snapshot and take the top-k inside
    each shard: a tombstone mask can neither be threaded nor applied after
    the fact (a deleted doc of a pruned engine could certify tau), so
    passing one raises."""
    if deleted_mask is not None:
        raise NotImplementedError(
            "sharded serve steps do not consume deleted_mask; compact() "
            "the retriever (threshold=0.0) and rebuild the sharded index "
            "from the surviving documents"
        )


def _bounds_mode(geometry: Optional[dict]) -> tuple[bool, int]:
    """(csr?, row_cap) the step was built for, from ``geometry()``."""
    geo = geometry or {}
    return (geo.get("bounds_format", "dense") == "csr",
            int(geo.get("csr_row_cap", 0) or 0))


def _check_bounds(index: ShardedTiledIndex, csr: bool, row_cap: int) -> None:
    """Raise where the index's bounds are not the format the step was
    built for, or need a wider CSR row than it was built for."""
    if csr:
        if index.tbm_indptr is None:
            raise ValueError(
                "serve step built for bounds_format='csr' but the "
                "ShardedTiledIndex stores dense bounds; rebuild with "
                "build_sharded_tiled(..., bounds_format='csr')"
            )
        if index.csr_row_cap > row_cap:
            raise ValueError(
                f"serve step built for csr_row_cap={row_cap} but the "
                f"index needs {index.csr_row_cap}; rebuild the serve "
                "step with this index's geometry()"
            )
    elif index.term_block_max_q is None:
        raise ValueError(
            "serve step built for dense bounds but the ShardedTiledIndex "
            "stores CSR; pass its geometry() to make_serve_step"
        )


def _check_index(index, ctx: _Group, docs_per_shard: int, kind: type,
                 geometry: Optional[dict]) -> None:
    if not isinstance(index, kind):
        raise TypeError(f"this step serves a {kind.__name__}, got "
                        f"{type(index).__name__}")
    if index.num_shards != ctx.size:
        raise ValueError(
            f"the index has {index.num_shards} shard(s) but the process "
            f"group has {ctx.size} rank(s); shard s is served by rank s, "
            f"so build the index with num_shards={ctx.size}"
        )
    if index.docs_per_shard != docs_per_shard:
        raise ValueError(
            f"serve step built for docs_per_shard={docs_per_shard}, the "
            f"index has {index.docs_per_shard}"
        )
    if kind is ShardedTiledIndex:  # the rest of the geometry is the index's
        _check_bounds(index, *_bounds_mode(geometry))


def _query_weights(queries: Optional[SparseBatch], qw, width: int,
                   dev, dtype=torch.float32) -> torch.Tensor:
    """[B, >= width] query weights on ``dev`` in the compute ``dtype``:
    ``qw`` as given, else the queries densified; zero-padded up to
    ``width``."""
    if qw is None:
        if queries is None:
            raise ValueError("a serve step needs queries or qw")
        qw = queries.to(dev).to_dense()
    qw = torch.as_tensor(qw, dtype=torch.float32).to(dev)
    if qw.shape[1] < width:
        qw = torch.nn.functional.pad(qw, (0, width - qw.shape[1]))
    return qw.to(dtype)


def _need_queries(queries) -> SparseBatch:
    if queries is None:
        raise ValueError("the pruned serve steps read the query batch "
                         "(its bounds); pass queries=")
    return queries


def _sharded_step(ctx: _Group, k: int, docs_per_shard: int, kind: type,
                  geometry: Optional[dict], local_scores):
    """The uniform step around ``local_scores(local index, queries, qw,
    tau_init, index) -> [B, docs_per_shard]`` scores of this rank's shard
    (its values in the step's compute dtype): checks, then local top-k,
    gather, merge, tau.  The values come back as f32."""

    def serve_step(index, queries=None, qw=None, tau_init=None,
                   deleted_mask=None):
        _reject_deleted(deleted_mask)
        _check_index(index, ctx, docs_per_shard, kind, geometry)
        local = index.shard(ctx.rank, ctx.dtype)
        if queries is not None:
            queries = queries.to(index.device)
        scores = local_scores(local, queries, qw, tau_init, index)
        mv, mi = topk_mod.local_then_global_topk(
            scores, ctx.rank * docs_per_shard, k, ctx.group)
        mv = mv.float()
        return mv, mi, _advance_tau(mv, tau_init, k, index.num_docs)

    return serve_step


def make_serve_step(
    group=None,
    *,
    engine: Optional[str] = None,
    cfg: Optional[RetrievalConfig] = None,
    k: Optional[int] = None,
    docs_per_shard: int,
    geometry: Optional[dict] = None,
    hierarchical_merge: bool = True,
    compute_dtype=torch.float32,
):
    """The one sharded serve-step factory, dispatched through the engine
    registry (:func:`repro.core.distributed.make_serve_step`, with the
    process group ``group`` in place of the mesh).

    ``engine`` picks the per-shard scorer (default ``cfg.engine``; an
    engine with no sharded step raises with the serveable list); ``cfg``
    carries its knobs (``traversal``, ``theta``, ``prune_seed_blocks``,
    the planner's, ``plan_cache``, ``obs``, the default ``k``).  The tiled
    steps are built for the index's ``geometry()`` (its bound format
    included).  This process serves shard ``rank`` of ``group``.  Every
    step is

        ``serve_step(index, queries=None, qw=None, tau_init=None,
        deleted_mask=None) -> (values [B, k], global ids [B, k], tau [B])``

    on this rank's device, the same on every rank.  ``index`` is the
    sharded index (whole, or ``keep_shard(rank)``); ``qw`` the dense
    query weights where a step reads them (``ell``, ``tiled``; the pruned
    steps read ``queries``).  ``tau`` is the merged k-th best where
    finite and certified by k real documents; ``tau_init`` (consumed by
    the BMP sweeps, rejected by the two-pass one) must be certified by k
    documents already retrieved in the same query stream.  A non-None
    ``deleted_mask`` raises ``NotImplementedError``.  With ``cfg.obs`` set
    each call is a fenced ``serve.shard_step`` span and counts
    ``serve.shard_steps_total``.  ``compute_dtype`` is float32 or
    bfloat16 (the module doc's contract); any other raises
    ``NotImplementedError``.
    """
    if compute_dtype not in COMPUTE_DTYPES:
        raise NotImplementedError(
            f"compute_dtype={compute_dtype}: the port's scoring kernels "
            "have float32 and bfloat16 routes only"
        )
    if cfg is None:
        cfg = RetrievalConfig(engine=engine or "tiled",
                              **({"k": k} if k else {}))
    engine = engine or cfg.engine
    k = k or cfg.k
    factory = registry.get_serve_factory(engine)
    ctx = _Group(group, *group_rank_size(group), compute_dtype)
    step = factory(ctx, k=k, docs_per_shard=docs_per_shard,
                   geometry=geometry, cfg=cfg,
                   hierarchical_merge=hierarchical_merge)
    obs = getattr(cfg, "obs", None)
    if obs is None:
        return step

    def serve_step(index, queries=None, qw=None, tau_init=None,
                   deleted_mask=None):
        with obs_mod.span(obs, "serve.shard_step", engine=engine):
            out = step(index, queries=queries, qw=qw, tau_init=tau_init,
                       deleted_mask=deleted_mask)
            obs_mod.fence(out)
        obs.counter("serve.shard_steps_total").inc()
        return out

    return serve_step


@registry.register_serve_factory("ell")
def _serve_factory_ell(ctx, *, k, docs_per_shard, geometry, cfg,
                       hierarchical_merge):
    def local_scores(local: EllIndex, queries, qw, tau_init, index):
        qw = _query_weights(queries, qw, local.vocab_size,
                            local.terms.device, local.values.dtype)
        return ell_ops.ell_gather(qw, local.terms,
                                  local.values)[:, :docs_per_shard]

    return _sharded_step(ctx, k, docs_per_shard, ShardedEllIndex, geometry,
                         local_scores)


def _raw_tiled_shard(arrays, rank: int, docs_per_shard: int,
                     geometry: dict, width: int, dtype) -> TiledIndex:
    """Shard ``rank`` of raw shard-stacked ``(local_term, local_doc, value,
    chunk_term_block, chunk_doc_block)`` arrays as a TiledIndex, its block
    runs found from the chunks' doc blocks (a padded tail's chunks hold no
    live slot and join the last run)."""
    lt, ld, val, ctb, cdb = (torch.as_tensor(a)[rank] for a in arrays)
    n_db = geometry["n_doc_blocks"]
    start, count = _block_chunk_runs(torch.cummax(cdb, 0).values, n_db)
    return TiledIndex(
        local_term=lt, local_doc=ld, value=val.to(dtype),
        chunk_term_block=ctb, chunk_doc_block=cdb, chunk_first=None,
        tile_max=None, block_max=None, num_docs=docs_per_shard,
        vocab_size=width, term_block=geometry["term_block"],
        doc_block=geometry["doc_block"], chunk_size=geometry["chunk_size"],
        block_chunk_start=start, block_chunk_count=count,
    )


@registry.register_serve_factory("tiled")
def _serve_factory_tiled(ctx, *, k, docs_per_shard, geometry, cfg,
                         hierarchical_merge):
    def local_scores(local: TiledIndex, queries, qw, tau_init, index):
        qw = _query_weights(queries, qw,
                            local.num_term_blocks * local.term_block,
                            local.local_term.device, local.value.dtype)
        return scoring._score_blocks(qw, local)[:, :docs_per_shard]

    step = _sharded_step(ctx, k, docs_per_shard, ShardedTiledIndex,
                         geometry, local_scores)

    def serve_step(index, queries=None, qw=None, tau_init=None,
                   deleted_mask=None):
        if isinstance(index, ShardedTiledIndex):
            return step(index, queries=queries, qw=qw, tau_init=tau_init,
                        deleted_mask=deleted_mask)
        # Raw (lt, ld, val, ctb, cdb) shard-stacked arrays, as JAX's step
        # takes them: one shard a rank, each of docs_per_shard real docs.
        _reject_deleted(deleted_mask)
        if qw is None:
            raise ValueError("a tiled step over raw arrays needs qw")
        qw = torch.as_tensor(qw)
        local = _raw_tiled_shard(index, ctx.rank, docs_per_shard, geometry,
                                 qw.shape[1], ctx.dtype)
        scores = local_scores(local, None, qw, tau_init, None)
        mv, mi = topk_mod.local_then_global_topk(
            scores, ctx.rank * docs_per_shard, k, ctx.group)
        mv = mv.float()
        num_real = int(torch.as_tensor(index[0]).shape[0]) * docs_per_shard
        return mv, mi, _advance_tau(mv, tau_init, k, num_real)

    return serve_step


def _bmp_local(theta: float, k: int):
    def local_scores(local: TiledIndex, queries, qw, tau_init, index):
        return scoring.score_tiled_bmp(_need_queries(queries), local, k=k,
                                       theta=theta, tau_init=tau_init)

    return local_scores


@registry.register_serve_factory("tiled-pruned")
def _serve_factory_tiled_pruned(ctx, *, k, docs_per_shard, geometry, cfg,
                                hierarchical_merge):
    if cfg.traversal != "two-pass":
        return _sharded_step(ctx, k, docs_per_shard, ShardedTiledIndex,
                             geometry, _bmp_local(1.0, k))

    def local_scores(local: TiledIndex, queries, qw, tau_init, index):
        if tau_init is not None:
            raise ValueError(
                "tau warm-start needs traversal='bmp' "
                "(the two-pass sweep re-seeds per call)"
            )
        return scoring.score_tiled_pruned(_need_queries(queries), local,
                                          k=k,
                                          seed_blocks=cfg.prune_seed_blocks)

    return _sharded_step(ctx, k, docs_per_shard, ShardedTiledIndex,
                         geometry, local_scores)


@registry.register_serve_factory("tiled-pruned-approx")
def _serve_factory_tiled_pruned_approx(ctx, *, k, docs_per_shard, geometry,
                                       cfg, hierarchical_merge):
    return _sharded_step(ctx, k, docs_per_shard, ShardedTiledIndex,
                         geometry, _bmp_local(cfg.theta, k))


def demand_plan(ctx: _Group, index: ShardedTiledIndex, local: TiledIndex,
                queries: SparseBatch, ub: torch.Tensor, cfg):
    """The demand plan of a grouped or fused step, the same on every rank:
    each rank's block bounds ``ub`` [B, n_db] and chunk counts gathered in
    shard order (both gathers on every call, so every rank issues the same
    collectives whether or not its plan cache hits), laid side by side as
    [B, S * n_db] (:func:`repro.core.distributed._host_demand_ub`), and fed
    to the deterministic planner."""
    demand = topk_mod.gather_shards(ub, ctx.group)  # [S, B, n_db]
    cost = topk_mod.gather_shards(local.block_chunk_count, ctx.group)
    demand = demand.permute(1, 0, 2).reshape(ub.shape[0], -1)
    knobs = (cfg.sched_top_m, cfg.sched_max_group, cfg.sched_min_share)
    return planner_mod.plan_with_cache(
        getattr(cfg, "plan_cache", None), queries, index,
        lambda: planner_mod.plan_micro_batches(
            demand.cpu().numpy(), cost.reshape(-1).cpu().numpy(),
            top_m=knobs[0], max_group=knobs[1], min_share=knobs[2],
        ),
        knobs=knobs, obs=getattr(cfg, "obs", None),
    )


def _grouped_factory(ctx, k, docs_per_shard, geometry, cfg, stacked: bool):
    def local_scores(local: TiledIndex, queries, qw, tau_init, index):
        queries = _need_queries(queries)
        ub = scoring.block_upper_bounds(queries, local)
        plan = demand_plan(ctx, index, local, queries, ub, cfg)
        return scoring.grouped_sweeps(
            queries, local, k, stacked=stacked, groups=plan.groups,
            tau_init=tau_init, obs=getattr(cfg, "obs", None), ub=ub,
        )

    return _sharded_step(ctx, k, docs_per_shard, ShardedTiledIndex,
                         geometry, local_scores)


@registry.register_serve_factory("tiled-bmp-grouped")
def _serve_factory_tiled_bmp_grouped(ctx, *, k, docs_per_shard, geometry,
                                     cfg, hierarchical_merge):
    """Demand-grouped sharded BMP: one plan over every shard's bounds, one
    ``bmp_scan`` launch a padded group on each shard, one merge."""
    return _grouped_factory(ctx, k, docs_per_shard, geometry, cfg,
                            stacked=False)


@registry.register_serve_factory("tiled-bmp-fused")
def _serve_factory_tiled_bmp_fused(ctx, *, k, docs_per_shard, geometry,
                                   cfg, hierarchical_merge):
    """Fused sharded BMP: the grouped step's plan, the groups of each
    power-of-two bucket stacked into one ``bmp_scan`` launch a shard
    (:func:`repro_torch.kernels.bmp_scan.ops.bmp_scan`'s contract)."""
    return _grouped_factory(ctx, k, docs_per_shard, geometry, cfg,
                            stacked=True)


# -- the deprecated factories (JAX's historical make_retrieval_serve_step_*) --


def _deprecated(old: str, new: str) -> None:
    warnings.warn(f"{old} is deprecated; use {new}", DeprecationWarning,
                  stacklevel=3)


def make_retrieval_serve_step(group=None, *, k: int, docs_per_shard: int,
                              hierarchical_merge: bool = True,
                              compute_dtype=torch.float32):
    """Deprecated: ``make_serve_step(engine="ell", ...)``.

    Original contract preserved: ``serve_step(index, qw) -> (values,
    global ids)``."""
    _deprecated("make_retrieval_serve_step",
                "make_serve_step(engine='ell', ...)")
    step = make_serve_step(group, engine="ell", k=k,
                           docs_per_shard=docs_per_shard,
                           hierarchical_merge=hierarchical_merge,
                           compute_dtype=compute_dtype)

    def serve_step(index, qw):
        mv, mi, _ = step(index, qw=qw)
        return mv, mi

    return serve_step


def make_retrieval_serve_step_tiled(group=None, *, k: int,
                                    docs_per_shard: int, geometry: dict,
                                    hierarchical_merge: bool = True,
                                    compute_dtype=torch.float32):
    """Deprecated: ``make_serve_step(engine="tiled", ...)``.

    Original contract preserved: ``serve_step(lt, ld, val, ctb, cdb, qw) ->
    (values, global ids)`` over the raw shard-stacked arrays."""
    _deprecated("make_retrieval_serve_step_tiled",
                "make_serve_step(engine='tiled', ...)")
    step = make_serve_step(group, engine="tiled", k=k,
                           docs_per_shard=docs_per_shard, geometry=geometry,
                           hierarchical_merge=hierarchical_merge,
                           compute_dtype=compute_dtype)

    def serve_step(lt, ld, val, ctb, cdb, qw):
        mv, mi, _ = step((lt, ld, val, ctb, cdb), qw=qw)
        return mv, mi

    return serve_step


def make_retrieval_serve_step_tiled_pruned(
    group=None, *, k: int, docs_per_shard: int, geometry: dict,
    seed_blocks: Optional[int] = None, hierarchical_merge: bool = True,
    compute_dtype=torch.float32,
):
    """Deprecated: ``make_serve_step(engine="tiled-pruned",
    cfg=RetrievalConfig(traversal="two-pass"), ...)``.

    Original contract preserved: ``serve_step(index, queries, qw) ->
    (values, global ids)``."""
    _deprecated("make_retrieval_serve_step_tiled_pruned",
                "make_serve_step(engine='tiled-pruned', ...)")
    cfg = RetrievalConfig(engine="tiled-pruned", traversal="two-pass", k=k,
                          prune_seed_blocks=seed_blocks)
    step = make_serve_step(group, engine="tiled-pruned", cfg=cfg, k=k,
                           docs_per_shard=docs_per_shard, geometry=geometry,
                           hierarchical_merge=hierarchical_merge,
                           compute_dtype=compute_dtype)

    def serve_step(index, queries, qw):
        mv, mi, _ = step(index, queries=queries, qw=qw)
        return mv, mi

    return serve_step


def make_retrieval_serve_step_tiled_bmp(
    group=None, *, k: int, docs_per_shard: int, geometry: dict,
    theta: float = 1.0, hierarchical_merge: bool = True,
    compute_dtype=torch.float32,
):
    """Deprecated: ``make_serve_step(engine="tiled-pruned", ...)`` (or
    ``engine="tiled-pruned-approx"`` with ``theta < 1``).

    Original contract preserved: ``serve_step(index, queries, qw,
    tau_init=None) -> (values, global ids, tau)``."""
    _deprecated("make_retrieval_serve_step_tiled_bmp",
                "make_serve_step(engine='tiled-pruned', ...)")
    engine = "tiled-pruned-approx" if theta != 1.0 else "tiled-pruned"
    cfg = RetrievalConfig(engine=engine, k=k,
                          **({"theta": theta} if theta != 1.0 else {}))
    step = make_serve_step(group, engine=engine, cfg=cfg, k=k,
                           docs_per_shard=docs_per_shard, geometry=geometry,
                           hierarchical_merge=hierarchical_merge,
                           compute_dtype=compute_dtype)

    def serve_step(index, queries, qw, tau_init=None):
        return step(index, queries=queries, qw=qw, tau_init=tau_init)

    return serve_step


# -- state carried across from the JAX package -------------------------------

ELL_FIELDS = ("terms", "values")
ELL_SCALARS = ("docs_per_shard", "num_docs", "vocab_size", "term_block",
               "doc_block")
TILED_FIELDS = ("local_term", "local_doc", "value", "chunk_term_block",
                "chunk_doc_block", "term_block_max_q", "term_block_scale",
                "block_chunk_start", "block_chunk_count", "tbm_indptr",
                "tbm_cols", "tbm_vals_q")
TILED_SCALARS = ("docs_per_shard", "num_docs", "vocab_size", "term_block",
                 "doc_block", "chunk_size", "bounds_format", "csr_row_cap")


def _tensors(arrays: dict, names, dev) -> dict:
    return {f: (None if arrays.get(f) is None
                else torch.from_numpy(np.array(arrays[f])).to(dev))
            for f in names}


def sharded_ell_from_numpy(arrays: dict, scalars: dict,
                           device="cuda") -> ShardedEllIndex:
    """A ShardedEllIndex from the JAX one's arrays as numpy
    (``ELL_FIELDS``, optional ``block_max``) and ``ELL_SCALARS``."""
    dev = resolve_device(device)
    return ShardedEllIndex(**_tensors(arrays, ELL_FIELDS + ("block_max",),
                                      dev),
                           **{f: scalars[f] for f in ELL_SCALARS})


def sharded_tiled_from_numpy(arrays: dict, scalars: dict,
                             device="cuda") -> ShardedTiledIndex:
    """A ShardedTiledIndex from the JAX one's arrays as numpy
    (``TILED_FIELDS``; the optional ones may be missing or None) and
    ``TILED_SCALARS``."""
    dev = resolve_device(device)
    return ShardedTiledIndex(**_tensors(arrays, TILED_FIELDS, dev),
                             **{f: scalars[f] for f in TILED_SCALARS})


__all__ = [
    "ShardedEllIndex", "ShardedTiledIndex", "build_sharded_ell",
    "build_sharded_tiled", "snapshot_paged", "make_serve_step",
    "group_rank_size", "sharded_ell_from_numpy", "sharded_tiled_from_numpy",
    "make_retrieval_serve_step", "make_retrieval_serve_step_tiled",
    "make_retrieval_serve_step_tiled_pruned",
    "make_retrieval_serve_step_tiled_bmp",
]


# ---------------------------------------------------------------------------
# Dry-run input shapes (``launch.cells``): meta tensors, no allocation


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def retrieval_input_specs(
    num_docs: int,
    vocab_size: int,
    batch: int,
    avg_doc_terms: int,
    num_shards: int,
    k_pad: int = 8,
):
    """The shard-stacked ELL index ([S, N/S, K] int32 terms, f32 values)
    and the [B, V] f32 query weights of the serve step, as ``meta``
    tensors of JAX's shapes and dtypes (``repro.core.distributed.
    retrieval_input_specs``), and ``docs_per_shard``."""
    per = cdiv(num_docs, num_shards)
    k = ceil_to(int(avg_doc_terms * 1.6), k_pad)  # headroom over the mean
    return dict(
        index=(_meta((num_shards, per, k), torch.int32),
               _meta((num_shards, per, k), torch.float32)),
        qw=_meta((batch, vocab_size), torch.float32),
        docs_per_shard=per,
    )


def retrieval_tiled_specs(
    num_docs: int,
    vocab_size: int,
    batch: int,
    avg_doc_terms: int,
    num_shards: int,
    chunk_size: int = 512,
    doc_block: int = 256,
    term_block: int = 512,
):
    """A shard-stacked tiled index's chunk arrays ([S, C, chunk_size]
    int32 terms and local docs, f32 values; [S, C] int32 chunk metadata)
    and the [B, V padded] f32 query weights, as ``meta`` tensors of JAX's
    shapes and dtypes (``repro.core.distributed.retrieval_tiled_specs``),
    with ``docs_per_shard``, ``n_chunks`` and the geometry."""
    per = cdiv(num_docs, num_shards)
    nnz = int(per * avg_doc_terms * 1.1)
    n_doc_blocks = cdiv(per, doc_block)
    n_chunks = cdiv(nnz, chunk_size) + n_doc_blocks
    v_pad = ceil_to(vocab_size, term_block)
    return dict(
        chunks=tuple(_meta((num_shards, n_chunks, chunk_size), dt)
                     for dt in (torch.int32, torch.int32, torch.float32)),
        meta=(_meta((num_shards, n_chunks), torch.int32),
              _meta((num_shards, n_chunks), torch.int32)),
        qw=_meta((batch, v_pad), torch.float32),
        docs_per_shard=per,
        n_chunks=n_chunks,
        geometry=dict(chunk_size=chunk_size, doc_block=doc_block,
                      term_block=term_block, n_doc_blocks=n_doc_blocks),
    )
