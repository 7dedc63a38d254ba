"""Device-parallel inverted indices, built on device with sorts and scans.

The layouts of :mod:`repro.core.index`, field for field:

``FlatIndex`` — the paper's §3 layout verbatim: every posting list
concatenated into ``doc_ids`` / ``values``, each list padded to ``pad_to``
slots (default ``LANE`` = 128, the JAX package's pad), with per-term
``offsets``, ``lengths``, ``padded_lengths`` and ``max_values``.  The
per-term loop of the ``segment`` engine reads it.

``TiledIndex`` — postings bucketed into ``(term_block x doc_block)`` tiles
and packed into fixed-capacity COO chunks (``local_term``, ``local_doc``,
``value``), sorted by doc block then term block.  Every doc block owns a
contiguous run of at least one chunk (``block_chunk_start/count``; a
posting-free block gets one empty zeroing chunk).  Within a chunk the
postings fill the first slots, padding after them, in ascending
``local_doc`` order: the stable sort below keeps the doc-major order of the
input.  The ``scatter_score`` kernel relies on these facts — one CTA per
doc block walks its run and sums each doc's postings as one contiguous
segment — and ``tiled_index_from_numpy`` checks them
(``check_chunk_order``) on an index built elsewhere.

``EllIndex`` — doc-major padded term lists for the doc-parallel kernel;
each row's terms are left-packed, padding id ``vocab_size``.

The builders give arrays equal to the JAX builders' (tested field for
field), but run as a handful of sorts, scans and scatters on the batch's
device instead of a Python loop per chunk.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.sparse import SparseBatch
from repro_torch.utils import cdiv, ceil_to, resolve_device

LANE = 128  # FlatIndex's default pad (the JAX package's TPU lane width)
SUBLANE = 8

# The array payload of a FlatIndex, in JAX's field order.
FLAT_ARRAY_FIELDS = (
    "doc_ids", "values", "offsets", "lengths", "padded_lengths",
    "max_values",
)

# The complete array payload of a TiledIndex (copied from
# repro.core.index): the fields every build produces, the optional ones
# (fine bounds in either layout), and the scalars.
TILED_ARRAY_FIELDS = (
    "local_term", "local_doc", "value", "chunk_term_block",
    "chunk_doc_block", "chunk_first", "tile_max", "block_max",
    "block_chunk_start", "block_chunk_count",
)
TILED_OPTIONAL_ARRAY_FIELDS = (
    "term_block_max_q", "term_block_scale",
    "tbm_indptr", "tbm_cols", "tbm_vals_q",
)
TILED_SCALAR_FIELDS = (
    "num_docs", "vocab_size", "term_block", "doc_block", "chunk_size",
    "bounds_format",
)


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


@dataclasses.dataclass
class TiledIndex:
    """(term_block x doc_block)-bucketed COO-chunk index (see module doc)."""

    local_term: torch.Tensor  # int32 [num_chunks, C] in [0, term_block), C at pad
    local_doc: torch.Tensor  # int32 [num_chunks, C] in [0, doc_block), -1 at pad
    value: torch.Tensor  # f32 [num_chunks, C]
    chunk_term_block: torch.Tensor  # int32 [num_chunks]
    chunk_doc_block: torch.Tensor  # int32 [num_chunks]
    chunk_first: torch.Tensor  # int32 [num_chunks] 1 = first chunk of its block
    tile_max: torch.Tensor  # f32 [num_chunks] max |value| in chunk
    block_max: torch.Tensor  # f32 [num_term_blocks, num_doc_blocks]
    num_docs: int
    vocab_size: int
    term_block: int
    doc_block: int
    chunk_size: int
    # Fine per-(term, doc_block) maxima, u8-quantized rounding up, with a
    # per-term f32 scale: dense u8 [V, n_db] or CSR (indptr, cols, vals).
    bounds_format: str = "dense"
    term_block_max_q: Optional[torch.Tensor] = None  # u8 [V, num_doc_blocks]
    term_block_scale: Optional[torch.Tensor] = None  # f32 [V]
    tbm_indptr: Optional[torch.Tensor] = None  # int32 [V + 1]
    tbm_cols: Optional[torch.Tensor] = None  # int32 [nnz_bounds]
    tbm_vals_q: Optional[torch.Tensor] = None  # u8 [nnz_bounds]
    # Block b owns chunks [block_chunk_start[b], + block_chunk_count[b]).
    block_chunk_start: Optional[torch.Tensor] = None  # int32 [num_doc_blocks]
    block_chunk_count: Optional[torch.Tensor] = None  # int32 [num_doc_blocks]

    @property
    def num_chunks(self) -> int:
        return int(self.local_term.shape[0])

    @property
    def num_doc_blocks(self) -> int:
        return cdiv(self.num_docs, self.doc_block)

    @property
    def num_term_blocks(self) -> int:
        return cdiv(self.vocab_size, self.term_block)

    @property
    def padded_docs(self) -> int:
        return self.num_doc_blocks * self.doc_block

    @property
    def device(self) -> torch.device:
        return self.local_term.device

    @property
    def has_fine_bounds(self) -> bool:
        return self.term_block_max_q is not None or self.tbm_indptr is not None

    def bounds_bytes(self) -> int:
        """Bytes actually stored for the fine bound matrix (either format)."""
        return sum(_nbytes(a) for a in (
            self.term_block_max_q, self.term_block_scale, self.tbm_indptr,
            self.tbm_cols, self.tbm_vals_q,
        ))

    def bounds_memory(self) -> dict:
        """Both layouts' sizes for the fine bound matrix, and the stored one."""
        if not self.has_fine_bounds:
            return {"format": "none", "stored": 0, "dense": 0, "csr": 0}
        v = int(self.term_block_scale.shape[0])
        scale = 4 * v
        dense = v * self.num_doc_blocks + scale
        if self.tbm_indptr is not None:
            nnz = int(self.tbm_cols.shape[0])
        else:
            nnz = int(torch.count_nonzero(self.term_block_max_q))
        csr = 4 * (v + 1) + 4 * nnz + nnz + scale
        return {"format": self.bounds_format, "stored": self.bounds_bytes(),
                "dense": dense, "csr": csr}

    def memory_bytes(self) -> int:
        return (sum(_nbytes(getattr(self, f)) for f in TILED_ARRAY_FIELDS)
                + self.bounds_bytes())

    @property
    def total_postings(self) -> int:
        return int((self.local_doc >= 0).sum())

    @property
    def padding_overhead(self) -> float:
        nnz = max(self.total_postings, 1)
        return self.local_doc.numel() / nnz - 1.0


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0) - x


def _block_chunk_runs(
    chunk_doc_block: torch.Tensor, n_doc_blocks: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(start, count) of each doc block's contiguous chunk run;
    ``chunk_doc_block`` must be sorted ascending."""
    db = chunk_doc_block.long().contiguous()
    blocks = torch.arange(n_doc_blocks, device=db.device)
    start = torch.searchsorted(db, blocks, right=False)
    count = torch.searchsorted(db, blocks, right=True) - start
    return start.to(torch.int32), count.to(torch.int32)


def _postings(docs: SparseBatch, start: int = 0, stop: Optional[int] = None):
    """(term, doc, value) of every posting of rows ``[start, stop)`` in
    doc-major, slot order — the order ``repro.core.sparse.to_numpy_rows``
    concatenates them in."""
    ids = docs.term_ids[start:stop]
    doc, slot = torch.nonzero(ids >= 0, as_tuple=True)
    return ids[doc, slot].long(), doc + start, docs.values[start:stop][
        doc, slot]


@dataclasses.dataclass
class FlatIndex:
    """Paper §3 flat inverted index (posting lists padded to ``pad_to``)."""

    doc_ids: torch.Tensor  # int32 [P], -1 at padding
    values: torch.Tensor  # f32 [P], 0 at padding
    offsets: torch.Tensor  # int32 [V] start of each term's (padded) list
    lengths: torch.Tensor  # int32 [V] true posting count
    padded_lengths: torch.Tensor  # int32 [V] rounded up to pad_to
    max_values: torch.Tensor  # f32 [V] per-term max value, floored at 0
    num_docs: int
    vocab_size: int
    pad_to: int = LANE

    @property
    def total_postings(self) -> int:
        return int(self.lengths.sum())

    @property
    def total_padded(self) -> int:
        return int(self.doc_ids.shape[0])

    @property
    def padding_overhead(self) -> float:
        """eps_pad of the paper's Eq. (3)."""
        nnz = max(self.total_postings, 1)
        return self.total_padded / nnz - 1.0

    @property
    def device(self) -> torch.device:
        return self.doc_ids.device

    def memory_bytes(self) -> int:
        return sum(_nbytes(getattr(self, f)) for f in FLAT_ARRAY_FIELDS)


def build_flat_index(
    docs: SparseBatch, pad_to: int = LANE, sort_postings: bool = True
) -> FlatIndex:
    """CSC over (term -> doc) postings (paper §3.2), on ``docs``' device.

    JAX sorts the postings by (term, doc), or stably by term when
    ``sort_postings`` is off.  The postings come doc-major, so one stable
    sort by term gives that order either way.  The total rounds up to at
    least ``pad_to`` slots, as in JAX (an empty vocabulary included).
    """
    dev = docs.device
    v = docs.vocab_size
    i32 = torch.int32
    terms, doc, vals = _postings(docs)
    terms, order = torch.sort(terms, stable=True)
    doc, vals = doc[order], vals[order]
    # Each term's run in the sorted postings: [start, start + length).
    bounds = torch.searchsorted(terms, torch.arange(v + 1, device=dev))
    start = bounds[:-1]
    lengths = bounds[1:] - start
    padded = (lengths + pad_to - 1) // pad_to * pad_to
    offsets = _exclusive_cumsum(padded)
    total = max(int(padded.sum()), pad_to)
    flat_docs = torch.full((total,), -1, dtype=i32, device=dev)
    flat_vals = torch.zeros(total, dtype=torch.float32, device=dev)
    pos = offsets[terms] + torch.arange(terms.numel(), device=dev) \
        - start[terms]
    flat_docs[pos] = doc.to(i32)
    flat_vals[pos] = vals
    max_values = torch.zeros(v, dtype=torch.float32, device=dev)
    max_values.scatter_reduce_(0, terms, vals, "amax")
    return FlatIndex(
        doc_ids=flat_docs, values=flat_vals, offsets=offsets.to(i32),
        lengths=lengths.to(i32), padded_lengths=padded.to(i32),
        max_values=max_values, num_docs=docs.batch, vocab_size=v,
        pad_to=pad_to,
    )


# Corpus slots a step of build_tiled_index reads at once, as whole doc
# blocks: bounds the step's per-posting scratch (about a dozen int64
# arrays of its postings) to a slab of 2^26 slots whatever the corpus
# (8,841,823 docs x 302 slots at serve_8m, over 2^31).
_TILED_ROW_ELEMS = 1 << 26
# Entries of a step's fine-bound slab ([V, its doc blocks] f32 maxima and
# their quantization's temporaries), where the build stores fine bounds:
# 2^26 whatever n_db (30,522 x 138,154 at serve_8m's sharded geometry,
# 16.9 GB as one f32 matrix).
_BOUND_ELEMS = 1 << 26


def _doc_block_ranges(docs: SparseBatch, doc_block: int, n_db: int,
                      vocab: int = 0):
    """[first, end) doc blocks of each step of the build, in order; with
    ``vocab`` (fine bounds stored) each step's [vocab, blocks] slab also
    stays within ``_BOUND_ELEMS``."""
    per = max(1, _TILED_ROW_ELEMS // max(docs.max_terms * doc_block, 1))
    if vocab:
        per = min(per, max(1, _BOUND_ELEMS // vocab))
    return [(s, min(s + per, n_db)) for s in range(0, n_db, per)]


def _bound_slab(terms, doc, vals, v: int, doc_block: int, d0: int,
                d1: int) -> torch.Tensor:
    """f32 [V, d1 - d0]: each (term, doc block)'s max |value| among the
    postings of doc blocks [d0, d1), 0 where it has none."""
    slab = torch.zeros(v * (d1 - d0), dtype=torch.float32, device=vals.device)
    slab.scatter_reduce_(0, terms * (d1 - d0) + doc // doc_block - d0,
                         vals.abs(), "amax")
    return slab.view(v, d1 - d0)


def _bound_scale(row_max: torch.Tensor) -> torch.Tensor:
    """Each term's quantization step from its largest |value| (1 for a
    term with none).  Float32, and true division (a tensor divisor: CUDA
    turns division by a Python scalar into a multiply by its reciprocal),
    as numpy computes it."""
    scale = torch.where(row_max > 0, row_max, 1.0) * (1.0 + 1e-6)
    return scale / torch.full_like(scale, 255.0)


def _quantize_bounds(slab: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """u8 [V, w] of the maxima ``slab`` over the steps ``scale`` [V],
    rounding up (floor + 1, at most 255; 0 where the max is 0) so that the
    dequantized bound never dips below the true max."""
    q = slab / scale[:, None]
    q.floor_().add_(1.0).clamp_(max=255.0)
    return q.masked_fill_(~(slab > 0), 0.0).to(torch.uint8)


class _TiledBuild:
    """The two passes of a tiled build over ``docs``' rows taken as
    ``num_docs`` docs (rows past ``docs.batch`` are empty docs, as a short
    last shard's padding rows are), a range of whole doc blocks at a time
    (``_doc_block_ranges``): the chunks are sorted doc block first, so
    each range owns one contiguous run of them.

    The constructor is the count pass: each doc block's chunks (``cdiv(len,
    C)`` a nonempty tile; a posting-free block gets one empty zeroing
    chunk) and, with ``bounds_format`` set, each term's largest |value|
    (its fine-bound scale: the max over doc blocks of the per-block
    maxima, which a max gives exactly) and for ``"csr"`` each term's count
    of nonzero bounds (``bound_indptr``).  :meth:`fill` is the second
    pass, into outputs the caller allocated once at their final size."""

    def __init__(self, docs: SparseBatch, num_docs: int, term_block: int,
                 doc_block: int, chunk_size: int,
                 bounds_format: Optional[str] = None):
        if bounds_format not in (None, "dense", "csr"):
            raise ValueError(
                f"unknown bounds_format {bounds_format!r}; use 'dense' or "
                "'csr'"
            )
        self.docs, self.bounds_format = docs, bounds_format
        self.term_block, self.doc_block = term_block, doc_block
        self.chunk_size = chunk_size
        dev, v = docs.device, docs.vocab_size
        i64 = torch.int64
        self.n_db = n_db = max(cdiv(num_docs, doc_block), 1)
        self.n_tb = n_tb = max(cdiv(v, term_block), 1)
        self.ranges = _doc_block_ranges(docs, doc_block, n_db,
                                        v if bounds_format else 0)
        real_per_db = torch.zeros(n_db, dtype=i64, device=dev)
        row_max = (torch.zeros(v, dtype=torch.float32, device=dev)
                   if bounds_format else None)
        nnz = (torch.zeros(v, dtype=i64, device=dev)
               if bounds_format == "csr" else None)
        for d0, d1 in self.ranges:
            terms, doc, vals = _postings(docs, d0 * doc_block, d1 * doc_block)
            tile = (doc // doc_block - d0) * n_tb + terms // term_block
            tile_len = torch.bincount(tile, minlength=(d1 - d0) * n_tb)
            real_per_db[d0:d1] = ((tile_len + chunk_size - 1) // chunk_size
                                  ).view(d1 - d0, n_tb).sum(dim=1)
            if row_max is not None:
                row_max.scatter_reduce_(0, terms, vals.abs(), "amax")
            if nnz is not None:
                nnz += (_bound_slab(terms, doc, vals, v, doc_block, d0, d1)
                        > 0).sum(dim=1)
        self.real_per_db = real_per_db
        self.per_db = torch.where(real_per_db > 0, real_per_db, 1)
        self.db_start = _exclusive_cumsum(self.per_db)
        self.n_chunks = int(self.per_db.sum())
        self.scale = None if row_max is None else _bound_scale(row_max)
        self.bound_indptr = None
        if nnz is not None:
            self.bound_indptr = torch.zeros(v + 1, dtype=i64, device=dev)
            self.bound_indptr[1:] = torch.cumsum(nnz, 0)

    def stored_scale(self) -> torch.Tensor:
        """``term_block_scale``: the step bumped up one ulp, so that the
        dequantized bound cannot round below the true maximum."""
        return torch.nextafter(self.scale,
                               torch.full_like(self.scale, float("inf")))

    def chunk_doc_block(self) -> torch.Tensor:
        """int32 [n_chunks]: each chunk's doc block."""
        return torch.repeat_interleave(
            torch.arange(self.n_db, dtype=torch.int32,
                         device=self.per_db.device), self.per_db)

    def fill(self, local_term, local_doc, value, chunk_term_block,
             tile_max=None, block_max=None, bounds=None) -> None:
        """The second pass: each range's postings, stably sorted by
        (doc_block, term_block), into the first ``n_chunks`` rows of
        ``local_term``/``local_doc``/``value`` [>= n_chunks, C] and
        ``chunk_term_block``, which hold their pad values already: each
        bucket (a run of equal key) splits into cdiv(len, C) chunks, and
        postings keep doc order within a tile.  Where given, ``tile_max``
        [n_chunks] and ``block_max`` [n_tb * n_db] (zeros) take amax
        scatters, and ``bounds`` the fine bounds: u8 [V, n_db] (zeros) for
        ``"dense"``, the CSR's ``(cols, vals_q)`` (at least
        ``bound_indptr[-1]`` long) for ``"csr"``, row-major."""
        docs, n_db, v = self.docs, self.n_db, self.docs.vocab_size
        term_block, doc_block = self.term_block, self.doc_block
        chunk_size = self.chunk_size
        dev = docs.device
        i32 = torch.int32
        cursor = (None if self.bound_indptr is None
                  else self.bound_indptr[:-1].clone())
        for d0, d1 in self.ranges:
            terms, doc, vals = _postings(docs, d0 * doc_block, d1 * doc_block)
            if bounds is not None:
                self._fill_bounds(bounds, cursor, _quantize_bounds(
                    _bound_slab(terms, doc, vals, v, doc_block, d0, d1),
                    self.scale), d0, d1)
            db = doc // doc_block
            tb = terms // term_block
            key = db * (v // term_block + 2) + tb
            key, order = torch.sort(key, stable=True)
            terms, doc, vals, db, tb = (terms[order], doc[order], vals[order],
                                        db[order], tb[order])
            _, bucket_len = torch.unique_consecutive(key, return_counts=True)
            bucket_start = _exclusive_cumsum(bucket_len)
            bucket_db = db[bucket_start]
            bucket_chunks = (bucket_len + chunk_size - 1) // chunk_size
            # A bucket's first chunk: its block's run start, plus the
            # chunks of the range's earlier buckets, less those of the
            # range's earlier blocks.
            bucket_first = (self.db_start[bucket_db]
                            + _exclusive_cumsum(bucket_chunks)
                            - _exclusive_cumsum(self.real_per_db[d0:d1])[
                                bucket_db - d0])
            bucket_of = torch.repeat_interleave(
                torch.arange(bucket_len.numel(), device=dev), bucket_len
            )
            offset = (torch.arange(terms.numel(), device=dev)
                      - bucket_start[bucket_of])
            chunk_of = bucket_first[bucket_of] + offset // chunk_size
            slot_of = offset % chunk_size
            local_term[chunk_of, slot_of] = (terms - tb * term_block).to(i32)
            local_doc[chunk_of, slot_of] = (doc - db * doc_block).to(i32)
            value[chunk_of, slot_of] = vals
            chunk_term_block[chunk_of] = tb.to(i32)
            absv = vals.abs()
            if tile_max is not None:
                tile_max.scatter_reduce_(0, chunk_of, absv, "amax")
            if block_max is not None:
                block_max.scatter_reduce_(0, tb * n_db + db, absv, "amax")

    def _fill_bounds(self, bounds, cursor, q, d0: int, d1: int) -> None:
        """Doc blocks [d0, d1)'s quantized bounds ``q`` [V, d1 - d0] into
        ``bounds``; CSR entries go after each row's earlier ranges'
        (``cursor``, advanced here), so each row's columns ascend."""
        if self.bounds_format == "dense":
            bounds[:, d0:d1] = q
            return
        cols, vals_q = bounds
        rows_nz, cols_nz = torch.nonzero(q, as_tuple=True)  # row-major
        count = torch.bincount(rows_nz, minlength=q.shape[0])
        rank = (torch.arange(rows_nz.numel(), device=q.device)
                - _exclusive_cumsum(count)[rows_nz])
        pos = cursor[rows_nz] + rank
        cols[pos] = (cols_nz + d0).to(torch.int32)
        vals_q[pos] = q[rows_nz, cols_nz]
        cursor += count


def build_tiled_index(
    docs: SparseBatch,
    term_block: int = 512,
    doc_block: int = 256,
    chunk_size: int = 512,
    store_term_block_max: bool = False,
    bounds_format: str = "dense",
) -> TiledIndex:
    """Bucket postings into (term_block x doc_block) tiles, pack COO chunks.

    Runs on ``docs``' device, a range of whole doc blocks at a time
    (``_TILED_ROW_ELEMS``, and ``_BOUND_ELEMS`` with fine bounds): a
    first pass counts each doc block's chunks (and the fine bounds' scale
    and CSR row lengths), the output is allocated once at its final size,
    and a second pass sorts each range's postings into its run and
    quantizes the range's fine bounds into place (:class:`_TiledBuild`).
    ``bounds_format`` picks the fine bound layout when
    ``store_term_block_max`` is set: ``"dense"`` (u8 [V, n_db]) or
    ``"csr"`` (nonzero (term, doc_block) entries only).
    """
    if bounds_format not in ("dense", "csr"):
        raise ValueError(
            f"unknown bounds_format {bounds_format!r}; use 'dense' or 'csr'"
        )
    dev = docs.device
    v = docs.vocab_size
    i32 = torch.int32
    build = _TiledBuild(docs, docs.batch, term_block, doc_block, chunk_size,
                        bounds_format if store_term_block_max else None)
    n_chunks, n_db, n_tb = build.n_chunks, build.n_db, build.n_tb

    local_term = torch.full((n_chunks, chunk_size), chunk_size, dtype=i32,
                            device=dev)
    local_doc = torch.full((n_chunks, chunk_size), -1, dtype=i32, device=dev)
    value = torch.zeros((n_chunks, chunk_size), dtype=torch.float32,
                        device=dev)
    chunk_term_block = torch.zeros(n_chunks, dtype=i32, device=dev)
    chunk_first = torch.zeros(n_chunks, dtype=i32, device=dev)
    chunk_first[build.db_start] = 1
    tile_max = torch.zeros(n_chunks, dtype=torch.float32, device=dev)
    # Per-(term_block, doc_block) maxima for block-max pruning.
    block_max = torch.zeros(n_tb * n_db, dtype=torch.float32, device=dev)
    fine, bounds = {}, None
    if store_term_block_max:
        fine["term_block_scale"] = build.stored_scale()
        if bounds_format == "csr":
            nnz = int(build.bound_indptr[-1])
            bounds = (torch.zeros(nnz, dtype=i32, device=dev),
                      torch.zeros(nnz, dtype=torch.uint8, device=dev))
            fine.update(tbm_indptr=build.bound_indptr.to(i32),
                        tbm_cols=bounds[0], tbm_vals_q=bounds[1])
        else:
            bounds = fine["term_block_max_q"] = torch.zeros(
                (v, n_db), dtype=torch.uint8, device=dev)
    build.fill(local_term, local_doc, value, chunk_term_block,
               tile_max=tile_max, block_max=block_max, bounds=bounds)

    return TiledIndex(
        local_term=local_term,
        local_doc=local_doc,
        value=value,
        chunk_term_block=chunk_term_block,
        chunk_doc_block=build.chunk_doc_block(),
        chunk_first=chunk_first,
        tile_max=tile_max,
        block_max=block_max.view(n_tb, n_db),
        num_docs=docs.batch,
        vocab_size=v,
        term_block=term_block,
        doc_block=doc_block,
        chunk_size=chunk_size,
        bounds_format=bounds_format,
        block_chunk_start=build.db_start.to(i32),
        block_chunk_count=build.per_db.to(i32),
        **fine,
    )


@dataclasses.dataclass
class EllIndex:
    """Doc-major ELL layout for the doc-parallel (bandwidth-bound) kernel."""

    terms: torch.Tensor  # int32 [N_pad, K], vocab_size at padding
    values: torch.Tensor  # f32 [N_pad, K]
    num_docs: int
    vocab_size: int

    def memory_bytes(self) -> int:
        return _nbytes(self.terms) + _nbytes(self.values)

    @property
    def max_terms(self) -> int:
        return int(self.terms.shape[1])

    @property
    def device(self) -> torch.device:
        return self.terms.device


# Rows left-packed at once by fill_ell_rows: bounds its scratch (the
# sort's int64 indices among it) to 2^26 slots.
_ELL_ROW_ELEMS = 1 << 26


def fill_ell_rows(docs: SparseBatch, terms: torch.Tensor,
                  values: torch.Tensor) -> None:
    """Write ``docs``' rows, left-packed, into the first ``docs.batch``
    rows of ``terms``/``values`` [>= N, K] (which hold ``vocab_size`` and 0
    already), a bounded number of rows at a time."""
    n, v = docs.batch, docs.vocab_size
    width = min(terms.shape[1], docs.max_terms)
    step = max(1, _ELL_ROW_ELEMS // max(docs.max_terms, 1))
    for s in range(0, n, step):
        e = min(s + step, n)
        ids, vals = docs.term_ids[s:e], docs.values[s:e]
        # Stable sort of each row on "is padding" moves live slots first.
        order = torch.sort((ids < 0).to(torch.int8), dim=1,
                           stable=True).indices
        ids = ids.gather(1, order)[:, :width]
        vals = vals.gather(1, order)[:, :width]
        terms[s:e, :width] = torch.where(ids >= 0, ids, v).to(torch.int32)
        values[s:e, :width] = torch.where(ids >= 0, vals, 0.0)


def fill_block_max(docs: SparseBatch, term_block: int, doc_block: int,
                   out: torch.Tensor) -> None:
    """Take ``out`` [n_tb, n_db] (zeros) to the per-(term_block,
    doc_block) max |value| of ``docs``' rows, ``_ELL_ROW_ELEMS`` slots a
    step (amax scatters: the whole-batch result)."""
    flat = out.view(-1)
    step = max(1, _ELL_ROW_ELEMS // max(docs.max_terms, 1))
    for s in range(0, docs.batch, step):
        terms, doc, vals = _postings(docs, s, s + step)
        flat.scatter_reduce_(
            0, terms // term_block * out.shape[1] + doc // doc_block,
            vals.abs(), "amax")


def build_ell_index(
    docs: SparseBatch, k_pad: int = SUBLANE, n_pad: int = SUBLANE
) -> EllIndex:
    """Left-packed padded term lists, on ``docs``' device."""
    n, v = docs.batch, docs.vocab_size
    lens = docs.nnz_per_row()
    k = ceil_to(max(int(lens.max()) if n else 1, 1), k_pad)
    npad = ceil_to(max(n, 1), n_pad)
    terms = torch.full((npad, k), v, dtype=torch.int32, device=docs.device)
    values = torch.zeros((npad, k), dtype=torch.float32, device=docs.device)
    fill_ell_rows(docs, terms, values)
    return EllIndex(terms, values, n, v)


def reorder_docs(
    docs: SparseBatch, method: str = "signature"
) -> tuple[SparseBatch, torch.Tensor]:
    """Cluster-friendly document permutation, on ``docs``' device
    (:func:`repro.core.index.reorder_docs`, the same permutation).

    ``"signature"`` stably sorts documents by their top-weighted term id;
    ``"df-signature"`` by the highest-document-frequency term among each
    document's 8 top-weighted terms (the first such in ascending weight
    order on a tie of frequencies); ``"none"`` keeps the order.  Empty
    documents go last.  Returns the permuted batch and ``perm`` (int64,
    on the device) with ``new_row[i] = old_row[perm[i]]``.
    """
    ids, vals = docs.term_ids, docs.values
    dev, v = docs.device, docs.vocab_size
    live = ids >= 0
    masked = torch.where(live, vals, float("-inf"))
    if method == "none":
        perm = torch.arange(docs.batch, device=dev)
    elif method == "signature":
        top = ids.gather(1, masked.argmax(dim=1, keepdim=True))[:, 0]
        sig = torch.where(top >= 0, top, v)
        perm = torch.sort(sig, stable=True).indices
    elif method == "df-signature":
        df = torch.bincount(torch.where(live, ids, v).reshape(-1).long(),
                            minlength=v + 1)
        df[v] = -1  # padding never wins
        n_top = min(8, ids.shape[1])
        top_slots = torch.sort(masked, dim=1, stable=True).indices[:, -n_top:]
        cand = ids.gather(1, top_slots).long()
        cand = torch.where(cand >= 0, cand, v)
        sig = cand.gather(1, df[cand].argmax(dim=1, keepdim=True))[:, 0]
        perm = torch.sort(sig, stable=True).indices
    else:
        raise ValueError(f"unknown reorder method {method!r}")
    return SparseBatch(ids[perm], vals[perm], v), perm


def shard_docs(docs: SparseBatch, num_shards: int,
               shard: int) -> tuple[SparseBatch, int]:
    """Contiguous document partition for document-sharded serving
    (:func:`repro.core.index.shard_docs`): shard ``shard``'s rows and its
    global doc-id offset.  Every shard gets ``cdiv(N, num_shards)`` rows,
    the last ones padded with empty docs, so shard shapes are uniform.
    Runs on ``docs``' device."""
    per = cdiv(docs.batch, num_shards)
    start = shard * per
    end = min(start + per, docs.batch)
    ids = torch.full((per, docs.max_terms), -1, dtype=torch.int32,
                     device=docs.device)
    vals = torch.zeros((per, docs.max_terms), dtype=torch.float32,
                       device=docs.device)
    if end > start:
        ids[: end - start] = docs.term_ids[start:end]
        vals[: end - start] = docs.values[start:end]
    return SparseBatch(ids, vals, docs.vocab_size), start


def filter_tiled_index(index: TiledIndex, queries: SparseBatch) -> TiledIndex:
    """Query-aware tile skipping (exact): drop chunks whose term block
    carries zero query mass.  Every doc block keeps at least one chunk (its
    first, with postings blanked when its term block is inactive), so the
    kernel still writes every output window.  ``local_term`` is left as
    is: the blanking is in ``local_doc``/``value`` only."""
    dev = index.device
    q_ids = queries.term_ids.to(dev)
    q_vals = queries.values.to(dev)
    active = torch.zeros(index.num_term_blocks, dtype=torch.bool, device=dev)
    valid = (q_ids >= 0) & (q_vals != 0)
    active[q_ids[valid].long() // index.term_block] = True

    tb = index.chunk_term_block.long()
    db = index.chunk_doc_block.long()
    keep = active[tb]
    kept = torch.zeros(index.num_doc_blocks, dtype=torch.int64, device=dev)
    kept.index_add_(0, db, keep.long())
    keep[index.block_chunk_start.long()[kept == 0]] = True

    idx = torch.nonzero(keep).squeeze(1)
    db_kept = index.chunk_doc_block[idx]
    first = torch.ones(idx.numel(), dtype=torch.int32, device=dev)
    first[1:] = (db_kept[1:] != db_kept[:-1]).to(torch.int32)
    ld = index.local_doc[idx]
    val = index.value[idx]
    inactive = ~active[tb[idx]]
    ld[inactive] = -1
    val[inactive] = 0.0
    run_start, run_count = _block_chunk_runs(db_kept, index.num_doc_blocks)
    return dataclasses.replace(
        index,
        local_term=index.local_term[idx],
        local_doc=ld,
        value=val,
        chunk_term_block=index.chunk_term_block[idx],
        chunk_doc_block=db_kept,
        chunk_first=first,
        tile_max=index.tile_max[idx],
        block_chunk_start=run_start,
        block_chunk_count=run_count,
    )


# -- state carried across from the JAX package -------------------------------


def _tensor(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dev)  # a writable copy


def tiled_index_from_numpy(arrays: dict, scalars: dict,
                           device="cuda") -> TiledIndex:
    """A TiledIndex from the JAX index's fields as numpy arrays (names of
    ``TILED_ARRAY_FIELDS`` + ``TILED_OPTIONAL_ARRAY_FIELDS``; an optional
    field may be missing or None) and its ``TILED_SCALAR_FIELDS``."""
    dev = resolve_device(device)
    tensors = {
        f: _tensor(arrays[f], dev)
        for f in TILED_ARRAY_FIELDS + TILED_OPTIONAL_ARRAY_FIELDS
        if arrays.get(f) is not None
    }
    index = TiledIndex(**tensors,
                       **{f: scalars[f] for f in TILED_SCALAR_FIELDS})
    check_chunk_order(index)
    return index


def check_chunk_order(index: TiledIndex) -> None:
    """Raise unless each chunk's live slots (``local_doc >= 0``) come first
    and in non-decreasing ``local_doc`` order — what the ``scatter_score``
    kernel's segmented sums assume (see the module doc)."""
    ld = index.local_doc
    live = ld >= 0
    if bool((live[:, 1:] & ~live[:, :-1]).any()):
        raise ValueError("TiledIndex: a chunk has a live slot after padding")
    if bool((live[:, 1:] & (ld[:, 1:] < ld[:, :-1])).any()):
        raise ValueError("TiledIndex: a chunk's local_doc is not sorted")


def ell_index_from_numpy(terms, values, num_docs: int, vocab_size: int,
                         device="cuda") -> EllIndex:
    dev = resolve_device(device)
    return EllIndex(_tensor(terms, dev), _tensor(values, dev), num_docs,
                    vocab_size)
