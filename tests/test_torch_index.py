"""repro_torch index builders vs repro's, field for field, on the CPU.

Both packages index the same numpy corpus (``repro.data.synthetic``); the
port's vectorised builders must give arrays equal to the JAX package's
loop-per-chunk builders — values, dtypes and shapes — and the state
carried across (``*_from_numpy``) must round-trip.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import index as jidx
from repro.core.sparse import SparseBatch as JBatch
from repro.data.synthetic import make_msmarco_like
from repro_torch.core import index as tidx
from repro_torch.core.sparse import SparseBatch as TBatch

FIELDS = tidx.TILED_ARRAY_FIELDS + tidx.TILED_OPTIONAL_ARRAY_FIELDS


def _np(a):
    return None if a is None else (
        a.numpy() if torch.is_tensor(a) else np.asarray(a)
    )


def _corpus(n_docs, vocab, seed, empty_blocks=(), holes=False):
    """Numpy (ids, vals) of a synthetic corpus; ``empty_blocks`` are doc
    ranges left posting-free, ``holes`` blanks a few mid-row slots."""
    c = make_msmarco_like(n_docs, 4, vocab_size=vocab, seed=seed)
    ids = np.array(c.docs.term_ids)
    vals = np.array(c.docs.values)
    for lo, hi in empty_blocks:
        ids[lo:hi] = -1
        vals[lo:hi] = 0.0
    if holes:
        rng = np.random.default_rng(seed)
        r = rng.integers(0, n_docs, size=20)
        s = rng.integers(0, 3, size=20)
        ids[r, s] = -1
        vals[r, s] = 0.0
    return ids, vals, c


def _both(ids, vals, vocab):
    return (JBatch(jnp.asarray(ids), jnp.asarray(vals), vocab),
            TBatch(torch.from_numpy(ids), torch.from_numpy(vals), vocab))


def _assert_tiled_equal(j, t):
    for f in FIELDS:
        a, b = _np(getattr(j, f)), _np(getattr(t, f))
        if a is None:
            assert b is None, f
            continue
        assert b is not None, f
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in tidx.TILED_SCALAR_FIELDS:
        assert getattr(j, f) == getattr(t, f), f


# (n_docs, vocab, term_block, doc_block, chunk_size, empty doc ranges)
GEOMETRIES = [
    # vocab not a multiple of term_block; chunk_size < term_block
    (300, 1000, 128, 64, 64, ()),
    # posting-free doc blocks (the second and the last), ragged last block
    (333, 700, 256, 32, 128, ((32, 64), (320, 333))),
    # chunk_size > term_block; a block larger than the corpus
    (90, 513, 64, 128, 256, ()),
]


@pytest.mark.parametrize("n_docs,vocab,tb,db,cs,empty", GEOMETRIES)
@pytest.mark.parametrize("bounds", [None, "dense", "csr"])
def test_build_tiled_index_matches_jax(n_docs, vocab, tb, db, cs, empty,
                                       bounds):
    ids, vals, _ = _corpus(n_docs, vocab, seed=n_docs, empty_blocks=empty,
                           holes=True)
    jb, tbatch = _both(ids, vals, vocab)
    kw = dict(term_block=tb, doc_block=db, chunk_size=cs,
              store_term_block_max=bounds is not None,
              bounds_format=bounds or "dense")
    j = jidx.build_tiled_index(jb, **kw)
    t = tidx.build_tiled_index(tbatch, **kw)
    _assert_tiled_equal(j, t)
    assert t.memory_bytes() == j.memory_bytes()
    assert t.bounds_memory() == j.bounds_memory()
    assert t.padding_overhead == pytest.approx(j.padding_overhead)


def _ranges_of(blocks, db, k):
    """``_TILED_ROW_ELEMS`` for build steps of ``blocks`` doc blocks each
    (1 = a range boundary on every doc block)."""
    return blocks * db * k


@pytest.mark.parametrize("n_docs,vocab,tb,db,cs,empty", GEOMETRIES)
@pytest.mark.parametrize("bounds", [None, "dense", "csr"])
def test_ranged_build_tiled_index_matches_one_shot_and_jax(
        n_docs, vocab, tb, db, cs, empty, bounds, monkeypatch):
    """The build in ranges of whole doc blocks (the module constant lowered
    to one block a range, and to three with a ragged last range) equals the
    one-shot build and JAX's, field for field, bit for bit: posting-free
    blocks keep their one empty chunk, a ragged last block, the bounds in
    both formats."""
    ids, vals, _ = _corpus(n_docs, vocab, seed=n_docs + 1,
                           empty_blocks=empty, holes=True)
    jb, tbatch = _both(ids, vals, vocab)
    kw = dict(term_block=tb, doc_block=db, chunk_size=cs,
              store_term_block_max=bounds is not None,
              bounds_format=bounds or "dense")
    j = jidx.build_tiled_index(jb, **kw)
    whole = tidx.build_tiled_index(tbatch, **kw)
    n_db = -(-n_docs // db)
    assert len(tidx._doc_block_ranges(tbatch, db, n_db)) == 1
    for blocks in (1, 3):
        monkeypatch.setattr(tidx, "_TILED_ROW_ELEMS",
                            _ranges_of(blocks, db, tbatch.max_terms))
        assert len(tidx._doc_block_ranges(tbatch, db, n_db)) == \
            -(-n_db // blocks)
        t = tidx.build_tiled_index(tbatch, **kw)
        _assert_tiled_equal(j, t)
        _assert_tiled_equal(whole, t)


@pytest.mark.parametrize("fmt", ["dense", "csr"])
def test_ranged_build_sharded_tiled_matches_jax(fmt, monkeypatch):
    """``build_sharded_tiled`` runs each shard's build in ranges: with a
    range boundary on every doc block, every stacked field is JAX's."""
    from repro.core import distributed as jdist
    from repro_torch.core import distributed as tdist

    ids, vals, _ = _corpus(301, 900, seed=8, empty_blocks=((64, 96),),
                           holes=True)
    jb, tbatch = _both(ids, vals, 900)
    monkeypatch.setattr(tidx, "_TILED_ROW_ELEMS", 1)
    geo = dict(term_block=128, doc_block=32, chunk_size=64,
               bounds_format=fmt)
    j = jdist.build_sharded_tiled(jb, 2, **geo)
    t = tdist.build_sharded_tiled(tbatch, 2, **geo)
    for f in tdist.TILED_FIELDS:
        a, b = getattr(j, f), getattr(t, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f)
    for f in tdist.TILED_SCALARS + ("num_shards", "num_doc_blocks"):
        assert getattr(t, f) == getattr(j, f), f


def test_chunks_hold_postings_in_doc_order():
    """The scatter_score kernel's invariant: within every chunk the valid
    postings' local_doc never decreases, and each doc block's run is
    [block_chunk_start, + block_chunk_count)."""
    ids, vals, _ = _corpus(300, 1000, seed=3)
    t = tidx.build_tiled_index(_both(ids, vals, 1000)[1], term_block=128,
                               doc_block=64, chunk_size=64)
    ld = t.local_doc.numpy()
    for row in ld:
        live = row[row >= 0]
        assert np.all(np.diff(live) >= 0)
        assert np.all(row[len(live):] == -1)  # padding only at the end
    db = t.chunk_doc_block.numpy()
    for b, (s, n) in enumerate(zip(t.block_chunk_start.numpy(),
                                   t.block_chunk_count.numpy())):
        assert n >= 1 and np.all(db[s:s + n] == b)


@pytest.mark.parametrize("q_terms", [None, (0, 40)])
def test_filter_tiled_index_matches_jax(q_terms):
    ids, vals, c = _corpus(333, 700, seed=5, empty_blocks=((32, 64),))
    jb, tbatch = _both(ids, vals, 700)
    kw = dict(term_block=128, doc_block=32, chunk_size=64)
    j = jidx.build_tiled_index(jb, **kw)
    t = tidx.build_tiled_index(tbatch, **kw)
    q_ids = np.array(c.queries.term_ids)
    q_vals = np.array(c.queries.values)
    if q_terms is not None:  # queries in one term block: most chunks go
        lo, hi = q_terms
        q_vals = np.where((q_ids >= lo) & (q_ids < hi), q_vals, 0.0)
        q_vals = q_vals.astype(np.float32)
    jq, tq = _both(q_ids, q_vals, 700)
    jf = jidx.filter_tiled_index(j, jq)
    tf = tidx.filter_tiled_index(t, tq)
    _assert_tiled_equal(jf, tf)
    if q_terms is not None:
        assert tf.num_chunks < t.num_chunks


@pytest.mark.parametrize("n_docs,vocab,holes", [(300, 1000, False),
                                                (97, 513, True)])
def test_build_ell_index_matches_jax(n_docs, vocab, holes):
    ids, vals, _ = _corpus(n_docs, vocab, seed=n_docs + 1, holes=holes)
    jb, tbatch = _both(ids, vals, vocab)
    j = jidx.build_ell_index(jb)
    t = tidx.build_ell_index(tbatch)
    for f in ("terms", "values"):
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (t.num_docs, t.vocab_size) == (j.num_docs, j.vocab_size)
    assert t.memory_bytes() == j.memory_bytes()


@pytest.mark.parametrize("bounds", [None, "dense", "csr"])
def test_tiled_index_from_numpy_round_trips(bounds):
    ids, vals, _ = _corpus(200, 600, seed=7)
    jb, tbatch = _both(ids, vals, 600)
    kw = dict(term_block=128, doc_block=32, chunk_size=64,
              store_term_block_max=bounds is not None,
              bounds_format=bounds or "dense")
    j = jidx.build_tiled_index(jb, **kw)
    carried = tidx.tiled_index_from_numpy(
        {f: _np(getattr(j, f)) for f in FIELDS},
        {f: getattr(j, f) for f in tidx.TILED_SCALAR_FIELDS},
        device="cpu",
    )
    _assert_tiled_equal(j, carried)
    t = tidx.build_tiled_index(tbatch, **kw)
    again = tidx.tiled_index_from_numpy(
        {f: _np(getattr(t, f)) for f in FIELDS},
        dataclasses.asdict(t), device="cpu",
    )
    _assert_tiled_equal(t, again)


@pytest.mark.parametrize("breakage", ["slot_after_padding", "unsorted_docs"])
def test_tiled_index_from_numpy_rejects_chunk_order_the_kernel_cannot_sum(
        breakage):
    ids, vals, _ = _corpus(200, 600, seed=7)
    jb, _ = _both(ids, vals, 600)
    j = jidx.build_tiled_index(jb, term_block=128, doc_block=32,
                               chunk_size=64)
    scalars = {f: getattr(j, f) for f in tidx.TILED_SCALAR_FIELDS}
    # The JAX build and its tile-skipped form keep the order.
    jq = jidx.filter_tiled_index(j, _both(ids[:2], vals[:2], 600)[0])
    for ok in (j, jq):
        tidx.tiled_index_from_numpy(
            {f: _np(getattr(ok, f)) for f in FIELDS}, scalars, device="cpu")
    arrays = {f: _np(getattr(j, f)) for f in FIELDS}
    ld = arrays["local_doc"].copy()
    live = (ld >= 0).sum(axis=1)
    row = int(np.argmax(np.where(live < ld.shape[1], live, 0)))
    n_live = int(live[row])
    assert 2 <= n_live < ld.shape[1]
    if breakage == "slot_after_padding":
        ld[row, n_live - 1], ld[row, n_live] = -1, ld[row, n_live - 1]
    else:
        ld[row, :n_live] = ld[row, :n_live][::-1].copy()
        assert ld[row, 0] > ld[row, n_live - 1]
    arrays["local_doc"] = ld
    with pytest.raises(ValueError, match="TiledIndex"):
        tidx.tiled_index_from_numpy(arrays, scalars, device="cpu")


def test_ell_index_from_numpy_round_trips():
    ids, vals, _ = _corpus(120, 500, seed=9)
    j = jidx.build_ell_index(_both(ids, vals, 500)[0])
    t = tidx.ell_index_from_numpy(np.asarray(j.terms), np.asarray(j.values),
                                  j.num_docs, j.vocab_size, device="cpu")
    np.testing.assert_array_equal(t.terms.numpy(), np.asarray(j.terms))
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    assert (t.num_docs, t.vocab_size) == (j.num_docs, j.vocab_size)


# -- the bounded sharded build and the fine bounds by ranges ----------------


def _one_shot_fine_bounds(tbm: torch.Tensor, bounds_format: str) -> dict:
    """The fine bounds of a whole [V, n_db] f32 maxima matrix in one step,
    as the build computed them before it quantized a range of doc blocks
    at a time: the reference the ranged build is held to."""
    v = tbm.shape[0]
    row_max = tbm.max(dim=1).values
    scale = torch.where(row_max > 0, row_max, 1.0) * (1.0 + 1e-6)
    scale = scale / torch.full_like(scale, 255.0)
    q = torch.minimum(torch.floor(tbm / scale[:, None]) + 1.0,
                      torch.full_like(tbm, 255.0))
    dense_q = torch.where(tbm > 0, q, 0.0).to(torch.uint8)
    out = {"term_block_scale": torch.nextafter(
        scale, torch.full_like(scale, float("inf")))}
    if bounds_format == "csr":
        rows_nz, cols_nz = torch.nonzero(dense_q, as_tuple=True)
        indptr = torch.zeros(v + 1, dtype=torch.int64)
        indptr[1:] = torch.cumsum(torch.bincount(rows_nz, minlength=v), 0)
        out.update(tbm_indptr=indptr.to(torch.int32),
                   tbm_cols=cols_nz.to(torch.int32),
                   tbm_vals_q=dense_q[rows_nz, cols_nz])
    else:
        out["term_block_max_q"] = dense_q
    return out


def _tbm(ids, vals, vocab, doc_block):
    """f32 [V, n_db]: each (term, doc block)'s max |value|."""
    n_db = -(-ids.shape[0] // doc_block)
    out = np.zeros((vocab, n_db), np.float32)
    r, s = np.nonzero(ids >= 0)
    np.maximum.at(out, (ids[r, s], r // doc_block), np.abs(vals[r, s]))
    return torch.from_numpy(out)


@pytest.mark.parametrize("fmt", ["dense", "csr"])
@pytest.mark.parametrize("blocks", [1, 3])
def test_fine_bounds_by_ranges_match_one_shot_and_jax(fmt, blocks,
                                                      monkeypatch):
    """The fine bounds quantized a range of doc blocks at a time
    (``_BOUND_ELEMS`` lowered to one and to three blocks a range) equal
    the one-shot quantization of the whole [V, n_db] maxima and JAX's, in
    both formats: a term with no postings (scale 1.0), an all-zero column
    (a posting-free doc block) and a ragged last block included."""
    vocab, db = 700, 32
    ids, vals, _ = _corpus(333, vocab, seed=21, empty_blocks=((64, 96),),
                           holes=True)
    ids[ids == 5] = -1  # term 5 has no postings
    vals[ids < 0] = 0.0
    jb, tbatch = _both(ids, vals, vocab)
    kw = dict(term_block=128, doc_block=db, chunk_size=64,
              store_term_block_max=True, bounds_format=fmt)
    j = jidx.build_tiled_index(jb, **kw)
    monkeypatch.setattr(tidx, "_BOUND_ELEMS", blocks * vocab)
    n_db = -(-333 // db)
    assert len(tidx._doc_block_ranges(tbatch, db, n_db, vocab)) == \
        -(-n_db // blocks)
    t = tidx.build_tiled_index(tbatch, **kw)
    _assert_tiled_equal(j, t)
    tbm = _tbm(ids, vals, vocab, db)
    assert not tbm[5].any() and not tbm[:, 2].any()
    want = _one_shot_fine_bounds(tbm, fmt)
    assert t.term_block_scale[5] == torch.nextafter(
        torch.tensor(1.0 * (1.0 + 1e-6)) / 255.0, torch.tensor(np.inf))
    for name, a in want.items():
        b = getattr(t, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


def _stacked_one_shot(tbatch, shards, geo):
    """Today's sharded layout from each ``shard_docs`` copy's one-shot
    build, padded at the tail and stacked: the reference of the bounded
    sharded build."""
    built = [tidx.build_tiled_index(tidx.shard_docs(tbatch, shards, s)[0],
                                    store_term_block_max=True, **geo)
             for s in range(shards)]
    c_n = max(b.num_chunks for b in built)
    fills = dict(local_term=geo["chunk_size"], local_doc=-1, value=0.0,
                 chunk_term_block=0, chunk_doc_block=0)
    out = {}
    for name, fill in fills.items():
        out[name] = torch.stack([torch.cat([
            getattr(b, name), getattr(b, name).new_full(
                (c_n - b.num_chunks,) + getattr(b, name).shape[1:], fill)])
            for b in built])
    for name in ("term_block_scale", "block_chunk_start",
                 "block_chunk_count", "term_block_max_q", "tbm_indptr"):
        if getattr(built[0], name) is not None:
            out[name] = torch.stack([getattr(b, name) for b in built])
    if geo["bounds_format"] == "csr":
        nnz = max(max(b.tbm_cols.numel() for b in built), 1)
        for name in ("tbm_cols", "tbm_vals_q"):
            out[name] = torch.stack([torch.cat([getattr(b, name), getattr(
                b, name).new_zeros(nnz - getattr(b, name).numel())])
                for b in built])
    return out


@pytest.mark.parametrize("fmt", ["dense", "csr"])
@pytest.mark.parametrize("shards", [1, 2, 3])
@pytest.mark.parametrize("blocks", [1, 3])
def test_bounded_build_sharded_tiled_matches_jax(fmt, shards, blocks,
                                                 monkeypatch):
    """``build_sharded_tiled`` counts every shard, allocates the stacked
    arrays once and fills each shard's row from a view of the corpus: at
    S = 1, 2 and 3 (302 docs: a ragged last shard, and at S = 3 one with
    padding rows), with ranges of one and three doc blocks forced through
    ``_BOUND_ELEMS``, every stacked field equals JAX's
    ``build_sharded_tiled`` and the padded stack of each shard's one-shot
    build."""
    from repro.core import distributed as jdist
    from repro_torch.core import distributed as tdist

    vocab = 900
    ids, vals, _ = _corpus(302, vocab, seed=8, empty_blocks=((64, 96),),
                           holes=True)
    jb, tbatch = _both(ids, vals, vocab)
    geo = dict(term_block=128, doc_block=32, chunk_size=64,
               bounds_format=fmt)
    j = jdist.build_sharded_tiled(jb, shards, **geo)
    want = _stacked_one_shot(tbatch, shards, geo)
    monkeypatch.setattr(tidx, "_BOUND_ELEMS", blocks * vocab)
    t = tdist.build_sharded_tiled(tbatch, shards, **geo)
    for f in tdist.TILED_FIELDS:
        a, b = getattr(j, f), getattr(t, f)
        assert (a is None) == (b is None) == (f not in want), f
        if a is not None:
            assert b.dtype == want[f].dtype, f
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f)
            assert torch.equal(b, want[f]), f
    for f in tdist.TILED_SCALARS + ("num_shards", "num_doc_blocks"):
        assert getattr(t, f) == getattr(j, f), f


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_build_sharded_ell_block_max_matches_jax(shards, monkeypatch):
    """``build_sharded_ell(store_block_max=True)`` takes each shard's
    per-tile maxima from row views a few rows at a time (``_ELL_ROW_ELEMS``
    lowered to 7 rows a step): every field JAX's."""
    from repro.core import distributed as jdist
    from repro_torch.core import distributed as tdist

    ids, vals, _ = _corpus(302, 900, seed=12, empty_blocks=((64, 96),),
                           holes=True)
    jb, tbatch = _both(ids, vals, 900)
    monkeypatch.setattr(tidx, "_ELL_ROW_ELEMS", 7 * tbatch.max_terms)
    kw = dict(store_block_max=True, term_block=128, doc_block=32)
    j = jdist.build_sharded_ell(jb, shards, **kw)
    t = tdist.build_sharded_ell(tbatch, shards, **kw)
    for f in ("terms", "values", "block_max"):
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a, err_msg=f)
