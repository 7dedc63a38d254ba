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
