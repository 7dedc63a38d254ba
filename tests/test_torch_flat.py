"""The port's FlatIndex and the paper's comparison engines vs ``repro``.

``build_flat_index`` field for field against JAX's numpy build (dtypes
included) at pad_to 32 and 128, sorted or not, on a corpus, a vocabulary
with empty terms, one doc and an empty vocabulary; ``score_segment`` bit
for bit on ``_torch_parity.dyadic`` weights (every f32 sum exact) and
within rtol 1e-6 otherwise; ``score_bcoo`` (a ``torch.sparse`` product)
within rtol 1e-6, bit for bit on dyadic weights; both engines through
``RetrievalEngine.search`` against the JAX engines, top-k tie-aware
(``_torch_parity.assert_same_topk``); the segment loop's launch count;
and ``make_serve_step`` refusing both, as JAX's does.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import assert_same_topk, dyadic, port_batch
from repro.core import engine as jeng
from repro.core import index as jidx
from repro.core import scoring as jscoring
from repro.core.sparse import SparseBatch as JBatch
from repro.data.synthetic import make_msmarco_like
from repro_torch.core import engine as teng
from repro_torch.core import index as tidx
from repro_torch.core import scoring as tscoring
from repro_torch.core.distributed import make_serve_step

RTOL = 1e-6


def _corpus(seed, docs=300, queries=8, vocab=700):
    return make_msmarco_like(num_docs=docs, num_queries=queries,
                             vocab_size=vocab, seed=seed)


def _docs(case):
    if case == "corpus":
        return _corpus(3).docs
    if case == "empty-terms":
        # ids on the even terms of [0, 400) only: half the vocabulary has
        # no posting, so runs of zero-length lists share an offset
        docs = _corpus(5, docs=120, vocab=200).docs
        ids = np.asarray(docs.term_ids)
        return JBatch(jnp.asarray(np.where(ids >= 0, 2 * ids, -1)),
                      docs.values, 400)
    if case == "one-doc":
        return _corpus(6, docs=1, queries=1, vocab=300).docs
    # an empty vocabulary: two docs, all padding
    return JBatch(jnp.full((2, 1), -1, jnp.int32),
                  jnp.zeros((2, 1), jnp.float32), 0)


@pytest.mark.parametrize("case", ["corpus", "empty-terms", "one-doc",
                                  "empty-vocab"])
@pytest.mark.parametrize("sort_postings", [True, False])
@pytest.mark.parametrize("pad_to", [32, 128])
def test_build_flat_index_matches_jax(case, sort_postings, pad_to):
    docs = _docs(case)
    ref = jidx.build_flat_index(docs, pad_to=pad_to,
                                sort_postings=sort_postings)
    got = tidx.build_flat_index(port_batch(docs), pad_to=pad_to,
                                sort_postings=sort_postings)
    for name in tidx.FLAT_ARRAY_FIELDS:
        a, b = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    for name in ("num_docs", "vocab_size", "pad_to", "total_postings",
                 "total_padded", "padding_overhead"):
        assert getattr(got, name) == getattr(ref, name), name
    assert got.memory_bytes() == ref.memory_bytes()
    assert got.total_padded >= pad_to and got.total_padded % pad_to == 0


@pytest.mark.parametrize("seed,pad_to", [(0, 128), (1, 32), (2, 7)])
def test_score_segment_matches_jax(seed, pad_to):
    c = _corpus(seed)
    for exact, (q, d) in ((True, (dyadic(c.queries), dyadic(c.docs))),
                          (False, (c.queries, c.docs))):
        want = np.asarray(jscoring.score_segment(
            q, jidx.build_flat_index(d, pad_to=pad_to)))
        got = tscoring.score_segment(
            port_batch(q), tidx.build_flat_index(port_batch(d),
                                                 pad_to=pad_to)).numpy()
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_bcoo_matches_jax(seed):
    c = _corpus(seed)
    want = np.asarray(jscoring.score_bcoo(c.queries, c.docs))
    got = tscoring.score_bcoo(port_batch(c.queries), port_batch(c.docs))
    assert got.shape == want.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    q, d = dyadic(c.queries), dyadic(c.docs)
    np.testing.assert_array_equal(
        tscoring.score_bcoo(port_batch(q), port_batch(d)).numpy(),
        np.asarray(jscoring.score_bcoo(q, d)))


def test_segment_launches_one_a_valid_query_term():
    c = _corpus(4)
    q = port_batch(c.queries)
    index = tidx.build_flat_index(port_batch(c.docs))
    tscoring.segment_launches = 0
    tscoring.score_segment(q, index)
    assert tscoring.segment_launches == int((q.term_ids >= 0).sum()) > 0
    # a query row of padding only launches nothing and scores 0
    empty = q.slice_rows(0, 1)
    empty.term_ids[:] = -1
    tscoring.segment_launches = 0
    assert not tscoring.score_segment(empty, index).any()
    assert tscoring.segment_launches == 0


@pytest.mark.parametrize("engine", ["bcoo", "segment"])
@pytest.mark.parametrize("k", [10, 300])
def test_engines_search_like_jax(engine, k):
    c = _corpus(8, docs=257, queries=7, vocab=600)
    oracle = jscoring.score_dense_f64(c.queries, c.docs)
    cfg = dict(engine=engine, k=k, query_chunk=3)
    port = teng.RetrievalEngine(port_batch(c.docs),
                                teng.RetrievalConfig(**cfg), device="cpu")
    ref = jeng.RetrievalEngine(c.docs, jeng.RetrievalConfig(**cfg))
    assert_same_topk(port.search(port_batch(c.queries)),
                     ref.search(c.queries), oracle)
    assert port.index_bytes() == ref.index_bytes()
    assert port.padding_overhead() == ref.padding_overhead()
    assert (port._flat is None) == (engine == "bcoo")
    assert port._tiled is None and port._ell is None


@pytest.mark.parametrize("engine", ["bcoo", "segment"])
def test_make_serve_step_refuses_the_comparison_engines(engine):
    with pytest.raises(ValueError, match="serveable engines"):
        make_serve_step(engine=engine, k=5, docs_per_shard=8)
