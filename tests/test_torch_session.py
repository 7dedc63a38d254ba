"""The port's ``Retriever`` and ``SearchSession`` vs ``repro.core.session``,
on the CPU.

The checks of ``tests/test_session.py``, each run through both packages on
the same corpus: aligned growth equals one cold engine, a warm session
(score only the new segments from the cached tau, merge) equals a cold
one, rebuilds and k changes run cold, the LRU bound evicts the same
streams, duplicate stream ids, the errors, ``prune_stats``,
``bounds_memory`` and ``evaluate``.  The corpus's weights are dyadic
(``_torch_parity.dyadic``), so the packages agree bit for bit: values,
ids and every cached tau (an ``np.float32``).  ``tiled-bmp-fused`` is
held against JAX's ``tiled-bmp-grouped`` (the JAX fused kernel does not
trace on this JAX; by contract both return the same top-k and tau).
"""
import numpy as np
import pytest
import torch

from _torch_parity import dyadic, port_batch
from repro.core import RetrievalConfig as JConfig
from repro.core import Retriever as JRetriever
from repro.data.synthetic import make_msmarco_like
from repro_torch.core import RetrievalConfig, RetrievalEngine, Retriever
from repro_torch.core.sparse import SparseBatch

DB = 16
BASE = dict(k=10, term_block=128, doc_block=DB, chunk_size=32)
PRUNED = ("tiled-pruned", "tiled-bmp-grouped", "tiled-bmp-fused")
JAX_NAME = {"tiled-bmp-fused": "tiled-bmp-grouped"}


@pytest.fixture(scope="module")
def corpus():
    c = make_msmarco_like(num_docs=192, num_queries=6, vocab_size=600,
                          seed=31)
    return dyadic(c.docs), dyadic(c.queries), c.qrels


def _cfgs(engine, **kw):
    return (RetrievalConfig(engine=engine, **{**BASE, **kw}),
            JConfig(engine=JAX_NAME.get(engine, engine), **{**BASE, **kw}))


def _pair(engine, docs, **kw):
    """(port Retriever, JAX Retriever) over the same first segment."""
    pc, jc = _cfgs(engine, **kw)
    return (Retriever(port_batch(docs), pc, device="cpu"),
            JRetriever(docs, jc))


def _rows(batch, rows):
    import jax.numpy as jnp
    from repro.core.sparse import SparseBatch as JBatch

    r = np.asarray(rows)
    return JBatch(jnp.asarray(np.asarray(batch.term_ids)[r]),
                  jnp.asarray(np.asarray(batch.values)[r]), batch.vocab_size)


def _same(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype or a.dtype.kind == b.dtype.kind
        np.testing.assert_array_equal(a, b)


def _cold(docs, queries, engine, k=10, **kw):
    pc, _ = _cfgs(engine, **kw)
    return RetrievalEngine(port_batch(docs), pc, device="cpu").search(
        port_batch(queries), k=k)


@pytest.mark.parametrize("engine", ("tiled", "ell") + PRUNED)
def test_grown_equals_cold_and_jax(corpus, engine):
    """Aligned ``add_docs`` growth == one cold engine over everything, and
    == the JAX Retriever grown the same way (values, ids, tau)."""
    docs, queries, _ = corpus
    port, ref = _pair(engine, docs.slice_rows(0, 64))
    for s, n in ((64, 96), (160, 32)):
        assert port.add_docs(port_batch(docs.slice_rows(s, n))) == \
            ref.add_docs(docs.slice_rows(s, n))
    assert (port.version, port.num_docs) == (ref.version, ref.num_docs)
    pv, pi = port.search(port_batch(queries))
    _same((pv, pi), _cold(docs, queries, engine))
    _same((pv, pi), ref.search(queries))
    if engine in PRUNED:
        _same(port.search(port_batch(queries), return_tau=True),
              ref.search(queries, return_tau=True))
    assert port.index_bytes() > 0


def test_unaligned_growth_matches_jax(corpus):
    docs, queries, _ = corpus
    port, ref = _pair("tiled-pruned", docs.slice_rows(0, 100))
    port.add_docs(port_batch(docs.slice_rows(100, 92)))
    ref.add_docs(docs.slice_rows(100, 92))
    _same(port.search(port_batch(queries), return_tau=True),
          ref.search(queries, return_tau=True))
    _same(port.search(port_batch(queries)), _cold(docs, queries,
                                                  "tiled-pruned"))


@pytest.mark.parametrize("engine", PRUNED)
def test_session_warm_equals_cold_with_jax_tau(corpus, engine):
    """search -> add_docs -> search scores only the new segment, returns
    the cold result, and caches JAX's tau, bit for bit."""
    docs, queries, _ = corpus
    port, ref = _pair(engine, docs.slice_rows(0, 96))
    ps, rs = port.open_session(k=10), ref.open_session(k=10)
    _same(ps.search(port_batch(queries)), rs.search(queries))
    before = [ps.cached_tau(q) for q in range(queries.batch)]
    assert before == [rs.cached_tau(q) for q in range(queries.batch)]
    for q in range(queries.batch):
        assert ps._cache[q].tau.dtype == np.float32
        assert ps._cache[q].tau.tobytes() == rs._cache[q].tau.tobytes()
    port.add_docs(port_batch(docs.slice_rows(96, 96)))
    ref.add_docs(docs.slice_rows(96, 96))
    got = ps.search(port_batch(queries))
    _same(got, _cold(docs, queries, engine))
    _same(got, rs.search(queries))
    after = [ps.cached_tau(q) for q in range(queries.batch)]
    assert after == [rs.cached_tau(q) for q in range(queries.batch)]
    assert all(a >= b for a, b in zip(after, before))  # appends raise tau
    _same(ps.search(port_batch(queries)), got)  # pure cache hit
    assert len(ps) == queries.batch


def test_session_mixed_warm_and_cold_streams(corpus):
    docs, queries, _ = corpus
    port = Retriever(port_batch(docs.slice_rows(0, 64)),
                     _cfgs("tiled-pruned")[0], device="cpu")
    ps = port.open_session(k=10)
    ps.search(port_batch(_rows(queries, [0, 1, 2])), query_ids=[0, 1, 2])
    port.add_docs(port_batch(docs.slice_rows(64, 128)))
    got = ps.search(port_batch(queries), query_ids=list(range(
        queries.batch)))
    _same(got, _cold(docs, queries, "tiled-pruned"))


def test_session_rebuild_and_k_change(corpus):
    docs, queries, _ = corpus
    port, ref = _pair("tiled-pruned", docs)
    ps, rs = port.open_session(k=10), ref.open_session(k=10)
    ps.search(port_batch(queries))
    rs.search(queries)
    _same(ps.search(port_batch(queries), k=7), _cold(docs, queries,
                                                     "tiled-pruned", k=7))
    port.rebuild(port_batch(docs.slice_rows(0, 64)))
    ref.rebuild(docs.slice_rows(0, 64))
    assert (port.epoch, port.version) == (ref.epoch, ref.version) == (1, 1)
    assert ps.cached_tau(0) is None and rs.cached_tau(0) is None
    got = ps.search(port_batch(queries))
    _same(got, rs.search(queries))
    _same(got, _cold(docs.slice_rows(0, 64), queries, "tiled-pruned"))


def test_session_duplicate_query_ids(corpus):
    """Duplicate ids with identical rows are one stream: the warm repeat
    after add_docs equals a cold session's; differing rows raise."""
    docs, queries, _ = corpus
    dup = port_batch(_rows(queries, [0, 1, 0]))
    port = Retriever(port_batch(docs.slice_rows(0, 96)),
                     _cfgs("tiled-pruned")[0], device="cpu")
    ps = port.open_session()
    dv, di = ps.search(dup, query_ids=["a", "b", "a"])
    np.testing.assert_array_equal(di[0], di[2])
    np.testing.assert_array_equal(dv[0], dv[2])
    port.add_docs(port_batch(docs.slice_rows(96, 96)))
    warm = ps.search(dup, query_ids=["a", "b", "a"])
    cold = Retriever(port_batch(docs), port.config, device="cpu")
    _same(warm, cold.open_session().search(dup, query_ids=["a", "b", "a"]))
    with pytest.raises(ValueError, match="duplicate query_id"):
        ps.search(port_batch(queries),
                  query_ids=["a", "a"] + list(range(queries.batch - 2)))


def test_session_and_retriever_errors(corpus):
    docs, queries, _ = corpus
    empty = Retriever(config=_cfgs("tiled-pruned")[0], device="cpu")
    for fn in (lambda: empty.search(port_batch(queries)),
               lambda: empty.open_session().search(port_batch(queries))):
        with pytest.raises(ValueError, match="no documents"):
            fn()
    r = Retriever(port_batch(docs), _cfgs("tiled-pruned")[0], device="cpu")
    with pytest.raises(ValueError, match="query_ids"):
        r.open_session().search(port_batch(queries), query_ids=[1, 2])
    with pytest.raises(ValueError, match="max_entries"):
        r.open_session(max_entries=0)
    bad = SparseBatch(torch.full((2, 3), -1, dtype=torch.int32),
                      torch.zeros((2, 3)), docs.vocab_size + 1)
    with pytest.raises(ValueError, match="vocab"):
        r.add_docs(bad)
    assert r.add_docs(port_batch(docs.slice_rows(0, 0))) == r.version
    tau = np.zeros(queries.batch, np.float32)
    with pytest.raises(ValueError, match="only meaningful"):
        Retriever(port_batch(docs), _cfgs("tiled")[0], device="cpu").search(
            port_batch(queries), tau_init=tau)
    with pytest.raises(ValueError, match="warm-start"):
        Retriever(port_batch(docs), _cfgs("tiled-pruned",
                                          traversal="two-pass")[0],
                  device="cpu").search(port_batch(queries), tau_init=tau)


def test_k_beyond_corpus(corpus):
    docs, queries, _ = corpus
    port = Retriever(port_batch(docs.slice_rows(0, 32)),
                     _cfgs("tiled-pruned")[0], device="cpu")
    ps = port.open_session(k=500)
    v, _ = ps.search(port_batch(queries))
    assert v.shape == (queries.batch, 32)
    port.add_docs(port_batch(docs.slice_rows(32, 160)))
    _same(ps.search(port_batch(queries)),
          _cold(docs, queries, "tiled-pruned", k=500))


def test_prune_stats_bounds_memory_and_evaluate(corpus):
    docs, queries, qrels = corpus
    port, ref = _pair("tiled-pruned", docs.slice_rows(0, 96))
    port.add_docs(port_batch(docs.slice_rows(96, 96)))
    ref.add_docs(docs.slice_rows(96, 96))
    pst = port.prune_stats(port_batch(queries), k=10)
    rst = ref.prune_stats(queries, k=10)
    for f in ("num_doc_blocks", "blocks_seeded", "blocks_scored",
              "chunks_total", "chunks_scored", "sweep_steps", "theta"):
        assert getattr(pst, f) == getattr(rst, f), f
    assert pst.num_doc_blocks == 192 // DB
    pbm, rbm = port.bounds_memory(), ref.bounds_memory()
    assert {k: pbm[k] for k in ("format", "stored", "dense", "csr")} == \
        {k: rbm[k] for k in ("format", "stored", "dense", "csr")}
    assert pbm["mapped_bytes"] == 0 and pbm["device_bytes"] > 0
    assert Retriever(port_batch(docs), _cfgs("tiled")[0],
                     device="cpu").prune_stats(port_batch(queries)) is None
    approx, japprox = _pair("tiled-pruned-approx", docs, theta=0.7)
    got = approx.evaluate(port_batch(queries), qrels, k=10)
    assert "recall_vs_exact@10" in got
    assert got == japprox.evaluate(queries, qrels, k=10)


def test_csr_bounds_session_matches_dense(corpus):
    docs, queries, _ = corpus
    out = []
    for fmt in ("dense", "csr"):
        r = Retriever(port_batch(docs.slice_rows(0, 96)),
                      _cfgs("tiled-pruned", bounds_format=fmt)[0],
                      device="cpu")
        r.add_docs(port_batch(docs.slice_rows(96, 96)))
        out.append(r.open_session().search(port_batch(queries)))
    _same(out[0], out[1])


@pytest.mark.parametrize("max_entries", [2, 4])
def test_session_lru_matches_jax(corpus, max_entries):
    """The bound holds, the same streams are evicted as in JAX, and an
    evicted stream's next search cold-starts to the unbounded result."""
    docs, queries, _ = corpus
    port, ref = _pair("tiled-pruned", docs.slice_rows(0, 96))
    ps = port.open_session(k=10, max_entries=max_entries)
    rs = ref.open_session(k=10, max_entries=max_entries)
    unbounded = port.open_session(k=10)
    ps.search(port_batch(queries))
    rs.search(queries)
    unbounded.search(port_batch(queries))
    assert len(ps) == len(rs) == max_entries
    assert ps.evictions == rs.evictions == queries.batch - max_entries
    cached = [ps.cached_tau(q) is not None for q in range(queries.batch)]
    assert cached == [rs.cached_tau(q) is not None
                      for q in range(queries.batch)]
    assert cached == [q >= queries.batch - max_entries
                      for q in range(queries.batch)]
    port.add_docs(port_batch(docs.slice_rows(96, 96)))
    ref.add_docs(docs.slice_rows(96, 96))
    got = ps.search(port_batch(queries))
    _same(got, unbounded.search(port_batch(queries)))
    _same(got, rs.search(queries))
    _same(got, _cold(docs, queries, "tiled-pruned"))


def test_session_lru_recency_order(corpus):
    """Re-searching a stream refreshes its slot: the least recent other
    stream is evicted."""
    docs, queries, _ = corpus
    r = Retriever(port_batch(docs), _cfgs("tiled-pruned")[0], device="cpu")
    s = r.open_session(k=10, max_entries=2)
    for qid, row in (("a", 0), ("b", 1), ("a", 0), ("c", 2)):
        s.search(port_batch(_rows(queries, [row])), query_ids=[qid])
    assert s.cached_tau("a") is not None
    assert s.cached_tau("b") is None
    assert s.cached_tau("c") is not None


def test_default_device_raises_without_cuda(corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    docs, _, _ = corpus
    with pytest.raises(RuntimeError, match="cuda"):
        Retriever(port_batch(docs), _cfgs("tiled")[0])
