"""repro_torch RetrievalEngine vs repro's, engine by engine, on the CPU.

Both packages search the same numpy corpus (``repro.data.synthetic``).
Top-k values must be allclose (rtol 1e-5, atol 1e-6: f32 sums in another
order) and ids equal, compared tie-aware (``_torch_parity.
assert_same_topk``).
"""
import numpy as np
import pytest

from _torch_parity import RTOL, ATOL, assert_same_topk, port_batch
from repro.core import engine as jeng
from repro.core import scoring as jscoring
from repro.data.synthetic import make_msmarco_like
from repro_torch.core import engine as teng

GEOM = dict(term_block=128, doc_block=32, chunk_size=64)
ENGINES = [("dense", {}), ("tiled", {}), ("tiled", {"tile_skip": True}),
           ("ell", {}), ("bcoo", {}), ("segment", {})]
IDS = ["dense", "tiled", "tiled-tile_skip", "ell", "bcoo", "segment"]


@pytest.fixture(scope="module")
def corpus():
    c = make_msmarco_like(257, 7, vocab_size=600, seed=21)
    oracle = jscoring.score_dense_f64(c.queries, c.docs)  # [B, N] float64
    return c, oracle


def _pair(c, engine, extra, **kw):
    cfg = dict(engine=engine, **GEOM, **extra, **kw)
    return (teng.RetrievalEngine(port_batch(c.docs), teng.RetrievalConfig(**cfg),
                                 device="cpu"),
            jeng.RetrievalEngine(c.docs, jeng.RetrievalConfig(**cfg)))


@pytest.mark.parametrize("engine,extra", ENGINES, ids=IDS)
def test_search_in_query_chunks(corpus, engine, extra):
    c, oracle = corpus
    port, ref = _pair(c, engine, extra, query_chunk=3, k=20)
    assert_same_topk(port.search(port_batch(c.queries)), ref.search(c.queries),
                     oracle)


@pytest.mark.parametrize("engine", ["tiled", "ell", "tiled-pruned"])
def test_search_frees_each_chunk_and_keeps_its_bits(corpus, engine):
    """Query chunks of 1, 3 and the whole batch (each chunk's scores freed
    before the next is scored) give the same values and ids, bit for bit,
    and JAX's search."""
    c, oracle = corpus
    got = [_pair(c, engine, {}, query_chunk=qc, k=20)[0].search(
        port_batch(c.queries)) for qc in (1, 3, c.queries.batch)]
    for other in got[1:]:
        for a, b in zip(other, got[0]):
            np.testing.assert_array_equal(a, b)
    ref = _pair(c, engine, {}, k=20)[1]
    assert_same_topk(got[0], ref.search(c.queries), oracle)


@pytest.mark.parametrize("engine,extra", ENGINES, ids=IDS)
def test_k_larger_than_num_docs_and_tau(corpus, engine, extra):
    c, oracle = corpus
    port, ref = _pair(c, engine, extra)
    pv, pi, pt = port.search(port_batch(c.queries), k=400, return_tau=True)
    rv, ri, rt = ref.search(c.queries, k=400, return_tau=True)
    assert pv.shape == (7, 257)
    assert_same_topk((pv, pi), (rv, ri), oracle)
    np.testing.assert_array_equal(pt, rt)  # fewer than k docs: -inf
    pv, pi, pt = port.search(port_batch(c.queries), k=10, return_tau=True)
    rv, ri, rt = ref.search(c.queries, k=10, return_tau=True)
    assert_same_topk((pv, pi), (rv, ri), oracle)
    np.testing.assert_allclose(pt, rt, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="tau_init"):
        port.search(port_batch(c.queries), k=10, tau_init=pt)


@pytest.mark.parametrize("engine,extra", ENGINES, ids=IDS)
def test_delete_docs(corpus, engine, extra):
    c, oracle = corpus
    port, ref = _pair(c, engine, extra)
    doomed = np.array([0, 5, 17, 31, 32, 100, 256])
    assert port.delete_docs(doomed) == ref.delete_docs(doomed) == 7
    assert port.delete_docs([5]) == 0
    assert port.num_alive == ref.num_alive == 250
    for k in (15, 253):  # 253 > alive: the tail is -inf, id -1
        assert_same_topk(port.search(port_batch(c.queries), k=k),
                         ref.search(c.queries, k=k), oracle,
                         deleted=port.deleted_mask)
    with pytest.raises(ValueError, match="doc ids"):
        port.delete_docs([257])


@pytest.mark.parametrize("engine,extra", ENGINES, ids=IDS)
def test_stream_search(corpus, engine, extra):
    c, oracle = corpus
    cuts = [(0, 100), (100, 100), (200, 57)]
    cfg = dict(engine=engine, k=12, **GEOM, **extra)
    pv, pi, pt = teng.stream_search(
        [port_batch(c.docs.slice_rows(s, n)) for s, n in cuts], port_batch(c.queries),
        teng.RetrievalConfig(**cfg), device="cpu",
    )
    rv, ri, rt = jeng.stream_search(
        [c.docs.slice_rows(s, n) for s, n in cuts], c.queries,
        jeng.RetrievalConfig(**cfg),
    )
    assert_same_topk((pv, pi), (rv, ri), oracle)
    np.testing.assert_allclose(pt, rt, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("engine", ["tiled", "ell"])
def test_search_in_bounded_ranges_matches_jax(corpus, engine, monkeypatch):
    """The bounded steps of the serve path forced small — the index build a
    doc block a step, ``chunk_doc_bounds`` a chunk a step, the ELL fill a
    few rows a step and the top-k's tie repair a row or two a step — give
    the one-step search's bits and JAX's search (slabs of 64)."""
    from repro_torch.core import index as tidx
    from repro_torch.core import topk as ttopk
    from repro_torch.kernels.scatter_score import ops as scatter_ops

    c, oracle = corpus
    port, ref = _pair(c, engine, {}, k=40, topk_block=64)
    want = port.search(port_batch(c.queries))
    monkeypatch.setattr(tidx, "_TILED_ROW_ELEMS", 1)
    monkeypatch.setattr(tidx, "_ELL_ROW_ELEMS", 3 * c.docs.term_ids.shape[1])
    monkeypatch.setattr(scatter_ops, "_BOUNDS_ELEMS", 1)
    monkeypatch.setattr(ttopk, "_TIE_ELEMS", 2 * 257)
    port, _ = _pair(c, engine, {}, k=40, topk_block=64)
    got = port.search(port_batch(c.queries))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert_same_topk(got, ref.search(c.queries), oracle)


def test_evaluate_index_bytes_and_from_prebuilt(corpus):
    c, _ = corpus
    port, ref = _pair(c, "tiled", {})
    assert port.evaluate(port_batch(c.queries), c.qrels, k=50) == pytest.approx(
        ref.evaluate(c.queries, c.qrels, k=50))
    assert port.index_bytes() == ref.index_bytes()
    deleted = np.zeros(257, bool)
    deleted[3] = True
    again = teng.RetrievalEngine.from_prebuilt(
        port_batch(c.docs), port.config, port._index, deleted=deleted,
        device="cpu",
    )
    v, i = again.search(port_batch(c.queries), k=5)
    assert not np.any(i == 3)


def test_config_validation_matches_jax():
    for bad in (dict(k=0), dict(query_chunk=0), dict(engine="nope"),
                dict(theta=0.5),  # theta on an exact engine
                dict(engine="tiled-pruned-approx", theta=0.0),
                dict(engine="tiled-bmp-grouped", traversal="two-pass"),
                dict(engine="tiled-pruned", bounds_format="coo"),
                dict(engine="tiled-bmp-fused", sched_top_m=0),
                dict(engine="tiled-bmp-fused", sched_max_group=0),
                dict(engine="tiled-bmp-grouped", sched_min_share=1.5)):
        with pytest.raises(ValueError):
            jeng.RetrievalConfig(**bad)
        with pytest.raises(ValueError):
            teng.RetrievalConfig(**bad)
    # The JAX knob that nothing in the port reads is not a field of its
    # config: setting it fails instead of being ignored.
    jax_fields = jeng.RetrievalConfig.__dataclass_fields__
    assert "use_f32_scores" in jax_fields
    with pytest.raises(TypeError):
        teng.RetrievalConfig(use_f32_scores=True)
    # pad_to is read by the segment engine's FlatIndex: JAX's default, and
    # a segment engine built at another pad holds JAX's index and results.
    assert teng.RetrievalConfig().pad_to == jax_fields["pad_to"].default
    c = make_msmarco_like(64, 3, vocab_size=200, seed=4)
    port, ref = _pair(c, "segment", {}, pad_to=32, k=8)
    assert port._flat.pad_to == ref._flat.pad_to == 32
    np.testing.assert_array_equal(port._flat.doc_ids.numpy(),
                                  np.asarray(ref._flat.doc_ids))
    assert port.index_bytes() == ref.index_bytes()
    assert port.padding_overhead() == ref.padding_overhead()
    assert_same_topk(port.search(port_batch(c.queries)),
                     ref.search(c.queries),
                     jscoring.score_dense_f64(c.queries, c.docs))
    # obs is one, as in JAX: an enabled Obs by default, serving state
    # outside equality and repr.
    from repro_torch.obs import Obs
    port_obs = teng.RetrievalConfig.__dataclass_fields__["obs"]
    assert isinstance(teng.RetrievalConfig().obs, Obs)
    assert teng.RetrievalConfig(obs=None).obs is None
    for attr in ("compare", "repr"):
        assert getattr(port_obs, attr) is getattr(jax_fields["obs"], attr)
        assert getattr(port_obs, attr) is False
