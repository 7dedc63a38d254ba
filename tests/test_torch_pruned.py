"""The port's pruned path vs the JAX package, on the CPU.

Bounds, the top-k helpers of the sweep, ``reorder_docs``, the topical
corpus's laws, and every pruned engine end to end: ``search`` (top-k,
``return_tau``), ``prune_stats``, ``delete_docs``, ``evaluate`` and
``stream_search``.  Both packages get the same numpy corpus (JAX's
``make_topical_corpus``), reordered by ``df-signature`` so that pruning
really happens.  ``tiled-bmp-fused`` is held against JAX's
``tiled-bmp-grouped``: the reference fused Pallas kernel does not trace on
this JAX, and by contract the two engines return the same top-k, tau and
stats.  Tolerances: rtol 1e-5 / atol 1e-6 on f32 values, top-k ids
compared tie-aware (``_torch_parity.assert_same_topk``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import ATOL, RTOL, assert_same_topk, port_batch
from repro.core import engine as jeng
from repro.core import index as jidx
from repro.core import scoring as jscoring
from repro.core import topk as jtopk
from repro.data import synthetic as jsyn
from repro_torch.core import engine as teng
from repro_torch.core import index as tidx
from repro_torch.core import scoring as tscoring
from repro_torch.core import topk as ttopk
from repro_torch.data import synthetic as tsyn

GEOM = dict(term_block=256, doc_block=16, chunk_size=32,
            reorder_docs=True, reorder_method="df-signature")
# (port config, JAX config) overrides; the fused engine's reference is the
# grouped one.
ENGINES = {
    "bmp": (dict(engine="tiled-pruned"),) * 2,
    "two-pass": (dict(engine="tiled-pruned", traversal="two-pass"),) * 2,
    "bmp-csr": (dict(engine="tiled-pruned", bounds_format="csr"),) * 2,
    "approx": (dict(engine="tiled-pruned-approx", theta=0.8),) * 2,
    "grouped": (dict(engine="tiled-bmp-grouped"),) * 2,
    "fused": (dict(engine="tiled-bmp-fused"),
              dict(engine="tiled-bmp-grouped")),
}


@pytest.fixture(scope="module")
def corpus():
    c = jsyn.make_topical_corpus(1001, 6, vocab_size=1500, num_topics=6,
                                 topic_vocab=150, seed=5)
    oracle = jscoring.score_dense_f64(c.queries, c.docs)
    return c, oracle


def _pair(c, name, k):
    pcfg, jcfg = ENGINES[name]
    return (teng.RetrievalEngine(port_batch(c.docs), teng.RetrievalConfig(
                k=k, **GEOM, **pcfg), device="cpu"),
            jeng.RetrievalEngine(c.docs, jeng.RetrievalConfig(
                k=k, **GEOM, **jcfg)))


def _stats(st):
    return dataclasses.asdict(st)


@pytest.mark.parametrize("fmt", ["dense", "csr"])
def test_block_upper_bounds_match_jax(corpus, fmt):
    c, oracle = corpus
    j = jidx.build_tiled_index(c.docs, term_block=256, doc_block=16,
                               chunk_size=32, store_term_block_max=True,
                               bounds_format=fmt)
    t = tidx.build_tiled_index(port_batch(c.docs), 256, 16, 32,
                               store_term_block_max=True, bounds_format=fmt)
    q = port_batch(c.queries)
    got = tscoring.block_upper_bounds(q, t)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jscoring.block_upper_bounds(c.queries, j)),
        rtol=RTOL, atol=ATOL)
    if fmt == "csr":  # the device scatter gives the dense gather's entries
        d = tidx.build_tiled_index(port_batch(c.docs), 256, 16, 32,
                                   store_term_block_max=True)
        assert torch.equal(got, tscoring.block_upper_bounds(q, d))
    # Bounds dominate every true score in their block.
    n_db = t.num_doc_blocks
    pad = np.full((oracle.shape[0], n_db * 16 - oracle.shape[1]), -np.inf)
    block_max = np.concatenate([oracle, pad], 1).reshape(-1, n_db, 16).max(2)
    assert np.all(got.numpy() >= block_max - 1e-5)
    coarse = tidx.build_tiled_index(port_batch(c.docs), 256, 16, 32)
    assert torch.all(tscoring.block_upper_bounds(q, coarse) >= got - 1e-5)


def test_threshold_helpers_match_jax():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 4, size=(3, 40)).astype(np.float32)
    x[:, ::5] = -np.inf
    heap = np.sort(rng.normal(size=(3, 6)).astype(np.float32))[:, ::-1]
    heap = np.ascontiguousarray(heap)
    heap[1, 3:] = -np.inf
    for k in (1, 7, 40):
        np.testing.assert_array_equal(
            ttopk.partial_topk_threshold(torch.from_numpy(x), k).numpy(),
            np.asarray(jtopk.partial_topk_threshold(jnp.asarray(x), k)))
    for k in (None, 4):
        for p, r in zip(
                ttopk.update_topk_heap(torch.from_numpy(heap),
                                       torch.from_numpy(x[:, :9]), k),
                jtopk.update_topk_heap(jnp.asarray(heap),
                                       jnp.asarray(x[:, :9]), k)):
            np.testing.assert_array_equal(p.numpy(), np.asarray(r))


@pytest.mark.parametrize("method", ["none", "signature", "df-signature"])
def test_reorder_docs_permutation_matches_jax(corpus, method):
    c, _ = corpus
    jdocs, jperm = jidx.reorder_docs(c.docs, method=method)
    tdocs, tperm = tidx.reorder_docs(port_batch(c.docs), method=method)
    np.testing.assert_array_equal(tperm.numpy(), jperm)
    np.testing.assert_array_equal(tdocs.term_ids.numpy(),
                                  np.asarray(jdocs.term_ids))
    with pytest.raises(ValueError):
        tidx.reorder_docs(port_batch(c.docs), method="bisection")


def test_topical_corpus_has_the_reference_laws():
    """Same laws, other numbers: moments within a few percent."""
    t = tsyn.make_topical_corpus(4000, 200, vocab_size=3000, device="cpu")
    j = jsyn.make_topical_corpus(4000, 200, vocab_size=3000)
    shared = max(int(3000 * 0.03), 16)

    def stats(ids, vals):
        live = ids >= 0
        head = live & (ids < shared)
        return np.array([live.sum(1).mean(), live.sum(1).std(),
                         head.sum() / live.sum(), vals[head].mean(),
                         vals[live & ~head].mean()])

    got = stats(t.docs.term_ids.numpy(), t.docs.values.numpy())
    want = stats(np.asarray(j.docs.term_ids), np.asarray(j.docs.values))
    np.testing.assert_allclose(got, want, rtol=0.05)
    q_len = (t.queries.term_ids >= 0).sum(1).float().mean().item()
    assert 38 <= q_len <= 40
    assert len(t.qrels) == 200


@pytest.mark.parametrize("name", list(ENGINES))
def test_search_tau_stats_and_deletes_match_jax(corpus, name):
    c, oracle = corpus
    port, ref = _pair(c, name, k=5)
    q = port_batch(c.queries)
    pv, pi, pt = port.search(q, return_tau=True)
    rv, ri, rt = ref.search(c.queries, return_tau=True)
    assert_same_topk((pv, pi), (rv, ri), oracle)
    np.testing.assert_allclose(pt, rt, rtol=RTOL, atol=ATOL)
    assert _stats(port.prune_stats(q)) == _stats(ref.prune_stats(c.queries))
    assert port.padding_overhead() == pytest.approx(ref.padding_overhead())
    doomed = np.array([0, 3, 17, 500, 1000])
    assert port.delete_docs(doomed) == ref.delete_docs(doomed) == 5
    pv, pi = port.search(q, k=8)
    rv, ri = ref.search(c.queries, k=8)
    assert_same_topk((pv, pi), (rv, ri), oracle, deleted=port.deleted_mask)
    assert _stats(port.prune_stats(q, k=8)) == _stats(
        ref.prune_stats(c.queries, k=8))


def test_warm_tau_search_equals_cold(corpus):
    c, oracle = corpus
    port, _ = _pair(c, "fused", k=5)
    q = port_batch(c.queries)
    v, i, tau = port.search(q, return_tau=True)
    v2, i2, tau2 = port.search(q, tau_init=tau * 0.9, return_tau=True)
    np.testing.assert_array_equal(i, i2)
    np.testing.assert_array_equal(tau, tau2)
    two = teng.RetrievalEngine(port_batch(c.docs), teng.RetrievalConfig(
        k=5, engine="tiled-pruned", traversal="two-pass", **GEOM),
        device="cpu")
    with pytest.raises(ValueError, match="traversal"):
        two.search(q, tau_init=tau)


@pytest.mark.parametrize("name", ["bmp", "fused"])
def test_stream_search_warm_equals_cold(corpus, name):
    c, oracle = corpus
    cuts = [(0, 400), (400, 400), (800, 201)]
    pcfg = teng.RetrievalConfig(k=5, **GEOM, **ENGINES[name][0])
    pv, pi, pt = teng.stream_search(
        [port_batch(c.docs.slice_rows(s, n)) for s, n in cuts],
        port_batch(c.queries), pcfg, device="cpu")
    exact = teng.RetrievalEngine(port_batch(c.docs), teng.RetrievalConfig(
        k=5, engine="tiled", term_block=256, doc_block=16, chunk_size=32),
        device="cpu").search(port_batch(c.queries), return_tau=True)
    assert_same_topk((pv, pi), exact[:2], oracle)
    np.testing.assert_allclose(pt, exact[2], rtol=RTOL, atol=ATOL)


def test_evaluate_reports_recall_vs_exact_for_theta(corpus):
    c, _ = corpus
    port, ref = _pair(c, "approx", k=5)
    got = port.evaluate(port_batch(c.queries), c.qrels, k=5)
    want = ref.evaluate(c.queries, c.qrels, k=5)
    assert set(got) == set(want) and "recall_vs_exact@5" in got
    for key in want:
        assert got[key] == pytest.approx(want[key])
