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
from repro_torch.core.sparse import SparseBatch
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


@pytest.mark.parametrize("fmt", ["dense", "csr"])
@pytest.mark.parametrize("deleted", [False, True])
def test_two_pass_with_bounds_in_ranges_matches_one_shot_and_jax(
        fmt, deleted, monkeypatch):
    """The two-pass engine with its bound rows built a few doc blocks at a
    time (``_BOUND_ROW_ELEMS`` lowered to one and to three blocks a range
    at B = 6; the three-block ranges through the emulated FMA, forced by
    ``_EXACT_SUM_RATIO`` 0): the bounds and the term seeds bit for bit the one-shot
    ``einsum`` and ``argmax`` over the whole [B, K, n_db] rows and JAX's
    bounds; the scores (their ``-inf`` too) and ``PruneStats`` bit for bit
    the one-range call; and against JAX's ``score_tiled_pruned``: the same
    ``-inf`` positions, scores within rtol 1e-5 / atol 1e-6, equal stats,
    the same top-k (tie-aware) and tau within the same tolerance (the f32
    scores sum in another order); with and without deleted docs."""
    # Short queries over a small-vocabulary topical corpus: some blocks
    # seed tau, some are swept in pass 2, the rest are skipped.
    c = jsyn.make_topical_corpus(2001, 6, vocab_size=1500, num_topics=6,
                                 topic_vocab=150, seed=5, query_terms=8)
    k = 8
    jdocs, _ = jidx.reorder_docs(c.docs, method="df-signature")
    oracle = jscoring.score_dense_f64(c.queries, jdocs)
    kw = dict(term_block=256, doc_block=16, chunk_size=32,
              store_term_block_max=True)
    j = jidx.build_tiled_index(jdocs, bounds_format=fmt, **kw)
    t = tidx.build_tiled_index(port_batch(jdocs), bounds_format=fmt, **kw)
    dense = tidx.build_tiled_index(port_batch(jdocs), **kw)
    q = port_batch(c.queries)
    mask = None
    if deleted:
        mask = np.zeros(jdocs.batch, bool)
        mask[[0, 3, 17, 500, 1000, 2000]] = True

    ids = q.term_ids.clamp(min=0).long()
    rows = dense.term_block_max_q[ids].float()
    w = torch.where(q.term_ids >= 0, q.values.abs(), 0.0) * \
        dense.term_block_scale[ids]
    one_ub = torch.einsum("bkd,bk->bd", rows, w)
    one_seeds = (w[..., None] * rows).argmax(dim=-1)
    np.testing.assert_array_equal(
        one_ub.numpy(), np.asarray(jscoring.block_upper_bounds(c.queries, j)))
    one = tscoring.score_tiled_pruned(q, t, k, return_stats=True,
                                      deleted_mask=mask)
    st = one[1]
    assert 0 < st.blocks_seeded < st.blocks_scored < st.num_doc_blocks
    for blocks, ratio in ((1, tscoring._EXACT_SUM_RATIO), (3, 0.0)):
        # ratio 0: the emulated FMA, forced
        monkeypatch.setattr(tscoring, "_BOUND_ROW_ELEMS", blocks * q.batch)
        monkeypatch.setattr(tscoring, "_EXACT_SUM_RATIO", ratio)
        ub, seeds = tscoring._fine_bounds(q, t, seeds=True)
        assert torch.equal(ub, one_ub) and torch.equal(seeds, one_seeds)
        assert torch.equal(tscoring.block_upper_bounds(q, t), one_ub)
        out, st = tscoring.score_tiled_pruned(q, t, k, return_stats=True,
                                              deleted_mask=mask)
        assert torch.equal(out, one[0]) and st == one[1]

    jout, jst = jscoring.score_tiled_pruned(c.queries, j, k,
                                            return_stats=True,
                                            deleted_mask=mask)
    assert _stats(one[1]) == _stats(jst)
    got, want = one[0].numpy(), np.asarray(jout)
    skipped = np.isneginf(want)
    np.testing.assert_array_equal(np.isneginf(got), skipped)
    np.testing.assert_allclose(got[~skipped], want[~skipped], rtol=RTOL,
                               atol=ATOL)
    pv, pi = ttopk.topk(one[0], k)
    rv, ri = jtopk.topk_two_stage(jnp.asarray(want), k)
    pv, pi, rv, ri = (np.asarray(x) for x in (pv, pi, rv, ri))
    scores = np.asarray(oracle)
    if deleted:
        scores = np.where(mask[None, :], -np.inf, scores)
    assert_same_topk((pv, np.where(np.isfinite(pv), pi, -1)),
                     (rv, np.where(np.isfinite(rv), ri, -1)), scores)
    np.testing.assert_allclose(pv[:, -1], rv[:, -1], rtol=RTOL,
                               atol=ATOL)  # tau


def test_fine_bounds_sum_in_one_pass_only_where_exact(monkeypatch):
    """A query whose weights span more than ``_EXACT_SUM_RATIO`` takes the
    emulated FMA: bounds 1 (weight 1) and 205 (weight 5,237,765 x 2^-54)
    in one doc block sum to 1 + 2^-23, the FMA's rounding of 1 + 2^-24 +
    2^-54, where one float64 sum rounded to f32 gives 1 (the one-pass
    step, forced, shows it); a query of close weights sums in one pass,
    the emulated FMA's bits."""
    def index(bound, scale):
        z = torch.zeros((1, 1), dtype=torch.int32)
        return tidx.TiledIndex(
            local_term=z, local_doc=z, value=torch.zeros((1, 1)),
            chunk_term_block=z[0], chunk_doc_block=z[0], chunk_first=None,
            tile_max=None, block_max=None, num_docs=16, vocab_size=2,
            term_block=2, doc_block=16, chunk_size=1,
            term_block_max_q=torch.tensor([[1], [bound]], dtype=torch.uint8),
            term_block_scale=torch.tensor([1.0, scale]))

    q = SparseBatch(torch.tensor([[0, 1]], dtype=torch.int32),
                    torch.tensor([[1.0, 1.0]]), 2)
    far, near = index(205, 5237765 * 2.0 ** -54), index(205, 0.3)
    assert tscoring._fine_bounds(q, far)[0].item() == 1 + 2.0 ** -23
    assert tscoring._fine_bounds(q, near)[0].item() == np.float32(
        1.0 + 205 * np.float64(np.float32(0.3)))
    monkeypatch.setattr(tscoring, "_EXACT_SUM_RATIO", float("inf"))
    assert tscoring._fine_bounds(q, far)[0].item() == 1.0


def test_fma_nonneg_rounds_once():
    """``scoring._fma_nonneg`` is ``a * b + c`` rounded once to f32, held
    to exact rational arithmetic on random nonnegative f32 triples over a
    wide exponent range and on a double-rounding case: 205 x (5,237,765 x
    2^-54) + 1 = 1 + 2^-24 + 2^-54, just above the midpoint between 1 and
    1 + 2^-23, which a float64 sum rounds to the midpoint and then to 1."""
    from fractions import Fraction

    rng = np.random.default_rng(3)
    n = 4000
    a = rng.integers(0, 256, n).astype(np.float32)
    b = (rng.random(n) * 2.0 ** rng.integers(-40, 10, n)).astype(np.float32)
    c = (rng.random(n) * 2.0 ** rng.integers(-40, 20, n)).astype(np.float32)
    a[0], b[0], c[0] = 205.0, np.float32(5237765 * 2.0 ** -54), 1.0
    got = tscoring._fma_nonneg(torch.from_numpy(a), torch.from_numpy(b),
                               torch.from_numpy(c)).numpy()
    assert got[0] == np.float32(1 + 2.0 ** -23)
    assert np.float32(np.float64(c[0]) + np.float64(a[0]) * b[0]) == 1.0
    for x, y, z, g in zip(a.tolist(), b.tolist(), c.tolist(), got.tolist()):
        exact = Fraction(x) * Fraction(y) + Fraction(z)
        lo = np.float32(float(exact))  # the nearest f64, then f32
        cands = {lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(0))}
        best = min(cands, key=lambda f: (abs(Fraction(float(f)) - exact),
                                         int(np.float32(f).view(np.int32))
                                         & 1))
        assert g == best, (x, y, z, g, best)


@pytest.fixture(scope="module")
def table11():
    """Table 11's regime at a CPU size: B = 64, k = 100 over 3,001 topical
    docs reordered by ``df-signature`` (an msmarco-like corpus this small
    matches fewer than k docs for some queries, whose tau then stays 0 and
    whose sweep never retires), both packages over one build (the port's
    carried field for field), doc blocks of 16."""
    from _torch_parity import carry_tiled

    c = jsyn.make_topical_corpus(3001, 64, vocab_size=1500, num_topics=6,
                                 topic_vocab=150, seed=5)
    docs, _ = jidx.reorder_docs(c.docs, method="df-signature")
    j = jidx.build_tiled_index(docs, term_block=256, doc_block=16,
                               chunk_size=64, store_term_block_max=True)
    oracle = np.asarray(jscoring.score_dense_f64(c.queries, docs))
    return c, j, carry_tiled(j), oracle


def _topk_of(scores, k):
    v, i = ttopk.topk(torch.from_numpy(np.array(scores)), k)
    v, i = v.numpy(), i.numpy()
    return v, np.where(np.isfinite(v), i, -1)


def _sched(st):
    return (st.group_sizes, st.padded_group_sizes,
            st.blocks_scored_per_group, st.chunks_scored_per_group,
            st.blocks_scored_union, st.chunks_scored_union, st.sweep_steps)


@pytest.mark.parametrize("engine,theta", [
    ("bmp", 1.0), ("bmp", 0.8), ("grouped", 1.0), ("fused", 1.0)])
def test_bmp_traversals_at_table11_regime_match_jax(table11, engine, theta):
    """The BMP traversals at B = 64, k = 100 against JAX's:
    ``score_tiled_bmp`` at theta 1.0 and 0.8 against JAX's (the same
    ``-inf`` positions, scores within rtol 1e-5 / atol 1e-6, the top-100
    tie-aware, tau within the same tolerance, equal ``PruneStats``);
    ``score_tiled_bmp_grouped`` and the fused ``bmp_scan`` against JAX's
    grouped engine (the same demand groups, per-group fetch counts and
    steps; JAX's fused Pallas kernel does not trace on this JAX)."""
    from repro_torch.kernels.bmp_scan import ops as bmp_ops

    c, j, t, oracle = table11
    q, k = port_batch(c.queries), 100
    if engine == "bmp":
        out, st, tau = tscoring.score_tiled_bmp(
            q, t, k, theta=theta, return_stats=True, return_tau=True)
        jout, jst, jtau = jscoring.score_tiled_bmp(
            c.queries, j, k, theta=theta, return_stats=True, return_tau=True)
        assert _stats(st) == _stats(jst)
        assert st.sweep_steps < st.num_doc_blocks  # every row retires
    else:
        fn = (tscoring.score_tiled_bmp_grouped if engine == "grouped"
              else bmp_ops.bmp_scan)
        out, st, tau = fn(q, t, k, return_stats=True, return_tau=True)
        jout, jst, jtau = jscoring.score_tiled_bmp_grouped(
            c.queries, j, k, return_stats=True, return_tau=True)
        assert _sched(st) == _sched(jst)
        assert _stats(st.union) == _stats(jst.union)
        assert 1 < st.num_groups  # the planner really splits the batch
    got, want = out.numpy(), np.asarray(jout)
    skipped = np.isneginf(want)
    np.testing.assert_array_equal(np.isneginf(got), skipped)
    np.testing.assert_allclose(got[~skipped], want[~skipped], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tau.numpy(), np.asarray(jtau), rtol=RTOL,
                               atol=ATOL)
    pv, pi = _topk_of(out, k)
    rv, ri = _topk_of(jout, k)
    if theta == 1.0:
        assert_same_topk((pv, pi), (rv, ri), oracle)
    else:  # bounded recall: the same docs as JAX's sweep, not the exact ones
        np.testing.assert_allclose(pv, rv, rtol=RTOL, atol=ATOL)
