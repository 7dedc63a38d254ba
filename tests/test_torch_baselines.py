"""The port's CPU baselines vs ``repro.core.wand`` / ``repro.core.seismic``.

The checks of ``tests/test_wand_baselines.py`` on the port, plus equality
with the JAX package's: ``CpuPostings`` and ``SeismicIndex`` builds equal
JAX's (postings, maxima, block maxima, blocks and summaries, dtypes
included); WAND and BMW (``theta`` 1 and an over-pruning 1.5), the
exhaustive oracle and Seismic at each ``query_cut`` give JAX's ids and
values exactly (the same Python float arithmetic on the same f32 inputs).
WAND and BMW are exact against the exhaustive oracle, Seismic is
approximate and cut-monotone, and the port's engines, run on the CPU,
return WAND's top-k.
"""
import numpy as np
import pytest

from _torch_parity import port_batch
from repro.core import seismic as jseismic
from repro.core import wand as jwand
from repro.core.metrics import ranking_overlap
from repro.data.synthetic import make_msmarco_like
from repro_torch.core import seismic as tseismic
from repro_torch.core import wand as twand
from repro_torch.core.engine import RetrievalConfig, RetrievalEngine

K = 10


@pytest.fixture(scope="module")
def setup():
    c = make_msmarco_like(num_docs=350, num_queries=10, vocab_size=700,
                          seed=7)
    cp = twand.CpuPostings.build(port_batch(c.docs))
    ev, ei = twand.exhaustive_topk_cpu(port_batch(c.queries), cp, K)
    return c, cp, ev, ei


def _same(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("block_size", [64, 16])
def test_cpu_postings_match_jax(setup, block_size):
    c = setup[0]
    got = twand.CpuPostings.build(port_batch(c.docs), block_size=block_size)
    want = jwand.CpuPostings.build(c.docs, block_size=block_size)
    assert (got.num_docs, got.block_size) == (want.num_docs, want.block_size)
    assert got.postings.keys() == want.postings.keys()
    assert got.max_score == want.max_score
    for t in want.postings:
        _same(got.postings[t], want.postings[t])
        _same((got.block_max[t],), (want.block_max[t],))


@pytest.mark.parametrize("block_size", [128, 32])
def test_seismic_index_matches_jax(setup, block_size):
    c = setup[0]
    got = tseismic.SeismicIndex.build(port_batch(c.docs),
                                      block_size=block_size)
    want = jseismic.SeismicIndex.build(c.docs, block_size=block_size)
    assert (got.num_docs, got.block_size) == (want.num_docs,
                                              want.block_size)
    assert got.blocks.keys() == want.blocks.keys()
    for t, blocks in want.blocks.items():
        assert len(got.blocks[t]) == len(blocks)
        for (gd, gv, gs), (wd, wv, ws) in zip(got.blocks[t], blocks):
            _same((gd, gv), (wd, wv))
            assert gs == ws


def test_exhaustive_matches_jax(setup):
    c, _, ev, ei = setup
    want = jwand.exhaustive_topk_cpu(
        c.queries, jwand.CpuPostings.build(c.docs), K)
    _same((ev, ei), want)


@pytest.mark.parametrize("theta", [1.0, 1.5])
@pytest.mark.parametrize("block_max", [False, True])
def test_wand_matches_jax(setup, block_max, theta):
    c, cp, _, _ = setup
    got = twand.wand_topk_cpu(port_batch(c.queries), cp, K,
                              block_max=block_max, theta=theta)
    want = jwand.wand_topk_cpu(c.queries, jwand.CpuPostings.build(c.docs),
                               K, block_max=block_max, theta=theta)
    _same(got, want)


@pytest.mark.parametrize("block_max", [False, True])
def test_wand_exact(setup, block_max):
    c, cp, ev, ei = setup
    wv, wi = twand.wand_topk_cpu(port_batch(c.queries), cp, K,
                                 block_max=block_max)
    np.testing.assert_allclose(np.sort(wv, axis=1), np.sort(ev, axis=1),
                               atol=1e-9)


@pytest.mark.parametrize("seed", [20, 21, 22])
def test_wand_exact_multiple_seeds(seed):
    c = make_msmarco_like(200, 6, vocab_size=400, seed=seed)
    q = port_batch(c.queries)
    cp = twand.CpuPostings.build(port_batch(c.docs))
    ev, _ = twand.exhaustive_topk_cpu(q, cp, 5)
    bv, bi = twand.wand_topk_cpu(q, cp, 5, block_max=True)
    np.testing.assert_allclose(np.sort(bv, 1), np.sort(ev, 1), atol=1e-9)
    _same((bv, bi), jwand.wand_topk_cpu(
        c.queries, jwand.CpuPostings.build(c.docs), 5, block_max=True))


@pytest.mark.parametrize("cut", [5, 10, 50])
def test_seismic_matches_jax(setup, cut):
    c = setup[0]
    got = tseismic.seismic_topk_cpu(
        port_batch(c.queries), tseismic.SeismicIndex.build(port_batch(c.docs)),
        K, query_cut=cut)
    want = jseismic.seismic_topk_cpu(
        c.queries, jseismic.SeismicIndex.build(c.docs), K, query_cut=cut)
    _same(got, want)


def test_seismic_is_approximate_and_cut_monotone(setup):
    """The paper's Seismic comparison: query_cut trades recall for speed."""
    c, _, _, ei = setup
    si = tseismic.SeismicIndex.build(port_batch(c.docs))
    q = port_batch(c.queries)
    ov = [ranking_overlap(tseismic.seismic_topk_cpu(q, si, K,
                                                    query_cut=cut)[1], ei, K)
          for cut in (5, 10, 50)]
    assert ov[0] <= ov[1] + 1e-9 and ov[1] <= ov[2] + 1e-9
    assert ov[0] < 0.999  # genuinely approximate


@pytest.mark.parametrize("engine", ["dense", "bcoo", "segment", "tiled",
                                    "ell"])
def test_port_engines_match_wand_topk(setup, engine):
    """Cross-system agreement: the port's engines (plain versions on the
    CPU) return WAND's top-k."""
    c, cp, _, _ = setup
    wv, wi = twand.wand_topk_cpu(port_batch(c.queries), cp, K)
    eng = RetrievalEngine(
        port_batch(c.docs),
        RetrievalConfig(engine=engine, k=K, doc_block=64, term_block=256,
                        chunk_size=128), device="cpu")
    v, i = eng.search(port_batch(c.queries), k=K)
    np.testing.assert_allclose(v, wv, rtol=1e-5, atol=1e-6)
    assert ranking_overlap(i, wi, K) > 0.99
