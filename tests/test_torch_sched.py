"""The port's demand planner (``repro_torch.sched.planner``) vs JAX's.

The planner is numpy in both packages, with the same tie rules, so every
output must be equal: signatures, groups, forecasts, the padded and
bucketed group rows, ``PAD_TAU``, the errors, and the plan cache's hits.
The bounds come from a reordered topical corpus (where groups form), plus
random rows with zero and negative bounds.
"""
import numpy as np
import pytest
import torch

from _torch_parity import port_batch
from repro.core import index as jidx
from repro.core import scoring as jscoring
from repro.data.synthetic import make_topical_corpus
from repro.sched import planner as jplan
from repro_torch.core import engine as teng
from repro_torch.core import scoring as tscoring
from repro_torch.sched import planner as tplan


@pytest.fixture(scope="module")
def bounds():
    c = make_topical_corpus(1200, 24, vocab_size=1800, num_topics=6,
                            topic_vocab=150, seed=9)
    docs, _ = jidx.reorder_docs(c.docs, method="df-signature")
    j = jidx.build_tiled_index(docs, term_block=256, doc_block=16,
                               chunk_size=32, store_term_block_max=True)
    ub = np.asarray(jscoring.block_upper_bounds(c.queries, j))
    rng = np.random.default_rng(0)
    noisy = rng.normal(size=(12, ub.shape[1])).astype(np.float32)
    noisy[3] = 0.0  # no positive bound
    noisy[5] = -np.abs(noisy[5])
    return c, ub, noisy, np.asarray(j.block_chunk_count)


def _same_plan(a, b):
    assert a.group_sizes == b.group_sizes
    for x, y in zip(a.groups, b.groups):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.signatures, b.signatures):
        np.testing.assert_array_equal(x, y)
    assert (a.est_chunks_flat, a.est_chunks_grouped) == (
        b.est_chunks_flat, b.est_chunks_grouped)
    assert a.est_reduction == b.est_reduction


@pytest.mark.parametrize("top_m,max_group,min_share", [
    (8, None, 0.5), (4, 3, 0.2), (1, None, 1.0), (16, 2, 0.0),
])
def test_plans_equal(bounds, top_m, max_group, min_share):
    _, ub, noisy, cost = bounds
    for u in (ub, noisy):
        kw = dict(top_m=top_m, max_group=max_group, min_share=min_share)
        _same_plan(tplan.plan_micro_batches(u, cost, **kw),
                   jplan.plan_micro_batches(u, cost, **kw))
    plan = tplan.plan_micro_batches(ub, cost)
    assert 1 < plan.num_groups < ub.shape[0]  # groups really form


def test_padded_and_bucketed_rows_equal(bounds):
    _, ub, _, cost = bounds
    groups = tplan.plan_micro_batches(ub, cost, top_m=4).groups
    tau0 = np.linspace(-1, 1, ub.shape[0]).astype(np.float32)
    assert tplan.PAD_TAU == jplan.PAD_TAU
    for a, b in zip(tplan.padded_group_rows(groups, tau0),
                    jplan.padded_group_rows(groups, tau0)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    ta = list(tplan.bucketed_group_rows(groups, tau0))
    ja = list(jplan.bucketed_group_rows(groups, tau0))
    assert [(s, [(gi, g.tolist()) for gi, g in e]) for s, e, _, _ in ta] == \
        [(s, [(gi, g.tolist()) for gi, g in e]) for s, e, _, _ in ja]
    for (_, _, s1, t1), (_, _, s2, t2) in zip(ta, ja):
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(t1, t2)


@pytest.mark.parametrize("call", [
    lambda p: p.plan_micro_batches(np.zeros(5), np.ones(5)),
    lambda p: p.plan_micro_batches(np.zeros((2, 5)), np.ones(4)),
    lambda p: p.plan_micro_batches(np.zeros((2, 5)), np.ones(5), max_group=0),
    lambda p: p.plan_micro_batches(np.zeros((2, 5)), np.ones(5),
                                   min_share=2.0),
    lambda p: p.validate_groups([[0, 1], [1]], 3),
    lambda p: p.validate_groups([[0, 1], [2], []], 3),
    lambda p: p.validate_groups([[0, 3]], 2),
    lambda p: p.PlanCache(max_entries=0),
])
def test_bad_inputs_rejected_alike(call):
    for mod in (jplan, tplan):
        with pytest.raises(ValueError):
            call(mod)


def test_plan_cache_hits_and_eviction_alike(bounds):
    _, ub, noisy, cost = bounds
    for mod in (tplan, jplan):
        cache = mod.PlanCache(max_entries=2)
        for key, u in (("a", ub), ("a", ub), ("b", noisy), ("c", ub),
                       ("a", ub)):
            cache.get_or_plan(key, lambda u=u: mod.plan_micro_batches(
                u, cost))
        cache.set_epoch(1, owner="r")
        cache.set_epoch(1, owner="r")
        assert (cache.plans_computed, cache.hits, cache.evictions,
                len(cache)) == (4, 1, 2, 2)
        cache.set_epoch(2, owner="r")
        assert len(cache) == 0


@pytest.mark.parametrize("engine", ["tiled-bmp-grouped", "tiled-bmp-fused"])
def test_repeated_stream_plans_once(bounds, engine):
    c, _, _, _ = bounds
    cache = tplan.PlanCache()
    cfg = teng.RetrievalConfig(engine=engine, k=5, term_block=256,
                               doc_block=16, chunk_size=32,
                               reorder_docs=True,
                               reorder_method="df-signature",
                               plan_cache=cache)
    eng = teng.RetrievalEngine(port_batch(c.docs), cfg, device="cpu")
    q = port_batch(c.queries)
    first = eng.search(q)
    for _ in range(2):
        again = eng.search(q)
        np.testing.assert_array_equal(first[1], again[1])
    assert (cache.plans_computed, cache.hits) == (1, 2)
    # The engine planned what the planner gives for its bounds (whose
    # plans equal JAX's: test_plans_equal).
    idx = eng._index
    _same_plan(next(iter(cache._plans.values())), tplan.plan_micro_batches(
        tscoring.block_upper_bounds(q, idx).numpy(),
        idx.block_chunk_count.numpy()))
    # The same query batch on another index plans anew.
    other = teng.RetrievalEngine(port_batch(c.docs), cfg, device="cpu")
    other.search(q)
    assert cache.plans_computed == 2


def test_stream_key_reads_tensors(bounds):
    c, _, _, _ = bounds
    q = port_batch(c.queries)
    idx = object.__new__(type("Ix", (), {}))
    a = tplan.PlanCache.stream_key(q, idx, extra=(1,))
    b = tplan.PlanCache.stream_key(
        type(q)(q.term_ids.clone(), q.values.clone(), q.vocab_size), idx,
        extra=(1,))
    assert a == b
    q.values[0, 0] += 1.0
    assert tplan.PlanCache.stream_key(q, idx, extra=(1,)) != a
    assert isinstance(q.term_ids, torch.Tensor)
