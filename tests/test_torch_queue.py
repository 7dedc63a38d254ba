"""The port's ``QueryScheduler`` and ``RequestQueue`` vs ``repro.sched.queue``,
on the CPU.

The scheduler cases of ``tests/test_sched.py`` (bounded admission, EDF
with FIFO ties, the arrival mirror, assembly triggers, a late request
served in the next micro-batch, never dropped, results equal to direct
``Retriever.search`` over warm streams and index growth, the session
bound, the plan cache's hits and its epoch invalidation, two schedulers
sharing one cache, ``run_async``), and runs of both schedulers under one
fake clock that must give the same micro-batches, results, stamps and
lateness.  The weights are dyadic (``_torch_parity.dyadic``), so results
agree bit for bit; the JAX side runs ``tiled-bmp-grouped`` where the port
runs ``tiled-bmp-fused`` (the JAX fused kernel does not trace here).
"""
import asyncio

import numpy as np
import pytest
import torch

from _torch_parity import dyadic, port_batch
from repro.core.engine import RetrievalConfig as JConfig
from repro.core.session import Retriever as JRetriever
from repro.data.synthetic import make_msmarco_like
from repro.sched import QueryScheduler as JScheduler
from repro_torch.core.engine import RetrievalConfig
from repro_torch.core.session import Retriever
from repro_torch.sched import (
    QueueFull, QueryScheduler, Request, RequestQueue,
)

K = 10
GEOM = dict(k=K, term_block=128, doc_block=16, chunk_size=32)
JAX_NAME = {"tiled-bmp-fused": "tiled-bmp-grouped"}


@pytest.fixture(scope="module")
def corpus():
    c = make_msmarco_like(num_docs=257, num_queries=8, vocab_size=803,
                          seed=3)
    return dyadic(c.docs), dyadic(c.queries)


def _retriever(docs, engine="tiled-bmp-grouped"):
    return Retriever(port_batch(docs), RetrievalConfig(engine=engine,
                                                       **GEOM), device="cpu")


def _sched(r, **kw):
    return QueryScheduler(r, k=K, device="cpu", **kw)


def _rows(queries):
    return np.asarray(queries.term_ids), np.asarray(queries.values)


# -- the queue ----------------------------------------------------------------

def test_queue_bounded_admission_and_malformed_requests():
    q = RequestQueue(capacity=2)
    q.submit(Request(0, np.array([1]), np.array([1.0])))
    assert q.submit(Request(1, np.array([1]), np.array([1.0]))) == 2
    with pytest.raises(QueueFull, match="capacity"):
        q.submit(Request(2, np.array([1]), np.array([1.0])))
    with pytest.raises(ValueError, match="capacity"):
        RequestQueue(capacity=0)
    for ids, vals in (([1, 2, 3], [1.0]), ([1], [1.0, 2.0])):
        with pytest.raises(ValueError, match="one weight per term"):
            Request(0, np.array(ids), np.array(vals))


def test_queue_pops_earliest_deadline_first():
    q = RequestQueue(capacity=8)
    for qid, dl in ((0, 5.0), (1, 1.0), (2, 3.0), (3, 1.0)):
        q.submit(Request(qid, np.array([1]), np.array([1.0]), deadline=dl))
    assert [r.query_id for r in q.pop_batch(3)] == [1, 3, 2]
    assert [r.query_id for r in q.pop_batch(3)] == [0]


@pytest.mark.parametrize("seed", [0, 1])
def test_queue_arrival_mirror_tracks_and_stays_bounded(seed):
    rng = np.random.default_rng(seed)
    q = RequestQueue(capacity=16)
    live = []
    for step in range(400):
        if live and (rng.random() < 0.5 or len(live) >= 16):
            for r in q.pop_batch(int(rng.integers(1, 4))):
                live.remove(r)
        else:
            r = Request(step, np.array([1]), np.array([1.0]),
                        deadline=float(rng.random()),
                        arrival=float(rng.random()))
            q.submit(r)
            live.append(r)
        assert q.oldest_arrival == min((r.arrival for r in live),
                                       default=None)
        assert len(q._arrivals) <= 2 * max(len(live), 8) + 16
    while q.pop_batch(4):
        pass
    assert q.oldest_arrival is None and len(q._arrivals) == 0


# -- the scheduler against JAX's under one fake clock ------------------------

@pytest.mark.parametrize("engine", ["tiled-bmp-grouped", "tiled-bmp-fused"])
def test_fake_clock_runs_match_jax(corpus, engine):
    """Staggered arrivals and deadlines, a micro-batch of 3, ``step`` at
    fixed instants: the same EDF batches, results, stamps and lateness
    as the JAX scheduler, and the same counters in the obs snapshot."""
    docs, queries = corpus
    qi, qv = _rows(queries)
    port = _sched(_retriever(docs, engine), capacity=16, max_batch=3,
                  max_delay=2.0, clock=lambda: 0.0)
    ref = JScheduler(JRetriever(docs, JConfig(
        engine=JAX_NAME.get(engine, engine), **GEOM)), k=K, capacity=16,
        max_batch=3, max_delay=2.0, clock=lambda: 0.0)
    rng = np.random.default_rng(4)
    subs = [(i % 8, float(t), float(t + d)) for i, (t, d) in enumerate(
        zip(np.sort(rng.uniform(0, 6, 12)), rng.uniform(0.5, 4, 12)))]
    got, want = [], []
    now, nxt = 0.0, 0
    while nxt < len(subs) or len(port.queue):
        while nxt < len(subs) and subs[nxt][1] <= now:
            qid, t, dl = subs[nxt]
            for s in (port, ref):
                s.submit(f"s{qid}", qi[qid], qv[qid], deadline=dl, now=t)
            nxt += 1
        assert port.ready(now) == ref.ready(now)
        got.append(port.step(now=now))
        want.append(ref.step(now=now))
        now += 0.75
    assert [[x.query_id for x in b] for b in got] == \
        [[x.query_id for x in b] for b in want]
    assert any(len(b) > 1 for b in got) and any(x.late for b in got
                                                for x in b)
    for b, c in zip(got, want):
        for x, y in zip(b, c):
            np.testing.assert_array_equal(x.values, y.values)
            np.testing.assert_array_equal(x.ids, y.ids)
            assert (x.late, x.arrival, x.dispatched_at, x.served_at,
                    x.queue_wait, x.latency) == (
                y.late, y.arrival, y.dispatched_at, y.served_at,
                y.queue_wait, y.latency)
    assert port.served == ref.served == len(subs)
    ps, rs = port.obs_snapshot(), ref.obs_snapshot()
    for name in ("sched.requests_total", "sched.batches_total",
                 "sched.deadline_miss_total"):
        assert ps.counters[name] == rs.counters[name], name
    for name in ("sched.queue_wait_s", "sched.e2e_latency_s",
                 "sched.batch_size"):
        assert ps.histograms[name]["buckets"] == \
            rs.histograms[name]["buckets"], name
    for name in ("sched.served_total", "session.cache.entries",
                 "plan.cache.computed", "plan.cache.hits"):
        assert ps.gauges[name] == rs.gauges[name], name


def test_late_request_falls_to_next_batch_never_dropped(corpus):
    docs, queries = corpus
    qi, qv = _rows(queries)
    clock = [0.0]
    sched = _sched(_retriever(docs), capacity=8, max_batch=2,
                   max_delay=10.0, clock=lambda: clock[0])
    for i in range(3):
        sched.submit(i, qi[i], qv[i], deadline=0.0, now=0.0)
    assert [x.query_id for x in sched.step(now=1.0)] == [0, 1]
    assert len(sched.queue) == 1
    second = sched.step(now=2.0)
    assert [x.query_id for x in second] == [2] and second[0].late
    assert sched.served == 3


def test_scheduler_assembly_triggers(corpus):
    docs, queries = corpus
    qi, qv = _rows(queries)
    sched = _sched(_retriever(docs), capacity=8, max_batch=2,
                   max_delay=5.0, clock=lambda: 0.0)
    assert not sched.ready(now=0.0)
    sched.submit(0, qi[0], qv[0], deadline=100.0, now=0.0)
    assert not sched.ready(now=1.0)
    assert sched.step(now=1.0) == []
    assert sched.ready(now=6.0)
    sched.submit(1, qi[1], qv[1], deadline=100.0, now=0.0)
    assert sched.ready(now=1.0)
    assert len(sched.step(now=1.0)) == 2


@pytest.mark.parametrize("engine", ["tiled-bmp-grouped", "tiled-bmp-fused"])
def test_scheduler_equals_direct_search_with_warm_streams(corpus, engine):
    docs, queries = corpus
    qi, qv = _rows(queries)
    r = _retriever(docs.slice_rows(0, 240), engine)
    sched = _sched(r, capacity=32, max_batch=4, clock=lambda: 0.0)
    b = queries.batch
    for i in range(b):
        sched.submit(i, qi[i], qv[i])
    sched.drain()
    assert sched.session.cached_tau(0) is not None
    r.add_docs(port_batch(docs.slice_rows(240, 16)))
    for i in range(b):
        sched.submit(i, qi[i], qv[i])
    results = {x.query_id: x for x in sched.drain()}
    dv, di = r.search(port_batch(queries), k=K)
    for i in range(b):
        np.testing.assert_array_equal(results[i].values, dv[i])
        np.testing.assert_array_equal(results[i].ids, di[i])


def test_scheduler_respects_session_cache_bound(corpus):
    docs, queries = corpus
    qi, qv = _rows(queries)
    sched = _sched(_retriever(docs), capacity=32, max_batch=4,
                   max_entries=2, clock=lambda: 0.0)
    for i in range(queries.batch):
        sched.submit(i, qi[i], qv[i])
    sched.drain()
    assert len(sched.session) <= 2


def _drain_stream(sched, queries, base_id, now=0.0):
    qi, qv = _rows(queries)
    for i in range(queries.batch):
        sched.submit(base_id + i, qi[i], qv[i], now=now)
    return sched.drain(now=now)


@pytest.mark.parametrize("engine", ["tiled-bmp-grouped", "tiled-bmp-fused"])
def test_repeated_stream_plans_exactly_once(corpus, engine):
    docs, queries = corpus
    sched = _sched(_retriever(docs, engine), max_batch=queries.batch,
                   clock=lambda: 0.0)
    first = _drain_stream(sched, queries, 0)
    assert (sched.plan_cache.plans_computed, sched.plan_cache.hits) == (1, 0)
    second = _drain_stream(sched, queries, 1000)
    assert (sched.plan_cache.plans_computed, sched.plan_cache.hits) == (1, 1)
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a.values, b.values)
        np.testing.assert_array_equal(a.ids, b.ids)
    _drain_stream(sched, queries, 1000)  # same stream ids: session cache
    assert (sched.plan_cache.plans_computed, sched.plan_cache.hits) == (1, 1)


def test_plan_cache_invalidated_on_epoch_bump_and_shared(corpus):
    docs, queries = corpus
    r = _retriever(docs)
    sched = _sched(r, max_batch=queries.batch, clock=lambda: 0.0)
    _drain_stream(sched, queries, 0)
    r.rebuild(port_batch(docs))
    cold = _drain_stream(sched, queries, 2000)
    assert sched.plan_cache.plans_computed == 2
    wv, wi = r.search(port_batch(queries), k=K)
    for res in cold:
        np.testing.assert_array_equal(res.values, wv[res.query_id - 2000])
        np.testing.assert_array_equal(res.ids, wi[res.query_id - 2000])
    # two retrievers sharing one config adopt one cache without thrash
    cfg = RetrievalConfig(engine="tiled-bmp-grouped", **GEOM)
    r1 = Retriever(port_batch(docs), cfg, device="cpu")
    r2 = Retriever(port_batch(docs), cfg, device="cpu")
    r1.rebuild(port_batch(docs))
    s1 = _sched(r1, max_batch=queries.batch, clock=lambda: 0.0)
    s2 = _sched(r2, max_batch=queries.batch, clock=lambda: 0.0)
    assert s1.plan_cache is s2.plan_cache
    for s, base in ((s1, 0), (s2, 100), (s1, 200), (s2, 300)):
        _drain_stream(s, queries, base)
    assert (s1.plan_cache.plans_computed, s1.plan_cache.hits) == (2, 2)
    r2.rebuild(port_batch(docs))
    _drain_stream(s2, queries, 400)
    assert s1.plan_cache.plans_computed == 3


def test_run_async_delivers_batches_and_rejects_hoarding(corpus):
    docs, queries = corpus
    qi, qv = _rows(queries)
    sched = _sched(_retriever(docs), capacity=8, max_batch=2,
                   clock=lambda: 0.0)
    with pytest.raises(ValueError, match="on_batch"):
        asyncio.run(sched.run_async())
    for i in range(3):
        sched.submit(i, qi[i], qv[i], deadline=0.0, now=0.0)
    delivered = []
    assert asyncio.run(sched.run_async(on_batch=delivered.extend,
                                       stop=lambda: True)) == []
    assert sorted(x.query_id for x in delivered) == [0, 1, 2]


def test_scheduler_device_rule(corpus):
    docs, _ = corpus
    r = _retriever(docs)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            QueryScheduler(r)  # the default device needs a card
    with pytest.raises(ValueError, match="device"):
        QueryScheduler(r, device="meta")
