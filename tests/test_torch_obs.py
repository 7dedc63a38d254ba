"""The port's ``obs`` vs ``repro.obs``, on the CPU.

The checks of ``tests/test_obs.py``, through both packages: the same
samples give the same histogram buckets, percentiles, snapshots and
Prometheus text; snapshots of either package load and merge in the
other; spans nest and export to the same dicts and Chrome events; a
queued serve traces the same span names as the JAX serve; obs on and off
give the same bits; ``dump``.  And the port's own ``fence``: one
``torch.cuda.synchronize`` per CUDA device a tree holds tensors on,
nothing for CPU tensors, no swallowed exception.
"""
import json
import math

import numpy as np
import pytest
import torch

from _torch_parity import dyadic, port_batch
from repro import obs as jobs
from repro.core.engine import RetrievalConfig as JConfig
from repro.core.session import Retriever as JRetriever
from repro.data.synthetic import make_msmarco_like
from repro.sched import QueryScheduler as JScheduler
from repro_torch import obs as obs_mod
from repro_torch.core.engine import RetrievalConfig
from repro_torch.core.session import Retriever
from repro_torch.obs import Histogram, MetricsRegistry, Obs, ObsSnapshot
from repro_torch.sched import QueryScheduler

K = 10


def _registries(seed):
    """The same counters, gauges and samples into a port and a JAX
    registry."""
    rng = np.random.default_rng(seed)
    out = []
    for mod in (obs_mod, jobs):
        reg = mod.MetricsRegistry()
        reg.counter("kernel.launches_total").inc(seed + 1)
        reg.gauge("sched.queue_depth").set(10 * seed)
        h = reg.histogram("span.engine.score")
        for x in rng.lognormal(mean=-6.0, sigma=1.5, size=500):
            h.observe(float(x))
        for x in (0.0, -1.0, float("nan"), 1e-9):
            h.observe(x)
        rng = np.random.default_rng(seed)
        out.append(reg)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histograms_snapshots_and_prometheus_equal_jax(seed):
    port, ref = _registries(seed)
    ph = port.histogram("span.engine.score")
    rh = ref.histogram("span.engine.score")
    assert (ph.lo, ph.growth) == (rh.lo, rh.growth) == (1e-7, 2 ** 0.125)
    assert ph.buckets == rh.buckets and -1 in ph.buckets
    for q in (0.0, 50.0, 95.0, 99.0, 100.0):
        assert ph.percentile(q) == rh.percentile(q)
    ps, rs = port.snapshot(), ref.snapshot()
    assert ps.as_dict() == rs.as_dict()
    assert ps.to_prometheus() == rs.to_prometheus()
    # either package's exported snapshot loads and merges in the other
    rt = json.loads(json.dumps(rs.as_dict()))
    assert (ps.merge(ObsSnapshot.from_dict(rt)).as_dict()
            == rs.merge(jobs.ObsSnapshot.from_dict(
                json.loads(json.dumps(ps.as_dict())))).as_dict())
    assert Histogram.from_dict(rt["histograms"]["span.engine.score"]
                               ).buckets == rh.buckets


def test_histogram_percentiles_merge_and_edges():
    rng = np.random.default_rng(7)
    samples = rng.lognormal(mean=-4.0, sigma=2.0, size=1000)
    whole, a, b = Histogram(), Histogram(), Histogram()
    for i, x in enumerate(samples):
        whole.observe(float(x))
        (a if i % 2 else b).observe(float(x))
    a.merge(b)
    assert a.buckets == whole.buckets
    for q in (50.0, 95.0, 99.0):
        assert a.percentile(q) == whole.percentile(q)
        np.testing.assert_allclose(whole.percentile(q),
                                   np.percentile(samples, q),
                                   rtol=whole.growth - 1.0 + 0.01)
    with pytest.raises(ValueError, match="merge"):
        a.merge(Histogram(lo=1e-6))
    assert math.isnan(Histogram().percentile(50.0))


def test_snapshot_merge_associative():
    snaps = [r.snapshot() for r in (_registries(i)[0] for i in range(3))]
    s0, s1, s2 = snaps
    left, right = s0.merge(s1).merge(s2), s0.merge(s1.merge(s2))
    assert left.as_dict() == right.as_dict()
    assert left.as_dict() == ObsSnapshot.merge_all(snaps).as_dict()
    assert left.counters["kernel.launches_total"] == 6
    assert left.gauges["sched.queue_depth"] == 20


def test_span_nesting_and_chrome_export_match_jax():
    trees = []
    for mod in (obs_mod, jobs):
        o = mod.Obs()
        with o.span("root", batch=2):
            with o.span("child.a"):
                pass
            with o.span("child.b"):
                with o.span("leaf"):
                    pass
        o.record_span("queue.wait", 1.0, 2.5, batch=2)
        trees.append(o)
    port, ref = trees
    assert [r.name for r in port.trace_log.roots()] == ["root", "queue.wait"]
    for o in trees:
        assert [s.name for s in o.trace_log.roots()[0].walk()] == [
            "root", "child.a", "child.b", "leaf"]
    events = json.loads(json.dumps(port.trace_log.to_chrome_trace()))
    want = ref.trace_log.to_chrome_trace()
    assert [(e["name"], e["ph"], e["tid"], e["args"]) for e in events] == \
        [(e["name"], e["ph"], e["tid"], e["args"]) for e in want]
    snap = port.snapshot()
    np.testing.assert_allclose(snap.histograms["span.queue.wait"]["sum"],
                               1.5)
    # span dicts cross both ways
    jd = json.loads(json.dumps(ref.trace_log.roots()[0].as_dict()))
    assert [s.name for s in obs_mod.Span.from_dict(jd).walk()] == \
        [s.name for s in jobs.Span.from_dict(
            port.trace_log.roots()[0].as_dict()).walk()]
    with obs_mod.span(None, "anything", k=1) as sp:
        assert sp is None
    with obs_mod.timer(None, "t"):
        pass


def test_fence(monkeypatch):
    """One synchronize per CUDA device of the tree, none for CPU tensors,
    and the synchronize's own error is not swallowed."""

    class OnCard:
        is_cuda = True

        def __init__(self, i):
            self.device = torch.device("cuda", i)

    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    obs_mod.fence({"a": torch.ones(2), "b": [torch.zeros(1), 3, None]})
    assert calls == []
    obs_mod.fence((OnCard(1), {"x": [OnCard(0), OnCard(1)]}, torch.ones(1)))
    assert calls == [torch.device("cuda", 0), torch.device("cuda", 1)]

    def broken(dev):
        raise RuntimeError("device fault")

    monkeypatch.setattr(torch.cuda, "synchronize", broken)
    with pytest.raises(RuntimeError, match="device fault"):
        obs_mod.fence([OnCard(0)])
    assert obs_mod.clock() <= obs_mod.clock()


# -- the serve path ----------------------------------------------------------

@pytest.fixture(scope="module")
def corpus():
    c = make_msmarco_like(num_docs=257, num_queries=8, vocab_size=803,
                          seed=3)
    return dyadic(c.docs), dyadic(c.queries)


GEOM = dict(engine="tiled-bmp-grouped", k=K, term_block=128, doc_block=16,
            chunk_size=32)


def _names(span):
    return [s.name for s in span.walk()]


def test_queued_serve_span_tree_matches_jax(corpus):
    docs, queries = corpus
    qi, qv = np.asarray(queries.term_ids), np.asarray(queries.values)
    port_r = Retriever(port_batch(docs), RetrievalConfig(**GEOM),
                       device="cpu")
    ref_r = JRetriever(docs, JConfig(**GEOM))
    port = QueryScheduler(port_r, capacity=64, max_batch=4, device="cpu")
    ref = JScheduler(ref_r, capacity=64, max_batch=4)
    for s in (port, ref):
        for wave in (1, 2):  # wave 2: cold streams, identical content
            for i in range(4):
                s.submit(f"w{wave}-{i}", qi[i], qv[i])
            s.drain()
    roots = port_r.config.obs.trace_log.roots()
    jroots = ref_r.config.obs.trace_log.roots()
    assert [_names(t) for t in roots] == [_names(t) for t in jroots]
    assert len(roots) == 2 and all(t.name == "serve.step" for t in roots)
    for t in roots:
        for stage in ("queue.wait", "session.search", "segment.search",
                      "engine.score", "plan", "kernel", "cache.write"):
            assert t.find(stage), stage
    assert [p.attrs["cached"] for t in roots for p in t.find("plan")] == \
        [False, True]
    ps, rs = port.obs_snapshot(), ref.obs_snapshot()
    # deadline misses depend on each run's wall clock, not on the package
    miss = "sched.deadline_miss_total"
    assert {k: v for k, v in ps.counters.items() if k != miss} == \
        {k: v for k, v in rs.counters.items() if k != miss}
    assert ps.counters["kernel.launches_total"] > 0
    assert ps.gauges["plan.cache.hits"] == 1
    assert ps.gauges["session.cache.entries"] == 8
    assert set(ps.gauges) == set(rs.gauges)
    assert set(ps.histograms) == set(rs.histograms)
    assert "pager.hits" in ps.gauges


def test_obs_on_off_bit_identical_and_dump(corpus, tmp_path):
    docs, queries = corpus
    q = port_batch(queries)
    on = Retriever(port_batch(docs), RetrievalConfig(**GEOM), device="cpu")
    off = Retriever(port_batch(docs), RetrievalConfig(**GEOM, obs=None),
                    device="cpu")
    assert off.obs_snapshot() is None
    for a, b in zip(on.search(q, k=K, return_tau=True),
                    off.search(q, k=K, return_tau=True)):
        np.testing.assert_array_equal(a, b)
    path = tmp_path / "obs.json"
    payload = obs_mod.dump(on.config.obs, str(path),
                           snapshot=on.obs_snapshot())
    assert json.loads(path.read_text()) == payload
    assert payload["counters"]["kernel.launches_total"] > 0
    assert payload["gauges"]["index.num_docs"] == docs.batch
    assert payload["histograms"]["span.engine.score"]["count"] > 0
    assert all(e["ph"] == "X" for e in payload["chrome_trace"])
    # the dump is a JAX snapshot too
    jobs.ObsSnapshot.from_dict(payload).merge(jobs.ObsSnapshot())
