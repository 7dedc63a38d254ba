"""The port's deletion lifecycle vs ``repro.core.session``, on the CPU.

The checks of ``tests/test_deletions.py`` through both packages:

  (a) ``delete_docs`` + search == a retriever rebuilt over the survivors
      (ids mapped back), for every registered engine, and == JAX's
      tombstoned search;
  (b) a warm session searched after deletions == a cold one, the
      demotion thresholds (``SearchSession._demotion_tau``) are JAX's
      ``np.float32`` values bit for bit, and the demotion counts agree;
  (c) ``compact()`` changes no result, shrinks the chunk universe, and
      leaves the same stats as JAX's compaction.

Three deletion shapes (scattered ids, a whole doc block, a majority
wipe), each from a fixed seed.  The weights are dyadic
(``_torch_parity.dyadic``), so the packages agree bit for bit.
``tiled-bmp-fused`` is held against JAX's ``tiled-bmp-grouped``: the JAX
fused kernel does not trace on this JAX (``pl.load``), which is why
``tests/test_deletions.py`` fails there for that engine.
"""
import numpy as np
import pytest

from _torch_parity import dyadic, port_batch
from repro.core.engine import RetrievalConfig as JConfig
from repro.core.session import Retriever as JRetriever
from repro.core.session import SearchSession as JSession
from repro.data.synthetic import make_msmarco_like
from repro_torch.core import registry
from repro_torch.core.engine import RetrievalConfig
from repro_torch.core.session import Retriever, SearchSession

ENGINES = registry.available_engines()
PRUNED = tuple(n for n in ENGINES if registry.get_engine(n).pruned)
JAX_NAME = {"tiled-bmp-fused": "tiled-bmp-grouped"}
NUM_DOCS, NUM_QUERIES, VOCAB, K = 96, 4, 64, 5
STYLES = ("scattered", "block", "heavy")


def _cfgs(engine):
    kw = dict(doc_block=16, term_block=8, k=K)
    return (RetrievalConfig(engine=engine, **kw),
            JConfig(engine=JAX_NAME.get(engine, engine), **kw))


def _corpus(seed):
    c = make_msmarco_like(num_docs=NUM_DOCS, num_queries=NUM_QUERIES,
                          vocab_size=VOCAB, seed=seed)
    return dyadic(c.docs), dyadic(c.queries), c.qrels


def _subset(batch, keep):
    import jax.numpy as jnp
    from repro.core.sparse import SparseBatch as JBatch

    return JBatch(jnp.asarray(np.asarray(batch.term_ids)[keep]),
                  jnp.asarray(np.asarray(batch.values)[keep]),
                  batch.vocab_size)


def _delete_ids(seed, style):
    rng = np.random.default_rng(seed)
    if style == "scattered":
        return np.unique(rng.choice(NUM_DOCS, size=9, replace=False))
    if style == "block":
        start = int(rng.integers(0, NUM_DOCS // 16)) * 16
        return np.arange(start, start + 16)
    return np.unique(rng.choice(NUM_DOCS, size=(2 * NUM_DOCS) // 3,
                                replace=False))


def _same(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,style", list(zip((3, 4, 5), STYLES)))
def test_delete_matches_rebuild_on_survivors(seed, style):
    docs, queries, _ = _corpus(seed)
    dead = _delete_ids(seed + 1, style)
    survivors = np.setdiff1d(np.arange(NUM_DOCS), dead)
    q = port_batch(queries)
    for engine in ENGINES:
        pc, jc = _cfgs(engine)
        port, ref = Retriever(port_batch(docs), pc, device="cpu"), \
            JRetriever(docs, jc)
        assert port.delete_docs(dead) == ref.delete_docs(dead) == len(dead)
        assert port.delete_docs(dead) == 0  # idempotent
        assert port.num_alive == ref.num_alive == len(survivors)
        assert port.mutation == ref.mutation == 1
        np.testing.assert_array_equal(port.is_deleted(np.arange(NUM_DOCS)),
                                      ref.is_deleted(np.arange(NUM_DOCS)))
        got = port.search(q, k=K)
        _same(got, ref.search(queries, k=K))
        rebuilt = Retriever(port_batch(_subset(docs, survivors)), pc,
                            device="cpu")
        rv, ri = rebuilt.search(q, k=K)
        ri = np.where(ri >= 0, survivors[np.clip(ri, 0, None)], -1)
        np.testing.assert_array_equal(got[1], ri, err_msg=engine)
        fin = np.isfinite(rv)
        np.testing.assert_array_equal(got[0][fin], rv[fin])
        assert not np.isin(got[1], dead).any(), engine


@pytest.mark.parametrize("seed,style", list(zip((6, 7, 8), STYLES)))
def test_warm_after_delete_matches_cold_and_jax_demotion(seed, style):
    """The demotion policy is the session's, the same for every engine:
    run on an exact engine and on each warm-started sweep."""
    docs, queries, _ = _corpus(seed)
    dead = _delete_ids(seed + 1, style)
    split = NUM_DOCS - 32
    q = port_batch(queries)
    for engine in ("tiled", "tiled-pruned", "tiled-bmp-grouped",
                   "tiled-bmp-fused"):
        pc, jc = _cfgs(engine)
        port = Retriever(port_batch(_subset(docs, np.arange(split))), pc,
                         device="cpu")
        ref = JRetriever(_subset(docs, np.arange(split)), jc)
        port.add_docs(port_batch(_subset(docs, np.arange(split,
                                                         NUM_DOCS))))
        ref.add_docs(_subset(docs, np.arange(split, NUM_DOCS)))
        warm, jwarm = SearchSession(port, k=K), JSession(ref, k=K)
        _same(warm.search(q), jwarm.search(queries))
        port.delete_docs(dead)
        ref.delete_docs(dead)
        for qid in range(NUM_QUERIES):
            got = warm._demotion_tau(warm._cache[qid])
            want = jwarm._demotion_tau(jwarm._cache[qid])
            assert (got is None) == (want is None), (engine, qid)
            if got is not None:
                assert isinstance(got, np.float32)
                assert got.tobytes() == want.tobytes(), (engine, qid)
        v_warm = warm.search(q)
        _same(v_warm, SearchSession(port, k=K).search(q))
        _same(v_warm, jwarm.search(queries))
        assert warm.demotions == jwarm.demotions
        _same(warm.search(q), v_warm)  # revalidated at the new mutation


@pytest.mark.parametrize("engine", PRUNED)
def test_compact_preserves_results_and_tightens_stats(engine):
    docs, queries, _ = _corpus(seed=7)
    q = port_batch(queries)
    pc, jc = _cfgs(engine)
    port, ref = Retriever(port_batch(docs), pc, device="cpu"), \
        JRetriever(docs, jc)
    sess = SearchSession(port, k=K)
    for r in (port, ref):
        r.delete_docs(np.arange(NUM_DOCS // 2))
    before = port.search(q, k=K)
    st_before = port.prune_stats(q, k=K)
    sess.search(q)
    assert port.compact(threshold=0.25) == ref.compact(threshold=0.25) == 1
    after = port.search(q, k=K)
    _same(after, before)
    _same(after, ref.search(queries, k=K))
    st_after = port.prune_stats(q, k=K)
    jst = ref.prune_stats(queries, k=K)
    assert st_after.chunks_total < st_before.chunks_total
    assert st_after.chunks_scored <= st_before.chunks_scored
    assert (st_after.chunks_total, st_after.chunks_scored,
            st_after.blocks_scored) == (jst.chunks_total, jst.chunks_scored,
                                        jst.blocks_scored)
    np.testing.assert_array_equal(port._segments[0].id_map,
                                  ref._segments[0].id_map)
    v_sess, i_sess = sess.search(q)
    np.testing.assert_array_equal(i_sess, after[1][:, : i_sess.shape[1]])
    r2 = Retriever(port_batch(docs), pc, device="cpu")
    r2.delete_docs(np.arange(NUM_DOCS))
    assert r2.compact(threshold=0.0) == 0
    assert r2.num_alive == 0


def test_compact_and_delete_validation():
    docs, _, _ = _corpus(seed=3)
    r = Retriever(port_batch(docs), _cfgs("tiled")[0], device="cpu")
    for bad in (1.0, -0.1):
        with pytest.raises(ValueError):
            r.compact(threshold=bad)
    for bad in ([NUM_DOCS], [-1]):
        with pytest.raises(ValueError):
            r.delete_docs(bad)


def test_evaluate_excludes_deleted_from_qrels():
    docs, queries, qrels = _corpus(seed=11)
    pc, jc = _cfgs("tiled")
    port, ref = Retriever(port_batch(docs), pc, device="cpu"), \
        JRetriever(docs, jc)
    dead = sorted(qrels[0])
    for r in (port, ref):
        r.delete_docs(dead)
    k = min(32, port.num_alive)
    got = port.evaluate(port_batch(queries), [set(x) for x in qrels], k=k)
    assert got == ref.evaluate(queries, [set(x) for x in qrels], k=k)
    returned = [set(int(x) for x in row if x >= 0)
                for row in port.search(port_batch(queries), k=k)[1]]
    surv = [set(x) - set(dead) for x in qrels]
    per_q = [len(s & ids) / len(s) for s, ids in zip(surv, returned) if s]
    assert got[f"recall@{k}"] == pytest.approx(np.mean(per_q))
