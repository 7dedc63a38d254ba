"""The bf16 ``compute_dtype`` of the port's sharded serve steps, on the CPU.

The contract (``repro_torch.core.distributed``): the query weights and the
index values are rounded to bf16, each product is exact in f32, the
products are summed in f32, each score is rounded to bf16 once, and the
top-k runs over those values, lower id first on ties.  Held here:

  * ``ell`` in bf16 against JAX's bf16 ``ell`` step (which rounds its
    einsum's f32 sums once too): each value within one bf16 ulp, an id in
    one top-k only within one ulp of the other's k-th value
    (``_torch_parity.assert_bf16_topk``); on a corpus of few weight levels
    (``ties``) the scores tie in runs, so lower-id-first decides the cut.
  * The five other engines in bf16 against the port's bf16 ``ell`` step,
    the same way; the pruned engines (and ``approx`` at theta 1) against
    the port's bf16 ``tiled`` step bit for bit, values, ids and tau.
  * Every bf16 engine, port and JAX, against float64: top-k overlap >=
    0.95 (``tests/test_perf_features.py``'s bar), and the port's overlap
    with JAX's bf16 step of the same engine (JAX's tiled and BMP steps
    round every product, so it is no bit-for-bit bar).
  * The prune margin on near-ties: a bound from the f32 values (and the
    rounded weights) keeps every block whose bf16 score could tie tau.
  * The plain bf16 versions against their definitions; the index cast
    once for each (index, dtype); the four deprecated factories against
    JAX's; make_corpus's chunked packing and the chunked ELL rows; the
    top-k's tie repair by position.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_parity import assert_bf16_topk, dyadic, port_batch
from repro.core import distributed as jdist
from repro.core import index as jidx
from repro.core.engine import RetrievalConfig as JConfig
from repro.core.sparse import SparseBatch as JBatch
from repro.data.synthetic import make_topical_corpus
from repro.sched.planner import PlanCache as JPlanCache
from repro_torch.core import distributed as tdist
from repro_torch.core import index as tidx
from repro_torch.core import topk as ttopk
from repro_torch.core.engine import RetrievalConfig
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels.bmp_scan.ref import (
    MARGIN_REL, bmp_sweep_ref, prune_margin,
)
from repro_torch.kernels.ell_gather import ops as ell_ops
from repro_torch.kernels.ell_gather.ref import ell_gather_ref
from repro_torch.kernels.scatter_score.ref import scatter_score_ref
from repro_torch.sched.planner import PlanCache

BF = torch.bfloat16
K = 10
GEO = dict(term_block=128, doc_block=16, chunk_size=32)
MIN_SHARE = 0.2  # few planner groups: JAX runs its grouped step eagerly
OVERLAP_MIN = 0.95  # tests/test_perf_features.py::test_bf16_serving_quality
ENGINES = {  # id: (engine, extra config)
    "tiled": ("tiled", {}),
    "pruned-bmp": ("tiled-pruned", {}),
    "pruned-two-pass": ("tiled-pruned", {"traversal": "two-pass"}),
    "approx": ("tiled-pruned-approx", {}),  # theta 1: exact
    "grouped": ("tiled-bmp-grouped", {"sched_min_share": MIN_SHARE}),
    "fused": ("tiled-bmp-fused", {"sched_min_share": MIN_SHARE}),
}
PRUNED = [e for e in ENGINES if e != "tiled"]


def _levels(batch, levels):
    """A JAX batch with each nonzero weight moved to the nearest of
    ``levels`` (few values: many docs score alike)."""
    v = np.asarray(batch.values)
    lv = np.asarray(levels, np.float32)
    near = lv[np.abs(v[..., None] - lv).argmin(-1)]
    return JBatch(jnp.asarray(np.asarray(batch.term_ids)),
                  jnp.asarray(np.where(v != 0, near, 0.0).astype(np.float32)),
                  batch.vocab_size)


@pytest.fixture(scope="module", params=["corpus", "ties"])
def case(request):
    """(JAX docs, JAX queries, port docs, port queries, the indices)."""
    c = make_topical_corpus(600, 10, vocab_size=900, num_topics=6,
                            topic_vocab=120, seed=9)
    docs, _ = jidx.reorder_docs(c.docs, method="df-signature")
    queries = c.queries
    if request.param == "ties":
        docs = _levels(docs, [0.5, 1.0, 1.5, 2.0])
        queries = _levels(queries, [0.5, 1.0])
    tdocs, tq = port_batch(docs), port_batch(queries)
    idx = {"ell": (jdist.build_sharded_ell(docs, 1),
                   tdist.build_sharded_ell(tdocs, 1)),
           "tiled": (jdist.build_sharded_tiled(docs, 1, **GEO),
                     tdist.build_sharded_tiled(tdocs, 1, **GEO))}
    return docs, queries, tdocs, tq, idx


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.asarray(jax.devices()[:1]), ("shard",))


def _port_step(case, engine, extra, dtype=BF):
    _, _, _, tq, idx = case
    kind = "ell" if engine == "ell" else "tiled"
    tx = idx[kind][1]
    cfg = RetrievalConfig(engine=engine, k=K, **extra)
    cfg.plan_cache = PlanCache()
    step = tdist.make_serve_step(
        engine=engine, cfg=cfg, k=K, docs_per_shard=tx.docs_per_shard,
        geometry=None if kind == "ell" else tx.geometry(),
        compute_dtype=dtype)
    return step(tx, queries=tq)


def _jax_step(case, mesh, engine, extra):
    docs, queries, _, _, idx = case
    kind = "ell" if engine == "ell" else "tiled"
    jx = idx[kind][0]
    cfg = JConfig(engine=engine, k=K, **extra)
    cfg.plan_cache = JPlanCache()
    step = jdist.make_serve_step(
        mesh, ("shard",), engine=engine, cfg=cfg, k=K,
        docs_per_shard=jx.docs_per_shard,
        geometry=None if kind == "ell" else jx.geometry(),
        compute_dtype=jnp.bfloat16)
    qw = queries.to_dense()
    if kind == "tiled":
        v_pad = jx.term_block * -(-queries.vocab_size // jx.term_block)
        qw = jnp.pad(qw, ((0, 0), (0, v_pad - queries.vocab_size)))
    with mesh:
        return tuple(np.asarray(x) for x in step(jx, queries=queries,
                                                 qw=qw))


def _np(res):
    return tuple(x.numpy() for x in res)


def test_ell_bf16_matches_jax(case, mesh):
    got = _np(_port_step(case, "ell", {}))
    want = _jax_step(case, mesh, "ell", {})
    assert got[0].dtype == np.float32
    # bf16 values, returned as f32 (JAX casts its bf16 scores back)
    np.testing.assert_array_equal(
        got[0], torch.from_numpy(got[0]).to(BF).float().numpy())
    assert_bf16_topk(got, want)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_engines_bf16_match_ell(case, engine):
    assert_bf16_topk(_np(_port_step(case, *ENGINES[engine])),
                     _np(_port_step(case, "ell", {})))


@pytest.mark.parametrize("engine", PRUNED)
def test_pruned_bf16_exact_against_tiled(case, engine):
    """Under the contract the pruned steps sum in tiled's order and skip
    only blocks no doc of which could reach tau: tiled's bits."""
    got = _port_step(case, *ENGINES[engine])
    want = _port_step(case, "tiled", {})
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _overlap(a, b):
    return float(np.mean([len(set(x) & set(y)) / len(x)
                          for x, y in zip(a, b)]))


@pytest.mark.parametrize("engine", ["ell", "tiled", "pruned-bmp",
                                    "pruned-two-pass", "approx-0.7",
                                    "grouped"])
def test_bf16_steps_against_float64(engine):
    """Port and JAX in bf16 against float64, and against each other (the
    port's fused step against JAX's grouped one: the fused Pallas kernel
    does not trace here)."""
    c = make_topical_corpus(600, 10, vocab_size=900, num_topics=6,
                            topic_vocab=120, seed=9)
    docs, _ = jidx.reorder_docs(c.docs, method="df-signature")
    case_ = (docs, c.queries, port_batch(docs), port_batch(c.queries),
             {"ell": (jdist.build_sharded_ell(docs, 1),
                      tdist.build_sharded_ell(port_batch(docs), 1)),
              "tiled": (jdist.build_sharded_tiled(docs, 1, **GEO),
                        tdist.build_sharded_tiled(port_batch(docs), 1,
                                                  **GEO))})
    name, extra = (("tiled-pruned-approx", {"theta": 0.7})
                   if engine == "approx-0.7" else
                   ("ell", {}) if engine == "ell" else ENGINES[engine])
    mesh_ = Mesh(np.asarray(jax.devices()[:1]), ("shard",))
    want = _jax_step(case_, mesh_, name, extra)
    ports = [_np(_port_step(case_, name, extra))]
    if engine == "grouped":
        ports.append(_np(_port_step(case_, *ENGINES["fused"])))
    f64 = (np.asarray(c.queries.to_dense(), np.float64)
           @ np.asarray(docs.to_dense(), np.float64).T)
    oracle = np.argsort(-f64, axis=1, kind="stable")[:, :K]
    assert _overlap(want[1], oracle) >= OVERLAP_MIN
    for got in ports:
        assert _overlap(got[1], oracle) >= OVERLAP_MIN
        assert _overlap(got[1], want[1]) >= OVERLAP_MIN
        rel = np.abs(got[0] - np.take_along_axis(f64, got[1], 1)) / f64.max()
        assert rel.max() <= (1 + 2.0 ** -8) ** 3 - 1 + 1e-5


# -- the margin ----------------------------------------------------------------


def test_prune_margin_covers_the_bf16_roundings():
    """Near-ties: scores of bf16-rounded weights and values, summed in f32
    and rounded once, each against the bound a pruned engine forms (the
    f32 values, the rounded weights).  A doc that ties tau (score == tau)
    or beats it must keep its block: bound >= tau - margin(tau).  The f32
    margin (1e-4) misses some; the bf16 one misses none, with room."""
    rng = np.random.default_rng(0)
    n, t = 20000, 48
    q = rng.uniform(0.01, 3.5, (n, t)).astype(np.float32)
    v = rng.uniform(0.01, 3.5, (n, t)).astype(np.float32)
    qb = torch.from_numpy(q).to(BF).float()
    vb = torch.from_numpy(v).to(BF).float()
    score = (qb * vb).sum(-1).to(BF).float()  # f32 sums, one rounding
    bound = (qb * torch.from_numpy(v)).sum(-1)
    keep32 = bound >= score - prune_margin(score, torch.float32)
    keep16 = bound >= score - prune_margin(score, BF)
    assert bool(keep16.all())
    assert not bool(keep32.all())
    # The margin's room: the worst case seen uses under half of it.
    need = ((score - bound) / score.abs()).max()
    assert float(need) < MARGIN_REL[BF] / 2
    assert float(need) <= 2.0 ** -7 + 2.0 ** -15 + 1e-4


# -- the plain versions, the packing, the cast --------------------------------


def test_plain_bf16_versions_equal_their_definitions():
    rng = np.random.default_rng(1)
    b, v, n, k = 5, 200, 40, 12
    qw = torch.from_numpy(np.where(rng.random((b, v)) < 0.2,
                                   rng.uniform(0.05, 3, (b, v)), 0.0)
                          .astype(np.float32)).to(BF)
    terms = torch.from_numpy(rng.integers(0, v + 1, (n, k)).astype(np.int32))
    vals = torch.from_numpy(rng.uniform(0.01, 3.5, (n, k)).astype(
        np.float32)).to(BF)
    got = ell_gather_ref(qw, terms, vals)
    assert got.dtype == BF
    assert torch.equal(got, ell_gather_ref(qw.float(), terms,
                                           vals.float()).to(BF))
    # the definition: exact products (float64), then the one rounding
    qf = torch.nn.functional.pad(qw.double(), (0, 1))
    exact = (qf[:, terms.long()] * vals.double()).sum(-1)
    ulp = 2.0 ** (torch.floor(torch.log2(exact.clamp_min(2.0 ** -126))) - 7)
    assert bool(((got.double() - exact).abs() <= ulp).all())
    with pytest.raises(TypeError, match="index values"):
        ell_ops.ell_gather(qw, terms, vals.float())
    with pytest.raises(TypeError, match="float16"):
        ell_ops.ell_gather(qw.half(), terms, vals.half())


def test_plain_bf16_sweep_rounds_each_window_once():
    c = make_topical_corpus(300, 3, vocab_size=600, num_topics=4,
                            topic_vocab=100, seed=2)
    t = tidx.build_tiled_index(port_batch(c.docs), 128, 16, 32,
                               store_term_block_max=True)
    tb = tidx.TiledIndex(**{**t.__dict__, "value": t.value.to(BF)})
    from repro_torch.core import scoring
    qw = scoring._pad_queries_to_term_blocks(port_batch(c.queries), tb)
    assert qw.dtype == BF
    ub = scoring.block_upper_bounds(port_batch(c.queries), tb)
    order = torch.argsort(-ub, dim=-1, stable=True)
    runs = (tb.block_chunk_start, tb.block_chunk_count, tb.chunk_term_block,
            tb.chunk_doc_block, tb.local_term, tb.local_doc, tb.value)
    scores, heap, bsc, csc, steps = bmp_sweep_ref(
        qw, order.int(), ub.gather(-1, order), torch.full((3,), -np.inf),
        *runs, term_block=128, doc_block=16, k_eff=K, theta=1.0,
        num_docs=t.num_docs)
    cols = bsc.repeat_interleave(16)
    whole = scatter_score_ref(qw, *runs[4:], tb.chunk_term_block,
                              tb.chunk_doc_block, tb.block_chunk_start,
                              tb.block_chunk_count, term_block=128,
                              doc_block=16, num_doc_blocks=t.num_doc_blocks)
    assert torch.equal(scores[:, cols], whole.float()[:, cols])
    # the heap holds the top-k of the rounded scores of the scored docs
    real = cols.clone()
    real[t.num_docs:] = False
    want = torch.topk(torch.where(real, scores, -np.inf), K).values
    assert torch.equal(heap, want)


def test_index_is_cast_once_for_each_dtype(case):
    _, _, tdocs, tq, _ = case
    ell = tdist.build_sharded_ell(tdocs, 1)
    step = tdist.make_serve_step(engine="ell", k=K,
                                 docs_per_shard=ell.docs_per_shard,
                                 compute_dtype=BF)
    before = tdist.cast_bytes
    first = step(ell, queries=tq)
    assert tdist.cast_bytes - before == ell.values.numel() * 6
    again = step(ell, queries=tq)
    assert tdist.cast_bytes - before == ell.values.numel() * 6
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    kept = ell.keep_shard(0, "cpu")  # a copy: its own cache
    assert kept.casts == {} and ell.casts[BF].dtype == BF
    assert ell.shard(0).values.dtype == torch.float32
    with pytest.raises(NotImplementedError, match="bfloat16"):
        tdist.make_serve_step(engine="ell", k=K, docs_per_shard=8,
                              compute_dtype=torch.float64)


# -- the deprecated factories --------------------------------------------------


@pytest.fixture(scope="module")
def shim_corpus():
    c = make_topical_corpus(400, 6, vocab_size=700, num_topics=5,
                            topic_vocab=100, seed=4)
    return dyadic(c.docs), dyadic(c.queries)


@pytest.mark.parametrize("name", ["ell", "tiled", "tiled_pruned",
                                  "tiled_bmp"])
def test_deprecated_factories_equal_jax(shim_corpus, mesh, name):
    docs, queries = shim_corpus
    tdocs, tq = port_batch(docs), port_batch(queries)
    factory = ("make_retrieval_serve_step" if name == "ell"
               else f"make_retrieval_serve_step_{name}")
    jf, tf = getattr(jdist, factory), getattr(tdist, factory)
    if name == "ell":
        jx, tx = jdist.build_sharded_ell(docs, 1), tdist.build_sharded_ell(
            tdocs, 1)
        kw = dict(k=K, docs_per_shard=jx.docs_per_shard)
    else:
        jx = jdist.build_sharded_tiled(docs, 1, **GEO)
        tx = tdist.build_sharded_tiled(tdocs, 1, **GEO)
        kw = dict(k=K, docs_per_shard=jx.docs_per_shard,
                  geometry=jx.geometry())
    with pytest.warns(DeprecationWarning, match="make_serve_step"):
        jstep = jf(mesh, ("shard",), **kw)
    with pytest.warns(DeprecationWarning, match="make_serve_step"):
        tstep = tf(**kw)
    qw = queries.to_dense()
    if name != "ell":
        v_pad = jx.term_block * -(-queries.vocab_size // jx.term_block)
        qw = jnp.pad(qw, ((0, 0), (0, v_pad - queries.vocab_size)))
    tqw = torch.from_numpy(np.asarray(qw))
    raw = lambda x: tuple(getattr(x, f) for f in (  # noqa: E731
        "local_term", "local_doc", "value", "chunk_term_block",
        "chunk_doc_block"))
    with mesh:
        if name == "ell":
            want = jstep(jx, qw)
        elif name == "tiled":
            want = jstep(*raw(jx), qw)
        else:
            want = jstep(jx, queries, qw)
    got = (tstep(tx, tqw) if name == "ell" else
           tstep(*raw(tx), tqw) if name == "tiled" else
           tstep(tx, tq, tqw))
    assert len(got) == len(want) == (3 if name == "tiled_bmp" else 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # compute_dtype reaches the step
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        bstep = tf(**kw, compute_dtype=BF)
    got_b = (bstep(tx, tqw) if name == "ell" else
             bstep(*raw(tx), tqw) if name == "tiled" else
             bstep(tx, tq, tqw))
    assert not torch.equal(got_b[0], got[0])
    assert torch.equal(got_b[0], got_b[0].to(BF).float())


# -- the corpus and the index at scale: chunked, the same bits -----------------


def test_make_corpus_packs_in_chunks_with_the_same_docs(monkeypatch):
    whole = tsyn.make_corpus(3001, 2000, seed=4, device="cpu")
    monkeypatch.setattr(tsyn, "_PACK_ELEMS", 997)
    monkeypatch.setattr(tidx, "_ELL_ROW_ELEMS", 1000)
    cut = tsyn.make_corpus(3001, 2000, seed=4, device="cpu")
    assert cut.term_ids.dtype == torch.int32
    assert torch.equal(cut.term_ids, whole.term_ids)
    assert torch.equal(cut.values, whole.values)
    live = cut.term_ids >= 0
    assert int(live.sum(1).max()) == cut.max_terms  # no dead column
    ell = tdist.build_sharded_ell(cut, 3)
    monkeypatch.setattr(tidx, "_ELL_ROW_ELEMS", 1 << 26)
    ref = tdist.build_sharded_ell(whole, 3)
    assert torch.equal(ell.terms, ref.terms)
    assert torch.equal(ell.values, ref.values)


def test_tie_repair_by_position_keeps_lax_top_k_order(monkeypatch):
    """bf16 scores tie at the k-th value in most rows: the repair a few
    rows at a time gives the lowest positions, as a full sort would."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 6, (37, 500)).astype(
        np.float32)).to(BF)
    monkeypatch.setattr(ttopk, "_TIE_ELEMS", 1200)
    vals, pos = ttopk.topk(x, 50)
    xn = x.float().numpy()
    want = np.lexsort((np.broadcast_to(np.arange(500), xn.shape), -xn),
                      axis=1)[:, :50]
    np.testing.assert_array_equal(pos.numpy(), want)
    np.testing.assert_array_equal(vals.float().numpy(),
                                  np.take_along_axis(xn, want, 1))
