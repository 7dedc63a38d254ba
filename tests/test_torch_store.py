"""The port's segment store vs ``repro.store``, on the CPU.

The checks of ``tests/test_store.py`` on the port, and the interop the
two packages promise: a store written by ``repro.store.SegmentWriter``
opens in the port and one written by the port opens in
``repro.core.session.Retriever.from_store``, with bit-identical index
arrays (names, dtypes, values) and equal results.  Then the port's own
round trips (every engine, both bound layouts, reordering, tombstones,
compaction, a warm session, ``add_docs`` spilling), the streaming bound,
the pager's budget, LRU order and counters, corruption, version and
geometry errors, and the config snapshot's JAX-only keys.  The weights
are dyadic (``_torch_parity.dyadic``), so results agree bit for bit.
"""
import json
import os
import threading

import numpy as np
import pytest

from _torch_parity import dyadic, port_batch
from repro.core.engine import RetrievalConfig as JConfig
from repro.core.session import Retriever as JRetriever
from repro.data.synthetic import make_msmarco_like
from repro.store import SegmentReader as JReader
from repro.store import SegmentWriter as JWriter
from repro.store import format as j_store_fmt
from repro_torch.core import registry
from repro_torch.core.engine import RetrievalConfig
from repro_torch.core.index import (
    TILED_ARRAY_FIELDS, TILED_OPTIONAL_ARRAY_FIELDS,
)
from repro_torch.core.session import Retriever, SearchSession
from repro_torch.store import (
    SegmentPager, SegmentReader, SegmentWriter, StoreCorruptionError, Upload,
)
from repro_torch.store import format as store_fmt

ENGINES = registry.available_engines()
PRUNED = tuple(n for n in ENGINES if registry.get_engine(n).pruned)
JAX_NAME = {"tiled-bmp-fused": "tiled-bmp-grouped"}
NUM_DOCS, NUM_QUERIES, VOCAB, K, SEG = 96, 4, 64, 5, 32
FIELDS = TILED_ARRAY_FIELDS + TILED_OPTIONAL_ARRAY_FIELDS


def _cfg(engine, **kw):
    kw.setdefault("doc_block", 16)
    kw.setdefault("term_block", 8)
    return RetrievalConfig(engine=engine, k=K, **kw)


def _jcfg(engine, **kw):
    kw.setdefault("doc_block", 16)
    kw.setdefault("term_block", 8)
    return JConfig(engine=JAX_NAME.get(engine, engine), k=K, **kw)


@pytest.fixture(scope="module")
def corpus():
    c = make_msmarco_like(num_docs=NUM_DOCS, num_queries=NUM_QUERIES,
                          vocab_size=VOCAB, seed=11)
    return dyadic(c.docs), dyadic(c.queries), c.qrels


def _batches(docs, size):
    return [docs.slice_rows(s, min(size, docs.batch - s))
            for s in range(0, docs.batch, size)]


def _pair(tmp_path, corpus, cfg, budget=None, seg=SEG):
    """(paged port retriever over a fresh port store, never-spilled port
    retriever with the same segmentation)."""
    docs = corpus[0]
    path = str(tmp_path / "store")
    SegmentWriter(path, cfg, segment_docs=seg, device="cpu").ingest(
        port_batch(b) for b in _batches(docs, seg))
    paged = Retriever.from_store(path, device_budget_bytes=budget,
                                 device="cpu")
    ref = Retriever(config=cfg, device="cpu")
    for b in _batches(docs, seg):
        ref.add_docs(port_batch(b))
    return paged, ref


def _same_search(a, b, queries, jax_b=False):
    got = a.search(port_batch(queries), k=K, return_tau=True) \
        if a.spec.supports_tau else a.search(port_batch(queries), k=K)
    want = b.search(queries if jax_b else port_batch(queries), k=K,
                    **({"return_tau": True} if a.spec.supports_tau else {}))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


# -- interop with the JAX package --------------------------------------------

@pytest.mark.parametrize("engine", ["tiled", "ell", "tiled-pruned",
                                    "tiled-bmp-fused"])
def test_jax_store_opens_in_the_port_and_back(tmp_path, corpus, engine):
    docs, queries, _ = corpus
    kw = dict(bounds_format="csr") if engine == "tiled-pruned" else {}
    jpath, ppath = str(tmp_path / "jax"), str(tmp_path / "port")
    # Writing builds the index only, so JAX writes a fused store too.
    JWriter(jpath, JConfig(engine=engine, k=K, doc_block=16, term_block=8,
                           **kw), segment_docs=SEG).ingest(
        _batches(docs, SEG))
    SegmentWriter(ppath, _cfg(engine, **kw), segment_docs=SEG,
                  device="cpu").ingest(
        port_batch(b) for b in _batches(docs, SEG))
    resident = Retriever(config=_cfg(engine, **kw), device="cpu")
    for b in _batches(docs, SEG):
        resident.add_docs(port_batch(b))
    # the port opens the JAX store, JAX opens the port's
    from_jax = Retriever.from_store(jpath, device="cpu")
    from_port = JRetriever.from_store(ppath)
    assert from_port.config.engine == engine and from_port.version == 3
    _same_search(from_jax, resident, queries)
    if engine not in JAX_NAME:  # JAX's fused kernel does not trace here
        _same_search(from_jax, from_port, queries, jax_b=True)
    # the same files, and bit-identical index arrays both ways
    seg = store_fmt.segment_dir_name(1)
    jm = JReader(os.path.join(jpath, seg)).manifest
    pm = SegmentReader(os.path.join(ppath, seg)).manifest
    assert sorted(jm["arrays"]) == sorted(pm["arrays"])
    assert pm["format_version"] == jm["format_version"] == 1
    assert {k: pm[k] for k in ("kind", "num_docs", "count", "geometry",
                               "bounds_memory")} == \
        {k: jm[k] for k in ("kind", "num_docs", "count", "geometry",
                            "bounds_memory")}
    for name in jm["arrays"]:
        for a, b in ((JReader(os.path.join(jpath, seg)).array(name),
                      SegmentReader(os.path.join(ppath, seg)).array(name)),):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    if pm["kind"] == "tiled":
        loaded = SegmentReader(os.path.join(jpath, seg)).load_index(
            Upload("cpu"))
        jloaded = JReader(os.path.join(ppath, seg)).load_index()
        for name in FIELDS:
            a, b = getattr(loaded, name), getattr(jloaded, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert a.numpy().dtype == np.asarray(b).dtype, name
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_reorder_store_crosses_to_jax(tmp_path, corpus):
    docs, queries, _ = corpus
    cfg = _cfg("tiled-pruned", reorder_docs=True,
               reorder_method="df-signature")
    paged, ref = _pair(tmp_path, corpus, cfg)
    _same_search(paged, ref, queries)
    _same_search(paged, JRetriever.from_store(str(tmp_path / "store")),
                 queries, jax_b=True)
    unperm = SegmentReader(os.path.join(
        str(tmp_path / "store"), store_fmt.segment_dir_name(0))
    ).array("doc_unperm")
    assert unperm.dtype == np.int32


def test_config_snapshot_jax_only_keys(tmp_path, corpus):
    docs, _, _ = corpus
    path = str(tmp_path / "store")
    SegmentWriter(path, _cfg("tiled"), segment_docs=SEG,
                  device="cpu").ingest([port_batch(docs)])
    snap = json.load(open(os.path.join(path, store_fmt.STORE_MANIFEST_NAME)))
    assert snap["config"]["pad_to"] == 128
    assert snap["config"]["use_f32_scores"] is True
    assert "obs" not in snap["config"] and "plan_cache" not in snap["config"]
    # pad_to is a config field now: another value round-trips.
    assert store_fmt.config_from_manifest(
        {**snap["config"], "pad_to": 64})["pad_to"] == 64
    for key, bad in (("use_f32_scores", False),
                     ("engine", "pallas"), ("engine", "pallas_ell")):
        with pytest.raises(ValueError, match=key if key != "engine" else
                           ("'tiled'" if bad == "pallas" else "'ell'")):
            store_fmt.config_from_manifest({**snap["config"], key: bad})
    jpath = str(tmp_path / "jax_pallas")
    JWriter(jpath, JConfig(engine="pallas", k=K, doc_block=16,
                           term_block=8), segment_docs=SEG).ingest(
        _batches(docs, SEG))
    with pytest.raises(ValueError, match="'tiled'"):
        Retriever.from_store(jpath, device="cpu")


def test_jax_segment_store_keeps_its_pad(tmp_path, corpus):
    """A JAX ``segment`` store written at pad_to 32 opens in the port with
    that pad (its FlatIndex rebuilt at 32, as JAX's is) and gives JAX's
    results; the port's store of it opens in JAX."""
    docs, queries, _ = corpus
    jpath, ppath = str(tmp_path / "jax"), str(tmp_path / "port")
    JWriter(jpath, JConfig(engine="segment", k=K, pad_to=32),
            segment_docs=SEG).ingest(_batches(docs, SEG))
    port = Retriever.from_store(jpath, device="cpu")
    assert port.config.pad_to == 32
    flat = port._segments[0].engine._flat
    assert flat.pad_to == 32 and flat.total_padded % 32 == 0
    _same_search(port, JRetriever.from_store(jpath), queries, jax_b=True)
    SegmentWriter(ppath, RetrievalConfig(engine="segment", k=K, pad_to=32),
                  segment_docs=SEG, device="cpu").ingest(
        port_batch(b) for b in _batches(docs, SEG))
    assert JRetriever.from_store(ppath).config.pad_to == 32
    with pytest.raises(ValueError, match="pad_to"):
        Retriever.from_store(jpath, config=RetrievalConfig(
            engine="segment", k=K), device="cpu")


# -- round trips in the port -------------------------------------------------

def test_round_trip_every_engine(tmp_path, corpus):
    docs, queries, qrels = corpus
    for engine in ENGINES:
        paged, ref = _pair(tmp_path / engine, corpus, _cfg(engine))
        _same_search(paged, ref, queries)
        assert paged.evaluate(port_batch(queries), qrels, k=K) == \
            ref.evaluate(port_batch(queries), qrels, k=K)


@pytest.mark.parametrize("engine", PRUNED)
@pytest.mark.parametrize("bounds_format", ["dense", "csr"])
def test_round_trip_bounds_formats(tmp_path, corpus, engine, bounds_format):
    paged, ref = _pair(tmp_path, corpus, _cfg(engine,
                                              bounds_format=bounds_format))
    _same_search(paged, ref, corpus[1])
    bm = paged.bounds_memory()
    assert bm["format"] == bounds_format and bm["stored"] > 0


def test_deletes_persist_and_compact_rewrites_in_place(tmp_path, corpus):
    queries = corpus[1]
    cfg = _cfg("tiled-pruned")
    paged, ref = _pair(tmp_path, corpus, cfg)
    doomed = [1, 7, 33, 34, 65] + list(range(8, 24))
    paged.delete_docs(doomed)
    ref.delete_docs(doomed)
    _same_search(paged, ref, queries)
    reopened = Retriever.from_store(str(tmp_path / "store"), device="cpu")
    assert reopened.num_alive == ref.num_alive
    assert sorted(reopened._deleted_ids) == sorted(doomed)
    _same_search(reopened, ref, queries)
    gen0 = paged._segments[0].handle.generation
    assert paged.compact(threshold=0.5) == ref.compact(threshold=0.5) == 1
    assert paged._segments[0].handle.generation == gen0 + 1
    _same_search(paged, ref, queries)
    reopened = Retriever.from_store(str(tmp_path / "store"), device="cpu")
    _same_search(reopened, ref, queries)
    assert reopened._segments[0].id_map is not None
    # the compacted store opens in JAX too
    _same_search(reopened, JRetriever.from_store(str(tmp_path / "store")),
                 queries, jax_b=True)


def test_warm_session_over_paged_matches_cold(tmp_path, corpus):
    queries = corpus[1]
    paged, ref = _pair(tmp_path, corpus, _cfg("tiled-pruned"))
    sess = SearchSession(paged, k=K)
    v1, i1 = sess.search(port_batch(queries))
    doomed = sorted({int(d) for d in i1[:, 0]})
    paged.delete_docs(doomed)
    ref.delete_docs(doomed)
    v2, i2 = sess.search(port_batch(queries))
    rv, ri = ref.search(port_batch(queries), k=K)
    np.testing.assert_array_equal(v2, rv)
    np.testing.assert_array_equal(i2, ri)
    assert not np.array_equal(v1, v2)


def test_add_docs_spills_to_store(tmp_path, corpus):
    docs, queries, _ = corpus
    paged, ref = _pair(tmp_path, corpus, _cfg("tiled-pruned"))
    extra = port_batch(_batches(docs, SEG)[0])
    paged.add_docs(extra)
    ref.add_docs(extra)
    assert os.path.isdir(os.path.join(str(tmp_path / "store"),
                                      store_fmt.segment_dir_name(3)))
    _same_search(paged, ref, queries)
    assert Retriever.from_store(str(tmp_path / "store"),
                                device="cpu").version == 4
    with pytest.raises(NotImplementedError, match="fresh store"):
        paged.rebuild(port_batch(docs))


def test_streaming_build_and_writer_errors(tmp_path, corpus):
    docs = corpus[0]
    cfg = _cfg("tiled-pruned")
    w = SegmentWriter(str(tmp_path / "s"), cfg, segment_docs=SEG,
                      device="cpu")
    w.ingest(port_batch(b) for b in _batches(docs, 24))  # misaligned
    assert w.max_buffered_docs <= SEG
    assert (w.docs_written, w.segments_written) == (NUM_DOCS,
                                                    NUM_DOCS // SEG)
    with pytest.raises(ValueError, match="doc_block"):
        SegmentWriter(str(tmp_path / "t"), cfg, segment_docs=SEG + 1,
                      device="cpu")
    with pytest.raises(ValueError, match="already holds"):
        SegmentWriter(str(tmp_path / "s"), cfg, segment_docs=SEG,
                      device="cpu")


# -- the pager ---------------------------------------------------------------

def test_pager_budget_and_counters(tmp_path, corpus):
    queries = corpus[1]
    probe, ref = _pair(tmp_path, corpus, _cfg("tiled-pruned"))
    probe.search(port_batch(queries), k=K)
    seg_bytes = [s["device_bytes"] for s in probe.bounds_memory()["segments"]]
    assert all(b > 0 for b in seg_bytes)
    assert probe.pager_stats()["evictions"] == 0
    probe.search(port_batch(queries), k=K)  # unbounded: all hits
    st = probe.pager_stats()
    assert st["hits"] >= 3 and st["bytes_loaded"] == sum(seg_bytes)
    budget = max(seg_bytes)
    paged = Retriever.from_store(str(tmp_path / "store"),
                                 device_budget_bytes=budget, device="cpu")
    v1, i1 = paged.search(port_batch(queries), k=K)
    st1 = paged.pager_stats()
    assert st1["resident_bytes"] <= budget and st1["evictions"] > 0
    assert st1["misses"] + st1["prefetches"] >= 3
    v2, i2 = paged.search(port_batch(queries), k=K)
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(i1, i2)
    assert paged.pager_stats()["resident_bytes"] <= budget
    rv, ri = ref.search(port_batch(queries), k=K)
    np.testing.assert_array_equal(v1, rv)
    np.testing.assert_array_equal(i1, ri)
    snap = paged.obs_snapshot()
    assert snap.gauges["pager.evictions"] == paged.pager_stats()["evictions"]


class _Eng:
    def __init__(self, n):
        self.n = n

    def index_bytes(self):
        return self.n


class _H:
    """A segment handle whose page-in makes an engine of ``n`` bytes; it
    records the thread it ran on and, with ``gate``, blocks until the
    gate opens (``fail``: raises instead)."""

    def __init__(self, name, n, gate=None, fail=False):
        self.seg_dir, self.generation, self.n = name, 0, n
        self.gate, self.fail, self.thread = gate, fail, None

    def load_engine(self, config, upload):
        assert isinstance(upload, Upload)
        self.thread = threading.current_thread()
        if self.gate is not None:
            assert self.gate.wait(10)
        if self.fail:
            raise StoreCorruptionError(f"{self.seg_dir}: bad page-in")
        return _Eng(self.n)

    def mapped_bytes(self):
        return self.n


def test_pager_lru_eviction_order():
    pager = SegmentPager(budget_bytes=250, config=object(), device="cpu")
    a, b, c = _H("a", 100), _H("b", 100), _H("c", 100)
    for h in (a, b, c):
        pager.acquire(h)  # c evicts a (LRU)
    assert pager.resident_segments() == ["b", "c"]
    assert pager.stats()["evictions"] == 1
    pager.acquire(b)  # refresh b
    pager.acquire(a)  # evicts c, not b
    assert pager.resident_segments() == ["b", "a"]
    pager.prefetch(_H("d", 200))  # would have to evict the MRU: skipped
    assert pager.stats()["prefetch_skipped"] == 1
    assert pager.resident_segments() == ["b", "a"]
    a.generation = 1
    assert not pager.is_resident(a)
    pager.acquire(a)
    assert pager.stats()["misses"] == 5
    pager.evict_all()
    assert pager.stats()["resident_bytes"] == 0
    with pytest.raises(ValueError, match="budget_bytes"):
        SegmentPager(budget_bytes=0, device="cpu")


def test_prefetch_stages_off_the_callers_thread():
    """A prefetch returns while its page-in still runs on the pager's
    thread; acquiring it waits for that page-in, counts a hit (as the JAX
    pager does) and admits it into the LRU under the budget."""
    pager = SegmentPager(budget_bytes=250, config=object(), device="cpu")
    a, gate = _H("a", 100), threading.Event()
    b, c = _H("b", 100, gate=gate), _H("c", 100)
    pager.acquire(c)
    pager.acquire(a)
    pager.prefetch(b)  # returns with b's page-in blocked on the gate
    assert not pager.is_resident(b) and pager.resident_segments() == ["c",
                                                                      "a"]
    pager.prefetch(b)  # already staged: neither counted nor skipped
    st = pager.stats()
    assert st["prefetches"] == 1 and st["prefetch_skipped"] == 0
    gate.set()
    assert pager.acquire(b).n == 100
    assert b.thread is not threading.current_thread()
    assert a.thread is threading.current_thread()  # a demand miss
    assert pager.resident_segments() == ["a", "b"]  # c evicted at admit
    st = pager.stats()
    assert (st["hits"], st["misses"], st["evictions"]) == (1, 2, 1)
    assert st["bytes_loaded"] == 300 and st["resident_bytes"] == 200


def test_prefetch_error_is_raised_not_swallowed():
    """A page-in that fails on the prefetch thread raises where the
    segment is next acquired (or invalidated), and leaves no residency."""
    pager = SegmentPager(config=object(), device="cpu")
    bad = _H("bad", 100, fail=True)
    pager.prefetch(bad)
    with pytest.raises(StoreCorruptionError, match="bad page-in"):
        pager.acquire(bad)
    assert pager.resident_segments() == []
    pager.prefetch(bad)
    with pytest.raises(StoreCorruptionError, match="bad page-in"):
        pager.evict_all()
    bad.fail = False
    assert pager.acquire(bad).n == 100


def test_corpus_4x_device_budget(tmp_path, corpus):
    docs, queries, qrels = corpus
    cfg = _cfg("tiled-pruned")
    ref = Retriever(config=cfg, device="cpu")
    for b in _batches(docs, 16):
        ref.add_docs(port_batch(b))
    total = ref.index_bytes()
    path = str(tmp_path / "store")
    w = SegmentWriter(path, cfg, segment_docs=16, device="cpu")
    w.ingest(port_batch(b) for b in _batches(docs, 16))
    assert w.max_buffered_docs <= 16
    paged = Retriever.from_store(path, device_budget_bytes=total // 4,
                                 device="cpu")
    _same_search(paged, ref, queries)
    doomed = list(range(0, 12)) + [40, 41, 90]
    paged.delete_docs(doomed)
    ref.delete_docs(doomed)
    _same_search(paged, ref, queries)
    assert paged.compact(threshold=0.5) == ref.compact(threshold=0.5) >= 1
    _same_search(paged, ref, queries)
    assert paged.evaluate(port_batch(queries), qrels, k=K) == \
        ref.evaluate(port_batch(queries), qrels, k=K)
    st = paged.pager_stats()
    assert st["budget_bytes"] == total // 4
    assert st["evictions"] > 0 and st["bytes_loaded"] > 0


def test_bounds_memory_breakdown(tmp_path, corpus):
    paged, ref = _pair(tmp_path, corpus, _cfg("tiled-pruned"))
    bm = paged.bounds_memory()
    assert bm["device_bytes"] == 0 and bm["mapped_bytes"] > 0
    assert [s["resident"] for s in bm["segments"]] == [False] * 3
    paged.search(port_batch(corpus[1]), k=K)
    bm2, rbm = paged.bounds_memory(), ref.bounds_memory()
    assert bm2["device_bytes"] > 0 and rbm["mapped_bytes"] == 0
    assert rbm["device_bytes"] == ref.index_bytes() > 0
    assert {k: bm2[k] for k in ("format", "stored", "dense", "csr")} == \
        {k: rbm[k] for k in ("format", "stored", "dense", "csr")}


# -- corruption --------------------------------------------------------------

def _one_store(tmp_path, corpus):
    path = str(tmp_path / "store")
    SegmentWriter(path, _cfg("tiled-pruned"), segment_docs=SEG,
                  device="cpu").ingest(
        port_batch(b) for b in _batches(corpus[0], SEG))
    return path, os.path.join(path, store_fmt.segment_dir_name(0))


@pytest.mark.parametrize("size,chunk", [(0, 1 << 26), (5000, 1 << 26),
                                        (3 * 4096 + 1, 4096),
                                        (2 * 4096, 4096)])
def test_crc32_file_matches_jax(tmp_path, size, chunk):
    """The port's CRC pass reads in large chunks; the checksum is JAX's,
    whatever the chunk and however the file's size falls on it."""
    path = tmp_path / "blob"
    path.write_bytes(np.random.default_rng(size).bytes(size))
    assert (store_fmt.crc32_file(str(path), chunk=chunk)
            == j_store_fmt.crc32_file(str(path)))


@pytest.mark.parametrize("fault", ["truncated", "bit flip", "uncommitted",
                                   "not a store", "version", "geometry"])
def test_faults_are_detected(tmp_path, corpus, fault):
    path, seg = _one_store(tmp_path, corpus)
    target = os.path.join(seg, SegmentReader(seg).manifest["arrays"][
        "value"]["file"])
    size = os.path.getsize(target)
    if fault == "truncated":
        with open(target, "r+b") as f:
            f.truncate(size - 8)
        with pytest.raises(StoreCorruptionError, match="truncated"):
            SegmentReader(seg).validate()
    elif fault == "bit flip":
        with open(target, "r+b") as f:
            f.seek(size - 4)
            byte = f.read(1)
            f.seek(size - 4)
            f.write(bytes([byte[0] ^ 0xFF]))
        with pytest.raises(StoreCorruptionError, match="CRC-32"):
            SegmentReader(seg).validate()
    elif fault == "uncommitted":
        os.remove(os.path.join(seg, store_fmt.MANIFEST_NAME))
        with pytest.raises(StoreCorruptionError, match="never committed"):
            Retriever.from_store(path, device="cpu")
    elif fault == "not a store":
        with pytest.raises(StoreCorruptionError, match="not a segment"):
            Retriever.from_store(str(tmp_path), device="cpu")
    elif fault == "version":
        mpath = os.path.join(seg, store_fmt.MANIFEST_NAME)
        manifest = json.load(open(mpath))
        manifest["format_version"] = 99
        json.dump(manifest, open(mpath, "w"))
        with pytest.raises(StoreCorruptionError, match="format_version"):
            SegmentReader(seg)
    else:
        with pytest.raises(ValueError, match="doc_block"):
            Retriever.from_store(path, config=_cfg("tiled-pruned",
                                                   doc_block=32),
                                 device="cpu")
        with pytest.raises(ValueError, match="engine"):
            Retriever.from_store(path, config=_cfg("tiled"), device="cpu")
