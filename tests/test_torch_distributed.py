"""The port's sharded serving (``repro_torch.core.distributed``) and serve
driver (``repro_torch.launch.serve``) vs ``repro.core.distributed``, on the
CPU.

  * ``shard_docs``, ``build_sharded_ell`` and ``build_sharded_tiled`` (dense
    and CSR bounds) equal JAX's field for field at S = 1, 2, 4.
  * Each engine's step at world size 1 equals JAX ``make_serve_step`` on
    one CPU device: values, ids and tau bit for bit, and the grouped and
    fused steps' plan groups.
  * At S = 4, four shards emulated in threads (the gather a barrier, the
    merge ``merge_gathered``) equal JAX on four forced host devices, run
    in one subprocess (``XLA_FLAGS`` is dropped in the test process).
  * Two ranks over gloo, in two processes, give the emulation's bits, and
    both ranks plan the same groups.
  * The loud errors, ``snapshot_paged`` against JAX's, and the serve driver
    on the CPU (overlap 1.0 against float64, the obs dump's span).

The weights are dyadic (``_torch_parity.dyadic``), so every f32 sum is
exact and the packages agree bit for bit.  The corpus is topical and
reordered, so the demand planner forms groups of several sizes.
"""
import json
import os
import socket
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_parity import dyadic, port_batch, shard_run
from repro.core import distributed as jdist
from repro.core import index as jidx
from repro.core.engine import RetrievalConfig as JConfig
from repro.core.session import Retriever as JRetriever
from repro.data.synthetic import make_topical_corpus
from repro.sched.planner import PlanCache as JPlanCache
from repro_torch.core import distributed as tdist
from repro_torch.core import index as tidx
from repro_torch.core import topk as ttopk
from repro_torch.core.engine import RetrievalConfig
from repro_torch.core.session import Retriever
from repro_torch.kernels.ell_gather import ops as ell_ops
from repro_torch.launch import serve
from repro_torch.sched.planner import PlanCache

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SRC = os.path.join(ROOT, "src")
K = 10
GEO = dict(term_block=128, doc_block=16, chunk_size=32)
# The planner's min_share: on this corpus, groups of 7 and 1 rows (two
# buckets) at one shard; JAX runs its grouped step eagerly, a few seconds
# a group, so few groups keep the file fast.
MIN_SHARE = 0.2
TWO_RANKS_MIN_SHARE = 0.5  # at two shards: four groups
CASES = {  # id: (engine, extra config)
    "ell": ("ell", {}),
    "tiled": ("tiled", {}),
    "pruned-bmp": ("tiled-pruned", {}),
    "pruned-two-pass": ("tiled-pruned", {"traversal": "two-pass"}),
    "approx": ("tiled-pruned-approx", {"theta": 0.7}),
    "grouped": ("tiled-bmp-grouped", {"sched_min_share": MIN_SHARE}),
    "fused": ("tiled-bmp-fused", {"sched_min_share": MIN_SHARE}),
}


@pytest.fixture(scope="module")
def corpus():
    c = make_topical_corpus(500, 8, vocab_size=900, num_topics=6,
                            topic_vocab=120, seed=9)
    docs, _ = jidx.reorder_docs(c.docs, method="df-signature")
    return dyadic(docs), dyadic(c.queries)


@pytest.fixture(scope="module")
def saved(corpus, tmp_path_factory):
    """The corpus as an npz, for the subprocesses."""
    docs, queries = corpus
    path = tmp_path_factory.mktemp("dist") / "corpus.npz"
    np.savez(path, doc_ids=np.asarray(docs.term_ids),
             doc_vals=np.asarray(docs.values),
             q_ids=np.asarray(queries.term_ids),
             q_vals=np.asarray(queries.values), vocab=docs.vocab_size)
    return path


JAX_FOUR = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.core import distributed as jd
from repro.core.engine import RetrievalConfig
from repro.core.sparse import SparseBatch
from repro.sched.planner import PlanCache

d = np.load(sys.argv[1])
K, GEO, MIN_SHARE = %(K)r, %(GEO)r, %(MIN_SHARE)r
docs = SparseBatch(jnp.asarray(d["doc_ids"]), jnp.asarray(d["doc_vals"]),
                   int(d["vocab"]))
qs = SparseBatch(jnp.asarray(d["q_ids"]), jnp.asarray(d["q_vals"]),
                 int(d["vocab"]))
mesh = Mesh(np.asarray(jax.devices()[:4]), ("shard",))
out = {}
ell = jd.build_sharded_ell(docs, 4)
step = jd.make_serve_step(mesh, ("shard",), engine="ell", k=K,
                          docs_per_shard=ell.docs_per_shard)
with mesh:
    out["ell"] = step(ell, queries=qs, qw=qs.to_dense())
tiled = jd.build_sharded_tiled(docs, 4, **GEO)
cfg = RetrievalConfig(engine="tiled-bmp-fused", k=K,
                      sched_min_share=MIN_SHARE)
cfg.plan_cache = PlanCache()
step = jd.make_serve_step(mesh, ("shard",), engine="tiled-bmp-fused",
                          cfg=cfg, k=K, docs_per_shard=tiled.docs_per_shard,
                          geometry=tiled.geometry())
v_pad = -(-qs.vocab_size // GEO["term_block"]) * GEO["term_block"]
qw = jnp.pad(qs.to_dense(), ((0, 0), (0, v_pad - qs.vocab_size)))
with mesh:
    out["fused"] = step(tiled, queries=qs, qw=qw)
flat = {f"{name}_{i}": np.asarray(x) for name, res in out.items()
        for i, x in enumerate(res)}
(plan,) = cfg.plan_cache._plans.values()
for i, g in enumerate(plan.groups):
    flat[f"group_{i}"] = np.asarray(g)
np.savez(sys.argv[2], **flat)
""" % dict(K=K, GEO=GEO, MIN_SHARE=MIN_SHARE)


@pytest.fixture(scope="module")
def jax_four_shards(saved, tmp_path_factory):
    """JAX at S = 4 on four forced host devices, started in the background
    when first asked for and read when a test needs its results."""
    out = tmp_path_factory.mktemp("jax4") / "out.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_FOUR, str(saved), str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def result():
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, log
        return dict(np.load(out))

    yield result
    if proc.poll() is None:
        proc.kill()


def _port(corpus):
    docs, queries = corpus
    return port_batch(docs), port_batch(queries)


def _configs(engine, extra):
    t = RetrievalConfig(engine=engine, k=K, **extra)
    j = JConfig(engine=engine, k=K, **extra)
    t.plan_cache, j.plan_cache = PlanCache(), JPlanCache()
    return t, j


def _groups(cache):
    return [[g.tolist() for g in plan.groups]
            for plan in cache._plans.values()]


def _assert_same(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(w))


# -- the host builds ----------------------------------------------------------


# Asking for the subprocess fixtures here starts them in the background.
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_builds_equal_jax(corpus, jax_four_shards, gloo_ranks, shards):
    docs, _ = corpus
    tdocs, _ = _port(corpus)
    for s in range(shards):
        jb, joff = jidx.shard_docs(docs, shards, s)
        tb, toff = tidx.shard_docs(tdocs, shards, s)
        assert joff == toff
        _assert_same((tb.term_ids, tb.values), (jb.term_ids, jb.values))
    je = jdist.build_sharded_ell(docs, shards, store_block_max=True)
    te = tdist.build_sharded_ell(tdocs, shards, store_block_max=True)
    _assert_same((te.terms, te.values, te.block_max),
                 (je.terms, je.values, je.block_max))
    for f in tdist.ELL_SCALARS + ("num_shards",):
        assert getattr(te, f) == getattr(je, f), f
    for fmt in ("dense", "csr"):
        jt = jdist.build_sharded_tiled(docs, shards, bounds_format=fmt,
                                       **GEO)
        tt = tdist.build_sharded_tiled(tdocs, shards, bounds_format=fmt,
                                       **GEO)
        for f in tdist.TILED_FIELDS:
            a, b = getattr(jt, f), getattr(tt, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                              err_msg=f)
        for f in tdist.TILED_SCALARS + ("num_shards", "num_doc_blocks"):
            assert getattr(tt, f) == getattr(jt, f), f
        assert tt.geometry() == jt.geometry()
        assert tt.bounds_memory() == jt.bounds_memory()
    # The default geometry is JAX build_sharded_tiled's, not
    # RetrievalConfig's.
    assert tdist.build_sharded_tiled(tdocs, 1).geometry() == \
        jdist.build_sharded_tiled(docs, 1).geometry()


def test_carriers_from_numpy(corpus):
    docs, _ = corpus
    je = jdist.build_sharded_ell(docs, 2)
    te = tdist.sharded_ell_from_numpy(
        {f: getattr(je, f) for f in tdist.ELL_FIELDS},
        {f: getattr(je, f) for f in tdist.ELL_SCALARS}, device="cpu")
    _assert_same((te.terms, te.values), (je.terms, je.values))
    jt = jdist.build_sharded_tiled(docs, 2, bounds_format="csr", **GEO)
    tt = tdist.sharded_tiled_from_numpy(
        {f: getattr(jt, f) for f in tdist.TILED_FIELDS},
        {f: getattr(jt, f) for f in tdist.TILED_SCALARS}, device="cpu")
    assert tt.num_shards == 2 and tt.term_block_max_q is None
    assert tt.geometry() == jt.geometry()
    _assert_same((tt.tbm_cols, tt.local_doc), (jt.tbm_cols, jt.local_doc))


# -- world size 1 against JAX on one device -----------------------------------


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.asarray(jax.devices()[:1]), ("shard",))


@pytest.fixture(scope="module")
def one_shard(corpus):
    docs, _ = corpus
    tdocs, _ = _port(corpus)
    return {
        "ell": (jdist.build_sharded_ell(docs, 1),
                tdist.build_sharded_ell(tdocs, 1)),
        "tiled": (jdist.build_sharded_tiled(docs, 1, **GEO),
                  tdist.build_sharded_tiled(tdocs, 1, **GEO)),
    }


@pytest.mark.parametrize("case", list(CASES))
def test_step_equals_jax(corpus, one_shard, mesh, case):
    engine, extra = CASES[case]
    _, queries = corpus
    _, tq = _port(corpus)
    kind = "ell" if engine == "ell" else "tiled"
    jx, tx = one_shard[kind]
    geo = None if kind == "ell" else jx.geometry()
    tcfg, jcfg = _configs(engine, extra)
    jstep = jdist.make_serve_step(mesh, ("shard",), engine=engine, cfg=jcfg,
                                  k=K, docs_per_shard=jx.docs_per_shard,
                                  geometry=geo)
    tstep = tdist.make_serve_step(engine=engine, cfg=tcfg, k=K,
                                  docs_per_shard=tx.docs_per_shard,
                                  geometry=geo)
    qw = queries.to_dense()
    if kind == "tiled":
        v_pad = jx.term_block * -(-queries.vocab_size // jx.term_block)
        qw = jnp.pad(qw, ((0, 0), (0, v_pad - queries.vocab_size)))
    with mesh:
        want = jstep(jx, queries=queries, qw=qw)
    got = tstep(tx, queries=tq)
    _assert_same(got, want)
    assert got[0].shape == (tq.batch, K)
    assert _groups(tcfg.plan_cache) == _groups(jcfg.plan_cache)
    if engine.startswith("tiled-bmp"):
        (groups,) = _groups(tcfg.plan_cache)
        assert len({len(g) for g in groups}) > 1  # several buckets
    # A certified tau carried into the next call, where a step takes one.
    if case == "pruned-bmp":
        tau = want[2]
        with mesh:
            want2 = jstep(jx, queries=queries, qw=qw, tau_init=tau)
        _assert_same(tstep(tx, queries=tq, tau_init=np.asarray(tau)), want2)


# -- several shards: emulated in threads, over gloo, and JAX's ---------------


class _Board:
    def __init__(self, size):
        self.size = size
        self.slots = [None] * size
        self.barrier = threading.Barrier(size)


class _FakeGroup:
    """A rank of a process group emulated in threads: its gather is a
    barrier over a shared board."""

    def __init__(self, rank, board):
        self.rank, self.board = rank, board

    def gather(self, x):
        b = self.board
        b.slots[self.rank] = x.clone()
        b.barrier.wait()
        out = torch.stack(b.slots)
        b.barrier.wait()
        return out


def _emulate(monkeypatch, size, run):
    """``run(group)`` on ``size`` emulated ranks at once -> each result."""
    monkeypatch.setattr(tdist, "group_rank_size",
                        lambda g: (g.rank, g.board.size))
    monkeypatch.setattr(ttopk, "gather_shards", lambda x, g: g.gather(x))
    board = _Board(size)
    results, errors = [None] * size, []

    def worker(r):
        try:
            results[r] = run(_FakeGroup(r, board))
        except BaseException as e:  # noqa: BLE001 - reraised below
            errors.append(e)
            board.barrier.abort()

    threads = [threading.Thread(target=worker, args=(r,))
               for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def _shard_run(tdocs, tq, shards, min_share=MIN_SHARE):
    return shard_run(tdocs, tq, shards, k=K, geo=GEO, min_share=min_share)


def test_four_shards_equal_jax(corpus, monkeypatch, jax_four_shards):
    tdocs, tq = _port(corpus)
    ranks = _emulate(monkeypatch, 4, _shard_run(tdocs, tq, 4))
    want = jax_four_shards()
    for out, groups in ranks:
        for name in ("ell", "fused"):
            _assert_same(out[name], [want[f"{name}_{i}"] for i in range(3)])
        n = sum(1 for key in want if key.startswith("group_"))
        assert groups == [[want[f"group_{i}"].tolist() for i in range(n)]]
    # The merge alone, on the gathered per-shard top-ks.
    ell = tdist.build_sharded_ell(tdocs, 4)
    qw = tq.to_dense()
    parts = [ttopk.local_topk(
        ell_ops.ell_gather(qw, ell.shard(s).terms, ell.shard(s).values),
        s * ell.docs_per_shard, K) for s in range(4)]
    mv, mi = ttopk.merge_gathered(torch.stack([p[0] for p in parts]),
                                  torch.stack([p[1] for p in parts]), K)
    _assert_same((mv, mi), (want["ell_0"], want["ell_1"]))


GLOO_RANK = r"""
import pickle, sys
import numpy as np, torch, torch.distributed as dist
sys.path.insert(0, %(tests)r)
from repro_torch.core.sparse import SparseBatch
from _torch_parity import shard_run

path, out, port, rank = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
d = np.load(path)
v = int(d["vocab"])
docs = SparseBatch(torch.from_numpy(d["doc_ids"]),
                   torch.from_numpy(d["doc_vals"]), v)
qs = SparseBatch(torch.from_numpy(d["q_ids"]), torch.from_numpy(d["q_vals"]),
                 v)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
try:
    res = shard_run(docs, qs, 2, k=%(K)r, geo=%(GEO)r,
                    min_share=%(TWO_RANKS_MIN_SHARE)r)(None)
finally:
    dist.destroy_process_group()
with open(out, "wb") as f:
    pickle.dump(res, f)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_ranks(saved, tmp_path_factory):
    """One spawn of two gloo ranks, each keeping only its shard, started in
    the background when first asked for -> a function that waits for
    their results."""
    import pickle

    code = GLOO_RANK % dict(tests=os.path.dirname(__file__), K=K, GEO=GEO,
                            TWO_RANKS_MIN_SHARE=TWO_RANKS_MIN_SHARE)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    tmp = tmp_path_factory.mktemp("gloo")
    outs = [tmp / f"rank{r}.pkl" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(saved), str(outs[r]), port, str(r)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]

    def result():
        logs = [p.communicate(timeout=300)[0] for p in procs]
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log
        return [pickle.loads(o.read_bytes()) for o in outs]

    yield result
    for p in procs:
        if p.poll() is None:
            p.kill()


def test_gloo_two_ranks_equal_emulation(corpus, gloo_ranks, monkeypatch):
    got = gloo_ranks()
    tdocs, tq = _port(corpus)
    want = _emulate(monkeypatch, 2,
                    _shard_run(tdocs, tq, 2, TWO_RANKS_MIN_SHARE))
    assert got[0][1] == got[1][1] == want[0][1]  # the same plan everywhere
    assert len(got[0][1][0]) > 1
    for (out, _), (ref, _) in zip(got, want):
        for name in ("ell", "fused"):
            _assert_same(out[name], ref[name])


# -- the loud errors ----------------------------------------------------------


def test_errors(corpus, one_shard):
    tdocs, tq = _port(corpus)
    _, tx = one_shard["tiled"]
    _, te = one_shard["ell"]
    two = tdist.build_sharded_ell(tdocs, 2)
    step = tdist.make_serve_step(engine="ell", k=K,
                                 docs_per_shard=two.docs_per_shard)
    with pytest.raises(ValueError, match="2 shard"):  # JAX serves shard 0
        step(two, queries=tq)
    ell = tdist.make_serve_step(engine="ell", k=K,
                                docs_per_shard=te.docs_per_shard)
    with pytest.raises(NotImplementedError, match="deleted_mask"):
        ell(te, queries=tq, deleted_mask=np.zeros(te.num_docs, bool))
    with pytest.raises(NotImplementedError, match="float32"):
        tdist.make_serve_step(engine="ell", k=K, docs_per_shard=8,
                              compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="serveable engines"):
        tdist.make_serve_step(engine="dense", k=K, docs_per_shard=8)
    csr = tdist.build_sharded_tiled(tdocs, 1, bounds_format="csr", **GEO)
    pruned = dict(engine="tiled-pruned", k=K,
                  docs_per_shard=tx.docs_per_shard)
    with pytest.raises(ValueError, match="stores CSR"):
        tdist.make_serve_step(geometry=tx.geometry(), **pruned)(
            csr, queries=tq)
    with pytest.raises(ValueError, match="stores dense"):
        tdist.make_serve_step(geometry=csr.geometry(), **pruned)(
            tx, queries=tq)
    narrow = dict(csr.geometry(), csr_row_cap=csr.csr_row_cap - 1)
    with pytest.raises(ValueError, match="csr_row_cap"):
        tdist.make_serve_step(geometry=narrow, **pruned)(csr, queries=tq)
    two_pass = tdist.make_serve_step(
        cfg=RetrievalConfig(engine="tiled-pruned", traversal="two-pass",
                            k=K), geometry=tx.geometry(), **pruned)
    with pytest.raises(ValueError, match="warm-start"):
        two_pass(tx, queries=tq, tau_init=np.zeros(tq.batch, np.float32))
    with pytest.raises(ValueError, match="holds shard 1 only"):
        two.keep_shard(1, "cpu").shard(0)


# -- snapshot_paged ----------------------------------------------------------


def test_snapshot_paged_equals_jax(corpus):
    docs, _ = corpus
    tdocs, _ = _port(corpus)
    cut = 250
    kw = dict(engine="tiled", k=K, **GEO)
    j = JRetriever(docs.slice_rows(0, cut), JConfig(**kw))
    t = Retriever(tdocs.slice_rows(0, cut), RetrievalConfig(**kw),
                  device="cpu")
    j.add_docs(docs.slice_rows(cut, docs.batch - cut))
    t.add_docs(tdocs.slice_rows(cut, tdocs.batch - cut))
    gone = np.arange(3, docs.batch, 7)
    j.delete_docs(gone)
    t.delete_docs(gone)
    with pytest.raises(NotImplementedError, match="tombstones"):
        tdist.snapshot_paged(t)
    j.compact(threshold=0.0)
    t.compact(threshold=0.0)
    (jd, jg), (td, tg) = jdist.snapshot_paged(j), tdist.snapshot_paged(t)
    np.testing.assert_array_equal(tg, jg)
    _assert_same((td.term_ids, td.values), (jd.term_ids, jd.values))
    assert td.vocab_size == jd.vocab_size
    with pytest.raises(TypeError, match="snapshot_paged"):
        tdist.build_sharded_tiled(t, 1)


# -- the serve driver ---------------------------------------------------------


@pytest.mark.parametrize("flags", [
    ["--engine", "ell"], ["--engine", "tiled-bmp-grouped"],
    ["--engine", "tiled-bmp-fused", "--bounds-format", "csr"], ["--sched"],
])
def test_serve_driver_exact_on_cpu(flags, tmp_path):
    dump = tmp_path / "obs.json"
    out = serve.main(["--device", "cpu", "--docs", "700", "--batch", "12",
                      "--vocab", "1000", "--k", "20", "--rounds", "1",
                      "--max-batch", "4", "--obs-dump", str(dump)] + flags)
    assert out["overlap"] == 1.0 and out["shards"] == 1
    spans = {e["name"] for e in json.loads(dump.read_text())["chrome_trace"]}
    assert "serve.shard_step" in spans


@pytest.mark.parametrize("flags", [
    ["--engine", "ell"], ["--engine", "tiled-bmp-fused"], ["--sched"],
])
def test_serve_driver_oracle_in_ranges(flags, monkeypatch):
    """The driver's float64 oracle a range of 7 docs at a time
    (``scoring._ORACLE_ELEMS`` lowered) gives the overlap of the one-shot
    oracle: 1.0, as ``test_serve_driver_exact_on_cpu`` holds it."""
    from repro_torch.core import scoring as tscoring

    argv = ["--device", "cpu", "--docs", "700", "--batch", "12", "--vocab",
            "1000", "--k", "20", "--rounds", "1", "--max-batch", "4"]
    calls = []
    ranged = tscoring.topk_f64

    def counted(queries, docs, k):
        calls.append(docs.batch)
        return ranged(queries, docs, k)

    monkeypatch.setattr(tscoring, "_ORACLE_ELEMS", 12 * 7)
    monkeypatch.setattr(tscoring, "topk_f64", counted)
    out = serve.main(argv + flags)
    assert calls == [700]
    assert out["overlap"] == 1.0 and out["shards"] == 1


def test_serve_driver_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--docs", "50", "--batch", "2"])
