"""The CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and ``nvcc`` and skip without them.  The
file imports no JAX, so it runs on a machine that has only the port's
dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerance: max |kernel - plain| <= 1e-5 * max |plain| — the same f32
products summed in another order.  ``scatter_score`` and ``ell_gather``
also repeat bit for bit on every route (sparse and dense query tiles), and
the two routes give the same bits.  The ``bmp_scan`` sweep must also fetch
exactly the plain version's blocks and chunks in the same number of steps,
on every route and cluster split, and repeat bit for bit.
``splade_head`` sums d-long dot products in another order; its max over
tokens is exact (the kernel multiplies in 3xTF32 on the tensor cores, which
keeps f32 accuracy, and skips the rows of mask 0).  ``flash_attention`` in
f32 (the SIMT route): atol = rtol = 2e-5 (the JAX package's bar for this
kernel); in bf16 (the wgmma route) both versions compute in f32 and round
once, so within one bf16 ulp of the output plus that f32 bar.
``embedding_bag``: atol = rtol = 1e-5 of the plain version (an f32 sum of
at most a few products, in another order), bitwise equal between launches,
between its routes (the lane vectors a table allows) and, for unweighted
bags, to the sequential f32 sum over l.  The comparison engines (no
kernel of their own): ``segment`` bit for bit its CPU run, ``bcoo``
(cuSPARSE) within TOL of its CPU run, both within 1e-5 of float64; the
``FlatIndex`` built on the card equal to the CPU build.  The MoE layer
(plain PyTorch) on the card within TOL of its CPU run, with the same
expert ids and drops; the data-parallel step under an NCCL group of one
bit for bit ``make_train_step``.  The bf16 routes of ``scatter_score``,
``ell_gather`` and ``bmp_scan``: bitwise the f32 route on the rounded
inputs rounded once (the exact two), each score within one bf16 ulp of the
plain version's; the six bf16 sharded steps on the card against the same
step on the CPU the same way (``_torch_parity.assert_bf16_topk``), the
pruned ones the bf16 ``tiled`` step's bits.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import index as tidx
from repro_torch.core import scoring
from repro_torch.core.engine import RetrievalConfig, RetrievalEngine
from repro_torch.data.synthetic import make_msmarco_like, make_topical_corpus
from repro_torch.kernels.bmp_scan import ops as bmp_ops
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_ref,
                                                  sequential_bag_sum)
from repro_torch.kernels.bmp_scan.ref import bmp_sweep_ref
from repro_torch.kernels import query_tiles
from repro_torch.kernels.ell_gather import ops as ell_ops
from repro_torch.kernels.ell_gather.ref import ell_gather_ref
from repro_torch.kernels.scatter_score import ops as scatter_ops
from repro_torch.kernels.scatter_score.ref import scatter_score_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.splade_head import ops as head_ops
from repro_torch.kernels.splade_head.ref import splade_head_ref

TOL = 1e-5
BF = torch.bfloat16


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want):
    """Within TOL of max |want| where finite; the same infinities."""
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert torch.equal(got[~fin], want[~fin])
    if fin.any():
        err = (got[fin] - want[fin]).abs().max().item()
        assert err <= TOL * want[fin].abs().max().item(), err


def _tiled_args(t):
    return (t.local_term, t.local_doc, t.value, t.chunk_term_block,
            t.chunk_doc_block)


@pytest.mark.parametrize("tb,db,cs,b", [(512, 256, 512, 70),
                                        (512, 256, 512, 300),
                                        (512, 128, 64, 64),
                                        (128, 32, 256, 3)])
def test_scatter_score_kernel_matches_plain(cuda, tb, db, cs, b):
    c = make_msmarco_like(3001, b, vocab_size=5000, seed=tb + db,
                          device=cuda)
    t = tidx.build_tiled_index(c.docs, tb, db, cs)
    qw = torch.nn.functional.pad(c.queries.to_dense(),
                                 (0, t.num_term_blocks * tb - c.vocab_size))
    # the index, and a tile-skipped one whose zeroing chunks are blanked
    for ix in (t, tidx.filter_tiled_index(t, c.queries.slice_rows(0, 1))):
        before = scatter_ops.launches
        got = scatter_ops.scatter_score(
            qw, *_tiled_args(ix), ix.block_chunk_start, ix.block_chunk_count,
            term_block=tb, doc_block=db, num_doc_blocks=ix.num_doc_blocks)
        assert scatter_ops.launches == before + 1
        want = scatter_score_ref(qw, *_tiled_args(ix), ix.block_chunk_start,
                                 ix.block_chunk_count, term_block=tb,
                                 doc_block=db,
                                 num_doc_blocks=ix.num_doc_blocks)
        _close(got, want)


@pytest.mark.parametrize("b", [1, 64, 130])
def test_ell_gather_kernel_matches_plain(cuda, b):
    c = make_msmarco_like(2999, b, vocab_size=5000, seed=b, device=cuda)
    e = tidx.build_ell_index(c.docs)
    qw = c.queries.to_dense()
    before = ell_ops.launches
    got = ell_ops.ell_gather(qw, e.terms, e.values)
    assert ell_ops.launches == before + 1
    _close(got, ell_gather_ref(qw, e.terms, e.values))


def _query_cases(cuda, sparse, width):
    """The query weights [B, width] each route must take: the corpus's
    sparse queries, nearly dense ones (the dense route), all zero, one
    nonzero query a tile of 128, and (B > 128) sparse tiles before a dense
    last one."""
    b = sparse.shape[0]
    sparse = torch.nn.functional.pad(sparse, (0, width - sparse.shape[1]))
    g = torch.Generator(device=cuda).manual_seed(b)
    dense = torch.rand((b, width), generator=g, device=cuda)
    dense = torch.where(dense > 0.1, dense, 0.0)
    one = torch.zeros_like(sparse)
    one[::128] = sparse[::128]
    cases = {"sparse": sparse, "dense": dense, "zero": torch.zeros_like(sparse),
             "one a tile": one}
    if b > 128:
        mixed = sparse.clone()
        mixed[(b - 1) // 128 * 128:] = dense[(b - 1) // 128 * 128:]
        cases["dense last tile"] = mixed
    return cases


@pytest.mark.parametrize("b", [1, 129, 500])
@pytest.mark.parametrize("tb,db,cs", [(512, 256, 512), (256, 32, 64)])
def test_scatter_score_routes_on_the_card(cuda, b, tb, db, cs):
    """Sparse and dense tiles, all-zero and one-query tiles, full and
    partial runs (chunk_size < term_block in the second geometry): within
    TOL of the plain version, and two launches bitwise equal."""
    c = make_msmarco_like(2500, b, vocab_size=4000, seed=b, device=cuda)
    t = tidx.build_tiled_index(c.docs, tb, db, cs)
    keep = (torch.arange(t.num_doc_blocks, device=cuda) % 3 != 1).int()
    kw = dict(term_block=tb, doc_block=db, num_doc_blocks=t.num_doc_blocks)
    for name, qw in _query_cases(cuda, c.queries.to_dense(),
                                 t.num_term_blocks * tb).items():
        for count in (t.block_chunk_count, t.block_chunk_count * keep):
            args = (qw, *_tiled_args(t), t.block_chunk_start, count)
            got = scatter_ops.scatter_score(*args, **kw)
            again = scatter_ops.scatter_score(*args, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, again), name
            _close(got, scatter_score_ref(*args, **kw))
            if name == "zero":
                assert not got.any()


@pytest.mark.parametrize("b", [1, 129, 500])
def test_ell_gather_routes_on_the_card(cuda, b):
    """The same query cases through ell_gather (padding ids equal to the
    vocabulary size)."""
    c = make_msmarco_like(2500, b, vocab_size=4000, seed=b + 7, device=cuda)
    e = tidx.build_ell_index(c.docs)
    assert bool((e.terms == 4000).any())
    for name, qw in _query_cases(cuda, c.queries.to_dense(), 4000).items():
        got = ell_ops.ell_gather(qw, e.terms, e.values)
        again = ell_ops.ell_gather(qw, e.terms, e.values)
        torch.cuda.synchronize()
        assert torch.equal(got, again), name
        _close(got, ell_gather_ref(qw, e.terms, e.values))
        if name == "zero":
            assert not got.any()


def _route_cases(cuda):
    """129 sparse queries (a tile of 128 and a ragged one), the tiled and
    ELL indexes, and each kernel's call on given query weights."""
    c = make_msmarco_like(2500, 129, vocab_size=4000, seed=5, device=cuda)
    t = tidx.build_tiled_index(c.docs, 512, 256, 512)
    e = tidx.build_ell_index(c.docs)
    width = {"scatter_score": t.num_term_blocks * 512, "ell_gather": 4000}
    calls = {
        "scatter_score": lambda qw: scatter_ops.scatter_score(
            qw, *_tiled_args(t), t.block_chunk_start, t.block_chunk_count,
            term_block=512, doc_block=256, num_doc_blocks=t.num_doc_blocks),
        "ell_gather": lambda qw: ell_ops.ell_gather(qw, e.terms, e.values),
    }
    return c.queries.to_dense(), width, calls


@pytest.mark.parametrize("kernel", ["scatter_score", "ell_gather"])
def test_routes_give_the_same_bits_on_the_card(cuda, kernel, monkeypatch):
    """The same query rows through the sparse route and the dense one (every
    tile forced dense, and rows put into a tile of dense rows) give the
    same bits."""
    qw, width, calls = _route_cases(cuda)
    qw = torch.nn.functional.pad(qw, (0, width[kernel] - qw.shape[1]))
    call = calls[kernel]
    assert not query_tiles.pack_query_tiles(qw)[3].any()
    sparse = call(qw)
    g = torch.Generator(device=cuda).manual_seed(3)
    mixed = torch.rand(qw.shape, generator=g, device=cuda)
    mixed = torch.where(mixed > 0.1, mixed, 0.0)
    mixed[:5], mixed[128] = qw[:5], qw[128]
    assert query_tiles.pack_query_tiles(mixed)[3].tolist() == [1, 0]
    in_dense_tile = call(mixed)
    monkeypatch.setattr(query_tiles, "DENSE_SHARE", 0.0)
    assert query_tiles.pack_query_tiles(qw)[3].all()
    dense = call(qw)
    torch.cuda.synchronize()
    assert torch.equal(sparse, dense)
    assert torch.equal(sparse[:5], in_dense_tile[:5])
    assert torch.equal(sparse[128], in_dense_tile[128])


@pytest.mark.parametrize("engine", ["tiled-pruned", "tiled-bmp-grouped",
                                    "tiled-bmp-fused"])
def test_dense_route_keeps_the_pruned_engines_bits(cuda, engine, monkeypatch):
    """``tiled`` with every query tile on scatter_score's dense route gives
    the pruned engines' bits, as its sparse route does."""
    c = make_topical_corpus(3000, 24, vocab_size=4000, num_topics=8,
                            topic_vocab=300, seed=2, device=cuda)
    geo = dict(k=20, term_block=256, doc_block=32, chunk_size=64)
    tiled = RetrievalEngine(c.docs, RetrievalConfig(engine="tiled", **geo),
                            device=cuda)
    eng = RetrievalEngine(c.docs, RetrievalConfig(engine=engine, **geo),
                          device=cuda)
    v, i = eng.search(c.queries)
    monkeypatch.setattr(query_tiles, "DENSE_SHARE", 0.0)
    exact = tiled.search(c.queries)
    assert (v == exact[0]).all() and (i == exact[1]).all()


def test_cuda_tensors_never_reach_the_plain_version(cuda, monkeypatch):
    """A CUDA tensor goes to the kernel or raises; a bad operand raises
    before any launch."""
    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(scatter_ops, "scatter_score_ref", boom)
    monkeypatch.setattr(ell_ops, "ell_gather_ref", boom)
    monkeypatch.setattr(bmp_ops, "bmp_sweep_ref", boom)
    c = make_msmarco_like(500, 8, vocab_size=2000, seed=1, device=cuda)
    for name in ("tiled", "ell", "tiled-pruned", "tiled-bmp-fused"):
        v, i = RetrievalEngine(c.docs, RetrievalConfig(engine=name, k=10),
                               device=cuda).search(c.queries)
        assert v.shape == (8, 10)
    e = tidx.build_ell_index(c.docs)
    with pytest.raises(TypeError):
        ell_ops.ell_gather(c.queries.to_dense(), e.terms.long(), e.values)


def test_scatter_score_kernel_honours_partial_runs(cuda):
    """Runs over a subset of blocks: the kernel scores those blocks as the
    full runs do and leaves 0 elsewhere, as its plain version."""
    c = make_msmarco_like(2001, 16, vocab_size=3000, seed=3, device=cuda)
    t = tidx.build_tiled_index(c.docs, 256, 32, 64)
    qw = torch.nn.functional.pad(c.queries.to_dense(),
                                 (0, t.num_term_blocks * 256 - 3000))
    keep = torch.arange(t.num_doc_blocks, device=cuda) % 3 == 1
    count = t.block_chunk_count * keep.int()
    args = (qw, *_tiled_args(t), t.block_chunk_start)
    kw = dict(term_block=256, doc_block=32, num_doc_blocks=t.num_doc_blocks)
    got = scatter_ops.scatter_score(*args, count, **kw)
    full = scatter_ops.scatter_score(*args, t.block_chunk_count, **kw)
    cols = keep.repeat_interleave(32)
    assert torch.equal(got[:, cols], full[:, cols])
    assert not got[:, ~cols].any()
    _close(got, scatter_score_ref(*args, count, **kw))


def _sweep_inputs(cuda, n_docs, b, db, k, cs=64, seed=0):
    c = make_topical_corpus(n_docs, b, vocab_size=4000, num_topics=8,
                            topic_vocab=300, seed=seed, device=cuda)
    docs, _ = tidx.reorder_docs(c.docs, "df-signature")
    t = tidx.build_tiled_index(docs, 256, db, cs, store_term_block_max=True)
    qw = scoring._pad_queries_to_term_blocks(c.queries, t)
    ub = scoring.block_upper_bounds(c.queries, t, qw=qw)
    order = torch.argsort(-ub, dim=-1, stable=True)
    return t, qw, order.int(), ub.gather(-1, order)


def _runs(t):
    return (t.block_chunk_start, t.block_chunk_count, t.chunk_term_block,
            t.chunk_doc_block, t.local_term, t.local_doc, t.value)


@pytest.mark.parametrize("db,k,groups,theta,warm,dead,pad_to,weights", [
    (16, 5, [[0, 1, 2], [3], [4, 5, 6, 7]], 1.0, False, False, 0, None),
    (64, 40, [[0, 1, 2, 3, 4, 5, 6, 7]], 0.8, True, True, 0, None),
    (32, 10, [list(range(40))], 1.0, False, True, 0, None),  # 64 rows
    # Every route and the cluster split: b = 1 over more groups than SMs
    # (small route, no cluster), b = 1, 2, 3 and 8 over few groups (small
    # route, a cluster a group), b = 9 (wide, 32-row tile), b = 64 and
    # 256 (wide, 128-row tile, cluster).  "holes": the first group's rows
    # lose every weight of term block 0 (demanded by every row) and the
    # last group's first row is all zero; "dense": every term has a weight
    # (8 rows x 4,096 terms: the packed weights stay in device memory).
    (32, 10, [[i] for i in range(140)], 1.0, True, True, 0, "holes"),
    (16, 5, [[0]], 0.8, False, False, 0, "holes"),
    (32, 10, [[0, 1], [2, 3], [4, 5]], 0.8, True, False, 0, "holes"),
    (64, 20, [[0, 1, 2], [3, 4, 5]], 1.0, False, True, 3, "holes"),
    (16, 5, [list(range(8))], 1.0, True, True, 0, None),
    (32, 10, [list(range(8)), list(range(8, 16))], 1.0, False, True, 0,
     "dense"),
    (32, 10, [list(range(9)), list(range(9, 18))], 0.8, False, True, 9,
     "holes"),
    (64, 40, [list(range(64))], 1.0, True, False, 0, "holes"),
    (32, 10, [list(range(256))], 1.0, False, True, 0, None),
])
def test_bmp_sweep_kernel_matches_plain(cuda, db, k, groups, theta, warm,
                                        dead, pad_to, weights):
    size = pad_to or max(1 << (len(g) - 1).bit_length() for g in groups)
    _check_sweep(cuda, db, k, groups, theta, warm, dead, pad_to, weights, 64,
                 "small" if size <= bmp_ops.SMALL_MAX_ROWS else "wide")


@pytest.mark.parametrize("cs,groups,weights", [
    (1024, [[0], [1], [2, 3]], "holes"),  # over four 128-slot loads
    (50, [[0, 1, 2], [3, 4]], None),  # not a whole number of 16-byte pieces
])
def test_bmp_sweep_small_groups_go_wide_where_the_small_route_cannot(
        cuda, cs, groups, weights):
    _check_sweep(cuda, 32, 10, groups, 0.8, True, True, 0, weights, cs,
                 "wide")


def _check_sweep(cuda, db, k, groups, theta, warm, dead, pad_to, weights, cs,
                 route_name):
    b = max(max(g) for g in groups) + 1
    t, qw, order, ub_sorted = _sweep_inputs(cuda, 1500, b, db, k, cs)
    if weights == "holes":  # the bounds stay upper bounds: weights drop
        qw = qw.clone()
        qw[groups[0], :256] = 0.0
        qw[groups[-1][0]] = 0.0
    elif weights == "dense":  # both versions run the same schedule
        g = torch.Generator(device=cuda).manual_seed(7)
        qw = qw + 0.01 * torch.rand(qw.shape, generator=g, device=cuda)
    size = pad_to or max(1 << (len(g) - 1).bit_length() for g in groups)
    sel = torch.tensor([g + [0] * (size - len(g)) for g in groups],
                       device=cuda)
    tau0 = torch.full(sel.shape, float("-inf"), device=cuda)
    if warm:
        tau0[:, 0] = 2.0
    for i, g in enumerate(groups):
        tau0[i, len(g):] = 3.4e38 / 4  # PAD_TAU
    alive = None
    if dead:
        alive = torch.ones(t.num_docs, dtype=torch.bool, device=cuda)
        alive[::7] = False
    kw = dict(term_block=256, doc_block=db, k_eff=k, theta=theta,
              num_docs=t.num_docs)
    before = bmp_ops.launches
    got = bmp_ops.bmp_sweep(qw[sel], order[sel], ub_sorted[sel], tau0,
                            *_runs(t), alive, **kw)
    assert bmp_ops.launches == before + 1
    route = bmp_ops.last_route
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert route.name == route_name
    assert (route.cluster > 1) == (len(groups) < sms)
    # Only the small route stages packed weights, unless they are too many.
    assert route.weights_in_smem == (route.name == "small"
                                     and weights != "dense")
    torch.cuda.synchronize()
    for gi in range(len(groups)):
        want = bmp_sweep_ref(qw[sel[gi]], order[sel[gi]],
                             ub_sorted[sel[gi]], tau0[gi], *_runs(t), alive,
                             **kw)
        _close(got[0][gi], want[0])
        _close(got[1][gi], want[1])
        assert torch.equal(got[2][gi].bool(), want[2])
        assert torch.equal(got[3][gi].bool(), want[3])
        assert int(got[4][gi, 0]) == want[4]


@pytest.mark.parametrize("rows,n_groups", [(1, 140), (2, 3), (1, 1),
                                           (64, 1), (16, 140)])
def test_bmp_sweep_kernel_is_deterministic(cuda, rows, n_groups):
    b = rows * n_groups
    t, qw, order, ub_sorted = _sweep_inputs(cuda, 1500, b, 32, 10, seed=4)
    sel = torch.arange(b, device=cuda).reshape(n_groups, rows)
    tau0 = torch.full(sel.shape, float("-inf"), device=cuda)
    kw = dict(term_block=256, doc_block=32, k_eff=10, theta=1.0,
              num_docs=t.num_docs)
    args = (qw[sel], order[sel], ub_sorted[sel], tau0, *_runs(t))
    first = bmp_ops.bmp_sweep(*args, **kw)
    second = bmp_ops.bmp_sweep(*args, **kw)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.parametrize("engine", ["tiled-pruned", "tiled-bmp-grouped",
                                    "tiled-bmp-fused"])
@pytest.mark.parametrize("reorder", [False, True])
def test_pruned_engines_on_the_card_match_tiled(cuda, engine, reorder):
    c = make_topical_corpus(3000, 24, vocab_size=4000, num_topics=8,
                            topic_vocab=300, seed=2, device=cuda)
    geo = dict(k=20, term_block=256, doc_block=32, chunk_size=64)
    exact = RetrievalEngine(c.docs, RetrievalConfig(engine="tiled", **geo),
                            device=cuda).search(c.queries)
    eng = RetrievalEngine(c.docs, RetrievalConfig(
        engine=engine, reorder_docs=reorder, reorder_method="df-signature",
        **geo), device=cuda)
    before = bmp_ops.launches
    v, i = eng.search(c.queries)
    assert bmp_ops.launches > before
    if reorder:  # other blocks, so sums in another order
        torch.testing.assert_close(torch.from_numpy(v),
                                   torch.from_numpy(exact[0]))
    else:  # scored blocks carry scatter_score's very bits (the same fold)
        assert (v == exact[0]).all() and (i == exact[1]).all()


@pytest.mark.parametrize("b,t,d,v,layout", [
    (3, 37, 64, 1000, "contiguous"),  # ragged T and V
    (2, 130, 96, 513, "embed.T"),  # T over three token tiles
    (1, 64, 768, 30522, "embed.T"),  # B = 1 at the encoder's width
    (4, 200, 768, 2000, "contiguous"),
    (2, 7, 64, 257, "embed.T"),
])
def test_splade_head_kernel_matches_plain(cuda, b, t, d, v, layout):
    g = torch.Generator(device=cuda).manual_seed(b * t + v)
    h = torch.randn(b, t, d, generator=g, device=cuda)
    mask = (torch.rand(b, t, generator=g, device=cuda) > 0.3).float()
    mask[:, 1::3] *= 0.5  # a fractional mask
    if b > 1:
        mask[-1] = 0.0  # an all-zero row
    embed = torch.randn(v, d, generator=g, device=cuda) * 0.05
    w = embed.T if layout == "embed.T" else embed.T.contiguous()
    bias = torch.randn(v, generator=g, device=cuda) * 0.1
    before = head_ops.launches
    got = head_ops.splade_head(h, mask, w, bias)
    assert head_ops.launches == before + 1
    _close(got, splade_head_ref(h, mask, w, bias))
    assert torch.equal(got, head_ops.splade_head(h, mask, w, bias))
    if b > 1:
        assert not got[-1].any()


@pytest.mark.parametrize("layout", ["embed.T", "contiguous"])
@pytest.mark.parametrize("t,valid", [
    (64, (8, 64, 0, 33, 17, 1, 63, 40)),  # the encode path's mix, and none
    (200, (130, 0, 200, 64)),  # more valid rows than one 64-row chunk
])
def test_splade_head_kernel_skips_masked_rows(cuda, layout, t, valid):
    b, d, v = len(valid), 768, 4099
    g = torch.Generator(device=cuda).manual_seed(t + v)
    h = torch.randn(b, t, d, generator=g, device=cuda)
    mask = (torch.arange(t, device=cuda)[None, :]
            < torch.tensor(valid, device=cuda)[:, None]).float()
    embed = torch.randn(v, d, generator=g, device=cuda) * 0.05
    w = embed.T if layout == "embed.T" else embed.T.contiguous()
    bias = torch.randn(v, generator=g, device=cuda) * 0.1
    before = head_ops.launches
    got = head_ops.splade_head(h, mask, w, bias)
    assert head_ops.launches == before + 1
    _close(got, splade_head_ref(h, mask, w, bias))
    assert torch.equal(got, head_ops.splade_head(h, mask, w, bias))
    assert not got[valid.index(0)].any()  # no valid token: every term is 0


def test_encoder_on_the_card_goes_through_the_kernel(cuda, monkeypatch):
    from repro_torch.configs.gpusparse import ENCODER_SMOKE
    from repro_torch.models.splade import SpladeEncoder

    enc = SpladeEncoder(ENCODER_SMOKE, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(1)
    tokens = torch.randint(0, ENCODER_SMOKE.vocab_size, (5, 40),
                           generator=g, device=cuda)
    mask = (torch.rand(5, 40, generator=g, device=cuda) > 0.2).float()
    with pytest.raises(RuntimeError, match="backward"):
        enc.encode(tokens, mask, use_kernel=True)
    with torch.inference_mode():
        want = enc.encode(tokens, mask)

        def boom(*a, **k):
            raise AssertionError("plain version called on a CUDA tensor")

        monkeypatch.setattr(head_ops, "splade_head_ref", boom)
        before = head_ops.launches
        got = enc.encode(tokens, mask, use_kernel=True)
    assert head_ops.launches == before + 1
    _close(got, want)


def _flash_within(got, want):
    """f32: atol = rtol = 2e-5; bf16: one bf16 ulp of the output on top
    (|x| in [2^(e-1), 2^e) has a bf16 ulp of 2^(e-8))."""
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    bar = 2e-5 * (1 + w.abs())
    if got.dtype == torch.bfloat16:
        big = torch.maximum(g.abs(), w.abs())
        bar = bar + torch.ldexp(torch.ones_like(big),
                                torch.frexp(big).exponent - 8)
    err = (g - w).abs()
    assert torch.isfinite(g).all() and (err <= bar).all(), float(err.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,dh,causal,window", [
    (2, 64, 4, 2, 64, True, None),
    (1, 200, 14, 2, 64, True, None),  # qwen2-0.5b's heads, ragged S
    (2, 130, 6, 3, 64, True, 24),  # window across tile edges
    (1, 96, 8, 1, 64, True, None),  # MQA
    (2, 77, 4, 4, 64, False, None),
    (1, 300, 32, 8, 128, True, None),  # Dh 128, ragged S
    (1, 150, 32, 8, 128, False, 40),
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, b, s, hq, hkv,
                                              dh, causal, window):
    g = torch.Generator(device=cuda).manual_seed(s * hq + dh)
    q, k, v = (torch.randn(b, s, h, dh, generator=g, device=cuda).to(dtype)
               for h in (hq, hkv, hkv))
    before = flash_ops.launches
    got = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    assert flash_ops.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, s, hq, dh)
    _flash_within(got, flash_attention_ref(q, k, v, causal, window))
    assert torch.equal(got, flash_ops.flash_attention(q, k, v, causal=causal,
                                                      window=window))


@pytest.mark.parametrize("b,sq,skv,hq,hkv,dh,causal,window", [
    (1, 257, 257, 14, 2, 64, True, None),  # qwen2-0.5b's heads, ragged tile
    (2, 129, 129, 4, 1, 128, True, 70),  # Dh 128, MQA, a window
    (1, 333, 333, 8, 8, 64, False, 100),  # not causal, a window
    (2, 64, 64, 2, 1, 128, False, None),
    (1, 1, 1, 4, 2, 64, True, None),  # one row
    (1, 100, 300, 6, 2, 64, False, None),  # more keys than queries
    (1, 300, 100, 6, 2, 128, True, None),  # rows past the last key
    (1, 4096, 4096, 32, 8, 128, True, None),  # qwen3-4b's heads (qk_norm)
    (1, 8192, 8192, 48, 8, 128, True, 4096),  # mixtral-8x22b's window
])
def test_flash_attention_bf16_route(cuda, b, sq, skv, hq, hkv, dh, causal,
                                    window):
    """The bf16 wgmma route against the plain version: one launch,
    deterministic, within FLASH_TOL plus one bf16 ulp."""
    g = torch.Generator(device=cuda).manual_seed(sq * hq + skv + dh)
    q = torch.randn(b, sq, hq, dh, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(b, skv, hkv, dh, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    before = flash_ops.launches
    got = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    assert flash_ops.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (b, sq, hq, dh)
    _flash_within(got, flash_attention_ref(q, k, v, causal, window))
    assert torch.equal(got, flash_ops.flash_attention(q, k, v, causal=causal,
                                                      window=window))


@pytest.mark.parametrize("dh", [64, 128])
def test_flash_attention_f32_takes_the_simt_route(cuda, dh):
    """An f32 call runs the f32 kernel: within FLASH_TOL of the plain
    version and of a float64 softmax, with no bf16 allowance."""
    g = torch.Generator(device=cuda).manual_seed(dh)
    q = torch.randn(1, 300, 14, dh, generator=g, device=cuda)
    k, v = (torch.randn(1, 300, 2, dh, generator=g, device=cuda)
            for _ in range(2))
    before = flash_ops.launches
    got = flash_ops.flash_attention(q, k, v, window=120)
    assert flash_ops.launches == before + 1 and got.dtype == torch.float32
    _flash_within(got, flash_attention_ref(q, k, v, True, 120))
    qd, kd, vd = (x.double().transpose(1, 2) for x in (q, k, v))
    kd, vd = (x.repeat_interleave(7, dim=1) for x in (kd, vd))
    pos = torch.arange(300, device=cuda)
    vis = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < 120)
    logits = (qd @ kd.transpose(-1, -2) / dh ** 0.5).masked_fill(
        ~vis, float("-inf"))
    exact = (torch.softmax(logits, -1) @ vd).transpose(1, 2)
    _flash_within(got, exact.float())


def test_flash_attention_reads_strided_heads(cuda):
    """q, k, v as views of one fused [B, S, Hq + 2 Hkv, Dh] projection."""
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(2, 100, 14 + 4, 64, generator=g, device=cuda)
    q, k, v = qkv[:, :, :14], qkv[:, :, 14:16], qkv[:, :, 16:]
    got = flash_ops.flash_attention(q, k, v)
    _flash_within(got, flash_attention_ref(q.contiguous(), k.contiguous(),
                                           v.contiguous()))


def test_flash_attention_bf16_reads_strided_heads(cuda):
    """The bf16 route's TMA maps over views of one fused [B, S, Hq + 2 Hkv,
    Dh] projection (head stride Dh, row stride (Hq + 2 Hkv) Dh)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    qkv = torch.randn(2, 150, 14 + 4, 64, generator=g,
                      device=cuda).bfloat16()
    q, k, v = qkv[:, :, :14], qkv[:, :, 14:16], qkv[:, :, 16:]
    got = flash_ops.flash_attention(q, k, v, window=100)
    _flash_within(got, flash_attention_ref(q.contiguous(), k.contiguous(),
                                           v.contiguous(), True, 100))


def test_flash_attention_refuses_what_it_cannot_run(cuda):
    q = torch.randn(1, 64, 4, 64, device=cuda, requires_grad=True)
    k = torch.randn(1, 64, 2, 64, device=cuda)
    before = flash_ops.launches
    with pytest.raises(RuntimeError, match="backward"):
        flash_ops.flash_attention(q, k, k)
    q = q.detach()
    with pytest.raises(TypeError):
        flash_ops.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(TypeError):
        flash_ops.flash_attention(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(ValueError, match="Dh"):
        flash_ops.flash_attention(q[..., :32].contiguous(),
                                  k[..., :32].contiguous(),
                                  k[..., :32].contiguous())
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q, torch.randn(1, 64, 3, 64, device=cuda),
                                  torch.randn(1, 64, 3, 64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        flash_ops.flash_attention(q.transpose(1, 3).contiguous().transpose(
            1, 3), k, k)
    assert flash_ops.launches == before


def test_lm_prefill_on_the_card_goes_through_the_kernel(cuda, monkeypatch):
    import dataclasses

    from repro_torch.configs.qwen2_0_5b import FULL
    from repro_torch.models.transformer import TransformerLM

    # qwen2-0.5b's head geometry (Dh 64, a group of 7), narrow and shallow
    cfg = dataclasses.replace(FULL, n_layers=2, d_model=448, n_heads=7,
                              n_kv_heads=1, d_ff=256, vocab_size=512,
                              dtype="float32")
    lm = TransformerLM(cfg, device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, 512, (2, 90), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    with pytest.raises(RuntimeError, match="backward"):
        lm.prefill(tokens)
    with torch.inference_mode():
        want = lm.prefill(tokens, use_kernel=False)

        def boom(*a, **k):
            raise AssertionError("plain version called on a CUDA tensor")

        monkeypatch.setattr(flash_ops, "flash_attention_ref", boom)
        before = flash_ops.launches
        got = lm.prefill(tokens)
    assert flash_ops.launches == before + cfg.n_layers
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,l,v,d,weighted,offset", [
    (7, 1, 50, 10, False, 0), (7, 1, 50, 10, True, 0),
    (130, 5, 1000, 18, False, 0), (130, 5, 1000, 18, True, 0),
    (130, 8, 1000, 16, True, 0), (130, 8, 1000, 7, True, 0),
    (130, 8, 1000, 16, True, 1),  # a view only 4-byte aligned
])
def test_embedding_bag_kernel_matches_plain(cuda, n, l, v, d, weighted,
                                            offset):
    g = torch.Generator(device=cuda).manual_seed(n + v)
    ids = torch.randint(-1, v + 20, (n, l), generator=g, device=cuda,
                        dtype=torch.int32)  # pads and ids at or past V
    ids[0] = -1  # an all-pad bag
    ids[1, 1:] = ids[1, 0].clone()  # duplicate ids
    store = torch.randn(v * d + offset, generator=g, device=cuda)
    table = store[offset:].view(v, d)
    w = torch.randn(n, l, generator=g, device=cuda) if weighted else None
    before = bag_ops.launches
    got = bag_ops.embedding_bag(ids, table, w)
    assert bag_ops.launches == before + 1
    if offset:
        assert bag_ops.pick_route(d, l, table.data_ptr(), ids.data_ptr(),
                                  None if w is None else w.data_ptr())[0] == 1
    assert got.shape == (n, d) and not got[0].any()
    torch.testing.assert_close(got, embedding_bag_ref(ids, w, table),
                               rtol=TOL, atol=TOL)
    assert torch.equal(got, bag_ops.embedding_bag(ids, table, w))


def _at_offset(t, nbytes):
    """A copy of ``t`` whose data starts ``nbytes`` past a 16-byte boundary
    (the alignment that makes the entry pick a narrower route)."""
    k = nbytes // t.element_size()
    store = t.new_empty(t.numel() + 4)  # the allocator aligns to 512 B
    view = store[k:k + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == nbytes
    return view


@pytest.mark.parametrize("d,l", [(16, 8), (10, 8), (18, 8), (7, 8),
                                 (10, 6), (16, 5), (10, 20)])
def test_embedding_bag_routes_give_the_same_bits_on_the_card(cuda, d, l):
    """Every route (vec, ivec) the shape allows, reached by copying the same
    values to 0-, 8- and 4-byte offsets, with weights and without, gives
    the same bits; unweighted, the sequential f32 fold's."""
    v, n = 3000, 1500
    g = torch.Generator(device=cuda).manual_seed(d + l)
    ids = torch.randint(-1, v + 20, (n, l), generator=g, device=cuda,
                        dtype=torch.int32)  # pads and ids at or past V
    ids[2] = -1  # an all-pad bag
    ids[3, 1:] = ids[3, 0].clone()  # duplicate ids
    table = torch.randn(v, d, generator=g, device=cuda)
    w = torch.randn(n, l, generator=g, device=cuda)
    vecs = 3 if d % 4 == 0 else 2 if d % 2 == 0 else 1
    ivecs = 2 if l % 2 == 0 else 1
    for weights in (None, w):
        runs = {}
        for toff in (0, 8, 4):
            for ioff in (0, 8, 4):
                i, t = _at_offset(ids, ioff), _at_offset(table, toff)
                wt = None if weights is None else _at_offset(weights, ioff)
                route = bag_ops.pick_route(d, l, t.data_ptr(), i.data_ptr(),
                                           None if wt is None
                                           else wt.data_ptr())
                if route not in runs:
                    runs[route] = bag_ops.embedding_bag(i, t, wt)
        assert len(runs) == vecs * ivecs  # every route reached
        first = runs.pop(max(runs))
        for got in runs.values():
            assert torch.equal(got, first)
        if weights is None:
            assert torch.equal(first, sequential_bag_sum(ids, table))
        torch.testing.assert_close(first,
                                   embedding_bag_ref(ids, weights, table),
                                   rtol=TOL, atol=TOL)


def test_embedding_bag_refuses_what_it_cannot_run(cuda):
    ids = torch.zeros((4, 3), dtype=torch.int32, device=cuda)
    table = torch.randn(10, 10, device=cuda, requires_grad=True)
    before = bag_ops.launches
    with pytest.raises(RuntimeError, match="backward"):
        bag_ops.embedding_bag(ids, table)
    table = table.detach()
    with pytest.raises(TypeError):
        bag_ops.embedding_bag(ids.long(), table)
    with pytest.raises(TypeError):
        bag_ops.embedding_bag(ids, table.double())
    with pytest.raises(ValueError, match="contiguous"):
        bag_ops.embedding_bag(ids, table.T)
    with pytest.raises(ValueError):
        bag_ops.embedding_bag(ids, table, torch.ones(4, 2, device=cuda))
    assert bag_ops.launches == before


def test_xdeepfm_forward_on_the_card_goes_through_the_kernel(cuda,
                                                            monkeypatch):
    """xDeepFM at full width (the 16.6M-row Criteo-39 table) on a multi-hot
    batch: one launch a forward, the plain path's logits."""
    from repro_torch.configs.xdeepfm import FULL
    from repro_torch.data.synthetic import make_recsys_batch
    from repro_torch.models.recsys import build_model

    model = build_model(FULL, device=cuda)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in make_recsys_batch(
        64, FULL.n_sparse, FULL.vocab_sizes, multi_hot=8, seed=0).items()}
    with pytest.raises(RuntimeError, match="backward"):
        model(batch)
    with torch.inference_mode():
        want = model(batch, use_kernel=False)

        def boom(*a, **k):
            raise AssertionError("plain version called on a CUDA tensor")

        monkeypatch.setattr(bag_ops, "embedding_bag_ref", boom)
        before = bag_ops.launches
        got = model(batch)
    assert bag_ops.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# -- training: the losses run the plain versions, on the card as on the CPU

def _train_case(name: str, device):
    """(model, loss_fn, numpy batch) of a SMOKE config, seeded on the
    CPU (the same weights on every device)."""
    from repro_torch.configs import din, gpusparse, qwen2_0_5b, xdeepfm
    from repro_torch.data.pipeline import lm_batch_fn, paired_batch_fn
    from repro_torch.data.synthetic import make_recsys_batch
    from repro_torch.models.recsys import build_model
    from repro_torch.models.splade import SpladeEncoder
    from repro_torch.models.transformer import TransformerLM

    gen = torch.Generator().manual_seed(4)
    if name == "encoder":
        m = SpladeEncoder(gpusparse.ENCODER_SMOKE, device="cpu",
                          generator=gen)
        return (m.to(device), lambda b: m.contrastive_loss(b),
                paired_batch_fn(512, 8, 32)(0, 0))
    if name == "lm":
        m = TransformerLM(qwen2_0_5b.SMOKE, device="cpu", generator=gen)
        return m.to(device), m.loss_fn, lm_batch_fn(2, 64, 512)(0, 0)
    cfg = {"din": din, "xdeepfm": xdeepfm}[name].SMOKE
    m = build_model(cfg, device="cpu", seed=4).to(device)
    return m, m.loss_fn, make_recsys_batch(
        64, cfg.n_sparse, list(cfg.vocab_sizes), cfg.seq_len, cfg.item_vocab,
        multi_hot=3, seed=1)


@pytest.mark.parametrize("name", ["encoder", "lm", "din", "xdeepfm"])
def test_train_step_on_the_card_matches_the_cpu(cuda, name):
    """One step's loss within 1e-5 relative and each gradient leaf within
    1e-4 of its max |g| (f32 products summed in another order, no TF32);
    the losses launch no kernel (they have no backward)."""
    from repro_torch.train import AdamWConfig, init_state, make_train_step
    from repro_torch.train.train_loop import _accumulate_grads, to_device

    kernels = (head_ops, flash_ops, bag_ops, scatter_ops, ell_ops)
    before = [k.launches for k in kernels]
    results = {}
    for dev in ("cpu", cuda):
        model, loss_fn, batch = _train_case(name, dev)
        params = dict(model.named_parameters())
        loss, _, grads = _accumulate_grads(loss_fn, params,
                                           to_device(batch, dev), 1)
        adamw = AdamWConfig(lr=1e-3, warmup_steps=1)
        state, metrics = make_train_step(loss_fn, adamw)(
            init_state(params, adamw).as_dict(), batch)
        assert all(p.device.type == torch.device(dev).type
                   for p in state["params"].values())
        assert int(state["opt_state"]["step"]) == 1
        results[str(dev)] = (float(loss), {k: g.cpu() for k, g in
                                           grads.items()},
                             float(metrics["loss"]))
    assert [k.launches for k in kernels] == before
    (cl, cg, cm), (gl, gg, gm) = results["cpu"], results[str(cuda)]
    assert abs(gl - cl) <= 1e-5 * abs(cl) and abs(gm - cm) <= 1e-5 * abs(cm)
    for k, g in cg.items():
        err = (gg[k] - g).abs().max().item()
        assert err <= 1e-4 * max(g.abs().max().item(), 1e-30), (k, err)


def test_contrastive_loss_through_the_kernel_raises_under_grad(cuda):
    model, loss_fn, batch = _train_case("encoder", cuda)
    from repro_torch.train.train_loop import to_device

    b = to_device(batch, cuda)
    with pytest.raises(RuntimeError, match="backward"):
        model.encode(b["q_tokens"], b["q_mask"], use_kernel=True)
    before = head_ops.launches
    loss, aux = loss_fn(b)
    loss.backward()
    assert head_ops.launches == before
    assert model.embed.grad is not None and torch.isfinite(loss)


def test_async_checkpoint_round_trip_from_the_card(cuda, tmp_path):
    """``save`` copies the card's tensors to the host before it returns; a
    later in-place step does not reach the file; ``load`` puts each leaf
    back on the template's device with its dtype."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.train import AdamWConfig, init_state

    model, _, _ = _train_case("lm", cuda)
    state = init_state(dict(model.named_parameters()),
                       AdamWConfig()).as_dict()
    want = {k: v.detach().cpu().clone() for k, v in state["params"].items()}
    ck = Checkpointer(str(tmp_path), async_write=True)
    ck.save(7, state)
    with torch.no_grad():
        for p in state["params"].values():
            p.mul_(2.0).add_(1.0)
    ck.wait()
    assert ck.list_steps() == [7]
    loaded = ck.load(7, state)
    for k, v in loaded["params"].items():
        assert v.device == state["params"][k].device
        assert v.dtype == torch.float32 and torch.equal(v.cpu(), want[k]), k
    step = loaded["opt_state"]["step"]
    assert step.dtype == torch.int32 and step.device.type == "cuda"


# -- the serving state on the card ---------------------------------------

def _serve_corpus(cuda):
    return make_msmarco_like(4096, 64, vocab_size=5000, seed=21,
                             device=cuda)


def test_fence_waits_for_a_queued_kernel(cuda):
    """A fenced span covers the kernel: after ``fence`` the work is done,
    and the span is at least the kernel's CUDA-event time."""
    from repro_torch import obs as obs_mod

    c = make_msmarco_like(200_000, 256, vocab_size=30522, seed=22,
                          device=cuda)
    idx = tidx.build_tiled_index(c.docs)
    scoring.score_tiled(c.queries, idx)  # warm-up (build, first launch)
    obs = obs_mod.Obs()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    before = scatter_ops.launches
    with obs.span("kernel") as sp:
        start.record()
        out = scoring.score_tiled(c.queries, idx)
        end.record()
        obs_mod.fence(out)
        assert end.query()
    assert scatter_ops.launches == before + 1
    assert sp.duration * 1e3 >= start.elapsed_time(end)


def test_paged_index_is_bit_identical_after_a_pinned_copy(cuda, tmp_path):
    from repro_torch.core.index import (
        TILED_ARRAY_FIELDS, TILED_OPTIONAL_ARRAY_FIELDS,
    )
    from repro_torch.store import SegmentReader, SegmentWriter, Upload

    c = _serve_corpus(cuda)
    cfg = RetrievalConfig(engine="tiled-pruned", doc_block=64,
                          bounds_format="csr")
    SegmentWriter(str(tmp_path / "s"), cfg, segment_docs=4096,
                  device=cuda).ingest([c.docs])
    resident = RetrievalEngine(c.docs, cfg, device=cuda)._index
    stream = torch.cuda.Stream(cuda)
    upload = Upload(cuda, stream)
    loaded = SegmentReader(str(tmp_path / "s" / "seg_00000")).load_index(
        upload)
    upload.finish()
    assert upload.pinned and all(p.is_pinned() for p in upload.pinned)
    upload.wait()
    for name in TILED_ARRAY_FIELDS + TILED_OPTIONAL_ARRAY_FIELDS:
        a, b = getattr(resident, name), getattr(loaded, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert b.is_cuda and a.dtype == b.dtype, name
            assert torch.equal(a, b), name
    torch.cuda.synchronize()
    assert upload.done() and not upload.pinned


@pytest.mark.parametrize("engine", ["tiled-bmp-fused", "ell"])
@pytest.mark.parametrize("budget", [None, "two segments"])
def test_prefetch_on_its_own_stream_gives_the_resident_results(
        cuda, tmp_path, budget, engine):
    """Prefetches staged on the pager's thread and stream, a persisted
    index (fused) and a rebuild from the documents (``ell``)."""
    from repro_torch.core.session import Retriever
    from repro_torch.store import SegmentStore, SegmentWriter

    c = _serve_corpus(cuda)
    cfg = RetrievalConfig(engine=engine, k=50, doc_block=64)
    SegmentWriter(str(tmp_path / "s"), cfg, segment_docs=1024,
                  device=cuda).ingest([c.docs])
    resident = Retriever(config=cfg, device=cuda)
    for s in range(0, 4096, 1024):
        resident.add_docs(c.docs.slice_rows(s, 1024))
    want = resident.search(c.queries, return_tau=True)
    if budget is not None:
        # room for the working segment and a prefetch (bounded by its
        # files' size), not for all four: the LRU must evict
        mapped = max(h.mapped_bytes()
                     for h in SegmentStore.open(str(tmp_path / "s")).segments)
        budget = max(s.index_bytes() for s in resident._segments) + mapped
    paged = Retriever.from_store(str(tmp_path / "s"),
                                 device_budget_bytes=budget, device=cuda)
    for _ in range(2):
        got = paged.search(c.queries, return_tau=True)
        for a, b in zip(got, want):
            assert (a == b).all()
    st = paged.pager_stats()
    assert st["prefetches"] > 0
    assert paged._pager._inflight == []  # released when the search ended
    assert paged._pager._stream is not None
    assert paged._pager._stream != torch.cuda.current_stream(cuda)
    if budget is not None:
        assert st["evictions"] > 0


# -- sharded serving on the card ---------------------------------------------

@pytest.mark.parametrize("engine", ["ell", "tiled", "tiled-pruned",
                                    "tiled-pruned-approx",
                                    "tiled-bmp-grouped", "tiled-bmp-fused"])
def test_sharded_step_at_world_size_one_equals_the_engine(cuda, engine):
    """The world-size-1 step on the card gives the single-index engine's
    bits at the sharded build's geometry, through the kernels."""
    from repro_torch.core.distributed import (
        build_sharded_ell, build_sharded_tiled, make_serve_step,
    )

    c = make_topical_corpus(20_000, 64, vocab_size=5000, seed=23,
                            device=cuda)
    k = 100
    extra = {"theta": 0.8} if engine == "tiled-pruned-approx" else {}
    ell = engine == "ell"
    idx = (build_sharded_ell(c.docs, 1) if ell
           else build_sharded_tiled(c.docs, 1))
    geo = None if ell else idx.geometry()
    cfg = RetrievalConfig(engine=engine, k=k, **extra)
    before = (ell_ops.launches, scatter_ops.launches, bmp_ops.launches)
    vals, ids, tau = make_serve_step(
        engine=engine, cfg=cfg, docs_per_shard=idx.docs_per_shard,
        geometry=geo)(idx, queries=c.queries)
    after = (ell_ops.launches, scatter_ops.launches, bmp_ops.launches)
    assert after != before  # a kernel ran
    single = RetrievalConfig(engine=engine, k=k, term_block=512,
                             doc_block=64, chunk_size=128, **extra)
    want = RetrievalEngine(c.docs, single, device=cuda).search(
        c.queries, k=k, return_tau=True)
    vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
    assert (vals == want[0]).all()
    # The engine reports -1 at a non-finite value; the step its position.
    assert (np.where(np.isfinite(vals), ids, -1) == want[1]).all()
    assert (tau.cpu().numpy() == want[2]).all()


def test_sharded_step_under_an_nccl_group_of_one(cuda):
    """The collective path on the card: an NCCL group of world size 1
    gives the no-group step's bits."""
    import socket

    import torch.distributed as dist

    from repro_torch.core.distributed import (
        build_sharded_ell, make_serve_step,
    )

    c = make_msmarco_like(30_000, 64, vocab_size=5000, seed=24, device=cuda)
    idx = build_sharded_ell(c.docs, 1)
    step = dict(engine="ell", k=100, docs_per_shard=idx.docs_per_shard)
    want = make_serve_step(**step)(idx, queries=c.queries)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        got = make_serve_step(**step)(idx, queries=c.queries)
    finally:
        dist.destroy_process_group()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# -- mixture of experts and data-parallel training on the card ---------------

@pytest.mark.parametrize("dispatch", ["einsum", "ragged"])
def test_moe_block_on_the_card_matches_the_cpu(cuda, dispatch):
    """olmoe-1b-7b's routing (64 experts, top-8) at a narrow width, f32:
    the same expert ids and kept (token, slot) entries as the CPU, the
    output within TOL of max |CPU|, the aux loss within 1e-6 relative."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import layers as L

    full = get_arch("olmoe-1b-7b").config
    cfg = dataclasses.replace(full, d_model=256, d_ff=128, dtype="float32",
                              moe=dataclasses.replace(full.moe,
                                                      dispatch=dispatch))
    g = torch.Generator().manual_seed(5)
    p = L.init_moe(g, cfg, torch.float32)
    x = torch.randn(2, 300, cfg.d_model, generator=g)
    out = {}
    for dev in ("cpu", cuda):
        pd = {k: v.to(dev) for k, v in p.items()}
        y, aux = L.moe_block(pd, x.to(dev), cfg)
        _, ids, _ = L.route(pd, x.to(dev).reshape(600, -1), cfg.moe)
        g_tok = L.moe_group_tokens(600, cfg.moe)
        pos = L.capacity_positions(ids.view(600 // g_tok, g_tok, -1),
                                   cfg.moe.num_experts)
        kept = pos.view(600, -1) < L.moe_capacity(g_tok, cfg.moe)
        out[str(dev)] = y.cpu(), float(aux), ids.cpu(), kept.cpu()
    (cy, ca, ci, ck), (gy, ga, gi, gk) = out["cpu"], out[str(cuda)]
    assert torch.equal(gi, ci) and torch.equal(gk, ck)
    assert (gy - cy).abs().max().item() <= TOL * cy.abs().max().item()
    assert abs(ga - ca) <= 1e-6 * abs(ca)


def test_ddp_step_under_an_nccl_group_of_one(cuda, monkeypatch):
    """``make_ddp_train_step`` under an NCCL group of one gives
    ``make_train_step``'s losses and parameters bit for bit (both under
    deterministic algorithms); compressed, its error buffer holds every
    parameter."""
    import socket

    import torch.distributed as dist

    from repro_torch.configs import smollm_135m
    from repro_torch.data.pipeline import lm_batch_fn
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.train import (AdamWConfig, init_state,
                                   make_ddp_train_step, make_train_step)

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = smollm_135m.SMOKE
    batches = [lm_batch_fn(4, 32, cfg.vocab_size)(0, i) for i in range(2)]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    torch.use_deterministic_algorithms(True)
    try:
        runs = {}
        for mode in ("single", "ddp", "compressed"):
            lm = TransformerLM(cfg, device=cuda, generator=torch.Generator(
                device=cuda).manual_seed(0))
            adamw = AdamWConfig(lr=1e-3, warmup_steps=1)
            step = (make_train_step(lm.loss_fn, adamw) if mode == "single"
                    else make_ddp_train_step(
                        lm.loss_fn, adamw, compress=mode == "compressed"))
            state = init_state(dict(lm.named_parameters()), adamw).as_dict()
            losses = []
            for b in batches:
                state, m = step(state, b)
                losses.append(float(m["loss"]))
            runs[mode] = losses, state
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    (l1, s1), (l2, s2), (_, s3) = (runs[m] for m in ("single", "ddp",
                                                     "compressed"))
    assert l1 == l2
    for k, v in s1["params"].items():
        assert torch.equal(v, s2["params"][k]), k
    assert set(s3["err_buf"]) == set(s3["params"])


@pytest.mark.parametrize("pad_to", [32, 128])
def test_flat_index_built_on_the_card_equals_the_cpu_build(cuda, pad_to):
    c = make_msmarco_like(4001, 4, vocab_size=5000, seed=41, device=cuda)
    got = tidx.build_flat_index(c.docs, pad_to=pad_to)
    want = tidx.build_flat_index(c.docs.to("cpu"), pad_to=pad_to)
    assert got.device.type == "cuda"
    for name in tidx.FLAT_ARRAY_FIELDS:
        a, b = getattr(got, name).cpu(), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert got.padding_overhead == want.padding_overhead


@pytest.mark.parametrize("engine", ["bcoo", "segment"])
def test_comparison_engines_on_the_card_match_cpu_and_f64(cuda, engine):
    """``bcoo`` (cuSPARSE through ``torch.sparse.mm``) and ``segment`` (the
    per-term ``index_add_`` loop) on the card: scores within TOL of their
    CPU runs and 1e-5 relative of float64; ``segment`` bit for bit its CPU
    run (each cell is added once a launch, in the same order) and one
    launch a valid query term."""
    c = make_msmarco_like(3001, 24, vocab_size=5000, seed=43, device=cuda)
    cfg = RetrievalConfig(engine=engine, k=50)
    eng = RetrievalEngine(c.docs, cfg, device=cuda)
    cpu = RetrievalEngine(c.docs.to("cpu"), cfg, device="cpu")
    scoring.segment_launches = 0
    got = eng.score(c.queries)
    if engine == "segment":
        assert scoring.segment_launches == int((c.queries.term_ids >= 0).sum())
        assert torch.equal(got.cpu(), cpu.score(c.queries.to("cpu")))
    else:
        _close(got, cpu.score(c.queries.to("cpu")).to(cuda))
    f64 = scoring.score_dense_f64(c.queries, c.docs)
    assert float(((got.double() - f64).abs() / f64.abs().clamp_min(1e-30))
                 .max()) <= 1e-5
    v, i = eng.search(c.queries, k=50)
    fv, fi = scoring.topk_f64(c.queries, c.docs, 50)
    np.testing.assert_allclose(v, fv.cpu().numpy(), rtol=1e-5)


def test_policy_at_model_one_is_the_unsharded_lm_bit_for_bit(cuda):
    """Phase 13a's case at a small width: the sharding policy of a 1 x 1
    mesh under an NCCL group of one gives the unsharded model's prefill
    and decode logits bit for bit (bf16, through ``flash_attention``)."""
    import dataclasses
    import socket

    import torch.distributed as dist

    from repro_torch.configs import qwen3_4b
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.sharding.policies import make_policy

    # Dh 64: the kernel takes Dh 64 or 128, SMOKE's 16 raises.
    cfg = dataclasses.replace(qwen3_4b.SMOKE, dtype="bfloat16", d_head=64)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(1))

    def run(policy):
        lm = TransformerLM(cfg, device=cuda, generator=torch.Generator(
            cuda).manual_seed(0), policy=policy)
        with torch.inference_mode():
            flash_ops.launches = 0
            out = [lm.prefill(tokens)]
            assert flash_ops.launches == cfg.n_layers
            cache = lm.init_cache(2, 8)
            for i in range(3):
                lg, cache = lm.decode_step(cache, tokens[:, i], i)
                out.append(lg)
        return out

    want = run(None)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        got = run(make_policy(make_debug_mesh(1, 1)))
    finally:
        dist.destroy_process_group()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _nccl_group_of_one():
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)


@pytest.mark.parametrize("family", ["lm", "schnet"])
def test_sharded_step_under_an_nccl_group_of_one_is_make_train_step(
        cuda, family, monkeypatch):
    """``make_sharded_train_step`` at mesh (1, 1) under an NCCL group of
    one gives ``make_train_step``'s losses, norms and parameters bit for
    bit over 3 steps (both under deterministic algorithms): ``qwen3-4b``
    at SMOKE in bf16 with remat and ``seq_parallel`` set (a no-op on one
    rank), SchNet's full graph."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import qwen3_4b, schnet as schnet_cfg
    from repro_torch.data.pipeline import lm_batch_fn
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.schnet import SchNet
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.sharding.policies import make_policy
    from repro_torch.train import AdamWConfig, adamw_init
    from repro_torch.train.train_loop import (make_sharded_train_step,
                                              make_train_step)

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if family == "lm":
        cfg = dataclasses.replace(qwen3_4b.SMOKE, dtype="bfloat16",
                                  seq_parallel=True)
        batch = lm_batch_fn(4, 32, cfg.vocab_size)(0, 0)

        def make(policy):
            return TransformerLM(cfg, device=cuda, generator=torch.Generator(
                device=cuda).manual_seed(0), policy=policy), {}
    else:
        cfg = dataclasses.replace(schnet_cfg.SMOKE, d_in=8)
        g = torch.Generator().manual_seed(2)
        n, e = 50, 200
        batch = {"node_feat": torch.randn(n, 8, generator=g),
                 "senders": torch.randint(0, n, (e,), generator=g),
                 "receivers": torch.randint(0, n + 1, (e,), generator=g),
                 "distances": 0.5 + 4 * torch.rand(e, generator=g),
                 "targets": torch.randn(n, generator=g),
                 "node_mask": (torch.rand(n, generator=g) < 0.5).float()}

        def make(policy):
            return SchNet(cfg, device=cuda, generator=torch.Generator(
                device=cuda).manual_seed(0), policy=policy), {
                    "batched": False}

    def run(policy):
        model, kw = make(policy)
        params = dict(model.named_parameters())
        state = {"params": params, "opt_state": adamw_init(params)}
        step = (make_train_step(model.loss_fn, AdamWConfig()) if policy is None
                else make_sharded_train_step(model.loss_fn, AdamWConfig(),
                                             model.train_plan(**kw)))
        metrics = []
        for _ in range(3):
            state, m = step(state, batch)
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        return metrics, params

    torch.use_deterministic_algorithms(True)
    try:
        want = run(None)
        _nccl_group_of_one()
        try:
            got = run(make_policy(make_debug_mesh(1, 1)))
        finally:
            dist.destroy_process_group()
    finally:
        torch.use_deterministic_algorithms(False)
    assert got[0] == want[0]
    for k, v in want[1].items():
        assert torch.equal(got[1][k], v), k


def test_train_state_cut_into_shards_and_gathered_back(cuda):
    """``policies.shard_state`` cuts a whole state on the card into each
    rank's blocks (every coordinate of a (2, 2) mesh: the blocks tile each
    leaf), and ``gather_state`` under an NCCL group of one, mesh (1, 1),
    gives the whole state back."""
    import torch.distributed as dist

    from repro_torch.configs import smollm_135m
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.sharding import policies as pol
    from repro_torch.train import adamw_init

    lm = TransformerLM(smollm_135m.SMOKE, device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(0))
    params = {k: v.detach() for k, v in lm.named_parameters()}
    opt = adamw_init(params)
    for k in params:
        opt["mu"][k].normal_()
        opt["nu"][k].uniform_()
    whole = {"params": params, "opt_state": opt}
    mesh = pol.AbstractMesh((2, 2))
    policy = pol.make_policy(mesh)
    specs = pol.lm_param_specs(smollm_135m.SMOKE, policy, params)
    # numbered leaves: the distinct blocks of the four ranks hold each
    # number once
    numbered = {k: torch.arange(v.numel(), device=cuda,
                                dtype=torch.float32).view(v.shape)
                for k, v in params.items()}
    state = {"params": numbered, "opt_state": {
        "step": opt["step"], "mu": numbered, "nu": numbered}}
    parts = {c: pol.shard_state(state, specs, mesh, c)
             for c in [(0, 0), (0, 1), (1, 0), (1, 1)]}
    for k, v in numbered.items():
        axes = [i for i, a in enumerate(mesh.mesh_dim_names)
                if a in pol.sharded_axes(specs[k], mesh)]
        blocks = {tuple(c[i] for i in axes): part["params"][k]
                  for c, part in parts.items()}
        for block in blocks.values():
            assert block.device == v.device  # a view on the card
            assert tuple(block.shape) == pol.local_shape(v.shape, specs[k],
                                                         mesh)
        got = torch.sort(torch.cat([b.reshape(-1)
                                    for b in blocks.values()])).values
        assert torch.equal(got, v.reshape(-1)), k
    _nccl_group_of_one()
    try:
        one = pol.make_policy(make_debug_mesh(1, 1))
        ones = pol.lm_param_specs(smollm_135m.SMOKE, one, params)
        cut = pol.shard_state(whole, ones, one.mesh, [0, 0])
        back = pol.gather_state(cut, ones, one)
    finally:
        dist.destroy_process_group()
    for k, v in params.items():
        assert torch.equal(back["params"][k], v)
        assert torch.equal(back["opt_state"]["mu"][k], opt["mu"][k])
        assert torch.equal(back["opt_state"]["nu"][k], opt["nu"][k])


# -- the bf16 routes ------------------------------------------------------------


def _within_bf16_ulp(got, want):
    """Each bf16 value within one bf16 ulp of ``want``'s (two f32 sums of
    one contract in other orders may round either way)."""
    torch.cuda.synchronize()
    g, w = got.double().cpu(), want.double().cpu()
    fin = torch.isfinite(w)
    assert torch.equal(torch.isfinite(g), fin)
    ulp = torch.exp2(torch.floor(torch.log2(w[fin].abs().clamp_min(
        2.0 ** -126))) - 7)
    assert bool(((g[fin] - w[fin]).abs() <= ulp).all())


@pytest.mark.parametrize("kernel", ["scatter_score", "ell_gather"])
@pytest.mark.parametrize("b", [3, 130])
def test_bf16_routes_match_plain_and_the_f32_route(cuda, kernel, b):
    c = make_msmarco_like(3001, b, vocab_size=5000, seed=b + 7, device=cuda)
    if kernel == "ell_gather":
        e = tidx.build_ell_index(c.docs)
        vb = e.values.to(BF)
        qw = c.queries.to_dense()
        fn = lambda q, v: ell_ops.ell_gather(q, e.terms, v)  # noqa: E731
        plain = lambda q, v: ell_gather_ref(q, e.terms, v)  # noqa: E731
    else:
        t = tidx.build_tiled_index(c.docs, 512, 128, 256)
        vb = t.value.to(BF)
        qw = torch.nn.functional.pad(c.queries.to_dense(),
                                     (0, t.num_term_blocks * 512 - 5000))
        runs = (t.chunk_term_block, t.chunk_doc_block, t.block_chunk_start,
                t.block_chunk_count)
        kw = dict(term_block=512, doc_block=128,
                  num_doc_blocks=t.num_doc_blocks)
        fn = lambda q, v: scatter_ops.scatter_score(  # noqa: E731
            q, t.local_term, t.local_doc, v, *runs, **kw)
        plain = lambda q, v: scatter_score_ref(  # noqa: E731
            q, t.local_term, t.local_doc, v, *runs, **kw)
    for q in _query_cases(cuda, qw, qw.shape[1]).values():
        qb = q.to(BF)
        got = fn(qb, vb)
        assert got.dtype == BF
        assert torch.equal(got, fn(qb.float(), vb.float()).to(BF))
        assert torch.equal(got, fn(qb, vb))
        _within_bf16_ulp(got, plain(qb, vb))
    with pytest.raises(TypeError, match="index values"):
        fn(qw.to(BF), vb.float())


@pytest.mark.parametrize("rows,n_groups,cs", [(1, 6, 128), (4, 3, 256),
                                              (64, 1, 128), (3, 2, 68)])
def test_bmp_sweep_bf16_route_matches_plain(cuda, rows, n_groups, cs):
    """Small route (rows <= 8, chunk lines of whole 16-byte pieces), wide
    route (64 rows, or 3 rows whose 68-slot bf16 lines are no whole
    pieces): the plain bf16 sweep's fetch sets and steps, scores and heap
    within one bf16 ulp of its largest score, each scored block the bf16
    ``scatter_score``'s bits."""
    c = make_topical_corpus(6000, rows * n_groups, vocab_size=5000, seed=cs,
                            device=cuda)
    docs, _ = tidx.reorder_docs(c.docs, "df-signature")
    t = tidx.build_tiled_index(docs, 512, 64, cs, store_term_block_max=True)
    tb = tidx.TiledIndex(**{**t.__dict__, "value": t.value.to(BF)})
    qw = scoring._pad_queries_to_term_blocks(c.queries, tb)
    ub = scoring.block_upper_bounds(c.queries, tb)
    order = torch.argsort(-ub, dim=-1, stable=True)
    us = ub.gather(-1, order)
    g = lambda x: x.reshape(n_groups, rows, *x.shape[1:])  # noqa: E731
    runs = (tb.block_chunk_start, tb.block_chunk_count, tb.chunk_term_block,
            tb.chunk_doc_block, tb.local_term, tb.local_doc, tb.value)
    kw = dict(term_block=512, doc_block=64, k_eff=10, theta=1.0,
              num_docs=tb.num_docs)
    tau = torch.full((n_groups, rows), float("-inf"), device=cuda)
    got = bmp_ops.bmp_sweep(g(qw), g(order.int()), g(us), tau, *runs, **kw)
    want_route = "small" if rows <= 8 and cs % 8 == 0 else "wide"
    assert bmp_ops.last_route.name == want_route
    for i in range(n_groups):
        want = bmp_sweep_ref(g(qw)[i], g(order.int())[i], g(us)[i], tau[i],
                             *runs, **kw)
        scale = want[0].abs().max().item()
        assert (got[0][i] - want[0]).abs().max().item() <= 2 ** -7 * scale
        fin = torch.isfinite(want[1])
        assert torch.equal(torch.isfinite(got[1][i]), fin)
        assert torch.equal(got[2][i].bool(), want[2])
        assert torch.equal(got[3][i].bool(), want[3])
        assert int(got[4][i, 0]) == want[4]
        cols = want[2].repeat_interleave(64)
        exact = scatter_ops.scatter_score(
            g(qw)[i], tb.local_term, tb.local_doc, tb.value,
            tb.chunk_term_block, tb.chunk_doc_block, tb.block_chunk_start,
            tb.block_chunk_count * want[2].int(), term_block=512,
            doc_block=64, num_doc_blocks=tb.num_doc_blocks).float()
        assert torch.equal(got[0][i][:, cols], exact[:, cols])


@pytest.mark.parametrize("engine", ["ell", "tiled", "tiled-pruned",
                                    "tiled-pruned-approx",
                                    "tiled-bmp-grouped", "tiled-bmp-fused"])
def test_bf16_sharded_steps_on_the_card_match_the_cpu(cuda, engine):
    """Each bf16 step through the kernels against the same step on the CPU
    (the plain versions): one contract, sums in other orders."""
    from _torch_parity import assert_bf16_topk
    from repro_torch.core.distributed import (
        build_sharded_ell, build_sharded_tiled, make_serve_step,
    )

    c = make_topical_corpus(20_000, 32, vocab_size=5000, seed=29,
                            device="cpu")
    docs, _ = tidx.reorder_docs(c.docs, "df-signature")
    k = 100

    def run(dev, name):
        ell = name == "ell"
        d = docs.to(dev)
        idx = build_sharded_ell(d, 1) if ell else build_sharded_tiled(d, 1)
        cfg = RetrievalConfig(engine=name, k=k)
        step = make_serve_step(engine=name, cfg=cfg,
                               docs_per_shard=idx.docs_per_shard,
                               geometry=None if ell else idx.geometry(),
                               compute_dtype=BF)
        return step(idx, queries=c.queries.to(dev))

    before = (ell_ops.launches, scatter_ops.launches, bmp_ops.launches)
    got = run(cuda, engine)
    assert (ell_ops.launches, scatter_ops.launches,
            bmp_ops.launches) != before
    want = run("cpu", engine)
    assert_bf16_topk([x.cpu().numpy() for x in got],
                     [x.numpy() for x in want])
    if engine.startswith("tiled-"):
        tiled = run(cuda, "tiled")
        for a, b in zip(got, tiled):
            assert torch.equal(a, b)


def test_lint_device_half_on_one_kernel(cuda):
    """The lint's device half (``repro_torch.lint.sanitize``) on
    ``embedding_bag``'s weighted route, ids outside [0, V) included: the
    guard bands and the repeated launches are clean, the kernel agrees with
    its plain version, and memcheck and racecheck are each clean or say
    why they could not check (never silent); no finding."""
    from repro_torch.lint import sanitize

    name = "embedding_bag/vec4/weighted"
    results = sanitize.run("cuda", names=[name])
    res = results["routes"][name]
    assert res["guard"] == "clean" and res["repeat"] == "clean"
    assert res["plain"] == "clean"
    for tool in ("memcheck", "racecheck"):
        assert res[tool] == "clean" or res[tool].startswith("not checked")
    assert sanitize.memory_findings(results) == []
    assert sanitize.race_findings(results) == []
