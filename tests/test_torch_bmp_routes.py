"""The redesigned ``bmp_scan`` kernel's host decisions and scoring order,
on the CPU.

The CUDA kernel runs only on the card; what it decides on the host and the
order in which it sums are held here in plain numpy and torch:

(a) ``pick_route`` is a pure function of the launch's shape: groups of at
    most ``SMALL_MAX_ROWS`` rows take the small route (lanes over
    postings), larger ones, and small ones whose chunk geometry or shared
    memory the small route cannot take, the wide route (lanes over rows);
    a launch of fewer groups than SMs splits each group over a cluster; a
    geometry that no route fits raises.
(b) ``pack_small_weights`` and ``term_block_mask`` equal their definitions
    from ``qw``.
(c) An emulation of the small route's sweep: each step's candidate blocks
    (alive rows' rank-i blocks not yet scored, on the state a step that
    many workers back left) scored ahead of the retire test, each chunk's
    live slots cut into 32 slices walked in slot order with fma, a doc's
    later slice parts added after its first in slice order, chunks in run
    order; then the retire test and the demand set on the true state, and
    only the demanded windows written.  Run with and without skipping the
    chunks of all-zero term blocks and the zero-weight postings, and with
    1 or 48 workers.  Against ``bmp_sweep_ref``: scores, heap and tau
    within KERNEL_TOL (1e-5 of max |plain|), fetch sets and steps equal.
    Every demanded block is a candidate, and the skips keep the order of
    every nonzero term, so the scores are bit for bit equal in every run.
    The fma is emulated in float64 (the product is exact) rounded once to
    f32.  The bf16 route's walk (weights and values widened from bf16, a
    complete window rounded once, the bf16 margin) against the plain bf16
    version the same way, within one bf16 ulp.
(d) ``pick_route`` with bf16 values: the small route where a chunk's
    values fill whole 16-byte pieces (chunk_size a multiple of 8), the
    weights' shared memory counted in 2-byte words.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import index as tidx
from repro_torch.core import scoring
from repro_torch.core.topk import update_topk_heap
from repro_torch.data.synthetic import make_topical_corpus
from repro_torch.kernels.bmp_scan import ops as bmp_ops
from repro_torch.kernels.bmp_scan.ref import bmp_sweep_ref, prune_margin
from repro_torch.kernels.scatter_score.ref import scatter_score_ref

KERNEL_TOL = 1e-5
H100_SMS = 132
SERVE_1M = dict(doc_block=256, chunk_size=512, v_pad=30720, term_block=512)


# (a) the route and cluster picker ----------------------------------------

@pytest.mark.parametrize("groups,b,name,tile,cluster", [
    (494, 1, "small", 1, 1),  # the topical call's singletons: no cluster
    (3, 2, "small", 2, 16),  # its 2-row bucket: a cluster a group
    (200, 3, "small", 4, 1),
    (20, 8, "small", 8, 4),
    (1, 9, "wide", 32, 8),  # one above the cut-off
    (1, 64, "wide", 128, 8),
    (1, 256, "wide", 128, 8),  # the flat 256-row sweep
    (140, 16, "wide", 32, 1),
])
def test_pick_route_is_a_pure_function_of_the_shape(groups, b, name, tile,
                                                    cluster):
    route = bmp_ops.pick_route(groups, b, H100_SMS, SERVE_1M["doc_block"],
                               SERVE_1M["chunk_size"],
                               v_pad=SERVE_1M["v_pad"],
                               term_block=SERVE_1M["term_block"],
                               nz_cap=40 * b, max_run=120)
    assert (route.name, route.tile, route.cluster) == (name, tile, cluster)
    assert route == bmp_ops.pick_route(
        groups, b, H100_SMS, 256, 512, v_pad=30720, term_block=512,
        nz_cap=40 * b, max_run=120)
    assert route.smem <= bmp_ops.MAX_SMEM
    if name == "small":
        assert route.threads == 32 * bmp_ops.PIPE_WARPS
        assert route.weights_in_smem
        # Several groups share an SM (228 KB of shared memory each): the
        # 494 one-row groups of a topical call fit in one wave.
        assert 228 * 1024 // route.smem >= (4 if tile == 1 else 2)
    else:
        assert route.threads == 1024 and not route.weights_in_smem


def test_pick_route_sizes_shared_memory_from_the_layout():
    kw = dict(v_pad=30720, term_block=512, max_run=120)
    few = bmp_ops.pick_route(494, 1, H100_SMS, 256, 512, nz_cap=40, **kw)
    assert few.smem == 4 * bmp_ops.small_smem_words(1, 256, 512, 30720, 512,
                                                    120, 40)
    pair = bmp_ops.pick_route(300, 2, H100_SMS, 256, 512, nz_cap=80, **kw)
    assert pair.smem == 4 * bmp_ops.small_smem_words(2, 256, 512, 30720, 512,
                                                     120, 160)
    # Dense weights (a nearly dense SPLADE query) stay in device memory.
    dense = bmp_ops.pick_route(494, 1, H100_SMS, 256, 512, nz_cap=30720,
                               **kw)
    assert not dense.weights_in_smem and dense.smem < few.smem + 4 * 40
    wide = bmp_ops.pick_route(1, 256, H100_SMS, 256, 512, **kw)
    assert wide.smem == 4 * bmp_ops.wide_smem_words(128, 256, 512, 256, 60)
    # The SM count is an argument: a smaller card clusters fewer groups.
    assert bmp_ops.pick_route(3, 2, 8, 256, 512, nz_cap=80, **kw).cluster == 2
    assert bmp_ops.pick_route(8, 2, 8, 256, 512, nz_cap=80, **kw).cluster == 1


@pytest.mark.parametrize("groups,b,doc_block,chunk_size", [
    (1, 256, 1024, 512),  # the wide window alone is over 227 KB
    (1, 1, 4096, 8192),  # the small route's ring and window, and the wide's
    (4, 2, 4096, 510),  # small: not 16-byte pieces; wide: its window
    (4, 2, 4096, 1024),  # small: over four 128-slot loads; wide: its window
])
def test_pick_route_raises_where_no_route_fits(groups, b, doc_block,
                                               chunk_size):
    with pytest.raises(ValueError):
        bmp_ops.pick_route(groups, b, H100_SMS, doc_block, chunk_size,
                           v_pad=30720, term_block=512, nz_cap=40 * b,
                           max_run=120)


@pytest.mark.parametrize("groups,b,chunk_size,max_run,cluster", [
    (4, 2, 510, 120, 8),  # not a whole number of 16-byte pieces
    (4, 2, 1024, 120, 8),  # over four 128-slot loads
    (494, 1, 512, 20_000, 1),  # 3 workers x 2 x max_run words of chunk list
])
def test_pick_route_sends_small_groups_wide_where_the_small_route_cannot(
        groups, b, chunk_size, max_run, cluster):
    kw = dict(v_pad=30720, term_block=512, nz_cap=40 * b, max_run=max_run)
    route = bmp_ops.pick_route(groups, b, H100_SMS, 256, chunk_size, **kw)
    assert (route.name, route.tile, route.cluster) == ("wide", 32, cluster)
    assert route.smem == 4 * bmp_ops.wide_smem_words(32, 256, chunk_size, b,
                                                     60)
    assert route.threads == 1024 and not route.weights_in_smem
    # The same geometry with a chunk the small route takes stays small.
    if max_run == 120:
        assert bmp_ops.pick_route(groups, b, H100_SMS, 256, 512,
                                  **kw).name == "small"
    else:
        assert 4 * bmp_ops.small_smem_words(1, 256, 512, 30720, 512, max_run,
                                            0) > bmp_ops.MAX_SMEM


# (b) the small route's packed weights -------------------------------------

def _sparse_qw(g, b, v_pad, nnz, seed):
    rng = np.random.default_rng(seed)
    qw = np.zeros((g, b, v_pad), np.float32)
    for gi in range(g):
        for r in range(b):
            t = rng.choice(v_pad, size=nnz, replace=False)
            qw[gi, r, t] = rng.uniform(0.05, 3.0, size=nnz)
    qw[-1] = 0.0  # an all-zero group
    return torch.from_numpy(qw)


@pytest.mark.parametrize("b,v_pad,nnz", [(1, 1024, 40), (3, 1000, 17),
                                         (8, 2048, 60)])
def test_pack_small_weights_equals_its_definition(b, v_pad, nnz):
    qw = _sparse_qw(4, b, v_pad, nnz, seed=b)
    tile = 1 << (b - 1).bit_length()
    nz_cap, _ = bmp_ops.launch_sizes(bmp_ops.nonzero_terms(qw),
                                     torch.zeros(0, dtype=torch.int32))
    bits, rank, weights = bmp_ops.pack_small_weights(qw, tile, nz_cap)
    g = qw.shape[0]
    n_words = -(-v_pad // 32)
    assert bits.dtype == rank.dtype == torch.int32
    assert bits.shape == rank.shape == (g, n_words)
    nz = (qw != 0).any(dim=1).numpy()
    assert weights.shape == (g, max(int(nz.sum(1).max()), 1), tile)
    u = bits.numpy().view(np.uint32)
    for gi in range(g):
        unpacked = [(u[gi, t // 32] >> (t % 32)) & 1 for t in range(v_pad)]
        np.testing.assert_array_equal(np.array(unpacked, bool), nz[gi])
        counts = [bin(int(w)).count("1") for w in u[gi]]
        np.testing.assert_array_equal(rank[gi].numpy(),
                                      np.cumsum(counts) - counts)
        for t in np.flatnonzero(nz[gi]):
            below = int(u[gi, t // 32]) & ((1 << (t % 32)) - 1)
            slot = int(rank[gi, t // 32]) + bin(below).count("1")
            np.testing.assert_array_equal(weights[gi, slot, :b].numpy(),
                                          qw[gi, :, t].numpy())
            assert not weights[gi, slot, b:].any()
        assert not weights[gi, int(nz[gi].sum()):].any()
    assert not bits[-1].any() and not weights[-1].any()


def test_term_block_mask_equals_its_definition():
    qw = _sparse_qw(3, 2, 2048, 5, seed=7)
    qw[0, :, 512:1024] = 0.0
    mask = bmp_ops.term_block_mask(bmp_ops.nonzero_terms(qw), 256)
    want = [[int((qw[g, :, t0:t0 + 256] != 0).any()) for t0 in
             range(0, 2048, 256)] for g in range(3)]
    assert mask.dtype == torch.int32
    assert mask.tolist() == want
    assert mask[0, 2:4].tolist() == [0, 0] and not mask[2].any()


# (c) the kernel's scoring order, emulated -----------------------------------

def _fma(a, b, c):
    """f32 fma: the product is exact in float64, the sum rounded once."""
    return np.float32(float(a) * float(b) + float(c))


def _score_block(window, qw, nz, tb_nz, idx, blk, skip):
    """Block blk's window [b, D]: each chunk's live slots in 32 equal
    slices; each (slice, doc) part an fma chain from 0 in slot order; a
    doc's parts added to its window row in slice order; chunks in run
    order."""
    lt_all, ld_all, val_all, ctb, bcs, bcc, T, D = idx
    b = qw.shape[0]
    for c in range(int(bcs[blk]), int(bcs[blk]) + int(bcc[blk])):
        tb = int(ctb[c])
        if skip and not tb_nz[tb]:
            continue  # every posting adds +0: the line is not read
        lt, ld, val = lt_all[c], ld_all[c], val_all[c]
        n_live = int(np.argmax(ld < 0)) if (ld < 0).any() else len(ld)
        pw = -(-n_live // 32)
        for s in range(32):
            cur, acc = None, None
            for x in range(s * pw, min(s * pw + pw, n_live)):
                d, lo = int(ld[x]), int(lt[x])
                if not (0 <= lo < T and d < D):
                    continue  # adds weight x 0
                t = tb * T + lo
                if skip and not nz[t]:
                    continue  # weight 0 in every row
                if d != cur:
                    if cur is not None:
                        window[:, cur] += acc
                    cur, acc = d, np.zeros(b, np.float32)
                for r in range(b):
                    acc[r] = _fma(qw[r, t], val[x], acc[r])
            if cur is not None:
                window[:, cur] += acc


def kernel_sweep(qw, order, ub_sorted, tau0, t, *, k_eff, theta, workers=1,
                 skip=True):
    """One group's sweep as the small route orders it -> bmp_sweep_ref's
    five outputs.  Step i is scored ahead of its retire test, on the state
    step i - ``workers`` left (the workers take the steps in turn): its
    candidates are the rows alive then and their rank-i blocks not scored
    then, each block once, each into a window of its own.  At its turn the
    step runs the retire test and the demand set on the true state; every
    block it demands must be a candidate, and only those windows are
    written."""
    D, T = t.doc_block, t.term_block
    bf16 = qw.dtype == torch.bfloat16  # widened exactly; a window rounded
    bcs, bcc = t.block_chunk_start.numpy(), t.block_chunk_count.numpy()
    idx = (t.local_term.numpy(), t.local_doc.numpy(),
           t.value.float().numpy(), t.chunk_term_block.numpy(), bcs, bcc, T,
           D)
    qn = qw.float().numpy()
    nz = (qn != 0).any(axis=0)
    tb_nz = nz.reshape(-1, T).any(axis=1)
    b, n_db = order.shape
    n_pad = n_db * D
    scores = np.zeros((b, n_pad), np.float32)
    heap = torch.full((b, k_eff), float("-inf"))
    tau = tau0.clone()
    alive = torch.ones(b, dtype=torch.bool)
    bscored = np.zeros(n_db, bool)
    cscored = np.zeros(t.num_chunks, bool)
    real = torch.arange(n_pad) < t.num_docs
    win = torch.arange(D)
    seen = [(alive.clone(), bscored.copy())]  # the state after each step
    steps = 0
    while steps < n_db and bool(alive.any()):
        i = steps
        blk = order[:, i].long()
        was_alive, was_scored = seen[max(i + 1 - workers, 0)]
        windows = {}
        for r in range(b):
            bk = int(blk[r])
            if was_alive[r] and not was_scored[bk] and bk not in windows:
                windows[bk] = np.zeros((b, D), np.float32)
                _score_block(windows[bk], qn, nz, tb_nz, idx, bk, skip)
        alive &= theta * ub_sorted[:, i] >= tau - prune_margin(tau, qw.dtype)
        for r in range(b):  # the demand: row order, each block once
            bk = int(blk[r])
            if alive[r] and not bscored[bk]:
                done = windows[bk]
                if bf16:  # the complete window, rounded once
                    done = torch.from_numpy(done).to(qw.dtype).float().numpy()
                scores[:, bk * D:(bk + 1) * D] = done
                bscored[bk] = True
                cscored[bcs[bk]: bcs[bk] + bcc[bk]] = True
        st = torch.from_numpy(scores)
        cols = (torch.where(alive, blk, 0) * D)[:, None] + win
        w = torch.where(alive[:, None] & real[cols], st.gather(1, cols),
                        float("-inf"))
        heap, kth = update_topk_heap(heap, w)
        tau = torch.maximum(tau, kth)
        steps = i + 1
        seen.append((alive.clone(), bscored.copy()))
    return (torch.from_numpy(scores), heap, torch.from_numpy(bscored),
            torch.from_numpy(cscored), steps)


@pytest.fixture(scope="module")
def sweep_case():
    c = make_topical_corpus(1200, 6, vocab_size=1500, num_topics=6,
                            topic_vocab=150, seed=3, device="cpu")
    docs, _ = tidx.reorder_docs(c.docs, "df-signature")
    t = tidx.build_tiled_index(docs, 256, 64, 64, store_term_block_max=True)
    qw = scoring._pad_queries_to_term_blocks(c.queries, t)
    qw[1, :256] = 0.0  # no weight in term block 0 (demanded by every row)
    qw[4] = 0.0  # an all-zero query
    ub = scoring.block_upper_bounds(c.queries, t, qw=qw)
    order = torch.argsort(-ub, dim=-1, stable=True)
    return t, qw, order.int(), ub.gather(-1, order)


def _runs(t):
    return (t.block_chunk_start, t.block_chunk_count, t.chunk_term_block,
            t.chunk_doc_block, t.local_term, t.local_doc, t.value)


@pytest.mark.parametrize("rows,theta,warm", [
    ([0], 1.0, False), ([1], 1.0, False), ([4], 1.0, False),
    ([0, 1], 0.8, True), ([2, 3, 4], 1.0, False),
])
def test_kernel_order_matches_plain_and_skips_are_exact(sweep_case, rows,
                                                        theta, warm):
    t, qw, order, ub_sorted = sweep_case
    sel = torch.tensor(rows)
    tau0 = torch.full((len(rows),), float("-inf"))
    if warm:
        tau0[0] = 1.0
    kw = dict(term_block=t.term_block, doc_block=t.doc_block, k_eff=10,
              theta=theta, num_docs=t.num_docs)
    want = bmp_sweep_ref(qw[sel], order[sel], ub_sorted[sel], tau0,
                         *_runs(t), **kw)
    args = (qw[sel], order[sel], ub_sorted[sel], tau0, t)
    ekw = dict(k_eff=10, theta=theta)
    got = kernel_sweep(*args, **ekw)
    scale = max(float(want[0].abs().max()), 1e-30)
    assert float((got[0] - want[0]).abs().max()) <= KERNEL_TOL * scale
    fin = torch.isfinite(want[1])
    assert torch.equal(torch.isfinite(got[1]), fin)
    if fin.any():
        assert float((got[1][fin] - want[1][fin]).abs().max()) \
            <= KERNEL_TOL * scale
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert got[4] == want[4]
    # The skips, and scoring steps ahead on 48 workers' stale states,
    # leave every bit in place.
    for other in (kernel_sweep(*args, **ekw, skip=False),
                  kernel_sweep(*args, **ekw, workers=48)):
        for x, y in zip(got[:4], other[:4]):
            assert torch.equal(x, y)
        assert got[4] == other[4]
    if not qw[sel].any():
        assert not got[0].any()


@pytest.mark.parametrize("rows,theta", [([0], 1.0), ([0, 1], 0.8),
                                        ([2, 3, 4], 1.0)])
def test_bf16_kernel_order_matches_plain_and_skips_are_exact(sweep_case, rows,
                                                             theta):
    """The bf16 route's walk: the weights and values widened from bf16,
    each complete window rounded once before it enters the heap, the bf16
    margin in the retire test.  The plain bf16 version sums in another
    order: scores, heap within one bf16 ulp of its largest score, the
    fetch sets and steps equal; the skips and 48 workers change no bit;
    a scored block is the plain ``scatter_score`` bf16 block's value."""
    t, qw, order, ub_sorted = sweep_case
    bf = torch.bfloat16
    tb = dataclasses.replace(t, value=t.value.to(bf))
    sel = torch.tensor(rows)
    q = qw[sel].to(bf)
    tau0 = torch.full((len(rows),), float("-inf"))
    kw = dict(term_block=t.term_block, doc_block=t.doc_block, k_eff=10,
              theta=theta, num_docs=t.num_docs)
    want = bmp_sweep_ref(q, order[sel], ub_sorted[sel], tau0, *_runs(tb),
                         **kw)
    args = (q, order[sel], ub_sorted[sel], tau0, tb)
    got = kernel_sweep(*args, k_eff=10, theta=theta)
    tol = 2.0 ** -7 * max(float(want[0].abs().max()), 1e-30)
    assert float((got[0] - want[0]).abs().max()) <= tol
    fin = torch.isfinite(want[1])
    assert torch.equal(torch.isfinite(got[1]), fin)
    assert float((got[1][fin] - want[1][fin]).abs().max()) <= tol
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert got[4] == want[4]
    assert torch.equal(got[0], got[0].to(bf).float())  # bf16 values
    for other in (kernel_sweep(*args, k_eff=10, theta=theta, skip=False),
                  kernel_sweep(*args, k_eff=10, theta=theta, workers=48)):
        for x, y in zip(got[:4], other[:4]):
            assert torch.equal(x, y)
    cols = want[2].repeat_interleave(t.doc_block)
    plain = scatter_score_ref(
        q, tb.local_term, tb.local_doc, tb.value, tb.chunk_term_block,
        tb.chunk_doc_block, tb.block_chunk_start,
        tb.block_chunk_count * want[2].to(torch.int32),
        term_block=t.term_block, doc_block=t.doc_block,
        num_doc_blocks=t.num_doc_blocks).float()
    assert torch.equal(want[0][:, cols], plain[:, cols])


@pytest.mark.parametrize("chunk_size,name", [(128, "small"), (68, "wide"),
                                             (512, "small")])
def test_pick_route_bf16_takes_the_small_route_on_whole_pieces(chunk_size,
                                                               name):
    kw = dict(v_pad=30720, term_block=512, nz_cap=40, max_run=4)
    f32 = bmp_ops.pick_route(4, 2, 132, 64, chunk_size, **kw)
    bf16 = bmp_ops.pick_route(4, 2, 132, 64, chunk_size, **kw, elem_bytes=2)
    assert f32.name == "small" and bf16.name == name
    if name == "small":  # 40 terms x 2 rows of weights: 80 words or 40
        assert f32.smem - bf16.smem == 4 * 40


def test_pick_route_bf16_wide_needs_whole_words():
    with pytest.raises(ValueError, match="4-byte words"):
        bmp_ops.pick_route(1, 64, 132, 64, 63, v_pad=1024, term_block=512,
                           elem_bytes=2)
