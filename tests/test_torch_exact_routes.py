"""The redesigned ``scatter_score`` and ``ell_gather`` kernels' host side and
summation order, on the CPU.

The CUDA kernels run only on the card; what their entries compute on the
host and the order in which the kernels sum are held here in numpy:

(a) ``pack_query_tiles`` equals its definition from ``qw``: per tile of 128
    queries and term, the (offset, count) record of the term's weights; a
    sparse tile's entries (query in the tile, weight) of the nonzero weights
    of the real queries in query order, or a dense tile's whole slab; the
    entries hold the sparse tiles alone and the slabs the dense tiles.
(b) ``chunk_doc_bounds`` (each warp's slots of each chunk) equals its
    definition; an emulation of the new ``scatter_score``: warps own docs;
    each chunk's live slots are cut into 32 equal slices; a doc's postings
    of one slice are a part, an fma chain from +0 in slot order, added into
    the doc's row when the part ends; chunks in run order.  Run with the sparse
    route's skips (a posting of no nonzero weight in the tile, a pair of
    weight 0) and without (the dense route: every pair, zeros included):
    the two are bitwise equal, and both within KERNEL_TOL of
    ``scatter_score_ref`` and of the Pallas kernel in interpret mode.
(c) The same for ``ell_gather`` (a doc's sums over its slots in slot
    order) against ``ell_gather_ref`` and the Pallas kernel.
(d) The route of a tile is a pure function of its nonzero count.
(e) The bf16 routes: the bf16 packing holds each weight's bf16 bits and
    the f32 packing's records and routes; each walk, fed the bf16 packing
    and the bf16 values widened, is the f32 walk on the rounded inputs bit
    for bit, so a score rounded once is the bf16 route's, within one bf16
    ulp of the plain bf16 version (which sums in another order).

The fma is emulated in float64 (the product is exact) rounded once to f32.
"""
import numpy as np
import pytest
import torch

from _torch_parity import carry_tiled
from repro.core import index as jidx
from repro.data.synthetic import make_msmarco_like
from repro.kernels.ell_gather import ell_score
from repro.kernels.scatter_score import scatter_score as jax_scatter
from repro_torch.core import index as tidx
from repro_torch.kernels import query_tiles
from repro_torch.kernels.ell_gather.ref import ell_gather_ref
from repro_torch.kernels.scatter_score import ops as scatter_ops
from repro_torch.kernels.scatter_score.ref import scatter_score_ref

KERNEL_TOL = 1e-5
TILE = query_tiles.QUERY_TILE


def _fma(w, x, acc):
    """f32 fma, elementwise: the product is exact in float64, the sum
    rounded once to f32."""
    return (w.astype(np.float64) * np.float64(x)
            + acc.astype(np.float64)).astype(np.float32)


def _within(got, want):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= KERNEL_TOL * scale


def _numpy(packed):
    """pack_query_tiles' tensors as numpy (a bf16 slab widened: exact)."""
    return tuple((x.float() if x.dtype == torch.bfloat16 else x).numpy()
                 for x in packed)


def _entries(e):
    """(queries, f32 weights) of packed entries: f32 (query, bits) pairs,
    or bf16 words (query | bf16 bits << 16)."""
    if e.ndim == 2:
        return e[:, 0], e[:, 1].view(np.float32)
    return e & 0xFFFF, (e & np.int32(-65536)).view(np.float32)


# (a) the packer ------------------------------------------------------------

def _qw(b, v, nnz, seed, dense_rows=()):
    rng = np.random.default_rng(seed)
    qw = np.zeros((b, v), np.float32)
    for r in range(b):
        qw[r, rng.choice(v, size=min(nnz, v), replace=False)] = \
            rng.uniform(0.05, 3.0, size=min(nnz, v))
    for r in dense_rows:
        qw[r] = np.where(rng.random(v) < 0.9, rng.uniform(0.05, 3.0, v), 0.0)
    return qw


def _check_pack(qw):
    records, entries, cw, dense = (
        x.numpy() for x in query_tiles.pack_query_tiles(torch.from_numpy(qw)))
    b, v = qw.shape
    n_tiles = -(-b // TILE)
    assert records.shape == (n_tiles, v, 2) and records.dtype == np.int32
    assert entries.ndim == 2 and entries.shape[1] == 2
    assert entries.dtype == np.int32 and cw.dtype == np.float32
    assert dense.shape == (n_tiles,) and dense.dtype == np.int32
    padded = np.zeros((n_tiles * TILE, v), np.float32)
    padded[:b] = qw
    n_entries, n_dense = 0, 0
    for g in range(n_tiles):
        rows = min(TILE, b - g * TILE)
        tile = padded[g * TILE:(g + 1) * TILE]
        want_dense = (tile[:rows] != 0).sum() >= \
            query_tiles.DENSE_SHARE * rows * v
        assert bool(dense[g]) == want_dense
        for t in range(v):
            off, n = records[g, t]
            if want_dense:  # the slab's row, padding queries included
                assert (off, n) == ((n_dense * v + t) * TILE, TILE)
                np.testing.assert_array_equal(cw[off:off + n], tile[:, t])
                continue
            # the real queries' nonzero weights, in query order
            want_q = np.flatnonzero(tile[:rows, t])
            assert (off, n) == (n_entries, want_q.size)
            np.testing.assert_array_equal(entries[off:off + n, 0], want_q)
            np.testing.assert_array_equal(
                entries[off:off + n, 1].view(np.float32), tile[want_q, t])
            n_entries += n
        n_dense += want_dense
    # the sparse tiles' entries and the dense tiles' slabs, nothing else
    assert entries.shape[0] == n_entries
    assert cw.shape[0] == n_dense * v * TILE
    return records, dense


@pytest.mark.parametrize("b,v,nnz,dense_rows", [
    (1, 300, 40, ()),  # one query: a ragged tile of one row
    (129, 257, 20, ()),  # a second tile of one real query, 127 padding
    (500, 300, 48, ()),  # serve_1m's batch: 3 tiles + 116 rows
    (130, 200, 0, (128, 129)),  # a zero tile, then a dense one
    (64, 150, 5, tuple(range(64))),  # every row dense
])
def test_pack_query_tiles_equals_its_definition(b, v, nnz, dense_rows):
    qw = _qw(b, v, nnz, seed=b + v, dense_rows=dense_rows)
    records, dense = _check_pack(qw)
    if not qw[:TILE].any():  # an all-zero tile has no entries
        assert not records[0, :, 1].any() and not dense[0]


def test_pack_query_tiles_one_query_per_tile():
    qw = np.zeros((300, 100), np.float32)
    qw[[5, 200, 299], [7, 7, 99]] = [1.5, 0.25, 2.0]
    records, dense = _check_pack(qw)
    assert not dense.any()
    assert records[:, 7, 1].tolist() == [1, 1, 0]
    assert records[:, 99, 1].tolist() == [0, 0, 1]


# (b) scatter_score's order ---------------------------------------------------

@pytest.mark.parametrize("tb,db,cs", [(256, 32, 64), (128, 64, 128),
                                      (128, 16, 64)])
def test_chunk_doc_bounds_equals_its_definition(tb, db, cs):
    """Warp w's slots of each chunk (its docs [w * ceil(D/32), ...)) and the
    live count, on an index with blanked chunks (a tile-skipped one) and,
    at D = 16, warps that own no doc."""
    c = make_msmarco_like(130, 3, vocab_size=500, seed=db)
    j = jidx.filter_tiled_index(
        jidx.build_tiled_index(c.docs, term_block=tb, doc_block=db,
                               chunk_size=cs), c.queries.slice_rows(0, 1))
    t = carry_tiled(j)
    got = scatter_ops.chunk_doc_bounds(t.local_doc, db).numpy()
    assert got.dtype == np.int32 and got.shape == (t.num_chunks, 33)
    per = -(-db // 32)
    for i, ld in enumerate(t.local_doc.numpy()):
        n_live = int((ld >= 0).sum())
        assert (ld[:n_live] >= 0).all() and (np.diff(ld[:n_live]) >= 0).all()
        for w in range(33):
            edge = min(w * per, db)
            assert got[i, w] == int(np.sum(ld[:n_live] < edge)), (i, w)
        assert got[i, 32] == n_live


def _routes(qw, packed):
    """Per tile, its [V, 128] slab for the dense route, or None for the
    sparse route: packed=None takes the dense route everywhere, from qw
    (every pair, zeros included); else :func:`pack_query_tiles`'s output
    decides, and a dense tile's slab is read from its ``cw``."""
    n_tiles = -(-qw.shape[0] // TILE)
    padded = np.zeros((n_tiles * TILE, qw.shape[1]), np.float32)
    padded[:qw.shape[0]] = qw
    if packed is None:
        return [padded[g * TILE:(g + 1) * TILE].T for g in range(n_tiles)]
    records, _, cw, dense = packed
    v = qw.shape[1]
    return [cw[records[g, 0, 0]:records[g, 0, 0] + v * TILE].reshape(v, TILE)
            if dense[g] else None for g in range(n_tiles)]


def emulate_scatter(qw, t, count, packed=None):
    """[B, n_pad] as the CUDA kernel sums it: packed=None is the dense
    route on every tile; else :func:`pack_query_tiles`'s output, each
    tile on its route (the sparse one with its skips)."""
    b = qw.shape[0]
    T, D, n_db = t.term_block, t.doc_block, t.num_doc_blocks
    lt, ld, val = t.local_term.numpy(), t.local_doc.numpy(), t.value.numpy()
    ctb, bcs = t.chunk_term_block.numpy(), t.block_chunk_start.numpy()
    slabs = _routes(qw, packed)
    n_tiles = len(slabs)
    out = np.zeros((n_tiles * TILE, n_db * D), np.float32)
    for g, slab in enumerate(slabs):  # slab [V_pad, 128], or None
        for db in range(n_db):
            win = np.zeros((D, TILE), np.float32)
            for c in range(bcs[db], bcs[db] + count[db]):
                n_live = int((ld[c] >= 0).sum())
                per = max(-(-n_live // 32), 1)
                key, acc = None, None
                for p in range(n_live):
                    d, lo = int(ld[c, p]), int(lt[c, p])
                    if not 0 <= d < D:
                        continue
                    live = 0 <= lo < T
                    term = int(ctb[c]) * T + (lo if live else 0)
                    if slab is not None:
                        q = slice(None)
                        w, x = slab[term], val[c, p] if live else 0.0
                    else:
                        off, n = packed[0][g, term]
                        if not live or n == 0:
                            continue  # no nonzero weight: not summed
                        q, w = _entries(packed[1][off:off + n])
                        x = val[c, p]
                    if (d, p // per) != key:
                        if key is not None:
                            win[key[0]] += acc
                        key, acc = (d, p // per), np.zeros(TILE, np.float32)
                    acc[q] = _fma(w, x, acc[q])
                if key is not None:
                    win[key[0]] += acc
            out[g * TILE:(g + 1) * TILE, db * D:(db + 1) * D] = win.T
    return out[:b]


def _tiled_case(n_docs, vocab, tb, db, cs, n_queries, seed):
    c = make_msmarco_like(n_docs, n_queries, vocab_size=vocab, seed=seed)
    j = jidx.build_tiled_index(c.docs, term_block=tb, doc_block=db,
                               chunk_size=cs)
    qw = np.asarray(c.queries.to_dense())
    qw = np.pad(qw, ((0, 0), (0, j.num_term_blocks * tb - qw.shape[1])))
    return c, j, carry_tiled(j), qw


@pytest.mark.parametrize("n_docs,vocab,tb,db,cs,nq,partial", [
    (150, 600, 256, 32, 64, 5, False),  # chunk_size < term_block
    (150, 600, 256, 32, 64, 5, True),  # partial runs (the two-pass route)
    (201, 500, 128, 64, 128, 3, False),  # a ragged last doc block
])
def test_scatter_order_skips_are_exact_and_match_plain(n_docs, vocab, tb, db,
                                                       cs, nq, partial):
    c, j, t, qw = _tiled_case(n_docs, vocab, tb, db, cs, nq, seed=n_docs)
    qw[1] = 0.0  # an all-zero query
    count = t.block_chunk_count.clone()
    if partial:
        count[1::3] = 0
    packed = tuple(x.numpy() for x in
                   query_tiles.pack_query_tiles(torch.from_numpy(qw)))
    sparse = emulate_scatter(qw, t, count.numpy(), packed)
    dense = emulate_scatter(qw, t, count.numpy())
    np.testing.assert_array_equal(sparse.view(np.int32), dense.view(np.int32))
    assert not sparse[1].any()
    plain = scatter_score_ref(
        torch.from_numpy(qw), t.local_term, t.local_doc, t.value,
        t.chunk_term_block, t.chunk_doc_block, t.block_chunk_start, count,
        term_block=tb, doc_block=db, num_doc_blocks=t.num_doc_blocks).numpy()
    _within(sparse, plain)
    if not partial:
        c.queries.values = c.queries.values.at[1].set(0.0)
        pallas = np.asarray(jax_scatter(c.queries, j))
        _within(sparse[:, :n_docs], pallas)


def test_scatter_order_with_two_tiles_and_a_dense_one():
    """130 queries: a sparse tile and a ragged one of two nearly dense
    queries (the dense route): still the plain version's scores."""
    c, j, t, qw = _tiled_case(60, 300, 128, 32, 64, 130, seed=3)
    rng = np.random.default_rng(0)
    qw[128:] = np.where(rng.random(qw[128:].shape) < 0.9,
                        rng.uniform(0.05, 3.0, qw[128:].shape), 0.0)
    qw[:, 300:] = 0.0  # V_pad's padding terms
    pack = query_tiles.pack_query_tiles(torch.from_numpy(qw))
    assert pack[3].tolist() == [0, 1]
    count = t.block_chunk_count.numpy()
    sparse = emulate_scatter(qw, t, count, tuple(x.numpy() for x in pack))
    np.testing.assert_array_equal(sparse, emulate_scatter(qw, t, count))
    plain = scatter_score_ref(
        torch.from_numpy(qw), t.local_term, t.local_doc, t.value,
        t.chunk_term_block, t.chunk_doc_block, t.block_chunk_start,
        t.block_chunk_count, term_block=128, doc_block=32,
        num_doc_blocks=t.num_doc_blocks).numpy()
    _within(sparse, plain)


# (c) ell_gather's order --------------------------------------------------------

def emulate_ell(qw, terms, values, packed=None):
    """[B, N_pad] as the CUDA kernel sums it (a doc's slots in order, from
    +0): packed=None is the dense route on every tile, else each tile on
    its route (the sparse one with its skips)."""
    b, v = qw.shape
    slabs = _routes(qw, packed)
    n_tiles = len(slabs)
    out = np.zeros((n_tiles * TILE, terms.shape[0]), np.float32)
    for g, slab in enumerate(slabs):
        for n in range(terms.shape[0]):
            acc = np.zeros(TILE, np.float32)
            for k in range(terms.shape[1]):
                tk = int(terms[n, k])
                live = 0 <= tk < v
                if slab is not None:
                    q = slice(None)
                    w, x = slab[tk if live else 0], values[n, k] if live else 0.0
                else:
                    off, cnt = packed[0][g, tk] if live else (0, 0)
                    if cnt == 0:
                        continue
                    q, w = _entries(packed[1][off:off + cnt])
                    x = values[n, k]
                acc[q] = _fma(w, x, acc[q])
            out[g * TILE:(g + 1) * TILE, n] = acc
    return out[:b]


@pytest.mark.parametrize("n_docs,vocab,nq", [(96, 300, 5), (70, 400, 2)])
def test_ell_order_skips_are_exact_and_match_plain(n_docs, vocab, nq):
    c = make_msmarco_like(n_docs, nq, vocab_size=vocab, seed=n_docs + 1)
    j = jidx.build_ell_index(c.docs)
    e = tidx.ell_index_from_numpy(j.terms, j.values, j.num_docs,
                                  j.vocab_size, device="cpu")
    qw = np.array(c.queries.to_dense())
    qw[0] = 0.0  # an all-zero query
    terms, values = e.terms.numpy(), e.values.numpy()
    assert (terms == vocab).any()  # padding ids are vocab
    packed = tuple(x.numpy() for x in
                   query_tiles.pack_query_tiles(torch.from_numpy(qw)))
    sparse = emulate_ell(qw, terms, values, packed)
    np.testing.assert_array_equal(sparse, emulate_ell(qw, terms, values))
    assert not sparse[0].any()
    _within(sparse, ell_gather_ref(torch.from_numpy(qw), e.terms,
                                   e.values).numpy())
    c.queries.values = c.queries.values.at[0].set(0.0)
    pallas = np.asarray(ell_score(c.queries, j, doc_block=32, k_chunk=8))
    _within(sparse[:, :n_docs], pallas)


# (d) the route -----------------------------------------------------------------

@pytest.mark.parametrize("counts,rows,width,want", [
    ([0, 5, 8_699], [128, 128, 116], 150, [False, False, False]),
    ([9_600, 9_599, 8_700], [128, 128, 116], 150, [True, False, True]),  # half: dense
    ([58, 57], [1, 1], 115, [True, False]),  # one-row tiles (B = 1)
    ([8_000_000], [128], 30720, [True]),  # an encoder tile
    ([6_093], [128], 30720, [False]),  # a serve_1m tile (47.6 terms a query)
])
def test_route_is_a_pure_function_of_the_counts(counts, rows, width, want):
    counts, rows = torch.tensor(counts), torch.tensor(rows)
    got = query_tiles.dense_tiles(counts, rows, width)
    assert got.tolist() == want
    assert torch.equal(got, query_tiles.dense_tiles(counts.clone(),
                                                    rows.clone(), width))


def test_route_follows_the_count_not_the_places():
    """Two tiles with the same nonzero count, in other (query, term)
    places, take the same route."""
    rng = np.random.default_rng(4)
    qw = np.zeros((256, 40), np.float32)
    first = rng.choice(128 * 40, size=2560, replace=False)
    second = rng.choice(128 * 40, size=2560, replace=False)
    qw[:128].reshape(-1)[first] = 1.0
    qw[128:].reshape(-1)[second] = 2.0
    dense = query_tiles.pack_query_tiles(torch.from_numpy(qw))[3]
    assert dense.tolist() == [1, 1]
    assert query_tiles.tile_rows(256).tolist() == [128, 128]
    assert query_tiles.tile_rows(129).tolist() == [128, 1]


# (e) the bf16 routes ---------------------------------------------------------

def _bf16(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16 (nearest, ties to even), held in f32."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("b,v,nnz,dense_rows", [
    (129, 257, 20, ()), (500, 300, 48, ()), (130, 200, 0, (128, 129)),
])
def test_pack_query_tiles_bf16_equals_its_definition(b, v, nnz, dense_rows):
    """The bf16 packing: the f32 packing's records and routes for the
    rounded weights; an entry is one word, the query in bits 0-15 and the
    weight's bf16 bits in bits 16-31; the slab is the rounded weights."""
    qw = _bf16(_qw(b, v, nnz, seed=b + 2 * v, dense_rows=dense_rows))
    bf = query_tiles.pack_query_tiles(torch.from_numpy(qw).to(torch.bfloat16))
    records, entries, cw, dense = _numpy(bf)
    assert bf[1].dtype == torch.int32 and entries.ndim == 1
    assert bf[2].dtype == torch.bfloat16
    want = _numpy(query_tiles.pack_query_tiles(torch.from_numpy(qw)))
    np.testing.assert_array_equal(records, want[0])
    np.testing.assert_array_equal(dense, want[3])
    q, w = _entries(entries)
    np.testing.assert_array_equal(q, want[1][:, 0])
    np.testing.assert_array_equal(w, want[1][:, 1].view(np.float32))
    np.testing.assert_array_equal(cw, want[2])


def _bf16_within_ulp(got, want):
    """Each bf16 value within one bf16 ulp of ``want``'s."""
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    assert np.all(np.abs(got - want) <= ulp)


def test_scatter_bf16_walk_is_the_f32_walk_rounded_once():
    c, j, t, qw = _tiled_case(150, 600, 256, 32, 64, 130, seed=7)
    rng = np.random.default_rng(1)
    qw[128:] = np.where(rng.random(qw[128:].shape) < 0.9,
                        rng.uniform(0.05, 3.0, qw[128:].shape), 0.0)
    qw[:, 600:] = 0.0
    qb = torch.from_numpy(qw).to(torch.bfloat16)
    tb = torch.from_numpy(_bf16(t.value.numpy()))
    t_b = tidx.TiledIndex(**{**t.__dict__, "value": tb})
    count = t.block_chunk_count.numpy()
    packed = _numpy(query_tiles.pack_query_tiles(qb))
    assert packed[3].tolist() == [0, 1]  # both routes
    walk = emulate_scatter(qb.float().numpy(), t_b, count, packed)
    f32 = emulate_scatter(qb.float().numpy(), t_b, count, _numpy(
        query_tiles.pack_query_tiles(qb.float())))
    np.testing.assert_array_equal(walk.view(np.int32), f32.view(np.int32))
    plain = scatter_score_ref(
        qb, t.local_term, t.local_doc, tb.to(torch.bfloat16),
        t.chunk_term_block, t.chunk_doc_block, t.block_chunk_start,
        t.block_chunk_count, term_block=256, doc_block=32,
        num_doc_blocks=t.num_doc_blocks)
    assert plain.dtype == torch.bfloat16
    _bf16_within_ulp(_bf16(walk), plain.float().numpy())


def test_ell_bf16_walk_is_the_f32_walk_rounded_once():
    c = make_msmarco_like(90, 130, vocab_size=300, seed=5)
    j = jidx.build_ell_index(c.docs)
    e = tidx.ell_index_from_numpy(j.terms, j.values, j.num_docs,
                                  j.vocab_size, device="cpu")
    qw = np.array(c.queries.to_dense())
    rng = np.random.default_rng(2)
    qw[128:] = np.where(rng.random(qw[128:].shape) < 0.9,
                        rng.uniform(0.05, 3.0, qw[128:].shape), 0.0)
    qb = torch.from_numpy(qw).to(torch.bfloat16)
    vb = e.values.to(torch.bfloat16)
    terms, values = e.terms.numpy(), vb.float().numpy()
    packed = _numpy(query_tiles.pack_query_tiles(qb))
    assert packed[3].tolist() == [0, 1]
    walk = emulate_ell(qb.float().numpy(), terms, values, packed)
    f32 = emulate_ell(qb.float().numpy(), terms, values, _numpy(
        query_tiles.pack_query_tiles(qb.float())))
    np.testing.assert_array_equal(walk.view(np.int32), f32.view(np.int32))
    plain = ell_gather_ref(qb, e.terms, vb)
    assert plain.dtype == torch.bfloat16
    _bf16_within_ulp(_bf16(walk), plain.float().numpy())
