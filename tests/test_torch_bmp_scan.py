"""The port's BMP sweep (plain version and entries) vs the JAX package.

The reference Pallas ``bmp_scan`` kernel does not trace on this JAX, so
the port is held against what defines it: ``_bmp_sweep_impl`` (the jnp
sweep) and ``repro.kernels.bmp_scan.ref.bmp_scan_ref``, whose fetch sets
and step counts the fused kernel reproduces by contract.  The port's sweep
is fed the JAX bounds, so the visit order is the same: block and chunk
sets and step counts must be equal, tau and the scores allclose (rtol
1e-5 / atol 1e-6: f32 sums in another order).  The indices are the JAX
builds, carried across field by field.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import ATOL, RTOL, carry_tiled, port_batch
from repro.core import index as jidx
from repro.core import scoring as jscoring
from repro.data.synthetic import make_topical_corpus
from repro.kernels.bmp_scan.ref import bmp_scan_ref as jax_bmp_scan_ref
from repro_torch.core import scoring as tscoring
from repro_torch.kernels.bmp_scan import ops as bmp_ops
from repro_torch.kernels.bmp_scan.ref import bmp_scan_ref, bmp_sweep_ref
from repro_torch.sched.planner import PAD_TAU


@pytest.fixture(scope="module")
def corpus():
    c = make_topical_corpus(1001, 8, vocab_size=1500, num_topics=6,
                            topic_vocab=150, seed=5)  # ragged: 1001 docs
    docs, _ = jidx.reorder_docs(c.docs, method="df-signature")
    return c, docs


def _indices(corpus, db, cs):
    c, docs = corpus
    j = jidx.build_tiled_index(docs, term_block=256, doc_block=db,
                               chunk_size=cs, store_term_block_max=True)
    return j, carry_tiled(j)


def _allclose_inf(got, want):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


# (doc_block, chunk_size, k, theta, warm tau, deleted docs, rows)
CASES = [
    (16, 32, 5, 1.0, False, False, 2),  # flat sweep that retires early
    (32, 64, 10, 0.8, False, False, 8),  # theta < 1
    (16, 32, 5, 1.0, True, True, 4),  # tau_init and an alive mask
]


@pytest.mark.parametrize("db,cs,k,theta,warm,dead,rows", CASES)
def test_bmp_sweep_ref_reproduces_jax_trajectory(corpus, db, cs, k, theta,
                                                 warm, dead, rows):
    c, _ = corpus
    j, t = _indices(corpus, db, cs)
    q = c.queries.slice_rows(0, rows)
    qw = jscoring._pad_queries_to_term_blocks(q, j)
    ub = jscoring.block_upper_bounds(q, j, qw=qw)
    tau0 = np.full(rows, -np.inf, np.float32)
    if warm:
        tau0[0] = 2.5
        tau0[-1] = PAD_TAU
    alive = None
    if dead:
        alive = np.ones(j.num_docs, bool)
        alive[::5] = False
    want = jscoring._bmp_sweep_impl(
        qw, j.local_term, j.local_doc, j.value, j.chunk_term_block,
        j.chunk_doc_block, j.block_chunk_start, j.block_chunk_count, ub,
        jnp.float32(theta), jnp.asarray(tau0),
        None if alive is None else jnp.asarray(alive),
        num_docs=j.num_docs, term_block=256, doc_block=db, k_eff=k,
    )
    ub_t = torch.from_numpy(np.array(ub))
    order = torch.argsort(-ub_t, dim=-1, stable=True)
    alive_t = None if alive is None else torch.from_numpy(alive)
    scores, heap, bsc, csc, steps = bmp_sweep_ref(
        torch.from_numpy(np.array(qw)), order, ub_t.gather(-1, order),
        torch.from_numpy(tau0), t.block_chunk_start, t.block_chunk_count,
        t.chunk_term_block, t.chunk_doc_block, t.local_term, t.local_doc,
        t.value, alive_t, term_block=256, doc_block=db, k_eff=k,
        theta=theta, num_docs=t.num_docs,
    )
    np.testing.assert_array_equal(bsc.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(csc.numpy(), np.asarray(want[3]))
    assert steps == int(want[4])
    tau = torch.maximum(torch.from_numpy(tau0), heap[:, -1])
    np.testing.assert_allclose(tau.numpy(), np.asarray(want[1]), rtol=RTOL,
                               atol=ATOL)
    mask = tscoring._doc_mask(bsc, db, t.num_docs, alive_t)
    out = torch.where(mask, scores[:, : t.num_docs], float("-inf"))
    _allclose_inf(out.numpy(), want[0])
    if rows == 2:  # the flat sweep really retired: not every block scored
        assert 0 < bsc.sum() < t.num_doc_blocks


def test_bmp_scan_ref_fetch_sets_match_jax(corpus):
    c, _ = corpus
    j, t = _indices(corpus, 16, 32)
    groups = [np.array([0, 2, 5]), np.array([1]), np.array([3, 4, 6, 7])]
    tau_init = np.full(8, -np.inf, np.float32)
    tau_init[6] = 3.0
    jo, jt, jg = jax_bmp_scan_ref(c.queries, j, 5, groups,
                                  tau_init=tau_init)
    po, pt, pg = bmp_scan_ref(port_batch(c.queries), t, 5, groups,
                              tau_init=tau_init)
    for a, b in zip(pg, jg):
        np.testing.assert_array_equal(a["rows"], b["rows"])
        np.testing.assert_array_equal(a["block_scored"], b["block_scored"])
        np.testing.assert_array_equal(a["chunk_scored"], b["chunk_scored"])
        assert a["steps"] == b["steps"]
    _allclose_inf(po.numpy(), jo)
    np.testing.assert_allclose(pt, jt, rtol=RTOL, atol=ATOL)


def test_bmp_sweep_entry_on_cpu_is_the_plain_version(corpus):
    """A CPU tensor runs the plain version group by group and counts no
    launch."""
    c, _ = corpus
    _, t = _indices(corpus, 32, 64)
    q = port_batch(c.queries)
    qw = tscoring._pad_queries_to_term_blocks(q, t)
    ub = tscoring.block_upper_bounds(q, t, qw=qw)
    order = torch.argsort(-ub, dim=-1, stable=True)
    sel = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]])
    tau0 = torch.full((2, 4), float("-inf"))
    tau0[1, 3] = PAD_TAU
    runs = (t.block_chunk_start, t.block_chunk_count, t.chunk_term_block,
            t.chunk_doc_block, t.local_term, t.local_doc, t.value)
    kw = dict(term_block=256, doc_block=32, k_eff=7, theta=1.0,
              num_docs=t.num_docs)
    before = bmp_ops.launches
    got = bmp_ops.bmp_sweep(qw[sel], order[sel].int(),
                            ub.gather(-1, order)[sel], tau0, *runs, **kw)
    assert bmp_ops.launches == before
    for g in range(2):
        want = bmp_sweep_ref(qw[sel[g]], order[sel[g]],
                             ub.gather(-1, order)[sel[g]], tau0[g], *runs,
                             **kw)
        assert torch.equal(got[0][g], want[0])
        assert torch.equal(got[1][g], want[1])
        assert torch.equal(got[2][g], want[2].int())
        assert torch.equal(got[3][g], want[3].int())
        assert int(got[4][g, 0]) == want[4]


@pytest.mark.parametrize("groups", [
    None,  # the demand planner's plan
    [list(range(8))],  # one group: the flat sweep
    [[i] for i in range(8)],  # singletons
    [[0, 7], [1, 2, 3, 4, 5], [6]],
])
def test_grouped_and_fused_equal_flat_with_less_work(corpus, groups):
    c, _ = corpus
    _, t = _indices(corpus, 16, 32)
    q = port_batch(c.queries)
    flat, fst = tscoring.score_tiled_bmp(q, t, 5, return_stats=True)
    out, st, tau = tscoring.score_tiled_bmp_grouped(
        q, t, 5, groups=groups, return_stats=True, return_tau=True)
    fout, fst2, ftau = bmp_ops.bmp_scan(q, t, 5, groups=groups,
                                        return_stats=True, return_tau=True)
    assert torch.equal(out, fout) and torch.equal(tau, ftau)
    assert st.kernel_launches == 0 and st.launches == st.num_groups
    assert fst2.kernel_launches == len(set(fst2.padded_group_sizes))
    assert (st.chunks_scored_per_group, st.sweep_steps) == (
        fst2.chunks_scored_per_group, fst2.sweep_steps)
    assert st.chunk_work <= fst.chunks_scored * q.batch
    for a, b in ((out, flat), (fout, flat)):
        va, ia = torch.topk(a, 5)
        vb, ib = torch.topk(b, 5)
        assert torch.equal(va, vb) and torch.equal(ia, ib)


def test_fused_bucket_above_the_tpu_row_cap(corpus):
    """A 256-row bucket is one launch (the TPU kernel capped buckets at 128
    rows and ran larger ones through its oracle, group by group)."""
    c, _ = corpus
    _, t = _indices(corpus, 32, 64)
    q = port_batch(c.queries)
    rep = type(q)(q.term_ids.repeat(20, 1), q.values.repeat(20, 1),
                  q.vocab_size)  # 160 rows
    out, st = bmp_ops.bmp_scan(rep, t, 3, groups=[np.arange(160)],
                               return_stats=True)
    assert st.padded_group_sizes == (256,) and st.kernel_launches == 1
    flat = tscoring.score_tiled_bmp(rep, t, 3)
    assert torch.equal(torch.topk(out, 3).values, torch.topk(flat, 3).values)
