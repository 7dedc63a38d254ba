"""repro_torch.core.topk vs repro.core.topk (``lax.top_k``), on the CPU.

Inputs carry deliberate exact ties (values drawn from a few levels), so
ids match only if the port breaks ties towards the lower index as
``lax.top_k`` does — within a block, across the blocks of
``topk_two_stage``, and at the k-th value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topk as jtopk
from repro_torch.core import topk as ttopk


def _tied(shape, levels, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, levels, size=shape).astype(np.float32)
    x[..., ::7] = -np.inf  # masked slots tie among themselves too
    return x


def _eq(port, ref):
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))


@pytest.mark.parametrize("shape,k,levels", [
    ((3, 50), 10, 4),
    ((4, 300), 300, 3),  # k == n: the whole order
    ((2, 5, 64), 17, 2),  # leading batch dims
    ((3, 40), 39, 1),  # one value: ties decide everything
])
def test_topk_matches_lax_top_k(shape, k, levels):
    x = _tied(shape, levels, seed=k)
    _eq(ttopk.topk(torch.from_numpy(x), k), jax.lax.top_k(jnp.asarray(x), k))


@pytest.mark.parametrize("n,k,block,levels", [
    (1000, 100, 64, 3),  # ties span many blocks
    (1000, 100, 4096, 3),  # one block: plain top-k
    (999, 250, 100, 5),  # ragged last block, k > block
    (513, 7, 8, 2),
])
def test_topk_two_stage_matches_jax(n, k, block, levels):
    x = _tied((4, n), levels, seed=n + k)
    port = ttopk.topk_two_stage(torch.from_numpy(x), k, block=block)
    _eq(port, jtopk.topk_two_stage(jnp.asarray(x), k, block=block))
    _eq(port, jax.lax.top_k(jnp.asarray(x), k))


@pytest.mark.parametrize("rows,n,k,block,levels,step", [
    (7, 1000, 100, 64, 2, 3),  # heavy ties; 7 rows in steps of 3, 3, 1
    (5, 999, 250, 100, 5, 2),  # a short last slab in JAX; k > block
    (4, 700, 700, 128, 3, 1),  # k == n, one row a step
    (3, 130, 100, 64, 1, 2),  # one value: JAX's tail slab (2) < k
])
def test_row_sliced_topk_two_stage_matches_topk_and_jax(
        rows, n, k, block, levels, step, monkeypatch):
    """``topk_two_stage`` with its tie repair a few rows at a time
    (``_TIE_ELEMS`` lowered to ``step`` rows) equals the one-step call,
    :func:`topk` and JAX's ``topk_two_stage`` (which pads a short last
    slab with -inf), on a strided view of wider scores as the engines pass
    it."""
    x = _tied((rows, n + 5), levels, seed=rows * n + k)
    view = torch.from_numpy(x)[:, :n]  # row stride n + 5
    whole = ttopk.topk_two_stage(view, k, block=block)
    monkeypatch.setattr(ttopk, "_TIE_ELEMS", step * n)
    port = ttopk.topk_two_stage(view, k, block=block)
    _eq(port, whole)
    _eq(port, ttopk.topk(view, k))
    _eq(port, jtopk.topk_two_stage(jnp.asarray(x[:, :n]), k, block=block))


def test_merge_topk_and_topk_with_ids_match_jax():
    rng = np.random.default_rng(0)
    va = np.sort(_tied((3, 20), 4, 1), axis=1)[:, ::-1].copy()
    vb = np.sort(_tied((3, 30), 4, 2), axis=1)[:, ::-1].copy()
    ia = rng.integers(0, 1000, size=(3, 20))
    ib = rng.integers(0, 1000, size=(3, 30))
    t = [torch.from_numpy(a) for a in (va, ia, vb, ib)]
    j = [jnp.asarray(a) for a in (va, ia, vb, ib)]
    _eq(ttopk.merge_topk(*t, 25), jtopk.merge_topk(*j, 25))
    _eq(ttopk.topk_with_ids(t[2], t[3], 12),
        jtopk.topk_with_ids(j[2], j[3], k=12))


@pytest.mark.parametrize("k_req", [3, 5, 8])
def test_certify_tau_matches_jax(k_req):
    vals = np.array([[5, 4, 3, 2, 1], [9, 8, -np.inf, -np.inf, -np.inf]],
                    np.float32)
    prev = np.array([2.5, 10.0], np.float32)
    for p in (None, prev):
        np.testing.assert_array_equal(
            ttopk.certify_tau(torch.from_numpy(vals), k_req, p),
            jtopk.certify_tau(vals, k_req, p),
        )


def _oracle_corpus(n, b, vocab, dyadic, seed):
    """A port ``SparseBatch`` of docs and one of queries: docs 0-3 empty,
    every doc from 40 on a copy of one before it (ties across the whole
    range), weights multiples of 2^-8 when ``dyadic`` (every float64 sum
    exact, in any order)."""
    from repro_torch.core.sparse import SparseBatch

    rng = np.random.default_rng(seed)

    def rows(count, width):
        ids = np.full((count, width), -1, np.int32)
        vals = np.zeros((count, width), np.float32)
        for r in range(count):
            m = rng.integers(1, width + 1)
            ids[r, :m] = rng.choice(vocab, m, replace=False)
            v = rng.uniform(0.05, 3.0, m)
            vals[r, :m] = np.round(v * 256) / 256 if dyadic else v
        return ids, vals

    d_ids, d_vals = rows(n, 12)
    d_ids[:4], d_vals[:4] = -1, 0.0
    src = rng.integers(0, 40, n - 40)
    d_ids[40:], d_vals[40:] = d_ids[src], d_vals[src]
    q_ids, q_vals = rows(b, 6)
    docs = SparseBatch(torch.from_numpy(d_ids), torch.from_numpy(d_vals),
                       vocab)
    queries = SparseBatch(torch.from_numpy(q_ids), torch.from_numpy(q_vals),
                          vocab)
    return docs, queries


def _numpy_f64_topk(docs, queries, k):
    """The float64 top-k by numpy: dense scores, a stable argsort of their
    negation (ties to the lower id)."""
    def dense(batch):
        out = np.zeros((batch.batch, batch.vocab_size))
        ids, vals = batch.term_ids.numpy(), batch.values.numpy()
        r, c = np.nonzero(ids >= 0)
        out[r, ids[r, c]] = vals[r, c]
        return out

    scores = dense(queries) @ dense(docs).T
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, order, 1), order


@pytest.mark.parametrize("n,k", [(157, 30), (157, 157), (60, 80)])
@pytest.mark.parametrize("dyadic", [True, False])
def test_ranged_topk_f64_equals_one_shot_and_numpy(n, k, dyadic,
                                                   monkeypatch):
    """``scoring.topk_f64`` a range of 1 and of 3 docs a step
    (``_ORACLE_ELEMS`` lowered) gives the one-shot call's values and ids
    bit for bit, with ties at the k-th value (copied docs) to the lower
    id, empty docs scoring 0 and k > N cut to N; on dyadic weights it is
    numpy's float64 top-k (a stable argsort) bit for bit too."""
    from repro_torch.core import scoring as tscoring

    docs, queries = _oracle_corpus(n, 9, 300, dyadic, seed=n + k)
    one = tscoring.topk_f64(queries, docs, k)
    assert one[0].shape == (9, min(k, n)) and one[0].dtype == torch.float64
    want_v, want_i = _numpy_f64_topk(docs, queries, min(k, n))
    ties = 0
    for rows in (1, 3):
        monkeypatch.setattr(tscoring, "_ORACLE_ELEMS", 9 * rows)
        got = tscoring.topk_f64(queries, docs, k)
        _eq(got, one)
    for row in range(9):
        v = want_v[row]
        ties += int(np.any((v[:-1] == v[1:]) & (v[1:] == v[-1])))
    assert ties > 0  # the k-th value ties in some row
    if dyadic:
        _eq(one, (want_v, want_i))
    else:
        np.testing.assert_allclose(one[0].numpy(), want_v, rtol=1e-15)
