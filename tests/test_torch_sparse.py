"""repro_torch.core.sparse vs repro.core.sparse, and the on-device
generator's laws vs repro.data.synthetic's, on the CPU."""
import numpy as np
import pytest
import torch

from repro.core import sparse as jsparse
from repro.data import synthetic as jsyn
from repro_torch.core import sparse as tsparse
from repro_torch.data import synthetic as tsyn

ROWS = [np.array([5, 1, 3], np.int32), np.array([], np.int32),
        np.array([2, 2, 0], np.int32)]  # unsorted, empty, duplicate ids
VALS = [np.array([0.5, 1.5, 2.5], np.float32), np.array([], np.float32),
        np.array([1.0, 2.0, 3.0], np.float32)]


@pytest.mark.parametrize("pad_to", [None, 6])
def test_from_lists_to_dense_and_back_match_jax(pad_to):
    j = jsparse.from_lists(ROWS, VALS, vocab_size=7, pad_to=pad_to)
    t = tsparse.from_lists(ROWS, VALS, vocab_size=7, pad_to=pad_to,
                           device="cpu")
    np.testing.assert_array_equal(t.term_ids.numpy(), np.asarray(j.term_ids))
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    # duplicate ids accumulate (row 2 holds term 2 twice)
    np.testing.assert_array_equal(t.to_dense().numpy(),
                                  np.asarray(j.to_dense()))
    np.testing.assert_array_equal(t.nnz_per_row().numpy(),
                                  np.asarray(j.nnz_per_row()))
    for a, b in zip(tsparse.to_numpy_rows(t), jsparse.to_numpy_rows(j)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    s = t.slice_rows(1, 2).astype(torch.float64)
    assert (s.batch, s.values.dtype) == (2, torch.float64)


def test_dense_to_sparse_matches_jax():
    rng = np.random.default_rng(0)
    dense = np.where(rng.uniform(size=(4, 9)) < 0.3,
                     rng.uniform(size=(4, 9)), 0.0).astype(np.float32)
    j = jsparse.dense_to_sparse(dense, pad_to=5)
    for src in (dense, torch.from_numpy(dense)):
        t = tsparse.dense_to_sparse(src, pad_to=5, device="cpu")
        np.testing.assert_array_equal(t.term_ids.numpy(),
                                      np.asarray(j.term_ids))
        np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))


def test_dense_to_sparse_equals_the_per_row_build():
    """The vectorised build gives what the per-row host loop gave: each
    row's nonzero ids ascending, values as f32, the same padding."""
    rng = np.random.default_rng(3)
    dense = np.where(rng.uniform(size=(5, 40)) < 0.4,
                     rng.normal(size=(5, 40)), 0.0)  # f64, signed values
    dense[2] = 0.0  # an all-zero row
    dense[4, :] = rng.uniform(0.1, 1.0, size=40)  # a full row: K = V
    for pad_to in (None, 50):
        ids = [np.nonzero(r)[0].astype(np.int32) for r in dense]
        vals = [r[np.nonzero(r)[0]].astype(np.float32) for r in dense]
        old = tsparse.from_lists(ids, vals, vocab_size=40, pad_to=pad_to,
                                 device="cpu")
        new = tsparse.dense_to_sparse(torch.from_numpy(dense), pad_to=pad_to,
                                      device="cpu")
        assert new.vocab_size == 40
        assert torch.equal(new.term_ids, old.term_ids)
        assert torch.equal(new.values, old.values)
    empty = tsparse.dense_to_sparse(np.zeros((0, 7), np.float32),
                                    device="cpu")
    assert tuple(empty.term_ids.shape) == (0, 1)


def test_from_lists_rejects_ragged_input():
    with pytest.raises(ValueError, match="rows"):
        tsparse.from_lists(ROWS, VALS[:2], vocab_size=7, device="cpu")


def _stats(ids, vals, vocab):
    live = ids >= 0
    df = np.bincount(ids[live], minlength=vocab)
    return (live.sum(1).mean(), live.sum(1).std(), vals[live].mean(),
            df[:10] / live.sum())


def test_generator_keeps_the_numpy_laws():
    """Same laws, other numbers: nnz per doc and query, the weight law and
    the Zipf head agree with the numpy generator to sampling noise; rows
    are sorted, distinct, padded at the end."""
    n, vocab = 2000, 3000
    j = jsyn.make_msmarco_like(n, 300, vocab_size=vocab, seed=0)
    t = tsyn.make_msmarco_like(n, 300, vocab_size=vocab, seed=0, device="cpu")
    tid, tval = t.docs.term_ids.numpy(), t.docs.values.numpy()
    js = _stats(np.asarray(j.docs.term_ids), np.asarray(j.docs.values), vocab)
    ts = _stats(tid, tval, vocab)
    assert ts[0] == pytest.approx(js[0], rel=0.03)  # mean nnz/doc ~127
    assert ts[1] == pytest.approx(js[1], rel=0.1)
    assert ts[2] == pytest.approx(js[2], rel=0.03)
    np.testing.assert_allclose(ts[3], js[3], rtol=0.1)
    live = tid >= 0
    assert np.all(tval[live] >= 0.01) and np.all(tval[live] <= 3.5)
    assert np.all(tval[~live] == 0)
    for row, m in zip(tid, live):
        assert np.all(np.diff(row[m]) > 0) and not np.any(m[m.sum():])
    qj = np.asarray(j.queries.term_ids) >= 0
    qt = t.queries.term_ids.numpy() >= 0
    assert qt.sum(1).mean() == pytest.approx(qj.sum(1).mean(), rel=0.08)
    # a query shares its copied terms with its relevant doc
    for q, rel in zip(t.queries.term_ids.numpy()[:20], t.qrels[:20]):
        (d,) = rel
        assert len(np.intersect1d(q[q >= 0], tid[d][tid[d] >= 0])) >= 1
