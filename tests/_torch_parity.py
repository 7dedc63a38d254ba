"""Helpers shared by the port's CPU parity tests (``test_torch_*.py``).

``assert_same_topk`` compares two (values, ids) top-k results tie-aware:
values allclose at rtol 1e-5 / atol 1e-6 (f32 sums in another order), ids
equal except inside a run of reference values closer than that tolerance
(an f32 near-tie, which the two packages may order either way): there
only the set of ids must match, and in the run that reaches the k-th slot
— which may go on past the cut — each id must carry its float64 score.
"""
import numpy as np
import torch

from repro_torch.core import index as tidx
from repro_torch.core.sparse import SparseBatch

RTOL, ATOL = 1e-5, 1e-6


def port_batch(batch) -> SparseBatch:
    """A JAX ``SparseBatch`` as the port's, on the CPU."""
    return SparseBatch(torch.from_numpy(np.array(batch.term_ids)),
                       torch.from_numpy(np.array(batch.values)),
                       batch.vocab_size)


def carry_tiled(j):
    """A JAX ``TiledIndex`` as the port's, on the CPU, field for field."""
    fields = tidx.TILED_ARRAY_FIELDS + tidx.TILED_OPTIONAL_ARRAY_FIELDS
    return tidx.tiled_index_from_numpy(
        {f: getattr(j, f) for f in fields if getattr(j, f) is not None},
        {f: getattr(j, f) for f in tidx.TILED_SCALAR_FIELDS}, device="cpu",
    )


def assert_same_topk(port, ref, oracle, deleted=None):
    (pv, pi), (rv, ri) = port, ref
    np.testing.assert_allclose(pv, rv, rtol=RTOL, atol=ATOL)
    k = rv.shape[1]
    for row in range(rv.shape[0]):
        v = rv[row]
        with np.errstate(invalid="ignore"):  # -inf - -inf
            same = (v[1:] == v[:-1]) | (
                np.abs(v[1:] - v[:-1]) <= ATOL + RTOL * np.abs(v[1:]))
        starts = np.concatenate([[0], np.nonzero(~same)[0] + 1])
        ends = np.concatenate([starts[1:], [k]])
        for s, e in zip(starts, ends):
            if e < k:
                assert set(pi[row, s:e]) == set(ri[row, s:e]), (row, s, e)
        live = np.isfinite(pv[row])
        assert np.all(pi[row][~live] == -1)
        got = oracle[row, pi[row][live]]
        np.testing.assert_allclose(pv[row][live], got, rtol=RTOL, atol=ATOL)
        if deleted is not None:
            assert not np.any(deleted[pi[row][live]])
