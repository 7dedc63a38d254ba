"""The CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and ``nvcc`` and skip without them.  The
file imports no JAX, so it runs on a machine that has only the port's
dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerance: max |kernel - plain| <= 1e-5 * max |plain| — the same f32
products summed in another order.
"""
import pytest
import torch

from repro_torch.core import index as tidx
from repro_torch.core.engine import RetrievalConfig, RetrievalEngine
from repro_torch.data.synthetic import make_msmarco_like
from repro_torch.kernels.ell_gather import ops as ell_ops
from repro_torch.kernels.ell_gather.ref import ell_gather_ref
from repro_torch.kernels.scatter_score import ops as scatter_ops
from repro_torch.kernels.scatter_score.ref import scatter_score_ref

TOL = 1e-5


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want):
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= TOL * want.abs().max().item(), err


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
        want = scatter_score_ref(qw, *_tiled_args(ix), term_block=tb,
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


def test_cuda_tensors_never_reach_the_plain_version(cuda, monkeypatch):
    """A CUDA tensor goes to the kernel or raises; a bad operand raises
    before any launch."""
    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(scatter_ops, "scatter_score_ref", boom)
    monkeypatch.setattr(ell_ops, "ell_gather_ref", boom)
    c = make_msmarco_like(500, 8, vocab_size=2000, seed=1, device=cuda)
    for name in ("tiled", "ell"):
        v, i = RetrievalEngine(c.docs, RetrievalConfig(engine=name, k=10),
                               device=cuda).search(c.queries)
        assert v.shape == (8, 10)
    e = tidx.build_ell_index(c.docs)
    with pytest.raises(TypeError):
        ell_ops.ell_gather(c.queries.to_dense(), e.terms.long(), e.values)
