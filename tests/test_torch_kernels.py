"""The port's plain kernel versions vs the Pallas kernels (interpret mode).

Both sides score the very same index: the JAX package builds it, and the
port takes its arrays across with ``tiled_index_from_numpy`` /
``ell_index_from_numpy``.  Tolerance rtol 1e-5 / atol 1e-6: the Pallas
kernels sum through a one-hot matmul, the port through ``index_add_`` /
a slot sum — the same f32 products in another order.
"""
import numpy as np
import pytest
import torch

from _torch_parity import carry_tiled
from repro.core import index as jidx
from repro.data.synthetic import make_msmarco_like
from repro.kernels.ell_gather import ell_score
from repro.kernels.ell_gather.ref import ell_gather_ref as jax_ell_ref
from repro.kernels.scatter_score import scatter_score as jax_scatter
from repro.kernels.scatter_score.ref import scatter_score_ref as jax_scatter_ref
from repro_torch.core import index as tidx
from repro_torch.kernels.ell_gather import ops as ell_ops
from repro_torch.kernels.ell_gather.ref import ell_gather_ref
from repro_torch.kernels.scatter_score import ops as scatter_ops
from repro_torch.kernels.scatter_score.ref import scatter_score_ref

RTOL, ATOL = 1e-5, 1e-6


def _padded_qw(queries, index):
    qw = np.asarray(queries.to_dense())
    v_pad = index.num_term_blocks * index.term_block
    return np.pad(qw, ((0, 0), (0, v_pad - qw.shape[1])))


def _port_scatter(qw, t):
    return scatter_score_ref(
        torch.from_numpy(qw), t.local_term, t.local_doc, t.value,
        t.chunk_term_block, t.chunk_doc_block, t.block_chunk_start,
        t.block_chunk_count, term_block=t.term_block, doc_block=t.doc_block,
        num_doc_blocks=t.num_doc_blocks,
    ).numpy()


# The geometries of tests/test_kernels.py's scatter sweep; the first has
# chunk_size < term_block.
@pytest.mark.parametrize("n_docs,vocab,tb,db,cs", [
    (100, 300, 128, 32, 64),
    (257, 801, 256, 128, 128),
    (64, 128, 128, 128, 512),
])
@pytest.mark.parametrize("use_gather", [False, True])
def test_scatter_score_ref_matches_pallas(n_docs, vocab, tb, db, cs,
                                          use_gather):
    c = make_msmarco_like(n_docs, 6, vocab_size=vocab, seed=n_docs)
    j = jidx.build_tiled_index(c.docs, term_block=tb, doc_block=db,
                               chunk_size=cs)
    t = carry_tiled(j)
    got = _port_scatter(_padded_qw(c.queries, j), t)[:, :n_docs]
    want = np.asarray(jax_scatter(c.queries, j, use_gather=use_gather))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_scatter_score_ref_matches_jax_ref_on_blanked_chunks():
    """A tile-skipped index blanks only local_doc/value of its zeroing
    chunks; with chunk_size < term_block their local_term pad (== C) is a
    real local term, so the validity rule must read local_doc."""
    c = make_msmarco_like(150, 3, vocab_size=900, seed=4)
    j = jidx.build_tiled_index(c.docs, term_block=256, doc_block=32,
                               chunk_size=64)
    jf = jidx.filter_tiled_index(j, c.queries.slice_rows(0, 1))
    assert np.any((np.asarray(jf.local_doc) < 0)
                  & (np.asarray(jf.local_term) < jf.term_block))
    qw = _padded_qw(c.queries, jf)
    got = _port_scatter(qw, carry_tiled(jf))
    want = jax_scatter_ref(
        qw, jf.local_term, jf.local_doc, jf.value, jf.chunk_term_block,
        jf.chunk_doc_block, jf.chunk_first, term_block=jf.term_block,
        doc_block=jf.doc_block, num_doc_blocks=jf.num_doc_blocks,
    )
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# The geometries of tests/test_kernels.py's ELL sweep.
@pytest.mark.parametrize("n_docs,vocab,db,kc", [
    (96, 300, 32, 8),
    (200, 700, 64, 4),
])
def test_ell_gather_ref_matches_pallas(n_docs, vocab, db, kc):
    c = make_msmarco_like(n_docs, 5, vocab_size=vocab, seed=n_docs + 1)
    j = jidx.build_ell_index(c.docs)
    t = tidx.ell_index_from_numpy(j.terms, j.values, j.num_docs,
                                  j.vocab_size, device="cpu")
    qw = np.array(c.queries.to_dense())
    got = ell_gather_ref(torch.from_numpy(qw), t.terms, t.values).numpy()
    want = np.asarray(ell_score(c.queries, j, doc_block=db, k_chunk=kc))
    np.testing.assert_allclose(got[:, :n_docs], want, rtol=RTOL, atol=ATOL)
    qwt = np.concatenate([qw.T, np.zeros((1, qw.shape[0]), np.float32)])
    np.testing.assert_allclose(
        got, jax_ell_ref(qwt, np.minimum(np.asarray(j.terms), vocab),
                         np.asarray(j.values)),
        rtol=RTOL, atol=ATOL,
    )


def test_cpu_tensors_take_the_plain_version():
    """On a CPU tensor the entries return the plain version's result and
    count no launch."""
    c = make_msmarco_like(80, 3, vocab_size=200, seed=2)
    j = jidx.build_tiled_index(c.docs, term_block=64, doc_block=16,
                               chunk_size=32)
    t = carry_tiled(j)
    je = jidx.build_ell_index(c.docs)
    e = tidx.ell_index_from_numpy(je.terms, je.values, je.num_docs,
                                  je.vocab_size, device="cpu")
    before = (scatter_ops.launches, ell_ops.launches)
    qw = torch.from_numpy(_padded_qw(c.queries, j))
    got = scatter_ops.scatter_score(
        qw, t.local_term, t.local_doc, t.value, t.chunk_term_block,
        t.chunk_doc_block, t.block_chunk_start, t.block_chunk_count,
        term_block=t.term_block, doc_block=t.doc_block,
        num_doc_blocks=t.num_doc_blocks,
    )
    assert torch.equal(got, torch.from_numpy(_port_scatter(qw.numpy(), t)))
    q = qw[:, :200].contiguous()
    assert torch.equal(ell_ops.ell_gather(q, e.terms, e.values),
                       ell_gather_ref(q, e.terms, e.values))
    assert (scatter_ops.launches, ell_ops.launches) == before


def test_scatter_score_ref_honours_chunk_runs():
    """Runs over a subset of blocks (as the two-pass path passes them):
    the plain version scores those blocks as the full runs do and leaves 0
    elsewhere, as the CUDA kernel does."""
    c = make_msmarco_like(300, 4, vocab_size=700, seed=8)
    j = jidx.build_tiled_index(c.docs, term_block=256, doc_block=32,
                               chunk_size=64)
    t = carry_tiled(j)
    qw = torch.from_numpy(_padded_qw(c.queries, j))
    args = (qw, t.local_term, t.local_doc, t.value, t.chunk_term_block,
            t.chunk_doc_block, t.block_chunk_start)
    kw = dict(term_block=256, doc_block=32, num_doc_blocks=t.num_doc_blocks)
    full = scatter_score_ref(*args, t.block_chunk_count, **kw)
    keep = torch.tensor([1, 0, 0, 1, 1, 0, 1, 0, 1, 0], dtype=torch.bool)
    got = scatter_score_ref(*args, t.block_chunk_count * keep.int(), **kw)
    cols = keep.repeat_interleave(32)
    assert torch.equal(got[:, cols], full[:, cols])
    assert not got[:, ~cols].any() and full[:, ~cols].any()
    assert torch.equal(
        scatter_ops.scatter_score(*args, t.block_chunk_count * keep.int(),
                                  **kw), got)


def test_library_path_covers_the_shared_headers(tmp_path, monkeypatch):
    """A kernel's library name hashes its source, every shared
    ``csrc/*.cuh`` and the flags: editing a header it may include names a
    new library, so a stale one is never loaded (no nvcc needed)."""
    from repro_torch.kernels import build

    src = tmp_path / "csrc"
    src.mkdir()
    for f in list(build.SRC_DIR.glob("*.cu")) + list(
            build.SRC_DIR.glob("*.cuh")):
        (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "SRC_DIR", src)
    names = ("flash_attention", "splade_head", "scatter_score")
    before = {n: build.library_path(n) for n in names}
    assert len(set(before.values())) == len(names)
    header = src / "hopper.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: build.library_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    (src / "flash_attention.cu").write_bytes(
        (src / "flash_attention.cu").read_bytes() + b"\n")
    assert build.library_path("flash_attention") != after["flash_attention"]
    assert build.library_path("splade_head") == after["splade_head"]
    assert all(p.parent == build.BUILD_DIR for p in after.values())
