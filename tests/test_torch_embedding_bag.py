"""repro_torch's embedding_bag entry and plain versions vs repro's, on the
CPU.

Inputs are made with numpy from a seed and go through the JAX function and
its counterpart in the port.  The JAX ``embedding_bag`` runs its Pallas
kernel in interpret mode here, as ``tests/test_kernels.py::
test_embedding_bag_sweep`` runs it.  Tolerance atol = rtol = 1e-5: an f32
sum of at most 20 products, in another order (the Pallas kernel sums
through a one-hot product; the JAX package's own bar for it is 1e-4).

The port holds to the Pallas kernel where the two JAX functions disagree:
an id at or past V adds 0 in the kernel, while ``embedding_bag_ref`` (and
``embedding_bag_jnp``) gather NaN for it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import embedding_bag as j_bag
from repro.kernels.embedding_bag import embedding_bag_ref as j_bag_ref
from repro.models.recsys.embeddings import embedding_bag_jnp
from repro_torch.kernels.embedding_bag import embedding_bag_ref, ops
from repro_torch.models.recsys.embeddings import embedding_bag_plain

TOL = dict(rtol=1e-5, atol=1e-5)

# test_embedding_bag_sweep's shapes, then xDeepFM's D = 10 and DIN/DIEN's
# D = 18 with ragged bag counts: (V, D, N, L, batch_block, vocab_block).
SHAPES = [
    (500, 16, 32, 8, 16, 128),
    (1000, 64, 20, 20, 4, 256),
    (700, 10, 37, 5, 8, 128),
    (300, 18, 13, 8, 16, 64),
]


def _inputs(v, d, n, l, seed, low=-1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(low, v, size=(n, l)).astype(np.int32)
    w = rng.normal(size=(n, l)).astype(np.float32)
    table = rng.normal(size=(v, d)).astype(np.float32)
    return ids, w, table


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("v,d,n,l,bb,vb", SHAPES)
def test_plain_version_matches_the_pallas_kernel(v, d, n, l, bb, vb):
    ids, w, table = _inputs(v, d, n, l, seed=v + n)
    ids[0] = -1  # an all-pad bag
    ids[1, 1:] = ids[1, 0]  # duplicate ids
    want = np.asarray(j_bag(jnp.asarray(ids), jnp.asarray(table),
                            jnp.asarray(w), batch_block=bb, vocab_block=vb))
    before = ops.launches
    got = ops.embedding_bag(_t(ids), _t(table), _t(w))
    assert ops.launches == before  # a CPU call launches nothing
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[0].any()
    unweighted = np.asarray(j_bag(jnp.asarray(ids), jnp.asarray(table),
                                  batch_block=bb, vocab_block=vb))
    np.testing.assert_allclose(ops.embedding_bag(_t(ids), _t(table)).numpy(),
                               unweighted, **TOL)


@pytest.mark.parametrize("v,d,n,l", [s[:4] for s in SHAPES])
def test_plain_version_matches_the_jax_ref_below_v(v, d, n, l):
    ids, w, table = _inputs(v, d, n, l, seed=3 * v + l)
    want = np.asarray(j_bag_ref(jnp.asarray(ids), jnp.asarray(w),
                                jnp.asarray(table)))
    got = embedding_bag_ref(_t(ids), _t(w), _t(table))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_an_id_at_or_past_v_adds_zero_as_in_the_pallas_kernel():
    ids = np.array([[0, -1, 7], [5, 2, 4]], np.int32)
    w = np.ones(ids.shape, np.float32)
    table = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    kernel = np.asarray(j_bag(jnp.asarray(ids), jnp.asarray(table),
                              jnp.asarray(w), vocab_block=8))
    np.testing.assert_allclose(kernel[0], table[0], **TOL)
    np.testing.assert_allclose(kernel[1], table[2] + table[4], **TOL)
    # a fact about the reference: its take fills an id past V with NaN
    assert np.isnan(np.asarray(j_bag_ref(jnp.asarray(ids), jnp.asarray(w),
                                         jnp.asarray(table)))[0]).all()
    got = ops.embedding_bag(_t(ids), _t(table), _t(w))
    np.testing.assert_allclose(got.numpy(), kernel, **TOL)
    np.testing.assert_allclose(
        embedding_bag_plain(_t(table), _t(ids)).numpy(), kernel, **TOL)
    # an empty table: every id is outside [0, V)
    empty = torch.zeros((0, 3))
    assert torch.equal(ops.embedding_bag(_t(ids), empty), torch.zeros(2, 3))


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_model_plain_bag_matches_embedding_bag_jnp(combiner, weighted):
    ids, w, table = _inputs(300, 18, 13, 8, seed=7)
    ids[2] = -1
    wj = jnp.asarray(w) if weighted else None
    want = np.asarray(embedding_bag_jnp(jnp.asarray(table), jnp.asarray(ids),
                                        wj, combiner))
    got = embedding_bag_plain(_t(table), _t(ids),
                              _t(w) if weighted else None, combiner)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_entry_refuses_a_device_without_a_kernel():
    ids = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.embedding_bag(ids, torch.zeros((4, 2), device="meta"))
    with pytest.raises(ValueError, match="combiner"):
        embedding_bag_plain(torch.zeros((4, 2)),
                            torch.zeros((2, 3), dtype=torch.int32),
                            combiner="max")
