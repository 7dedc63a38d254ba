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
