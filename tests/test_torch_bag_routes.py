"""The redesigned ``embedding_bag`` kernel's host side and summation order,
on the CPU.

The CUDA kernel (``src/repro_torch/csrc/embedding_bag.cu``) runs only on
the card; what surrounds it runs here: the route as a pure function of D,
L and the pointers' alignment (``ops.pick_route``), and a numpy emulation
of the kernel's grid — CTAs of 128 threads, a lane group of D / vec
threads a bag (groups following each other across warps), each lane's
ids and weights loaded ivec at a time, chunks of 8 ids, vec columns a
lane, and the fold fmaf(live ? w : 0, live ? x : 0, acc) in ascending l
from +0.  Unweighted, the fold is f32 adds, so the emulation is held bit
for bit to ``sequential_bag_sum``; weighted (fmaf emulated in float64,
then rounded), within BAG_TOL (atol = rtol = 1e-5) of
``embedding_bag_ref``, and every route bit for bit to the widest.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.embedding_bag import (embedding_bag_ref, ops,
                                               sequential_bag_sum)

BAG_TOL = 1e-5
THREADS, CHUNK = 128, 8  # csrc/embedding_bag.cu's kThreads and kChunk


@pytest.mark.parametrize("d,l,table,ids,weights,want", [
    (10, 8, 256, 512, None, (2, 2)),  # xDeepFM: 40-byte rows
    (16, 8, 256, 512, None, (4, 2)),  # AutoInt: 64-byte rows
    (18, 8, 256, 512, 1024, (2, 2)),  # DIN: 72-byte rows, weights aligned
    (7, 8, 256, 512, None, (1, 2)),  # odd D: scalar rows
    (16, 8, 260, 512, None, (1, 2)),  # a view only 4-byte aligned
    (16, 8, 264, 512, None, (2, 2)),  # a view 8-byte aligned
    (10, 5, 256, 512, None, (2, 1)),  # odd L: scalar ids
    (10, 6, 256, 520, None, (2, 2)),  # ids 8-byte aligned
    (10, 8, 256, 512, 1028, (2, 1)),  # weights only 4-byte aligned
    (10, 1, 256, 512, None, (2, 1)),  # one-hot bags
    (10, 8, 256, 516, None, (2, 1)),  # ids only 4-byte aligned
])
def test_route_is_a_pure_function_of_d_l_and_alignment(d, l, table, ids,
                                                       weights, want):
    assert ops.pick_route(d, l, table, ids, weights) == want
    assert ops.pick_route(d, l, table, ids, weights) == want


def test_route_of_real_tensors_and_an_offset_view():
    store = torch.zeros(1000 * 16 + 4)  # the allocator aligns to 64 B
    ids = torch.zeros((4, 8), dtype=torch.int32)
    assert store.data_ptr() % 16 == 0
    for k, vec in ((0, 4), (2, 2), (1, 1)):
        view = store[k:k + 16000].view(1000, 16)  # starts 4 * k bytes in
        assert ops.pick_route(16, 8, view.data_ptr(),
                              ids.data_ptr()) == (vec, 2)


def _fma(w, x, acc):
    """fmaf in f32: the product is exact in float64, the sum rounded
    twice (float64, then f32), which matches fmaf but in rare ties."""
    return (np.float64(w) * x.astype(np.float64)
            + acc.astype(np.float64)).astype(np.float32)


def emulate(ids, w, table, vec, ivec):
    """The kernel's grid in numpy, lane by lane: (out, writes a column)."""
    n, l = ids.shape
    v, d = table.shape
    cols = d // vec  # lanes a group
    out = np.full((n, d), np.nan, np.float32)
    writes = np.zeros((n, d), np.int64)
    blocks = -(-n * cols // THREADS)
    for t in range(blocks * THREADS):
        if t >= n * cols:
            continue  # the grid's ragged last CTA
        bag, c = divmod(t, cols)
        acc = np.zeros(vec, np.float32)
        for j0 in range(0, l, CHUNK):
            idw, ww = {}, {}  # this lane's loads, ivec words at a time
            for u in range(0, CHUNK, ivec):
                if j0 + u < l:
                    word = ids[bag, j0 + u:j0 + u + ivec]
                    assert len(word) == ivec  # whole, never cut by L
                    for e in range(ivec):
                        idw[u + e] = int(word[e])
                        if w is not None:
                            ww[u + e] = w[bag, j0 + u + e]
            for u in range(min(CHUNK, l - j0)):
                i = idw[u]
                if 0 <= i < v:
                    x, wt = table[i, c * vec:(c + 1) * vec], \
                        1.0 if w is None else ww[u]
                else:
                    x, wt = np.zeros(vec, np.float32), 0.0
                acc = (acc + x).astype(np.float32) if w is None \
                    else _fma(wt, x, acc)
        out[bag, c * vec:(c + 1) * vec] = acc
        writes[bag, c * vec:(c + 1) * vec] += 1
    return out, writes


def _bags(n, l, v, d, seed):
    """Bags with pads, ids at or past V, an all-pad bag and duplicate ids."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, v, size=(n, l)).astype(np.int32)
    ids[::5, l // 2] = -1
    ids[::7, l - 1] = v + 1
    ids[2] = -1
    ids[3, 1:] = ids[3, 0]
    table = rng.normal(size=(v, d)).astype(np.float32)
    w = rng.normal(size=ids.shape).astype(np.float32)
    return ids, w, table


@pytest.mark.parametrize("d,l", [(10, 8), (16, 8), (18, 6), (7, 20),
                                 (64, 4), (10, 1)])
def test_emulated_kernel_is_the_sequential_fold_on_every_route(d, l):
    ids, w, table = _bags(53, l, 400, d, seed=d + l)
    want = sequential_bag_sum(torch.from_numpy(ids),
                              torch.from_numpy(table)).numpy()
    ref_w = embedding_bag_ref(torch.from_numpy(ids), torch.from_numpy(w),
                              torch.from_numpy(table)).numpy()
    widest = ops.pick_route(d, l, 256, 512)
    runs = {}
    for vec in (4, 2, 1):
        for ivec in (2, 1):
            if vec <= widest[0] and ivec <= widest[1]:
                for weighted in (False, True):
                    got, writes = emulate(ids, w if weighted else None,
                                          table, vec, ivec)
                    assert (writes == 1).all()  # every column once
                    runs[(vec, ivec, weighted)] = got
    for (vec, ivec, weighted), got in runs.items():
        if weighted:
            np.testing.assert_allclose(got, ref_w, rtol=BAG_TOL, atol=BAG_TOL)
            assert np.array_equal(got, runs[(*widest, True)])
        else:
            assert np.array_equal(got, want)
    assert not want[2].any()  # the all-pad bag
