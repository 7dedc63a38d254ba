"""Tiny geometries of every route of the six kernels.

Each :class:`Route` builds the inputs of one kernel entry on a device from
seeded CPU data: ``kernel-shape`` runs the entry's CUDA branch on fake
copies of the CPU inputs, and the device half
(:mod:`repro_torch.lint.sanitize`) runs it on the card.  The routes are
the ones each entry picks from the shapes and dtypes it is given:

* ``scatter_score`` and ``ell_gather``: f32 and bf16, on sparse query
  tiles (a SPLADE-like share of nonzero weights) and on dense ones (every
  weight nonzero: the dense route);
* ``bmp_scan``: the small route (3 rows a group) and the wide route (12
  rows a group, an alive mask), f32 and bf16, two groups (so each is split
  over a thread-block cluster on the card);
* ``splade_head``: a ragged T and V, ``w`` the strided ``embed.T`` view;
* ``flash_attention``: bf16 (the ``wgmma`` route) and f32 (the SIMT
  route), GQA with a ragged S, causal, and a window;
* ``embedding_bag``: ids of -1, V and above (each adds 0), with weights
  and 4-wide rows, and without weights on 7-wide rows.

``ints`` gives, for an entry's inputs, the integer arguments its launch
must pass (position in the C signature -> value), from the tensors'
shapes alone.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

F32, BF16, I32 = torch.float32, torch.bfloat16, torch.int32


@dataclasses.dataclass(frozen=True)
class Route:
    """One route of one kernel: ``make(device) -> (args, kwargs)`` of the
    entry ``package.ops.<entry>``; ``ints(args, kwargs) -> {position:
    value}`` of its launch; ``shadow``: the entry module's helpers that
    read data on the host (``kernel-shape`` runs them on the CPU
    inputs)."""

    name: str
    package: str
    entry: str
    dtype: torch.dtype
    make: Callable
    ints: Callable
    shadow: tuple = ()


def _corpus():
    from repro_torch.data.synthetic import make_msmarco_like

    return make_msmarco_like(48, 24, vocab_size=512, seed=7, device="cpu")


def _tiled():
    from repro_torch.core.index import build_tiled_index

    c = _corpus()
    idx = build_tiled_index(c.docs, term_block=64, doc_block=16,
                            chunk_size=32, store_term_block_max=True)
    return c, idx


def _dense_weights(b: int, v: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(11)
    return torch.rand((b, v), generator=g) + 0.05


def _to(device, dtype, *tensors):
    return tuple(t.to(device=device, dtype=dtype) for t in tensors)


# -- scatter_score ------------------------------------------------------------


def _scatter_make(dtype, dense: bool):
    def make(device):
        c, idx = _tiled()
        v_pad = idx.num_term_blocks * idx.term_block
        b = 20
        qw = _dense_weights(b, v_pad) if dense else F.pad(
            c.queries.to_dense()[:b], (0, v_pad - c.vocab_size))
        qw, value = _to(device, dtype, qw, idx.value)
        runs = tuple(t.to(device) for t in (
            idx.local_term, idx.local_doc))
        rest = tuple(t.to(device) for t in (
            idx.chunk_term_block, idx.chunk_doc_block, idx.block_chunk_start,
            idx.block_chunk_count))
        return ((qw, *runs, value, *rest),
                dict(term_block=idx.term_block, doc_block=idx.doc_block,
                     num_doc_blocks=idx.num_doc_blocks))
    return make


def _scatter_ints(args, kw):
    qw, lt = args[0], args[1]
    n_db, db = kw["num_doc_blocks"], kw["doc_block"]
    return {12: qw.shape[0], 14: qw.shape[1], 15: n_db, 16: kw["term_block"],
            17: db, 18: lt.shape[1], 19: n_db * db}


# -- ell_gather ---------------------------------------------------------------


def _ell_make(dtype, dense: bool):
    def make(device):
        from repro_torch.core.index import build_ell_index

        c = _corpus()
        ell = build_ell_index(c.docs)
        b = 20
        qw = _dense_weights(b, c.vocab_size) if dense else \
            c.queries.to_dense()[:b]
        qw, values = _to(device, dtype, qw, ell.values)
        return (qw, ell.terms.to(device), values), {}
    return make


def _ell_ints(args, kw):
    qw, terms = args[0], args[1]
    return {7: qw.shape[0], 9: qw.shape[1], 10: terms.shape[0],
            11: terms.shape[1]}


# -- bmp_scan -----------------------------------------------------------------


def _bmp_make(dtype, rows: int, alive: bool):
    def make(device):
        from repro_torch.core import scoring

        c, idx = _tiled()
        g = 2
        v_pad = idx.num_term_blocks * idx.term_block
        qw = F.pad(c.queries.to_dense(), (0, v_pad - c.vocab_size))
        ub = scoring.block_upper_bounds(c.queries, idx)
        qw, ub = qw[:g * rows], ub[:g * rows]
        order = torch.argsort(-ub, dim=-1, stable=True)
        ub_sorted = ub.gather(-1, order)
        tau0 = torch.full((g, rows), float("-inf"))
        mask = None
        if alive:
            mask = (torch.arange(idx.num_docs) % 5 != 3).to(device)
        qw, value = _to(device, dtype, qw.view(g, rows, -1), idx.value)
        sched = [t.to(device) for t in (
            order.to(I32).view(g, rows, -1), ub_sorted.view(g, rows, -1),
            tau0)]
        runs = [t.to(device) for t in (
            idx.block_chunk_start, idx.block_chunk_count,
            idx.chunk_term_block, idx.chunk_doc_block, idx.local_term,
            idx.local_doc)]
        return ((qw, *sched, *runs, value, mask),
                dict(term_block=idx.term_block, doc_block=idx.doc_block,
                     k_eff=5, theta=1.0, num_docs=idx.num_docs))
    return make


def _bmp_ints(args, kw):
    qw, bcc, lt = args[0], args[5], args[8]
    g, b, v_pad = qw.shape
    tb = kw["term_block"]
    return {5: int(qw.dtype == BF16), 26: g, 27: b, 29: v_pad,
            30: args[1].shape[-1], 31: lt.shape[0], 32: tb,
            33: kw["doc_block"], 34: lt.shape[1], 35: kw["k_eff"],
            38: kw["num_docs"], 39: -(-v_pad // 32), 42: v_pad // tb,
            43: max(int(bcc.max()), 1)}


# -- splade_head, flash_attention, embedding_bag ------------------------------


def _splade_make(device):
    g = torch.Generator().manual_seed(3)
    b, t, d, v = 2, 9, 64, 300
    h = torch.randn((b, t, d), generator=g)
    mask = (torch.rand((b, t), generator=g) > 0.3).float()
    mask[1] = 0.0  # a row with no token
    embed = torch.randn((v, d), generator=g) * 0.1
    bias = torch.randn((v,), generator=g) * 0.1
    return (h.to(device), mask.to(device), embed.to(device).T,
            bias.to(device)), {}


def _splade_ints(args, kw):
    h, _, w, _ = args
    b, t, d = h.shape
    return {5: b, 6: t, 7: d, 8: w.shape[1], 9: w.stride(0),
            10: w.stride(1)}


def _flash_make(dtype, window):
    def make(device):
        g = torch.Generator().manual_seed(5)
        b, s, hq, hkv, dh = 1, 70, 4, 2, 64
        q = torch.randn((b, s, hq, dh), generator=g)
        k = torch.randn((b, s, hkv, dh), generator=g)
        v = torch.randn((b, s, hkv, dh), generator=g)
        q, k, v = _to(device, dtype, q, k, v)
        return (q, k, v), dict(causal=True, window=window)
    return make


def _flash_ints(args, kw):
    q, k, v = args
    b, sq, hq, dh = q.shape
    window = kw.get("window")
    out = {4: int(q.dtype == BF16), 5: b, 6: sq, 7: k.shape[1], 8: hq,
           9: k.shape[2], 10: dh, 20: int(kw.get("causal", True)),
           21: int(window is not None), 22: window or 0}
    for base, t in ((11, q), (14, k), (17, v)):
        out.update({base + i: s for i, s in enumerate(t.stride()[:3])})
    return out


def _bag_make(d: int, l: int, weighted: bool):
    def make(device):
        g = torch.Generator().manual_seed(9)
        n, v = 6, 10
        ids = torch.randint(0, v, (n, l), generator=g, dtype=I32)
        ids[0, 0], ids[1, -1], ids[2, 0] = -1, v, v + 3  # each adds 0
        table = torch.randn((v, d), generator=g)
        weights = torch.rand((n, l), generator=g) if weighted else None
        return (ids.to(device), table.to(device),
                None if weights is None else weights.to(device)), {}
    return make


def _bag_ints(args, kw):
    ids, table, _ = args
    return {4: ids.shape[0], 5: ids.shape[1], 6: table.shape[0],
            7: table.shape[1]}


def _routes() -> tuple[Route, ...]:
    out = []
    for dtype, tag in ((F32, "f32"), (BF16, "bf16")):
        for dense in (False, True):
            kind = "dense" if dense else "sparse"
            out.append(Route(f"scatter_score/{tag}/{kind}", "scatter_score",
                             "scatter_score", dtype,
                             _scatter_make(dtype, dense), _scatter_ints,
                             ("pack_query_tiles",)))
            out.append(Route(f"ell_gather/{tag}/{kind}", "ell_gather",
                             "ell_gather", dtype, _ell_make(dtype, dense),
                             _ell_ints, ("pack_query_tiles",)))
    for dtype, tag in ((F32, "f32"), (BF16, "bf16")):
        for name, rows, alive in (("small", 3, False), ("wide", 12, True)):
            out.append(Route(
                f"bmp_scan/{name}/{tag}", "bmp_scan", "bmp_sweep", dtype,
                _bmp_make(dtype, rows, alive), _bmp_ints,
                ("nonzero_terms", "launch_sizes", "pack_small_weights")))
    out.append(Route("splade_head/f32", "splade_head", "splade_head", F32,
                     _splade_make, _splade_ints))
    out.append(Route("flash_attention/bf16-wgmma", "flash_attention",
                     "flash_attention", BF16, _flash_make(BF16, None),
                     _flash_ints))
    out.append(Route("flash_attention/bf16-wgmma/window", "flash_attention",
                     "flash_attention", BF16, _flash_make(BF16, 24),
                     _flash_ints))
    out.append(Route("flash_attention/f32", "flash_attention",
                     "flash_attention", F32, _flash_make(F32, None),
                     _flash_ints))
    out.append(Route("embedding_bag/vec4/weighted", "embedding_bag",
                     "embedding_bag", F32, _bag_make(12, 4, True),
                     _bag_ints))
    out.append(Route("embedding_bag/vec1", "embedding_bag", "embedding_bag",
                     F32, _bag_make(7, 3, False), _bag_ints))
    return tuple(out)


ROUTES: tuple[Route, ...] = _routes()
PACKAGES = ("scatter_score", "ell_gather", "bmp_scan", "splade_head",
            "flash_attention", "embedding_bag")
