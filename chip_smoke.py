#!/usr/bin/env python3
"""Drive the PyTorch port's exact and pruned paths, SPLADE query encoding
in front of the exact one, LM serving (prefill and decode) and recsys
serving (DIN, DIEN, AutoInt, xDeepFM), on one NVIDIA H100.

Run from the root of a checkout, with one CUDA card and no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. Build the six CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, in parallel) and print the card's name and power
   limit.
2. Hold ``scatter_score`` and ``ell_gather`` against their plain PyTorch
   versions on the card, at 50,000 docs x 64 queries, V = 30,522, over
   several index geometries (``chunk_size < term_block``, a ragged last
   doc block, a tile-skipped index whose blanked chunks test the padding
   rule); ``splade_head`` against its plain version at (B, T, d, V) =
   (1, 7, 64, 1000), (3, 130, 96, 513) and (64, 256, 768, 30,522), W
   given contiguous and as the strided ``embed.T`` view, a fractional mask
   and an all-zero row.
2b. The same size on a topical corpus reordered by ``df-signature``:
   ``bmp_scan`` against its plain version (scores, heap and tau within
   KERNEL_TOL, block and chunk fetch sets and step counts equal) at
   doc_block 64 / k = 10 and doc_block 256 / k = 1000 (``chunk_size <
   term_block``), for a flat launch of all rows, the planner's buckets,
   an alive mask, and a group of more than 128 rows; ``scatter_score``
   over partial chunk runs; engines ``tiled-pruned`` (bmp, two-pass) and
   ``tiled-bmp-grouped`` against float64, ``tiled-pruned-approx`` (theta
   0.8) with its ``recall_vs_exact``.
3. The main path at the repo's ``serve_1m`` shape (``repro.configs.
   gpusparse``): 1,000,000 docs generated on the card, V = 30,522, 500
   queries, k = 1000, through ``RetrievalEngine.search`` for engines
   ``tiled`` and ``ell``; the kernels' launch counters are zeroed just
   before and read just after.  Exactness against a float64 oracle on 16
   sampled queries: mean overlap@1000 >= 0.999, returned scores within
   1e-5 relative of float64, and the two engines agreeing the same way.
3a. SPLADE encoding in front of phase 3's engines: ``SpladeEncoder`` at
   the full width of the gpusparse ``ENCODER`` (12 layers, d = 768, V =
   30,522; ``repro_torch.configs.gpusparse``) with seeded random weights
   encodes 500 queries of T = 64 tokens (ids uniform over V, 8-64 valid
   tokens each) with ``use_kernel=True`` under ``inference_mode``; the
   encoding is thresholded at 0.05, made sparse on the card and searched
   at k = 1000 by ``tiled`` and ``ell``.  The ``splade_head``,
   ``scatter_score`` and ``ell_gather`` counters are zeroed just before
   and read just after.  Encode ms and encode -> search ms per call (host
   clock, synchronised; a warm-up, 5 rounds, their median and the whole
   window's rate); exactness against float64 as in phase 3; the kernel's
   encoding against ``use_kernel=False`` within KERNEL_TOL.
3b. The pruned path at serve_1m width: 1,000,000 docs of
   ``make_topical_corpus`` (seed 0), 500 queries, k = 1000, engine
   ``tiled-bmp-fused`` with ``reorder_docs`` (``df-signature``), a
   warm-up and 5 rounds, the ``bmp_scan`` counter zeroed before and read
   after; then one call each at doc_block 64 / k = 10 and on phase 3's
   unclustered corpus.  Each held to float64 as in phase 3, the first also
   to ``tiled``; the scheduler's stats printed.  The flat sweep and the
   per-group engine run at phase 2b's size only (a cut of depth: at
   serve width each takes minutes).
4. Each kernel against its plain version again at the main path's own
   shapes (the serve_1m index, all 500 queries: several query tiles and a
   ragged last one), then per-kernel times with CUDA events at those
   shapes: the kernel, its plain version, one library call computing the
   same scores (``torch.sparse.mm``, used nowhere in the port), and the
   least time the card could take (bytes over 3.35 TB/s or f32 operations
   over 67 TFLOP/s, H100 SXM data sheet).  For ``bmp_scan``: a sample of
   the main path's groups (the bucket with the most rows) against the
   plain version, its times at those shapes, the bound of the work it did
   (chunk lines, windows, heaps and weights; 2 x live postings x rows),
   no library call; and the time of every launch of one search call.
   For ``splade_head``: its time at phase 3a's shapes (the encoder's own
   hidden states, B = 500, T = 64), the plain version's, one
   ``torch.matmul`` of h [B T, d] by W (the product alone, used nowhere in
   the port) and the bound of 2 x valid tokens x d V f32 operations (a
   token of mask 0 needs no product).
5a. With the earlier phases' data freed: ``flash_attention`` against its
   plain version and a float64 softmax, f32 and bf16, over JAX's
   ``test_flash_attention_sweep`` geometries at Dh 64, qwen2-0.5b's heads
   (Hq 14 over 2) with S = 1000 and 2048 (windowed), Dh 128 (Hq 32 over 8),
   windows and MQA (FLASH_TOL), and that it is deterministic.
5. LM serving at the full width and depth of ``qwen2-0.5b``
   (``repro_torch.configs.qwen2_0_5b.FULL``: 24 layers, d 896, 14 heads
   over 2, d_ff 4864, V = 151,936, bf16 compute) with seeded random
   weights.  ``TransformerLM.prefill`` of 1 x 32,768 tokens from
   ``make_lm_batch`` (``prefill_32k`` with its batch cut from 32 to 1): a
   warm-up and 5 rounds on the host clock, the ``flash_attention`` counter
   zeroed before and read after (24 launches a prefill).  The kernel
   against its plain version on layer 0's own q, k, v at that shape, then
   its time, the plain version's, one ``scaled_dot_product_attention``
   call's (used nowhere in the port) and its bound (4 B Hq Dh x the visible
   (query, key) pairs over 989 TFLOP/s of bf16, or the q, k, v, o bytes
   over 3.35 TB/s).  The whole prefill through the kernel against the plain
   path at 2 x 4,096 tokens, in bf16 and in f32.  Then ``decode_step`` for
   16 steps of 32 sequences (``decode_32k`` with its batch cut from 128 to
   32) from a cache whose first 32,768 slots hold seeded bf16 K/V: ms per
   step against the bound of the cache bytes over 3.35 TB/s.
6a. With phase 5's data freed: ``embedding_bag`` against its plain version
   and float64 (BAG_TOL) at (N, L, V, D) = (7, 1, 50, 10), (130, 5, 1000,
   18) with pads and ids at or past V, (19,968, 8, 1,000,003, 10)
   (xDeepFM's serve_p99 lookup at H = 8) and (4,096, 100, 100,000, 16),
   each with an all-pad bag and duplicate ids, weights given and None;
   two launches bitwise equal.
6. Recsys serving at the full width of ``repro_torch.configs.{xdeepfm,
   autoint,din,dien}.FULL`` (the Criteo-39 tables, 16,596,850 rows, and
   the Amazon-style ones, 1,111,110 context rows and 1,000,000 items) with
   seeded random weights.  6b: ``forward`` of ``RECSYS_SHAPES``'
   serve_p99 batch (B = 512, ``make_recsys_batch``) at H = 1 and 8, a
   warm-up and 5 rounds on the host clock, one ``embedding_bag`` launch a
   forward, logits within RECSYS_TOL of the plain path.  6c:
   ``retrieval_cand`` — one user, ``score_candidates`` over 1,000,000
   candidates (DIN 65,536: its [C, 100, 72] attention features do not fit
   one card at 1,000,000), then the top 100, against the plain path
   (scores within RECSYS_TOL, ids tie-aware).  The counter is zeroed
   before 6b and read after 6c.  6d: xDeepFM's lookup alone at
   serve_bulk's batch (262,144 x 39 bags of 8; its CIN would need 82 GB
   there): the kernel against its plain version, then CUDA-event times of
   the kernel, the plain version and one ``F.embedding_bag`` call (used
   nowhere in the port), and the bound (each id, each distinct row and
   the output once, over 3.35 TB/s).

It prints the ``kernels`` JSON line, the card line, and as its last line
``{"ok": true, "device": {...}}``.  Without a card, or outside a checkout,
it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
BF16_FLOP_PER_S = 989e12  # H100 SXM bf16 on the tensor cores, dense
# Kernel vs plain version: both sum the same f32 products in another order
# (the plain version's index_add_ in atomic order, the kernel serially with
# fma), over at most a few hundred products per score.
KERNEL_TOL = 1e-5  # max |kernel - plain| <= KERNEL_TOL * max |plain|
OVERLAP_MIN = 0.999  # the paper's exactness bar; residue: f32 near-ties
SCORE_RTOL = 1e-5  # returned f32 scores vs float64
# flash_attention in f32: atol = rtol = 2e-5, the JAX package's bar for the
# kernel (tests/test_kernels.py::test_flash_attention_sweep).  In bf16 the
# kernel and its plain version both compute in f32 and round once to bf16,
# so they may differ by one bf16 ulp of the output on top of that bar; so
# may the kernel and the float64 softmax rounded once.
FLASH_TOL = 2e-5
# The whole prefill, kernel path against plain path: f32 logits within
# 1e-4 of max |plain| (24 layers of the same f32 arithmetic in another
# order); bf16 logits no farther apart than the plain path's own bf16
# logits are from its f32 ones (each side rounds its attention output to
# bf16 once a layer, so the two may differ by an ulp there, and bf16 noise
# carries that through the layers).
PREFILL_F32_RTOL = 1e-4
# embedding_bag against its plain version and float64: atol = rtol = 1e-5
# elementwise (an f32 sum of at most 100 products in another order; the
# JAX package's bar for its kernel is 1e-4).  The recsys models, kernel
# path against plain path: logits and retrieval scores within 1e-5 of
# max |plain| (the same f32 arithmetic; only the bag sums' order differs).
BAG_TOL = 1e-5
RECSYS_TOL = 1e-5


@dataclasses.dataclass(frozen=True)
class Sizes:
    vocab: int = 30522
    check_docs: int = 49_997  # ragged: not a multiple of any doc block
    check_queries: int = 64
    docs: int = 1_000_000  # serve_1m
    queries: int = 500
    k: int = 1000
    oracle_queries: int = 16
    rounds: int = 5
    reps: int = 5
    geometries: tuple = ((512, 256, 512), (512, 128, 256), (256, 64, 128))
    # The pruned path: (term_block, doc_block, chunk_size, k) of phase 2b.
    pruned_geometries: tuple = ((512, 64, 512, 10), (512, 256, 256, 1000))
    check_groups: int = 4  # groups a launch held against the plain version
    big_group: int = 160  # rows of the repeated-query group (> 128)
    engine_k: int = 100  # k of the pruned engines at the phase-2 size
    small_doc_block: int = 64  # phase 3b's case where retirement shows
    small_k: int = 10
    sample_groups: int = 4  # phase 4: main-path groups held against plain
    # splade_head against its plain version (phase 2): (B, T, d, V).
    head_shapes: tuple = ((1, 7, 64, 1000), (3, 130, 96, 513),
                          (64, 256, 768, 30522))
    # The encoder (phase 3a): a config of repro_torch.configs.gpusparse.
    encoder: str = "ENCODER"
    encode_len: int = 64  # T of the query batch
    encode_min_len: int = 8  # valid tokens per query: 8..encode_len
    threshold: float = 0.05  # the serve example's query threshold
    # flash_attention against its plain version and float64 (phase 5a):
    # (B, S, Hq, Hkv, Dh, causal, window).  JAX's test_flash_attention_sweep
    # geometries at Dh 64 (the kernel takes Dh 64 and 128), qwen2-0.5b's
    # heads with a ragged S, Dh 128 (Hq 32 over 8), windows and MQA.
    flash_shapes: tuple = (
        (2, 64, 4, 2, 64, True, None), (1, 128, 6, 3, 64, True, 24),
        (2, 32, 2, 2, 64, False, None), (1, 96, 8, 1, 64, True, None),
        (2, 1000, 14, 2, 64, True, None), (1, 2048, 14, 2, 64, True, 300),
        (1, 777, 32, 8, 128, True, None), (2, 300, 32, 8, 128, False, 100),
        (1, 500, 16, 1, 128, True, None))
    # The LM (phase 5): a config of repro_torch.configs.qwen2_0_5b.
    lm: str = "FULL"
    prefill_batch: int = 1  # LM_SHAPES' prefill_32k, its batch cut 32 -> 1
    prefill_len: int = 32768
    check_batch: int = 2  # the whole prefill, kernel against plain path
    check_len: int = 4096
    decode_batch: int = 32  # LM_SHAPES' decode_32k, its batch cut 128 -> 32
    decode_context: int = 32768  # cache slots filled before decoding
    decode_steps: int = 16
    # embedding_bag against its plain version and float64 (phase 6a):
    # (N, L, V, D).  The second shape also holds pads and ids at or past V;
    # the third is xDeepFM's serve_p99 lookup at H = 8 (512 x 39 bags).
    bag_shapes: tuple = ((7, 1, 50, 10), (130, 5, 1000, 18),
                         (19_968, 8, 1_000_003, 10),
                         (4096, 100, 100_000, 16))
    # The recsys models (phase 6): configs of repro_torch.configs.<model>.
    recsys_models: tuple = ("xdeepfm", "autoint", "din", "dien")
    recsys_config: str = "FULL"
    serve_batch: int = 512  # RECSYS_SHAPES' serve_p99
    hots: tuple = (1, 8)  # bag sizes of the served batches
    candidates: int = 1_000_000  # RECSYS_SHAPES' retrieval_cand
    din_candidates: int = 65_536  # DIN's retrieval, cut to fit one card
    retrieval_k: int = 100
    bulk_batch: int = 262_144  # RECSYS_SHAPES' serve_bulk (6d)
    bulk_hot: int = 8


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(dev) -> None:
    import torch

    torch.cuda.synchronize(dev)


def event_ms(fn, reps: int, dev) -> float:
    """Mean ms of ``fn()`` over ``reps`` runs after one warm-up, timed with
    CUDA events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def padded_queries(queries, index):
    import torch.nn.functional as F

    qw = queries.to_dense()
    v_pad = index.num_term_blocks * index.term_block
    return F.pad(qw, (0, v_pad - qw.shape[1]))


def tiled_args(index):
    return dict(
        local_term=index.local_term, local_doc=index.local_doc,
        value=index.value, chunk_term_block=index.chunk_term_block,
        chunk_doc_block=index.chunk_doc_block,
        block_chunk_start=index.block_chunk_start,
        block_chunk_count=index.block_chunk_count,
        term_block=index.term_block, doc_block=index.doc_block,
        num_doc_blocks=index.num_doc_blocks,
    )


def compare(name: str, got, want, quiet: bool = False) -> float:
    """max |got - want|; raises unless it is within KERNEL_TOL of
    max |want| (both finite and of one shape)."""
    import torch

    sync(got.device)
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite output")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    rel = err / max(scale, 1e-30)
    if not quiet:
        log(f"  {name}: max_abs_err={err!r} max_abs_plain={scale!r} "
            f"rel={rel!r}")
    if rel > KERNEL_TOL:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (rel {rel} > {KERNEL_TOL})")
    return err


def check_kernels(dev, sizes: Sizes):
    """Phase 2: each kernel against its plain version, several geometries."""
    import torch

    from repro_torch.core import index as index_mod
    from repro_torch.data.synthetic import make_msmarco_like
    from repro_torch.kernels.ell_gather import ell_gather, ell_gather_ref
    from repro_torch.kernels.scatter_score import (
        scatter_score, scatter_score_ref,
    )

    c = make_msmarco_like(sizes.check_docs, sizes.check_queries,
                          vocab_size=sizes.vocab, seed=11, device=dev)
    errs = {"scatter_score": 0.0, "ell_gather": 0.0}
    for tb, db, cs in sizes.geometries:
        idx = index_mod.build_tiled_index(c.docs, term_block=tb, doc_block=db,
                                          chunk_size=cs)
        qw = padded_queries(c.queries, idx)
        for tag, ix in (("", idx),
                        ("/tile-skip", index_mod.filter_tiled_index(
                            idx, c.queries.slice_rows(0, 2)))):
            args = tiled_args(ix)
            got = scatter_score(qw, **args)
            want = scatter_score_ref(qw, **args)
            err = compare(f"scatter_score T={tb} D={db} C={cs}{tag}",
                          got, want)
            errs["scatter_score"] = max(errs["scatter_score"], err)
            again = scatter_score(qw, **args)
            if not torch.equal(got, again):
                raise AssertionError("scatter_score is not deterministic")
    ell = index_mod.build_ell_index(c.docs)
    qw = c.queries.to_dense()
    got = ell_gather(qw, ell.terms, ell.values)
    errs["ell_gather"] = compare("ell_gather", got,
                                 ell_gather_ref(qw, ell.terms, ell.values))
    return errs


def check_head(dev, sizes: Sizes) -> float:
    """Phase 2: ``splade_head`` against its plain version, both W layouts,
    a fractional mask and (B > 1) an all-zero row."""
    import torch

    from repro_torch.kernels.splade_head import splade_head, splade_head_ref

    err = 0.0
    for b, t, d, v in sizes.head_shapes:
        g = torch.Generator(device=dev).manual_seed(b + t + d + v)
        h = torch.randn(b, t, d, generator=g, device=dev)
        mask = (torch.rand(b, t, generator=g, device=dev) > 0.25).float()
        mask[:, 1::4] *= 0.5
        if b > 1:
            mask[-1] = 0.0
        embed = torch.randn(v, d, generator=g, device=dev) * 0.05
        bias = torch.randn(v, generator=g, device=dev) * 0.1
        for layout, w in (("embed.T", embed.T),
                          ("contiguous", embed.T.contiguous())):
            got = splade_head(h, mask, w, bias)
            err = max(err, compare(f"splade_head B={b} T={t} d={d} V={v} "
                                   f"W {layout}", got,
                                   splade_head_ref(h, mask, w, bias)))
            if b > 1 and bool(got[-1].any()):
                raise AssertionError("splade_head: a fully masked row is "
                                     "not 0")
            if not torch.equal(got, splade_head(h, mask, w, bias)):
                raise AssertionError("splade_head is not deterministic")
    return err


def docs_csr(docs, dtype):
    """The docs as a CSR [N, V] tensor, for the library products this
    script uses as yardstick and check (the port never calls them)."""
    import torch

    live = docs.term_ids >= 0
    crow = torch.zeros(docs.batch + 1, dtype=torch.int64, device=docs.device)
    crow[1:] = torch.cumsum(live.sum(dim=1), 0)
    return torch.sparse_csr_tensor(
        crow, docs.term_ids[live].long(), docs.values[live].to(dtype),
        size=(docs.batch, docs.vocab_size),
    )


def overlap(a, b, k: int) -> float:
    return sum(len(set(x[:k].tolist()) & set(y[:k].tolist())) / k
               for x, y in zip(a, b)) / len(a)


def check_exact(name: str, vals, ids, oracle, sample, k: int):
    """Overlap@k with the float64 top-k, and returned scores vs float64."""
    import numpy as np
    import torch

    o = oracle.T  # [Bq, N]
    o_ids = torch.topk(o, k, dim=1).indices.cpu().numpy()
    ov = overlap(ids[sample], o_ids, k)
    got = torch.from_numpy(vals[sample]).double().to(o.device)
    want = o.gather(1, torch.from_numpy(ids[sample]).to(o.device))
    rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
    log(f"  {name}: overlap@{k} vs f64 = {ov!r}, max rel score err = {rel!r}")
    if not np.all(ids[sample] >= 0):
        raise AssertionError(f"{name}: missing ids in the top-{k}")
    if ov < OVERLAP_MIN or rel > SCORE_RTOL:
        raise AssertionError(f"{name}: not exact (overlap {ov}, rel {rel})")



def compare_inf(name: str, got, want) -> float:
    """``compare`` where the plain version may hold infinities: they must
    sit at the same places with the same sign.  Quiet."""
    import torch

    sync(got.device)
    fin = torch.isfinite(want)
    if (got.shape != want.shape or not torch.equal(torch.isfinite(got), fin)
            or not torch.equal(got[~fin], want[~fin])):
        raise AssertionError(f"{name}: infinities differ from the plain "
                             f"version's")
    if not bool(fin.any()):
        return 0.0
    return compare(name, got[fin], want[fin], quiet=True)


def tiled_runs(index):
    return (index.block_chunk_start, index.block_chunk_count,
            index.chunk_term_block, index.chunk_doc_block,
            index.local_term, index.local_doc, index.value)


def sweep_launches(index, qw, ub, groups, k_eff, theta=1.0, alive=None,
                   tau0=None):
    """The launches ``bmp_scan`` makes for ``groups`` (one per power-of-two
    bucket, as the fused engine), each as ``(sel, order, ub_sorted, tau,
    call)`` where ``call()`` launches the kernel on those inputs."""
    import numpy as np
    import torch

    from repro_torch.kernels.bmp_scan import ops as bmp_ops
    from repro_torch.sched import planner

    dev = qw.device
    b = qw.shape[0]
    tau0 = np.full(b, -np.inf, np.float32) if tau0 is None else tau0
    out = []
    for _, _, sel, tau in planner.bucketed_group_rows(groups, tau0):
        sel = torch.from_numpy(sel).to(dev)
        u = ub[sel]
        order = torch.argsort(-u, dim=-1, stable=True).to(torch.int32)
        us = u.gather(-1, order.long())
        tau = torch.from_numpy(tau).to(dev)
        q = qw[sel]
        kw = dict(term_block=index.term_block, doc_block=index.doc_block,
                  k_eff=k_eff, theta=theta, num_docs=index.num_docs)
        call = (lambda q=q, order=order, us=us, tau=tau, kw=kw:
                bmp_ops.bmp_sweep(q, order, us, tau, *tiled_runs(index),
                                  alive, **kw))
        out.append((sel, order, us, tau, call, kw))
    return out


def check_sweep(name, index, qw, launch, got, groups_to_check, alive=None):
    """Hold ``groups_to_check`` groups of one ``bmp_sweep`` launch against
    the plain version on the same order/ub_sorted/tau0: scores, heap and
    tau within KERNEL_TOL, fetch sets and steps equal."""
    import torch

    from repro_torch.kernels.bmp_scan.ref import bmp_sweep_ref
    from repro_torch.sched.planner import PAD_TAU

    sel, order, us, tau, _, kw = launch
    err = 0.0
    for g in range(min(groups_to_check, sel.shape[0])):
        want = bmp_sweep_ref(qw[sel[g]], order[g], us[g], tau[g],
                             *tiled_runs(index), alive, **kw)
        tag = f"{name}, group {g} of {sel.shape[0]} x {sel.shape[1]} rows"
        e = compare(f"{tag} scores", got[0][g], want[0], quiet=True)
        e = max(e, compare_inf(f"{tag} heap", got[1][g], want[1]))
        real = tau[g] < PAD_TAU  # pad rows keep PAD_TAU in both
        compare_inf(f"{tag} tau",
                    torch.maximum(tau[g], got[1][g][:, -1])[real],
                    torch.maximum(tau[g], want[1][:, -1])[real])
        same = (torch.equal(got[2][g].bool(), want[2])
                and torch.equal(got[3][g].bool(), want[3])
                and int(got[4][g, 0]) == want[4])
        if not same:
            raise AssertionError(f"{tag}: fetch sets or steps differ from "
                                 f"the plain version's")
        log(f"  {tag}: blocks {int(want[2].sum())}/{want[2].numel()}, "
            f"chunks {int(want[3].sum())}/{want[3].numel()}, steps "
            f"{want[4]} equal; scores/heap/tau max_abs_err={e!r} (max "
            f"|plain| {float(want[0].abs().max())!r})")
        err = max(err, e)
    return err


def oracle_f64(docs, queries, sample):
    """Float64 scores [N, len(sample)] of the sampled queries."""
    import torch

    from repro_torch.core import SparseBatch

    sel = torch.from_numpy(sample).to(docs.device)
    return torch.sparse.mm(
        docs_csr(docs, torch.float64),
        SparseBatch(queries.term_ids[sel], queries.values[sel],
                    queries.vocab_size).to_dense(torch.float64).T,
    )


def check_pruned(dev, sizes: Sizes):
    """Phase 2b: ``bmp_scan`` against its plain version on a reordered
    topical corpus, two geometries; the pruned engines at this size against
    float64; ``scatter_score`` over partial chunk runs."""
    import numpy as np
    import torch

    from repro_torch.core import RetrievalConfig, RetrievalEngine
    from repro_torch.core import index as index_mod
    from repro_torch.core import scoring
    from repro_torch.data.synthetic import make_topical_corpus
    from repro_torch.kernels.scatter_score import (
        scatter_score, scatter_score_ref,
    )
    from repro_torch.sched import planner

    c = make_topical_corpus(sizes.check_docs, sizes.check_queries,
                            vocab_size=sizes.vocab, seed=12, device=dev)
    docs, _ = index_mod.reorder_docs(c.docs, "df-signature")
    b = sizes.check_queries
    err = 0.0
    for tb, db, cs, k in sizes.pruned_geometries:
        idx = index_mod.build_tiled_index(docs, tb, db, cs,
                                          store_term_block_max=True)
        qw = scoring._pad_queries_to_term_blocks(c.queries, idx)
        ub = scoring.block_upper_bounds(c.queries, idx, qw=qw)
        k_eff = min(k, idx.num_docs)
        tag = f"bmp_scan T={tb} D={db} C={cs} k={k}"
        plan = planner.plan_micro_batches(
            ub.cpu().numpy(), idx.block_chunk_count.cpu().numpy())
        alive = torch.ones(idx.num_docs, dtype=torch.bool, device=dev)
        alive[::7] = False
        cases = [("flat", [np.arange(b)], None, b)]
        cases.append((f"fused ({plan.num_groups} groups)", plan.groups, None,
                      sizes.check_groups))
        cases.append(("flat, 1 doc in 7 deleted", [np.arange(b)], alive, b))
        for name, groups, alv, n_check in cases:
            for launch in sweep_launches(idx, qw, ub, groups, k_eff,
                                         alive=alv):
                got = launch[4]()
                err = max(err, check_sweep(f"{tag} {name}", idx, qw, launch,
                                           got, n_check, alv))
        # A group above the TPU kernel's 128-row cap: the queries repeated.
        rows = torch.arange(sizes.big_group, device=dev) % b
        (launch,) = sweep_launches(idx, qw[rows], ub[rows],
                                   [np.arange(sizes.big_group)], k_eff)
        err = max(err, check_sweep(f"{tag} {sizes.big_group} rows", idx,
                                   qw[rows], launch, launch[4](), 1))
        # scatter_score over the chunk runs of every third block only.
        keep = torch.arange(idx.num_doc_blocks, device=dev) % 3 == 0
        args = dict(tiled_args(idx), block_chunk_count=(
            idx.block_chunk_count * keep.to(torch.int32)))
        compare(f"scatter_score T={tb} D={db} C={cs} partial runs",
                scatter_score(qw, **args), scatter_score_ref(qw, **args))

    # The pruned engines at this size, against float64.
    sample = np.arange(b)
    oracle = oracle_f64(c.docs, c.queries, sample)
    cfg = dict(k=sizes.engine_k, doc_block=64, reorder_docs=True,
               reorder_method="df-signature")
    for engine, extra in (("tiled-pruned", {}),
                          ("tiled-pruned", {"traversal": "two-pass"}),
                          ("tiled-bmp-grouped", {})):
        eng = RetrievalEngine(c.docs, RetrievalConfig(engine=engine, **cfg,
                                                      **extra), device=dev)
        vals, ids = eng.search(c.queries)
        st = eng.prune_stats(c.queries)
        log(f"  {engine} {extra}: blocks {st.blocks_scored}/"
            f"{st.num_doc_blocks}, chunks {st.chunks_scored}/"
            f"{st.chunks_total}, steps {st.sweep_steps}")
        check_exact(f"{engine} {extra}", vals, ids, oracle, sample,
                    sizes.engine_k)
    approx = RetrievalEngine(c.docs, RetrievalConfig(
        engine="tiled-pruned-approx", theta=0.8, **cfg), device=dev)
    metrics = approx.evaluate(c.queries, c.qrels, k=sizes.engine_k)
    log(f"  tiled-pruned-approx theta=0.8: {metrics}")
    return err


def host_rounds(name, fn, rounds, dev, batch, unit="QPS"):
    """A warm-up and ``rounds`` calls of ``fn`` on the host clock, the
    device synchronised after each -> (the last result, ms: the median
    round, or the warm-up call when ``rounds`` is 0).  Logs every round and
    the rate of ``batch`` queries (or tokens) a call at the median and over
    the whole window of rounds."""
    import numpy as np

    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    first = time.perf_counter() - t0
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        times.append(time.perf_counter() - t0)
    if not times:
        ms = 1e3 * first
        log(f"  {name}: one call {ms!r} ms")
        return out, ms
    ms = 1e3 * float(np.median(times))
    log(f"  {name}: {ms!r} ms per call (median of {rounds}, all "
        f"{[1e3 * t for t in times]!r}; warm-up {1e3 * first!r}), "
        f"{batch / ms * 1e3!r} {unit} at the median, "
        f"{batch * rounds / sum(times)!r} {unit} over the whole window of "
        f"{rounds} rounds")
    return out, ms


def time_search(name, eng, queries, k, rounds, dev):
    """:func:`host_rounds` of ``eng.search`` (results come back as numpy,
    so each call ends on the host) -> (values, ids, ms)."""
    import numpy as np

    (vals, ids), ms = host_rounds(f"{name}: search",
                                  lambda: eng.search(queries, k=k), rounds,
                                  dev, queries.batch)
    if vals.shape != (queries.batch, min(k, eng.num_docs)):
        raise AssertionError(f"{name}: result shape {vals.shape}")
    if not np.all(np.isfinite(vals)):
        raise AssertionError(f"{name}: non-finite scores")
    return vals, ids, ms


def serve_pruned(dev, sizes: Sizes, msmarco):
    """Phase 3b: the fused engine at serve_1m width on a reordered topical
    corpus (its launch counter zeroed before and read after each case),
    then at doc_block 64 / k = 10, then on the unclustered corpus."""
    import collections

    import numpy as np
    import torch

    from repro_torch.core import RetrievalConfig, RetrievalEngine
    from repro_torch.data.synthetic import make_topical_corpus
    from repro_torch.kernels.bmp_scan import ops as bmp_ops

    t0 = time.perf_counter()
    corpus = make_topical_corpus(sizes.docs, sizes.queries,
                                 vocab_size=sizes.vocab, seed=0, device=dev)
    sync(dev)
    log(f"  topical corpus on device: {time.perf_counter() - t0:.3f} s; "
        f"{int((corpus.docs.term_ids >= 0).sum()) / sizes.docs:.2f} nnz/doc, "
        f"K={corpus.docs.max_terms}")
    g = torch.Generator().manual_seed(6)
    sample = torch.randperm(sizes.queries, generator=g)[
        :sizes.oracle_queries].sort().values.numpy()
    oracle = oracle_f64(corpus.docs, corpus.queries, sample)
    base = dict(engine="tiled-bmp-fused", reorder_docs=True,
                reorder_method="df-signature")
    out = {}
    for case, docs, queries, orc, k, extra, rounds in (
            ("main", corpus.docs, corpus.queries, oracle, sizes.k, {},
             sizes.rounds),
            (f"doc_block {sizes.small_doc_block}, k={sizes.small_k}",
             corpus.docs, corpus.queries, oracle, sizes.small_k,
             {"doc_block": sizes.small_doc_block}, 0),
            ("unclustered (make_msmarco_like)", msmarco.docs,
             msmarco.queries, None, sizes.k, {}, 0)):
        t0 = time.perf_counter()
        eng = RetrievalEngine(docs, RetrievalConfig(k=k, **base, **extra),
                              device=dev)
        sync(dev)
        log(f"  tiled-bmp-fused, {case}: index build with reordering "
            f"{time.perf_counter() - t0:.3f} s, {eng.index_bytes()} B")
        torch.cuda.reset_peak_memory_stats(dev)
        bmp_ops.launches = 0
        vals, ids, ms = time_search(f"tiled-bmp-fused, {case}", eng,
                                    queries, k, rounds, dev)
        launches = bmp_ops.launches
        log(f"  tiled-bmp-fused, {case}: bmp_scan launches {launches}, peak "
            f"device memory {torch.cuda.max_memory_allocated(dev)} B")
        if launches <= 0:
            raise AssertionError(f"bmp_scan was not launched ({case})")
        if orc is None:
            orc = oracle_f64(docs, queries, sample)
        check_exact(f"tiled-bmp-fused, {case}", vals, ids, orc, sample, k)
        _, st = bmp_ops.bmp_scan(queries, eng._index, k, return_stats=True,
                                 plan_cache=eng.config.plan_cache)
        buckets = collections.Counter(st.padded_group_sizes)
        log(f"  tiled-bmp-fused, {case}: {st.num_groups} groups, buckets "
            f"{dict(sorted(buckets.items()))}, launches "
            f"{st.kernel_launches}; blocks {st.blocks_scored_union}/"
            f"{st.num_doc_blocks}, chunks {st.chunks_scored_union}/"
            f"{st.chunks_total} (union), steps {st.sweep_steps}; chunk work "
            f"{st.chunk_work} live, {st.padded_chunk_work} padded, against "
            f"{st.flat_chunk_work(st.chunks_total)} for every chunk x B")
        out[case] = dict(engine=eng, vals=vals, ids=ids, ms=ms,
                         launches=launches, stats=st, queries=queries)
    main = out["main"]
    exact = RetrievalEngine(corpus.docs, RetrievalConfig(engine="tiled",
                                                         k=sizes.k),
                            device=dev)
    tv, ti = exact.search(corpus.queries, k=sizes.k)
    ov = overlap(main["ids"], ti, sizes.k)
    rel = float(np.max(np.abs(main["vals"] - tv)
                       / np.maximum(np.abs(tv), 1e-30)))
    log(f"  tiled-bmp-fused vs tiled on the topical corpus: overlap@"
        f"{sizes.k} = {ov!r}, max rel = {rel!r}")
    if ov < OVERLAP_MIN or rel > SCORE_RTOL:
        raise AssertionError("tiled-bmp-fused and tiled disagree")
    main["corpus"] = corpus
    return main


def encode_search(dev, sizes: Sizes, corpus, engines) -> dict:
    """Phase 3a: SPLADE encoding at the encoder's full width in front of
    phase 3's engines, the kernels' counters zeroed before and read after;
    times, float64 exactness and the kernel against ``use_kernel=False``."""
    import numpy as np
    import torch

    from repro_torch.configs import gpusparse
    from repro_torch.core.sparse import dense_to_sparse
    from repro_torch.kernels.ell_gather import ops as ell_ops
    from repro_torch.kernels.scatter_score import ops as scatter_ops
    from repro_torch.kernels.splade_head import ops as head_ops
    from repro_torch.models.splade import SpladeEncoder

    cfg = getattr(gpusparse, sizes.encoder)
    if cfg.vocab_size != sizes.vocab:
        raise AssertionError(f"encoder vocab {cfg.vocab_size} != corpus "
                             f"vocab {sizes.vocab}")
    t0 = time.perf_counter()
    enc = SpladeEncoder(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    sync(dev)
    n_params = sum(p.numel() for p in enc.parameters())
    log(f"  {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"{cfg.n_heads} heads, d_ff={cfg.d_ff}, V={cfg.vocab_size}, "
        f"{cfg.act}; num_params {cfg.num_params()} (+ {cfg.vocab_size} "
        f"mlm_bias = {n_params} tensors' elements); seeded init "
        f"{time.perf_counter() - t0:.3f} s")
    g = torch.Generator(device=dev).manual_seed(1)
    b, t = sizes.queries, sizes.encode_len
    tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=g, device=dev)
    lens = torch.randint(sizes.encode_min_len, t + 1, (b,), generator=g,
                         device=dev)
    mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).float()
    thr = sizes.threshold

    def encode():
        return enc.encode(tokens, mask, use_kernel=True)

    def queries_of(x):
        return dense_to_sparse(torch.where(x > thr, x, 0.0), device=dev)

    out = {}
    with torch.inference_mode():
        head_ops.launches = 0
        scatter_ops.launches = 0
        ell_ops.launches = 0
        x, encode_ms = host_rounds(
            f"encode {b} x {t} tokens (use_kernel=True)", encode,
            sizes.rounds, dev, b)
        for name, eng in engines.items():
            def call(eng=eng):
                q = queries_of(encode())
                return q, eng.search(q, k=sizes.k)
            (q, (vals, ids)), ms = host_rounds(f"encode -> {name} search",
                                              call, sizes.rounds, dev, b)
            out[name] = (q, vals, ids, ms)
        launches = {"splade_head": head_ops.launches,
                    "scatter_score": scatter_ops.launches,
                    "ell_gather": ell_ops.launches}
    log(f"  launches on the encode -> search path: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the encode -> "
                                 f"search path")

    with torch.inference_mode():
        if (tuple(x.shape) != (b, cfg.vocab_size)
                or not bool(torch.isfinite(x).all()) or bool((x < 0).any())):
            raise AssertionError("encode: not a finite non-negative [B, V]")
        nnz = (x > thr).sum(dim=1).float()
        log(f"  terms above {thr} per query: min {int(nnz.min())}, median "
            f"{float(nnz.median())!r}, max {int(nnz.max())}; max weight "
            f"{float(x.max())!r}")
        err = compare("encode, use_kernel=True vs False", x,
                      enc.encode(tokens, mask, use_kernel=False))
    sample = torch.randperm(b, generator=torch.Generator().manual_seed(7))[
        :sizes.oracle_queries].sort().values.numpy()
    for name, (q, vals, ids, _) in out.items():
        check_exact(f"encode -> {name}", vals, ids,
                    oracle_f64(corpus.docs, q, sample), sample, sizes.k)
    (tq, tv, ti, _), (eq, ev, ei, _) = out["tiled"], out["ell"]
    if not (torch.equal(tq.term_ids, eq.term_ids)
            and torch.equal(tq.values, eq.values)):
        raise AssertionError("encode is not deterministic across calls")
    ov = overlap(ti, ei, sizes.k)
    rel = float(np.max(np.abs(tv - ev) / np.maximum(np.abs(ev), 1e-30)))
    log(f"  encode -> tiled vs ell: overlap@{sizes.k} = {ov!r}, max rel = "
        f"{rel!r}")
    if ov < OVERLAP_MIN or rel > SCORE_RTOL:
        raise AssertionError("encode -> tiled and ell disagree")
    return dict(enc=enc, tokens=tokens, mask=mask, err=err,
                encode_ms=encode_ms, launches=launches["splade_head"])


def head_row(dev, sizes: Sizes, enc_run: dict, err: float) -> dict:
    """Phase 4 for ``splade_head``: kernel, plain version and one
    ``torch.matmul`` of the product alone, at phase 3a's shapes."""
    import torch

    from repro_torch.kernels.splade_head import ops as head_ops
    from repro_torch.kernels.splade_head.ref import splade_head_ref

    enc, mask = enc_run["enc"], enc_run["mask"]
    with torch.inference_mode():
        h = enc.hidden(enc_run["tokens"])
        w, bias = enc.head_weight(), enc.mlm_bias
        b, t, d = h.shape
        v = w.shape[1]
        err = max(err, compare(f"splade_head at B={b} T={t} d={d} V={v}",
                               head_ops.splade_head(h, mask, w, bias),
                               splade_head_ref(h, mask, w, bias)))
        kernel_ms = event_ms(lambda: head_ops.splade_head(h, mask, w, bias),
                             sizes.reps, dev)
        plain_ms = event_ms(lambda: splade_head_ref(h, mask, w, bias),
                            max(1, sizes.reps // 2), dev)
        library_ms = event_ms(lambda: torch.matmul(h.view(b * t, d), w),
                              sizes.reps, dev)
    # A token of mask 0 adds an exact 0 to a max of non-negative terms, so
    # the function needs the product only for the valid tokens' rows.
    rows = int((mask != 0).sum())
    nbytes = 4 * (rows * d + b * t + d * v + v + b * v)
    flops = 2.0 * rows * d * v
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    row = {
        "name": "splade_head", "route": "cuda",
        "source": "src/repro_torch/csrc/splade_head.cu",
        "replaces": "src/repro/kernels/splade_head/kernel.py:46",
        "launches": enc_run["launches"], "max_abs_err": err, "ms": kernel_ms,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }
    log(f"  splade_head: kernel {kernel_ms!r} ms ({kernel_ms / enc_run['encode_ms']!r} "
        f"of an encode call), plain {plain_ms!r} ms, library (matmul alone) "
        f"{library_ms!r} ms, bound {row['bound_ms']!r} ms "
        f"({row['bound_by']}: {rows} valid token rows of {b * t}, {nbytes} "
        f"B, {flops!r} flop)")
    return row


def bmp_row(dev, sizes: Sizes, main, err: float) -> dict:
    """Phase 4 for ``bmp_scan``: a sample of the main path's groups against
    the plain version, then times at those shapes, the bound of the work
    they did, and the kernel time of a whole search call."""
    import numpy as np

    from repro_torch.core import scoring
    from repro_torch.kernels.bmp_scan.ref import bmp_sweep_ref
    from repro_torch.sched import planner

    eng, queries = main["engine"], main["queries"]
    idx = eng._index
    k_eff = min(sizes.k, idx.num_docs)
    t0 = time.perf_counter()
    qw = scoring._pad_queries_to_term_blocks(queries, idx)
    ub = scoring.block_upper_bounds(queries, idx, qw=qw)
    sync(dev)
    bounds_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = planner.plan_micro_batches(ub.cpu().numpy(),
                                      idx.block_chunk_count.cpu().numpy())
    plan_s = time.perf_counter() - t0
    launches = sweep_launches(idx, qw, ub, plan.groups, k_eff)
    t0 = time.perf_counter()
    for launch in launches:
        launch[4]()
    sync(dev)
    all_s = time.perf_counter() - t0
    log(f"  a search call's parts: bounds {1e3 * bounds_s!r} ms, plan "
        f"{1e3 * plan_s!r} ms, {len(launches)} bmp_scan launches "
        f"{1e3 * all_s!r} ms (host clock, synchronised)")
    # The sample: the first groups of the bucket with the most rows.
    tau0 = np.full(qw.shape[0], -np.inf, np.float32)
    *_, (_, entries, _, _) = planner.bucketed_group_rows(plan.groups, tau0)
    (sample,) = sweep_launches(
        idx, qw, ub, [g for _, g in entries[: sizes.sample_groups]], k_eff)
    sel_full, order, us, tau, _, kw = sample
    got = sample[4]()
    err = max(err, check_sweep("bmp_scan at serve_1m", idx, qw, sample, got,
                               sizes.sample_groups))
    kernel_ms = event_ms(sample[4], sizes.reps, dev)
    plain = (lambda: [bmp_sweep_ref(qw[sel_full[g]], order[g], us[g], tau[g],
                                    *tiled_runs(idx), None, **kw)
                      for g in range(sel_full.shape[0])])
    plain_ms = event_ms(plain, 1, dev)
    bsc, csc = got[2].bool(), got[3].bool()
    gs, rows = sel_full.shape
    live = (idx.local_doc >= 0).sum(dim=1)
    postings = int(sum(int(live[csc[g]].sum()) for g in range(gs)))
    nbytes = (int(csc.sum()) * idx.chunk_size * 12  # chunk lines fetched
              + int(bsc.sum()) * rows * idx.doc_block * 4  # windows written
              + gs * rows * k_eff * 4  # heaps written
              + gs * rows * qw.shape[1] * 4)  # query weights read
    flops = 2.0 * postings * rows
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    row = {
        "name": "bmp_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/bmp_scan.cu",
        "replaces": "src/repro/kernels/bmp_scan/kernel.py:297",
        "launches": main["launches"], "max_abs_err": err, "ms": kernel_ms,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }
    log(f"  bmp_scan on {gs} groups x {rows} rows of the main path: kernel "
        f"{kernel_ms!r} ms, plain {plain_ms!r} ms, bound "
        f"{row['bound_ms']!r} ms ({row['bound_by']}: {nbytes} B, {flops!r} "
        f"flop), library: none")
    all_ms = event_ms(lambda: [launch[4]() for launch in launches], 1, dev)
    log(f"  bmp_scan, every launch of one search call: {all_ms!r} ms "
        f"(CUDA events)")
    return row


def flash_within(name: str, got, want) -> float:
    """max |got - want|; raises unless every element is within FLASH_TOL
    (atol and rtol) of ``want``, plus one bf16 ulp of the output when
    ``got`` is bf16 (both finite and of one shape)."""
    import torch

    sync(got.device)
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite output")
    g, w = got.double(), want.double()
    bar = FLASH_TOL * (1 + w.abs())
    if got.dtype == torch.bfloat16:
        big = torch.maximum(g.abs(), w.abs())
        bar = bar + torch.ldexp(torch.ones_like(big),
                                torch.frexp(big).exponent - 8)
    err = (g - w).abs()
    worst = float((err / bar).max()) if err.numel() else 0.0
    if worst > 1.0:
        raise AssertionError(f"{name}: outside its tolerance ({worst!r} of "
                             f"the bar; max err {float(err.max())!r})")
    return float(err.max()) if err.numel() else 0.0


def attention_f64(q, k, v, causal, window):
    """The naive float64 softmax, [B, Sq, Hq, Dh]; a row with no visible key
    gives 0."""
    import math

    import torch

    b, sq, hq, dh = q.shape
    skv, g = k.shape[1], hq // k.shape[2]
    qq = q.double().transpose(1, 2)
    kk = k.double().repeat_interleave(g, dim=2).transpose(1, 2)
    vv = v.double().repeat_interleave(g, dim=2).transpose(1, 2)
    logits = qq @ kk.transpose(-1, -2) / math.sqrt(dh)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= qp - kp < window
    p = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
    return (p.nan_to_num(0.0) @ vv).transpose(1, 2)


def check_flash(dev, sizes: Sizes) -> float:
    """Phase 5a: ``flash_attention`` against its plain version and the
    float64 softmax over ``sizes.flash_shapes``, f32 and bf16; and that
    it is deterministic."""
    import torch

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    err = 0.0
    for b, s, hq, hkv, dh, causal, window in sizes.flash_shapes:
        g = torch.Generator(device=dev).manual_seed(s * hq + dh)
        base = [torch.randn(b, s, h, dh, generator=g, device=dev)
                for h in (hq, hkv, hkv)]
        exact = attention_f64(*base, causal, window)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (x.to(dtype) for x in base)
            tag = (f"flash_attention B={b} S={s} Hq={hq} Hkv={hkv} Dh={dh} "
                   f"causal={causal} window={window} {dtype}")
            got = flash_ops.flash_attention(q, k, v, causal, window)
            e = flash_within(f"{tag} vs plain", got,
                             flash_attention_ref(q, k, v, causal, window))
            if dtype == torch.float32:
                e64 = flash_within(f"{tag} vs float64", got, exact)
            else:  # the float64 softmax of the bf16 inputs
                e64 = flash_within(f"{tag} vs float64", got, attention_f64(
                    q, k, v, causal, window))
            if not torch.equal(got, flash_ops.flash_attention(q, k, v, causal,
                                                              window)):
                raise AssertionError(f"{tag}: not deterministic")
            log(f"  {tag}: max_abs_err vs plain {e!r}, vs float64 {e64!r}")
            err = max(err, e)
    return err


def attention_flops(b, s, hq, dh, window) -> float:
    """4 B Hq Dh x the (query, key) pairs the causal (and window) mask
    leaves visible: q k^T and p v, two operations a multiply-add each."""
    w = s if window is None else min(window, s)
    pairs = w * (w + 1) // 2 + (s - w) * w
    return 4.0 * b * hq * dh * pairs


def serve_lm(dev, sizes: Sizes, err: float) -> dict:
    """Phase 5: LM serving at the full width and depth of ``sizes.lm``
    (seeded random weights).  5b: prefill of ``prefill_batch`` x
    ``prefill_len`` tokens through ``flash_attention``, its counter zeroed
    before and read after; the kernel against its plain version on layer
    0's own q, k, v, then its time, the plain version's, one
    ``scaled_dot_product_attention`` call's and its bound; the whole prefill
    against the plain path at ``check_len``, bf16 and f32.  5c: decode
    ``decode_steps`` tokens for ``decode_batch`` sequences from a cache
    whose first ``decode_context`` slots hold seeded bf16 K/V."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.configs import qwen2_0_5b
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import TransformerLM

    cfg = getattr(qwen2_0_5b, sizes.lm)
    t0 = time.perf_counter()
    lm = TransformerLM(cfg, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0))
    sync(dev)
    log(f"  {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads} of {cfg.head_dim}, "
        f"d_ff={cfg.d_ff}, V={cfg.vocab_size}, qkv_bias={cfg.qkv_bias}, "
        f"tied={cfg.tie_embeddings}, {cfg.dtype} compute over f32 "
        f"parameters; num_params {cfg.num_params()} (+ qkv biases = "
        f"{sum(p.numel() for p in lm.parameters())}); seeded init "
        f"{time.perf_counter() - t0:.3f} s")
    b, s = sizes.prefill_batch, sizes.prefill_len
    tokens = torch.from_numpy(make_lm_batch(b, s, cfg.vocab_size,
                                            seed=0)["tokens"]).to(dev)
    out = {}
    with torch.inference_mode():
        # 5b. the main path: prefill through the kernel
        flash_ops.launches = 0
        logits, prefill_ms = host_rounds(
            f"prefill {b} x {s} tokens", lambda: lm.prefill(tokens),
            sizes.rounds, dev, b * s, unit="tokens/s")
        launches = flash_ops.launches
        calls = sizes.rounds + 1
        log(f"  flash_attention launches: {launches} in {calls} prefill "
            f"calls ({launches / calls!r} a prefill)")
        if launches != calls * cfg.n_layers:
            raise AssertionError(f"flash_attention launched {launches} "
                                 f"times, not {cfg.n_layers} a prefill")
        if (tuple(logits.shape) != (b, 1, cfg.vocab_size)
                or not bool(torch.isfinite(logits).all())):
            raise AssertionError("prefill: not finite [B, 1, V] logits")

        # the kernel on layer 0's own q, k, v at the full shape
        dt = cfg.compute_dtype
        p = lm.blocks[0].cast(dt)
        positions = torch.arange(s, device=dev)
        x = L.rms_norm(lm.embed_tokens(tokens).to(dt), p["ln_attn"],
                       cfg.norm_eps)
        q, k, v = L.qkv(p["attn"], x, cfg, positions)
        del x
        win = cfg.sliding_window
        err = max(err, flash_within(
            f"flash_attention, layer 0 at {tuple(q.shape)} {q.dtype}",
            flash_ops.flash_attention(q, k, v, True, win),
            flash_attention_ref(q, k, v, True, win)))
        kernel_ms = event_ms(lambda: flash_ops.flash_attention(q, k, v, True,
                                                               win),
                             sizes.reps, dev)
        plain_ms = event_ms(lambda: flash_attention_ref(q, k, v, True, win),
                            1, dev)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION]):
            library_ms = event_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), sizes.reps, dev)
        nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        flops = attention_flops(b, s, cfg.n_heads, cfg.head_dim, win)
        peak = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else F32_FLOP_PER_S
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
        row = {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:110",
            "launches": launches, "max_abs_err": err, "ms": kernel_ms,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
        }
        log(f"  flash_attention at {tuple(q.shape)} {q.dtype}: kernel "
            f"{kernel_ms!r} ms ({kernel_ms * cfg.n_layers!r} ms a prefill, "
            f"{cfg.n_layers * kernel_ms / prefill_ms!r} of it), plain "
            f"{plain_ms!r} ms, library (scaled_dot_product_attention) "
            f"{library_ms!r} ms, bound {row['bound_ms']!r} ms "
            f"({row['bound_by']}: {nbytes} B, {flops!r} flop; "
            f"{row['bound_ms'] * cfg.n_layers!r} ms a prefill); "
            f"{flops / kernel_ms / 1e9!r} TFLOP/s")
        del q, k, v, qt, kt, vt, p

        # the whole prefill, kernel path against plain path
        cb, cs = sizes.check_batch, sizes.check_len
        ctoks = torch.from_numpy(make_lm_batch(cb, cs, cfg.vocab_size,
                                               seed=1)["tokens"]).to(dev)
        lm32 = TransformerLM(dataclasses.replace(cfg, dtype="float32"),
                             device=dev)
        lm32.load_state_dict(lm.state_dict())
        got16, plain16 = lm.prefill(ctoks), lm.prefill(ctoks, use_kernel=False)
        got32 = lm32.prefill(ctoks)
        plain32 = lm32.prefill(ctoks, use_kernel=False)
        del lm32
        e32 = float((got32 - plain32).abs().max())
        scale = float(plain32.abs().max())
        e16 = float((got16 - plain16).abs().max())
        drift = float((plain16 - plain32).abs().max())
        top2 = plain16[:, 0].topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        clear = margin > 2 * e16
        same = bool((got16[:, 0].argmax(-1) == plain16[:, 0].argmax(-1))[
            clear].all())
        log(f"  prefill {cb} x {cs}, kernel vs plain path: f32 max err "
            f"{e32!r} (max |plain| {scale!r}); bf16 max err {e16!r}, the "
            f"plain path's own bf16-vs-f32 drift {drift!r}; top-2 margins "
            f"{margin.tolist()!r}, argmax equal where clear: {same}")
        if (e32 > PREFILL_F32_RTOL * scale or e16 > drift or not same
                or not bool(torch.isfinite(got16).all())):
            raise AssertionError("prefill: the kernel path disagrees with "
                                 "the plain path")
        out["prefill"] = dict(ms=prefill_ms, tokens=b * s, err32=e32,
                              err16=e16, drift=drift)
        del got16, plain16, got32, plain32

        # 5c. decode from a long cache
        db, ctx = sizes.decode_batch, sizes.decode_context
        steps = sizes.decode_steps
        cache = lm.init_cache(db, ctx + steps)
        g = torch.Generator(device=dev).manual_seed(3)
        kv_shape = (db, ctx, cfg.n_kv_heads, cfg.head_dim)
        for li in range(cfg.n_layers):
            for name in ("k", "v"):
                cache[name][li, :, :ctx] = torch.randn(
                    kv_shape, generator=g, device=dev).to(dt)
        cache["pos"][:, :ctx] = torch.arange(ctx, dtype=torch.int32,
                                             device=dev)
        dtoks = torch.from_numpy(make_lm_batch(db, steps, cfg.vocab_size,
                                               seed=2)["tokens"]).to(dev)
        cache_bytes = 2 * cache["k"].element_size() * cfg.n_layers * db * (
            ctx + steps) * cfg.n_kv_heads * cfg.head_dim
        log(f"  decode: cache {tuple(cache['k'].shape)} {cache['k'].dtype} "
            f"x 2 = {cache_bytes} B, first {ctx} slots filled")
        times = []
        for i in range(steps):
            sync(dev)
            t0 = time.perf_counter()
            dl, cache = lm.decode_step(cache, dtoks[:, i], ctx + i)
            sync(dev)
            times.append(time.perf_counter() - t0)
        if (tuple(dl.shape) != (db, cfg.vocab_size)
                or not bool(torch.isfinite(dl).all())):
            raise AssertionError("decode: not finite [B, V] logits")
        if not torch.equal(cache["pos"][:, ctx:ctx + steps].cpu(),
                           torch.arange(ctx, ctx + steps, dtype=torch.int32)
                           .expand(cfg.n_layers, steps)):
            raise AssertionError("decode: the cache positions were not "
                                 "written")
        step_ms = 1e3 * float(np.median(times[1:]))
        bound_ms = cache_bytes / HBM_BYTES_PER_S * 1e3
        log(f"  decode {db} x {steps} steps from {ctx} cached positions: "
            f"{step_ms!r} ms per step (median of steps 2-{steps}, all "
            f"{[1e3 * t for t in times]!r}), {db / step_ms * 1e3!r} tokens/s "
            f"at the median, {db * (steps - 1) / sum(times[1:])!r} tokens/s "
            f"over steps 2-{steps}; bound {bound_ms!r} ms (the cache bytes "
            f"over {HBM_BYTES_PER_S} B/s)")
        out["decode"] = dict(ms=step_ms, bound_ms=bound_ms)
        del cache
    out["row"] = row
    return out


def bag_f64(ids, weights, table):
    """The float64 bag sum of f32 inputs (an id outside [0, V) adds 0)."""
    import torch

    live = (ids >= 0) & (ids < table.shape[0])
    w = (torch.ones(ids.shape, dtype=torch.float64, device=ids.device)
         if weights is None else weights.double())
    g = table.double()[torch.where(live, ids, 0).long()]
    return (g * torch.where(live, w, 0.0)[..., None]).sum(dim=1)


def bag_within(name: str, got, want) -> float:
    """max |got - want|; raises unless every element is within BAG_TOL
    (atol and rtol) of ``want`` (both finite and of one shape)."""
    import torch

    sync(got.device)
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite output")
    g, w = got.double(), want.double()
    err = (g - w).abs()
    worst = float((err / (BAG_TOL * (1 + w.abs()))).max()) \
        if err.numel() else 0.0
    if worst > 1.0:
        raise AssertionError(f"{name}: outside its tolerance ({worst!r} of "
                             f"the bar; max err {float(err.max())!r})")
    return float(err.max()) if err.numel() else 0.0


def check_bags(dev, sizes: Sizes) -> float:
    """Phase 6a: ``embedding_bag`` against its plain version and float64
    over ``sizes.bag_shapes``, weights given and None, an all-pad bag and
    duplicate ids in each (N > 1, L > 1), pads and ids at or past V in the
    second shape; and that two launches agree bitwise."""
    import torch

    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

    err = 0.0
    for i, (n, l, v, d) in enumerate(sizes.bag_shapes):
        g = torch.Generator(device=dev).manual_seed(n + l + v + d)
        low, high = (-1, v + v // 10) if i == 1 else (0, v)
        ids = torch.randint(low, high, (n, l), generator=g, device=dev,
                            dtype=torch.int32)
        if n > 1:
            ids[0] = -1  # an all-pad bag
            ids[1, 1:] = ids[1, 0].clone()  # duplicate ids
        table = torch.randn(v, d, generator=g, device=dev)
        for w in (None, torch.randn(n, l, generator=g, device=dev)):
            tag = (f"embedding_bag N={n} L={l} V={v} D={d} "
                   f"weights={'none' if w is None else 'given'}")
            got = bag_ops.embedding_bag(ids, table, w)
            e = bag_within(f"{tag} vs plain", got,
                           embedding_bag_ref(ids, w, table))
            e64 = bag_within(f"{tag} vs float64", got,
                             bag_f64(ids, w, table))
            if n > 1 and bool(got[0].any()):
                raise AssertionError(f"{tag}: an all-pad bag is not 0")
            if not torch.equal(got, bag_ops.embedding_bag(ids, table, w)):
                raise AssertionError(f"{tag}: not deterministic")
            log(f"  {tag}: max_abs_err vs plain {e!r}, vs float64 {e64!r}")
            err = max(err, e)
    return err


def to_device(batch: dict, dev) -> dict:
    import torch

    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def same_topk(name, got, want, scores, tol) -> float:
    """Kernel top-k (values, ids) against the plain path's, tie-aware: at
    each rank the values agree within ``tol`` and the id the kernel chose
    carries a plain score within ``tol`` of the plain value there (a swap
    inside a near-tie passes, a wrong id does not).  Returns the share of
    ranks with the same id."""
    (gv, gi), (wv, wi) = got, want
    sync(gv.device)
    if gv.shape != wv.shape:
        raise AssertionError(f"{name}: top-k shape {tuple(gv.shape)} vs "
                             f"{tuple(wv.shape)}")
    bad = float((gv - wv).abs().max())
    carried = float((scores[0, gi[0].long()] - wv[0]).abs().max())
    if bad > tol or carried > tol:
        raise AssertionError(f"{name}: top-k differs (values {bad!r}, ids' "
                             f"plain scores {carried!r}, bar {tol!r})")
    return float((gi == wi).float().mean())


def serve_recsys(dev, sizes: Sizes, err: float) -> dict:
    """Phase 6: the four recsys models at ``sizes.recsys_config`` with
    seeded weights.  6b: ``forward`` of a ``serve_batch`` batch from
    ``make_recsys_batch`` at each bag size in ``sizes.hots`` (a warm-up and
    ``rounds`` calls, one ``embedding_bag`` launch each), against the plain
    path.  6c: ``retrieval_cand`` — one user (the first of the multi-hot
    batch), ``score_candidates`` then the top ``retrieval_k``, against the
    plain path.  The ``embedding_bag`` counter is zeroed before 6b and read
    after 6c.  6d: xDeepFM's lookup alone at ``bulk_batch``: the kernel,
    its plain version, one ``F.embedding_bag`` call (used nowhere in the
    port) and the bound (each id, each distinct row and the output
    once)."""
    import importlib

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.topk import topk
    from repro_torch.data.synthetic import make_recsys_batch
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.models.recsys import build_model

    out = {"serve": {}, "retrieval": {}}
    bulk_model = None
    bag_ops.launches = 0
    for name in sizes.recsys_models:
        cfg = getattr(importlib.import_module(f"repro_torch.configs.{name}"),
                      sizes.recsys_config)
        t0 = time.perf_counter()
        model = build_model(cfg, device=dev, seed=0)
        sync(dev)
        n_params = sum(p.numel() for p in model.parameters())
        log(f"  {cfg.name}: {len(cfg.vocab_sizes)} fields, "
            f"{model.embedding.total_rows} table rows x D={cfg.embed_dim}, "
            f"{n_params} parameters ({4 * n_params} B); seeded init "
            f"{time.perf_counter() - t0:.3f} s")
        with torch.inference_mode():
            user = None
            for hot in sizes.hots:
                batch = to_device(make_recsys_batch(
                    sizes.serve_batch, cfg.n_sparse, cfg.vocab_sizes,
                    cfg.seq_len, cfg.item_vocab, multi_hot=hot, seed=0), dev)
                before = bag_ops.launches
                logits, ms = host_rounds(
                    f"{cfg.name} forward B={sizes.serve_batch} H={hot}",
                    lambda: model(batch), sizes.rounds, dev,
                    sizes.serve_batch, unit="examples/s")
                calls = sizes.rounds + 1
                if bag_ops.launches - before != calls:
                    raise AssertionError(
                        f"{cfg.name}: {bag_ops.launches - before} "
                        f"embedding_bag launches in {calls} forwards")
                plain = model(batch, use_kernel=False)
                if (tuple(logits.shape) != (sizes.serve_batch,)
                        or not bool(torch.isfinite(logits).all())):
                    raise AssertionError(f"{cfg.name}: not finite [B] "
                                         f"logits")
                e = float((logits - plain).abs().max())
                scale = float(plain.abs().max())
                log(f"  {cfg.name} H={hot}: kernel vs plain path max err "
                    f"{e!r} (max |logit| {scale!r}); 1 launch a forward")
                if e > RECSYS_TOL * scale:
                    raise AssertionError(f"{cfg.name}: the kernel path "
                                         f"disagrees with the plain path")
                out["serve"][(name, hot)] = dict(ms=ms, err=e, scale=scale)
                user = {k: v[:1] for k, v in batch.items()}

            # 6c. retrieval_cand: one user, every candidate, top-k
            c = sizes.din_candidates if name == "din" else sizes.candidates
            cand = torch.arange(c, dtype=torch.int32, device=dev)
            k = min(sizes.retrieval_k, c)

            def retrieve(use_kernel=True):
                # candidate ids are positions (arange), as same_topk reads
                scores = model.score_candidates(user, cand, use_kernel)
                vals, idx = topk(scores, k)
                return scores, vals, cand[idx]

            before = bag_ops.launches
            (scores, vals, ids), ms = host_rounds(
                f"{cfg.name} retrieval {c} candidates, top-{k}", retrieve,
                sizes.rounds, dev, 1, unit="users/s")
            launched = bag_ops.launches - before
            plain, pvals, pids = retrieve(use_kernel=False)
            if (tuple(scores.shape) != (1, c)
                    or not bool(torch.isfinite(scores).all())):
                raise AssertionError(f"{cfg.name}: not finite [1, C] scores")
            scale = float(plain.abs().max())
            e = float((scores - plain).abs().max())
            share = same_topk(f"{cfg.name} retrieval", (vals, ids),
                              (pvals, pids), plain, RECSYS_TOL * scale)
            log(f"  {cfg.name} retrieval: scores max err {e!r} (max |score| "
                f"{scale!r}), top-{k} ids equal at {share!r} of ranks, "
                f"{launched} embedding_bag launches in {sizes.rounds + 1} "
                f"calls")
            if e > RECSYS_TOL * scale:
                raise AssertionError(f"{cfg.name}: retrieval scores disagree")
            out["retrieval"][name] = dict(ms=ms, candidates=c, err=e,
                                          scale=scale, same_ids=share)
            del scores, plain, cand, user, batch
        if name == "xdeepfm":
            bulk_model = model
        del model
        torch.cuda.empty_cache()
    launches = bag_ops.launches
    log(f"  embedding_bag launches on the main path (6b, 6c): {launches}")
    if launches <= 0:
        raise AssertionError("embedding_bag was not launched on the main "
                             "path")

    # 6d. xDeepFM's lookup alone at serve_bulk: real work for the kernel
    if bulk_model is None:
        from repro_torch.configs import xdeepfm

        bulk_model = build_model(getattr(xdeepfm, sizes.recsys_config),
                                 device=dev, seed=0)
    cfg = bulk_model.cfg
    table = bulk_model.fields["table"].detach()
    t0 = time.perf_counter()
    flat = bulk_model.embedding.flat_ids(torch.from_numpy(make_recsys_batch(
        sizes.bulk_batch, cfg.n_sparse, cfg.vocab_sizes,
        multi_hot=sizes.bulk_hot, seed=1)["sparse_ids"]).to(dev))
    sync(dev)
    n, l = flat.shape
    d = table.shape[1]
    log(f"  6d: {n} bags x {l} ids over {tuple(table.shape)} "
        f"({table.numel() * 4} B); batch {time.perf_counter() - t0:.3f} s")
    with torch.inference_mode():
        got = bag_ops.embedding_bag(flat, table)
        err = max(err, bag_within(f"embedding_bag N={n} L={l} vs plain", got,
                                  embedding_bag_ref(flat, None, table)))
        if not torch.equal(got, bag_ops.embedding_bag(flat, table)):
            raise AssertionError("embedding_bag is not deterministic")
        live = flat >= 0
        lib_ids = torch.where(live, flat, 0)
        lib_w = live.float()  # pads (none here) to row 0 at weight 0
        lib = F.embedding_bag(lib_ids, table, mode="sum",
                              per_sample_weights=lib_w)
        lib_err = bag_within("F.embedding_bag vs the kernel", lib, got)
        del got, lib
        kernel_ms = event_ms(lambda: bag_ops.embedding_bag(flat, table),
                             sizes.reps * 4, dev)
        plain_ms = event_ms(lambda: embedding_bag_ref(flat, None, table),
                            sizes.reps, dev)
        library_ms = event_ms(lambda: F.embedding_bag(
            lib_ids, table, mode="sum", per_sample_weights=lib_w),
            sizes.reps * 4, dev)
    # The bound reads each id once, each distinct row it names once (a
    # repeated row is needed once) and writes the output once.
    distinct = int(torch.unique(flat[flat >= 0]).numel())
    nbytes = n * l * 4 + distinct * d * 4 + n * d * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    gathered = n * l * 4 + n * l * d * 4 + n * d * 4  # every row per id
    log(f"  embedding_bag at N={n} L={l} D={d}: kernel {kernel_ms!r} ms, "
        f"plain {plain_ms!r} ms, library (F.embedding_bag, max err "
        f"{lib_err!r}) {library_ms!r} ms, bound {bound_ms!r} ms (bytes: "
        f"{n * l} ids, {distinct} distinct rows of {d * 4} B, {n * d * 4} B "
        f"out = {nbytes} B over {HBM_BYTES_PER_S} B/s); counting a row per "
        f"id instead, {gathered} B: {gathered / HBM_BYTES_PER_S * 1e3!r} "
        f"ms, {gathered / kernel_ms / 1e9!r} TB/s")
    out["row"] = {
        "name": "embedding_bag", "route": "cuda",
        "source": "src/repro_torch/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/kernel.py:58",
        "launches": launches, "max_abs_err": err, "ms": kernel_ms,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": library_ms,
    }
    del bulk_model, table, flat, lib_ids, lib_w
    return out


def run(dev, sizes: Sizes) -> list[dict]:
    import numpy as np
    import torch

    from repro_torch.core import RetrievalConfig, RetrievalEngine
    from repro_torch.core.topk import topk_two_stage
    from repro_torch.data.synthetic import make_msmarco_like
    from repro_torch.kernels import build
    from repro_torch.kernels.ell_gather import ops as ell_ops
    from repro_torch.kernels.ell_gather.ref import ell_gather_ref
    from repro_torch.kernels.scatter_score import ops as scatter_ops
    from repro_torch.kernels.scatter_score.ref import scatter_score_ref

    # 1. build
    t0 = time.perf_counter()
    build.build()
    log(f"build: {time.perf_counter() - t0:.3f} s for {', '.join(build.SOURCES)}")
    for name, out in build.compiler_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line.lower():
                log(f"  {name}: {line.strip()}")

    # 2. kernels vs plain versions
    log(f"phase 2: kernels vs plain, {sizes.check_docs} docs x "
        f"{sizes.check_queries} queries, V={sizes.vocab}")
    errs = check_kernels(dev, sizes)
    errs["splade_head"] = check_head(dev, sizes)
    log(f"phase 2b: bmp_scan vs plain and the pruned engines, "
        f"{sizes.check_docs} topical docs x {sizes.check_queries} queries")
    errs["bmp_scan"] = check_pruned(dev, sizes)

    # 3. main path
    log(f"phase 3: main path, {sizes.docs} docs x {sizes.queries} queries, "
        f"V={sizes.vocab}, k={sizes.k}")
    t0 = time.perf_counter()
    corpus = make_msmarco_like(sizes.docs, sizes.queries,
                               vocab_size=sizes.vocab, seed=0, device=dev)
    sync(dev)
    nnz = int((corpus.docs.term_ids >= 0).sum())
    q_nnz = int((corpus.queries.term_ids >= 0).sum())
    log(f"  corpus on device: {time.perf_counter() - t0:.3f} s; "
        f"{nnz / sizes.docs:.2f} nnz/doc, {q_nnz / sizes.queries:.2f} "
        f"nnz/query, K={corpus.docs.max_terms}")
    scatter_ops.launches = 0
    ell_ops.launches = 0
    engines, results = {}, {}
    for name in ("tiled", "ell"):
        t0 = time.perf_counter()
        eng = RetrievalEngine(corpus.docs, RetrievalConfig(engine=name,
                                                           k=sizes.k),
                              device=dev)
        sync(dev)
        log(f"  {name}: index build {time.perf_counter() - t0:.3f} s, "
            f"{eng.index_bytes()} B ({eng.index_bytes() / sizes.docs:.1f} "
            f"B/doc)")
        vals, ids, _ = time_search(name, eng, corpus.queries, sizes.k,
                                   sizes.rounds, dev)
        results[name] = vals, ids
        engines[name] = eng
    launches = {"scatter_score": scatter_ops.launches,
                "ell_gather": ell_ops.launches}
    log(f"  launches on the main path: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")

    g = torch.Generator().manual_seed(5)
    sample = torch.randperm(sizes.queries, generator=g)[
        :sizes.oracle_queries].sort().values.numpy()
    oracle = oracle_f64(corpus.docs, corpus.queries, sample)
    for name, (vals, ids) in results.items():
        check_exact(name, vals, ids, oracle, sample, sizes.k)
    (tv, ti), (ev, ei) = results["tiled"], results["ell"]
    ov = overlap(ti, ei, sizes.k)
    rel = float(np.max(np.abs(tv - ev) / np.maximum(np.abs(ev), 1e-30)))
    log(f"  tiled vs ell: overlap@{sizes.k} = {ov!r}, max rel = {rel!r}")
    if ov < OVERLAP_MIN or rel > SCORE_RTOL:
        raise AssertionError("tiled and ell disagree")

    # 3a. SPLADE encoding in front of the exact engines
    log(f"phase 3a: encode -> search, {sizes.encoder} x {sizes.queries} "
        f"queries of {sizes.encode_len} tokens, k={sizes.k}")
    enc_run = encode_search(dev, sizes, corpus, engines)

    # 3b. the pruned path
    log(f"phase 3b: the pruned path, tiled-bmp-fused, {sizes.docs} topical "
        f"docs x {sizes.queries} queries, k={sizes.k}")
    pruned = serve_pruned(dev, sizes, corpus)

    # 4. kernels vs plain at the main path's shapes, then times per kernel
    log("phase 4: kernels vs plain at the main shapes; times (CUDA events)")
    tiled = engines["tiled"]._index
    ell = engines["ell"]._index
    qw_t = padded_queries(corpus.queries, tiled)
    qw = corpus.queries.to_dense()
    b = sizes.queries
    specs = {
        "scatter_score": dict(
            kernel=lambda: scatter_ops.scatter_score(qw_t, **tiled_args(tiled)),
            plain=lambda: scatter_score_ref(qw_t, **tiled_args(tiled)),
            bytes=(tiled.num_chunks * tiled.chunk_size * 12
                   + tiled.num_chunks * 4 + tiled.num_doc_blocks * 8
                   + b * qw_t.shape[1] * 4
                   + b * tiled.padded_docs * 4),
            source="src/repro_torch/csrc/scatter_score.cu",
            replaces="src/repro/kernels/scatter_score/kernel.py:98",
        ),
        "ell_gather": dict(
            kernel=lambda: ell_ops.ell_gather(qw, ell.terms, ell.values),
            plain=lambda: ell_gather_ref(qw, ell.terms, ell.values),
            bytes=(ell.terms.numel() * 8 + b * sizes.vocab * 4
                   + b * ell.terms.shape[0] * 4),
            source="src/repro_torch/csrc/ell_gather.cu",
            replaces="src/repro/kernels/ell_gather/kernel.py:57",
        ),
    }
    for name, s in specs.items():
        err = compare(f"{name} at {sizes.docs} docs x {b} queries",
                      s["kernel"](), s["plain"]())
        errs[name] = max(errs[name], err)
    csr = docs_csr(corpus.docs, torch.float32)
    library_ms = event_ms(lambda: torch.sparse.mm(csr, qw.T), sizes.reps, dev)
    del csr
    # Where a search call's time goes besides the kernel: the [B, N] top-k.
    scores = engines["ell"].score(corpus.queries)
    topk_ms = event_ms(lambda: topk_two_stage(scores, sizes.k), sizes.reps,
                       dev)
    del scores
    log(f"  topk_two_stage [{b}, {sizes.docs}] k={sizes.k}: {topk_ms!r} ms")
    flops = 2.0 * nnz * b
    rows = []
    for name, s in specs.items():
        kernel_ms = event_ms(s["kernel"], sizes.reps, dev)
        plain_ms = event_ms(s["plain"], max(1, sizes.reps // 2), dev)
        t_bytes = s["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        row = {
            "name": name, "route": "cuda", "source": s["source"],
            "replaces": s["replaces"], "launches": launches[name],
            "max_abs_err": errs[name], "ms": kernel_ms,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
        }
        log(f"  {name}: kernel {kernel_ms!r} ms, plain {plain_ms!r} ms, "
            f"library {library_ms!r} ms, bound {row['bound_ms']!r} ms "
            f"({row['bound_by']}: {s['bytes']} B, {flops!r} flop)")
        rows.append(row)
    rows.append(bmp_row(dev, sizes, pruned, errs["bmp_scan"]))
    rows.append(head_row(dev, sizes, enc_run, errs["splade_head"]))
    log(f"peak device memory since phase 3b's last case: "
        f"{torch.cuda.max_memory_allocated(dev)} B")

    # 5. LM serving; the earlier phases' corpora, indices and encoder go
    del corpus, engines, results, pruned, enc_run, tiled, ell, qw_t, qw
    torch.cuda.empty_cache()
    log(f"phase 5a: flash_attention vs plain and float64, "
        f"{len(sizes.flash_shapes)} shapes x f32, bf16")
    err = check_flash(dev, sizes)
    log(f"phase 5: LM serving, {sizes.lm} of repro_torch.configs.qwen2_0_5b: "
        f"prefill {sizes.prefill_batch} x {sizes.prefill_len}, decode "
        f"{sizes.decode_batch} x {sizes.decode_steps} steps from "
        f"{sizes.decode_context}")
    torch.cuda.reset_peak_memory_stats(dev)
    lm_run = serve_lm(dev, sizes, err)
    rows.append(lm_run["row"])
    log(f"peak device memory in phase 5: "
        f"{torch.cuda.max_memory_allocated(dev)} B")

    # 6. recsys serving; phase 5's model and cache are gone
    del lm_run
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    log(f"phase 6a: embedding_bag vs plain and float64, "
        f"{len(sizes.bag_shapes)} shapes")
    err = check_bags(dev, sizes)
    log(f"phase 6: recsys serving, {sizes.recsys_config} of "
        f"{', '.join(sizes.recsys_models)}: serve {sizes.serve_batch} at "
        f"H = {sizes.hots}, retrieval over {sizes.candidates} candidates "
        f"(DIN {sizes.din_candidates}), lookup at {sizes.bulk_batch}")
    rows.append(serve_recsys(dev, sizes, err)["row"])
    log(f"peak device memory in phase 6: "
        f"{torch.cuda.max_memory_allocated(dev)} B")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    card = card_line()
    log(f"card: {card}")
    dev = torch.device("cuda", 0)
    rows = run(dev, Sizes())
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
