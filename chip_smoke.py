#!/usr/bin/env python3
"""Drive the PyTorch port's exact and pruned paths, SPLADE query encoding
in front of the exact one, LM serving (prefill and decode), recsys
serving (DIN, DIEN, AutoInt, xDeepFM), training (the encoder, the LM and
the recsys models) and the serving state (sessions, deletions, the
scheduler, the segment store), on one NVIDIA H100.

Run from the root of a checkout, with one CUDA card and no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. Build the six CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, in parallel), print the card's name and power
   limit, each kernel's registers and spills, and (where ``cuobjdump`` is
   present) the count of ``HGMMA`` instructions in ``flash_attention``'s
   library and of ``HMMA`` in ``splade_head``'s: the tensor-core routes
   must show in the compiled code.
2. Hold ``scatter_score`` and ``ell_gather`` against their plain PyTorch
   versions on the card, at 50,000 docs x 64 queries, V = 30,522, over
   several index geometries (``chunk_size < term_block``, a ragged last
   doc block, a tile-skipped index whose blanked chunks test the padding
   rule), on the corpus's sparse query tiles and on nearly dense ones (the
   kernels' dense route), each launched twice and bitwise equal;
   ``splade_head`` against its plain version at (B, T, d, V) =
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
   over 67 TFLOP/s, H100 SXM data sheet).  The bytes count the index's
   live slots (every ELL slot's term id, which marks the padding), QW and
   the scores once; the old yardstick, the padded index stream, is printed
   beside it.  The operations are 2 x the
   nonzero products sum_q sum_{t in q} df(t), counted on the card from the
   index and the queries (the old yardstick, 2 x postings x B, printed
   beside it), with the counts the kernels' design rests on: the nonzero
   share, the postings whose term has a nonzero weight in a tile of 128
   queries, the nonzero queries of such a posting, the distinct terms a
   tile and the term blocks it touches; the packing of the query tiles and
   ``scatter_score``'s ``chunk_doc_bounds`` are timed apart (they run
   inside the kernels' entries, so inside their times).  Both kernels on
   phase 3a's nearly dense encoder queries: the dense route they pick
   against the sparse route forced, timed apart and bitwise equal.  For ``bmp_scan``: a sample of
   the main path's groups (the bucket with the most rows) and two of its
   one-row groups against the plain version; the route and cluster size of
   each launch; the times of the sample, of the launch of one-row groups
   and of every launch of one search call, each beside the floor of the
   work its data needs (the demanded chunk lines of a term block with a
   nonzero weight of the group, the windows, heaps and weights, each
   moved once; the row's bound) and the same count over every demanded
   line, with the share of chunk lines and postings the skip leaves
   unread; no library call.
   For ``splade_head``: its time at phase 3a's shapes (the encoder's own
   hidden states, B = 500, T = 64), the plain version's, one
   ``torch.matmul`` of h [B T, d] by W (the product alone, used nowhere in
   the port) and the bound of 3 x 2 x valid tokens x d V TF32 operations
   over 495 TFLOP/s (the kernel keeps f32 accuracy with three TF32
   products; a token of mask 0 needs no product), with the f32 SIMT bound
   beside it.
5a. With the earlier phases' data freed: ``flash_attention`` against its
   plain version and a float64 softmax, f32 and bf16, over JAX's
   ``test_flash_attention_sweep`` geometries at Dh 64, qwen2-0.5b's heads
   (Hq 14 over 2) with S = 1000 and 2048 (windowed), Dh 128 (Hq 32 over 8),
   windows and MQA (FLASH_TOL), and that it is deterministic.  f32 inputs
   take the SIMT route, bf16 the wgmma route.
5. LM serving at the full width and depth of ``qwen2-0.5b``
   (``repro_torch.configs.qwen2_0_5b.FULL``: 24 layers, d 896, 14 heads
   over 2, d_ff 4864, V = 151,936, bf16 compute) with seeded random
   weights.  ``TransformerLM.prefill`` of 1 x 32,768 tokens from
   ``make_lm_batch`` (``prefill_32k`` with its batch cut from 32 to 1): a
   warm-up and 5 rounds on the host clock, the ``flash_attention`` counter
   zeroed before and read after (24 launches a prefill).  The kernel
   against its plain version on layer 0's own q, k, v at that shape, then
   its time (the bf16 wgmma route), the f32 SIMT route's on the same
   inputs in f32, the plain version's, one ``scaled_dot_product_attention``
   call's (used nowhere in the port) and its bound (4 B Hq Dh x the visible
   (query, key) pairs over 989 TFLOP/s of bf16, or the q, k, v, o bytes
   over 3.35 TB/s; the bf16 route does 1.5x those operations, p v twice).  The whole prefill through the kernel against the plain
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
   before 6b and read after 6c.  6d: the lookups alone at serve_bulk's
   batch (262,144 examples; xDeepFM's CIN would need 82 GB there):
   xDeepFM's (39 bags of 8 over 16,596,850 rows, D = 10; the kernels
   line's row), AutoInt's (the same tables, D = 16) and DIN's context (6
   bags of 8 over 1,111,110 rows, D = 18), each under uniform and skewed
   ids (a power law of exponent SKEW_EXPONENT per field), weights None and
   given: every route (vec, ivec) that the inputs' values reach at 0-, 8-
   and 4-byte offsets bitwise equal, unweighted
   bags bitwise the sequential f32 fold, uniform ids within BAG_TOL of the
   plain version (xDeepFM's also of float64); CUDA-event times of the
   kernel and one ``F.embedding_bag`` call (used nowhere in the port), the
   plain version's for the row, the bound (each id and weight, each
   distinct row and the output once, over 3.35 TB/s), the distinct rows'
   sectors and the L2-side bytes (live ids x sectors a row x 32 B).  Then
   the probe of uniform ids against ids confined to the L2-resident tail
   of the table and ids all from the 10M-row field.

7. Training, with phase 6's data freed (no kernel has a backward, so the
   losses run the plain versions, in JAX as here).  7a: ``SpladeEncoder``
   at phase 3a's full width (seeded weights) trained on
   ``paired_batch_fn`` batches (32 pairs x 128 tokens), AdamW (lr 2e-3,
   10 warm-up steps): one step's loss and gradients on the card against the
   CPU at 8 pairs (TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL; the CPU pools each
   max over tokens from the card's token, since a near tie flips between
   two orders of summation); 10 steps on one repeated batch under
   deterministic algorithms, where the loss must fall, and the same 10 in
   the default mode (the step's time); then, from the seeded weights
   again and under deterministic algorithms, 20 steps
   of ``Trainer`` over ``DeterministicPipeline`` with async checkpoints
   every 10 steps, and a second model restored from the checkpoint of step
   10 that runs steps 11-20: its losses, parameters and moments bit for
   bit the unbroken run's.  Each step's time on the host clock
   (synchronised; the median from step 3), examples/s, peak memory and
   bound (6 x non-embedding parameters x tokens, 3 x the head's 2 x tokens
   x d x V and 3 x the attention's products, over the f32 rate; the
   products of one step counted by ``torch.utils.flop_counter`` beside it).
   7b: 500 pairs encoded through ``splade_head`` (held to the plain head)
   before and after training, their docs searched through ``tiled`` and
   ``ell`` (``scatter_score`` and ``ell_gather``) at k = 10 and held to
   float64; MRR@10 and nonzeros a doc printed; the three kernels'
   counters zeroed before 7a and read after 7b.  7c: ``qwen2-0.5b`` at
   full width and depth with remat, bf16 compute, 5 steps of 1 x 4,096
   tokens (``train_4k`` with its batch cut 256 -> 1) on one repeated
   batch: the loss falls; remat on and off give the same gradients bit for
   bit at 2 layers x 1,024.  7d: the four recsys models at ``FULL`` width,
   5 steps at B = 8,192 with bags of 8 (``train_batch`` cut 65,536 ->
   8,192): the loss falls.  A ``{"training": [...]}`` line holds each
   step's row.

8. Serving state at serve_1m, with phase 7's data freed (the launch
   counters of ``scatter_score``, ``ell_gather`` and ``bmp_scan`` zeroed
   before and read after; each must be launched).  8a: a ``Retriever``
   grown by ``add_docs`` in 4 segments (3 x 262,144 docs and 213,568),
   for ``tiled`` and ``ell``: its top-k against one ``RetrievalEngine``
   over the 1M docs (tie-aware, values within 1e-5 relative) and against
   float64 as in phase 3; a fenced ``obs`` span around one
   ``scatter_score`` call at least its CUDA-event time.  8b: on phase 3b's
   topical corpus, for ``tiled`` and ``tiled-bmp-fused``: 1 % of the docs
   deleted (seeded) equals an engine rebuilt on the survivors, and
   ``compact(0.25)`` (no segment qualifies) and ``compact(0.005)`` (every
   segment rebuilt) leave the results unchanged.  8c: a ``SearchSession``
   on ``tiled-bmp-fused`` (doc_block 64, k = 10): cold, warm, and warm
   after ``add_docs`` of 65,536 docs, bitwise the cold session's; blocks
   skipped from the cached tau.  8d: a ``QueryScheduler`` (micro-batches
   of 128) drains 2,000 requests (4 replays of the queries as new
   streams, deadline 0.5 s), each result equal to direct
   ``Retriever.search``; QPS and the e2e latency's p50/p99 from the obs
   snapshot; ``tiled`` search with ``obs=None`` against ``Obs()``.  8e:
   ``SegmentWriter`` writes the corpus (``tiled``, segments of 262,144)
   to a temporary directory; ``Retriever.from_store`` with no budget and
   with half the device bytes gives the resident bits; write and open
   seconds, pager counters and the effective H2D rate.  A
   ``{"serving_state": {...}}`` line holds the numbers.

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
# serve_bulk's skewed ids (6d): a power law over each field's ranks.
SKEW_EXPONENT = 1.05
TF32_FLOP_PER_S = 495e12  # H100 SXM TF32 on the tensor cores, dense
# Training, one step on the card against the CPU: the loss within 1e-5
# relative, each gradient leaf within 1e-4 of its max |g| (f32 products
# summed in another order through 12 layers and back, no TF32).
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
# The SASS instruction each tensor-core kernel must hold: wgmma (HGMMA) for
# flash_attention's bf16 route, TF32 mma.sync (HMMA) for splade_head.
TENSOR_CORE_OPS = {"flash_attention": "HGMMA", "splade_head": "HMMA"}


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
    singleton_checks: int = 2  # phase 4: one-row groups held against plain
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
    # 6d's lookups: xDeepFM's (the kernels line's row), AutoInt's and DIN's
    # context, each under these ids (bulk_ids), weights None and given.
    bulk_models: tuple = ("xdeepfm", "autoint", "din")
    bulk_kinds: tuple = ("uniform", "skewed")
    # Training (phase 7).  7a: the encoder of phase 3a on batches of
    # paired_batch_fn, as examples/train_splade.py trains it.
    train_pairs: int = 32
    train_len: int = 128
    train_steps: int = 20
    checkpoint_every: int = 10  # the restart resumes from the first
    overfit_steps: int = 10  # steps on one repeated batch
    cpu_pairs: int = 8  # one step on the card against the CPU
    train_lr: float = 2e-3
    train_warmup: int = 10
    flops_weight: float = 3e-4
    eval_pairs: int = 500  # 7b: served through the kernels
    eval_k: int = 10
    # 7c: LM_SHAPES' train_4k, its batch cut 256 -> 1.
    lm_train_batch: int = 1
    lm_train_len: int = 4096
    lm_train_steps: int = 5
    lm_train_lr: float = 1e-3
    remat_layers: int = 2  # remat on vs off
    remat_len: int = 1024
    # 7d: RECSYS_SHAPES' train_batch, cut 65,536 -> 8,192.
    recsys_train_batch: int = 8192
    recsys_train_hot: int = 8
    recsys_train_steps: int = 5
    # Serving state (phase 8) at serve_1m: a Retriever grown in 4
    # segments of 262,144 docs (the last 213,568), 1 % of the docs
    # deleted, a session grown by 65,536 docs, 4 replays of the queries
    # through the scheduler, and the store's segments of the same size.
    state_segments: int = 4
    state_segment_docs: int = 262_144
    delete_share: float = 0.01
    compact_threshold: float = 0.25
    session_extra_docs: int = 65_536
    sched_batch: int = 128
    sched_replays: int = 4
    sched_deadline_s: float = 0.5
    state_rounds: int = 3  # 8a: rounds after a warm-up


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


def dense_queries(b, width, dev, seed):
    """Nearly dense f32 query weights [b, width] (uniform, 10 % zeros, as
    the encoder's thresholded output): tiles of them take the kernels'
    dense route."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    qw = torch.rand((b, width), generator=g, device=dev)
    return torch.where(qw > 0.1, qw, 0.0)


def check_kernels(dev, sizes: Sizes):
    """Phase 2: each kernel against its plain version, several geometries,
    on the corpus's sparse query tiles and on dense ones; each launched
    twice, bitwise equal."""
    import torch

    from repro_torch.core import index as index_mod
    from repro_torch.data.synthetic import make_msmarco_like
    from repro_torch.kernels.ell_gather import ell_gather, ell_gather_ref
    from repro_torch.kernels.scatter_score import (
        scatter_score, scatter_score_ref,
    )

    def same_twice(name, fn, got):
        if not torch.equal(got, fn()):
            raise AssertionError(f"{name} is not deterministic")

    c = make_msmarco_like(sizes.check_docs, sizes.check_queries,
                          vocab_size=sizes.vocab, seed=11, device=dev)
    errs = {"scatter_score": 0.0, "ell_gather": 0.0}
    for i, (tb, db, cs) in enumerate(sizes.geometries):
        idx = index_mod.build_tiled_index(c.docs, term_block=tb, doc_block=db,
                                          chunk_size=cs)
        qw = padded_queries(c.queries, idx)
        cases = [("", idx, qw),
                 ("/tile-skip", index_mod.filter_tiled_index(
                     idx, c.queries.slice_rows(0, 2)), qw)]
        if i == 0:
            cases.append(("/dense tile", idx,
                          dense_queries(*qw.shape, dev, seed=tb)))
        for tag, ix, q in cases:
            args = tiled_args(ix)
            got = scatter_score(q, **args)
            want = scatter_score_ref(q, **args)
            err = compare(f"scatter_score T={tb} D={db} C={cs}{tag}",
                          got, want)
            errs["scatter_score"] = max(errs["scatter_score"], err)
            same_twice("scatter_score", lambda: scatter_score(q, **args), got)
    ell = index_mod.build_ell_index(c.docs)
    qw = c.queries.to_dense()
    for tag, q in (("", qw), ("/dense tile",
                              dense_queries(*qw.shape, dev, seed=1))):
        got = ell_gather(q, ell.terms, ell.values)
        errs["ell_gather"] = max(errs["ell_gather"], compare(
            f"ell_gather{tag}", got, ell_gather_ref(q, ell.terms,
                                                    ell.values)))
        same_twice("ell_gather", lambda: ell_gather(q, ell.terms, ell.values),
                   got)
    return errs


def query_counts(docs, qw, vocab: int, term_block: int) -> dict:
    """What the exact kernels' work depends on, counted on the card from
    the corpus and the dense queries qw [B, V]: the nonzero products
    sum_q sum_{t in q} df(t), and per tile of QUERY_TILE queries the
    postings whose term has a nonzero weight in the tile, the nonzero
    queries of such a posting, the tile's distinct terms and its share of
    term blocks holding one."""
    import torch

    from repro_torch.kernels.query_tiles import QUERY_TILE

    ids = docs.term_ids[docs.term_ids >= 0].long()
    df = torch.bincount(ids, minlength=vocab).double()
    postings = float(df.sum())
    nz = qw[:, :vocab] != 0
    b = nz.shape[0]
    products = float((nz.double() @ df).sum())
    n_tiles = -(-b // QUERY_TILE)
    tiles = torch.nn.functional.pad(nz, (0, 0, 0, n_tiles * QUERY_TILE - b))
    in_tile = tiles.view(n_tiles, QUERY_TILE, vocab).any(1)  # [tiles, V]
    live = float((in_tile.double() * df).sum())
    n_tb = -(-vocab // term_block)
    blocks = torch.nn.functional.pad(in_tile, (0, n_tb * term_block - vocab))
    touched = blocks.view(n_tiles, n_tb, term_block).any(-1)
    return {
        "postings": postings, "queries": b, "tiles": n_tiles,
        "nonzero_products": products,
        "nonzero_share": products / (postings * b),
        "live_posting_share": live / (postings * n_tiles),
        "queries_per_live_posting": products / max(live, 1.0),
        "distinct_terms_per_tile": in_tile.sum(1).tolist(),
        "distinct_terms_all": int(nz.any(0).sum()),
        "term_blocks_touched_share": float(touched.double().mean()),
    }


def dense_routes(dev, sizes: Sizes, queries, tiled, ell) -> None:
    """Phase 4: the kernels on phase 3a's encoder queries (nearly dense
    tiles): their route as picked (dense) against the sparse route forced
    on the same tiles (``DENSE_SHARE`` above 1), timed apart and bitwise
    equal."""
    import torch

    from repro_torch.kernels import query_tiles
    from repro_torch.kernels.ell_gather import ops as ell_ops
    from repro_torch.kernels.scatter_score import ops as scatter_ops

    qw_t = padded_queries(queries, tiled)
    qw = queries.to_dense()
    dense = query_tiles.pack_query_tiles(qw)[3].tolist()
    pack_ms = event_ms(lambda: query_tiles.pack_query_tiles(qw), sizes.reps,
                       dev)
    log(f"  encoder queries: nonzero share {float((qw != 0).double().mean())!r}"
        f", dense tiles {dense}; packing them {pack_ms!r} ms")
    calls = {"scatter_score": lambda: scatter_ops.scatter_score(
                 qw_t, **tiled_args(tiled)),
             "ell_gather": lambda: ell_ops.ell_gather(qw, ell.terms,
                                                      ell.values)}
    for name, fn in calls.items():
        picked = fn()
        picked_ms = event_ms(fn, sizes.reps, dev)
        share = query_tiles.DENSE_SHARE
        query_tiles.DENSE_SHARE = 2.0  # no tile is dense: the sparse route
        try:
            same = torch.equal(picked, fn())
            sparse_ms = event_ms(fn, sizes.reps, dev)
        finally:
            query_tiles.DENSE_SHARE = share
        del picked
        log(f"  {name} on the encoder's tiles: route as picked "
            f"{picked_ms!r} ms, sparse route forced {sparse_ms!r} ms; "
            f"bitwise equal: {same}")
        if not same:
            raise AssertionError(f"{name}: the dense and sparse routes "
                                 f"differ in bits")


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
                encode_ms=encode_ms, launches=launches["splade_head"],
                queries=tq)


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
    # the function needs the product only for the valid tokens' rows.  Kept
    # exact to f32 on the tensor cores (3xTF32) the product is three TF32
    # products: the least time the card could take; the f32 SIMT bound is
    # printed beside it.
    rows = int((mask != 0).sum())
    nbytes = 4 * (rows * d + b * t + d * v + v + b * v)
    flops = 2.0 * rows * d * v
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * flops / TF32_FLOP_PER_S * 1e3
    t_simt = flops / F32_FLOP_PER_S * 1e3
    row = {
        "name": "splade_head", "route": "cuda",
        "kernel_route": "cuda-mma-3xtf32",
        "source": "src/repro_torch/csrc/splade_head.cu",
        "replaces": "src/repro/kernels/splade_head/kernel.py:46",
        "launches": enc_run["launches"], "max_abs_err": err, "ms": kernel_ms,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_ms_f32_simt": max(t_bytes, t_simt),
        "library_ms": library_ms,
    }
    log(f"  splade_head: kernel {kernel_ms!r} ms ({kernel_ms / enc_run['encode_ms']!r} "
        f"of an encode call), plain {plain_ms!r} ms, library (matmul alone) "
        f"{library_ms!r} ms, bound {row['bound_ms']!r} ms "
        f"({row['bound_by']}: {rows} valid token rows of {b * t}, {nbytes} "
        f"B, 3 x {flops!r} TF32 flop; {t_simt!r} ms for {flops!r} f32 flop "
        f"outside the tensor cores)")
    return row


def sweep_work(idx, qw, launch, got, k_eff) -> dict:
    """What one ``bmp_sweep`` launch had to do, from its fetch sets and
    inputs.  ``bytes``: each input read once and each output written once
    -- the distinct chunk lines (12 B a slot) that some group of the launch
    demanded in a term block holding a nonzero weight of that group (a line
    of any other term block adds 0 to every score), each read once for the
    whole launch, the query weights read once, the scored windows and the
    heaps written once; ``bytes_all_lines`` the same over every distinct
    demanded line.  ``flops``: 2 x live postings of each group's kept lines
    x rows.  Group by group: ``line_reads`` (each group's kept lines, what a
    kernel that reads a line once a group reads), ``lines`` demanded and
    ``lines_skipped`` of them, ``postings`` and ``postings_skipped``."""
    import torch

    from repro_torch.kernels.bmp_scan import ops as bmp_ops

    sel = launch[0]
    gs, rows = sel.shape
    bsc, csc = got[2].bool(), got[3].bool()
    tbnz = bmp_ops.term_block_mask(bmp_ops.nonzero_terms(qw[sel]),
                                   idx.term_block).bool()
    kept = csc & tbnz[:, idx.chunk_term_block.long()]
    live = (idx.local_doc >= 0).sum(dim=1).double()
    postings = int((csc.double() @ live).sum())
    postings_kept = int((kept.double() @ live).sum())
    lines, lines_kept = int(csc.sum()), int(kept.sum())
    distinct, distinct_kept = int(csc.any(0).sum()), int(kept.any(0).sum())
    rest = (int(bsc.sum()) * rows * idx.doc_block * 4  # windows written
            + gs * rows * k_eff * 4  # heaps written
            + gs * rows * qw.shape[1] * 4)  # query weights read
    line = idx.chunk_size * 12
    del kept, tbnz
    torch.cuda.empty_cache()
    return dict(bytes=distinct_kept * line + rest,
                bytes_all_lines=distinct * line + rest,
                flops=2.0 * postings_kept * rows, line_reads=lines_kept,
                lines=lines, lines_skipped=lines - lines_kept,
                postings=postings, postings_skipped=postings - postings_kept)


def sweep_bound(work: dict):
    """(bound ms, "bytes" or "operations") of :func:`sweep_work`'s work."""
    t_bytes = work["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = work["flops"] / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def work_line(name, ms, work: dict, line_bytes: int) -> str:
    bound, by = sweep_bound(work)
    w = work
    return (f"  {name}: kernel {ms!r} ms, bound {bound!r} ms ({by}: "
            f"{w['bytes']} B, each kept line once, {w['flops']!r} flop; "
            f"every demanded line once {w['bytes_all_lines']} B = "
            f"{w['bytes_all_lines'] / HBM_BYTES_PER_S * 1e3!r} ms); kept "
            f"lines read group by group {w['line_reads']} = "
            f"{w['line_reads'] * line_bytes} B; the skip leaves "
            f"{w['lines_skipped']} of {w['lines']} demanded lines "
            f"({w['lines_skipped'] / max(w['lines'], 1)!r}) and "
            f"{w['postings_skipped']} of {w['postings']} postings "
            f"({w['postings_skipped'] / max(w['postings'], 1)!r}) unread, "
            f"group by group")


def bmp_row(dev, sizes: Sizes, main, err: float) -> dict:
    """Phase 4 for ``bmp_scan``: a sample of the main path's groups and a
    few of its singleton groups against the plain version, then times at
    those shapes and of every launch of a search call, each beside the
    bound of the work it did."""
    import numpy as np

    from repro_torch.core import scoring
    from repro_torch.kernels.bmp_scan import ops as bmp_ops
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
    outs = []
    t0 = time.perf_counter()
    for launch in launches:
        outs.append(launch[4]())
        log(f"  bmp_scan launch of {tuple(launch[0].shape)} groups x rows: "
            f"{bmp_ops.last_route}")
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
    # The launch of the one-row groups, where the call's groups are.
    single = min(range(len(launches)),
                 key=lambda i: launches[i][0].shape[1])
    err = max(err, check_sweep("bmp_scan at serve_1m, one-row groups", idx,
                               qw, launches[single], outs[single],
                               sizes.singleton_checks))
    kernel_ms = event_ms(sample[4], sizes.reps, dev)
    single_ms = event_ms(launches[single][4], sizes.reps, dev)
    all_ms = event_ms(lambda: [launch[4]() for launch in launches], 1, dev)
    plain = (lambda: [bmp_sweep_ref(qw[sel_full[g]], order[g], us[g], tau[g],
                                    *tiled_runs(idx), None, **kw)
                      for g in range(sel_full.shape[0])])
    plain_ms = event_ms(plain, 1, dev)
    # The least the data needs: a chunk line of a term block without a
    # nonzero weight of the group adds 0 to every score, so only the other
    # lines count, each once a launch (the bound over every demanded line
    # is logged beside it).
    work = sweep_work(idx, qw, sample, got, k_eff)
    bound_ms, bound_by = sweep_bound(work)
    row = {
        "name": "bmp_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/bmp_scan.cu",
        "replaces": "src/repro/kernels/bmp_scan/kernel.py:297",
        "launches": main["launches"], "max_abs_err": err, "ms": kernel_ms,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }
    gs, rows = sel_full.shape
    line = idx.chunk_size * 12
    log(work_line(f"bmp_scan on {gs} groups x {rows} rows of the main path "
                  f"(plain {plain_ms!r} ms, library: none)", kernel_ms,
                  work, line))
    log(work_line(f"bmp_scan on the {launches[single][0].shape[0]} one-row "
                  f"groups", single_ms,
                  sweep_work(idx, qw, launches[single], outs[single], k_eff),
                  line))
    # Launch by launch: a call's bound is the sum of its launches' bounds.
    whole = [sweep_work(idx, qw, launch, out, k_eff)
             for launch, out in zip(launches, outs)]
    del outs
    log(work_line(f"bmp_scan, every launch of one search call "
                  f"({len(launches)} launches, CUDA events; bytes and flops "
                  f"summed over its launches)", all_ms,
                  {key: sum(w[key] for w in whole) for key in whole[0]},
                  line))
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
        # the other route at the same shape: the f32 SIMT kernel
        q32, k32, v32 = (t.float() for t in (q, k, v))
        f32_ms = event_ms(lambda: flash_ops.flash_attention(
            q32, k32, v32, True, win), max(1, sizes.reps // 2), dev)
        del q32, k32, v32
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
        route = ("cuda-wgmma-bf16" if q.dtype == torch.bfloat16
                 else "cuda-simt-f32")
        row = {
            "name": "flash_attention", "route": "cuda",
            "kernel_route": route,
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:110",
            "launches": launches, "max_abs_err": err, "ms": kernel_ms,
            "kernel_ms": kernel_ms, "ms_f32_simt": f32_ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
        }
        log(f"  flash_attention at {tuple(q.shape)} {q.dtype} ({route}): "
            f"kernel {kernel_ms!r} ms ({kernel_ms * cfg.n_layers!r} ms a "
            f"prefill, {cfg.n_layers * kernel_ms / prefill_ms!r} of it), the "
            f"f32 SIMT route at the same shape {f32_ms!r} ms, plain "
            f"{plain_ms!r} ms, library (scaled_dot_product_attention) "
            f"{library_ms!r} ms, bound {row['bound_ms']!r} ms "
            f"({row['bound_by']}: {nbytes} B, {flops!r} flop; "
            f"{row['bound_ms'] * cfg.n_layers!r} ms a prefill); "
            f"{flops / kernel_ms / 1e9!r} TFLOP/s counted (the bf16 route "
            f"multiplies p v twice: 1.5x the counted work)")
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


def sectors_per_row(d: int) -> float:
    """32-byte sectors a row of ``d`` floats spans, averaged over the row
    starts of a table whose first row is 32-byte aligned (2 at D = 10 and
    16, 3 at D = 18)."""
    rb = 4 * d
    starts = [(rb * i) % 32 for i in range(8)]  # the starts repeat by 8 rows
    return sum((s + rb - 1) // 32 + 1 for s in starts) / len(starts)


def bulk_ids(kind: str, batch: int, vocab_sizes, hot: int, dev, seed: int):
    """int32 [batch * F, hot] rows of the concatenated table (bag n of
    field n mod F), made on the card from ``seed``.  ``uniform``: each
    field's ids uniform over its rows (``make_recsys_batch``'s law);
    ``skewed``: each field's ranks a power law of exponent SKEW_EXPONENT,
    mapped through a seeded permutation of the field's rows; ``confined``:
    every id uniform over the rows from the first field of at most 100,000
    rows on (the L2-resident tail of Criteo-39); ``big``: every id from the
    largest field."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    sizes = [int(v) for v in vocab_sizes]
    offs = [sum(sizes[:i]) for i in range(len(sizes))]
    f = len(sizes)
    if kind in ("confined", "big"):
        if kind == "confined":
            lo = next(o for o, v in zip(offs, sizes) if v <= 100_000)
            hi = sum(sizes)
        else:
            big = max(range(f), key=lambda i: sizes[i])
            lo, hi = offs[big], offs[big] + sizes[big]
        return torch.randint(lo, hi, (batch * f, hot), generator=g,
                             device=dev, dtype=torch.int32)
    ids = torch.empty((batch, f, hot), dtype=torch.int32, device=dev)
    for i, v in enumerate(sizes):
        if kind == "uniform":
            r = torch.randint(0, v, (batch, hot), generator=g, device=dev)
        elif kind == "skewed":
            p = torch.arange(1, v + 1, dtype=torch.float64,
                             device=dev) ** -SKEW_EXPONENT
            cdf = torch.cumsum(p / p.sum(), 0)
            u = torch.rand((batch, hot), generator=g, device=dev,
                           dtype=torch.float64)
            rank = torch.searchsorted(cdf, u).clamp_max(v - 1)
            r = torch.randperm(v, generator=g, device=dev)[rank]
        else:
            raise ValueError(f"bulk_ids: kind {kind!r}")
        ids[:, i] = (r + offs[i]).to(torch.int32)
    return ids.reshape(batch * f, hot)


def bag_probe(fns: dict, table, vocab_sizes, batch: int, hot: int,
              reps: int, dev) -> None:
    """The probe of ``embedding_bag`` at serve_bulk: CUDA-event ms of each
    ``fns[name](ids, table)`` under ``uniform``, ``confined`` and ``big``
    ids (:func:`bulk_ids`), timed in turns (a, b, ..., b, a; each name's
    mean), each with the row-sector rate it implies (ids x sectors a row x
    32 B over the time).  Confined ids are L2 hits, big ones misses to
    device memory; uniform ones mix both with the smallest fields' L1
    hits."""
    d = table.shape[1]
    for seed, kind in enumerate(("uniform", "confined", "big")):
        ids = bulk_ids(kind, batch, vocab_sizes, hot, dev, seed=100 + seed)
        l2 = ids.numel() * sectors_per_row(d) * 32
        times = {name: [] for name in fns}
        for name in [*fns, *reversed(fns)]:
            times[name].append(event_ms(lambda: fns[name](ids, table), reps,
                                        dev))
        for name, ts in times.items():
            ms = sum(ts) / len(ts)
            log(f"  probe {name} D={d} {kind} ids: {ms!r} ms (turns "
                f"{ts!r}), {l2!r} B of row sectors = {l2 / ms / 1e9!r} TB/s")
        del ids


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
    after 6c.  6d: the lookups alone at serve_bulk (:func:`bulk_lookups`)
    on the tables of ``sizes.bulk_models``, kept from 6b."""
    import importlib

    import torch

    from repro_torch.core.topk import topk
    from repro_torch.data.synthetic import make_recsys_batch
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.models.recsys import build_model

    out = {"serve": {}, "retrieval": {}}
    tables = {}  # 6d's tables, kept from the models served in 6b
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
        if name in sizes.bulk_models:
            tables[name] = (cfg, model.fields["table"].detach())
        del model
        torch.cuda.empty_cache()
    launches = bag_ops.launches
    log(f"  embedding_bag launches on the main path (6b, 6c): {launches}")
    if launches <= 0:
        raise AssertionError("embedding_bag was not launched on the main "
                             "path")

    out["row"] = bulk_lookups(dev, sizes, tables, err, launches)
    return out


def at_offset(t, nbytes: int):
    """A copy of contiguous ``t`` whose data starts ``nbytes`` (0, 4, 8 or
    12) past a 16-byte boundary: the alignment that makes
    ``embedding_bag``'s entry pick a narrower route (``pick_route``)."""
    k = nbytes // t.element_size()
    store = t.new_empty(t.numel() + 4)  # the allocator aligns to 512 B
    view = store[k:k + t.numel()].view(t.shape)
    view.copy_(t)
    if view.data_ptr() % 16 != nbytes:
        raise AssertionError(f"at_offset: {view.data_ptr() % 16} B, not "
                             f"{nbytes}")
    return view


def route_copies(ids, table, weights):
    """{(vec, ivec): (ids, table, weights)}: the inputs' values at 0-, 8-
    and 4-byte offsets (:func:`at_offset`), one copy for each route of
    ``embedding_bag`` they reach, the widest first."""
    from repro_torch.kernels.embedding_bag import ops as bag_ops

    def moved(t, off):
        return t if off == 0 or t is None else at_offset(t, off)

    bags = [(moved(ids, off), moved(weights, off)) for off in (0, 8, 4)]
    copies = {}
    for off in (0, 8, 4):
        t = moved(table, off)
        for i, w in bags:
            route = bag_ops.pick_route(
                t.shape[1], i.shape[1], t.data_ptr(), i.data_ptr(),
                None if w is None else w.data_ptr())
            copies.setdefault(route, (i, t, w))
    return copies


def bulk_lookups(dev, sizes: Sizes, tables: dict, err: float,
                 launches: int) -> dict:
    """6d: each of ``sizes.bulk_models``' lookups alone at serve_bulk
    (``bulk_batch`` examples x its fields, bags of ``bulk_hot``), under
    each of ``sizes.bulk_kinds``' ids, weights None and given.  The kernel
    is held bitwise to every route (vec, ivec) that the inputs' values
    reach at 0-, 8- and 4-byte offsets (:func:`route_copies`) and,
    unweighted, to the sequential f32 fold; at uniform ids to its
    plain version (and, for xDeepFM, to float64) within BAG_TOL.  Times
    (CUDA events): the kernel, one ``F.embedding_bag`` call (used nowhere
    in the port), and for xDeepFM at uniform unweighted ids (the kernels
    line's row) the plain version; beside them the bound (each id and
    weight, each distinct row and the output once, over 3.35 TB/s), the
    distinct rows' sectors (the two-sector count at D = 10) and the
    L2-side bytes (live ids x sectors a row x 32 B).  Then the probe
    (:func:`bag_probe`) on xDeepFM's table."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.embedding_bag.ref import (embedding_bag_ref,
                                                      sequential_bag_sum)

    if "xdeepfm" not in tables:
        raise AssertionError("6d needs xDeepFM's table (its kernels row)")
    b, hot, reps = sizes.bulk_batch, sizes.bulk_hot, sizes.reps * 4
    row = None
    for m, name in enumerate(sizes.bulk_models):
        cfg, table = tables[name]
        fields = tuple(cfg.vocab_sizes)
        d = table.shape[1]
        for k, kind in enumerate(sizes.bulk_kinds):
            t0 = time.perf_counter()
            ids = bulk_ids(kind, b, fields, hot, dev, seed=10 * m + k)
            n, l = ids.shape
            w = torch.rand((n, l), generator=torch.Generator(
                device=dev).manual_seed(k), device=dev)
            live = (ids >= 0) & (ids < table.shape[0])
            distinct = int(torch.unique(ids[live]).numel())
            sync(dev)
            log(f"  6d {cfg.name} {kind}: {n} bags x {l} ids over "
                f"{tuple(table.shape)}, {distinct} distinct rows; ids "
                f"{time.perf_counter() - t0:.3f} s")
            lib_ids = torch.where(live, ids, 0)
            for weights in (None, w):
                tag = (f"embedding_bag {cfg.name} {kind} ids, weights "
                       f"{'none' if weights is None else 'given'}")
                with torch.inference_mode():
                    got = bag_ops.embedding_bag(ids, table, weights)
                    route = bag_ops.pick_route(
                        d, l, table.data_ptr(), ids.data_ptr(),
                        None if weights is None else weights.data_ptr())
                    # every other route, through the same values at 8- and
                    # 4-byte offsets
                    copies = route_copies(ids, table, weights)
                    for other_route, args in copies.items():
                        if other_route != route and not torch.equal(
                                bag_ops.embedding_bag(*args[:2], args[2]),
                                got):
                            raise AssertionError(f"{tag}: route (vec, ivec) "
                                                 f"{other_route} gives other "
                                                 f"bits than {route}")
                    log(f"  {tag}: routes (vec, ivec) {list(copies)} give "
                        f"the same bits")
                    del copies
                    if weights is None and not torch.equal(
                            got, sequential_bag_sum(ids, table)):
                        raise AssertionError(f"{tag}: not the sequential "
                                             f"f32 fold")
                    if kind == "uniform":
                        e = bag_within(f"{tag} vs plain", got,
                                       embedding_bag_ref(ids, weights,
                                                         table))
                        err = max(err, e)
                        if name == "xdeepfm":
                            bag_within(f"{tag} vs float64", got,
                                       bag_f64(ids, weights, table))
                    lib_w = live.float() if weights is None \
                        else live.float() * weights
                    lib = F.embedding_bag(lib_ids, table, mode="sum",
                                          per_sample_weights=lib_w)
                    lib_err = bag_within(f"{tag}: F.embedding_bag vs the "
                                         f"kernel", lib, got)
                    del got, lib
                    kernel_ms = event_ms(lambda: bag_ops.embedding_bag(
                        ids, table, weights), reps, dev)
                    library_ms = event_ms(lambda: F.embedding_bag(
                        lib_ids, table, mode="sum",
                        per_sample_weights=lib_w), reps, dev)
                    plain_ms = None
                    if name == "xdeepfm" and kind == "uniform" \
                            and weights is None:
                        plain_ms = event_ms(lambda: embedding_bag_ref(
                            ids, None, table), sizes.reps, dev)
                # The bound reads each id (and weight) once, each distinct
                # row it names once and writes the output once.
                nbytes = (n * l * 4 * (1 if weights is None else 2)
                          + distinct * d * 4 + n * d * 4)
                bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
                sectors = sectors_per_row(d)
                two_sector = distinct * sectors * 32
                l2_side = int(live.sum()) * sectors * 32
                log(f"  {tag}: kernel {kernel_ms!r} ms (route (vec, ivec) "
                    f"{route}), "
                    f"library "
                    f"(F.embedding_bag, max err {lib_err!r}) "
                    f"{library_ms!r} ms"
                    + ("" if plain_ms is None else f", plain {plain_ms!r} ms")
                    + f"; bound {bound_ms!r} ms ({nbytes} B over "
                    f"{HBM_BYTES_PER_S} B/s); the distinct rows' sectors "
                    f"{two_sector!r} B ({two_sector / HBM_BYTES_PER_S * 1e3!r}"
                    f" ms), L2-side {l2_side!r} B of row sectors "
                    f"({l2_side / kernel_ms / 1e9!r} TB/s at the kernel's "
                    f"time)")
                if plain_ms is not None:
                    row = {
                        "name": "embedding_bag", "route": "cuda",
                        "source": "src/repro_torch/csrc/embedding_bag.cu",
                        "replaces":
                            "src/repro/kernels/embedding_bag/kernel.py:58",
                        "launches": launches, "max_abs_err": err,
                        "ms": kernel_ms, "kernel_ms": kernel_ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": "bytes", "library_ms": library_ms,
                    }
            del ids, w, live, lib_ids
    if row is None:
        raise AssertionError("6d: xDeepFM's uniform unweighted lookup did "
                             "not run")
    row["max_abs_err"] = err
    # The probe on xDeepFM's table: uniform, L2-resident and largest-field
    # ids.
    cfg, table = tables["xdeepfm"]
    with torch.inference_mode():
        bag_probe({"kernel": lambda i, t: bag_ops.embedding_bag(i, t)},
                  table, tuple(cfg.vocab_sizes), b, hot, reps, dev)
    return row


# ---------------------------------------------------------------------------
# Phase 7: training (the losses run the plain versions: no kernel has a
# backward), then the trained encoder served through the kernels.

class StepClock:
    """A train step timed on the host clock, the device synchronised
    before and after: ``ms`` holds each call's time."""

    def __init__(self, step, dev):
        self.step, self.dev, self.ms = step, dev, []

    def __call__(self, state, batch):
        sync(self.dev)
        t0 = time.perf_counter()
        out = self.step(state, batch)
        sync(self.dev)
        self.ms.append(1e3 * (time.perf_counter() - t0))
        return out


def counted_flops(fn) -> int:
    """The matrix-product flops ``fn()`` runs (``torch.utils.flop_counter``:
    forward and backward products alike)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def loss_and_grads(model, loss_fn, batch: dict, dev):
    """(f32 loss, {name: gradient}) of one batch at the model's weights."""
    import torch

    from repro_torch.train.train_loop import to_device

    params = dict(model.named_parameters())
    loss, _ = loss_fn(to_device(batch, dev))
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


class PinnedHead:
    """``splade_head_ref`` that records which token each max over tokens
    pools from, or, given the recorded tokens (``replay``), pools from
    those: the same function value where the two sides agree on the max
    (and within the activations' rounding where a near tie flips it), the
    gradient routed to the same token.  ``flips`` counts the maxima that
    the replaying side would have taken from another token."""

    def __init__(self):
        self.picked, self.replay, self.flips = [], None, 0

    def __call__(self, h, mask, w, b):
        import torch

        logits = torch.einsum("btd,dv->btv", h, w) + b
        acts = torch.log1p(torch.clamp_min(logits, 0.0)) * mask[..., None]
        own = acts.detach().argmax(dim=1)
        if self.replay is None:
            self.picked.append(own)
            return acts.amax(dim=1)
        idx = self.replay.pop(0).to(acts.device)
        self.flips += int((own != idx).sum())
        return acts.gather(1, idx[:, None, :])[:, 0]


def grads_within(name: str, got: dict, want: dict, tol: float) -> float:
    """Each leaf of ``got`` within ``tol`` of the same leaf's max |want|;
    the largest such relative error."""
    worst = 0.0
    for k, w in want.items():
        g = got[k].to(w.device)
        scale = float(w.abs().max())
        rel = float((g - w).abs().max()) / max(scale, 1e-30)
        worst = max(worst, rel)
        if not rel <= tol:
            raise AssertionError(f"{name}: gradient of {k} off by {rel!r} "
                                 f"of its max |g| (> {tol})")
    return worst


def step_row(name: str, ms: list, first: int, unit_count: int, unit: str,
             peak: int, flops: dict, nbytes: int) -> dict:
    """A training row: the median step of ``ms[first:]`` beside its bound,
    the larger of ``nbytes`` over HBM and the sum over dtypes of
    ``flops[dtype]`` over that dtype's peak rate."""
    import numpy as np

    rates = {"f32": F32_FLOP_PER_S, "bf16": BF16_FLOP_PER_S}
    med = float(np.median(ms[first:]))
    t_ops = sum(f / rates[t] for t, f in flops.items()) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    row = {"name": name, "ms": med, f"{unit}_per_s": unit_count / med * 1e3,
           "peak_bytes": peak, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flops": flops, "bytes": nbytes}
    log(f"  {name}: {med!r} ms a step (median of steps {first + 1}-"
        f"{len(ms)}, all {ms!r}), {row[f'{unit}_per_s']!r} {unit}/s, peak "
        f"{peak} B; bound {row['bound_ms']!r} ms ({row['bound_by']}: "
        f"{flops} flop, {nbytes} B)")
    return row


def eval_retrieval(dev, sizes: Sizes, model, pairs: dict, label: str):
    """7b: encode the eval pairs through ``splade_head`` (held to
    ``use_kernel=False`` within KERNEL_TOL), threshold at 0.01 as
    ``examples/train_splade.py`` does, search the docs with ``tiled`` and
    ``ell`` (k = ``eval_k``), hold every query's top-k to float64 (the
    returned scores and the k-th best, so a tie may go either way) -> MRR@k
    (query i's doc is doc i) and nonzeros a doc."""
    import numpy as np
    import torch

    from repro_torch.core import RetrievalConfig, RetrievalEngine
    from repro_torch.core.metrics import mrr_at_k
    from repro_torch.core.sparse import dense_to_sparse

    k = sizes.eval_k
    with torch.inference_mode():
        enc = {}
        for side in ("q", "d"):
            x = model.encode(pairs[f"{side}_tokens"], pairs[f"{side}_mask"],
                             use_kernel=True)
            compare(f"{label}: encode {side}, use_kernel=True vs False", x,
                    model.encode(pairs[f"{side}_tokens"],
                                 pairs[f"{side}_mask"], use_kernel=False))
            if bool((x < 0).any()):
                raise AssertionError(f"{label}: negative encoding")
            enc[side] = dense_to_sparse(torch.where(x > 0.01, x, 0.0),
                                        device=dev)
            if side == "d":
                nnz = float((x > 0.01).sum(dim=1).float().mean())
            del x
    n = pairs["q_tokens"].shape[0]
    oracle = oracle_f64(enc["d"], enc["q"], np.arange(n)).T  # [Bq, N]
    o_vals = torch.topk(oracle, k, dim=1).values.cpu().numpy()
    out = {}
    for name in ("tiled", "ell"):
        eng = RetrievalEngine(enc["d"], RetrievalConfig(engine=name, k=k),
                              device=dev)
        vals, ids = eng.search(enc["q"], k=k)
        at_ids = oracle.gather(1, torch.from_numpy(ids).to(dev)).cpu().numpy()
        rel = max(
            float(np.max(np.abs(vals - at_ids)
                         / np.maximum(np.abs(at_ids), 1e-30))),
            float(np.max(np.abs(vals - o_vals)
                         / np.maximum(np.abs(o_vals), 1e-30))))
        mrr = mrr_at_k(ids, [{i} for i in range(n)], k)
        log(f"  {label} -> {name}: top-{k} vs float64 max rel {rel!r}; "
            f"MRR@{k} {mrr!r}")
        if rel > SCORE_RTOL or not np.all(ids >= 0):
            raise AssertionError(f"{label} -> {name}: not exact ({rel})")
        out[name] = mrr
    if out["tiled"] != out["ell"]:
        log(f"  {label}: tiled and ell order a tie differently")
    return out["tiled"], nnz


def train_encoder(dev, sizes: Sizes) -> dict:
    """7a and 7b: the encoder of ``sizes.encoder`` (seeded weights) trained
    by ``Trainer`` on ``DeterministicPipeline`` batches of
    ``paired_batch_fn``, async checkpoints every ``checkpoint_every``
    steps; the restart from the first checkpoint against the unbroken run,
    bit for bit (both under deterministic algorithms); the loss falling on
    one repeated batch; one step's loss and gradients on the card against
    the CPU; the eval pairs served through the kernels before and after
    training.  The kernels' counters are zeroed before and read after."""
    import itertools
    import math
    import tempfile

    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import gpusparse
    from repro_torch.data.pipeline import (DeterministicPipeline,
                                           paired_batch_fn)
    from repro_torch.kernels.ell_gather import ops as ell_ops
    from repro_torch.kernels.scatter_score import ops as scatter_ops
    from repro_torch.kernels.splade_head import ops as head_ops
    from repro_torch.kernels.splade_head import splade_head_ref
    from repro_torch.models import splade as splade_module
    from repro_torch.models.splade import SpladeEncoder
    from repro_torch.runtime import FaultToleranceSupervisor
    from repro_torch.train import (AdamWConfig, Trainer, copy_state,
                                   init_state, make_train_step)
    from repro_torch.train.train_loop import to_device

    cfg = getattr(gpusparse, sizes.encoder)
    v, pairs_n, t = cfg.vocab_size, sizes.train_pairs, sizes.train_len
    make = paired_batch_fn(v, pairs_n, t)
    adamw = AdamWConfig(lr=sizes.train_lr, warmup_steps=sizes.train_warmup,
                        total_steps=sizes.train_steps)

    def encoder(seed):
        return SpladeEncoder(cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(seed))

    def trainer(model, **kw):
        step = make_train_step(lambda b: model.contrastive_loss(
            b, flops_weight=sizes.flops_weight), adamw)
        clock = StepClock(step, dev)
        state = init_state(dict(model.named_parameters()), adamw).as_dict()
        return Trainer(clock, state, **kw), clock

    model = encoder(0)
    params = dict(model.named_parameters())
    init = {k: p.detach().clone() for k, p in params.items()}
    n_params = sum(p.numel() for p in init.values())
    non_embed = n_params - cfg.vocab_size * cfg.d_model - cfg.vocab_size
    tokens = 2 * pairs_n * t
    flops = (6 * non_embed * tokens + 3 * 2 * tokens * cfg.d_model * v
             + 3 * cfg.n_layers * 4 * 2 * pairs_n * t * t * cfg.d_model)
    # The step's inputs (params and moments) read once and its outputs
    # written once: 24 B a parameter.
    nbytes = 24 * n_params
    loss_fn = lambda b: model.contrastive_loss(  # noqa: E731
        b, flops_weight=sizes.flops_weight)
    eval_pairs = to_device(paired_batch_fn(v, sizes.eval_pairs, t)(9, 0),
                           dev)
    head_ops.launches = scatter_ops.launches = ell_ops.launches = 0
    mrr0, nnz0 = eval_retrieval(dev, sizes, model, eval_pairs,
                                "before training")

    # One step's loss and gradients on the card against the CPU, at the
    # seeded weights, the CPU pooling each max from the card's token (a
    # near tie among 128 tokens, one in ~10^4 maxima, flips between two
    # orders of summation and sends that max's gradient elsewhere); the
    # step's products counted.
    small = paired_batch_fn(v, sizes.cpu_pairs, t)(0, 0)
    cpu_model = SpladeEncoder(cfg, device="cpu")
    copy_state(dict(cpu_model.named_parameters()),
               {k: p.cpu() for k, p in init.items()})
    pinned = PinnedHead()
    splade_module.splade_head_ref = pinned
    try:
        card = loss_and_grads(model, loss_fn, small, dev)
        pinned.replay = [i.cpu() for i in pinned.picked]
        t0 = time.perf_counter()
        cpu = loss_and_grads(cpu_model, lambda b: cpu_model.contrastive_loss(
            b, flops_weight=sizes.flops_weight), small, "cpu")
        cpu_s = time.perf_counter() - t0
    finally:
        splade_module.splade_head_ref = splade_head_ref
    rel_loss = abs(card[0] - cpu[0]) / abs(cpu[0])
    rel_g = grads_within("card vs CPU", card[1], cpu[1], TRAIN_GRAD_TOL)
    maxima = sum(i.numel() for i in pinned.picked)
    log(f"  one step at {sizes.cpu_pairs} pairs x {t}: card loss "
        f"{card[0]!r}, CPU {cpu[0]!r} (rel {rel_loss!r}, CPU {cpu_s:.3f} "
        f"s); gradients within {rel_g!r} of each leaf's max |g|; the CPU "
        f"alone would pool {pinned.flips} of {maxima} maxima from another "
        f"token")
    if not rel_loss <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"card vs CPU loss off by {rel_loss}")
    del cpu_model, cpu, card
    one = make(0, 0)
    counted = counted_flops(lambda: loss_and_grads(model, loss_fn, one, dev))
    log(f"  matrix-product flops of one step at {pairs_n} pairs: counted "
        f"{counted}, the bound's formula {flops} ({counted / flops!r})")

    # The loss falls over steps on one repeated batch, under deterministic
    # algorithms (at lr 2e-3 the full-width loss swings from step to step,
    # so the check is made reproducible); then the same steps in the
    # default mode, timed; each time the weights go back to the seeded ones.
    rows = {}
    for deterministic in (True, False):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.use_deterministic_algorithms(deterministic)
        try:
            tr, clock = trainer(model, data_iter=itertools.repeat(one))
            losses = [m["loss"] for m in tr.run(sizes.overfit_steps)]
        finally:
            torch.use_deterministic_algorithms(False)
        peak = torch.cuda.max_memory_allocated(dev)
        copy_state(params, init)
        mode = "deterministic" if deterministic else "default"
        log(f"  {sizes.overfit_steps} steps on one batch ({mode} "
            f"algorithms): losses {losses!r}")
        if deterministic and not losses[-1] < losses[0]:
            raise AssertionError("the loss does not fall on a repeated "
                                 "batch")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError("non-finite loss")
        rows[mode] = step_row(
            f"{cfg.name} contrastive step, one batch ({mode})", clock.ms, 2,
            pairs_n, "examples", peak, {"f32": flops}, nbytes)
        del tr, clock

    # 7a. the unbroken run, then the restart from its first checkpoint,
    # both under deterministic algorithms
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as d:
        torch.use_deterministic_algorithms(True)
        try:
            pipe = DeterministicPipeline(make, seed=0, prefetch=2)
            ck = Checkpointer(d, keep=3, async_write=True)
            tr, clock = trainer(model, data_iter=iter(pipe), checkpointer=ck,
                                checkpoint_every=sizes.checkpoint_every,
                                supervisor=FaultToleranceSupervisor())
            log_a = tr.run(sizes.train_steps)
            ck.wait()
            pipe.close()
            peak = torch.cuda.max_memory_allocated(dev)
            steps = ck.list_steps()
            log(f"  {cfg.name}: {sizes.train_steps} steps of {pairs_n} "
                f"pairs x {t} tokens; losses "
                f"{[m['loss'] for m in log_a]!r}; checkpoints {steps}")
            if steps[0] != sizes.checkpoint_every:
                raise AssertionError(f"checkpoints {steps}")
            restart = encoder(1)
            pipe = DeterministicPipeline(make, seed=0, start_step=steps[0],
                                         prefetch=2)
            tr_b, _ = trainer(restart, data_iter=iter(pipe),
                              start_step=steps[0])
            copy_state(tr_b.state, ck.load(steps[0], tr_b.state))
            log_b = tr_b.run(sizes.train_steps - steps[0])
            pipe.close()
        finally:
            torch.use_deterministic_algorithms(False)
    same = [m["loss"] for m in log_b] == [m["loss"] for m in
                                          log_a[steps[0]:]]
    for k, p in restart.named_parameters():
        same = same and torch.equal(p, params[k])
    for k in ("mu", "nu"):
        for name, m in tr_b.state["opt_state"][k].items():
            same = same and torch.equal(m, tr.state["opt_state"][k][name])
    log(f"  restart from step {steps[0]}: losses "
        f"{[m['loss'] for m in log_b]!r}; losses, parameters and moments "
        f"bit for bit the unbroken run's: {same}")
    if not same:
        raise AssertionError("the restart does not reproduce the run")
    row = step_row(f"{cfg.name} contrastive step, pipeline (deterministic)",
                   clock.ms, 2, pairs_n, "examples", peak, {"f32": flops},
                   nbytes)
    del restart, tr_b, tr, clock

    # 7b. the trained weights served through the kernels
    mrr1, nnz1 = eval_retrieval(dev, sizes, model, eval_pairs,
                                "after training")
    launches = {"splade_head": head_ops.launches,
                "scatter_score": scatter_ops.launches,
                "ell_gather": ell_ops.launches}
    log(f"  MRR@{sizes.eval_k} {mrr0!r} -> {mrr1!r}, nonzeros a doc "
        f"{nnz0!r} -> {nnz1!r}; launches on the training slice's path: "
        f"{launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched in phase 7b")
    return dict(rows=[rows["default"], rows["deterministic"], row],
                mrr=(mrr0, mrr1), nnz=(nnz0, nnz1), launches=launches)


def train_lm(dev, sizes: Sizes) -> dict:
    """7c: ``sizes.lm`` of qwen2_0_5b at full width and depth with remat,
    bf16 compute, ``lm_train_steps`` steps of ``Trainer`` on one repeated
    ``lm_batch_fn`` batch: the loss falls; then remat on and off give the
    same gradients at ``remat_layers`` layers x ``remat_len`` tokens, and
    the bound's formula is held to the counted products there."""
    import dataclasses
    import itertools

    import torch

    from repro_torch.configs import qwen2_0_5b
    from repro_torch.data.pipeline import lm_batch_fn
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.train import (AdamWConfig, Trainer, init_state,
                                   make_train_step)

    cfg = getattr(qwen2_0_5b, sizes.lm)
    if not cfg.remat:
        raise AssertionError(f"{cfg.name}: remat is off")
    d, v = cfg.d_model, cfg.vocab_size
    dh, hq = cfg.head_dim, cfg.n_heads

    def formula(c, b, s) -> dict:
        """The products of one step by dtype: the matrices' in the compute
        dtype, the plain attention's in f32 over the visible (query, key)
        pairs; the forward's recompute not counted."""
        non_embed = c.num_params() - v * d - (0 if c.tie_embeddings
                                              else v * d)
        mm = 6 * non_embed * b * s + 3 * 2 * b * s * d * v
        attn = 3 * c.n_layers * 4 * b * hq * dh * s * (s + 1) // 2
        out = {"f32": attn}
        key = "bf16" if c.compute_dtype == torch.bfloat16 else "f32"
        out[key] = out.get(key, 0) + mm
        return out

    def model(c, seed):
        return TransformerLM(c, device=dev, generator=torch.Generator(
            device=dev).manual_seed(seed))

    adamw = AdamWConfig(lr=sizes.lm_train_lr, warmup_steps=2,
                        total_steps=100)
    b, s = sizes.lm_train_batch, sizes.lm_train_len
    torch.cuda.reset_peak_memory_stats(dev)
    lm = model(cfg, 0)
    n_params = sum(p.numel() for p in lm.parameters())
    clock = StepClock(make_train_step(lm.loss_fn, adamw), dev)
    tr = Trainer(clock, init_state(dict(lm.named_parameters()),
                                   adamw).as_dict(),
                 itertools.repeat(lm_batch_fn(b, s, v)(0, 0)))
    losses = [m["loss"] for m in tr.run(sizes.lm_train_steps)]
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"  {cfg.name}: {n_params} parameters, {cfg.n_layers} layers, "
        f"remat, {cfg.dtype}; {b} x {s} tokens; losses {losses!r}")
    if not losses[-1] < losses[0]:
        raise AssertionError("the LM's loss does not fall")
    row = step_row(f"{cfg.name} next-token step (remat)", clock.ms, 1, b * s,
                   "tokens", peak, formula(cfg, b, s), 24 * n_params)
    del lm, tr, clock
    torch.cuda.empty_cache()

    small = dataclasses.replace(cfg, n_layers=sizes.remat_layers)
    lm = model(small, 1)
    batch = lm_batch_fn(1, sizes.remat_len, v)(0, 1)
    grads = {}
    for remat in (True, False):
        lm.cfg = dataclasses.replace(small, remat=remat)
        grads[remat] = loss_and_grads(lm, lm.loss_fn, batch, dev)
    same = grads[True][0] == grads[False][0] and all(
        torch.equal(g, grads[False][1][k]) for k, g in grads[True][1].items())
    counted = counted_flops(lambda: loss_and_grads(lm, lm.loss_fn, batch,
                                                   dev))
    want = sum(formula(small, 1, sizes.remat_len).values())
    log(f"  remat on vs off at {sizes.remat_layers} layers x "
        f"{sizes.remat_len}: loss {grads[True][0]!r} vs {grads[False][0]!r},"
        f" gradients bit for bit equal: {same}; products counted {counted},"
        f" the bound's formula {want} ({counted / want!r})")
    if not same:
        raise AssertionError("remat changes the LM's gradients")
    return dict(rows=[row], losses=losses)


def train_recsys(dev, sizes: Sizes) -> dict:
    """7d: each of ``sizes.recsys_models`` at ``recsys_config`` (seeded
    weights) for ``recsys_train_steps`` steps of ``Trainer`` on one
    repeated ``make_recsys_batch`` batch of ``recsys_train_batch`` examples
    with bags of ``recsys_train_hot``: the loss falls."""
    import importlib
    import itertools

    import torch

    from repro_torch.data.synthetic import make_recsys_batch
    from repro_torch.models.recsys import build_model
    from repro_torch.train import (AdamWConfig, Trainer, init_state,
                                   make_train_step)

    rows = []
    b = sizes.recsys_train_batch
    # lr 1e-4: at 1e-3 xDeepFM's first step (about lr x sign(g) on every
    # CIN filter) throws its loss up tenfold.
    adamw = AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=100)
    for name in sizes.recsys_models:
        cfg = getattr(importlib.import_module(f"repro_torch.configs.{name}"),
                      sizes.recsys_config)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        model = build_model(cfg, device=dev, seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        batch = make_recsys_batch(b, cfg.n_sparse, cfg.vocab_sizes,
                                  cfg.seq_len, cfg.item_vocab,
                                  multi_hot=sizes.recsys_train_hot, seed=0)
        clock = StepClock(make_train_step(model.loss_fn, adamw), dev)
        tr = Trainer(clock, init_state(dict(model.named_parameters()),
                                       adamw).as_dict(),
                     itertools.repeat(batch))
        losses = [m["loss"] for m in tr.run(sizes.recsys_train_steps)]
        peak = torch.cuda.max_memory_allocated(dev)
        log(f"  {cfg.name}: {n_params} parameters; B = {b}, H = "
            f"{sizes.recsys_train_hot}; losses {losses!r}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{cfg.name}: the loss does not fall")
        flops = counted_flops(lambda: loss_and_grads(model, model.loss_fn,
                                                     batch, dev))
        in_bytes = sum(v.nbytes for v in batch.values())
        # The step reads the batch, the params and moments once and writes
        # the params and moments once: 24 B a parameter.
        rows.append(step_row(f"{cfg.name} BCE step", clock.ms, 1, b,
                             "examples", peak, {"f32": flops},
                             24 * n_params + in_bytes))
        del model, tr, clock
    return dict(rows=rows)


def same_results(name: str, got, want, rtol: float = SCORE_RTOL) -> dict:
    """Two numpy top-k results (values, ids) of one query batch, tie-aware:
    the same infinities, finite values within ``rtol`` relative, and at
    each run of values within ``rtol`` of each other that ends before the
    cut the same set of ids (the run that reaches the k-th slot may go on
    past the cut, where either side may keep any of its docs).  Returns
    the max relative value error, whether the two are bitwise equal and
    the share of ranks with the same id."""
    import numpy as np

    (gv, gi), (wv, wi) = got, want
    if gv.shape != wv.shape:
        raise AssertionError(f"{name}: shape {gv.shape} vs {wv.shape}")
    fin = np.isfinite(wv)
    if not np.array_equal(fin, np.isfinite(gv)) or not np.array_equal(
            gv[~fin], wv[~fin]):
        raise AssertionError(f"{name}: infinities differ")
    rel = float(np.max(np.abs(gv[fin] - wv[fin])
                       / np.maximum(np.abs(wv[fin]), 1e-30))) \
        if fin.any() else 0.0
    if rel > rtol:
        raise AssertionError(f"{name}: values differ (rel {rel!r})")
    k = wv.shape[1]
    for row in np.nonzero((gi != wi).any(axis=1))[0]:
        v = wv[row]
        with np.errstate(invalid="ignore"):
            same = (v[1:] == v[:-1]) | (np.abs(v[1:] - v[:-1])
                                        <= rtol * np.abs(v[1:]))
        starts = np.concatenate([[0], np.nonzero(~same)[0] + 1])
        ends = np.concatenate([starts[1:], [k]])
        for s, e in zip(starts, ends):
            if e < k and set(gi[row, s:e]) != set(wi[row, s:e]):
                raise AssertionError(f"{name}: row {row} ranks {s}-{e} "
                                     "hold other docs")
    bitwise = bool(np.array_equal(gv, wv) and np.array_equal(gi, wi))
    share = float((gi == wi).mean())
    log(f"  {name}: max rel {rel!r}, bitwise {bitwise}, same id at "
        f"{share!r} of ranks")
    return dict(rel=rel, bitwise=bitwise, same_ids=share)


def timed(name: str, fn, dev):
    """One call of ``fn`` on the synchronised host clock -> (result, ms)."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    ms = 1e3 * (time.perf_counter() - t0)
    log(f"  {name}: {ms!r} ms")
    return out, ms


def segments(batch, sizes: Sizes):
    """``sizes.state_segments`` pieces of a corpus, each a whole number of
    ``sizes.state_segment_docs`` but the last."""
    n, step = batch.batch, sizes.state_segment_docs
    cuts = [min(i * step, n) for i in range(sizes.state_segments)] + [n]
    return [batch.slice_rows(a, b - a) for a, b in zip(cuts, cuts[1:])]


def subset(batch, keep):
    import torch

    from repro_torch.core import SparseBatch

    sel = torch.from_numpy(keep).to(batch.device)
    return SparseBatch(batch.term_ids[sel], batch.values[sel],
                       batch.vocab_size)


def serve_state(dev, sizes: Sizes) -> dict:
    """Phase 8: the serving state at serve_1m — ``Retriever`` grown by
    ``add_docs``, deletions and compaction, a ``SearchSession``, the
    ``QueryScheduler`` and the segment store with its pager — each checked
    against the stateless engine it must equal."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch import obs as obs_mod
    from repro_torch.core import RetrievalConfig, RetrievalEngine, Retriever
    from repro_torch.core import scoring
    from repro_torch.data.synthetic import (
        make_msmarco_like, make_topical_corpus,
    )
    from repro_torch.sched import QueryScheduler
    from repro_torch.store import SegmentStore, SegmentWriter

    out = {}
    k = sizes.k
    corpus = make_msmarco_like(sizes.docs, sizes.queries,
                               vocab_size=sizes.vocab, seed=0, device=dev)
    g = torch.Generator().manual_seed(5)
    sample = torch.randperm(sizes.queries, generator=g)[
        :sizes.oracle_queries].sort().values.numpy()
    oracle = oracle_f64(corpus.docs, corpus.queries, sample)
    pieces = segments(corpus.docs, sizes)
    log(f"  8a: segments of {[p.batch for p in pieces]} docs")

    # 8a. grown vs cold, tiled and ell
    resident = None
    for name in ("tiled", "ell"):
        cfg = RetrievalConfig(engine=name, k=k)
        grown = Retriever(pieces[0], cfg, device=dev)
        for p in pieces[1:]:
            grown.add_docs(p)
        cold = RetrievalEngine(corpus.docs, cfg, device=dev)
        got, ms = host_rounds(f"8a {name}: Retriever.search, "
                              f"{grown.version} segments",
                              lambda: grown.search(corpus.queries),
                              sizes.state_rounds, dev, sizes.queries)
        want = cold.search(corpus.queries)
        out[f"8a {name}"] = dict(ms=ms, **same_results(
            f"8a {name}: grown vs one engine", got, want))
        check_exact(f"8a {name} grown", got[0], got[1], oracle, sample, k)
        if name == "tiled":
            resident = grown
            # A fenced span around one scatter_score call covers the
            # kernel: at least its CUDA-event time.
            obs = obs_mod.Obs()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            q = corpus.queries.to(dev)
            scoring.score_tiled(q, cold._index)
            sync(dev)
            with obs.span("kernel") as sp:
                start.record()
                scores = scoring.score_tiled(q, cold._index)
                end.record()
                obs_mod.fence(scores)
            ev_ms = start.elapsed_time(end)
            log(f"  8a fence: span {sp.duration * 1e3!r} ms around one "
                f"scatter_score call of {ev_ms!r} ms (CUDA events)")
            if sp.duration * 1e3 < ev_ms:
                raise AssertionError("a fenced span is shorter than the "
                                     "kernel it covers")
            out["fence"] = dict(span_ms=sp.duration * 1e3, event_ms=ev_ms)
            del scores
            # 8d's direct search and the obs on/off times reuse cold
            rounds = []
            for obs_on in (True, False, False, True):
                cold.config.obs = obs_mod.Obs() if obs_on else None
                rounds.append((obs_on, host_rounds(
                    f"8d tiled search, obs {'Obs()' if obs_on else 'None'}",
                    lambda: cold.search(corpus.queries), sizes.rounds, dev,
                    sizes.queries)[1]))
            on = [ms for o, ms in rounds if o]
            off = [ms for o, ms in rounds if not o]
            out["obs"] = dict(on_ms=on, off_ms=off)
            log(f"  8d: tiled search with Obs() {on!r} ms, obs=None "
                f"{off!r} ms (turns on, off, off, on)")
        del grown, cold, got, want
        torch.cuda.empty_cache()

    # 8d. the scheduler: 4 replays of the 500 queries as 2,000 streams
    sched = QueryScheduler(resident, k=k, capacity=sizes.sched_replays
                           * sizes.queries, max_batch=sizes.sched_batch,
                           device=dev)
    direct = resident.search(corpus.queries)
    qi = corpus.queries.term_ids.cpu().numpy()
    qv = corpus.queries.values.cpu().numpy()
    t0 = time.perf_counter()
    now = sched.clock()
    for r in range(sizes.sched_replays):
        for i in range(sizes.queries):
            sched.submit((r, i), qi[i], qv[i],
                         deadline=now + sizes.sched_deadline_s)
    results = sched.drain()
    secs = time.perf_counter() - t0
    n = len(results)
    if n != sizes.sched_replays * sizes.queries:
        raise AssertionError(f"8d: {n} results")
    vals = np.stack([x.values for x in results])
    ids = np.stack([x.ids for x in results])
    rows = np.array([x.query_id[1] for x in results])
    out["8d"] = same_results("8d: each queued result vs direct search",
                             (vals, ids), (direct[0][rows], direct[1][rows]))
    snap = sched.obs_snapshot()
    e2e = snap.histograms["sched.e2e_latency_s"]
    misses = int(snap.counters.get("sched.deadline_miss_total", 0))
    out["8d"].update(qps=n / secs, p50_s=e2e["p50"], p99_s=e2e["p99"],
                     deadline_misses=misses,
                     batches=int(snap.counters["sched.batches_total"]))
    log(f"  8d: {n} requests in {secs!r} s: {n / secs!r} QPS, "
        f"{out['8d']['batches']} micro-batches of <= {sizes.sched_batch}, "
        f"e2e p50 {e2e['p50']!r} s, p99 {e2e['p99']!r} s, deadline "
        f"misses {misses} (deadline {sizes.sched_deadline_s} s after "
        "submission)")
    del sched, results, direct

    # 8e. the store: write the corpus, page it back in
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as d:
        path = os.path.join(d, "store")
        cfg = RetrievalConfig(engine="tiled", k=k)
        t0 = time.perf_counter()
        w = SegmentWriter(path, cfg, segment_docs=sizes.state_segment_docs,
                          device=dev)
        for p in pieces:
            w.add_docs(p)
        w.finalize()
        write_s = time.perf_counter() - t0
        disk = sum(h.mapped_bytes() for h in SegmentStore.open(path).segments)
        log(f"  8e: SegmentWriter wrote {w.segments_written} segments, "
            f"{disk} B, in {write_s!r} s")
        want = resident.search(corpus.queries, return_tau=False)
        dev_bytes = resident.index_bytes()
        for label, budget in (("no budget", None),
                              ("half the device bytes", dev_bytes // 2)):
            t0 = time.perf_counter()
            paged = Retriever.from_store(path, device_budget_bytes=budget,
                                         device=dev)
            open_s = time.perf_counter() - t0
            got, ms = timed(f"8e {label}: first paged search",
                            lambda: paged.search(corpus.queries), dev)
            st = paged.pager_stats()
            again, ms2 = timed(f"8e {label}: second search",
                               lambda: paged.search(corpus.queries), dev)
            st2 = paged.pager_stats()
            res = same_results(f"8e {label}: paged vs resident", got, want)
            same_results(f"8e {label}: second search", again, want)
            if not res["bitwise"]:
                raise AssertionError("8e: the paged index does not give the "
                                     "resident bits")
            gbs = st["bytes_loaded"] / (ms * 1e-3) / 1e9
            out[f"8e {label}"] = dict(open_s=open_s, ms=ms, ms_again=ms2,
                                      h2d_gbs=gbs, stats=st2)
            log(f"  8e {label}: open {open_s!r} s; first search pager "
                f"{st}; effective H2D {gbs!r} GB/s of the search's time; "
                f"after the second {st2}")
            if budget is not None and st2["resident_bytes"] > max(
                    budget, max(s.index_bytes() for s in resident._segments)):
                raise AssertionError("8e: the pager overran its budget")
            del paged, got, again
        out["8e write"] = dict(write_s=write_s, disk_bytes=disk)
    del resident, corpus, pieces, oracle
    torch.cuda.empty_cache()

    # 8b and 8c on the topical corpus
    topical = make_topical_corpus(sizes.docs, sizes.queries,
                                  vocab_size=sizes.vocab, seed=0, device=dev)
    tq = topical.queries
    rng = np.random.default_rng(8)
    dead = np.sort(rng.choice(sizes.docs, int(sizes.docs
                                              * sizes.delete_share),
                              replace=False))
    survivors = np.setdiff1d(np.arange(sizes.docs), dead)
    base = dict(reorder_docs=True, reorder_method="df-signature")
    for name in ("tiled", "tiled-bmp-fused"):
        cfg = RetrievalConfig(engine=name, k=k, **base)
        r = Retriever(device=dev, config=cfg)
        for p in segments(topical.docs, sizes):
            r.add_docs(p)
        newly, del_ms = timed(f"8b {name}: delete_docs of {len(dead)}",
                              lambda: r.delete_docs(dead), dev)
        got, ms = timed(f"8b {name}: search after the deletes",
                        lambda: r.search(tq), dev)
        if np.isin(got[1], dead).any():
            raise AssertionError("8b: a deleted doc was served")
        rebuilt = RetrievalEngine(subset(topical.docs, survivors), cfg,
                                  device=dev)
        (rv, ri), rms = timed(f"8b {name}: search of a rebuild on the "
                              "survivors", lambda: rebuilt.search(tq), dev)
        del rebuilt
        ri = np.where(ri >= 0, survivors[np.clip(ri, 0, None)], -1)
        res = same_results(f"8b {name}: deleted vs rebuilt on survivors",
                           got, (rv, ri))
        rows = {}
        for thr in (sizes.compact_threshold, sizes.delete_share / 2):
            n_c, c_ms = timed(f"8b {name}: compact({thr})",
                              lambda: r.compact(thr), dev)
            after, a_ms = timed(f"8b {name}: search after compact({thr}), "
                                f"{n_c} segments rebuilt",
                                lambda: r.search(tq), dev)
            rows[thr] = dict(rebuilt=n_c, compact_ms=c_ms, search_ms=a_ms,
                             **same_results(f"8b {name}: after compact("
                                            f"{thr}) vs before", after, got))
        out[f"8b {name}"] = dict(delete_ms=del_ms, search_ms=ms,
                                 rebuild_search_ms=rms, compact=rows, **res)
        del r
        torch.cuda.empty_cache()

    # 8c. a session on tiled-bmp-fused, doc_block 64, k = 10
    cfg = RetrievalConfig(engine="tiled-bmp-fused", k=sizes.small_k,
                          doc_block=sizes.small_doc_block, **base)
    r = Retriever(topical.docs, cfg, device=dev)
    s = r.open_session(k=sizes.small_k)
    cold, cold_ms = timed("8c cold session search", lambda: s.search(tq),
                          dev)
    warm, warm_ms = timed("8c warm search (every stream cached)",
                          lambda: s.search(tq), dev)
    if not (np.array_equal(cold[0], warm[0])
            and np.array_equal(cold[1], warm[1])):
        raise AssertionError("8c: warm != cold")
    extra = make_topical_corpus(sizes.session_extra_docs, 1,
                                vocab_size=sizes.vocab, seed=1,
                                device=dev).docs
    tau = np.array([s.cached_tau(i) for i in range(sizes.queries)],
                   np.float32)
    r.add_docs(extra)
    # every stream's entry is usable after an append; the share whose
    # cached tau is finite warm-starts the new segment's sweep
    hit = float(np.mean([s.cached_tau(i) is not None
                         for i in range(sizes.queries)]))
    finite = float(np.isfinite(tau).mean())
    grown, grown_ms = timed(f"8c warm search after add_docs of "
                            f"{extra.batch} docs", lambda: s.search(tq), dev)
    fresh, fresh_ms = timed("8c cold session over the grown index",
                            lambda: r.open_session(k=sizes.small_k).search(
                                tq), dev)
    res = same_results("8c warm after add_docs vs cold", grown, fresh)
    if not res["bitwise"]:
        raise AssertionError("8c: the warm session is not the cold one's "
                             "bits")
    # blocks the new segment's sweep skips from the cached tau, and cold
    seg = r._segments[-1].engine
    from repro_torch.kernels.bmp_scan import ops as bmp_ops
    skips = {}
    for label, t0_ in (("cold", None), ("warm", tau)):
        _, st = bmp_ops.bmp_scan(tq.to(dev), seg._index, sizes.small_k,
                                 tau_init=t0_, return_stats=True)
        skips[label] = 1.0 - st.blocks_scored_union / st.num_doc_blocks
    full = r.prune_stats(tq, k=sizes.small_k)
    log(f"  8c: share of streams with a usable cached entry {hit!r}, "
        f"with a finite cached tau {finite!r}; new "
        f"segment's blocks skipped {skips['warm']!r} warm vs "
        f"{skips['cold']!r} cold; a cold sweep of both segments skips "
        f"{full.block_skip_frac!r} of {full.num_doc_blocks} blocks")
    out["8c"] = dict(cold_ms=cold_ms, warm_ms=warm_ms, grown_ms=grown_ms,
                     fresh_ms=fresh_ms, cache_hit=hit, finite_tau=finite,
                     skip=skips,
                     full_skip=full.block_skip_frac, **res)
    return out


def run(dev, sizes: Sizes) -> list[dict]:
    import numpy as np
    import torch

    from repro_torch.core import RetrievalConfig, RetrievalEngine
    from repro_torch.core.topk import topk_two_stage
    from repro_torch.data.synthetic import make_msmarco_like
    from repro_torch.kernels import build
    from repro_torch.kernels.bmp_scan import ops as bmp_ops
    from repro_torch.kernels.ell_gather import ops as ell_ops
    from repro_torch.kernels.ell_gather.ref import ell_gather_ref
    from repro_torch.kernels.query_tiles import pack_query_tiles
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
    # The tensor-core routes show in the compiled code.
    for name, op in TENSOR_CORE_OPS.items():
        n = build.sass_count(name, op)
        log(f"  {name}: {op} instructions in the library: "
            f"{'not measured (no cuobjdump)' if n is None else n}")
        if n == 0:
            raise AssertionError(f"{name}: no {op} in the compiled code")

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
            # the index stream: each live posting's term, doc and value
            # (the old yardstick: every slot of every chunk); then each
            # chunk's term block, the runs, QW and the scores
            stream=int((tiled.local_doc >= 0).sum()) * 12,
            padded_stream=tiled.num_chunks * tiled.chunk_size * 12,
            rest=(tiled.num_chunks * 4 + tiled.num_doc_blocks * 8
                  + b * qw_t.shape[1] * 4 + b * tiled.padded_docs * 4),
            source="src/repro_torch/csrc/scatter_score.cu",
            replaces="src/repro/kernels/scatter_score/kernel.py:98",
        ),
        "ell_gather": dict(
            kernel=lambda: ell_ops.ell_gather(qw, ell.terms, ell.values),
            plain=lambda: ell_gather_ref(qw, ell.terms, ell.values),
            # the index stream: every slot's term id (padding is found by
            # reading it) and the live slots' values (the old yardstick:
            # every slot's value too); then QW and the scores
            stream=(ell.terms.numel() * 4
                    + int((ell.terms < sizes.vocab).sum()) * 4),
            padded_stream=ell.terms.numel() * 8,
            rest=b * sizes.vocab * 4 + b * ell.terms.shape[0] * 4,
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
    # The work these inputs need: 2 flop a nonzero product (a posting of a
    # term against each query holding that term).  The old yardstick
    # counted every posting against every query.
    counts = query_counts(corpus.docs, qw, sizes.vocab, tiled.term_block)
    log(f"  query counts at serve_1m: {json.dumps(counts)}")
    flops = 2.0 * counts["nonzero_products"]
    log(f"  operations: {flops!r} flop (2 x nonzero products); old "
        f"yardstick 2 x postings x B = {2.0 * nnz * b!r} flop, "
        f"{2.0 * nnz * b / F32_FLOP_PER_S * 1e3!r} ms at 67 TFLOP/s")
    for name, q in (("scatter_score", qw_t), ("ell_gather", qw)):
        pack_ms = event_ms(lambda: pack_query_tiles(q), sizes.reps, dev)
        log(f"  {name}: packing the query tiles {pack_ms!r} ms (inside "
            f"the kernel's time below)")
    bounds_ms = event_ms(lambda: scatter_ops.chunk_doc_bounds(
        tiled.local_doc, tiled.doc_block), sizes.reps, dev)
    log(f"  scatter_score: each warp's slots of each chunk "
        f"(chunk_doc_bounds) {bounds_ms!r} ms (inside its time below)")
    dense_routes(dev, sizes, enc_run["queries"], tiled, ell)
    rows = []
    for name, s in specs.items():
        kernel_ms = event_ms(s["kernel"], sizes.reps, dev)
        plain_ms = event_ms(s["plain"], max(1, sizes.reps // 2), dev)
        nbytes = s["stream"] + s["rest"]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        old_bytes = s["padded_stream"] + s["rest"]
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
            f"({row['bound_by']}: {nbytes} B, {flops!r} flop); old "
            f"yardstick, the padded index stream: {old_bytes} B, "
            f"{old_bytes / HBM_BYTES_PER_S * 1e3!r} ms")
        rows.append(row)
    rows.append(bmp_row(dev, sizes, pruned, errs["bmp_scan"]))
    rows.append(head_row(dev, sizes, enc_run, errs["splade_head"]))
    log(f"peak device memory since phase 3b's last case: "
        f"{torch.cuda.max_memory_allocated(dev)} B")

    # 5. LM serving; the earlier phases' corpora, indices and encoder go
    # (eng and q: the loops' last engine and query weights)
    del corpus, engines, eng, results, pruned, enc_run, tiled, ell, qw_t, \
        qw, q
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

    # 7. training; phase 6's models are gone
    torch.cuda.empty_cache()
    log(f"device memory held before phase 7: "
        f"{torch.cuda.memory_allocated(dev)} B")
    t0 = time.perf_counter()
    log(f"phase 7a: train {sizes.encoder} of repro_torch.configs.gpusparse, "
        f"{sizes.train_steps} steps of {sizes.train_pairs} pairs x "
        f"{sizes.train_len} tokens; 7b: serve {sizes.eval_pairs} pairs "
        f"before and after")
    training = train_encoder(dev, sizes)["rows"]
    torch.cuda.empty_cache()
    log(f"phase 7c: train {sizes.lm} of repro_torch.configs.qwen2_0_5b, "
        f"{sizes.lm_train_batch} x {sizes.lm_train_len} tokens")
    training += train_lm(dev, sizes)["rows"]
    torch.cuda.empty_cache()
    log(f"phase 7d: train {sizes.recsys_config} of "
        f"{', '.join(sizes.recsys_models)} at B = {sizes.recsys_train_batch}")
    training += train_recsys(dev, sizes)["rows"]
    log(f"phase 7: {time.perf_counter() - t0:.3f} s")
    print(json.dumps({"training": training}))

    # 8. serving state; phase 7's models are gone
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"phase 8: serving state at serve_1m: Retriever, deletions, "
        f"SearchSession, QueryScheduler, the store; {sizes.docs} docs x "
        f"{sizes.queries} queries, k={sizes.k}")
    counters = {"scatter_score": scatter_ops, "ell_gather": ell_ops,
                "bmp_scan": bmp_ops}
    for mod in counters.values():
        mod.launches = 0
    state = serve_state(dev, sizes)
    state_launches = {name: mod.launches for name, mod in counters.items()}
    log(f"  launches in phase 8: {state_launches}")
    for name, n in state_launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched in phase 8")
    log(f"phase 8: {time.perf_counter() - t0:.3f} s")
    print(json.dumps({"serving_state": state}, default=float))
    return rows


def main() -> int:
    # Phase 7's restart check runs under deterministic algorithms, which
    # need cuBLAS's workspace fixed before CUDA starts.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
