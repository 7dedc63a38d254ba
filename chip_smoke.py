#!/usr/bin/env python3
"""Drive the PyTorch port's exact and pruned paths, SPLADE query encoding
in front of the exact one, LM serving (prefill and decode), recsys
serving (DIN, DIEN, AutoInt, xDeepFM), training (the encoder, the LM and
the recsys models), the serving state (sessions, deletions, the
scheduler, the segment store), sharded serving with its serve driver,
the paper's system comparison (the ``bcoo`` and ``segment`` engines, the
WAND/BMW and Seismic CPU baselines), every LM architecture of the
registry (mixture-of-experts layers, the training driver, data-parallel
training), SchNet with the cell layer's dry run, tensor- and
expert-parallel serving under the sharding policy, and training under
it, on one NVIDIA H100.

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
2c. The bf16 routes at phase 2's sizes: ``scatter_score`` and
   ``ell_gather`` bitwise their f32 routes on the bf16-rounded inputs,
   rounded once, within one bf16 ulp of the largest score of their plain
   versions (BF16_KERNEL_TOL), twice bitwise equal, on sparse and dense
   query tiles; ``bmp_scan`` on phase 2b's corpus, flat (wide route) and
   the planner's groups (small route), against its plain version the same
   way with fetch sets and steps equal, each scored block of a launch's
   first group bitwise ``scatter_score``'s bf16 route.
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
   same scores (``torch.sparse.mm`` of the docs as CSR by a row-major
   QW^T, the ``bcoo`` engine's product; the strided QW.T of earlier runs
   printed beside it), and the
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
   unread; no library call.  The bf16 routes of the three at the same
   shapes, each held to its plain version (one bf16 ulp), timed beside
   its plain version, the library call in bf16 where PyTorch takes it
   (bf16 CSR by a bf16 QW^T) and the bound of its bf16 bytes: the
   ``bf16`` sub-row of each kernel's row.
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

9. Sharded serving at serve_1m, world size 1, with phase 8's data freed
   (the three retrieval kernels' counters zeroed before and read after;
   each must be launched).  9a: ``make_serve_step`` of each engine over a
   one-shard index from ``build_sharded_ell``/``build_sharded_tiled``
   (``build_sharded_tiled``'s geometry: doc_block 64, chunk 128): ``ell`` and
   ``tiled`` on phase 3's corpus, ``tiled-pruned`` (BMP sweep and
   two-pass), ``tiled-pruned-approx`` (theta 1), ``tiled-bmp-grouped``
   and ``tiled-bmp-fused`` on phase 3b's topical corpus reordered by
   ``df-signature``; each held to the single-index ``RetrievalEngine`` of
   the same engine at that geometry (ids tie-aware, values within 1e-6
   relative, tau equal) and to float64 as in phase 3; ms a step beside
   the engine's ms a search.  Each engine's step again with
   ``compute_dtype=torch.bfloat16``: its ms and kernel ms a step beside
   the f32 step's (CUDA events around each kernel entry), overlap@1000
   with float64 >= BF16_OVERLAP_MIN and scores within BF16_RTOL of it; the
   bf16 ``ell`` and ``tiled`` steps within one bf16 ulp of each other, the
   exact pruned steps the bf16 ``tiled`` step's bits on the topical
   corpus; the index cast once (``distributed.cast_bytes``); each
   kernel's bf16 route launched.  9b: ``ell`` and ``tiled-bmp-fused`` under
   an NCCL process group of one (``tcp://127.0.0.1``) give 9a's bits.
   9c: ``repro_torch.launch.serve.main`` at ``--docs 1000000 --batch 500
   --vocab 30522 --k 1000`` for ``--engine ell``, ``--engine
   tiled-bmp-fused`` and ``--sched --max-batch 128``: ms a batch, us a
   query, and the full batch's overlap with the float64 top-k (``ell``
   1.0000 as printed, the others at least 0.999).  A ``{"sharded":
   {...}}`` line holds the numbers.
9d. serve_8m (``src/repro_torch/configs/gpusparse.py:58``: 8,841,823
   docs, B = 500, k = 1000) on one card, with phase 9's data freed (the
   counters zeroed before and read after; ``ell_gather`` must be
   launched): the corpus made on the card, the one-shard ELL index, the
   corpus freed; the ``ell`` step in f32 and bf16, a warm-up and 5 calls
   timed with CUDA events (median), ``ell_gather`` alone beside its bound
   (that dtype's bytes) and HBM share, the f32 step exact against float64
   on 16 queries as phase 3, the bf16 step's overlap with float64, peak
   device memory.  A ``{"serve_8m": {...}}`` line holds the numbers.

10. The paper's system comparison, with phase 9's data freed (the
   counters of ``scatter_score``, ``ell_gather`` and the ``segment``
   engine's ``index_add_`` calls zeroed before and read after; each must
   be launched).  The host baselines start first in worker processes
   (``host_baseline``; pure Python, one core each) and run while the card
   works.  10a: serve_1m as in phase 3, ``bcoo`` (the docs as CSR times
   QW^T, ``torch.sparse.mm``) and ``segment`` (a ``FlatIndex`` and one
   ``index_add_`` a query term) beside ``tiled`` and ``ell`` through
   ``RetrievalEngine.search``: ms a search (median of 5, of 3 for an
   engine whose first search took over 1 s), float64 exactness as in phase
   3, the ids against ``tiled``'s tie-aware, ``segment``'s launches a
   search and its ratios to ``tiled`` and ``ell`` (the paper: 23-270x),
   the ``FlatIndex``'s build seconds, slots, eps_pad (Eq. 3) and bytes
   beside the tiled and ELL indices', and each search's peak device
   memory.  ``dense`` stays out: its [1M, V] f32 doc matrix is 122 GB.
   10b: the paper's Table 2 at its own size (4,000 docs, 64 queries, V =
   4,096, k = 100, ``make_msmarco_like`` seed 0): ``dense``, ``bcoo``,
   ``segment``, ``tiled`` and ``ell`` on the card against float64, the
   exhaustive oracle, WAND and BMW on the host against float64
   (tie-aware), Seismic at query_cut 5, 10 and 50 (overlap@100 and
   MRR@10, the overlap non-decreasing in the cut); µs a query each and
   the host CPU's name.  10c: WAND and BMW at serve_100k (k = 1000) on 3
   and 1 queries, held to the exhaustive oracle: ms a query on the host.
   A ``{"comparison": {...}}`` line holds the numbers.

11. Every LM architecture of ``repro_torch.configs`` at its published
   widths (seeded weights, f32 parameters, bf16 compute), with phase 10's
   data freed; each prefill a warm-up and 3 rounds, ``flash_attention``'s
   counter zeroed before and read after (one launch a layer), the kernel
   at layer 0's own q, k, v against its plain version, timed beside its
   plain version, one ``scaled_dot_product_attention`` call and its bound
   (as phase 5), and the whole prefill against the plain path in bf16
   (within ARCH_BF16_DRIFTS of the plain path's own bf16-vs-f32 drift;
   phase 5's one-drift bar printed) and f32 (phase 5's PREFILL_F32_RTOL,
   held for the dense arch).  11a: ``olmoe-1b-7b`` at full width and depth
   (16 layers, 64 experts, top-8; 6.92 B parameters), prefill 4 x 2,048
   (``prefill_32k`` cut to that), 8 decode steps of 32 sequences from
   2,048 cached positions with the (token, slot) entries dropped at
   capacity counted, and layer 0's ``moe_block`` on 256 tokens on the card
   against the CPU in f32 (MOE_CPU_TOL; expert ids and drops equal).
   11b: ``mixtral-8x22b`` at full width, **56 -> 2 layers** (~10 GB of f32
   a layer: the model does not fit one card), prefill 1 x 8,192 under its
   4,096-token window.  11c: ``qwen3-4b`` at full width and depth (Dh 128,
   qk_norm), prefill 1 x 4,096.  11d: ``repro_torch.launch.train.main``
   (``smollm-135m``, full width, its default 8 x 64 tokens, 6 steps, a
   checkpoint every 3) under deterministic algorithms, then its later
   checkpoint removed and a restart: the restarted steps' losses bit for
   bit the unbroken run's; one ``olmoe-1b-7b`` step at full width and 2
   layers x 2,048 tokens (ce + aux); ``make_ddp_train_step`` under an NCCL
   group of one, bit for bit ``make_train_step`` (losses and parameters),
   and compressed (its loss and error buffer).  A ``{"lm_archs": {...}}``
   line holds the numbers.

12. SchNet (``repro_torch.models.schnet``) at FULL width (d 64, 300 RBFs,
   3 interactions; seeded weights, f32, TF32 off, not under deterministic
   algorithms: ``index_add_`` accumulates with atomics), with phase 11's
   data freed; no kernel lies on its path (the counters, zeroed before,
   must stay 0).  12a, each of GNN_SHAPES' cells but one, built by the
   cell layer (``launch.cells.make_cell`` on the card: seeded weights,
   ``gnn_batch``'s graph), a warm-up and 10 steps of the cell's
   ``make_train_step`` timed with CUDA events (ms a step, the median;
   ``max_memory_allocated``; model FLOPs over the step against 66.9
   TFLOP/s; the dry run's estimated peak and bound beside them):
   ``full_graph_sm`` (2,708 nodes, 10,556 edges, 1,433 features; one
   step's loss within TRAIN_LOSS_RTOL and gradients within TRAIN_GRAD_TOL
   of the CPU's), ``minibatch_lg`` (a Reddit-size CSR of 232,965 nodes and
   114,615,892 edges made on the host, ``sample_neighbors`` from 1,024
   seeds at fanout (15, 10), padded to the cell's 169,984 nodes and
   168,960 edges, 602 features; the forward within 1e-5 of the CPU's) and
   ``molecule`` (128 x 30 nodes x 64 edges).  ``ogb_products`` is not run:
   its [E, 300] RBFs alone are 74.2 GB, and the dry run must say it does
   not fit.  12b, after 12a, in worker processes: the ``meta`` dry run of
   every cell of ``launch.cells.all_cells()`` at ``"single"`` (counted and
   analytic FLOPs, useful ratio, bytes, estimated peak, fit, dominant
   term, bound ms), printed as a table; every cell must count.  A
   ``{"schnet": {...}}`` line holds the numbers.

13. Tensor and expert parallelism (``repro_torch.sharding``), with phase
   12's data freed.  First, which collectives gloo takes CUDA tensors for
   (each tried on a group of one).  13a: ``qwen3-4b`` at full width and
   depth, prefill 1 x 4,096 in bf16 under the policy of a 1 x 1 mesh over
   an NCCL group of one: logits bit for bit the unsharded model's, 36
   ``flash_attention`` launches.  13b: the single-rank run of the cases
   below on the card, then two processes on card 0 over gloo with CUDA
   tensors (spawned without ``CUBLAS_WORKSPACE_CONFIG``), mesh 1 x 2, each
   holding its shards of the same seeded weights: ``qwen3-4b`` prefill 1 x
   4,096 and 8 decode steps of 8 sequences from 4,096 seeded cache slots
   (bf16 within ARCH_BF16_DRIFTS of the single run's own bf16-vs-f32
   drift, f32 prefill within PREFILL_F32_RTOL; 36 launches a prefill on
   16 q / 4 kv heads a rank), ``smollm-135m`` in f32 (9 q / 3 kv heads:
   every head from gathered weights, the cache split by sequence; within
   TP_SEQ_RTOL), ``olmoe-1b-7b`` prefill 4 x 2,048 under TP inside the
   experts and under EP (within the bf16 bar; expert ids and drops equal
   on the ranks, their share off the single run printed; layer 0's
   experts on 256 seeded tokens in f32: ids and drops the single run's,
   the output within MOE_CPU_TOL),
   xDeepFM and AutoInt at serve_p99 (B = 512, H = 1 and 8) with their
   tables row-sharded (each rank's rows within RECSYS_TOL; one
   ``embedding_bag`` launch a call on each rank).  For each case: ms a
   call (two ranks sharing one card, gloo: no measure of TP speed), each
   rank's peak memory beside the single run's, the launches.  13c: the
   ``meta`` dry run of every cell at ``"quad_tp"``, the MoE cells also
   with ``--expert-parallel``, in worker processes; every cell must count.
   A ``{"tensor_parallel": {...}}`` line holds the numbers; the
   ``kernels`` line's ``flash_attention`` and ``embedding_bag`` rows gain
   their launches a call on each rank.

14. Training under the sharding policy (``make_sharded_train_step``), with
   phase 13's data freed; no kernel lies on the training paths (the
   counters must stay 0: the main process's over the single runs, each
   rank's over each of its cases).  First the single-rank run of each case
   (``make_train_step``; the bf16 cases also in f32), each freed before
   the next and all before the ranks start; then gloo ranks sharing card
   0 under deterministic algorithms (a world of four for 14b and one of two
   for the rest, at once), each holding its shards of the same seeded
   weights and its share of the same batch, 3 steps a case.  14a:
   ``qwen3-4b`` at full width, **8 of 36 layers**, bf16, remat, batch **2
   (of 256)** x 4,096 (a mask of 70 % of the tokens), at mesh (1, 2) with
   ``seq_parallel`` forced on (TP + SP) and at (2, 1) (FSDP).  14b:
   ``smollm-135m`` in f32 at full depth, 4 x 1,024, at (2, 2) on four
   ranks (FSDP x TP; 9 q / 3 kv heads split).  14c: ``olmoe-1b-7b``,
   **2 of 16 layers**, bf16, 2 x 2,048 at (1, 2), TP inside the experts,
   then EP.  14d: xDeepFM at FULL width, ``train_batch`` **65,536 ->
   8,192**, at (1, 2) (training-layout row-sharded tables).  14e: SchNet
   at FULL width, ``full_graph_sm`` (edges split) and ``molecule``
   (graphs split), at (1, 2).  Gates, on every rank: the loss and
   ``grad_norm`` of each step within TRAIN_LOSS_RTOL of the single run's
   in f32, within ARCH_BF16_DRIFTS of the single run's own bf16-vs-f32
   drift in bf16; step 1's gradient blocks within TRAIN_GRAD_TOL of each
   leaf's max |g| (bf16: or twice the leaf's drift); every block another
   rank holds (parameters and both moments) bit for bit equal there after
   step 3, the step counter 3; step 2's collectives (``ctx.recording``)
   those ``analysis.ops.collective_bytes`` counts for the case's cell on
   ``meta``.  Printed: each rank's peak memory beside the single run's,
   the ms a step labelled "ranks sharing one card, gloo" (no measure of
   TP or FSDP speed).  14f: the ``meta`` count of every training cell at
   ``"quad"`` (13c counted them at ``"quad_tp"``), in worker processes
   started with the phase.  A ``{"sharded_training": {...}}`` line holds
   the numbers.

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
# A sharded step against the single-index engine (phase 9): the same
# kernels on the same index arrays, so the same f32 sums.
STEP_RTOL = 1e-6
# The bf16 routes (phases 2c, 4, 9a, 9d).  A bf16 score is an f32 sum of
# exact products rounded once to bf16, so the bf16 route of a kernel is its
# f32 route on the rounded inputs, rounded once: held bitwise.  Its plain
# version sums in another order and may round the other way at a tie of
# the f32 sums: one bf16 ulp of the largest score (BF16_KERNEL_TOL of it).
# Against float64 of the f32 inputs a bf16 score carries three roundings
# of at most 2^-8 each (the weight, the value, the score; the products are
# positive) and the f32 error; its top-k overlaps float64's at
# BF16_OVERLAP_MIN, the bar of the JAX package's bf16 serving
# (tests/test_perf_features.py).
BF16_KERNEL_TOL = 2.0 ** -7
BF16_RTOL = (1 + 2.0 ** -8) ** 3 - 1 + 1e-5
BF16_OVERLAP_MIN = 0.95
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
# One MoE layer on the card against the CPU, f32 (phase 11a): the same
# f32 products summed in another order, held as the LM parity tests hold
# the port to JAX.
MOE_CPU_TOL = 1e-5
# The whole prefill of a phase-11 architecture, kernel path against plain
# path, in bf16: within twice the plain path's own bf16-vs-f32 drift (the
# LM parity tests' bar for bf16).  Each path rounds its attention output to
# bf16 once a layer at other points; over qwen3-4b's 36 layers that noise
# grows to about one drift (1.07 drifts on the first chip run), so phase
# 5's one-drift bar is printed beside it, not held.
ARCH_BF16_DRIFTS = 2.0
# Phase 13b: two ranks against the single run of the same weights.  The
# sequence-split cache combines the ranks' softmax parts in f32: within
# TP_SEQ_RTOL of max |logit|.
TP_SEQ_RTOL = 1e-4
# Phase 13b's mesh is 1 x TP_RANKS; TP_SEQ_ARCH's kv heads do not divide
# it, so its cache is split by sequence.  A rank gets TP_TIMEOUT_S.
TP_RANKS = 2
TP_ROUNDS = 1  # timed calls a case, after its warm-up
TP_SEQ_ARCH = "smollm-135m"
TP_TIMEOUT_S = 900.0
# Phase 14: a world of ranks gets SHARD_TRAIN_TIMEOUT_S, and so do the meta
# counts' workers; each case runs SHARD_TRAIN_STEPS steps (step 1 read as
# its gradient, step 2 counted), 14d on SHARD_RECSYS_MODEL.  The kernels
# whose launch counters a rank reads (no kernel lies on a training path).
SHARD_TRAIN_TIMEOUT_S = 900.0
SHARD_TRAIN_STEPS = 3
SHARD_RECSYS_MODEL = "xdeepfm"
KERNELS = ("scatter_score", "ell_gather", "bmp_scan", "splade_head",
           "flash_attention", "embedding_bag")
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
    # Sharded serving (phase 9): launch.serve's rounds after its warm-up
    # (--sched drains the queue once, after one micro-batch).
    serve_rounds: int = 1
    # Phase 9d: serve_8m, the paper's corpus size and the repo's own shape
    # (src/repro_torch/configs/gpusparse.py:58), on one card: the ell step
    # in f32 and bf16, a warm-up and 5 rounds each.
    serve_8m_docs: int = 8_841_823
    # The system comparison (phase 10).  10a is serve_1m; 10b the paper's
    # Table 2 at its own size (benchmarks/table2_systems.py:18, the
    # corpus of benchmarks/common.py: V = 4,096, seed 0); 10c WAND and BMW
    # at serve_100k (src/repro/configs/gpusparse.py:52), their queries cut
    # 500 -> 3 and 1 (pure-Python traversals, seconds a query there).
    slow_search_ms: float = 1000.0  # above it, a median of 3 searches
    slow_rounds: int = 3
    table2_docs: int = 4000
    table2_queries: int = 64
    table2_vocab: int = 4096
    table2_k: int = 100
    seismic_cuts: tuple = (5, 10, 50)
    wand_docs: int = 100_000
    wand_queries: int = 3
    bmw_queries: int = 1
    host_timeout_s: float = 600.0  # a host baseline's worker at most
    # Every LM architecture (phase 11), each a config of its ArchSpec in
    # repro_torch.configs (``config``: the published widths).  11a:
    # olmoe-1b-7b at full depth, LM_SHAPES' prefill_32k cut to 4 x 2,048
    # and decode_32k to 32 sequences over 2,048 cached positions.
    arch_config: str = "config"
    lm_rounds: int = 3
    moe_arch: str = "olmoe-1b-7b"
    moe_batch: int = 4
    moe_len: int = 2048
    decode_moe_batch: int = 32
    decode_moe_context: int = 2048
    decode_moe_steps: int = 8
    moe_cpu_len: int = 256  # one layer's moe_block, card vs CPU in f32
    # 11b: mixtral-8x22b cut 56 -> 2 layers (~10 GB of f32 a layer: the
    # whole model does not fit one card); one prefill of 8,192 tokens, so
    # the 4,096-token window bites.
    swa_arch: str = "mixtral-8x22b"
    swa_layers: int = 2
    swa_len: int = 8192
    # 11c: qwen3-4b at full depth, one prefill of 4,096 tokens.
    dense_arch: str = "qwen3-4b"
    dense_len: int = 4096
    # 11d: launch.train's defaults (8 x 64 tokens) for 6 steps with a
    # checkpoint every 3; one olmoe step at 2 layers x 2,048 tokens; the
    # data-parallel step for 2 steps.
    train_arch: str = "smollm-135m"
    train_args: tuple = ("--steps", "6", "--checkpoint-every", "3")
    moe_train_layers: int = 2
    moe_train_len: int = 2048
    moe_train_steps: int = 2
    ddp_steps: int = 2
    # SchNet and the cell layer (phase 12).  12a: FULL width (d 64, 300
    # RBFs, 3 interactions), f32, each GNN_SHAPES cell but ogb_products a
    # warm-up and schnet_steps timed train steps; minibatch_lg samples a
    # Reddit-size CSR (GNN_SHAPES' 232,965 nodes, 114,615,892 edges).
    # 12b, after 12a: the meta dry run of every cell in dryrun_workers
    # processes (the machine's 8 cores; the card is idle meanwhile).
    schnet_cells: tuple = ("full_graph_sm", "minibatch_lg", "molecule")
    schnet_steps: int = 10
    reddit_nodes: int = 232_965
    reddit_edges: int = 114_615_892
    dryrun_workers: int = 8
    # Tensor and expert parallelism (phase 13), TP_RANKS gloo ranks on card
    # 0: dense_arch (qwen3-4b) prefill 1 x 4,096 and 8 decode steps of 8
    # sequences from 4,096 seeded cache slots (bf16 and f32); TP_SEQ_ARCH
    # the same in f32 (its 3 kv heads: the cache split by sequence);
    # moe_arch prefill 4 x 2,048 under TP inside the experts and under EP;
    # xDeepFM and AutoInt at serve_p99 with their tables row-sharded.
    tp_prefill_len: int = 4096
    tp_decode_batch: int = 8
    tp_decode_context: int = 4096
    tp_decode_steps: int = 8
    tp_moe_batch: int = 4
    tp_moe_len: int = 2048
    tp_recsys_models: tuple = ("xdeepfm", "autoint")
    # Training under the sharding policy (phase 14), SHARD_TRAIN_STEPS steps
    # a case on gloo ranks sharing card 0: 14a dense_arch cut to
    # shard_lm_layers layers, bf16, LM_SHAPES' train_4k with its batch cut
    # 256 -> shard_lm_batch, at (1, 2) with seq_parallel forced and at
    # (2, 1); 14b TP_SEQ_ARCH in f32 at full depth, shard_split_batch x
    # shard_split_len at (2, 2); 14c moe_arch cut to moe_train_layers,
    # bf16, shard_moe_batch x moe_train_len at (1, 2) under TP and EP; 14d
    # SHARD_RECSYS_MODEL at recsys_train_batch; 14e SchNet's full_graph_sm
    # (edges split) and molecule (graphs split).  The cells' meta counts
    # and 14f in shard_workers processes.
    shard_lm_layers: int = 8
    shard_lm_batch: int = 2
    shard_lm_len: int = 4096
    shard_split_batch: int = 4
    shard_split_len: int = 1024
    shard_moe_batch: int = 2
    shard_workers: int = 6


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


def compare(name: str, got, want, quiet: bool = False,
            tol: float = KERNEL_TOL) -> float:
    """max |got - want|; raises unless it is within ``tol`` of max |want|
    (both finite and of one shape)."""
    import torch

    sync(got.device)
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite output")
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    rel = err / max(scale, 1e-30)
    if not quiet:
        log(f"  {name}: max_abs_err={err!r} max_abs_plain={scale!r} "
            f"rel={rel!r}")
    if rel > tol:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (rel {rel} > {tol})")
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



def compare_inf(name: str, got, want, tol: float = KERNEL_TOL) -> float:
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
    return compare(name, got[fin], want[fin], quiet=True, tol=tol)


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


def check_sweep(name, index, qw, launch, got, groups_to_check, alive=None,
                tol: float = KERNEL_TOL):
    """Hold ``groups_to_check`` groups of one ``bmp_sweep`` launch against
    the plain version on the same order/ub_sorted/tau0: scores, heap and
    tau within ``tol``, fetch sets and steps equal."""
    import torch

    from repro_torch.kernels.bmp_scan.ref import bmp_sweep_ref
    from repro_torch.sched.planner import PAD_TAU

    sel, order, us, tau, _, kw = launch
    err = 0.0
    for g in range(min(groups_to_check, sel.shape[0])):
        want = bmp_sweep_ref(qw[sel[g]], order[g], us[g], tau[g],
                             *tiled_runs(index), alive, **kw)
        tag = f"{name}, group {g} of {sel.shape[0]} x {sel.shape[1]} rows"
        e = compare(f"{tag} scores", got[0][g], want[0], quiet=True, tol=tol)
        e = max(e, compare_inf(f"{tag} heap", got[1][g], want[1], tol))
        real = tau[g] < PAD_TAU  # pad rows keep PAD_TAU in both
        compare_inf(f"{tag} tau",
                    torch.maximum(tau[g], got[1][g][:, -1])[real],
                    torch.maximum(tau[g], want[1][:, -1])[real], tol)
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
    from repro_torch.core.scoring import docs_csr

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


def check_bf16(dev, sizes: Sizes) -> dict:
    """Phase 2c: the bf16 routes of the three retrieval kernels at phase
    2's sizes.  ``scatter_score`` and ``ell_gather`` (sparse and dense
    query tiles, phase 2's geometries): bitwise the f32 route on the
    bf16-rounded inputs, rounded once (the contract: the same f32 sums);
    within one bf16 ulp of the plain version; twice bitwise equal.
    ``bmp_scan`` on phase 2b's topical corpus, flat (the wide route) and
    the planner's groups (the small route): against the plain version
    (scores, heap, tau within one bf16 ulp of max |plain|; fetch sets and
    steps equal), and each scored block of a launch's first group bitwise
    ``scatter_score``'s bf16 route on that block."""
    import dataclasses as dc

    import numpy as np
    import torch

    from repro_torch.core import index as index_mod
    from repro_torch.core import scoring
    from repro_torch.data.synthetic import (
        make_msmarco_like, make_topical_corpus,
    )
    from repro_torch.kernels.bmp_scan import ops as bmp_ops
    from repro_torch.kernels.ell_gather import ell_gather, ell_gather_ref
    from repro_torch.kernels.scatter_score import (
        scatter_score, scatter_score_ref,
    )
    from repro_torch.sched import planner

    bf = torch.bfloat16
    errs = {"scatter_score": 0.0, "ell_gather": 0.0, "bmp_scan": 0.0}

    def held(name, kind, route, f32_route, plain):
        got = route()
        if got.dtype != bf:
            raise AssertionError(f"{name}: {got.dtype} scores, not bf16")
        if not torch.equal(got, f32_route().to(bf)):
            raise AssertionError(f"{name}: not the f32 route's sums on the "
                                 f"rounded inputs, rounded once")
        if not torch.equal(got, route()):
            raise AssertionError(f"{name} is not deterministic")
        errs[kind] = max(errs[kind], compare(name, got, plain(),
                                             tol=BF16_KERNEL_TOL))

    c = make_msmarco_like(sizes.check_docs, sizes.check_queries,
                          vocab_size=sizes.vocab, seed=11, device=dev)
    for i, (tb, db, cs) in enumerate(sizes.geometries):
        idx = index_mod.build_tiled_index(c.docs, term_block=tb, doc_block=db,
                                          chunk_size=cs)
        qw = padded_queries(c.queries, idx)
        vb = idx.value.to(bf)
        queries = [("", qw)] + ([("/dense tile", dense_queries(
            *qw.shape, dev, seed=tb))] if i == 0 else [])
        for tag, q in queries:
            qb = q.to(bf)
            args = dict(tiled_args(idx), value=vb)
            wide = dict(args, value=vb.float())
            held(f"scatter_score bf16 T={tb} D={db} C={cs}{tag}",
                 "scatter_score", lambda: scatter_score(qb, **args),
                 lambda: scatter_score(qb.float(), **wide),
                 lambda: scatter_score_ref(qb, **args))
    ell = index_mod.build_ell_index(c.docs)
    vb = ell.values.to(bf)
    qw = c.queries.to_dense()
    for tag, q in (("", qw), ("/dense tile",
                              dense_queries(*qw.shape, dev, seed=1))):
        qb = q.to(bf)
        held(f"ell_gather bf16{tag}", "ell_gather",
             lambda: ell_gather(qb, ell.terms, vb),
             lambda: ell_gather(qb.float(), ell.terms, vb.float()),
             lambda: ell_gather_ref(qb, ell.terms, vb))
    del c, ell, vb, qw

    t = make_topical_corpus(sizes.check_docs, sizes.check_queries,
                            vocab_size=sizes.vocab, seed=12, device=dev)
    docs, _ = index_mod.reorder_docs(t.docs, "df-signature")
    b = sizes.check_queries
    for tb, db, cs, k in sizes.pruned_geometries:
        idx = index_mod.build_tiled_index(docs, tb, db, cs,
                                          store_term_block_max=True)
        idx = dc.replace(idx, value=idx.value.to(bf))
        qw = scoring._pad_queries_to_term_blocks(t.queries, idx)  # bf16
        ub = scoring.block_upper_bounds(t.queries, idx)
        k_eff = min(k, idx.num_docs)
        plan = planner.plan_micro_batches(
            ub.cpu().numpy(), idx.block_chunk_count.cpu().numpy())
        for name, groups, n_check in (
                ("flat", [np.arange(b)], 1),
                (f"fused ({plan.num_groups} groups)", plan.groups,
                 sizes.check_groups)):
            for launch in sweep_launches(idx, qw, ub, groups, k_eff):
                got = launch[4]()
                route = getattr(bmp_ops.last_route, "name", "plain")
                tag = f"bmp_scan bf16 T={tb} D={db} C={cs} k={k} {name}"
                errs["bmp_scan"] = max(errs["bmp_scan"], check_sweep(
                    f"{tag} ({route} route)", idx, qw, launch, got, n_check,
                    tol=BF16_KERNEL_TOL))
                sel, bsc = launch[0], got[2][0].bool()
                args = dict(tiled_args(idx), block_chunk_count=(
                    idx.block_chunk_count * bsc.to(torch.int32)))
                cols = bsc.repeat_interleave(db)
                exact = scatter_score(qw[sel[0]], **args).float()
                if not torch.equal(got[0][0][:, cols], exact[:, cols]):
                    raise AssertionError(f"{tag}: a scored block is not "
                                         f"scatter_score's bf16 bits")
        log(f"  bmp_scan bf16 T={tb} D={db} C={cs} k={k}: scored blocks "
            f"bitwise scatter_score's bf16 route")
    return errs


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
    -- the distinct chunk lines (8 B a slot and the value: 12 B in f32, 10
    in bf16) that some group of the launch
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
            + gs * rows * qw.shape[1] * qw.element_size())  # weights read
    line = idx.chunk_size * (8 + idx.value.element_size())
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
    # The bf16 route on the same groups: the values and weights in bf16,
    # the same bounds and plan.
    import dataclasses as dc

    import torch

    idx_b = dc.replace(idx, value=idx.value.to(torch.bfloat16))
    qw_b = scoring._pad_queries_to_term_blocks(queries, idx_b)
    (sample_b,) = sweep_launches(
        idx_b, qw_b, ub, [g for _, g in entries[: sizes.sample_groups]],
        k_eff)
    got_b = sample_b[4]()
    err_b = check_sweep("bmp_scan bf16 at serve_1m", idx_b, qw_b, sample_b,
                        got_b, sizes.sample_groups, tol=BF16_KERNEL_TOL)
    ms_b = event_ms(sample_b[4], sizes.reps, dev)
    # The plain version on the sample's first group only (a host loop of
    # ~3,500 steps, ~3 s a group): the time budget of the script.
    sel_b, order_b, us_b, tau_b, _, kw_b = sample_b
    plain_b = event_ms(lambda: bmp_sweep_ref(
        qw_b[sel_b[0]], order_b[0], us_b[0], tau_b[0], *tiled_runs(idx_b),
        None, **kw_b), 1, dev)
    launches_b = sweep_launches(idx_b, qw_b, ub, plan.groups, k_eff)
    all_b = event_ms(lambda: [launch[4]() for launch in launches_b], 1, dev)
    work_b = sweep_work(idx_b, qw_b, sample_b, got_b, k_eff)
    bound_b, by_b = sweep_bound(work_b)
    row["bf16"] = dict(ms=ms_b, plain_ms_first_group=plain_b,
                       bound_ms=bound_b, bound_by=by_b, library_ms=None,
                       max_abs_err=err_b, call_ms=all_b)
    line_b = idx.chunk_size * 10
    log(work_line(f"bmp_scan bf16 on {gs} groups x {rows} rows of the main "
                  f"path (plain, its first group: {plain_b!r} ms)", ms_b,
                  work_b, line_b))
    log(f"  bmp_scan bf16, every launch of one search call: {all_b!r} ms "
        f"(f32 {all_ms!r} ms)")
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


def same_step(name: str, got, want) -> dict:
    """A sharded step's (values, ids, tau) tensors against the single-index
    engine's ``search(..., return_tau=True)`` numpy triple: ids tie-aware,
    values within ``STEP_RTOL`` (``same_results``), tau equal."""
    import numpy as np

    v, i, tau = (x.cpu().numpy() for x in got)
    # The engine reports id -1 at a non-finite value; the step a position.
    i = np.where(np.isfinite(v), i, -1)
    res = same_results(name, (v, i), want[:2], rtol=STEP_RTOL)
    if not np.array_equal(tau, want[2]):
        raise AssertionError(f"{name}: tau differs from the engine's")
    return res


class KernelClock:
    """While active, CUDA events around every call of the three retrieval
    kernels' entries (``scatter_score``, ``ell_gather``, ``bmp_sweep``),
    keyed by (kernel, the query weights' dtype): their ms and the launches
    they made (each entry's own counter, read around the call)."""

    def __init__(self):
        from repro_torch.kernels.bmp_scan import ops as bmp_ops
        from repro_torch.kernels.ell_gather import ops as ell_ops
        from repro_torch.kernels.scatter_score import ops as scatter_ops

        self.targets = {"scatter_score": (scatter_ops, "scatter_score"),
                        "ell_gather": (ell_ops, "ell_gather"),
                        "bmp_scan": (bmp_ops, "bmp_sweep")}
        self.events, self.launches, self.saved = [], {}, {}

    def __enter__(self):
        import torch

        for name, (mod, fn) in self.targets.items():
            orig = self.saved[name] = getattr(mod, fn)

            def timed(qw, *args, _name=name, _mod=mod, _orig=orig, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                n0 = _mod.launches
                start.record()
                out = _orig(qw, *args, **kw)
                end.record()
                key = (_name, str(qw.dtype).replace("torch.", ""))
                self.events.append((key, start, end))
                self.launches[key] = (self.launches.get(key, 0)
                                      + _mod.launches - n0)
                return out

            setattr(mod, fn, timed)
        return self

    def __exit__(self, *exc):
        for name, (mod, fn) in self.targets.items():
            setattr(mod, fn, self.saved[name])

    def ms(self, dev) -> dict:
        """{"kernel/dtype": ms summed over the calls}."""
        sync(dev)
        out = {}
        for (name, dt), start, end in self.events:
            key = f"{name}/{dt}"
            out[key] = out.get(key, 0.0) + start.elapsed_time(end)
        return out


def bf16_ulp(x):
    """One bf16 ulp at each value of the numpy array ``x``."""
    import numpy as np

    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def same_bf16_topk(name: str, got, want) -> dict:
    """Two bf16 steps' (values, ids) under one contract, summed in other
    orders: each value within one bf16 ulp of the other's at its rank,
    and an id in one top-k only where it sits within one ulp of the
    other's k-th value (a rounding tie at the cut)."""
    import numpy as np

    gv, gi = (np.asarray(x.cpu()) for x in got[:2])
    wv, wi = (np.asarray(x.cpu()) for x in want[:2])
    bad = np.abs(gv - wv) > bf16_ulp(wv)
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} values more than a "
                             f"bf16 ulp apart")
    moved = 0
    for r in range(gv.shape[0]):
        for v, ids, other, kth in ((gv[r], gi[r], set(wi[r].tolist()),
                                    wv[r, -1]),
                                   (wv[r], wi[r], set(gi[r].tolist()),
                                    gv[r, -1])):
            out = np.array([i not in other for i in ids.tolist()])
            moved += int(out.sum())
            if np.any(v[out] > kth + bf16_ulp(np.float32(kth))):
                raise AssertionError(f"{name}: row {r} differs above the "
                                     f"cut")
    log(f"  {name}: values within one bf16 ulp, {moved} ids at the cut "
        f"differ")
    return {"ids_at_cut_differ": moved}


def check_bf16_exact(name: str, vals, ids, oracle, sample, k: int) -> dict:
    """A bf16 step against float64: overlap@k >= BF16_OVERLAP_MIN and each
    returned score within BF16_RTOL of its float64 score."""
    import torch

    o = oracle.T
    o_ids = torch.topk(o, k, dim=1).indices.cpu().numpy()
    ov = overlap(ids[sample], o_ids, k)
    got = torch.from_numpy(vals[sample]).double().to(o.device)
    want = o.gather(1, torch.from_numpy(ids[sample]).to(o.device))
    rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
    log(f"  {name}: overlap@{k} vs f64 = {ov!r}, max rel score err = "
        f"{rel!r} (bars {BF16_OVERLAP_MIN}, {BF16_RTOL!r})")
    if ov < BF16_OVERLAP_MIN or rel > BF16_RTOL:
        raise AssertionError(f"{name}: bf16 step off float64 (overlap {ov}, "
                             f"rel {rel})")
    return {"overlap_f64": ov, "max_rel_f64": rel}


def serve_sharded(dev, sizes: Sizes) -> dict:
    """Phase 9: the sharded serve step at world size 1 for each engine, in
    f32 and bf16 (9a), the collective path under an NCCL group of one (9b),
    and ``repro_torch.launch.serve`` at serve_1m (9c)."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import RetrievalConfig, RetrievalEngine
    from repro_torch.core import distributed as tdist
    from repro_torch.core.distributed import (
        build_sharded_ell, build_sharded_tiled, make_serve_step,
    )
    from repro_torch.core.index import reorder_docs
    from repro_torch.data.synthetic import (
        make_msmarco_like, make_topical_corpus,
    )
    from repro_torch.launch import serve as serve_mod

    k, b = sizes.k, sizes.queries
    bf = torch.bfloat16
    # build_sharded_tiled's default geometry
    geo = dict(term_block=512, doc_block=64, chunk_size=128)
    out, keep = {}, {}
    bf16_launches = {}

    def step_of(name, idx, extra=None, dtype=torch.float32):
        cfg = RetrievalConfig(engine=name, k=k, obs=None, **(extra or {}))
        geometry = getattr(idx, "geometry", None)  # tiled indices only
        return make_serve_step(
            engine=name, cfg=cfg, docs_per_shard=idx.docs_per_shard,
            geometry=geometry and geometry(), compute_dtype=dtype)

    def clocked(label, step, idx, queries, rounds):
        """host_rounds of the step with the kernel clock on -> (result, ms
        a step, {kernel/dtype: kernel ms a step})."""
        cast0 = tdist.cast_bytes
        clock = KernelClock()
        with clock:
            got, ms = host_rounds(label, lambda: step(idx, queries=queries),
                                  rounds, dev, b)
        per = {key: t / (rounds + 1) for key, t in clock.ms(dev).items()}
        for key, n in clock.launches.items():
            bf16_launches[key] = bf16_launches.get(key, 0) + n
        log(f"  {label}: kernel ms a step {per!r}; index cast "
            f"{tdist.cast_bytes - cast0} B")
        return got, ms, per

    def both(label, name, idx, queries, rounds, extra=None, first_bf16=True):
        """The f32 and bf16 steps of one engine -> (f32 result, bf16
        result, numbers); ``first_bf16``: the index's first bf16 step."""
        got, ms, kms = clocked(f"{label}: sharded step",
                               step_of(name, idx, extra), idx, queries,
                               rounds)
        cast0 = tdist.cast_bytes
        got_b, ms_b, kms_b = clocked(f"{label}: bf16 sharded step",
                                     step_of(name, idx, extra, bf), idx,
                                     queries, rounds)
        # The values are cast once for each (index, dtype): 4 B read and
        # 2 B written a slot on the index's first bf16 step, none after.
        values = idx.values if name == "ell" else idx.value
        once = values.numel() * 6 if first_bf16 else 0
        if tdist.cast_bytes - cast0 != once:
            raise AssertionError(f"{label}: the index cast "
                                 f"{tdist.cast_bytes - cast0} B, not {once}")
        return got, got_b, dict(step_ms=ms, kernel_ms=kms, bf16_step_ms=ms_b,
                                bf16_kernel_ms=kms_b,
                                bf16_cast_bytes=tdist.cast_bytes - cast0)

    # 9a. the exact engines on phase 3's corpus
    corpus = make_msmarco_like(sizes.docs, b, vocab_size=sizes.vocab,
                               seed=0, device=dev)
    q = corpus.queries
    g = torch.Generator().manual_seed(5)
    sample = torch.randperm(b, generator=g)[
        :sizes.oracle_queries].sort().values.numpy()
    oracle = oracle_f64(corpus.docs, q, sample)
    exact_b = {}
    for name in ("ell", "tiled"):
        idx, build_ms = timed(
            f"9a {name}: sharded build, 1 shard",
            lambda: (build_sharded_ell(corpus.docs, 1) if name == "ell"
                     else build_sharded_tiled(corpus.docs, 1)), dev)
        got, got_b, nums = both(f"9a {name}", name, idx, q, sizes.rounds)
        eng = RetrievalEngine(corpus.docs, RetrievalConfig(
            engine=name, k=k, obs=None, **geo), device=dev)
        want, eng_ms = host_rounds(
            f"9a {name}: RetrievalEngine.search at the sharded geometry",
            lambda: eng.search(q, k=k, return_tau=True), sizes.rounds, dev, b)
        out[f"9a {name}"] = dict(search_ms=eng_ms, build_ms=build_ms, **nums,
                                 **same_step(f"9a {name}: step vs engine",
                                             got, want))
        check_exact(f"9a {name} step", got[0].cpu().numpy(),
                    got[1].cpu().numpy(), oracle, sample, k)
        out[f"9a {name}"].update(check_bf16_exact(
            f"9a {name} bf16 step", got_b[0].cpu().numpy(),
            got_b[1].cpu().numpy(), oracle, sample, k))
        exact_b[name] = got_b
        keep[name] = (idx, got)
        del eng, want
        torch.cuda.empty_cache()
    out["9a bf16 ell vs tiled"] = same_bf16_topk(
        "9a bf16: ell vs tiled", exact_b["ell"], exact_b["tiled"])
    del exact_b

    # 9a. the pruned engines on phase 3b's topical corpus, reordered as the
    # engines reorder it (sharded serving takes the corpus as given)
    topical = make_topical_corpus(sizes.docs, b, vocab_size=sizes.vocab,
                                  seed=0, device=dev)
    docs, _ = reorder_docs(topical.docs, method="df-signature")
    tq = topical.queries
    g = torch.Generator().manual_seed(6)
    t_sample = torch.randperm(b, generator=g)[
        :sizes.oracle_queries].sort().values.numpy()
    t_oracle = oracle_f64(docs, tq, t_sample)
    idx, build_ms = timed("9a pruned: sharded build, 1 shard",
                          lambda: build_sharded_tiled(docs, 1), dev)
    single = RetrievalEngine(docs, RetrievalConfig(
        engine="tiled-pruned", k=k, obs=None, **geo), device=dev)
    # Under the bf16 contract the exact pruned steps give the bits of the
    # bf16 tiled step: held to it.
    tiled_b, _ = host_rounds("9a pruned: bf16 tiled step on the topical "
                             "corpus", lambda: step_of("tiled", idx, None, bf)(
                                 idx, queries=tq), 0, dev, b)
    for name, extra in (("tiled-pruned", {}),
                        ("tiled-pruned", {"traversal": "two-pass"}),
                        ("tiled-pruned-approx", {}),
                        ("tiled-bmp-grouped", {}), ("tiled-bmp-fused", {})):
        label = f"9a {name}{' two-pass' if extra else ''}"
        got, got_b, nums = both(label, name, idx, tq, 0, extra,
                                first_bf16=False)
        eng = RetrievalEngine.from_prebuilt(
            docs, RetrievalConfig(engine=name, k=k, obs=None, **geo,
                                  **extra), single._index, device=dev)
        want, eng_ms = host_rounds(
            f"{label}: RetrievalEngine.search at the sharded geometry",
            lambda: eng.search(tq, k=k, return_tau=True), 0, dev, b)
        out[label] = dict(search_ms=eng_ms, **nums, **same_step(
            f"{label}: step vs engine", got, want))
        check_exact(f"{label} step", got[0].cpu().numpy(),
                    got[1].cpu().numpy(), t_oracle, t_sample, k)
        out[label].update(check_bf16_exact(
            f"{label} bf16 step", got_b[0].cpu().numpy(),
            got_b[1].cpu().numpy(), t_oracle, t_sample, k))
        if name != "tiled-pruned-approx":
            same = all(torch.equal(a, w) for a, w in zip(got_b, tiled_b))
            log(f"  {label} bf16: the bf16 tiled step's values, ids and tau "
                f"bitwise: {same}")
            if not same:
                raise AssertionError(f"{label}: the bf16 step is not exact "
                                     f"under the bf16 contract")
        if name == "tiled-bmp-fused":
            keep[name] = (idx, got)
    out["9a pruned build_ms"] = build_ms
    out["9a bf16 launches"] = {f"{n}/{d}": c
                               for (n, d), c in bf16_launches.items()}
    log(f"  9a launches by kernel and dtype: {out['9a bf16 launches']}")
    for name in ("scatter_score", "ell_gather", "bmp_scan"):
        if bf16_launches.get((name, "bfloat16"), 0) <= 0:
            raise AssertionError(f"{name}'s bf16 route was not launched "
                                 f"in 9a")
    del single, eng, want, topical, tiled_b
    torch.cuda.empty_cache()

    # 9b. the collective path on the card: an NCCL group of one
    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        port = s_.getsockname()[1]
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        for name, queries in (("ell", q), ("tiled-bmp-fused", tq)):
            idx, want = keep[name]
            got, ms = timed(f"9b {name}: step under an NCCL group of 1",
                            lambda: step_of(name, idx)(idx, queries=queries),
                            dev)
            for a, w in zip(got, want):
                if not torch.equal(a, w):
                    raise AssertionError(f"9b {name}: not 9a's bits")
            out[f"9b {name}"] = dict(ms=ms, bitwise=True)
    finally:
        dist.destroy_process_group()
    log("  9b: ell and tiled-bmp-fused under NCCL give 9a's bits")
    del keep, corpus, q, tq, docs, idx, got, want
    torch.cuda.empty_cache()

    # 9c. the serve driver at serve_1m
    base = ["--docs", str(sizes.docs), "--batch", str(b), "--vocab",
            str(sizes.vocab), "--k", str(k), "--rounds",
            str(sizes.serve_rounds)]
    for label, flags, floor in (
            ("ell", ["--engine", "ell"], 0.99995),
            ("tiled-bmp-fused", ["--engine", "tiled-bmp-fused"], OVERLAP_MIN),
            ("sched", ["--sched", "--max-batch", str(sizes.sched_batch)],
             OVERLAP_MIN)):
        t0 = time.perf_counter()
        res = serve_mod.main(base + flags)
        log(f"  9c {label}: {res['ms_per_batch']!r} ms/batch, "
            f"{res['us_per_query']!r} us/query, overlap {res['overlap']!r} "
            f"(the run {time.perf_counter() - t0:.3f} s)")
        if res["overlap"] < floor:  # 0.99995 prints as 1.0000
            raise AssertionError(f"9c {label}: overlap {res['overlap']}")
        out[f"9c {label}"] = res
        torch.cuda.empty_cache()
    return out


def ell_f64(index, queries, sample):
    """Float64 scores [N, len(sample)] of the sampled queries over an
    ``EllIndex``, a bounded slab of docs at a time (the corpus is gone by
    then, and its CSR in float64 would not fit beside the index)."""
    import torch

    qw = queries.to_dense(torch.float64)[torch.from_numpy(sample).to(
        queries.device)]
    qw = torch.nn.functional.pad(qw, (0, 1))  # the padding id reads 0
    n, kk = index.terms.shape
    out = torch.empty((n, qw.shape[0]), dtype=torch.float64,
                      device=qw.device)
    step = max(1, (1 << 26) // (qw.shape[0] * kk))
    for s in range(0, n, step):
        t = index.terms[s:s + step].long()
        v = index.values[s:s + step].double()
        out[s:s + step] = (qw[:, t] * v).sum(-1).T
    return out[:index.num_docs]


def serve_8m(dev, sizes: Sizes) -> dict:
    """Phase 9d: serve_8m (8,841,823 docs, B = 500, k = 1000) on one card
    at world size 1: the corpus made on the card, the one-shard ELL index
    built from it and the corpus freed; the ``ell`` step in f32 and in
    bf16, each a warm-up and ``rounds`` calls timed with CUDA events
    (median), ``ell_gather`` alone on the step's inputs beside its bound
    (that dtype's bytes: every slot's term id, the live values, QW, the
    scores) and its HBM share (bound over kernel time); the f32 step held
    to float64 on ``oracle_queries`` queries as phase 3 holds it, the bf16
    step's overlap with float64; peak device memory."""
    import numpy as np
    import torch

    from repro_torch.core import distributed as tdist
    from repro_torch.core.distributed import (
        build_sharded_ell, make_serve_step,
    )
    from repro_torch.data.synthetic import make_msmarco_like
    from repro_torch.kernels.ell_gather import ops as ell_ops

    n, b, k = sizes.serve_8m_docs, sizes.queries, sizes.k
    torch.cuda.reset_peak_memory_stats(dev)
    corpus, gen_ms = timed(f"9d: corpus of {n} docs on the card",
                           lambda: make_msmarco_like(
                               n, b, vocab_size=sizes.vocab, seed=0,
                               device=dev), dev)
    nnz = int((corpus.docs.term_ids >= 0).sum())
    log(f"  9d corpus: {nnz / n!r} nnz/doc, K={corpus.docs.max_terms}, "
        f"{torch.cuda.memory_allocated(dev)} B held")
    idx, build_ms = timed("9d: build_sharded_ell, 1 shard",
                          lambda: build_sharded_ell(corpus.docs, 1), dev)
    q = corpus.queries
    del corpus
    torch.cuda.empty_cache()
    local = idx.shard(0)
    live = int((local.terms < sizes.vocab).sum())
    log(f"  9d index: terms {tuple(idx.terms.shape)}, {live} live slots, "
        f"{torch.cuda.memory_allocated(dev)} B held after the corpus went")
    g = torch.Generator().manual_seed(5)
    sample = torch.randperm(b, generator=g)[
        :sizes.oracle_queries].sort().values.numpy()
    oracle, oracle_ms = timed("9d: float64 scores of the sampled queries",
                              lambda: ell_f64(local, q, sample), dev)
    out = dict(docs=n, nnz=nnz, slots=int(idx.terms.numel()),
               live_slots=live, corpus_ms=gen_ms, build_ms=build_ms,
               oracle_ms=oracle_ms)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        cast0 = tdist.cast_bytes
        step = make_serve_step(engine="ell", k=k,
                               docs_per_shard=idx.docs_per_shard,
                               compute_dtype=dtype)
        got = step(idx, queries=q)  # warm-up (and the one cast)
        sync(dev)
        times = []
        for _ in range(sizes.rounds):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            got = step(idx, queries=q)
            end.record()
            sync(dev)
            times.append(start.elapsed_time(end))
        step_ms = float(np.median(times))
        vals, ids = got[0].cpu().numpy(), got[1].cpu().numpy()
        if dtype == torch.float32:
            check_exact("9d ell f32 step", vals, ids, oracle, sample, k)
            ov = overlap(ids[sample], torch.topk(
                oracle.T, k, dim=1).indices.cpu().numpy(), k)
            res = {"overlap_f64": ov}
        else:
            res = check_bf16_exact("9d ell bf16 step", vals, ids, oracle,
                                   sample, k)
        qw = q.to_dense().to(dtype)
        vals_in = idx.shard(0, dtype).values
        kernel_ms = event_ms(lambda: ell_ops.ell_gather(qw, local.terms,
                                                        vals_in),
                             sizes.reps, dev)
        elem = qw.element_size()
        nbytes = (local.terms.numel() * 4 + live * elem
                  + b * sizes.vocab * elem + b * idx.docs_per_shard * elem)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[tag] = dict(step_ms=step_ms, step_ms_all=times,
                        kernel_ms=kernel_ms, bound_ms=bound_ms,
                        bound_bytes=nbytes, hbm_share=bound_ms / kernel_ms,
                        cast_bytes=tdist.cast_bytes - cast0, **res)
        log(f"  9d ell {tag}: {step_ms!r} ms a step (CUDA events, median "
            f"of {sizes.rounds}: {times!r}); ell_gather {kernel_ms!r} ms, "
            f"bound {bound_ms!r} ms ({nbytes} B), HBM share "
            f"{bound_ms / kernel_ms!r}; index cast "
            f"{tdist.cast_bytes - cast0} B")
        del got, qw, vals_in
        torch.cuda.empty_cache()
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    log(f"  9d peak device memory: {out['peak_bytes']} B")
    return out


# ---------------------------------------------------------------------------
# Phase 10: the paper's system comparison


def host_baseline(job: dict) -> dict:
    """One CPU baseline job of phase 10, run in a worker process so that
    the pure-Python traversals overlap the card's work: ``CpuPostings``
    built over the corpus saved at ``job["path"]`` (``save_corpus``), then
    each of ``job["kinds"]`` ("exhaustive", "wand", "bmw") over queries
    ``job["rows"]`` at ``job["k"]`` -> {kind: (values, ids, seconds)},
    the build seconds and the query count.  Touches no card."""
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    import numpy as np
    import torch

    from repro_torch.core import wand
    from repro_torch.core.sparse import SparseBatch

    torch.set_num_threads(1)
    with np.load(job["path"]) as f:
        a = {name: torch.from_numpy(f[name]) for name in f.files}
    vocab = int(a["vocab"])
    lo, hi = job["rows"]
    docs = SparseBatch(a["doc_ids"], a["doc_vals"], vocab)
    queries = SparseBatch(a["q_ids"][lo:hi], a["q_vals"][lo:hi], vocab)
    t0 = time.perf_counter()
    cp = wand.CpuPostings.build(docs)
    out = {"build_s": time.perf_counter() - t0, "queries": hi - lo}
    for kind in job["kinds"]:
        t0 = time.perf_counter()
        if kind == "exhaustive":
            res = wand.exhaustive_topk_cpu(queries, cp, job["k"])
        else:
            res = wand.wand_topk_cpu(queries, cp, job["k"],
                                     block_max=kind == "bmw")
        out[kind] = (*res, time.perf_counter() - t0)
    return out


def save_corpus(path: str, corpus) -> str:
    """A corpus's docs and queries as one ``.npz`` a worker can load."""
    import numpy as np

    np.savez(path, doc_ids=corpus.docs.term_ids.cpu().numpy(),
             doc_vals=corpus.docs.values.cpu().numpy(),
             q_ids=corpus.queries.term_ids.cpu().numpy(),
             q_vals=corpus.queries.values.cpu().numpy(),
             vocab=np.int64(corpus.vocab_size))
    return path


def host_results(parts, timeout: float) -> dict:
    """The results of one baseline's worker jobs, each a slice of the
    queries in order: values and ids stacked, seconds summed."""
    import numpy as np

    got = [p.get(timeout=timeout) for p in parts]
    out = {"queries": sum(g["queries"] for g in got),
           "build_s": max(g["build_s"] for g in got)}
    for kind in got[0]:
        if kind not in out:
            out[kind] = (np.concatenate([g[kind][0] for g in got]),
                         np.concatenate([g[kind][1] for g in got]),
                         sum(g[kind][2] for g in got))
    return out


def host_cpu_name() -> str:
    """The host CPU's model name (``/proc/cpuinfo``, else ``lscpu``, which
    names Arm cores too) and its core count."""
    import platform

    name = None
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("model name"):
                name = line.split(":", 1)[1].strip()
                break
    if name is None:
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=30).stdout
        except OSError:
            out = ""
        names = [line.split(":", 1)[1].strip() for line in out.splitlines()
                 if line.startswith("Model name")]
        name = names[0] if names else platform.machine()
    return f"{name}, {os.cpu_count()} cores"


def f64_topk(docs, queries, k: int):
    """Float64 top-k (values, ids) of every query, as numpy."""
    from repro_torch.core.scoring import topk_f64

    v, i = topk_f64(queries, docs, k)
    return v.cpu().numpy(), i.cpu().numpy()


def host_exact(name: str, got, want) -> dict:
    """A host baseline's float64 top-k against float64 scoring, tie-aware
    (``same_results`` at SCORE_RTOL, all k ranks)."""
    vals, ids, secs = got
    res = same_results(name, (vals, ids), want, rtol=SCORE_RTOL)
    return dict(s=secs, **res)


def serve_1m_comparison(dev, sizes: Sizes) -> dict:
    """10a: ``bcoo`` and ``segment`` beside ``tiled`` and ``ell`` at
    serve_1m through ``RetrievalEngine.search``: times, float64 exactness,
    the ids against ``tiled``'s, the segment loop's launches, the indices'
    bytes and peak memory."""
    import numpy as np
    import torch

    from repro_torch.core import RetrievalConfig, RetrievalEngine, scoring
    from repro_torch.data.synthetic import make_msmarco_like

    k, b = sizes.k, sizes.queries
    corpus = make_msmarco_like(sizes.docs, b, vocab_size=sizes.vocab,
                               seed=0, device=dev)
    q = corpus.queries
    g = torch.Generator().manual_seed(5)
    sample = torch.randperm(b, generator=g)[
        :sizes.oracle_queries].sort().values.numpy()
    oracle = oracle_f64(corpus.docs, q, sample)
    log(f"  dense: left out at serve_1m (its [{sizes.docs}, {sizes.vocab}] "
        f"f32 document matrix would be "
        f"{sizes.docs * sizes.vocab * 4 / 1e9:.1f} GB)")
    out, results = {}, {}
    for name in ("tiled", "ell", "bcoo", "segment"):
        eng, build_ms = timed(f"10a {name}: index build", lambda: (
            RetrievalEngine(corpus.docs, RetrievalConfig(engine=name, k=k),
                            device=dev)), dev)
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        rounds, note = sizes.rounds, f"median of {sizes.rounds}"
        if name == "segment":
            before = scoring.segment_launches
            _, first_ms = timed("10a segment: one search",
                                lambda: eng.search(q, k=k), dev)
            launches = scoring.segment_launches - before
            log(f"  10a segment: {launches} index_add_ launches a search "
                f"({launches / b!r} a query)")
            if first_ms > sizes.slow_search_ms:
                rounds = sizes.slow_rounds
                note = (f"median of {rounds}: one search took "
                        f"{first_ms:.1f} ms > {sizes.slow_search_ms} ms")
        vals, ids, ms = time_search(f"10a {name}", eng, q, k, rounds, dev)
        peak = torch.cuda.max_memory_allocated(dev)
        log(f"  10a {name}: {ms!r} ms a search ({note}); peak device memory "
            f"{peak} B, {peak - held} B above the {held} B held before it")
        check_exact(f"10a {name}", vals, ids, oracle, sample, k)
        row = dict(ms=ms, timing=note, build_ms=build_ms, peak_bytes=peak,
                   search_bytes=peak - held, index_bytes=eng.index_bytes(),
                   padding_overhead=eng.padding_overhead())
        if name == "segment":
            flat = eng._flat
            row.update(launches_per_search=launches,
                       total_postings=flat.total_postings,
                       total_padded=flat.total_padded, pad_to=flat.pad_to)
            log(f"  10a FlatIndex: built in {build_ms / 1e3!r} s, "
                f"{flat.total_postings} postings in {flat.total_padded} "
                f"slots (pad_to {flat.pad_to}), padding_overhead "
                f"{flat.padding_overhead!r} (Eq. 3), memory_bytes "
                f"{flat.memory_bytes()} B")
        if name != "tiled":
            row["vs_tiled"] = same_results(
                f"10a {name} vs tiled", (vals, ids), results["tiled"])
        results[name] = vals, ids
        out[name] = row
        del eng
        torch.cuda.empty_cache()
    for name in ("tiled", "ell"):
        log(f"  10a {name} index: {out[name]['index_bytes']} B, padding "
            f"overhead {out[name]['padding_overhead']!r}")
    seg = out["segment"]["ms"]
    out["ratios"] = {f"{a} / {b_}": out[a]["ms"] / out[b_]["ms"]
                     for a in ("segment", "bcoo") for b_ in ("tiled", "ell")}
    log(f"  10a segment / tiled = {seg / out['tiled']['ms']!r}, segment / "
        f"ell = {seg / out['ell']['ms']!r} (the paper: 23-270x); bcoo / "
        f"tiled = {out['ratios']['bcoo / tiled']!r}, bcoo / ell = "
        f"{out['ratios']['bcoo / ell']!r}")
    return out


def table2(dev, sizes: Sizes, corpus, host: dict) -> dict:
    """10b: the paper's Table 2 at its own size — the host baselines (the
    exhaustive oracle, WAND and BMW from ``host``'s workers, Seismic here)
    against float64, and ``dense``, ``bcoo``, ``segment``, ``tiled`` and
    ``ell`` on the card against float64, µs a query each."""
    import numpy as np

    from repro_torch.core import RetrievalConfig, RetrievalEngine, seismic
    from repro_torch.core.metrics import mrr_at_k, ranking_overlap

    k, nq = sizes.table2_k, sizes.table2_queries
    docs, q = corpus.docs, corpus.queries
    want = f64_topk(docs, q, k)
    out = {}
    everyone = np.arange(nq)
    oracle = oracle_f64(docs, q, everyone)
    for name in ("dense", "bcoo", "segment", "tiled", "ell"):
        eng = RetrievalEngine(docs, RetrievalConfig(
            engine=name, k=k, term_block=512, doc_block=256,
            chunk_size=256), device=dev)
        vals, ids, ms = time_search(f"10b {name}", eng, q, k, sizes.rounds,
                                    dev)
        check_exact(f"10b {name}", vals, ids, oracle, everyone, k)
        out[name] = dict(us_per_query=1e3 * ms / nq,
                         overlap=ranking_overlap(ids, want[1], k))
    t0 = time.perf_counter()
    si = seismic.SeismicIndex.build(docs)
    log(f"  10b SeismicIndex build {time.perf_counter() - t0!r} s")
    overlaps = []
    for cut in sizes.seismic_cuts:
        t0 = time.perf_counter()
        _, ids = seismic.seismic_topk_cpu(q, si, k, query_cut=cut)
        secs = time.perf_counter() - t0
        ov = ranking_overlap(ids, want[1], k)
        mrr = mrr_at_k(ids, corpus.qrels, 10)
        overlaps.append(ov)
        log(f"  10b seismic cut {cut}: {1e6 * secs / nq!r} us a query "
            f"(host), overlap@{k} {ov!r}, MRR@10 {mrr!r}")
        out[f"seismic_cut{cut}"] = dict(us_per_query=1e6 * secs / nq,
                                        overlap=ov, mrr10=mrr)
    # tests/test_wand_baselines.py's bar: the smallest cut never beats
    # the largest (between neighbours the heap-factor pruning may trade a
    # few ids either way).
    if overlaps[0] > overlaps[-1] + 1e-9:
        raise AssertionError(f"10b: Seismic's overlap at the smallest cut "
                             f"beats the largest: {overlaps}")
    res = host_results(host["10b wand"], sizes.host_timeout_s)
    res.update(host_results(host["10b bmw"], sizes.host_timeout_s))
    for kind in ("exhaustive", "wand", "bmw"):
        row = host_exact(f"10b {kind} (host)", res[kind], want)
        row["us_per_query"] = 1e6 * row["s"] / nq
        log(f"  10b {kind}: {row['us_per_query']!r} us a query (host, "
            f"worker processes)")
        out[kind] = row
    return out


def wand_100k(sizes: Sizes, host: dict) -> dict:
    """10c: WAND and BMW at serve_100k on the host, each held to the
    exhaustive oracle on its queries (values within 1e-9, ids
    tie-aware)."""
    out = {}
    for kind in ("wand", "bmw"):
        res = host_results(host[f"10c {kind}"], sizes.host_timeout_s)
        ev, ei, _ = res["exhaustive"]
        vals, ids, secs = res[kind]
        same_results(f"10c {kind} vs exhaustive", (vals, ids), (ev, ei),
                     rtol=1e-9)
        out[kind] = dict(queries=res["queries"],
                         ms_per_query=1e3 * secs / res["queries"],
                         postings_build_s=res["build_s"])
        log(f"  10c {kind}: {out[kind]['ms_per_query']!r} ms a query over "
            f"{sizes.wand_docs} docs (host; {res['queries']} queries, k = "
            f"{sizes.k}; CpuPostings built in {res['build_s']!r} s)")
    return out


def system_comparison(dev, sizes: Sizes) -> dict:
    """Phase 10: 10b's and 10c's corpora made on the card and saved for
    the host baselines' worker processes (BMW on 10b's queries in two
    halves), then 10a (serve_1m) and 10b (Table 2) on the card while they
    work, then the host results collected and checked."""
    import multiprocessing
    import tempfile

    from repro_torch.data.synthetic import make_msmarco_like

    nq, half = sizes.table2_queries, sizes.table2_queries // 2
    t2 = make_msmarco_like(sizes.table2_docs, nq,
                           vocab_size=sizes.table2_vocab, seed=0, device=dev)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        big = make_msmarco_like(
            sizes.wand_docs, max(sizes.wand_queries, sizes.bmw_queries),
            vocab_size=sizes.vocab, seed=0, device=dev)
        b = dict(path=save_corpus(os.path.join(tmp, "table2.npz"), t2),
                 k=sizes.table2_k)
        c = dict(path=save_corpus(os.path.join(tmp, "100k.npz"), big),
                 k=sizes.k)
        del big
        jobs = {  # the longest first
            "10b bmw": [dict(b, rows=(0, half), kinds=("bmw",)),
                        dict(b, rows=(half, nq), kinds=("bmw",))],
            "10c bmw": [dict(c, rows=(0, sizes.bmw_queries),
                             kinds=("exhaustive", "bmw"))],
            "10c wand": [dict(c, rows=(0, sizes.wand_queries),
                              kinds=("exhaustive", "wand"))],
            "10b wand": [dict(b, rows=(0, nq), kinds=("exhaustive", "wand"))],
        }
        n = sum(len(parts) for parts in jobs.values())
        pool = multiprocessing.get_context("spawn").Pool(n)
        try:
            host = {name: [pool.apply_async(host_baseline, (job,))
                           for job in parts] for name, parts in jobs.items()}
            t0 = time.perf_counter()
            log(f"phase 10a: bcoo and segment beside tiled and ell at "
                f"serve_1m, {sizes.docs} docs x {sizes.queries} queries, "
                f"k={sizes.k} (the host baselines run meanwhile in {n} "
                f"worker processes)")
            out["10a"] = serve_1m_comparison(dev, sizes)
            out["10a seconds"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            log(f"phase 10b: Table 2, {sizes.table2_docs} docs x {nq} "
                f"queries, V={sizes.table2_vocab}, k={sizes.table2_k}; "
                f"host CPU: {host_cpu_name()}")
            out["10b"] = table2(dev, sizes, t2, host)
            out["10b seconds"] = time.perf_counter() - t0
            log("phase 10c: WAND and BMW at serve_100k on the host")
            out["10c"] = wand_100k(sizes, host)
        finally:
            pool.terminate()
            pool.join()
    out["host_cpu"] = host_cpu_name()
    log(f"  10a {out['10a seconds']:.1f} s, 10b {out['10b seconds']:.1f} s "
        f"(the host baselines' wait included)")
    return out

# ---------------------------------------------------------------------------
# Phase 11: every LM architecture of the registry


def arch_config(sizes: Sizes, arch: str, **cut):
    """``sizes.arch_config`` (``config`` or ``smoke_config``) of ``arch``'s
    ArchSpec, with ``cut`` replaced (a depth cut)."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = getattr(get_arch(arch), sizes.arch_config)
    return dataclasses.replace(cfg, **cut) if cut else cfg


def seeded_lm(cfg, dev, seed: int = 0):
    """``TransformerLM(cfg)`` on ``dev`` from a generator seeded there,
    logged with its size and init time."""
    import torch

    from repro_torch.models.transformer import TransformerLM

    t0 = time.perf_counter()
    lm = TransformerLM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))
    sync(dev)
    n = sum(p.numel() for p in lm.parameters())
    moe = cfg.moe
    log(f"  {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads} of {cfg.head_dim}, "
        f"d_ff={cfg.d_ff}, V={cfg.vocab_size}, qk_norm={cfg.qk_norm}, "
        f"window={cfg.sliding_window}, "
        f"experts={None if moe is None else (moe.num_experts, moe.top_k)}, "
        f"{cfg.dtype} compute over f32 parameters; num_params "
        f"{cfg.num_params()} ({n} held, {4 * n} B), active "
        f"{cfg.num_active_params()}; seeded init "
        f"{time.perf_counter() - t0:.3f} s")
    return lm


def flash_at(lm, tokens, dev, sizes: Sizes, label: str) -> dict:
    """``flash_attention`` on layer 0's own q, k, v of ``tokens``: the
    kernel against its plain version, then the kernel's time, the plain
    version's, one ``scaled_dot_product_attention`` call's (the window as
    a boolean mask over the kv heads repeated, where there is one) and the
    bound (as phase 5's)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import layers as L

    cfg = lm.cfg
    dt = cfg.compute_dtype
    p = lm.blocks[0].cast(dt)
    b, s = tokens.shape
    x = L.rms_norm(lm.embed_tokens(tokens).to(dt), p["ln_attn"],
                   cfg.norm_eps)
    q, k, v = L.qkv(p["attn"], x, cfg, torch.arange(s, device=dev))
    del x, p
    win = cfg.sliding_window
    err = flash_within(
        f"{label}: flash_attention, layer 0 at {tuple(q.shape)} {q.dtype}",
        flash_ops.flash_attention(q, k, v, True, win),
        flash_attention_ref(q, k, v, True, win))
    kernel_ms = event_ms(lambda: flash_ops.flash_attention(q, k, v, True,
                                                           win),
                         sizes.reps, dev)
    plain_ms = event_ms(lambda: flash_attention_ref(q, k, v, True, win), 1,
                        dev)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if win is None:
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION]):
            library_ms = event_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), sizes.reps,
                dev)
    else:
        g = cfg.n_heads // cfg.n_kv_heads
        kt, vt = (t.repeat_interleave(g, dim=1) for t in (kt, vt))
        i = torch.arange(s, device=dev)
        mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < win)
        library_ms = event_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), sizes.reps, dev)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    flops = attention_flops(b, s, cfg.n_heads, cfg.head_dim, win)
    peak = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else F32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    out = dict(shape=list(q.shape), kv_heads=cfg.n_kv_heads, window=win,
               dtype=str(q.dtype), max_abs_err=err, ms=kernel_ms,
               plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               launches_a_prefill=cfg.n_layers)
    log(f"  {label}: flash_attention at {tuple(q.shape)} over "
        f"{cfg.n_kv_heads} kv heads, window {win}, {q.dtype}: kernel "
        f"{kernel_ms!r} ms ({kernel_ms * cfg.n_layers!r} ms a prefill), "
        f"plain {plain_ms!r} ms, library (scaled_dot_product_attention) "
        f"{library_ms!r} ms, bound {out['bound_ms']!r} ms "
        f"({out['bound_by']}: {nbytes} B, {flops!r} flop); max_abs_err vs "
        f"plain {err!r}")
    return out


def prefill_arch(dev, sizes: Sizes, lm, b: int, s: int, label: str,
                 hold_f32: bool) -> dict:
    """``lm.prefill`` of b x s tokens through ``flash_attention`` (a
    warm-up and ``lm_rounds`` rounds, the counter zeroed before and read
    after: one launch a layer), the kernel at layer 0's shape
    (:func:`flash_at`), then the whole prefill against the plain path:
    bf16 logits within ARCH_BF16_DRIFTS times the plain path's own
    bf16-vs-f32 drift (phase 5's bar is one drift; whether it holds is
    printed), the argmax equal where the top-2 margin is clear, and with
    ``hold_f32`` the f32 logits within PREFILL_F32_RTOL of max |plain|
    (phase 5's f32 bar).  A MoE's f32 routing may flip a near-tied expert
    between the two orders of summation, which moves a token by a gate's
    share, so its f32 error is printed, not held."""
    import dataclasses

    import torch

    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.kernels.flash_attention import ops as flash_ops

    cfg = lm.cfg
    tokens = torch.from_numpy(make_lm_batch(b, s, cfg.vocab_size,
                                            seed=0)["tokens"]).to(dev)
    out = {}
    with torch.inference_mode():
        flash_ops.launches = 0
        got16, ms = host_rounds(f"{label}: prefill {b} x {s}",
                                lambda: lm.prefill(tokens), sizes.lm_rounds,
                                dev, b * s, unit="tokens/s")
        launches = flash_ops.launches
        calls = sizes.lm_rounds + 1
        log(f"  {label}: flash_attention launches {launches} in {calls} "
            f"prefill calls")
        if launches != calls * cfg.n_layers:
            raise AssertionError(f"{label}: flash_attention launched "
                                 f"{launches} times, not {cfg.n_layers} a "
                                 f"prefill")
        if (tuple(got16.shape) != (b, 1, cfg.vocab_size)
                or not bool(torch.isfinite(got16).all())):
            raise AssertionError(f"{label}: not finite [B, 1, V] logits")
        out["prefill"] = dict(ms=ms, tokens=b * s, launches=launches,
                              calls=calls)
        out["flash"] = flash_at(lm, tokens, dev, sizes, label)

        plain16 = lm.prefill(tokens, use_kernel=False)
        lm.cfg = dataclasses.replace(cfg, dtype="float32")
        try:
            got32 = lm.prefill(tokens)
            plain32 = lm.prefill(tokens, use_kernel=False)
        finally:
            lm.cfg = cfg
    e32 = float((got32 - plain32).abs().max())
    scale = float(plain32.abs().max())
    e16 = float((got16 - plain16).abs().max())
    drift = float((plain16 - plain32).abs().max())
    top2 = plain16[:, 0].topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    clear = margin > 2 * e16
    same = bool((got16[:, 0].argmax(-1) == plain16[:, 0].argmax(-1))[
        clear].all())
    log(f"  {label}: prefill {b} x {s}, kernel vs plain path: bf16 max err "
        f"{e16!r}, the plain path's own bf16-vs-f32 drift {drift!r} "
        f"(within one drift, phase 5's bar: {e16 <= drift}); f32 max err "
        f"{e32!r} (max |plain| {scale!r}, held: {hold_f32}); argmax equal "
        f"where the top-2 margin is clear: {same}")
    if (e16 > ARCH_BF16_DRIFTS * drift or not same
            or (hold_f32 and e32 > PREFILL_F32_RTOL * scale)):
        raise AssertionError(f"{label}: the kernel path disagrees with the "
                             f"plain path")
    out["check"] = dict(err16=e16, drift=drift, err32=e32, scale32=scale,
                        within_one_drift=e16 <= drift)
    return out


def moe_layer_vs_cpu(dev, sizes: Sizes, lm, label: str) -> dict:
    """Layer 0's ``moe_block`` in f32 on ``moe_cpu_len`` seeded normal
    tokens, on the card against the same call on the CPU: expert ids and
    the kept (token, slot) entries equal, the output within MOE_CPU_TOL of
    max |CPU|, the aux loss within 1e-6 relative."""
    import dataclasses

    import torch

    from repro_torch.models import layers as L

    cfg = dataclasses.replace(lm.cfg, dtype="float32")
    moe = cfg.moe
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((1, sizes.moe_cpu_len, cfg.d_model), generator=g,
                    device=dev)
    res = {}
    with torch.inference_mode():
        for where in ("card", "cpu"):
            p = {k: v.detach().to(where if where == "cpu" else dev)
                 for k, v in lm.blocks[0].moe.items()}
            xx = x.to(p["router"].device)
            t0 = time.perf_counter()
            out, aux = L.moe_block(p, xx, cfg)
            sync(dev)
            ms = 1e3 * (time.perf_counter() - t0)
            _, ids, _ = L.route(p, xx[0], moe)
            t = ids.shape[0]
            g_tok = L.moe_group_tokens(t, moe)
            pos = L.capacity_positions(ids.view(t // g_tok, g_tok, -1),
                                       moe.num_experts)
            kept = (pos < L.moe_capacity(g_tok, moe)).view(t, -1)
            res[where] = (out.cpu(), float(aux), ids.cpu(), kept.cpu(), ms)
            del p
    (go, ga, gi, gk, gms), (co, ca, ci, ck, cms) = res["card"], res["cpu"]
    err = float((go - co).abs().max())
    scale = float(co.abs().max())
    log(f"  {label}: layer 0's moe_block in f32 on {sizes.moe_cpu_len} "
        f"tokens, card {gms!r} ms vs CPU {cms!r} ms: max err {err!r} (max "
        f"|CPU| {scale!r}); aux {ga!r} vs {ca!r}; expert ids equal: "
        f"{torch.equal(gi, ci)}; kept entries equal: {torch.equal(gk, ck)} "
        f"({int((~ck).sum())} of {ck.numel()} dropped)")
    if (not torch.equal(gi, ci) or not torch.equal(gk, ck)
            or err > MOE_CPU_TOL * scale or abs(ga - ca) > 1e-6 * abs(ca)):
        raise AssertionError(f"{label}: moe_block on the card disagrees "
                             f"with the CPU")
    return dict(err=err, scale=scale, dropped=int((~ck).sum()),
                entries=ck.numel())


def decode_moe(dev, sizes: Sizes, lm, label: str) -> dict:
    """``decode_moe_steps`` decode steps for ``decode_moe_batch`` sequences
    from a cache whose first ``decode_moe_context`` slots hold seeded K/V;
    the (token, slot) entries dropped at capacity counted on each layer's
    dispatch (T = B tokens a step)."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.models import layers as L

    cfg = lm.cfg
    moe = cfg.moe
    db, ctx = sizes.decode_moe_batch, sizes.decode_moe_context
    steps = sizes.decode_moe_steps
    dropped, entries = [], []
    positions = L.capacity_positions

    def counting(expert_idx, num_experts):
        pos = positions(expert_idx, num_experts)
        dropped.append((pos >= L.moe_capacity(expert_idx.shape[1],
                                               moe)).sum())
        entries.append(pos.numel())
        return pos

    with torch.inference_mode():
        cache = lm.init_cache(db, ctx + steps)
        g = torch.Generator(device=dev).manual_seed(3)
        kv_shape = (db, ctx, cfg.n_kv_heads, cfg.head_dim)
        for li in range(cfg.n_layers):
            for name in ("k", "v"):
                cache[name][li, :, :ctx] = torch.randn(
                    kv_shape, generator=g, device=dev).to(cfg.compute_dtype)
        cache["pos"][:, :ctx] = torch.arange(ctx, dtype=torch.int32,
                                             device=dev)
        dtoks = torch.from_numpy(make_lm_batch(db, steps, cfg.vocab_size,
                                               seed=2)["tokens"]).to(dev)
        times = []
        L.capacity_positions = counting
        try:
            for i in range(steps):
                sync(dev)
                t0 = time.perf_counter()
                dl, cache = lm.decode_step(cache, dtoks[:, i], ctx + i)
                sync(dev)
                times.append(time.perf_counter() - t0)
        finally:
            L.capacity_positions = positions
    if (tuple(dl.shape) != (db, cfg.vocab_size)
            or not bool(torch.isfinite(dl).all())):
        raise AssertionError(f"{label}: decode: not finite [B, V] logits")
    n_drop = int(sum(int(d) for d in dropped))
    step_ms = 1e3 * float(np.median(times[1:]))
    log(f"  {label}: decode {db} x {steps} steps from {ctx} cached "
        f"positions: {step_ms!r} ms per step (median of steps 2-{steps}, "
        f"all {[1e3 * t for t in times]!r}); capacity "
        f"{L.moe_capacity(db, moe)} a expert per step's group of {db}: "
        f"{n_drop} of {sum(entries)} (token, slot) entries dropped over "
        f"{steps} steps x {cfg.n_layers} layers")
    del cache
    return dict(ms=step_ms, batch=db, context=ctx, steps=steps,
                dropped=n_drop, entries=sum(entries))


def train_archs(dev, sizes: Sizes) -> dict:
    """11d: ``launch.train.main`` at ``train_arch``'s width with
    checkpoints, its later checkpoints removed, then a restart: the
    restarted steps' losses bit for bit the unbroken run's (both under
    deterministic algorithms); one step of ``moe_arch`` at full width and
    ``moe_train_layers`` layers, aux included; ``make_ddp_train_step``
    under an NCCL group of one: uncompressed, bit for bit
    ``make_train_step``; compressed, its loss and error buffer."""
    import dataclasses
    import shutil
    import signal
    import socket
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.data.pipeline import lm_batch_fn
    from repro_torch.launch import train as train_main
    from repro_torch.train import (AdamWConfig, init_state,
                                   make_ddp_train_step, make_train_step)
    from repro_torch.train.train_loop import to_device

    out = {}
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    torch.use_deterministic_algorithms(True)
    try:
        argv = ["--arch", sizes.train_arch, "--device", dev.type,
                "--checkpoint-dir", tmp, *sizes.train_args]
        if sizes.arch_config == "smoke_config":
            argv.append("--smoke")
        t0 = time.perf_counter()
        unbroken = train_main.main(argv)
        first_s = time.perf_counter() - t0
        every = int(argv[argv.index("--checkpoint-every") + 1])
        for name in os.listdir(tmp):
            if int(name.split("_")[1]) > every:
                shutil.rmtree(os.path.join(tmp, name))
        restarted = train_main.main(argv)
    finally:
        torch.use_deterministic_algorithms(False)
        for s, h in handlers.items():
            signal.signal(s, h)
        shutil.rmtree(tmp, ignore_errors=True)
    want = [m["loss"] for m in unbroken[every:]]
    got = [m["loss"] for m in restarted]
    log(f"  11d launch.train {' '.join(argv[:2])} {' '.join(sizes.train_args)}"
        f": {len(unbroken)} steps in {first_s:.3f} s, losses "
        f"{[m['loss'] for m in unbroken]!r}; restarted from step {every}: "
        f"{got!r}")
    if got != want:
        raise AssertionError("launch.train: the restart's losses are not "
                             "the unbroken run's")
    out["launch_train"] = dict(losses=[m["loss"] for m in unbroken],
                               restarted=got, seconds=first_s)

    # one MoE step at full width, depth cut
    cfg = arch_config(sizes, sizes.moe_arch, n_layers=sizes.moe_train_layers)
    torch.cuda.reset_peak_memory_stats(dev)
    lm = seeded_lm(cfg, dev)
    batch = lm_batch_fn(1, sizes.moe_train_len, cfg.vocab_size)(0, 0)
    with torch.no_grad():
        total, parts = lm.loss_fn(to_device(batch, dev))
    adamw = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    clock = StepClock(make_train_step(lm.loss_fn, adamw), dev)
    state = init_state(dict(lm.named_parameters()), adamw).as_dict()
    losses = [float(clock(state, batch)[1]["loss"])
              for _ in range(sizes.moe_train_steps)]
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"  11d {cfg.name} x {cfg.n_layers} layers, 1 x "
        f"{sizes.moe_train_len} tokens: ce {float(parts['ce'])!r} + aux "
        f"{float(parts['aux'])!r} = {float(total)!r}; step losses "
        f"{losses!r}, ms {clock.ms!r}; peak {peak} B")
    if not (float(parts["aux"]) > 0 and abs(losses[0] - float(total))
            <= TRAIN_LOSS_RTOL * abs(float(total))):
        raise AssertionError(f"{cfg.name}: the step's loss is not ce + aux")
    out["moe_step"] = dict(ms=clock.ms, losses=losses,
                           ce=float(parts["ce"]), aux=float(parts["aux"]),
                           peak_bytes=peak, layers=cfg.n_layers)
    del lm, state, clock
    torch.cuda.empty_cache()

    # make_ddp_train_step under an NCCL group of one
    cfg = arch_config(sizes, sizes.train_arch)
    batches = [lm_batch_fn(8, 64, cfg.vocab_size)(0, i)
               for i in range(sizes.ddp_steps)]
    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        port = s_.getsockname()[1]
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    torch.use_deterministic_algorithms(True)
    try:
        runs = {}
        for mode in ("single", "ddp", "compressed"):
            lm = seeded_lm(cfg, dev)
            adamw = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
            step = (make_train_step(lm.loss_fn, adamw) if mode == "single"
                    else make_ddp_train_step(lm.loss_fn, adamw,
                                             compress=mode == "compressed"))
            clock = StepClock(step, dev)
            state = init_state(dict(lm.named_parameters()), adamw).as_dict()
            losses = []
            for b_ in batches:
                state, m = clock(state, b_)
                losses.append(float(m["loss"]))
            runs[mode] = (losses, {k: v.detach().clone()
                                   for k, v in lm.named_parameters()},
                          state.get("err_buf"), clock.ms)
            del lm
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    (l1, p1, _, ms1), (l2, p2, _, ms2) = runs["single"], runs["ddp"]
    lc, _, err_buf, msc = runs["compressed"]
    same = l1 == l2 and all(torch.equal(p1[k], p2[k]) for k in p1)
    err_bytes = sum(e.numel() * e.element_size() for e in err_buf.values())
    log(f"  11d make_ddp_train_step under NCCL of 1, {cfg.name}: "
        f"uncompressed losses {l2!r} vs make_train_step {l1!r}, bit for "
        f"bit (losses and parameters): {same}; ms {ms2!r} vs {ms1!r}; "
        f"compressed losses {lc!r}, ms {msc!r}, err_buf {len(err_buf)} "
        f"leaves, {err_bytes} B")
    if not same:
        raise AssertionError("make_ddp_train_step at world size 1 is not "
                             "make_train_step")
    out["ddp"] = dict(losses=l2, single_losses=l1, compressed_losses=lc,
                      bitwise=same, err_buf_bytes=err_bytes, ms=ms2,
                      single_ms=ms1, compressed_ms=msc)
    return out


def lm_archs(dev, sizes: Sizes) -> dict:
    """Phase 11: 11a ``moe_arch`` at full width and depth (prefill, the
    kernel at layer 0, decode with drops, one layer on the card against
    the CPU), 11b ``swa_arch`` at full width and ``swa_layers`` layers
    (prefill over the window), 11c ``dense_arch`` at full width and depth
    (Dh 128 with qk_norm), 11d training (:func:`train_archs`)."""
    import torch

    out = {"card": card_line() if dev.type == "cuda" else "cpu"}
    log(f"  tf32 in matmuls: {torch.backends.cuda.matmul.allow_tf32}")

    t0 = time.perf_counter()
    lm = seeded_lm(arch_config(sizes, sizes.moe_arch), dev)
    label = f"11a {lm.cfg.name}"
    run = prefill_arch(dev, sizes, lm, sizes.moe_batch, sizes.moe_len, label,
                       hold_f32=False)
    run["decode"] = decode_moe(dev, sizes, lm, label)
    run["layer_vs_cpu"] = moe_layer_vs_cpu(dev, sizes, lm, label)
    run["seconds"] = time.perf_counter() - t0
    out[lm.cfg.name] = run
    del lm
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    lm = seeded_lm(arch_config(sizes, sizes.swa_arch,
                               n_layers=sizes.swa_layers), dev)
    run = prefill_arch(dev, sizes, lm, 1, sizes.swa_len,
                       f"11b {lm.cfg.name} x {lm.cfg.n_layers} layers",
                       hold_f32=False)
    run["layers"] = lm.cfg.n_layers
    run["seconds"] = time.perf_counter() - t0
    out[lm.cfg.name] = run
    del lm
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    lm = seeded_lm(arch_config(sizes, sizes.dense_arch), dev)
    run = prefill_arch(dev, sizes, lm, 1, sizes.dense_len,
                       f"11c {lm.cfg.name}", hold_f32=True)
    run["seconds"] = time.perf_counter() - t0
    out[lm.cfg.name] = run
    del lm
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    out["training"] = train_archs(dev, sizes)
    out["training"]["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Phase 12: SchNet at full width and the cell layer's dry run


def dryrun_cell(cell: tuple) -> dict:
    """12b's and 13c's job, in a worker process: the meta count of one
    cell, ``(arch, shape)`` at ``"single"`` or ``(arch, shape, layout,
    expert_parallel)`` (``launch.dryrun.run_cell``, nothing saved) -> the
    numbers of its table row, or its error.  Touches no card."""
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    import torch

    from repro_torch.launch import dryrun

    torch.set_num_threads(1)
    arch, shape, layout, ep = (*cell, "single", False)[:4]
    t0 = time.perf_counter()
    try:
        art = dryrun.run_cell(arch, shape, layout, save=False, verbose=False,
                              expert_parallel=ep)
    except Exception as e:  # listed by the caller, which then fails
        return {"arch": arch, "shape": shape, "error": repr(e)}
    roof = art["roofline"]
    return {"arch": arch, "shape": shape, "layout": layout, "ep": ep,
            "coll_bytes": art["collectives"]["total_bytes"],
            "model_flops": art["model_flops"],
            "flops": art["cost"]["flops"], "bytes": art["cost"]["bytes"],
            "peak_bytes": art["cost"]["peak_bytes"], "fits": art["fits"],
            "compute": roof["compute"], "useful_ratio": roof["useful_ratio"],
            "dominant": roof["dominant"],
            "bound_ms": 1e3 * max(roof["t_compute_s"], roof["t_memory_s"],
                                  roof["t_collective_s"]),
            "seconds": time.perf_counter() - t0}


def count_cells(pool, jobs: list) -> list:
    """``dryrun_cell`` of each job in ``pool``, the results in the jobs'
    order; the LM training cells (each some 25 s of probes, the rest a
    few) are handed out first, so that none starts last."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.cells import shape_of

    def slow(job):
        spec = get_arch(job[0])
        return spec.family == "lm" and shape_of(spec, job[1]).kind == "train"

    ordered = sorted(jobs, key=lambda job: not slow(job))
    return pool.map_async(dryrun_cell, ordered, chunksize=1), ordered


def counted_cells(pending, jobs: list, timeout: float) -> list:
    """The results of :func:`count_cells`, in the order of ``jobs``."""
    result, ordered = pending
    by_job = dict(zip(ordered, result.get(timeout)))
    return [by_job[job] for job in jobs]


def within(name: str, got, want, tol: float) -> float:
    """max |got - want| / max |want|, raising above ``tol`` (both finite,
    of one shape)."""
    import torch

    got = got.to(want.device)
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite output")
    rel = float((got - want).abs().max()) / max(float(want.abs().max()),
                                                1e-30)
    log(f"  {name}: card vs CPU, max rel err {rel!r} (<= {tol})")
    if not rel <= tol:
        raise AssertionError(f"{name}: the card and the CPU disagree "
                             f"(rel {rel} > {tol})")
    return rel


def schnet_cell(dev, sizes: Sizes, name: str, est: dict) -> dict:
    """12a: one GNN_SHAPES cell at FULL width on the card, built by the
    cell layer (``launch.cells.make_cell`` on ``dev``: seeded weights and
    ``gnn_batch``'s graph; minibatch_lg samples a CSR of
    ``reddit_nodes`` x ``reddit_edges``): the card against the CPU
    (full_graph_sm: one step's loss and gradients; minibatch_lg: the
    forward), then a warm-up and ``schnet_steps`` train steps of the
    cell's step timed with CUDA events, the peak of
    ``max_memory_allocated`` (and what earlier phases held before the
    cell), the model FLOPs over the median step against the f32 peak, and
    the dry run's count (``est``) beside them."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.analysis.roofline import PEAK_FLOPS
    from repro_torch.configs import get_arch
    from repro_torch.launch.cells import make_cell, shape_of
    from repro_torch.models.schnet import SchNet

    spec = get_arch("schnet")
    shape = shape_of(spec, name)
    if shape.kind == "gnn_minibatch":
        shape = dataclasses.replace(shape, n_nodes=sizes.reddit_nodes,
                                    n_edges=sizes.reddit_edges)
    held = torch.cuda.memory_allocated(dev)  # what earlier phases left
    t0 = time.perf_counter()
    cell = make_cell(spec, shape, "single", dev, seed=0)
    sync(dev)
    model, (state, dbatch) = cell.model, cell.args
    out = {"data_s": time.perf_counter() - t0,
           **{k: cell.meta[k] for k in ("graph_nodes", "graph_edges",
                                        "seeds", "sampled_nodes",
                                        "sampled_edges") if k in cell.meta}}
    log(f"  {name}: cell built in {out['data_s']:.3f} s {cell.meta}")
    if name in ("full_graph_sm", "minibatch_lg"):
        batch = {k: v.cpu() for k, v in dbatch.items()}
        cpu = SchNet(model.cfg, device="cpu")
        cpu.load_state_dict(model.state_dict())
        if name == "full_graph_sm":
            loss, grads = loss_and_grads(model, model.loss_fn, dbatch, dev)
            closs, cgrads = loss_and_grads(cpu, cpu.loss_fn, batch, "cpu")
            rel = abs(loss - closs) / max(abs(closs), 1e-30)
            log(f"  {name}: one step's loss card {loss!r} vs CPU {closs!r} "
                f"(rel {rel!r} <= {TRAIN_LOSS_RTOL})")
            if not rel <= TRAIN_LOSS_RTOL:
                raise AssertionError(f"{name}: loss card vs CPU rel {rel}")
            out["grad_rel_err"] = grads_within(name, grads, cgrads,
                                               TRAIN_GRAD_TOL)
            log(f"  {name}: gradients within {out['grad_rel_err']!r} of "
                f"each leaf's max (<= {TRAIN_GRAD_TOL})")
            out["loss_rel_err"] = rel
        else:
            keys = ("node_feat", "senders", "receivers", "distances")
            with torch.no_grad():
                got = model(*(dbatch[k] for k in keys))
                want = cpu(*(batch[k] for k in keys))
            out["forward_rel_err"] = within(f"{name} forward", got, want,
                                            RECSYS_TOL)
        del cpu, batch
    torch.cuda.reset_peak_memory_stats(dev)
    ms, losses = [], []
    for _ in range(1 + sizes.schnet_steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = cell.step_fn(state, dbatch)
        end.record()
        sync(dev)
        ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: non-finite loss {losses}")
    med = float(np.median(ms[1:]))
    peak = torch.cuda.max_memory_allocated(dev)
    share = est["model_flops"] / (med * 1e-3) / PEAK_FLOPS["f32"]
    out.update(ms=med, step_ms=ms, losses=losses, peak_bytes=peak,
               held_bytes=held, model_flops=est["model_flops"],
               flop_share=share,
               est_peak_bytes=est["peak_bytes"], bound_ms=est["bound_ms"],
               bound_by=est["dominant"], counted_flops=est["flops"],
               counted_bytes=est["bytes"])
    log(f"  {name}: {med!r} ms a step (median of steps 2-{len(ms)}, all "
        f"{ms!r}), losses {losses!r}; peak {peak} B, {held} B of it held "
        f"before the cell (the dry run's estimate {est['peak_bytes']!r} "
        f"B); model FLOPs {est['model_flops']!r} "
        f"-> {share!r} of {PEAK_FLOPS['f32']:.4g} FLOP/s; the dry run's "
        f"unfused count {est['bound_ms']!r} ms ({est['dominant']}: "
        f"{est['flops']!r} flop counted, {est['bytes']!r} B)")
    del model, state, dbatch, cell
    torch.cuda.empty_cache()
    return out


def schnet_phase(dev, sizes: Sizes) -> dict:
    """Phase 12: 12a runs the SchNet cells on the card (ogb_products is
    not run: the dry run must say it does not fit) with no other work on
    the host, then 12b counts every ``"single"`` cell on ``meta`` in
    ``dryrun_workers`` processes and prints the table; every cell must
    count."""
    import multiprocessing

    import torch

    from repro_torch.analysis.roofline import HBM_BYTES
    from repro_torch.launch.cells import all_cells

    total = torch.cuda.get_device_properties(dev).total_memory \
        if dev.type == "cuda" else HBM_BYTES
    log(f"  the card's memory: {total} B (analysis.roofline.HBM_BYTES "
        f"{HBM_BYTES}); deterministic algorithms: "
        f"{torch.are_deterministic_algorithms_enabled()} (index_add_ "
        f"accumulates with atomics); tf32 in matmuls: "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    out = {"12a": {}}
    t0 = time.perf_counter()
    # the SchNet cells' counts first (small), for 12a's comparisons
    est = {s: dryrun_cell(("schnet", s))
           for s in (*sizes.schnet_cells, "ogb_products")}
    for name in sizes.schnet_cells:
        log(f"phase 12a: schnet {name} at FULL width, f32, "
            f"{sizes.schnet_steps} timed train steps")
        out["12a"][name] = schnet_cell(dev, sizes, name, est[name])
    ogb = est["ogb_products"]
    e = 61_859_140
    log(f"  ogb_products: not run: its rbf [{e}, 300] f32 alone is "
        f"{e * 300 * 4} B and each [E, 64] f32 activation {e * 64 * 4} "
        f"B; the dry run's peak {ogb['peak_bytes']!r} B against the "
        f"card's {total} B: fits={ogb['fits']}")
    if ogb["fits"] or ogb["peak_bytes"] <= total:
        raise AssertionError("the dry run says ogb_products fits")
    out["12a"]["ogb_products"] = {"run": False, **ogb}
    out["12a seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cells = all_cells()
    pool = multiprocessing.get_context("spawn").Pool(sizes.dryrun_workers)
    try:
        rows = counted_cells(count_cells(pool, cells), cells, None)
    finally:
        pool.terminate()
        pool.join()
    out["12b seconds"] = time.perf_counter() - t0
    log(f"phase 12b: the meta dry run of {len(cells)} cells at 'single' "
        f"({sizes.dryrun_workers} worker processes, "
        f"{out['12b seconds']:.3f} s)")
    log(f"  {'arch':<14} {'shape':<14} {'model flops':>12} {'counted':>12} "
        f"{'useful':>8} {'bytes':>12} {'est peak B':>12} {'fits':>5} "
        f"{'dominant':>8} {'bound ms':>12} {'s':>6}")
    failed = [r for r in rows if "error" in r]
    for r in rows:
        if "error" in r:
            log(f"  {r['arch']:<14} {r['shape']:<14} FAILED: {r['error']}")
            continue
        log(f"  {r['arch']:<14} {r['shape']:<14} {r['model_flops']:>12.4g} "
            f"{r['flops']:>12.4g} {r['useful_ratio']:>8.3f} "
            f"{r['bytes']:>12.4g} {r['peak_bytes']:>12.4g} "
            f"{str(r['fits']):>5} {r['dominant']:>8} {r['bound_ms']:>12.4g} "
            f"{r['seconds']:>6.1f}")
    if failed:
        raise AssertionError(f"{len(failed)} cells did not count: "
                             f"{[(r['arch'], r['shape']) for r in failed]}")
    out["12b"] = rows
    return out



# ---------------------------------------------------------------------------
# Phase 13: tensor and expert parallelism


def free_port() -> int:
    import socket

    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        return s_.getsockname()[1]


def seeded_cache(lm, batch: int, ctx: int, steps: int, dev, seed: int):
    """``lm``'s cache for ``batch`` sequences of ``ctx + steps`` slots whose
    first ``ctx`` hold seeded K/V (bf16-rounded normals, the same numbers
    in any compute dtype) at positions 0..ctx-1; under a policy the
    rank's block of the same whole cache."""
    import torch

    from repro_torch.sharding import policies as pol

    cfg = lm.cfg
    cache = lm.init_cache(batch, ctx + steps)
    s = ctx + steps
    g = torch.Generator(device=dev).manual_seed(seed)
    pl = None
    if lm.policy is not None:
        pl = lm.policy.placements(pol.lm_cache_dims(
            lm.policy, batch, s, cfg.n_kv_heads)["k"])
    for li in range(cfg.n_layers):
        for name in ("k", "v"):
            full = torch.zeros((1, batch, s, cfg.n_kv_heads, cfg.head_dim),
                               dtype=cfg.compute_dtype, device=dev)
            full[0, :, :ctx] = torch.randn(
                (batch, ctx, cfg.n_kv_heads, cfg.head_dim), generator=g,
                device=dev).to(torch.bfloat16).to(cfg.compute_dtype)
            if pl is not None:
                full = pol.shard_leaf(full, pl, lm.policy.mesh, lm.coords)
            cache[name][li].copy_(full[0])
            del full
    cache["pos"][:, :ctx] = torch.arange(ctx, dtype=torch.int32, device=dev)
    return cache


def tp_cases(dev, sizes: Sizes, policy_of=None) -> dict:
    """13b's cases on one rank (``policy_of(cfg, ep)`` -> its policy) or,
    with ``policy_of`` None, on the whole model: each case's outputs (CPU
    tensors), ms a call (host clock, synchronised: a warm-up and
    ``TP_ROUNDS`` calls, the median), peak device memory and the kernels'
    launches a call.  The same seeds give every rank its shards of the
    single run's weights."""
    import contextlib
    import dataclasses
    import importlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.data.synthetic import make_lm_batch, make_recsys_batch
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import layers as L
    from repro_torch.models.recsys import build_model
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.sharding import ctx

    card = dev.type == "cuda"  # on the CPU (a rehearsal) no memory stats

    def wait():
        if card:
            sync(dev)

    def peak():
        return torch.cuda.max_memory_allocated(dev) if card else None

    def release():
        if card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

    def timed_calls(fn):
        out = fn()
        wait()
        times = []
        for _ in range(TP_ROUNDS):
            t0 = time.perf_counter()
            out = fn()
            wait()
            times.append(time.perf_counter() - t0)
        return out, 1e3 * float(np.median(times))

    def lm_of(cfg, ep=False):
        release()
        return TransformerLM(
            cfg, device=dev,
            generator=torch.Generator(device=dev).manual_seed(0),
            policy=None if policy_of is None else policy_of(cfg, ep))

    def heads(lm):
        dh = lm.cfg.head_dim
        attn = lm.blocks[0].attn
        return [attn["wq"].shape[1] // dh, attn["wk"].shape[1] // dh]

    def lm_case(cfg) -> dict:
        """A prefill of 1 x ``tp_prefill_len``, then ``tp_decode_steps``
        decode steps of ``tp_decode_batch`` sequences from the seeded
        cache."""
        lm = lm_of(cfg)
        tokens, dtoks = (torch.from_numpy(make_lm_batch(
            b, s, cfg.vocab_size, seed=seed)["tokens"]).to(dev)
            for b, s, seed in ((1, sizes.tp_prefill_len, 0),
                               (sizes.tp_decode_batch,
                                sizes.tp_decode_steps, 2)))
        flash_ops.launches = 0
        logits, ms = timed_calls(lambda: lm.prefill(tokens))
        case = {"prefill": logits.cpu(), "prefill_ms": ms,
                "flash_per_prefill": flash_ops.launches
                / (TP_ROUNDS + 1), "heads": heads(lm)}
        cache = seeded_cache(lm, sizes.tp_decode_batch,
                             sizes.tp_decode_context, sizes.tp_decode_steps,
                             dev, seed=3)
        steps, times = [], []
        for i in range(sizes.tp_decode_steps):
            wait()
            t0 = time.perf_counter()
            dl, cache = lm.decode_step(cache, dtoks[:, i],
                                       sizes.tp_decode_context + i)
            wait()
            times.append(time.perf_counter() - t0)
            steps.append(dl.cpu())
        case.update(decode=torch.stack(steps), cache_seq=lm.cache_seq,
                    decode_ms=1e3 * float(np.median(times[1:])),
                    peak=peak())
        return case

    out = {}
    with torch.inference_mode():
        # qwen3-4b in bf16 and f32; smollm-135m in f32 (split heads, the
        # cache split by sequence)
        cfg = arch_config(sizes, sizes.dense_arch)
        for dt in ("bfloat16", "float32"):
            out[f"{cfg.name} {dt}"] = lm_case(dataclasses.replace(cfg,
                                                                  dtype=dt))
        cfg = arch_config(sizes, TP_SEQ_ARCH)
        out[f"{cfg.name} float32"] = lm_case(dataclasses.replace(
            cfg, dtype="float32"))

        # olmoe-1b-7b: prefill under TP inside the experts, then EP
        cfg = arch_config(sizes, sizes.moe_arch)
        tokens = torch.from_numpy(make_lm_batch(
            sizes.tp_moe_batch, sizes.tp_moe_len, cfg.vocab_size,
            seed=0)["tokens"]).to(dev)
        runs = (("bfloat16", False), ("float32", False)) if policy_of is None \
            else (("bfloat16", False), ("bfloat16", True))
        for dt, ep in runs:
            lm = lm_of(dataclasses.replace(cfg, dtype=dt), ep)
            flash_ops.launches = 0
            lm.routes = []
            logits, ms = timed_calls(lambda: lm.prefill(tokens))
            last = lm.routes[-cfg.n_layers:]  # the last call's layers
            ids = torch.stack([r[0] for r in last]).cpu()
            kept = torch.stack([r[1] for r in last]).cpu()
            lm.routes = None
            # layer 0's experts in f32 on the same seeded tokens
            x = torch.randn((1, sizes.moe_cpu_len, cfg.d_model),
                            generator=torch.Generator(device=dev).manual_seed(
                                4), device=dev)
            layer_routes = []
            p = lm.layer(0, torch.float32)["moe"]
            with (contextlib.nullcontext() if lm.policy is None
                  else ctx.axes(lm.policy.mesh, lm.policy.dp, lm.policy.tp)):
                y, _ = L.moe_block(p, x, lm.cfg, lm.tp, layer_routes)
            out[f"{cfg.name} {dt}{' ep' if ep else ''}"] = {
                "prefill": logits.cpu(), "prefill_ms": ms, "ids": ids,
                "kept": kept, "heads": heads(lm), "layer0": y.cpu(),
                "layer0_ids": layer_routes[0][0].cpu(),
                "layer0_kept": layer_routes[0][1].cpu(),
                "experts": list(lm.blocks[0].moe["w_gate"].shape),
                "flash_per_prefill": flash_ops.launches
                / (TP_ROUNDS + 1), "peak": peak()}
            del lm

        # xDeepFM and AutoInt at serve_p99, tables row-sharded; a batch
        # is split over every rank
        n, r = ((1, 0) if policy_of is None
                else (dist.get_world_size(), dist.get_rank()))
        for name in sizes.tp_recsys_models:
            cfg = getattr(importlib.import_module(
                f"repro_torch.configs.{name}"), sizes.recsys_config)
            release()
            model = build_model(cfg, device=dev, seed=0,
                                policy=None if policy_of is None
                                else policy_of(cfg, False))
            for hot in sizes.hots:
                batch = to_device(make_recsys_batch(
                    sizes.serve_batch, cfg.n_sparse, cfg.vocab_sizes,
                    cfg.seq_len, cfg.item_vocab, multi_hot=hot, seed=0), dev)
                b = sizes.serve_batch // n
                mine = {k: v[r * b:(r + 1) * b] for k, v in batch.items()}
                bag_ops.launches = 0
                logits, ms = timed_calls(lambda: model(mine))
                out[f"{cfg.name} H={hot}"] = {
                    "logits": logits.cpu(), "ms": ms,
                    "rows": [r * b, (r + 1) * b],
                    "bag_per_call": bag_ops.launches / (TP_ROUNDS + 1),
                    "sharded": sorted(model.first), "peak": peak()}
            del model
    release()
    return out


def tp_rank(rank: int, world: int, port: int, path: str, dev_type: str,
            sizes: Sizes) -> None:
    """13b's rank ``rank`` of ``world`` on card 0 over gloo (a spawned
    process): its cases under the (1, world) mesh, written to ``path``."""
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding.policies import make_policy

    dev = torch.device(dev_type, 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        collectives = gloo_cuda_collectives(dev)
        mesh = make_debug_mesh(1, world, device_type=dev.type)
        t0 = time.perf_counter()
        out = tp_cases(dev, sizes, lambda cfg, ep: make_policy(
            mesh, expert_parallel=ep))
        out["seconds"] = time.perf_counter() - t0
        out["gloo_cuda"] = collectives
    finally:
        dist.destroy_process_group()
    torch.save(out, path)


def gloo_cuda_collectives(dev) -> dict:
    """Which collectives the gloo group in use (13b's ranks) carries for
    tensors on ``dev`` under the installed PyTorch: each run across the
    ranks (rank r holds ``8 r .. 8 r + 7``) and its result checked.  A
    refusal raises on every rank alike, before any transfer."""
    import torch
    import torch.distributed as dist

    n, r = dist.get_world_size(), dist.get_rank()

    def of(rank, dtype=torch.float32):
        return torch.arange(8 * rank, 8 * rank + 8, device=dev).to(dtype)

    every = torch.cat([of(q) for q in range(n)])
    w = 8 // n  # the block a rank gets of an 8-long tensor

    def reduced(op, dtype=torch.float32):
        def run():
            x = of(r, dtype)
            dist.all_reduce(x, op=op)
            return x
        want = torch.stack([of(q, dtype) for q in range(n)])
        return run, (want.sum(0) if op == dist.ReduceOp.SUM
                     else want.amax(0)).to(dtype)

    def listed():
        parts = [torch.empty(8, device=dev) for _ in range(n)]
        dist.all_gather(parts, of(r))
        return torch.cat(parts)

    def into():
        out = torch.empty(8 * n, device=dev)
        dist.all_gather_into_tensor(out, of(r))
        return out

    def scattered():
        out = torch.empty(w, device=dev)
        dist.reduce_scatter_tensor(out, of(r))
        return out

    def to_all():
        out = torch.empty(8, device=dev)
        dist.all_to_all_single(out, of(r))
        return out

    def broadcast():
        x = of(r)
        dist.broadcast(x, 0)
        return x

    tries = {
        "all_reduce SUM f32": reduced(dist.ReduceOp.SUM),
        "all_reduce MAX f32": reduced(dist.ReduceOp.MAX),
        "all_reduce SUM bf16": reduced(dist.ReduceOp.SUM, torch.bfloat16),
        "all_reduce SUM int32": reduced(dist.ReduceOp.SUM, torch.int32),
        "broadcast": (broadcast, of(0)),
        "all_gather (list)": (listed, every),
        "all_gather_into_tensor": (into, every),
        "reduce_scatter_tensor": (scattered, sum(
            of(q)[r * w:(r + 1) * w] for q in range(n))),
        "all_to_all_single": (to_all, torch.cat(
            [of(q)[r * w:(r + 1) * w] for q in range(n)])),
    }
    out = {}
    for name, (fn, want) in tries.items():
        try:
            got = fn()
            out[name] = (True if torch.equal(got, want)
                         else f"wrong values: {got.tolist()}")
        except (RuntimeError, ValueError) as e:
            out[name] = f"refused: {str(e).splitlines()[0][:160]}"
    return out


def held_to(name: str, got, want, bar: float) -> float:
    """max |got - want| against ``bar`` (raises above it)."""
    err = float((got - want).abs().max())
    log(f"    {name}: max err {err!r} (bar {bar!r})")
    if not err <= bar:
        raise AssertionError(f"{name}: {err!r} > {bar!r}")
    return err


def tp_phase(dev, sizes: Sizes) -> dict:
    """Phase 13: 13a one NCCL rank (mesh 1 x 1) bit for bit the unsharded
    qwen3-4b prefill; 13b two gloo ranks on card 0 (mesh 1 x 2) held to
    the single-rank run of the same weights; 13c the meta dry run of every
    cell at ``quad_tp`` (the MoE cells with ``--expert-parallel`` too)."""
    import multiprocessing
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.cells import all_cells
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.sharding.policies import make_policy

    out = {}
    t0 = time.perf_counter()

    # 13a: the policy's path at model 1 under an NCCL group of one
    cfg = arch_config(sizes, sizes.dense_arch)
    tokens = torch.from_numpy(make_lm_batch(
        1, sizes.tp_prefill_len, cfg.vocab_size, seed=0)["tokens"]).to(dev)
    with torch.inference_mode():
        lm = TransformerLM(cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(0))
        want = lm.prefill(tokens)
        del lm
        torch.cuda.empty_cache()
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
            world_size=1)
        try:
            lm = TransformerLM(cfg, device=dev, generator=torch.Generator(
                device=dev).manual_seed(0), policy=make_policy(
                    make_debug_mesh(1, 1, device_type=dev.type)))
            flash_ops.launches = 0
            got = lm.prefill(tokens)
            launches = flash_ops.launches
            del lm
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    same = torch.equal(got, want)
    log(f"  13a {cfg.name} prefill 1 x {sizes.tp_prefill_len} bf16, mesh "
        f"1 x 1 under NCCL: logits bit for bit the unsharded model's: "
        f"{same}; flash_attention launches {launches}")
    if not same or (dev.type == "cuda" and launches != cfg.n_layers):
        raise AssertionError("13a: the policy's path at model 1 is not the "
                             "unsharded model's")
    out["13a"] = {"bitwise": same, "flash_launches": launches,
                  "seconds": time.perf_counter() - t0}
    del got, want

    # 13b: the single-rank references, then two gloo ranks
    t1 = time.perf_counter()
    ref = tp_cases(dev, sizes)
    torch.cuda.empty_cache()
    out["13b single seconds"] = time.perf_counter() - t1
    tmp = tempfile.mkdtemp(prefix="tp_phase")
    world = TP_RANKS
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    paths = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
    # the ranks run without the workspace setting main() makes for
    # phase 7's deterministic algorithms: it slows small steps
    saved = os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
    t1 = time.perf_counter()
    try:
        procs = [ctx.Process(target=tp_rank, args=(
            r, world, port, paths[r], dev.type, sizes)) for r in range(world)]
        for p in procs:
            p.start()
    finally:
        if saved is not None:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved
    try:
        for p in procs:
            p.join(TP_TIMEOUT_S)
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            raise AssertionError(f"13b: the ranks exited with {codes}")
        ranks = [torch.load(p_, weights_only=False) for p_ in paths]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    out["13b ranks seconds"] = time.perf_counter() - t1
    # the collectives gloo carried for CUDA tensors between the two ranks;
    # the sharded paths use the all-reduces and the list all_gather
    out["gloo_cuda"] = ranks[0].pop("gloo_cuda")
    log(f"  gloo with {dev.type} tensors across {world} ranks (torch "
        f"{torch.__version__}): {json.dumps(out['gloo_cuda'])}")
    used = ("all_reduce SUM f32", "all_reduce MAX f32", "all_gather (list)")
    others = [got.pop("gloo_cuda") for got in ranks[1:]]
    if any(o != out["gloo_cuda"] for o in others) or any(
            out["gloo_cuda"][k] is not True for k in used):
        raise AssertionError("13b: gloo refused or garbled a collective "
                             "the sharded paths use")
    label = "two ranks sharing one card, gloo"
    checks = {}  # each comparison's [max err, bar]

    def held(name, got, want, bar):
        checks[name] = [held_to(name, got, want, bar), bar]

    rows = {}
    for key, want in ref.items():
        got_keys = [k for k in ranks[0] if k.startswith(key)]
        for gk in got_keys:
            rows[gk] = row = {"single_ms": {k: v for k, v in want.items()
                                            if k.endswith("ms")},
                              "single_peak": want.get("peak")}
            for r, got in enumerate(ranks):
                g = got[gk]
                row[f"rank{r}"] = {k: v for k, v in g.items()
                                   if not isinstance(v, torch.Tensor)}
    # qwen3-4b: bf16 within two drifts of the single run's own
    # bf16-vs-f32 drift; flash_attention 36 launches a prefill on each
    # rank, on 16 q / 4 kv heads
    name = arch_config(sizes, sizes.dense_arch).name
    n_layers = arch_config(sizes, sizes.dense_arch).n_layers
    w16, w32 = ref[f"{name} bfloat16"], ref[f"{name} float32"]
    for part in ("prefill", "decode"):
        drift = float((w16[part] - w32[part]).abs().max())
        for r, got in enumerate(ranks):
            g = got[f"{name} bfloat16"]
            held(f"13b {name} {part} bf16, rank {r} vs the single run "
                    f"(the single run's bf16-vs-f32 drift {drift!r})",
                    g[part], w16[part], ARCH_BF16_DRIFTS * drift)
            if part == "prefill":
                held(f"13b {name} prefill f32, rank {r}",
                        got[f"{name} float32"]["prefill"], w32["prefill"],
                        PREFILL_F32_RTOL * float(w32["prefill"].abs().max()))
            if g["heads"] != [w16["heads"][0] // world,
                              w16["heads"][1] // world] or (
                    dev.type == "cuda" and g["flash_per_prefill"] != n_layers):
                raise AssertionError(f"13b {name}: rank {r} ran "
                                     f"{g['flash_per_prefill']} launches a "
                                     f"prefill on heads {g['heads']}")
    # smollm-135m: f32, the cache split by sequence: within 1e-4 of max
    name = arch_config(sizes, TP_SEQ_ARCH).name
    w = ref[f"{name} float32"]
    for r, got in enumerate(ranks):
        g = got[f"{name} float32"]
        if g["cache_seq"] != ("model",):
            raise AssertionError(f"13b {name}: cache split {g['cache_seq']}")
        for part in ("prefill", "decode"):
            held(f"13b {name} {part} f32, cache by sequence, rank {r}",
                    g[part], w[part],
                    TP_SEQ_RTOL * float(w[part].abs().max()))
    # olmoe-1b-7b: TP inside the experts and EP, within the bf16 bar,
    # routing the same on both ranks; over the whole bf16 prefill, the
    # share of (token, slot) entries routed to another expert (or dropped
    # otherwise) than the single bf16 run within ARCH_BF16_DRIFTS times
    # the single run's own bf16-vs-f32 share (the witness of how far bf16
    # rounding alone moves near-tied routes); layer 0's experts on the
    # same tokens in f32: expert ids and drops equal to the single run's,
    # the output within MOE_CPU_TOL
    cfg = arch_config(sizes, sizes.moe_arch)
    w16, w32 = ref[f"{cfg.name} bfloat16"], ref[f"{cfg.name} float32"]
    drift = float((w16["prefill"] - w32["prefill"]).abs().max())
    witness = {k: float((w16[k] != w32[k]).float().mean())
               for k in ("ids", "kept")}
    log(f"    13b {cfg.name}: the single run's bf16-vs-f32 share of "
        f"(token, slot) entries routed to another expert "
        f"{witness['ids']!r}, dropped otherwise {witness['kept']!r}")
    out["13b moe witness"] = witness
    for mode in ("", " ep"):
        key = f"{cfg.name} bfloat16{mode}"
        g0 = ranks[0][key]
        for r, got in enumerate(ranks):
            g = got[key]
            held(f"13b {key} prefill, rank {r} (drift {drift!r})",
                    g["prefill"], w16["prefill"], ARCH_BF16_DRIFTS * drift)
            if not (torch.equal(g["ids"], g0["ids"])
                    and torch.equal(g["kept"], g0["kept"])):
                raise AssertionError(f"13b {key}: the ranks route "
                                     f"differently")
            held(f"13b {key} layer 0's experts on {sizes.moe_cpu_len} "
                    f"seeded tokens in f32, rank {r}", g["layer0"],
                    w16["layer0"],
                    MOE_CPU_TOL * float(w16["layer0"].abs().max()))
            if not (torch.equal(g["layer0_ids"], w16["layer0_ids"])
                    and torch.equal(g["layer0_kept"], w16["layer0_kept"])):
                raise AssertionError(f"13b {key}: layer 0's expert ids or "
                                     f"drops are not the single run's")
        ids_off = float((g0["ids"] != w16["ids"]).float().mean())
        kept_off = float((g0["kept"] != w16["kept"]).float().mean())
        drops = [int((~w16["kept"]).sum()), int((~g0["kept"]).sum())]
        for k, off in (("ids", ids_off), ("kept", kept_off)):
            checks[f"13b {key} whole-prefill {k} share off the single "
                   f"run"] = [off, ARCH_BF16_DRIFTS * witness[k]]
            if not off <= ARCH_BF16_DRIFTS * witness[k]:
                raise AssertionError(
                    f"13b {key}: {off!r} of the whole prefill's {k} differ "
                    f"from the single run's, above {ARCH_BF16_DRIFTS} x the "
                    f"single run's bf16-vs-f32 {witness[k]!r}")
        log(f"    13b {key}: expert ids and drops equal on the {world} "
            f"ranks, and layer 0's (same tokens, f32) the single run's; "
            f"over the whole bf16 prefill {ids_off!r} of the (token, slot) "
            f"entries route to another expert than the single run's and "
            f"{kept_off!r} change their drop (bars "
            f"{ARCH_BF16_DRIFTS * witness['ids']!r}, "
            f"{ARCH_BF16_DRIFTS * witness['kept']!r}); drops single "
            f"{drops[0]}, sharded {drops[1]}; experts a rank "
            f"{g0['experts']}")
        rows[key].update(ids_off=ids_off, kept_off=kept_off, drops=drops)
    # the recsys models: within RECSYS_TOL, embedding_bag on every rank
    for name in sizes.tp_recsys_models:
        for hot in sizes.hots:
            key = next(k for k in ref if k.endswith(f" H={hot}")
                       and k.startswith(name))
            w = ref[key]
            for r, got in enumerate(ranks):
                g = got[key]
                lo, hi = g["rows"]
                held(f"13b {key}, rank {r} rows {lo}:{hi}", g["logits"],
                        w["logits"][lo:hi],
                        RECSYS_TOL * float(w["logits"].abs().max()))
                if "fields.table" not in g["sharded"] or (
                        dev.type == "cuda" and g["bag_per_call"] < 1):
                    raise AssertionError(f"13b {key}: rank {r} launched "
                                         f"embedding_bag "
                                         f"{g['bag_per_call']} times a call "
                                         f"on tables {g['sharded']}")
    for key, row in rows.items():
        log(f"  13b {key} ({label}): " + json.dumps(row, default=str))
    out["13b"] = rows
    out["13b label"] = label
    out["13b checks"] = checks

    # 13c: the meta dry run at quad_tp
    t1 = time.perf_counter()
    jobs = [(a, s, "quad_tp", False) for a, s in all_cells()]
    jobs += [(a, s, "quad_tp", True) for a, s in all_cells()
             if getattr(get_arch(a).config, "moe", None) is not None]
    pool = multiprocessing.get_context("spawn").Pool(sizes.dryrun_workers)
    try:
        drs = counted_cells(count_cells(pool, jobs), jobs, None)
    finally:
        pool.terminate()
        pool.join()
    out["13c seconds"] = time.perf_counter() - t1
    log(f"phase 13c: the meta dry run of {len(jobs)} cells at 'quad_tp' "
        f"(MoE cells with --expert-parallel as well; "
        f"{sizes.dryrun_workers} workers, {out['13c seconds']:.3f} s)")
    log(f"  {'arch':<14} {'shape':<14} {'ep':>3} {'counted':>12} "
        f"{'coll B':>12} {'est peak B':>12} {'s':>6}")
    failed = [r for r in drs if "error" in r]
    for r in drs:
        if "error" in r:
            log(f"  {r['arch']:<14} {r['shape']:<14} FAILED: {r['error']}")
            continue
        log(f"  {r['arch']:<14} {r['shape']:<14} {str(r['ep'])[0]:>3} "
            f"{r['flops']:>12.4g} {r['coll_bytes']:>12.4g} "
            f"{r['peak_bytes']:>12.4g} {r['seconds']:>6.1f}")
    if failed or len(drs) != len(jobs):
        raise AssertionError(f"13c: {len(failed)} cells did not count")
    # the rows are the table above; the line keeps the totals, so that it
    # stays within the tail of the output a reader gets back
    out["13c"] = {"cells": len(drs), "counted": len(drs) - len(failed),
                  "coll_bytes": sum(r["coll_bytes"] for r in drs)}
    return out


# ---------------------------------------------------------------------------
# Phase 14: training under the sharding policy


def shard_train_cases(sizes: Sizes) -> dict:
    """Phase 14's cases as plain data (a spawned worker or rank unpickles
    them before ``src`` is on its path): key -> family, arch, the config's
    cuts, the train shape, the (data, model) mesh, expert parallelism,
    sequence parallelism (None: the cell's decision) and the key of the
    single run it is held to."""
    lm = {"n_layers": sizes.shard_lm_layers, "dtype": "bfloat16"}
    lm_shape = {"name": "train_4k", "kind": "train",
                "seq_len": sizes.shard_lm_len,
                "global_batch": sizes.shard_lm_batch}
    moe = {"n_layers": sizes.moe_train_layers, "dtype": "bfloat16"}
    moe_shape = dict(lm_shape, seq_len=sizes.moe_train_len,
                     global_batch=sizes.shard_moe_batch)
    split_shape = dict(lm_shape, seq_len=sizes.shard_split_len,
                       global_batch=sizes.shard_split_batch)
    recsys_shape = {"name": "train_batch", "kind": "recsys_train",
                    "global_batch": sizes.recsys_train_batch}

    def case(family, arch, cut, shape, mesh, ref, ep=False, sp=None):
        return {"family": family, "arch": arch, "cut": cut, "shape": shape,
                "mesh": mesh, "ep": ep, "sp": sp, "ref": ref}

    return {
        "14a tp+sp": case("lm", sizes.dense_arch, lm, lm_shape, (1, 2),
                          "14a", sp=True),
        "14a fsdp": case("lm", sizes.dense_arch, lm, lm_shape, (2, 1),
                         "14a"),
        "14b fsdp x tp": case("lm", TP_SEQ_ARCH, {"dtype": "float32"},
                              split_shape, (2, 2), "14b"),
        "14c tp": case("lm", sizes.moe_arch, moe, moe_shape, (1, 2), "14c"),
        "14c ep": case("lm", sizes.moe_arch, moe, moe_shape, (1, 2), "14c",
                       ep=True),
        "14d": case("recsys", SHARD_RECSYS_MODEL, {}, recsys_shape,
                    (1, 2), "14d"),
        "14e graph": case("gnn", "schnet", {}, {"name": "full_graph_sm"},
                          (1, 2), "14e graph"),
        "14e molecules": case("gnn", "schnet", {}, {"name": "molecule"},
                              (1, 2), "14e molecules"),
    }


def shard_train_spec(case: dict, sizes: Sizes):
    """(the case's ArchSpec with its config cut, its ShapeSpec)."""
    import dataclasses
    import importlib

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.cells import shape_of

    spec = get_arch(case["arch"])
    if case["family"] == "lm":
        cfg = arch_config(sizes, case["arch"], **case["cut"])
    elif case["family"] == "recsys":
        cfg = getattr(importlib.import_module(
            f"repro_torch.configs.{case['arch']}"), sizes.recsys_config)
    else:
        cfg = spec.config
    spec = dataclasses.replace(spec, config=cfg)
    shape = (shape_of(spec, case["shape"]["name"]) if case["family"] == "gnn"
             else ShapeSpec(**case["shape"]))
    return spec, shape


def shard_train_layout(case: dict):
    from repro_torch.launch.mesh import Layout

    d, m = case["mesh"]
    return Layout(name=f"mesh_{d}x{m}", cards=d * m, dp=d, tp=m,
                  expert_parallel=case["ep"])


def shard_train_model(case: dict, sizes: Sizes, dev, policy=None,
                      dtype=None):
    """(model, loss function, train_plan kwargs, the whole numpy batch,
    its dims' function) of a case, the weights seeded (seed 0: the
    sharded init draws every whole leaf and cuts it, so every rank holds
    the single run's weights), ``dtype`` overriding the LM's compute."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.data.synthetic import make_lm_batch, make_recsys_batch
    from repro_torch.launch.cells import gnn_batch
    from repro_torch.models.recsys import build_model
    from repro_torch.models.schnet import SchNet
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.sharding import policies as pol

    from repro_torch.launch.cells import seq_parallel

    spec, shape = shard_train_spec(case, sizes)
    cfg = spec.config
    gen = torch.Generator(device=dev).manual_seed(0)
    if case["family"] == "lm":
        sp = case["sp"]
        if sp is None:  # the cell's decision
            sp = seq_parallel(cfg, shape, shard_train_layout(case))
        cfg = dataclasses.replace(cfg, seq_parallel=sp,
                                  **({"dtype": dtype} if dtype else {}))
        model = TransformerLM(cfg, device=dev, generator=gen, policy=policy)
        batch = make_lm_batch(shape.global_batch, shape.seq_len,
                              cfg.vocab_size, seed=1)
        # a mask that differs by row: the loss is the global masked mean
        batch["loss_mask"] = (np.random.default_rng(2).random(
            batch["loss_mask"].shape) < 0.7).astype(np.float32)
        return (model, model.loss_fn, {}, batch,
                lambda p: pol.lm_batch_dims(p))
    if case["family"] == "recsys":
        model = build_model(cfg, device=dev, seed=0, policy=policy,
                            serving=False)
        batch = make_recsys_batch(shape.global_batch, cfg.n_sparse,
                                  cfg.vocab_sizes, cfg.seq_len,
                                  cfg.item_vocab, seed=1)
        batch["sparse_ids"] = batch["sparse_ids"][:, :, 0]  # the cell's
        return (model, model.loss_fn, {}, batch,
                lambda p: pol.recsys_batch_dims(
                    p, {k: v.ndim for k, v in batch.items()}))
    batched = shape.kind == "gnn_batched"
    arrays, _ = gnn_batch(shape, 1, 1 if batched else case["mesh"][0]
                          * case["mesh"][1], cfg.cutoff)
    d_in = arrays["node_feat"].shape[-1]
    model = SchNet(dataclasses.replace(cfg, d_in=d_in), device=dev,
                   generator=gen, policy=policy)
    loss_fn = model.batched_energy_loss if batched else model.loss_fn
    return (model, loss_fn, {"batched": batched}, arrays,
            lambda p: pol.gnn_batch_dims(p, batched))


def run_train_steps(dev, model, batch, grads_fn, update_fn, step_fn,
                    on_grads, record=None) -> dict:
    """SHARD_TRAIN_STEPS steps: the first as the gradient (``grads_fn``) then AdamW
    (``update_fn``), the train step's own two calls, so that step 1's
    gradient can be read (``out["grads"] = on_grads(grads)``); the rest
    through ``step_fn``, the second under ``record`` (a context counting
    its collectives) -> losses, norms, ms a step (host clock,
    synchronised), the peak device memory and the collectives counted."""
    import contextlib

    import torch

    from repro_torch.train import adamw_init

    card = dev.type == "cuda"
    params = dict(model.named_parameters())
    state = {"params": params, "opt_state": adamw_init(params)}
    out = {"loss": [], "grad_norm": [], "ms": []}
    if card:
        sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    for i in range(SHARD_TRAIN_STEPS):
        t0 = time.perf_counter()
        rec = contextlib.nullcontext({})
        if i == 1 and record is not None:
            rec = record()
        with rec as counted:
            if i == 0:
                loss, grads = grads_fn(params, batch)
                metrics = update_fn(grads, state)
                out["grads"] = on_grads(grads)
                del grads
            else:
                state, metrics = step_fn(state, batch)
                loss = metrics["loss"]
            if card:
                sync(dev)
        out["ms"].append(1e3 * (time.perf_counter() - t0))
        if i == 1:
            out["collectives"] = {k: list(v) for k, v in counted.items()}
        out["loss"].append(float(loss))
        out["grad_norm"].append(float(metrics["grad_norm"]))
    out["peak"] = torch.cuda.max_memory_allocated(dev) if card else None
    out["state"] = state
    return out


def shard_train_single(dev, sizes: Sizes, case: dict, dtype=None,
                       f32=None) -> dict:
    """A case's single-rank run (no policy): ``make_train_step``'s step
    1 as its gradient and AdamW, then the step itself.  Step 1's gradient
    is kept on the host (``grads``), with each leaf's max |g|
    (``scale``) and, given the f32 run's gradient ``f32``, its max |g -
    f32| (``drift``), counted on the card."""
    import torch

    from repro_torch.train import AdamWConfig, adamw_update, cosine_schedule
    from repro_torch.train.train_loop import make_train_step, to_device

    model, loss_fn, _, whole, _ = shard_train_model(case, sizes, dev,
                                                    dtype=dtype)
    adamw = AdamWConfig()
    schedule = cosine_schedule(adamw)
    batch = to_device(whole, dev)

    def grads_fn(params, b):
        loss, _ = loss_fn(b)
        gs = torch.autograd.grad(loss, list(params.values()),
                                 allow_unused=True)
        return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                               for (k, p), g in zip(params.items(), gs)}

    def update_fn(grads, state):
        return adamw_update(grads, state["params"], state["opt_state"],
                            adamw, schedule)[2]

    def keep(grads):
        out["scale"], out["drift"], host = {}, {}, {}
        for k, g in grads.items():
            g = g.detach().float()
            out["scale"][k] = float(g.abs().max())
            if f32 is not None:
                out["drift"][k] = float((g - f32[k].to(dev)).abs().max())
            host[k] = g.cpu()
        return host

    out = {}
    out.update(run_train_steps(dev, model, batch, grads_fn, update_fn,
                               make_train_step(loss_fn, adamw), keep))
    del out["state"], model
    return out


def shard_train_case(dev, sizes: Sizes, case: dict, tmp: str) -> dict:
    """One case on this rank (see :func:`shard_train_rank`); everything it
    allocates on the card is freed when it returns.  Step 1's gradient
    blocks are held, on the card, to the single run's gradient, which the
    main process saved to ``tmp`` (read back by memory map, each rank its
    blocks)."""
    import torch

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding import ctx
    from repro_torch.sharding import policies as pol
    from repro_torch.train import AdamWConfig, adamw_update, cosine_schedule
    from repro_torch.train.optimizer import sharded_global_norm
    from repro_torch.train.train_loop import (
        make_sharded_train_step, sharded_grads,
    )

    mesh = make_debug_mesh(*case["mesh"], device_type=dev.type)
    policy = pol.make_policy(mesh, expert_parallel=case["ep"])
    coords = list(mesh.get_coordinate())
    model, loss_fn, kw, whole, dims = shard_train_model(case, sizes, dev,
                                                        policy)
    plan = model.train_plan(**kw)
    batch = pol.shard_batch(whole, dims(policy), mesh, coords)
    adamw = AdamWConfig()
    schedule = cosine_schedule(adamw)

    def grads_fn(params, b):
        return sharded_grads(loss_fn, plan, params, b)

    def update_fn(grads, state):
        with ctx.axes(policy.mesh, policy.dp, policy.tp):
            return adamw_update(
                grads, state["params"], state["opt_state"], adamw, schedule,
                lambda g: sharded_global_norm(g, plan.specs, mesh))[2]

    def off_single(grads):
        """max |g - the single run's block|, a leaf."""
        ref = torch.load(shard_train_ref(tmp, case["ref"]), mmap=True,
                         weights_only=True)
        return {k: float((g.float() - pol.shard_leaf(
            ref[k], plan.specs[k], mesh, coords).to(dev)).abs().max())
            for k, g in grads.items()}

    res = run_train_steps(dev, model, batch, grads_fn, update_fn,
                          make_sharded_train_step(loss_fn, adamw, plan),
                          off_single, ctx.recording)
    state = res.pop("state")
    every = {a for a, n in pol.axis_sizes(mesh).items() if n > 1}
    shared = [k for k, pl in plan.specs.items()
              if set(pol.sharded_axes(pl, mesh)) != every]
    o = state["opt_state"]
    res["shared"] = {k: [t.detach().cpu() for t in (
        state["params"][k], o["mu"][k], o["nu"][k])] for k in shared}
    res["step"] = int(o["step"])
    res["blocks"] = {k: [list(mesh.mesh_dim_names).index(a)
                         for a in pol.sharded_axes(pl, mesh)]
                     for k, pl in plan.specs.items()}
    res["coords"] = coords
    res["params_per_rank"] = sum(p.numel() for p in model.parameters())
    return res


def shard_train_ref(tmp: str, ref: str) -> str:
    """Where the main process saves the single run ``ref``'s step-1
    gradient (CPU tensors by leaf name) for the ranks."""
    return os.path.join(tmp, f"single_{ref.replace(' ', '_')}.pt")


def shard_train_rank(rank: int, world: int, port: int, tmp: str,
                     dev_type: str, sizes: Sizes, keys: list) -> None:
    """14's rank ``rank`` of ``world`` on card 0 over gloo (a spawned
    process), under deterministic algorithms: each case of ``keys`` at its
    mesh -> the steps' numbers, its collectives of step 2, its peak (and
    what the card held as the case began), how far step 1's gradient
    blocks are from the single run's, the final blocks of every leaf
    another rank also holds and the launches of each kernel of KERNELS
    (counters zeroed as the case begins), written to ``tmp``."""
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    import gc
    import importlib

    import torch
    import torch.distributed as dist

    dev = torch.device(dev_type, 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.use_deterministic_algorithms(True)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    cases = shard_train_cases(sizes)
    kernels = {name: importlib.import_module(f"repro_torch.kernels.{name}.ops")
               for name in KERNELS}
    out = {}
    try:
        for key in keys:
            held = (torch.cuda.memory_allocated(dev) if dev.type == "cuda"
                    else None)
            for mod in kernels.values():
                mod.launches = 0
            out[key] = shard_train_case(dev, sizes, cases[key], tmp)
            out[key]["held before"] = held
            out[key]["launches"] = {name: mod.launches
                                    for name, mod in kernels.items()}
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"w{world}r{rank}.pt"))


def train_cell_collectives(job: tuple) -> dict:
    """14's meta count, in a worker process: the collectives of one step
    of the cell of a phase-14 case at its mesh (``collective_bytes`` on
    ``meta``: the forward's, the backward's and the optimizer's), or of a
    registry training cell at a layout (``(arch, shape, layout)``:
    12b/13c's ``dryrun_cell``)."""
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    import torch

    from repro_torch.analysis.ops import collective_bytes
    from repro_torch.launch.cells import make_cell

    torch.set_num_threads(1)
    key, case, sizes = job
    t0 = time.perf_counter()
    try:
        spec, shape = shard_train_spec(case, sizes)
        kw = ({"microbatches": 1, "seq_parallel_on": case["sp"]}
              if case["family"] == "lm" else {})
        cell = make_cell(spec, shape, shard_train_layout(case), **kw)
        stats = collective_bytes(cell)
    except Exception as e:  # listed by the caller, which then fails
        return {"key": key, "error": repr(e)}
    return {"key": key, "by_kind": stats.by_kind, "counts": stats.counts,
            "seconds": time.perf_counter() - t0}


def shard_train_phase(dev, sizes: Sizes) -> dict:
    """Phase 14: training under the sharding policy.  The single-rank runs
    of every case first (``make_train_step``, freed before the ranks
    start), then the ranks: 14b's four and two for the rest, at once, each
    on card 0 over gloo; meanwhile the meta counts of each case's cell and
    (14f) of every registry training cell at ``"quad"``.  Gates: each
    rank's loss and ``grad_norm`` of every step within TRAIN_LOSS_RTOL of
    the single run's in f32, within ARCH_BF16_DRIFTS of the single run's
    own bf16-vs-f32 drift in bf16; step 1's gradient blocks within
    TRAIN_GRAD_TOL of each leaf's max |g| (bf16: that or twice the leaf's
    drift); every block another rank holds bit for bit the same there
    after the last step, the step counter too; step 2's collectives those
    the cell's meta count gives."""
    import multiprocessing
    import shutil
    import tempfile

    import torch

    from repro_torch.launch.cells import all_cells, shape_of
    from repro_torch.configs import get_arch
    from repro_torch.sharding import policies as pol

    out = {}
    t0 = time.perf_counter()
    cases = shard_train_cases(sizes)
    pool = multiprocessing.get_context("spawn").Pool(sizes.shard_workers)
    counts = pool.map_async(train_cell_collectives,
                            [(k, c, sizes) for k, c in cases.items()],
                            chunksize=1)
    quad = [(a, s, "quad", False) for a, s in all_cells()
            if shape_of(get_arch(a), s).kind in (
                "train", "recsys_train", "gnn_full", "gnn_minibatch",
                "gnn_batched")]
    cells14f = count_cells(pool, quad)
    tmp = tempfile.mkdtemp(prefix="shard_train")
    try:
        # the single runs, each freed before the next (bf16 cases in f32
        # too: the drift their bars are counted in); each one's step-1
        # gradient is saved for the ranks, its max |g| a leaf kept
        singles, drift = {}, {}
        det = dev.type == "cuda"
        if det:
            torch.use_deterministic_algorithms(True)
        try:
            for key, case in cases.items():
                ref = case["ref"]
                if ref in singles:
                    continue
                t1 = time.perf_counter()
                bf16 = (case["family"] == "lm"
                        and case["cut"].get("dtype") == "bfloat16")
                f32 = None
                if bf16:
                    f32 = shard_train_single(dev, sizes, case, "float32")
                    torch.cuda.empty_cache()
                w = singles[ref] = shard_train_single(
                    dev, sizes, case, f32=f32 and f32["grads"])
                torch.save(w.pop("grads"), shard_train_ref(tmp, ref))
                torch.cuda.empty_cache()
                if bf16:
                    # the scalars' drift: the largest relative difference
                    # over the steps' losses and norms (one step's may fall
                    # near 0 by chance); a gradient's: the largest over the
                    # leaf's elements
                    drift[ref] = {"relative": max(
                        abs(a - b) / abs(b) for k in ("loss", "grad_norm")
                        for a, b in zip(w[k], f32[k])), "grads": w["drift"]}
                    w["f32"] = {k: f32[k] for k in ("loss", "grad_norm",
                                                    "ms", "peak")}
                    del f32
                log(f"  14 single {ref}: losses {w['loss']}, norms "
                    f"{w['grad_norm']}, ms {w['ms']}, peak {w['peak']} "
                    f"({time.perf_counter() - t1:.1f} s)")
        finally:
            if det:
                torch.use_deterministic_algorithms(False)
        out["singles seconds"] = time.perf_counter() - t0

        # the ranks: a world of four for 14b and one of two for the other
        # cases, run at once (each its own gloo group)
        ranks = {}
        t1 = time.perf_counter()
        ctx_mp = multiprocessing.get_context("spawn")
        worlds = {}
        for world in (4, 2):
            keys = [k for k, c in cases.items()
                    if c["mesh"][0] * c["mesh"][1] == world]
            port = free_port()
            worlds[world] = (keys, [ctx_mp.Process(
                target=shard_train_rank, args=(
                    r, world, port, tmp, dev.type, sizes, keys))
                for r in range(world)])
        procs = [p for _, ps in worlds.values() for p in ps]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(SHARD_TRAIN_TIMEOUT_S)
            codes = [p.exitcode for p in procs]
            if codes != [0] * len(procs):
                raise AssertionError(f"14: the ranks exited with {codes}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        out["ranks seconds"] = time.perf_counter() - t1
        for world, (keys, _) in worlds.items():
            got = [torch.load(os.path.join(tmp, f"w{world}r{r}.pt"),
                              weights_only=False) for r in range(world)]
            for key in keys:
                ranks[key] = [g[key] for g in got]
        checks, rows = shard_train_checks(sizes, cases, singles, drift,
                                          ranks)
        counted = {r["key"]: r for r in counts.get(SHARD_TRAIN_TIMEOUT_S)}
        for key, row in rows.items():
            want = counted[key]
            if "error" in want:
                raise AssertionError(f"14 {key}: the meta count failed: "
                                     f"{want['error']}")
            got = ranks[key][0]["collectives"]
            mine = {k: v for k, v in got.items() if v[1]}
            cell = {k: [want["by_kind"][k], want["counts"][k]]
                    for k in want["by_kind"]}
            row["collectives"] = mine
            row["cell collectives"] = cell
            if mine != cell:
                raise AssertionError(f"14 {key}: step 2's collectives {mine}"
                                     f" are not the cell's {cell}")
        out["cases"] = rows
        out["checks"] = checks
        out["label"] = "ranks sharing one card, gloo"
        drs = counted_cells(cells14f, quad, SHARD_TRAIN_TIMEOUT_S)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        pool.terminate()
        pool.join()
    failed = [r for r in drs if "error" in r]
    log(f"  14f: the meta count of {len(quad)} training cells at 'quad' "
        f"(their 'quad_tp' rows are 13c's)")
    for r in drs:
        if "error" in r:
            log(f"  {r['arch']:<14} {r['shape']:<14} FAILED: {r['error']}")
            continue
        log(f"  {r['arch']:<14} {r['shape']:<14} quad coll B "
            f"{r['coll_bytes']:>14.6g} flops {r['flops']:>12.4g} peak B "
            f"{r['peak_bytes']:>12.4g}")
    if failed or len(drs) != len(quad):
        raise AssertionError(f"14f: {len(failed)} cells did not count")
    out["14f"] = {f"{r['arch']}/{r['shape']}": r["coll_bytes"] for r in drs}
    out["seconds"] = time.perf_counter() - t0
    return out


def shard_train_checks(sizes: Sizes, cases: dict, singles: dict,
                       drift: dict, ranks: dict) -> tuple:
    """14's gates on the ranks' numbers (see :func:`shard_train_phase`)
    -> ({check: [max err, bar]}, a row a case)."""
    import torch

    checks, rows = {}, {}
    for key, case in cases.items():
        ref = case["ref"]
        want = singles[ref]
        dr = drift.get(ref)
        res = ranks[key]
        for r, got in enumerate(res):
            for k in ("loss", "grad_norm"):
                for i, (g, w) in enumerate(zip(got[k], want[k])):
                    bar = TRAIN_LOSS_RTOL * abs(w)
                    if dr is not None:
                        bar = max(bar, ARCH_BF16_DRIFTS * dr["relative"]
                                  * abs(w))
                    name = f"14 {key} rank {r} step {i + 1} {k}"
                    checks[name] = [abs(g - w), bar]
                    if not abs(g - w) <= bar:
                        raise AssertionError(f"{name}: {g!r} against the "
                                             f"single run's {w!r} (bar "
                                             f"{bar!r})")
            worst = 0.0
            if set(got["grads"]) != set(want["scale"]):
                raise AssertionError(f"14 {key} rank {r}: the gradient's "
                                     f"leaves are not the single run's")
            for k, scale in want["scale"].items():
                bar = TRAIN_GRAD_TOL * scale
                if dr is not None:
                    bar = max(bar, ARCH_BF16_DRIFTS * dr["grads"][k])
                err = got["grads"][k]
                worst = max(worst, err / max(bar, 1e-30))
                if not err <= bar:
                    raise AssertionError(f"14 {key} rank {r}: step 1's "
                                         f"gradient of {k} off by {err!r} "
                                         f"(bar {bar!r})")
            checks[f"14 {key} rank {r} step-1 gradients, worst share of "
                   f"the bar"] = [worst, 1.0]
            if any(got["launches"].values()):
                raise AssertionError(f"14 {key} rank {r} launched a kernel: "
                                     f"{got['launches']}")
            if got["step"] != SHARD_TRAIN_STEPS:
                raise AssertionError(f"14 {key} rank {r}: step counter "
                                     f"{got['step']}")
        # every block held by several ranks: the same bits on each
        for k in res[0]["shared"]:
            dims = res[0]["blocks"][k]
            held = {}
            for got in res:
                held.setdefault(tuple(got["coords"][i] for i in dims),
                                []).append(got["shared"][k])
            for same in held.values():
                for other in same[1:]:
                    if not all(torch.equal(a, b)
                               for a, b in zip(same[0], other)):
                        raise AssertionError(f"14 {key}: {k} (or its "
                                             f"moments) differs between "
                                             f"ranks holding one block")
        rows[key] = {
            "mesh": list(case["mesh"]), "ep": case["ep"], "sp": case["sp"],
            "loss": [g["loss"] for g in res],
            "single loss": want["loss"],
            "grad_norm": [g["grad_norm"] for g in res],
            "single grad_norm": want["grad_norm"],
            "ms": [g["ms"] for g in res], "single ms": want["ms"],
            "peak": [g["peak"] for g in res], "single peak": want["peak"],
            "held before": [g["held before"] for g in res],
            "params per rank": [g["params_per_rank"] for g in res],
            "launches": [g["launches"] for g in res],
            "shared leaves": len(res[0]["shared"])}
        if dr is not None:
            rows[key]["relative drift"] = dr["relative"]
            rows[key]["single f32"] = want["f32"]
        log(f"  14 {key} (ranks sharing one card, gloo): "
            + json.dumps(rows[key], default=str))
    return checks, rows


def bf16_rows(dev, sizes: Sizes, rows, corpus, tiled, ell, qw_t, qw,
              flops: float, errs: dict) -> None:
    """Phase 4 for the bf16 routes of ``scatter_score`` and
    ``ell_gather`` at serve_1m: each against its plain version, then the
    kernel, the plain version, the library call in bf16 (cuSPARSE's SpMM of
    bf16 CSR docs by a bf16 QW^T, where PyTorch takes it) and the bound of
    the bf16 bytes (the live slots' ids and docs 4 B, their values 2 B, QW
    and the scores 2 B a weight) or of the f32 operations; added to each
    kernel's row as its ``bf16`` sub-row."""
    import dataclasses as dc

    import torch

    from repro_torch.core import scoring
    from repro_torch.kernels.ell_gather import ops as ell_ops
    from repro_torch.kernels.ell_gather.ref import ell_gather_ref
    from repro_torch.kernels.scatter_score import ops as scatter_ops
    from repro_torch.kernels.scatter_score.ref import scatter_score_ref

    bf = torch.bfloat16
    b = qw.shape[0]
    tb = dc.replace(tiled, value=tiled.value.to(bf))
    ell_vb = ell.values.to(bf)
    qtb, qb = qw_t.to(bf), qw.to(bf)
    targs = tiled_args(tb)
    specs = {
        "scatter_score": (
            lambda: scatter_ops.scatter_score(qtb, **targs),
            lambda: scatter_score_ref(qtb, **targs),
            int((tiled.local_doc >= 0).sum()) * 10 + tiled.num_chunks * 4
            + tiled.num_doc_blocks * 8 + b * qw_t.shape[1] * 2
            + b * tiled.padded_docs * 2),
        "ell_gather": (
            lambda: ell_ops.ell_gather(qb, ell.terms, ell_vb),
            lambda: ell_gather_ref(qb, ell.terms, ell_vb),
            ell.terms.numel() * 4 + int((ell.terms < sizes.vocab).sum()) * 2
            + b * sizes.vocab * 2 + b * ell.terms.shape[0] * 2),
    }
    try:
        csr = scoring.docs_csr(corpus.docs, bf)
        rhs = qb.T.contiguous()
        torch.sparse.mm(csr, rhs)
        library_ms = event_ms(lambda: torch.sparse.mm(csr, rhs), sizes.reps,
                              dev)
        library = f"{library_ms!r} ms"
    except (RuntimeError, NotImplementedError) as e:
        library_ms, library = None, f"not taken ({str(e).splitlines()[0]})"
    csr = rhs = None
    torch.cuda.empty_cache()
    log(f"  library in bf16: torch.sparse.mm of bf16 CSR docs by a bf16 "
        f"QW^T: {library}")
    for name, (kernel, plain, nbytes) in specs.items():
        err = compare(f"{name} bf16 at {sizes.docs} docs x {b} queries",
                      kernel(), plain(), tol=BF16_KERNEL_TOL)
        kernel_ms = event_ms(kernel, sizes.reps, dev)
        plain_ms = event_ms(plain, 1, dev)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        sub = dict(ms=kernel_ms, plain_ms=plain_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   library_ms=library_ms,
                   max_abs_err=max(err, errs[name]))
        log(f"  {name} bf16: kernel {kernel_ms!r} ms, plain {plain_ms!r} "
            f"ms, library {library_ms!r} ms, bound {sub['bound_ms']!r} ms "
            f"({sub['bound_by']}: {nbytes} B, {flops!r} flop)")
        next(r for r in rows if r["name"] == name)["bf16"] = sub


def run(dev, sizes: Sizes) -> list[dict]:
    import numpy as np
    import torch

    from repro_torch.core import RetrievalConfig, RetrievalEngine, scoring
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
    log(f"phase 2c: the bf16 routes of scatter_score, ell_gather and "
        f"bmp_scan vs their f32 routes and plain versions")
    bf16_errs = check_bf16(dev, sizes)

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
    # The library call: cuSPARSE SpMM of the docs as CSR by QW^T laid out
    # row-major, as the ``bcoo`` engine calls it (the strided view QW.T,
    # the old yardstick, takes a far slower cuSPARSE path; printed beside).
    csr = scoring.docs_csr(corpus.docs, torch.float32)
    rhs = qw.T.contiguous()
    library_ms = event_ms(lambda: torch.sparse.mm(csr, rhs), sizes.reps,
                          dev)
    strided_ms = event_ms(lambda: torch.sparse.mm(csr, qw.T), sizes.reps,
                          dev)
    log(f"  library: torch.sparse.mm of the CSR docs by QW^T {library_ms!r} "
        f"ms (row-major QW^T); by the strided view QW.T {strided_ms!r} ms "
        f"(the old yardstick)")
    del csr, rhs
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
    bf16_rows(dev, sizes, rows, corpus, tiled, ell, qw_t, qw, flops,
              bf16_errs)
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

    # 9. sharded serving; phase 8's data is gone
    del state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"phase 9: sharded serving at serve_1m, world size 1: the six "
        f"engines' steps, NCCL, launch.serve; {sizes.docs} docs x "
        f"{sizes.queries} queries, k={sizes.k}")
    for mod in counters.values():
        mod.launches = 0
    sharded = serve_sharded(dev, sizes)
    sharded_launches = {name: mod.launches for name, mod in counters.items()}
    log(f"  launches in phase 9: {sharded_launches}")
    for name, n in sharded_launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched in phase 9")
    sharded["launches"] = sharded_launches
    log(f"phase 9: {time.perf_counter() - t0:.3f} s")
    # The bf16 routes' launches on the main path: 9a's bf16 steps.
    for row in rows:
        if row["name"] in ("scatter_score", "ell_gather", "bmp_scan"):
            row.setdefault("bf16", {})["launches"] = sharded[
                "9a bf16 launches"].get(f"{row['name']}/bfloat16", 0)
    sub = next(r for r in rows if r["name"] == "bmp_scan")["bf16"]
    sub["max_abs_err"] = max(sub["max_abs_err"], bf16_errs["bmp_scan"])
    print(json.dumps({"sharded": sharded}, default=float))

    # 9d. serve_8m on one card; phase 9's data is gone
    del sharded
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"phase 9d: serve_8m, {sizes.serve_8m_docs} docs x {sizes.queries} "
        f"queries, k={sizes.k}, world size 1: the ell step in f32 and bf16")
    for mod in counters.values():
        mod.launches = 0
    big = serve_8m(dev, sizes)
    big["launches"] = {name: mod.launches for name, mod in counters.items()}
    log(f"  launches in phase 9d: {big['launches']}")
    if big["launches"]["ell_gather"] <= 0:
        raise AssertionError("ell_gather was not launched in phase 9d")
    big["seconds"] = time.perf_counter() - t0
    log(f"phase 9d: {big['seconds']:.3f} s")
    for row in rows:
        if row["name"] == "ell_gather":
            row["serve_8m"] = {dt: {key: big[dt][key] for key in (
                "kernel_ms", "bound_ms", "hbm_share", "step_ms")}
                for dt in ("float32", "bfloat16")}
    print(json.dumps({"serve_8m": big}, default=float))

    # 10. the system comparison; phase 9d's data is gone
    del big
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for mod in counters.values():
        mod.launches = 0
    scoring.segment_launches = 0
    comparison = system_comparison(dev, sizes)
    comparison_launches = {name: mod.launches
                           for name, mod in counters.items()}
    comparison_launches["segment"] = scoring.segment_launches
    log(f"  launches in phase 10 (segment: its index_add_ calls): "
        f"{comparison_launches}")
    for name in ("scatter_score", "ell_gather", "segment"):
        if comparison_launches[name] <= 0:
            raise AssertionError(f"{name} was not launched in phase 10")
    comparison["launches"] = comparison_launches
    comparison["seconds"] = time.perf_counter() - t0
    log(f"phase 10: {comparison['seconds']:.3f} s")
    print(json.dumps({"comparison": comparison}, default=float))

    # 11. every LM architecture; phase 10's data is gone
    del comparison
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"phase 11: LM architectures: {sizes.moe_arch} prefill "
        f"{sizes.moe_batch} x {sizes.moe_len} and decode, {sizes.swa_arch} x "
        f"{sizes.swa_layers} layers prefill 1 x {sizes.swa_len}, "
        f"{sizes.dense_arch} prefill 1 x {sizes.dense_len}; training")
    archs = lm_archs(dev, sizes)
    archs["seconds"] = time.perf_counter() - t0
    log(f"phase 11: {archs['seconds']:.3f} s")
    print(json.dumps({"lm_archs": archs}, default=float))

    # 12. SchNet and the cell layer; phase 11's data is gone.  No kernel
    # lies on SchNet's path: the counters must stay 0.
    del archs
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.splade_head import ops as splade_ops

    counters["splade_head"] = splade_ops
    counters["flash_attention"] = flash_ops
    counters["embedding_bag"] = bag_ops
    for mod in counters.values():
        mod.launches = 0
    log(f"phase 12: SchNet at FULL width ({', '.join(sizes.schnet_cells)}) "
        f"and the meta dry run of every cell")
    gnn = schnet_phase(dev, sizes)
    gnn["launches"] = {name: mod.launches for name, mod in counters.items()}
    log(f"  launches in phase 12 (no kernel on SchNet's path): "
        f"{gnn['launches']}")
    if any(gnn["launches"].values()):
        raise AssertionError(f"phase 12 launched a kernel: "
                             f"{gnn['launches']}")
    gnn["seconds"] = time.perf_counter() - t0
    log(f"phase 12: {gnn['seconds']:.3f} s")
    print(json.dumps({"schnet": gnn}, default=float))

    # 13. tensor and expert parallelism; phase 12's data is gone.  The
    # ranks' launches are counted in their processes (13b's rows).
    del gnn
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"phase 13: tensor and expert parallelism: 13a one NCCL rank, "
        f"13b {TP_RANKS} gloo ranks on card 0 ({sizes.dense_arch}, "
        f"{TP_SEQ_ARCH}, {sizes.moe_arch} TP and EP, "
        f"{', '.join(sizes.tp_recsys_models)}), 13c the dry run at quad_tp")
    tp = tp_phase(dev, sizes)
    tp["seconds"] = time.perf_counter() - t0
    log(f"phase 13: {tp['seconds']:.3f} s")
    per_rank = {
        "flash_attention": {
            k: [v[f"rank{r}"]["flash_per_prefill"]
                for r in range(TP_RANKS)]
            for k, v in tp["13b"].items() if "flash_per_prefill" in
            v["rank0"]},
        "embedding_bag": {
            k: [v[f"rank{r}"]["bag_per_call"] for r in range(TP_RANKS)]
            for k, v in tp["13b"].items() if "bag_per_call" in v["rank0"]}}
    for row in rows:
        if row["name"] in per_rank:
            row["phase13_launches_per_call_per_rank"] = per_rank[row["name"]]
    print(json.dumps({"tensor_parallel": tp}, default=float))

    # 14. training under the sharding policy; phase 13's data is gone.  No
    # kernel lies on the training paths (no kernel has a backward): the
    # counters, zeroed before the single runs, must stay 0 (each rank holds
    # its own to 0 in shard_train_checks).
    del tp
    torch.cuda.empty_cache()
    for mod in counters.values():
        mod.launches = 0
    log(f"phase 14: training under the sharding policy on gloo ranks "
        f"sharing card 0: 14a {sizes.dense_arch} x {sizes.shard_lm_layers} "
        f"layers bf16, {sizes.shard_lm_batch} x {sizes.shard_lm_len}, at "
        f"(1, 2) with seq_parallel and at (2, 1); 14b {TP_SEQ_ARCH} f32, "
        f"{sizes.shard_split_batch} x {sizes.shard_split_len} at (2, 2); "
        f"14c {sizes.moe_arch} x {sizes.moe_train_layers} layers bf16 under "
        f"TP and EP; 14d {SHARD_RECSYS_MODEL} at B = "
        f"{sizes.recsys_train_batch}; 14e SchNet full_graph_sm and "
        f"molecule; 14f the training cells at 'quad' on meta")
    trained = shard_train_phase(dev, sizes)
    trained["launches"] = {name: mod.launches
                           for name, mod in counters.items()}
    if any(trained["launches"].values()):
        raise AssertionError(f"phase 14 launched a kernel: "
                             f"{trained['launches']}")
    log(f"phase 14: {trained['seconds']:.3f} s")
    print(json.dumps({"sharded_training": trained}, default=float))
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
