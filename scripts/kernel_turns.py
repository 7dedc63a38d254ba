#!/usr/bin/env python3
"""Phase 4's kernel times (``chip_smoke.py``) of one tree's package,
repeated, so two commits can be timed in turns on one card.

At serve_1m (1,000,000 docs x 500 queries, V = 30,522, k = 1000):
``scatter_score`` over the ``tiled`` index and ``ell_gather`` over the
``ell`` index of the msmarco-like corpus, and the ``bmp_scan`` sample
(the first 4 groups of the largest bucket of the fused engine's plan on
the reordered topical corpus), each as ``chip_smoke.event_ms`` times it
(CUDA events, the mean of 5 runs after a warm-up), ``--rounds`` times.
``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default this checkout's); the corpora, the plan and the timing are this
checkout's ``chip_smoke.py``.  Two commits in turns, from the root of a
checkout with one CUDA card:

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    for s in build/parent/src src src build/parent/src; do
        python3 scripts/kernel_turns.py --src $s; done

Each run prints the card's name and power limit and, as its last line,
one JSON object with its times.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.abspath(args.src), ROOT]
    import chip_smoke as cs
    from repro_torch.core import RetrievalConfig, RetrievalEngine, scoring
    from repro_torch.data.synthetic import (
        make_msmarco_like, make_topical_corpus,
    )
    from repro_torch.kernels import build
    from repro_torch.kernels.ell_gather import ops as ell_ops
    from repro_torch.kernels.scatter_score import ops as scatter_ops
    from repro_torch.sched import planner

    build.build(("scatter_score", "ell_gather", "bmp_scan"))
    sizes, dev = cs.Sizes(), torch.device("cuda", 0)
    corpus = make_msmarco_like(sizes.docs, sizes.queries,
                               vocab_size=sizes.vocab, seed=0, device=dev)
    tiled = RetrievalEngine(corpus.docs, RetrievalConfig(engine="tiled"),
                            device=dev)._index
    ell = RetrievalEngine(corpus.docs, RetrievalConfig(engine="ell"),
                          device=dev)._index
    qw_t = cs.padded_queries(corpus.queries, tiled)
    qw = corpus.queries.to_dense()
    fns = {
        "scatter_score": lambda: scatter_ops.scatter_score(
            qw_t, **cs.tiled_args(tiled)),
        "ell_gather": lambda: ell_ops.ell_gather(qw, ell.terms, ell.values),
    }
    topical = make_topical_corpus(sizes.docs, sizes.queries,
                                  vocab_size=sizes.vocab, seed=0, device=dev)
    idx = RetrievalEngine(topical.docs, RetrievalConfig(
        engine="tiled-bmp-fused", k=sizes.k, reorder_docs=True,
        reorder_method="df-signature"), device=dev)._index
    qw_b = scoring._pad_queries_to_term_blocks(topical.queries, idx)
    ub = scoring.block_upper_bounds(topical.queries, idx, qw=qw_b)
    plan = planner.plan_micro_batches(ub.cpu().numpy(),
                                      idx.block_chunk_count.cpu().numpy())
    tau0 = np.full(qw_b.shape[0], -np.inf, np.float32)
    *_, (_, entries, _, _) = planner.bucketed_group_rows(plan.groups, tau0)
    (sample,) = cs.sweep_launches(
        idx, qw_b, ub, [g for _, g in entries[: sizes.sample_groups]],
        min(sizes.k, idx.num_docs))
    fns["bmp_scan"] = sample[4]
    rounds = []
    for r in range(args.rounds):
        rounds.append({name: cs.event_ms(fn, sizes.reps, dev)
                       for name, fn in fns.items()})
        cs.log(f"{args.src} round {r}: {rounds[-1]}")
    card = cs.card_line()
    print(card)
    print(json.dumps({"src": args.src, "card": card, "rounds": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
