#!/usr/bin/env python3
"""Phase 4's kernel times (``chip_smoke.py``) and the main path's
searches of one tree's package, repeated, so two commits can be timed in
turns on one card.

At serve_1m (1,000,000 docs x 500 queries, V = 30,522, k = 1000):
``scatter_score`` over the ``tiled`` index and ``ell_gather`` over the
``ell`` index of the msmarco-like corpus, and the ``bmp_scan`` sample
(the first 4 groups of the largest bucket of the fused engine's plan on
the reordered topical corpus); beside them the main path's steps,
``RetrievalEngine.search`` through ``tiled`` and ``ell``,
``topk_two_stage`` alone on each engine's scores and ``chunk_doc_bounds``
alone on the ``tiled`` index.  Each is timed as ``chip_smoke.event_ms``
times it (CUDA events, the mean of 5 runs after a warm-up), ``--rounds``
times.  ``--src`` names the ``src`` directory whose ``repro_torch`` is
timed (default this checkout's); the corpora, the plan and the timing are
this checkout's ``chip_smoke.py``.  Two commits in turns, from the root of
a checkout with one CUDA card:

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    for s in build/parent/src src src build/parent/src; do
        python3 scripts/kernel_turns.py --src $s; done

Each run prints the card's name and power limit and, as its last line,
one JSON object with its times, each engine's build seconds and the peak
device memory of one search (``engines``; the peak counts all the script
holds), and the SHA-256 of each step's first output and of each engine's
index arrays (``digests``): equal digests across two trees mean the same
bits.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def digest(*arrays) -> str:
    """SHA-256 of tensors' or numpy arrays' bytes, in order."""
    import torch

    h = hashlib.sha256()
    for a in arrays:
        h.update(torch.as_tensor(a).contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


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
    from repro_torch.core.index import TILED_ARRAY_FIELDS
    from repro_torch.core.topk import topk_two_stage
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
    q, engines, runs, digests = corpus.queries, {}, {}, {}
    for name, fields in (("tiled", TILED_ARRAY_FIELDS),
                         ("ell", ("terms", "values"))):
        cs.sync(dev)
        t0 = time.perf_counter()
        eng = engines[name] = RetrievalEngine(corpus.docs, RetrievalConfig(
            engine=name, k=sizes.k), device=dev)
        cs.sync(dev)
        runs[name] = {"build_s": time.perf_counter() - t0}
        digests[f"index/{name}"] = digest(*(getattr(eng._index, f)
                                            for f in fields))
    tiled, ell = engines["tiled"]._index, engines["ell"]._index
    qw_t = cs.padded_queries(q, tiled)
    qw = q.to_dense()
    fns = {
        "scatter_score": lambda: scatter_ops.scatter_score(
            qw_t, **cs.tiled_args(tiled)),
        "ell_gather": lambda: ell_ops.ell_gather(qw, ell.terms, ell.values),
        "chunk_doc_bounds": lambda: scatter_ops.chunk_doc_bounds(
            tiled.local_doc, tiled.doc_block),
    }
    for name, eng in engines.items():
        torch.cuda.reset_peak_memory_stats(dev)
        fns[f"search/{name}"] = lambda eng=eng: eng.search(q, k=sizes.k)
        digests[f"search/{name}"] = digest(*fns[f"search/{name}"]())
        runs[name]["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        scores = eng.score(q)
        fns[f"topk_two_stage/{name}"] = (
            lambda scores=scores, eng=eng: topk_two_stage(
                scores, sizes.k, block=eng.config.topk_block))
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
    for name, fn in fns.items():
        if name not in digests:
            out = fn()
            digests[name] = digest(*(out if isinstance(out, tuple)
                                     else (out,)))
            del out
    rounds = []
    for r in range(args.rounds):
        rounds.append({name: cs.event_ms(fn, sizes.reps, dev)
                       for name, fn in fns.items()})
        cs.log(f"{args.src} round {r}: {rounds[-1]}")
    card = cs.card_line()
    print(card)
    print(json.dumps({"src": args.src, "card": card, "rounds": rounds,
                      "engines": runs, "digests": digests}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
