#!/usr/bin/env python3
"""Phase 4's kernel times (``chip_smoke.py``) and the main path's
searches of one tree's package, repeated, so two commits can be timed in
turns on one card.

At serve_1m (1,000,000 docs x 500 queries, V = 30,522, k = 1000):
``scatter_score`` over the ``tiled`` index and ``ell_gather`` over the
``ell`` index of the msmarco-like corpus, and the ``bmp_scan`` sample
(the first 4 groups of the largest bucket of the fused engine's plan on
the reordered topical corpus); beside them the main path's steps,
``RetrievalEngine.search`` through ``tiled``, ``ell`` and the two-pass
``tiled-pruned`` engine on the msmarco-like corpus and through the flat
BMP ``tiled-pruned`` and ``tiled-bmp-fused`` engines on the topical one,
``topk_two_stage`` alone on each msmarco-like engine's scores and
``chunk_doc_bounds`` alone on the ``tiled`` index.  The ``bounds`` block:
``scoring.block_upper_bounds`` over the two-pass engine's index and over
the fused engine's, each beside the one-shot ``torch.einsum("bkd,bk->bd",
rows, w)`` over the whole dense [B, K, n_db] rows (``einsum/...``, this
script's own), with the count of entries where the two differ and the
largest difference in f32 ulps.  Each is timed as ``chip_smoke.event_ms``
times it (CUDA events, the mean of 5 runs after a warm-up; of 1 for the
two searches on the topical corpus, seconds each), ``--rounds`` times.
``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default this checkout's); the corpora, the plan and the timing are this
checkout's ``chip_smoke.py``.  Two commits in turns, from the root of a
checkout with one CUDA card:

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    for s in build/parent/src src src build/parent/src; do
        python3 scripts/kernel_turns.py --src $s; done

Each run prints the card's name and power limit and, as its last line,
one JSON object with its times, each engine's build seconds, the peak
device memory of one search (``engines``; the peak counts all the script
holds) and a pruned engine's ``PruneStats``, the bounds' differences
from the one-shot ``einsum`` (``bound_bits``), and the SHA-256 of each
step's first output and of each engine's index arrays (``digests``):
equal digests across two trees mean the same bits.
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


def einsum_bounds(queries, index):
    """The one-shot fine bound over the whole dense [B, K, n_db] rows."""
    import torch

    ids = queries.term_ids.clamp(0, index.vocab_size - 1).long()
    rows = index.term_block_max_q[ids].float()
    w = torch.where(queries.term_ids >= 0, queries.values.abs(), 0.0) * \
        index.term_block_scale[ids]
    return torch.einsum("bkd,bk->bd", rows, w)


def bound_bits(got, want) -> dict:
    """Entries where two nonnegative f32 bounds differ, and the largest
    difference in f32 ulps."""
    import torch

    d = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs()
    return {"differ": int((d > 0).sum()), "entries": d.numel(),
            "max_ulps": int(d.max()) if d.numel() else 0}


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
    from repro_torch.core.index import (
        TILED_ARRAY_FIELDS, TILED_OPTIONAL_ARRAY_FIELDS,
    )
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
    pruned = dict(engine="tiled-pruned", traversal="two-pass")
    for name, cfg, fields in (
            ("tiled", dict(engine="tiled"), TILED_ARRAY_FIELDS),
            ("ell", dict(engine="ell"), ("terms", "values")),
            ("tiled-pruned two-pass", pruned,
             TILED_ARRAY_FIELDS + TILED_OPTIONAL_ARRAY_FIELDS)):
        cs.sync(dev)
        t0 = time.perf_counter()
        eng = engines[name] = RetrievalEngine(corpus.docs, RetrievalConfig(
            k=sizes.k, **cfg), device=dev)
        cs.sync(dev)
        runs[name] = {"build_s": time.perf_counter() - t0}
        digests[f"index/{name}"] = digest(*(
            a for a in (getattr(eng._index, f) for f in fields)
            if a is not None))
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
    reorder = dict(k=sizes.k, reorder_docs=True,
                   reorder_method="df-signature")
    for name, cfg in (("tiled-bmp-fused", dict(engine="tiled-bmp-fused")),
                      ("tiled-pruned bmp", dict(engine="tiled-pruned"))):
        cs.sync(dev)
        t0 = time.perf_counter()
        eng = engines[name] = RetrievalEngine(topical.docs, RetrievalConfig(
            **cfg, **reorder), device=dev)
        cs.sync(dev)
        runs[name] = {"build_s": time.perf_counter() - t0}
        fns[f"search/{name}"] = lambda eng=eng: eng.search(topical.queries,
                                                           k=sizes.k)
    slow = {"search/tiled-bmp-fused", "search/tiled-pruned bmp"}
    for name, qs in (("tiled-pruned two-pass", q),
                     ("tiled-bmp-fused", topical.queries),
                     ("tiled-pruned bmp", topical.queries)):
        runs[name]["prune_stats"] = vars(engines[name].prune_stats(qs))
    bits = {}
    for name, qs in (("tiled-pruned two-pass", q),
                     ("tiled-bmp-fused", topical.queries)):
        pidx = engines[name]._index
        fns[f"bounds/{name}"] = (lambda qs=qs, pidx=pidx:
                                 scoring.block_upper_bounds(qs, pidx))
        fns[f"einsum/{name}"] = (lambda qs=qs, pidx=pidx:
                                 einsum_bounds(qs, pidx))
        bits[name] = bound_bits(fns[f"bounds/{name}"](),
                                fns[f"einsum/{name}"]())
        cs.log(f"{args.src} bounds over {name}'s index against the one-shot "
               f"einsum: {bits[name]}")
    idx = engines["tiled-bmp-fused"]._index
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
        rounds.append({name: cs.event_ms(
            fn, 1 if name in slow else sizes.reps, dev)
            for name, fn in fns.items()})
        cs.log(f"{args.src} round {r}: {rounds[-1]}")
    card = cs.card_line()
    print(card)
    print(json.dumps({"src": args.src, "card": card, "rounds": rounds,
                      "engines": runs, "bound_bits": bits,
                      "digests": digests}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
