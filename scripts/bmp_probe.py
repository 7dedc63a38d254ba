#!/usr/bin/env python3
"""The pruned path's sweep kernel alone, at ``chip_smoke.py``'s serve_1m
topical shape: ``bmp_scan`` (``src/repro_torch/csrc/bmp_scan.cu``).

Builds the kernel and prints the compiler's report (registers, spills per
route), generates ``make_topical_corpus(1,000,000, 500)`` (seed 0) on the
card, builds the ``tiled-bmp-fused`` engine with ``df-signature``
reordering, runs one search call (host clock; the ``bmp_scan`` counter
zeroed before and read after), then ``chip_smoke.bmp_row``: the main
path's sample groups and two of its one-row groups against the plain
version (fetch sets and steps equal, scores, heap and tau within
KERNEL_TOL), and CUDA-event times of the sample launch, of the launch of
the one-row groups and of every launch of a call, each beside its bound
and its floor.  Run from the root of a checkout with one CUDA card:

    python3 scripts/bmp_probe.py [--docs N]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=1_000_000)
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.core import RetrievalConfig, RetrievalEngine
    from repro_torch.data.synthetic import make_topical_corpus
    from repro_torch.kernels import build
    from repro_torch.kernels.bmp_scan import ops as bmp_ops

    if not torch.cuda.is_available():
        print("bmp_probe: no CUDA device", file=sys.stderr)
        return 2
    cs.log(f"card: {cs.card_line()}")
    dev = torch.device("cuda", 0)
    sizes = dataclasses.replace(cs.Sizes(), docs=args.docs)
    t0 = time.perf_counter()
    build.build(["bmp_scan"])
    cs.log(f"build: {time.perf_counter() - t0:.3f} s")
    for line in build.compiler_log.get("bmp_scan", "").splitlines():
        if "registers" in line or "spill" in line.lower() or "entry" in line:
            cs.log(f"  {line.strip()}")
    corpus = make_topical_corpus(sizes.docs, sizes.queries,
                                 vocab_size=sizes.vocab, seed=0, device=dev)
    eng = RetrievalEngine(corpus.docs, RetrievalConfig(
        engine="tiled-bmp-fused", k=sizes.k, reorder_docs=True,
        reorder_method="df-signature"), device=dev)
    cs.sync(dev)
    bmp_ops.launches = 0
    _, _, ms = cs.time_search("tiled-bmp-fused, main", eng, corpus.queries,
                              sizes.k, 0, dev)
    main = dict(engine=eng, queries=corpus.queries,
                launches=bmp_ops.launches, ms=ms)
    cs.log(f"  bmp_scan launches in the call: {main['launches']}")
    row = cs.bmp_row(dev, sizes, main, 0.0)
    cs.log(f"  row: {row}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
