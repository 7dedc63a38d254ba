#!/usr/bin/env python3
"""Where the time of a retrieval search goes, on the card.

Builds serve_1m (``make_msmarco_like``: 1,000,000 docs, V = 30,522, 500
queries; ``chip_smoke.py``'s phase 3) and profiles, after a warm-up, one
``RetrievalEngine.search`` through each of ``--engines`` (default
``tiled`` and ``ell``; the paper's comparison points ``bcoo`` and
``segment`` too; k = 1000), and one call of the world-size-1 sharded
``ell`` step (``make_serve_step``; ``--no-step`` leaves it out) under
``torch.profiler``.  For each it prints the
host-clock time of the window (synchronised), the device time summed over
its kernels (one stream, so the busy share is their ratio; the rest is
the device's idle share) and the kernels that took the most device time.
Run from the root of a checkout with one CUDA card:

    python3 scripts/profile_retrieval.py [--docs 1000000] [--queries 500]
        [--engines tiled ell bcoo segment] [--no-step]
"""
from __future__ import annotations

import argparse
import os
import sys

from profile_lm import profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--docs", type=int, default=1_000_000)
    p.add_argument("--queries", type=int, default=500)
    p.add_argument("--vocab", type=int, default=30522)
    p.add_argument("--k", type=int, default=1000)
    p.add_argument("--top", type=int, default=10)
    p.add_argument("--engines", nargs="+", default=["tiled", "ell"])
    p.add_argument("--no-step", action="store_true",
                   help="leave out the sharded ell step")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_retrieval: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import RetrievalConfig, RetrievalEngine
    from repro_torch.core.distributed import build_sharded_ell, make_serve_step
    from repro_torch.data.synthetic import make_msmarco_like

    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), torch.__version__)
    c = make_msmarco_like(args.docs, args.queries, vocab_size=args.vocab,
                          seed=0, device=dev)
    for name in args.engines:
        eng = RetrievalEngine(c.docs, RetrievalConfig(engine=name, k=args.k,
                                                      obs=None), device=dev)
        profile(f"{name} search, {args.docs} docs x {args.queries} queries, "
                f"k={args.k}", lambda: eng.search(c.queries, k=args.k), dev,
                args.top)
        del eng
        torch.cuda.empty_cache()
    if args.no_step:
        return 0
    idx = build_sharded_ell(c.docs, 1)
    step = make_serve_step(engine="ell",
                           cfg=RetrievalConfig(engine="ell", k=args.k,
                                               obs=None),
                           docs_per_shard=idx.docs_per_shard)
    profile(f"sharded ell step, world size 1, {args.docs} docs x "
            f"{args.queries} queries, k={args.k}",
            lambda: step(idx, queries=c.queries), dev, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
