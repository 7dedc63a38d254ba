#!/usr/bin/env python3
"""Where the time of a recsys forward and of a retrieval call goes, on the
card.

Builds each recsys model at full width (``repro_torch.configs.<model>.
FULL``) with seeded random weights and profiles, after a warm-up, one
``forward`` of a ``make_recsys_batch`` batch of B examples with bags of H
ids (the serve_p99 shape of ``chip_smoke.py``'s phase 6b) and one
retrieval call (``score_candidates`` over C candidates for the batch's
first user, then the top 100; DIN over fewer, as in phase 6c) under
``torch.profiler``.  For each it prints the host-clock time of the window
(synchronised), the device time summed over its kernels (one stream, so
the busy share is their ratio) and the kernels that took the most device
time.  Run from the root of a checkout with one CUDA card:

    python3 scripts/profile_recsys.py [--batch 512] [--hot 8]
"""
from __future__ import annotations

import argparse
import importlib
import os
import sys

from profile_lm import profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--models", default="xdeepfm,autoint,din,dien")
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--hot", type=int, default=8)
    p.add_argument("--candidates", type=int, default=1_000_000)
    p.add_argument("--din-candidates", type=int, default=65_536)
    p.add_argument("--top", type=int, default=10)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_recsys: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.topk import topk
    from repro_torch.data.synthetic import make_recsys_batch
    from repro_torch.models.recsys import build_model

    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), torch.__version__)
    for name in args.models.split(","):
        cfg = importlib.import_module(f"repro_torch.configs.{name}").FULL
        model = build_model(cfg, device=dev, seed=0)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in make_recsys_batch(
            args.batch, cfg.n_sparse, cfg.vocab_sizes, cfg.seq_len,
            cfg.item_vocab, multi_hot=args.hot, seed=0).items()}
        user = {k: v[:1] for k, v in batch.items()}
        c = args.din_candidates if name == "din" else args.candidates
        cand = torch.arange(c, dtype=torch.int32, device=dev)

        def retrieve():
            vals, idx = topk(model.score_candidates(user, cand), 100)
            return vals, cand[idx]

        with torch.inference_mode():
            profile(f"{cfg.name} forward B={args.batch} H={args.hot}",
                    lambda: model(batch), dev, args.top)
            profile(f"{cfg.name} retrieval {c} candidates, top-100",
                    retrieve, dev, args.top)
        del model, batch, user, cand
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
