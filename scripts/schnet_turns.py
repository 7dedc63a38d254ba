#!/usr/bin/env python3
"""SchNet's train steps (``chip_smoke.py`` phase 12a) in fresh processes,
in turns, to tell what a long-lived process adds to them.

Each turn is a new process that times 12a's three cells
(``chip_smoke.schnet_cell``: a warm-up and 10 steps, the median) under one
variant: ``A`` as launched, ``B`` with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``
(what ``chip_smoke.main`` sets for phase 7's deterministic restart), ``D``
with 5 million small Python objects kept alive first (a large heap for the
collector to walk).  Run from the root of a checkout with one CUDA card:

    python3 scripts/schnet_turns.py [--order A B D D B A]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"A": ({}, 0), "B": ({"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}, 0),
            "D": ({}, 5)}


def one_turn(ballast_millions: int) -> dict:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    import chip_smoke as cs

    ballast = [{"i": i, "l": [i]} for i in range(ballast_millions * 10**6)]
    dev = torch.device("cuda", 0)
    sizes = cs.Sizes()
    out = {}
    for name in sizes.schnet_cells:
        est = cs.dryrun_cell(("schnet", name))
        out[name] = cs.schnet_cell(dev, sizes, name, est)["ms"]
    del ballast
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--order", nargs="+", default=list("ABDDBA"),
                    choices=sorted(VARIANTS))
    ap.add_argument("--one", type=int, default=None,
                    help=argparse.SUPPRESS)  # a turn's own process
    args = ap.parse_args()
    if args.one is not None:
        print("TURN " + json.dumps(one_turn(args.one)), flush=True)
        return 0
    base = {k: v for k, v in os.environ.items()
            if k != "CUBLAS_WORKSPACE_CONFIG"}
    for tag in args.order:
        env, ballast = VARIANTS[tag]
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one",
             str(ballast)], env={**base, **env}, capture_output=True,
            text=True, check=True)
        line = next(ln for ln in proc.stdout.splitlines()
                    if ln.startswith("TURN "))
        print(tag, env.get("CUBLAS_WORKSPACE_CONFIG"), ballast,
              line[len("TURN "):], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
