"""Roofline report: reads ``launch.dryrun``'s artifacts, prints the
roofline table, the memory-fit table at the card's memory and the cells
to climb first (``repro.analysis.report``).

    PYTHONPATH=src python -m repro_torch.analysis.report [--layout single]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.analysis.roofline import (
    HBM_BYTES, RooflineTerms, format_table, roofline_from_artifacts,
)

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "build", "dryrun")


def load_terms(layout: str = "single",
               results_dir: str = RESULTS_DIR) -> list[RooflineTerms]:
    terms = []
    pattern = os.path.join(results_dir, f"*__{layout}.json")
    for path in sorted(glob.glob(pattern)):
        with open(path) as f:
            terms.append(roofline_from_artifacts(json.load(f)))
    return terms


def fits(t: RooflineTerms, hbm_bytes: float = HBM_BYTES) -> bool:
    return t.meta.get("peak_bytes", 0.0) <= hbm_bytes


def memory_fit_table(terms: list[RooflineTerms],
                     hbm_bytes: float = HBM_BYTES) -> str:
    cap = f"fits {hbm_bytes / 1e9:.1f}GB"
    lines = [f"{'arch':<14} {'shape':<14} {'peak/dev GB':>11} {cap:>12}"]
    for t in terms:
        m = t.meta.get("peak_bytes", 0.0)
        lines.append(f"{t.arch:<14} {t.shape:<14} {m / 1e9:>11.2f} "
                     f"{'yes' if fits(t, hbm_bytes) else 'NO':>12}")
    return "\n".join(lines)


def pick_hillclimb(terms: list[RooflineTerms]) -> dict:
    """Worst roofline fraction, most collective-bound, most paper-like."""
    nonzero = [t for t in terms if t.bound_time > 0 and t.model_flops > 0]
    worst = min(nonzero, key=lambda t: t.roofline_fraction)
    coll = max(nonzero,
               key=lambda t: t.t_collective / max(t.bound_time, 1e-12))
    paper = [t for t in terms if t.arch == "gpusparse"]
    paper_pick = (max(paper, key=lambda t: t.meta.get("num_docs", 0))
                  if paper else None)
    reps = [t for t in nonzero if t.shape == "retrieval_cand"]
    rep = max(reps, key=lambda t: t.bound_time) if reps else None
    return {"worst_fraction": worst, "most_collective": coll,
            "paper_technique": paper_pick or rep}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layout", default="single")
    ap.add_argument("--dir", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    terms = load_terms(args.layout, args.dir)
    if not terms:
        raise SystemExit(f"no artifacts for {args.layout} under {args.dir}; "
                         "run python -m repro_torch.launch.dryrun first")
    print(format_table(terms))
    print()
    print(memory_fit_table(terms))
    print()
    for why, t in pick_hillclimb(terms).items():
        if t:
            print(f"hillclimb[{why}]: {t.arch}/{t.shape} "
                  f"dominant={t.dominant} fraction={t.roofline_fraction:.4f}")


if __name__ == "__main__":
    main()
