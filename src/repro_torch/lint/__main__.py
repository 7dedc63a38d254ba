"""CLI for ``repro_torch.lint``: ``python -m repro_torch.lint [paths]
[options]``.

Exit status is the CI contract: 0 iff no findings survived suppressions,
1 otherwise, 2 for usage errors.  ``--device cuda`` raises without a card:
the device half never skips quietly.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from repro_torch.lint import make_passes, run_paths


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="Static and device checks of the PyTorch port's own "
                    "contracts (the device rule, host syncs, registry "
                    "conformance, kernel shapes, deprecation shims, timing, "
                    "kernel memory and races, f32 accumulation).",
    )
    parser.add_argument(
        "paths", nargs="*", default=["src/repro_torch"],
        help="files or directories to lint (default: src/repro_torch)",
    )
    parser.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="text prints path:line: [pass] message; json emits the full "
             "report object",
    )
    parser.add_argument(
        "--select", action="append", default=None, metavar="PASS_ID",
        help="run only the given pass id(s); repeatable, or comma-separated",
    )
    parser.add_argument(
        "--cache", action="store_true",
        help="replay the findings of an unchanged tree (see "
             "repro_torch.lint.cache)",
    )
    parser.add_argument(
        "--device", choices=("cuda",), default=None,
        help="also run the device halves (kernel-memory, kernel-race) of "
             "the selected passes on the card; raises without one",
    )
    parser.add_argument(
        "--list-passes", action="store_true",
        help="list registered pass ids, each static, device or both, and "
             "exit",
    )
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _build_parser().parse_args(argv)

    if args.list_passes:
        for p in make_passes():
            print(f"{p.pass_id:22s} {p.kind:7s} {p.description}")
        return 0

    select = None
    if args.select is not None:
        select = [s.strip() for item in args.select for s in item.split(",")
                  if s.strip()]
    cache = None
    if args.cache:
        from repro_torch.lint.cache import DEFAULT_CACHE_PATH, LintCache

        roster = select if select is not None else [
            p.pass_id for p in make_passes()]
        cache = LintCache(DEFAULT_CACHE_PATH, roster)

    try:
        report = run_paths(args.paths, select=select, cache=cache,
                           device=args.device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.format == "json":
        print(json.dumps(report.as_dict(), indent=2))
    else:
        for finding in report.findings:
            print(finding.format())
        for name, res in (report.device or {}).get("routes", {}).items():
            print(f"device {name}: " + ", ".join(
                f"{k} {v}" for k, v in res.items()))
        status = "clean" if report.clean else (
            f"{len(report.findings)} finding(s)")
        cached = (f", {report.from_cache} from cache"
                  if report.from_cache else "")
        print(f"repro_torch.lint: {status} — {report.files_checked} "
              f"file(s), {len(report.passes_run)} pass(es), "
              f"{report.suppressed} suppressed{cached}", file=sys.stderr)
    return 0 if report.clean else 1


if __name__ == "__main__":
    sys.exit(main())
