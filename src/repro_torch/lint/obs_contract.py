"""obs-contract: all timing funnels through ``repro_torch.obs``.

The counterpart of :mod:`repro.lint.obs_contract`, the same contract.
Outside ``repro_torch/obs`` (the funnel itself) and ``benchmarks/``
(standalone timing harnesses), no source file calls
``time.time()`` / ``time.perf_counter()`` / ``time.perf_counter_ns()``
directly.  Raw clock reads scattered through the serve path are exactly
how the repo ended up with five disconnected stat islands: each one
picks its own clock domain, none is fenced against async dispatch, and
none aggregates.  ``repro_torch.obs.clock()`` is the one blessed
wall-clock read; measurements belong in ``obs`` spans/timers so they are
fenced (``torch.cuda.synchronize`` of the tree's devices) and land in the
shared registry.  The port's kernels are timed with CUDA events, which
this contract leaves alone.

Explicitly allowed: ``time.monotonic`` (the scheduler's clock-injection
*default*, a scheduling input rather than a measurement), ``time.sleep``
and friends — only the three measuring reads above are the contract.

Detection is call-based: dotted calls (``time.time()`` — any module
alias of ``time`` via ``import time as t`` is matched by attribute
name), and bare calls of names imported with
``from time import perf_counter [as alias]``.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.lint.core import FileContext, Finding, LintPass, dotted_name

PASS_ID = "obs-contract"

#: the measuring reads the contract forbids outside the funnel
_FORBIDDEN = ("time", "perf_counter", "perf_counter_ns")

_EXEMPT_PARTS = (
    ("repro_torch", "obs"),  # the funnel itself
    ("benchmarks",),   # standalone timing harnesses
)


def _norm_parts(path: str) -> tuple:
    return tuple(path.replace("\\", "/").split("/"))


def _is_exempt(path: str) -> bool:
    parts = _norm_parts(path)
    for sub in _EXEMPT_PARTS:
        n = len(sub)
        if any(parts[i:i + n] == sub for i in range(len(parts) - n + 1)):
            return True
    return False


def _time_aliases(tree: ast.AST) -> tuple[set, set]:
    """(module aliases of ``time``, local names bound to forbidden
    members via ``from time import ...``)."""
    mod_aliases: set[str] = set()
    member_aliases: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "time":
                    mod_aliases.add(a.asname or "time")
        elif isinstance(node, ast.ImportFrom) and node.module == "time":
            for a in node.names:
                if a.name in _FORBIDDEN:
                    member_aliases.add(a.asname or a.name)
    return mod_aliases, member_aliases


class ObsContractPass(LintPass):
    pass_id = PASS_ID
    description = (
        "raw time.time()/time.perf_counter() calls outside repro_torch.obs "
        "and benchmarks/ (timing must funnel through repro_torch.obs.clock "
        "/ spans so it is fenced and aggregated)"
    )

    def applies_to(self, path: str) -> bool:
        return not _is_exempt(path)

    def check_file(self, ctx: FileContext) -> Iterator[Finding]:
        mod_aliases, member_aliases = _time_aliases(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            bad = None
            if isinstance(fn, ast.Attribute):
                d = dotted_name(fn)
                if d is not None:
                    head, _, member = d.rpartition(".")
                    if head in mod_aliases and member in _FORBIDDEN:
                        bad = f"{head}.{member}"
            elif isinstance(fn, ast.Name) and fn.id in member_aliases:
                bad = fn.id
            if bad is not None:
                yield Finding(
                    self.pass_id, ctx.path, node.lineno,
                    f"raw clock read {bad}() — use repro_torch.obs.clock() "
                    "(or an obs span/timer, which also fences device "
                    "work) so the measurement lands in the shared "
                    "registry",
                )
