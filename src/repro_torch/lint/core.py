"""Lint framework: findings, the pass protocol, walker, suppressions.

The port's own copy of :mod:`repro.lint.core` (the port imports nothing of
the JAX package).  A :class:`LintPass` sees every linted file as a parsed
``ast`` tree plus raw source (``check_file``), and once more after the walk
for whole-tree checks (``finalize``, where the kernel-shape pass runs each
kernel entry's CUDA branch on fake tensors).  Passes never launch a kernel
or touch a device: the class of fault caught here ("tests pass, hardware
lies": a CUDA branch that falls back to the plain version, a host round
trip on the serve path, a half-precision running sum) is exactly the class
the CPU tests only sample.  The device half (``--device cuda``) is
:mod:`repro_torch.lint.sanitize`.

Suppressions: a finding is silenced by a comment

    # lint: disable=<pass-id>[,<pass-id>...] -- <justification>

on the finding's line, or on the *first* line of the multi-line
statement containing it (a disable on ``grid_spec = Spec(`` covers
findings on the continuation lines of that call).  Compound statements
(``def``/``if``/``for``…) only span their header — a disable on a
``def`` line cannot silence the whole body.  The justification is
**required**; a disable comment without one is itself reported (pass id
``suppression``), so every suppression in the tree documents why the
contract does not apply there.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Iterable, Iterator, Optional, Sequence

_SUPPRESS_RE = re.compile(
    r"#\s*lint:\s*disable=([A-Za-z0-9_,-]+)(?:\s+--\s*(\S.*))?"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation at a source location."""

    pass_id: str
    path: str
    line: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.pass_id}] {self.message}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class FileContext:
    """A parsed file as the passes see it."""

    path: str
    source: str
    tree: ast.AST
    # line -> (pass ids disabled on that line, justification or None)
    suppressions: dict[int, tuple[set[str], Optional[str]]]
    # statement-start line -> last line that suppression covers
    spans: dict[int, int] = dataclasses.field(default_factory=dict)

    def suppression_at(self, line: int):
        """The suppression governing ``line``: exact-line first, then
        the enclosing statement's start line (span rule)."""
        hit = self.suppressions.get(line)
        if hit is not None:
            return hit
        for start, (ids, why) in self.suppressions.items():
            if start <= line <= self.spans.get(start, start):
                return ids, why
        return None


class LintPass:
    """One contract.  Subclasses set ``pass_id``/``description`` and
    override ``check_file`` (per parsed file) and/or ``finalize`` (once,
    over every walked file); a pass with a device half (``kind`` "device"
    or "both") also overrides ``device_findings``, which reads the results
    of :func:`repro_torch.lint.sanitize.run` (``--device cuda``)."""

    pass_id: str = ""
    description: str = ""
    kind: str = "static"  # "static", "device" or "both"

    def applies_to(self, path: str) -> bool:
        return True

    def check_file(self, ctx: FileContext) -> Iterator[Finding]:
        return iter(())

    def finalize(self, files: Sequence[FileContext]) -> Iterator[Finding]:
        return iter(())

    def device_findings(self, results: dict) -> list[Finding]:
        return []


@dataclasses.dataclass
class Report:
    """What a lint run produced: the surviving findings plus coverage
    counters."""

    findings: list[Finding]
    files_checked: int
    passes_run: tuple[str, ...]
    suppressed: int = 0
    from_cache: int = 0
    # --device cuda: route -> each check's status
    # (repro_torch.lint.sanitize.run's "routes")
    device: Optional[dict] = None

    @property
    def clean(self) -> bool:
        return not self.findings

    def as_dict(self) -> dict:
        return {
            "clean": self.clean,
            "files_checked": self.files_checked,
            "passes": list(self.passes_run),
            "suppressed": self.suppressed,
            "from_cache": self.from_cache,
            "findings": [f.as_dict() for f in self.findings],
            "device": self.device,
        }


def _parse_suppressions(source: str) -> dict:
    out: dict[int, tuple[set[str], Optional[str]]] = {}
    for lineno, line in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if m:
            ids = {p.strip() for p in m.group(1).split(",") if p.strip()}
            out[lineno] = (ids, m.group(2))
    return out


def _stmt_spans(tree: ast.AST) -> dict[int, int]:
    """Map each statement's start line to the last line a suppression
    there covers.  Simple statements cover their whole extent
    (continuation lines of a multi-line call); compound statements
    cover only their header, so a ``def``-line disable cannot silence
    the body.  Decorators span themselves."""
    spans: dict[int, int] = {}

    def note(start: int, end: int) -> None:
        spans[start] = max(spans.get(start, start), max(start, end))

    for node in ast.walk(tree):
        if not isinstance(node, ast.stmt):
            continue
        end = getattr(node, "end_lineno", None) or node.lineno
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.stmt):
            end = body[0].lineno - 1  # header only
        note(node.lineno, end)
        for deco in getattr(node, "decorator_list", []):
            note(deco.lineno,
                 getattr(deco, "end_lineno", None) or deco.lineno)
    return spans


def iter_python_files(paths: Iterable[str]) -> list[str]:
    """Expand files/directories into a sorted .py file list."""
    out = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs
                    if d not in ("__pycache__", ".git", ".ipynb_checkpoints")
                )
                out.extend(
                    os.path.join(root, n) for n in sorted(names)
                    if n.endswith(".py")
                )
        elif p.endswith(".py"):
            out.append(p)
    return sorted(dict.fromkeys(out))


def load_file(path: str) -> tuple[Optional[FileContext], Optional[Finding]]:
    """Parse one file; a syntax error is itself a finding."""
    try:
        with open(path, encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=path)
    except (OSError, SyntaxError, ValueError) as e:
        line = getattr(e, "lineno", 1) or 1
        return None, Finding("parse", path, line, f"cannot parse: {e}")
    return FileContext(path, source, tree, _parse_suppressions(source),
                       _stmt_spans(tree)), None


def _apply_suppressions(
    findings: list[Finding], ctx: FileContext
) -> tuple[list[Finding], int]:
    """Drop findings disabled on their line (or on the start line of
    the statement spanning it); flag justification-less disables."""
    kept, dropped = [], 0
    for f in findings:
        ids, why = ctx.suppression_at(f.line) or (set(), None)
        if f.pass_id in ids or "all" in ids:
            if why:
                dropped += 1
                continue
            kept.append(Finding(
                "suppression", ctx.path, f.line,
                f"suppression of [{f.pass_id}] carries no justification "
                "(write `# lint: disable=... -- <reason>`)",
            ))
        else:
            kept.append(f)
    return kept, dropped


def run_passes(
    paths: Sequence[str],
    passes: Sequence[LintPass],
    select: Optional[Iterable[str]] = None,
    cache=None,
) -> Report:
    """Walk ``paths``, run every (selected) pass, return the report.

    With a :class:`repro_torch.lint.cache.LintCache`, files whose content
    hash and pass roster match a prior run replay their recorded
    findings and are excluded from the walk entirely — ``finalize``
    (the fake-tensor execution layer) never sees them.
    """
    if select is not None:
        wanted = set(select)
        unknown = wanted - {p.pass_id for p in passes}
        if unknown:
            raise ValueError(
                f"unknown pass id(s) {sorted(unknown)}; available: "
                f"{sorted(p.pass_id for p in passes)}"
            )
        passes = [p for p in passes if p.pass_id in wanted]

    files: list[FileContext] = []
    findings: list[Finding] = []
    per_file: dict[str, tuple[str, list[Finding], int]] = {}
    suppressed = 0
    from_cache = 0
    py_files = iter_python_files(paths)
    if cache is not None:
        cache.bind_tree(py_files)
    for path in py_files:
        key = cache.file_key(path) if cache is not None else None
        if cache is not None:
            hit = cache.lookup(path, key)
            if hit is not None:
                cached_findings, cached_suppressed = hit
                findings.extend(cached_findings)
                suppressed += cached_suppressed
                from_cache += 1
                continue
        ctx, err = load_file(path)
        if err is not None:
            findings.append(err)
            if cache is not None:
                cache.store(path, key, [err], 0)
            continue
        files.append(ctx)
        raw = []
        for p in passes:
            if p.applies_to(path):
                raw.extend(p.check_file(ctx))
        kept, dropped = _apply_suppressions(raw, ctx)
        findings.extend(kept)
        suppressed += dropped
        per_file[ctx.path] = (key, kept, dropped)
    ctx_by_path = {c.path: c for c in files}
    for p in passes:
        by_path: dict[str, list[Finding]] = {}
        for f in p.finalize(files):
            by_path.setdefault(f.path, []).append(f)
        for fpath, raw in by_path.items():
            ctx = ctx_by_path.get(fpath)
            if ctx is None:
                findings.extend(raw)
                continue
            kept, dropped = _apply_suppressions(raw, ctx)
            findings.extend(kept)
            suppressed += dropped
            key, prev, pdrop = per_file[fpath]
            per_file[fpath] = (key, prev + kept, pdrop + dropped)
    if cache is not None:
        for fpath, (key, kept, dropped) in per_file.items():
            cache.store(fpath, key, kept, dropped)
        cache.save()
    findings.sort(key=lambda f: (f.path, f.line, f.pass_id))
    return Report(
        findings=findings,
        files_checked=len(py_files),
        passes_run=tuple(p.pass_id for p in passes),
        suppressed=suppressed,
        from_cache=from_cache,
    )


# --- small AST helpers shared by the passes --------------------------------


def call_name(node: ast.AST) -> Optional[str]:
    """The trailing name of a called expression: ``f(...)`` -> "f",
    ``a.b.f(...)`` -> "f"; None for anything else."""
    if isinstance(node, ast.Call):
        node = node.func
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` -> "a.b.c" (Names/Attributes only)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def func_defs(tree: ast.AST) -> Iterator[ast.FunctionDef]:
    """Every function definition in the tree (any nesting)."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def param_names(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    return [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)]


def param_default(fn: ast.FunctionDef, name: str) -> tuple[bool, ast.AST]:
    """(has_default, default_node) for parameter ``name``."""
    a = fn.args
    pos = [*a.posonlyargs, *a.args]
    n_def = len(a.defaults)
    for i, p in enumerate(pos):
        if p.arg == name:
            j = i - (len(pos) - n_def)
            if j >= 0:
                return True, a.defaults[j]
            return False, None
    for p, d in zip(a.kwonlyargs, a.kw_defaults):
        if p.arg == name:
            return (d is not None), d
    return False, None
