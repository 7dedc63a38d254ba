"""Pass ``deprecation-shim``: legacy factories stay thin, loud shims.

The counterpart of :mod:`repro.lint.deprecation_shim`.  The per-engine
serve-step factories collapsed into one
:func:`repro_torch.core.distributed.make_serve_step`; the old
``make_retrieval_serve_step*`` names (four in the port) survive only as
compatibility shims.  A shim that silently stops warning, or quietly
grows its own build path instead of forwarding, reopens the old split
where two factories drift apart.  The shim contract is checked statically on any
``distributed.py``:

  * **D1** — the shim's docstring starts with ``Deprecated`` (callers
    reading help() learn the replacement).
  * **D2** — the body raises a ``DeprecationWarning`` (via the
    ``_deprecated`` helper or ``warnings.warn(..., DeprecationWarning)``).
  * **D3** — the body forwards through ``make_serve_step`` — not a
    private builder — so the legacy names exercise the same single
    factory path the registry wires.

A module-level function is treated as a shim if its name starts with
``make_retrieval_serve_step`` or its docstring starts with
``Deprecated``.
"""
from __future__ import annotations

import ast
import os
from typing import Iterator

from repro_torch.lint.core import FileContext, Finding, LintPass, call_name

PASS_ID = "deprecation-shim"


def _doc(fn: ast.FunctionDef) -> str:
    return ast.get_docstring(fn) or ""


def _warns(fn: ast.FunctionDef) -> bool:
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        if name == "_deprecated":
            return True
        if name == "warn" and any(
            isinstance(a, ast.Name) and a.id == "DeprecationWarning"
            for a in (*node.args, *(kw.value for kw in node.keywords))
        ):
            return True
    return False


def _forwards(fn: ast.FunctionDef) -> bool:
    return any(
        isinstance(node, ast.Call)
        and call_name(node) == "make_serve_step"
        for node in ast.walk(fn)
    )


class DeprecationShimPass(LintPass):
    pass_id = PASS_ID
    description = (
        "deprecated serve-step factories warn (DeprecationWarning) and "
        "forward through make_serve_step, never a private build path"
    )

    def applies_to(self, path: str) -> bool:
        return os.path.basename(path) == "distributed.py"

    def check_file(self, ctx: FileContext) -> Iterator[Finding]:
        for fn in ast.iter_child_nodes(ctx.tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            legacy_name = fn.name.startswith("make_retrieval_serve_step")
            deprecated_doc = _doc(fn).lstrip().startswith("Deprecated")
            if not (legacy_name or deprecated_doc):
                continue
            if not deprecated_doc:
                yield Finding(
                    self.pass_id, ctx.path, fn.lineno,
                    f"legacy factory `{fn.name}` needs a docstring "
                    "starting with 'Deprecated' naming the "
                    "make_serve_step replacement",
                )
            if not _warns(fn):
                yield Finding(
                    self.pass_id, ctx.path, fn.lineno,
                    f"deprecated factory `{fn.name}` never raises a "
                    "DeprecationWarning (call _deprecated(...) or "
                    "warnings.warn(..., DeprecationWarning))",
                )
            if not _forwards(fn):
                yield Finding(
                    self.pass_id, ctx.path, fn.lineno,
                    f"deprecated factory `{fn.name}` does not forward "
                    "through make_serve_step — shims must ride the one "
                    "registry-wired factory path, not a private builder",
                )
