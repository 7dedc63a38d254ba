"""Pass ``accum-dtype``: running sums accumulate in float32.

The port's counterpart of :mod:`repro.lint.accum_dtype`, as a taint pass
inside each function of the plain versions (``kernels/*/ref.py``) and of
the scoring path (``core/{scoring,topk,distributed}.py``).  The port's bf16
contract (the scoring kernels' bf16 routes): bf16 operands are widened to
f32, every product is exact, the sum runs in f32 and each score is rounded
**once**.  So:

* a value is *half* while its dtype is bfloat16/float16 — after
  ``.to(torch.bfloat16/float16/half)``, ``.bfloat16()``, ``.half()``, or a
  call with a half ``dtype=`` (an allocation);
* a value is *tainted* once it has been half: casting back up
  (``.float()``, ``.to(torch.float32)``) does not clear it, the precision
  is already lost; arithmetic, indexing and method calls carry both bits
  from their operands.

Reported: a running sum — ``+=``/``-=``, ``index_add_``, ``scatter_add_``,
``add_``, ``.sum``/``.cumsum`` (method or ``torch.`` function) — whose
accumulator is half (``.sum``/``.cumsum`` with ``dtype=torch.float32`` is
an f32 accumulator), or that folds a tainted value into an f32 one (a
second rounding of a rounded value).

Allowed, the two idioms of the contract: a ``matmul``/``mm``/``bmm``/
``einsum``/``linear``/``@`` of bf16 operands (the tensor cores accumulate
in f32 and round once: the product is half but not tainted), and a final
cast on the way out (``return x.to(torch.bfloat16)``), which sums nothing.
Parameters start clean (their dtype is the caller's), and branches are not
told apart (a documented limit: the pass reads each function top to
bottom, the last assignment of a name winning).
"""
from __future__ import annotations

import ast
import os
from typing import Iterator

from repro_torch.lint.core import (
    FileContext, Finding, LintPass, call_name, dotted_name, func_defs,
)

PASS_ID = "accum-dtype"

_HALF = {"bfloat16", "float16", "half"}
_WIDE = {"float32", "float", "float64", "double"}
_MATMUL = {"matmul", "mm", "bmm", "einsum", "linear", "addmm", "baddbmm"}
_SUMS = {"sum", "cumsum", "nansum"}
_ADDS = {"index_add_", "scatter_add_", "add_", "index_add", "scatter_add"}
_SCOPE = ("core/scoring.py", "core/topk.py", "core/distributed.py")

CLEAN = (False, False)  # (half now, tainted)


def _dtype_kind(node) -> str:
    """"half", "wide" or "" for a dtype expression."""
    name = (dotted_name(node) or "").rsplit(".", 1)[-1]
    if name in _HALF:
        return "half"
    if name in _WIDE:
        return "wide"
    return ""


def _kw(call: ast.Call, name: str):
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _in_scope(path: str) -> bool:
    norm = path.replace(os.sep, "/")
    parts = norm.split("/")
    if len(parts) >= 3 and parts[-3] == "kernels" and parts[-1] == "ref.py":
        return True
    return any(norm.endswith("/" + s) or norm == s for s in _SCOPE)


class _Taint:
    """The (half, tainted) state of each name, read top to bottom."""

    def __init__(self):
        self.names: dict[str, tuple[bool, bool]] = {}

    def of(self, node) -> tuple[bool, bool]:
        if node is None:
            return CLEAN
        if isinstance(node, ast.Name):
            return self.names.get(node.id, CLEAN)
        if isinstance(node, ast.Starred):
            return self.of(node.value)
        if isinstance(node, (ast.Subscript, ast.Attribute)):
            return self.of(node.value) if isinstance(
                node, ast.Subscript) else CLEAN
        if isinstance(node, ast.BinOp):
            if isinstance(node.op, ast.MatMult):
                return self._matmul([node.left, node.right])
            return self._join([node.left, node.right])
        if isinstance(node, ast.UnaryOp):
            return self.of(node.operand)
        if isinstance(node, ast.IfExp):
            return self._join([node.body, node.orelse])
        if isinstance(node, (ast.Tuple, ast.List)):
            return self._join(node.elts)
        if isinstance(node, ast.Call):
            return self._call(node)
        return CLEAN

    def _join(self, nodes) -> tuple[bool, bool]:
        states = [self.of(n) for n in nodes]
        return (any(s[0] for s in states), any(s[1] for s in states))

    def _matmul(self, operands) -> tuple[bool, bool]:
        half, _ = self._join(operands)
        return (half, False)  # f32 accumulation, one rounding

    def _call(self, node: ast.Call) -> tuple[bool, bool]:
        name = call_name(node) or ""
        recv = node.func.value if isinstance(node.func, ast.Attribute) \
            else None
        dt = _kw(node, "dtype")
        if name in ("bfloat16", "half") and recv is not None:
            return (True, True)
        if name in ("float", "double") and recv is not None:
            return (False, self.of(recv)[1])
        if name in ("to", "type") and recv is not None:
            target = node.args[0] if node.args else dt
            kind = _dtype_kind(target) if target is not None else ""
            if kind == "half":
                return (True, True)
            if kind == "wide":
                return (False, self.of(recv)[1])
            return self.of(recv)
        if name in _MATMUL:
            args = list(node.args) + ([recv] if recv is not None else [])
            return self._matmul(args)
        if dt is not None and _dtype_kind(dt) == "half":
            return (True, True)
        if dt is not None and _dtype_kind(dt) == "wide" and name in _SUMS:
            return (False, self.of(recv if recv is not None else
                                   (node.args[0] if node.args else None))[1])
        parts = list(node.args) + [kw.value for kw in node.keywords]
        if recv is not None:
            parts.append(recv)
        return self._join(parts)

    def bind(self, target, state) -> None:
        if isinstance(target, ast.Name):
            self.names[target.id] = state
        elif isinstance(target, (ast.Tuple, ast.List)):
            for t in target.elts:
                self.bind(t, state)


class AccumDtypePass(LintPass):
    pass_id = PASS_ID
    description = (
        "running sums in the plain versions and the scoring path accumulate "
        "in f32: no half accumulator, no rounded value folded into an f32 "
        "sum (bf16 matmul/einsum and a final cast are the contract's idioms)"
    )

    def applies_to(self, path: str) -> bool:
        return _in_scope(path)

    def check_file(self, ctx: FileContext) -> Iterator[Finding]:
        for fn in func_defs(ctx.tree):
            yield from self._check_function(ctx, fn)

    def _check_function(self, ctx, fn) -> Iterator[Finding]:
        taint = _Taint()
        for stmt in self._statements(fn.body):
            if isinstance(stmt, ast.Assign):
                state = taint.of(stmt.value)
                for t in stmt.targets:
                    taint.bind(t, state)
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                taint.bind(stmt.target, taint.of(stmt.value))
            elif isinstance(stmt, ast.AugAssign) and isinstance(
                    stmt.op, (ast.Add, ast.Sub)):
                yield from self._fold(ctx, fn, stmt.lineno,
                                      taint.of(stmt.target),
                                      taint.of(stmt.value), "+=")
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call):
                    yield from self._check_call(ctx, fn, node, taint)

    @staticmethod
    def _statements(body):
        """The function's statements in order, compound bodies inlined,
        nested functions left to their own check."""
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, (ast.If, ast.For, ast.While, ast.With,
                                 ast.Try)):
                head = stmt.test if isinstance(stmt, (ast.If, ast.While)) \
                    else None
                if head is not None:
                    yield ast.Expr(head, lineno=stmt.lineno)
                for field in ("body", "orelse", "finalbody"):
                    yield from AccumDtypePass._statements(
                        getattr(stmt, field, []))
                for h in getattr(stmt, "handlers", []):
                    yield from AccumDtypePass._statements(h.body)
                continue
            yield stmt

    def _check_call(self, ctx, fn, node: ast.Call, taint: _Taint):
        name = call_name(node) or ""
        recv = node.func.value if isinstance(node.func, ast.Attribute) \
            else None
        if name in _ADDS and recv is not None and node.args and not (
                dotted_name(node.func) or "").startswith("torch."):
            yield from self._fold(ctx, fn, node.lineno, taint.of(recv),
                                  taint.of(node.args[-1]), f".{name}")
        elif name in _SUMS:
            operand = recv if recv is not None and not (
                dotted_name(node.func) or "").startswith("torch.") else (
                node.args[0] if node.args else None)
            half, tainted = taint.of(operand)
            f32 = _dtype_kind(_kw(node, "dtype")) == "wide"
            if half and not f32:
                yield Finding(
                    self.pass_id, ctx.path, node.lineno,
                    f"`{name}` over a half value accumulates in half in "
                    f"`{fn.name}`: pass dtype=torch.float32 (widen, sum in "
                    "f32, round once)")
            elif tainted and not half:
                yield Finding(
                    self.pass_id, ctx.path, node.lineno,
                    f"`{name}` in `{fn.name}` sums values already rounded "
                    "to half and widened: each result must be rounded once, "
                    "at the end")

    def _fold(self, ctx, fn, line, acc, value, how: str):
        if acc[0]:
            yield Finding(
                self.pass_id, ctx.path, line,
                f"running sum ({how}) into a half accumulator in "
                f"`{fn.name}`: the sum rounds every step; accumulate in f32 "
                "and round once")
        elif value[1]:
            yield Finding(
                self.pass_id, ctx.path, line,
                f"running sum ({how}) in `{fn.name}` folds a value rounded "
                "to half into an f32 accumulator: a second rounding; widen "
                "the operands before the product, round once at the end")
