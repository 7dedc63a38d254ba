"""Pass ``device-contract``: where a kernel entry actually runs.

The port's counterpart of :mod:`repro.lint.interpret_contract` and of the
fault it was written for (a kernel entry that quietly ran the interpreter
on the accelerator while every test stayed green).  In the port the same
fault is a CUDA branch that gives way to the plain version, or a launch
nobody counts or checks.  The device rule (``repro_torch.utils
.resolve_device``, ``src/repro_torch/kernels/__init__.py``) is static, so
it is checked statically, on every ``kernels/<pkg>/ops.py``.  A *launch*
is a call of a name bound from ``build.load_function(...)``; an *entry*
is a function of the module that holds one.

  * **C1** — the entry's CPU branch (``if <t>.device.type == "cpu":``)
    calls the module's ``*_ref`` and returns, and builds nothing.
  * **C2** — any other device that is not CUDA raises (``if
    <t>.device.type != "cuda": raise ...``) before anything is built.
  * **C3** — no ``try`` surrounds a ``build.*`` call or a launch, and no
    ``except`` handler of the module calls a ``*_ref``: either would be a
    fallback that hides the kernel.
  * **C4** — each launch's return code is bound (``err = launch(...)``),
    handed to ``build.check(NAME, err)``, and ``launches += 1`` follows
    the check in the same block; the module counts nowhere else.
  * **C5** — no function of the module takes an ``interpret`` parameter
    (the JAX flag has no meaning here; the tensor's device decides).
  * **C6** — across the package, a public function with a ``device``
    parameter never defaults it to the CPU (``"cpu"``,
    ``torch.device("cpu")``): the entry points default to ``"cuda"`` and
    raise without a card.  ``None`` ("the inputs' device", the init
    helpers' convention) is allowed.
"""
from __future__ import annotations

import ast
import os
from typing import Iterator, Optional

from repro_torch.lint.core import (
    FileContext, Finding, LintPass, call_name, dotted_name, func_defs,
    param_default, param_names,
)

PASS_ID = "device-contract"


def _is_ops_file(path: str) -> bool:
    parts = path.replace(os.sep, "/").split("/")
    return (len(parts) >= 3 and parts[-3] == "kernels"
            and parts[-1] == "ops.py")


def _is_build_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and (dotted_name(node.func) or "").startswith("build."))


def _launch_names(fn: ast.FunctionDef) -> set[str]:
    """Names bound in ``fn`` from ``build.load_function(...)``."""
    out = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and dotted_name(node.value.func) == "build.load_function"):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return out


def _is_launch(node: ast.AST, launchers: set[str]) -> bool:
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in launchers)


def _device_test(test: ast.AST, op: type, device: str) -> bool:
    """``<expr>.device.type <op> "<device>"``."""
    return (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], op)
            and isinstance(test.left, ast.Attribute)
            and test.left.attr == "type"
            and isinstance(test.left.value, ast.Attribute)
            and test.left.value.attr == "device"
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value == device)


def _calls_ref(nodes) -> bool:
    return any(isinstance(n, ast.Call)
               and (call_name(n) or "").endswith("_ref")
               for stmt in nodes for n in ast.walk(stmt))


def _is_cpu_default(node: Optional[ast.AST]) -> bool:
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and call_name(node) == "device":
        return any(isinstance(a, ast.Constant) and a.value == "cpu"
                   for a in node.args)
    return False


def _stmt_lists(fn: ast.AST):
    """Every statement list (block) under ``fn``."""
    for node in ast.walk(fn):
        for field in ("body", "orelse", "finalbody"):
            block = getattr(node, field, None)
            if isinstance(block, list) and block and isinstance(
                    block[0], ast.stmt):
                yield block


def _is_count(stmt: ast.stmt) -> bool:
    """``launches += 1``."""
    return (isinstance(stmt, ast.AugAssign) and isinstance(stmt.op, ast.Add)
            and isinstance(stmt.target, ast.Name)
            and stmt.target.id == "launches"
            and isinstance(stmt.value, ast.Constant) and stmt.value.value == 1)


def _is_check_of(stmt: ast.stmt, err: str) -> bool:
    """``build.check(<name>, <err>)``."""
    return (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)
            and dotted_name(stmt.value.func) == "build.check"
            and len(stmt.value.args) == 2
            and isinstance(stmt.value.args[1], ast.Name)
            and stmt.value.args[1].id == err)


class DeviceContractPass(LintPass):
    pass_id = PASS_ID
    description = (
        "kernel entries: the CPU branch returns the *_ref, other non-CUDA "
        "devices raise, no try around a build or launch, every launch "
        "checked and counted, no interpret parameter; no public device "
        "parameter defaults to the CPU"
    )

    def check_file(self, ctx: FileContext) -> Iterator[Finding]:
        yield from self._check_device_defaults(ctx)
        if not _is_ops_file(ctx.path):
            return
        for fn in func_defs(ctx.tree):
            if "interpret" in param_names(fn):
                yield self._finding(
                    ctx, fn.lineno,
                    f"`{fn.name}` takes an `interpret` parameter (C5): the "
                    "port has no interpreter; the tensor's device picks the "
                    "plain version (CPU) or the kernel (CUDA)")
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ExceptHandler) and _calls_ref(node.body):
                yield self._finding(
                    ctx, node.lineno,
                    "an `except` handler calls a *_ref plain version (C3): "
                    "a failed kernel must raise, never fall back")
        for fn in ast.iter_child_nodes(ctx.tree):
            if isinstance(fn, ast.FunctionDef) and _launch_names(fn):
                yield from self._check_entry(ctx, fn, _launch_names(fn))
        for block in _stmt_lists(ctx.tree):
            for i, stmt in enumerate(block):
                if (isinstance(stmt, ast.AugAssign)
                        and isinstance(stmt.target, ast.Name)
                        and stmt.target.id == "launches"
                        and not any(isinstance(s, ast.Expr)
                                    and isinstance(s.value, ast.Call)
                                    and dotted_name(s.value.func)
                                    == "build.check" for s in block[:i])):
                    yield self._finding(
                        ctx, stmt.lineno,
                        "`launches` is counted where no checked launch "
                        "precedes it (C4): it counts kernel launches, one "
                        "after each build.check, and nothing else")

    def _finding(self, ctx, line: int, msg: str) -> Finding:
        return Finding(self.pass_id, ctx.path, line, msg)

    def _check_device_defaults(self, ctx: FileContext):
        for fn in func_defs(ctx.tree):
            if fn.name.startswith("_") and fn.name != "__init__":
                continue
            if "device" not in param_names(fn):
                continue
            has, default = param_default(fn, "device")
            if has and _is_cpu_default(default):
                yield self._finding(
                    ctx, fn.lineno,
                    f"`{fn.name}` defaults device={ast.unparse(default)} "
                    "(C6): entry points default to \"cuda\" and raise "
                    "without a card; callers that want the plain path ask "
                    "for device=\"cpu\"")

    def _check_entry(self, ctx, fn: ast.FunctionDef, launchers: set[str]):
        first_build = min(
            (n.lineno for n in ast.walk(fn) if _is_build_call(n)
             and dotted_name(n.func) != "build.score_dtype"),
            default=fn.lineno)
        cpu = [n for n in ast.walk(fn) if isinstance(n, ast.If)
               and _device_test(n.test, ast.Eq, "cpu")]
        if not cpu:
            yield self._finding(
                ctx, fn.lineno,
                f"entry `{fn.name}` has no `if <t>.device.type == \"cpu\":` "
                "branch (C1): a CPU tensor runs the module's *_ref")
        for branch in cpu:
            body = branch.body
            if not (_calls_ref(body) and isinstance(body[-1], ast.Return)):
                yield self._finding(
                    ctx, branch.lineno,
                    f"the CPU branch of `{fn.name}` does not return a call "
                    "of the module's *_ref plain version (C1)")
            if any(_is_build_call(n) or _is_launch(n, launchers)
                   for s in body for n in ast.walk(s)):
                yield self._finding(
                    ctx, branch.lineno,
                    f"the CPU branch of `{fn.name}` builds or launches a "
                    "kernel (C1)")
        other = [n for n in ast.walk(fn) if isinstance(n, ast.If)
                 and _device_test(n.test, ast.NotEq, "cuda")
                 and n.body and isinstance(n.body[0], ast.Raise)]
        if not other or other[0].lineno > first_build:
            yield self._finding(
                ctx, fn.lineno,
                f"entry `{fn.name}` does not raise for a device that is "
                "neither CPU nor CUDA before it builds (C2: `if "
                "<t>.device.type != \"cuda\": raise ...`)")
        for node in ast.walk(fn):
            if isinstance(node, ast.Try) and any(
                    _is_build_call(n) or _is_launch(n, launchers)
                    for s in node.body for n in ast.walk(s)):
                yield self._finding(
                    ctx, node.lineno,
                    f"a `try` in `{fn.name}` surrounds a build or a launch "
                    "(C3): an error of the kernel must reach the caller")
        for block in _stmt_lists(fn):
            for i, stmt in enumerate(block):
                calls = [n for n in ast.walk(stmt)
                         if _is_launch(n, launchers)]
                if not calls or isinstance(stmt, (ast.If, ast.For, ast.While,
                                                  ast.With, ast.Try)):
                    continue
                yield from self._check_launch(ctx, fn, block, i, stmt)

    def _check_launch(self, ctx, fn, block, i: int, stmt: ast.stmt):
        if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and isinstance(stmt.value, ast.Call)):
            yield self._finding(
                ctx, stmt.lineno,
                f"a launch in `{fn.name}` is not bound as `err = "
                "launch(...)` (C4): its return code must reach build.check")
            return
        err = stmt.targets[0].id
        rest = block[i + 1:]
        checks = [j for j, s in enumerate(rest) if _is_check_of(s, err)]
        if not checks:
            yield self._finding(
                ctx, stmt.lineno,
                f"the return code `{err}` of a launch in `{fn.name}` never "
                "reaches build.check (C4): a refused launch would pass "
                "silently")
            return
        if not any(_is_count(s) for s in rest[checks[0] + 1:]):
            yield self._finding(
                ctx, stmt.lineno,
                f"no `launches += 1` follows the checked launch in "
                f"`{fn.name}` (C4)")
