"""Pass ``kernel-memory``: every pointer a kernel gets is a checked tensor.

The port's counterpart of :mod:`repro.lint.kernel_memory`, in two halves.

**The static half** (every run, on each ``kernels/<pkg>/ops.py``): in each
entry, every tensor whose ``data_ptr()`` reaches a launch (a call of a name
bound from ``build.load_function``; directly, or through a helper such as
``ptr(t)`` that takes the pointer) was either

  * checked by ``build.expect`` (dtype, shape, device) — in the entry, in a
    ``for`` over a literal tuple of ``(tensor, name)`` pairs, or in a
    module-level helper the entry hands the tensor to — or
  * allocated in the entry (a name the entry binds that is not one of its
    parameters).

A parameter that reaches C unchecked is how an index of the wrong dtype or
length becomes an out-of-bounds read no CPU test sees.

**The device half** (``--device cuda``) runs every route of the six
kernels on the card: under ``compute-sanitizer --tool memcheck`` and with
each operand moved into a guard band (:mod:`repro_torch.lint.sanitize`).
Any error fails the pass; a route the tool cannot check is listed by name.
"""
from __future__ import annotations

import ast
import os
from typing import Iterator, Optional

from repro_torch.lint.core import (
    FileContext, Finding, LintPass, call_name, dotted_name, param_names,
)

PASS_ID = "kernel-memory"


def _is_ops_file(path: str) -> bool:
    parts = path.replace(os.sep, "/").split("/")
    return (len(parts) >= 3 and parts[-3] == "kernels"
            and parts[-1] == "ops.py")


def _launchers(fn: ast.FunctionDef) -> set[str]:
    return {t.id for node in ast.walk(fn)
            if isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Call)
            and dotted_name(node.value.func) == "build.load_function"
            for t in node.targets if isinstance(t, ast.Name)}


def _ptr_helpers(fn: ast.FunctionDef, module_fns: dict) -> set[str]:
    """Functions (nested in ``fn`` or module-level) that return a
    parameter's ``data_ptr()``."""
    out = set()
    for f in [*ast.walk(fn), *module_fns.values()]:
        if isinstance(f, ast.FunctionDef) and f is not fn and any(
                isinstance(n, ast.Call) and call_name(n) == "data_ptr"
                and isinstance(n.func.value, ast.Name)
                and n.func.value.id in param_names(f)
                for n in ast.walk(f)):
            out.add(f.name)
    return out


def _pointer_names(call: ast.Call, helpers: set[str]):
    """(name or None, line) of each tensor whose pointer the launch
    ``call`` takes."""
    for arg in [*call.args, *(kw.value for kw in call.keywords)]:
        for node in ast.walk(arg):
            if not isinstance(node, ast.Call):
                continue
            if call_name(node) == "data_ptr" and isinstance(node.func,
                                                            ast.Attribute):
                base = node.func.value
                yield (base.id if isinstance(base, ast.Name) else None,
                       node.lineno)
            elif (isinstance(node.func, ast.Name)
                  and node.func.id in helpers and node.args):
                a = node.args[0]
                yield (a.id if isinstance(a, ast.Name) else None,
                       node.lineno)


def _loop_bindings(loop: ast.For) -> dict[str, list[str]]:
    """``for t, what in ((a, "a"), (b, "b")):`` -> {"t": ["a", "b"]}."""
    out: dict[str, list[str]] = {}
    if not isinstance(loop.iter, (ast.Tuple, ast.List)):
        return out
    targets = loop.target.elts if isinstance(loop.target, ast.Tuple) \
        else [loop.target]
    for item in loop.iter.elts:
        elts = item.elts if isinstance(item, ast.Tuple) else [item]
        for t, e in zip(targets, elts):
            if isinstance(t, ast.Name) and isinstance(e, ast.Name):
                out.setdefault(t.id, []).append(e.id)
    return out


def _expected(fn: ast.FunctionDef, module_fns: dict,
              seen: Optional[set] = None) -> set[str]:
    """Names ``fn`` passes through ``build.expect`` (directly, through a
    literal loop, or through a module-level helper)."""
    seen = set() if seen is None else seen
    seen.add(fn.name)
    loops: dict[str, list[str]] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.For):
            for k, v in _loop_bindings(node).items():
                loops.setdefault(k, []).extend(v)
    out: set[str] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        if dotted_name(node.func) == "build.expect" and node.args:
            a = node.args[0]
            if isinstance(a, ast.Name):
                out.add(a.id)
                out.update(loops.get(a.id, ()))
        elif (isinstance(node.func, ast.Name)
              and node.func.id in module_fns
              and node.func.id not in seen):
            helper = module_fns[node.func.id]
            checked = _expected(helper, module_fns, seen)
            for p, a in zip(param_names(helper), node.args):
                if p in checked and isinstance(a, ast.Name):
                    out.add(a.id)
                    out.update(loops.get(a.id, ()))
    return out


def _bound(fn: ast.FunctionDef) -> set[str]:
    """Names the entry binds by assignment."""
    out = set()
    for node in ast.walk(fn):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets = [node.target]
        for t in targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    out.add(n.id)
    return out


class KernelMemoryPass(LintPass):
    pass_id = PASS_ID
    kind = "both"
    description = (
        "static: every tensor whose pointer reaches a launch was checked by "
        "build.expect or allocated in the entry; device: every route under "
        "compute-sanitizer memcheck and in guard bands"
    )

    def applies_to(self, path: str) -> bool:
        return _is_ops_file(path)

    def check_file(self, ctx: FileContext) -> Iterator[Finding]:
        module_fns = {n.name: n for n in ast.iter_child_nodes(ctx.tree)
                      if isinstance(n, ast.FunctionDef)}
        for fn in module_fns.values():
            launchers = _launchers(fn)
            if not launchers:
                continue
            helpers = _ptr_helpers(fn, module_fns)
            checked = _expected(fn, module_fns)
            params = set(param_names(fn))
            allocated = _bound(fn) - params
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Name)
                        and node.func.id in launchers):
                    continue
                for name, line in _pointer_names(node, helpers):
                    if name is None:
                        yield Finding(
                            self.pass_id, ctx.path, line,
                            f"a pointer in `{fn.name}`'s launch comes from "
                            "an expression, not a named tensor the entry "
                            "checked or allocated")
                    elif name not in checked and name not in allocated:
                        yield Finding(
                            self.pass_id, ctx.path, line,
                            f"`{name}`'s pointer reaches the launch in "
                            f"`{fn.name}` unchecked: pass it through "
                            "build.expect (dtype, shape, device) or "
                            "allocate it in the entry")

    def device_findings(self, results: dict):
        """The findings of a :func:`repro_torch.lint.sanitize.run`."""
        from repro_torch.lint import sanitize

        return sanitize.memory_findings(results)
