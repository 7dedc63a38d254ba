"""Pass ``host-sync``: no host round trip on the serve path.

The port's counterpart of :mod:`repro.lint.host_sync`.  PyTorch runs
eagerly, so there is no trace to fail: a ``.item()`` on the serve path
simply waits for the card, every call, and the benchmark then measures the
wait.  The scopes are torch's:

  * the public functions of the kernel entries (``kernels/*/ops.py``, and
    ``kernels/*.py`` but ``build.py``: the packing the entries run before
    each launch);
  * the functions ``register_engine`` wires: the decorated score function
    and its ``bounds=`` and ``stats=`` seams;
  * the step closures ``make_serve_step`` and the ``register_serve_factory``
    factories return: those functions' bodies;
  * a function under ``torch.compile`` (decorated, or passed to it) and the
    body of a ``with torch.cuda.graph(...)`` block.

A scope is lexical — a function's body and everything nested in it — and
reaches further only through direct calls: a call of a module-level
function of the serve-path modules (``kernels/``, ``core/{scoring,topk,
distributed,engine,registry}.py``), by its name in the module or through
an imported module, puts that function's body in scope too.  Calls of
methods, of functions passed as values, of other modules (the numpy
planner, ``obs``) and of the plain versions (``*_ref``: the CPU branch of
an entry, by the device contract) are not followed.  That is a documented
limit: the pass finds the round trip where the serve path hands a tensor
to the host, not what the host does next.

Inside a scope these are reported:

  * ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, and
    ``.nonzero()`` / ``torch.nonzero`` (an output sized by the data: the
    host waits for the count);
  * ``torch.cuda.synchronize()`` and ``.synchronize()`` on events and
    streams;
  * ``float()`` / ``int()`` / ``bool()`` of a non-literal (of a tensor it
    reads the card; of a shape — ``.shape``, ``.size()``, ``.numel()``,
    ``.dim()``, ``.stride()``, ``len()`` — it does not, and is allowed);
  * ``np.asarray`` / ``np.array``;
  * ``open()``, ``np.load``, ``np.memmap`` and the store classes
    (``SegmentReader``, ``SegmentStore``, ``SegmentWriter``,
    ``SegmentPager``): paging belongs to the session, not the step.

A round trip the path needs stays, with a suppression that says why;
``PERF.md`` lists them.
"""
from __future__ import annotations

import ast
import os
from typing import Iterator, Optional, Sequence

from repro_torch.lint.core import (
    FileContext, Finding, LintPass, call_name, dotted_name,
)

PASS_ID = "host-sync"

_SYNC_METHODS = {
    "item": ".item() copies a value to the host and waits for the card",
    "tolist": ".tolist() copies a tensor to the host and waits for the card",
    "cpu": ".cpu() copies a tensor to the host and waits for the card",
    "numpy": ".numpy() hands a tensor to the host",
    "synchronize": ".synchronize() waits for the card",
    "nonzero": ".nonzero() is sized by the data: the host waits for the "
               "count",
}
_CASTS = ("float", "int", "bool")
_NP_CALLS = {"np.asarray", "numpy.asarray", "np.array", "numpy.array"}
_FILE_CALLS = {"np.memmap", "numpy.memmap", "np.load", "numpy.load"}
_STORE_CALLS = {"SegmentReader", "SegmentStore", "SegmentWriter",
                "SegmentPager"}
# Tensor metadata: a cast of an expression built only from these reads no
# device memory.
_SHAPE_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda"}
_SHAPE_CALLS = {"size", "numel", "dim", "stride", "element_size", "len",
                "nelement", "storage_offset", "data_ptr"}
# Module files (relative to the package root) whose functions a scope's
# direct calls are followed into.
_SERVE_MODULES = ("core/scoring.py", "core/topk.py", "core/distributed.py",
                  "core/engine.py", "core/registry.py")


def _norm(path: str) -> str:
    return os.path.abspath(path).replace(os.sep, "/")


def _module_name(path: str) -> str:
    """``.../src/repro_torch/core/scoring.py`` -> ``repro_torch.core.scoring``
    (the path below the last ``repro_torch`` directory); a file elsewhere
    under a ``kernels`` directory is ``_.kernels.<...>``, any other file its
    own module."""
    parts = _norm(path)[:-3].split("/")
    for top, prefix in (("repro_torch", []), ("kernels", ["_"])):
        if top in parts[:-1]:
            i = len(parts) - 1 - parts[::-1].index(top)
            parts = prefix + parts[i:]
            if parts[-1] == "__init__":
                parts = parts[:-1]
            return ".".join(parts)
    return parts[-1]


def _rel(module: str) -> str:
    return module.split(".", 1)[1].replace(".", "/") + ".py" \
        if "." in module else module


def _is_kernel_entry_module(module: str) -> bool:
    rel = _rel(module)
    if not rel.startswith("kernels/"):
        return False
    base = rel.rsplit("/", 1)[-1]
    depth = rel.count("/")
    return (depth == 2 and base == "ops.py") or (
        depth == 1 and base not in ("build.py", "__init__.py"))


def _is_serve_module(module: str) -> bool:
    rel = _rel(module)
    return rel.startswith("kernels/") or rel in _SERVE_MODULES


def _is_literal(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) or (
        isinstance(node, ast.UnaryOp) and isinstance(node.operand,
                                                     ast.Constant))


def _is_metadata(node: ast.AST) -> bool:
    """The expression reads tensor metadata and constants only."""
    if _is_literal(node):
        return True
    if isinstance(node, ast.Attribute):
        return node.attr in _SHAPE_ATTRS
    if isinstance(node, ast.Subscript):
        return _is_metadata(node.value)
    if isinstance(node, ast.Call):
        return call_name(node) in _SHAPE_CALLS
    if isinstance(node, ast.BinOp):
        return _is_metadata(node.left) and _is_metadata(node.right)
    if isinstance(node, ast.UnaryOp):
        return _is_metadata(node.operand)
    if isinstance(node, ast.Compare):
        return _is_metadata(node.left) and all(
            _is_metadata(c) for c in node.comparators)
    return False


class _Module:
    """One parsed file: its functions and what its names import."""

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.name = _module_name(ctx.path)
        self.functions = {
            n.name: n for n in ast.iter_child_nodes(ctx.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        self.modules: dict[str, str] = {}  # alias -> module
        self.members: dict[str, tuple[str, str]] = {}  # name -> (mod, attr)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.modules[a.asname] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    local = a.asname or a.name
                    # `from pkg import mod` binds a module or a member;
                    # both are recorded, resolution tries each.
                    self.modules[local] = f"{node.module}.{a.name}"
                    self.members[local] = (node.module, a.name)


def _scope_roots(mod: _Module):
    """(function node, why) pairs this module roots, plus wired targets in
    other modules as (alias-qualified expression, why)."""
    roots, wired = [], []
    if _is_kernel_entry_module(mod.name):
        for name, fn in mod.functions.items():
            if not name.startswith("_"):
                roots.append((fn, "a kernel entry"))
    compiled = set()
    for node in ast.walk(mod.ctx.tree):
        if (isinstance(node, ast.Call)
                and dotted_name(node.func) in ("torch.compile", "compile")
                and node.args and isinstance(node.args[0], ast.Name)):
            compiled.add(node.args[0].id)
    for fn in ast.walk(mod.ctx.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for dec in fn.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            name = call_name(dec) if isinstance(dec, ast.Call) else (
                dotted_name(dec) or "").rsplit(".", 1)[-1]
            if name == "register_engine":
                roots.append((fn, "an engine's score function"))
                for kw in dec.keywords:
                    if kw.arg in ("bounds", "stats"):
                        wired.append((kw.value, f"an engine's {kw.arg}= seam"))
            elif name == "register_serve_factory":
                roots.append((fn, "a serve factory"))
            elif dotted_name(target) in ("torch.compile", "compile"):
                roots.append((fn, "a torch.compile function"))
        if fn.name in compiled:
            roots.append((fn, "a torch.compile function"))
        if fn.name == "make_serve_step":
            roots.append((fn, "make_serve_step"))
    return roots, wired


class HostSyncPass(LintPass):
    pass_id = PASS_ID
    description = (
        "no .item()/.tolist()/.cpu()/.numpy(), synchronize(), float()/int()"
        "/bool() of a tensor, np.asarray, or file/store handles on the serve "
        "path (kernel entries, wired engine functions, serve steps, "
        "torch.compile and CUDA-graph bodies)"
    )

    def finalize(self, files: Sequence[FileContext]) -> Iterator[Finding]:
        mods = [_Module(ctx) for ctx in files]
        by_name = {m.name: m for m in mods}
        seen_fns: set[int] = set()
        scoped: list[tuple[_Module, ast.AST, str]] = []  # in scope, and why

        def add(mod: _Module, fn: ast.AST, why: str) -> None:
            if id(fn) not in seen_fns:
                seen_fns.add(id(fn))
                scoped.append((mod, fn, why))

        graph_blocks = []
        for mod in mods:
            roots, wired = _scope_roots(mod)
            for fn, why in roots:
                add(mod, fn, why)
            for expr, why in wired:
                hit = self._resolve(mod, expr, by_name)
                if hit is not None:
                    add(*hit, why)
            for node in ast.walk(mod.ctx.tree):
                if isinstance(node, ast.With) and any(
                        isinstance(i.context_expr, ast.Call)
                        and (dotted_name(i.context_expr.func) or "")
                        .endswith("cuda.graph") for i in node.items):
                    graph_blocks.append((mod, node))
        for mod, fn, why in scoped:  # grows while it is walked
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    hit = self._resolve(mod, node.func, by_name)
                    if (hit is not None and not hit[1].name.endswith("_ref")
                            and (hit[0] is mod
                                 or _is_serve_module(hit[0].name))):
                        add(*hit, why)
        seen: set[tuple[str, int, str]] = set()
        items = [(mod, fn, why, fn.name) for mod, fn, why in scoped]
        items += [(mod, blk, "a CUDA graph capture", "with torch.cuda.graph")
                  for mod, blk in graph_blocks]
        for mod, node, why, label in items:
            for f in self._check_scope(mod.ctx, node, why, label):
                key = (f.path, f.line, f.message.split(" (in ")[0])
                if key not in seen:
                    seen.add(key)
                    yield f

    @staticmethod
    def _resolve(mod: _Module, expr: ast.AST,
                 by_name) -> Optional[tuple[_Module, ast.AST]]:
        """The module-level function ``expr`` names, where it is one of
        the walked files'."""
        if isinstance(expr, ast.Name):
            if expr.id in mod.functions:
                return mod, mod.functions[expr.id]
            if expr.id in mod.members:
                src, attr = mod.members[expr.id]
                target = by_name.get(src)
                if target is not None and attr in target.functions:
                    return target, target.functions[attr]
            return None
        if isinstance(expr, ast.Attribute) and isinstance(expr.value,
                                                          ast.Name):
            target = by_name.get(mod.modules.get(expr.value.id, ""))
            if target is not None and expr.attr in target.functions:
                return target, target.functions[expr.attr]
        return None

    def _check_scope(self, ctx: FileContext, root: ast.AST, why: str,
                     label: str):
        where = f"(in `{label}`, {why} on the serve path)"
        for node in ast.walk(root):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            full = dotted_name(func) or ""
            if isinstance(func, ast.Attribute):
                if full in ("torch.nonzero", "torch.argwhere"):
                    yield self._finding(ctx, node, f"{full}() is sized by "
                                        "the data: the host waits for the "
                                        f"count {where}")
                elif func.attr in _SYNC_METHODS and (
                        not node.args or func.attr == "nonzero"):
                    yield self._finding(
                        ctx, node, f"{_SYNC_METHODS[func.attr]} {where}")
                elif func.attr == "synchronize":
                    yield self._finding(ctx, node, f"{full}() waits for the "
                                        f"card {where}")
                elif full in _NP_CALLS:
                    yield self._finding(ctx, node, f"{full}() materialises a "
                                        f"value on the host {where}")
                elif full in _FILE_CALLS:
                    yield self._finding(ctx, node, f"{full}() opens a file "
                                        f"or mmap handle {where}")
                elif func.attr in _STORE_CALLS:
                    yield self._finding(ctx, node, f"store {func.attr}() "
                                        f"{where}: segment paging is "
                                        "session work")
            elif isinstance(func, ast.Name):
                if func.id == "open":
                    yield self._finding(ctx, node, f"open() {where}: file "
                                        "I/O on the serve path")
                elif func.id in _STORE_CALLS:
                    yield self._finding(ctx, node, f"store {func.id}() "
                                        f"{where}: segment paging is "
                                        "session work")
                elif (func.id in _CASTS and node.args
                      and not all(_is_metadata(a) for a in node.args)):
                    yield self._finding(ctx, node, f"{func.id}() of a value "
                                        "that may be a tensor reads it on "
                                        f"the host {where}")

    def _finding(self, ctx, node, msg: str) -> Finding:
        return Finding(self.pass_id, ctx.path, node.lineno, msg)
