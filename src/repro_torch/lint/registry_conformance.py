"""Pass ``registry-conformance``: capability flags match wired functions.

The counterpart of :mod:`repro.lint.registry_conformance`, over
:mod:`repro_torch.core.registry`.  The registry centralizes engine
dispatch behind :class:`~repro_torch.core.registry.EngineSpec` capability
flags.  Flags that
drift from the functions they describe fail at *serve* time (a
``supports_tau`` engine whose scorer silently ignores ``tau_init`` would
drop warm-start thresholds without an error anywhere).  The
registrations are declarative decorators, so conformance is statically
checkable:

  * ``supports_tau=True`` ⇒ the decorated score function accepts a
    ``tau_init`` parameter.
  * ``pruned=True`` ⇒ a ``bounds=`` seam is wired (the block-max seam
    every pruned consumer gathers through).
  * ``stats=`` names a module-level function ⇒ it takes the
    ``(queries, index, cfg, k)`` stats signature and actually returns a
    value (the ``RetrievalEngine.prune_stats`` seam).
  * ``@register_serve_factory`` factories accept the keyword set the
    port's ``make_serve_step`` calls them with (``k``,
    ``docs_per_shard``, ``geometry``, ``cfg``, ``hierarchical_merge``,
    ``compute_dtype``), or ``**kwargs``.

Plus the "no string branches" rule: **engine-name string comparisons are
forbidden outside ``repro_torch/core/registry.py``** — dispatch goes
through the spec's flags, never ``cfg.engine == "..."``.
"""
from __future__ import annotations

import ast
import os
from typing import Iterator, Optional

from repro_torch.lint.core import (
    FileContext, Finding, LintPass, call_name, func_defs, param_names,
)

PASS_ID = "registry-conformance"

#: the keywords repro_torch.core.distributed.make_serve_step passes
_FACTORY_KWARGS = {"k", "docs_per_shard", "geometry", "cfg",
                   "hierarchical_merge", "compute_dtype"}


def _decorator_call(fn: ast.FunctionDef, name: str) -> Optional[ast.Call]:
    for dec in fn.decorator_list:
        if isinstance(dec, ast.Call) and call_name(dec) == name:
            return dec
    return None


def _kw(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_true(node: Optional[ast.AST]) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def _mentions_engine(node: ast.AST) -> bool:
    """The expression reads an ``engine`` binding (``engine``,
    ``cfg.engine``, ``args.engine``, ...)."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id == "engine":
            return True
        if isinstance(sub, ast.Attribute) and sub.attr == "engine":
            return True
    return False


def _is_str_const(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return True
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)) and node.elts:
        return all(_is_str_const(e) for e in node.elts)
    return False


class RegistryConformancePass(LintPass):
    pass_id = PASS_ID
    description = (
        "EngineSpec capability flags match wired signatures; no "
        "engine-name string comparisons outside "
        "repro_torch.core.registry"
    )

    def check_file(self, ctx: FileContext) -> Iterator[Finding]:
        module_fns = {
            fn.name: fn for fn in ast.iter_child_nodes(ctx.tree)
            if isinstance(fn, ast.FunctionDef)
        }
        for fn in func_defs(ctx.tree):
            reg = _decorator_call(fn, "register_engine")
            if reg is not None:
                yield from self._check_registration(ctx, fn, reg,
                                                    module_fns)
            factory = _decorator_call(fn, "register_serve_factory")
            if factory is not None:
                yield from self._check_factory(ctx, fn)

        if not self._is_registry_module(ctx.path):
            yield from self._check_string_branches(ctx)

    @staticmethod
    def _is_registry_module(path: str) -> bool:
        parts = path.replace(os.sep, "/").split("/")
        return parts[-2:] == ["core", "registry.py"]

    def _check_registration(self, ctx, fn, reg, module_fns):
        if _is_true(_kw(reg, "supports_tau")):
            if "tau_init" not in param_names(fn):
                yield Finding(
                    self.pass_id, ctx.path, fn.lineno,
                    f"engine `{fn.name}` declares supports_tau=True but "
                    "its score function takes no tau_init parameter — "
                    "warm-start thresholds would be dropped silently",
                )
        if _is_true(_kw(reg, "pruned")) and _kw(reg, "bounds") is None:
            yield Finding(
                self.pass_id, ctx.path, fn.lineno,
                f"engine `{fn.name}` declares pruned=True without wiring "
                "a bounds= seam (block upper bounds are the contract "
                "every pruned consumer gathers through)",
            )
        if _is_true(_kw(reg, "supports_deletes")):
            if "deleted_mask" not in param_names(fn):
                yield Finding(
                    self.pass_id, ctx.path, fn.lineno,
                    f"engine `{fn.name}` declares supports_deletes=True "
                    "but its score function takes no deleted_mask "
                    "parameter — tombstones would be dropped silently "
                    "and deleted documents served",
                )
        if _is_true(_kw(reg, "pruned")) and not _is_true(
            _kw(reg, "supports_deletes")
        ):
            yield Finding(
                self.pass_id, ctx.path, fn.lineno,
                f"engine `{fn.name}` declares pruned=True without "
                "supports_deletes=True — pruned engines must mask "
                "tombstones in-sweep (post-hoc masking is unsafe: a "
                "deleted doc's exact score can certify tau and "
                "over-prune surviving documents)",
            )
        stats = _kw(reg, "stats")
        if isinstance(stats, ast.Name):
            target = module_fns.get(stats.id)
            if target is None:
                yield Finding(
                    self.pass_id, ctx.path, reg.lineno,
                    f"engine `{fn.name}` wires stats={stats.id} but no "
                    "module-level function of that name exists",
                )
            else:
                if len(param_names(target)) < 4:
                    yield Finding(
                        self.pass_id, ctx.path, target.lineno,
                        f"stats seam `{target.name}` must take the "
                        "(queries, index, cfg, k) signature",
                    )
                if not any(
                    isinstance(n, ast.Return) and n.value is not None
                    for n in ast.walk(target)
                ):
                    yield Finding(
                        self.pass_id, ctx.path, target.lineno,
                        f"stats seam `{target.name}` never returns a "
                        "stats value (RetrievalEngine.prune_stats "
                        "forwards its return)",
                    )

    def _check_factory(self, ctx, fn):
        params = set(param_names(fn))
        if fn.args.kwarg is None:
            missing = _FACTORY_KWARGS - params
            if missing:
                yield Finding(
                    self.pass_id, ctx.path, fn.lineno,
                    f"serve factory `{fn.name}` does not accept the "
                    f"make_serve_step keyword(s) {sorted(missing)} "
                    "(the factory signature is fixed by "
                    "repro_torch.core.distributed.make_serve_step)",
                )

    def _check_string_branches(self, ctx):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Compare):
                continue
            sides = [node.left, *node.comparators]
            if any(_mentions_engine(s) for s in sides) and any(
                _is_str_const(s) for s in sides
            ):
                yield Finding(
                    self.pass_id, ctx.path, node.lineno,
                    "engine-name string comparison outside "
                    "repro_torch.core.registry — dispatch through the "
                    "EngineSpec capability flags "
                    "(registry.get_engine(...).<flag>) instead",
                )
