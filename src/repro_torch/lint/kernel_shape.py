"""Pass ``kernel-shape``: each entry's CUDA branch agrees with its ``*_ref``.

The port's counterpart of :mod:`repro.lint.kernel_shape`.  Two layers:

**Static** (any ``kernels/<pkg>/ref.py``): the package defines a public
``*_ref``, the plain version its entry's CPU branch returns and every
kernel test holds the kernel against.

**Fake-tensor execution** (``finalize``, each walked
``kernels/<pkg>/ops.py`` of the six packages): the entry's CUDA branch
runs with no device, on fake CUDA tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``) of every route's tiny
geometry (:mod:`repro_torch.lint.geometry`: f32, and bf16 where the entry
has a bf16 route).  Inside the run

* ``build.load_function`` returns a recorder: the launch is not made, its
  arguments are kept and it returns 0; ``build.check`` records the code it
  was handed; ``torch.cuda.current_stream`` and
  ``torch.cuda.get_device_properties`` answer for an H100 (stream 0, 132
  SMs);
* the entry module's helpers that read data on the host (the query-tile
  packing's one transfer, ``bmp_scan``'s launch sizes and small-route
  packing: ``Route.shadow``) run on the real CPU inputs the fake ones were
  made from, and hand back fake copies of their results; a fake value fed
  to one of them that was computed on the fake path raises, so the harness
  cannot run on values it does not know.

Then the pass holds the entry's outputs (shape, dtype, a CUDA device)
against the same entry run on the real CPU inputs — its CPU branch, the
``*_ref`` — the number of arguments of each launch against its
``_ARGTYPES``, each argument's Python type against its C type (an int
for ``c_int``/``c_longlong``, an int or None for ``c_void_p``, a number
for ``c_float``), every integer the shapes fix against the tensors'
shapes (``Route.ints``), each launch's code against one ``build.check``,
and at least one launch a run.  A fake tensor's ``data_ptr()`` is 0 (with
a warning, silenced here).
"""
from __future__ import annotations

import ast
import contextlib
import ctypes
import importlib
import importlib.util
import os
import warnings
from typing import Iterator

from repro_torch.lint.core import FileContext, Finding, LintPass

PASS_ID = "kernel-shape"
SM_COUNT = 132  # an H100 SXM


def _kernels_parts(path: str):
    parts = os.path.abspath(path).replace(os.sep, "/").split("/")
    if "kernels" in parts[:-1]:
        return parts[len(parts) - 1 - parts[::-1].index("kernels"):]
    return None


def _load_ops(path: str, package: str):
    """The walked ``ops.py``: the installed module where it is the
    package's own file, else loaded from the path under a private name."""
    name = f"repro_torch.kernels.{package}.ops"
    mod = importlib.import_module(name)
    if os.path.samefile(mod.__file__, path):
        return mod
    spec = importlib.util.spec_from_file_location(
        f"_lint_kernel_shape_{package}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Props:
    multi_processor_count = SM_COUNT


class _Stream:
    cuda_stream = 0


@contextlib.contextmanager
def _patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _contiguous(self, memory_format=None):
    import torch

    fmt = torch.contiguous_format if memory_format is None else memory_format
    if self.is_contiguous(memory_format=fmt):
        return self
    return self.clone(memory_format=fmt)


class _Harness:
    """One fake run of an entry: the fake mode, the fake inputs' real
    twins, and what the launches were handed."""

    def __init__(self):
        from torch._subclasses.fake_tensor import FakeTensorMode

        self.mode = FakeTensorMode()
        self.twins: dict[int, tuple] = {}  # id(fake) -> (fake, real)
        self.launches: list[tuple[str, list, tuple]] = []
        self.checks: list[int] = []

    def fake(self, x):
        """A fake CUDA copy of a CPU tensor (same shape, strides, dtype),
        remembered with its real twin; other values pass through."""
        import torch

        if isinstance(x, torch.Tensor):
            with self.mode:
                f = torch.empty_strided(tuple(x.shape), tuple(x.stride()),
                                        dtype=x.dtype, device="cuda")
            self.twins[id(f)] = (f, x)
            return f
        if isinstance(x, (tuple, list)):
            return type(x)(self.fake(v) for v in x)
        return x

    def real(self, x):
        from torch._subclasses.fake_tensor import FakeTensor

        if isinstance(x, FakeTensor):
            hit = self.twins.get(id(x))
            if hit is None or hit[0] is not x:
                raise LookupError(
                    "a host-reading helper was handed a fake tensor with no "
                    "real twin (computed on the fake path)")
            return hit[1]
        if isinstance(x, (tuple, list)):
            return type(x)(self.real(v) for v in x)
        return x

    def shadow(self, fn):
        from torch._subclasses.fake_tensor import (
            FakeTensor, unset_fake_temporarily,
        )

        def run(*args, **kwargs):
            if not any(isinstance(a, FakeTensor)
                       for a in (*args, *kwargs.values())):
                return fn(*args, **kwargs)  # a call from a real run
            real_args = self.real(args)
            real_kwargs = {k: self.real(v) for k, v in kwargs.items()}
            with unset_fake_temporarily():
                out = fn(*real_args, **real_kwargs)
            return self.fake(out)
        return run

    def load_function(self, name, fn, argtypes):
        def launch(*args):
            self.launches.append((f"{name}.{fn}", list(args),
                                  tuple(argtypes)))
            return 0
        return launch

    def check(self, name, err):
        self.checks.append(err)


def _arg_problems(fn: str, args: list, argtypes: tuple) -> list[str]:
    problems = []
    if len(args) != len(argtypes):
        problems.append(f"{fn}: {len(args)} arguments for {len(argtypes)} "
                        "_ARGTYPES")
    for i, (a, ty) in enumerate(zip(args, argtypes)):
        if ty is ctypes.c_void_p:
            ok = a is None or isinstance(a, int)
        elif ty in (ctypes.c_int, ctypes.c_longlong):
            ok = isinstance(a, int) and (
                ty is ctypes.c_longlong or -2 ** 31 <= a < 2 ** 31)
        elif ty is ctypes.c_float:
            ok = isinstance(a, (int, float))
        else:
            ok = True
        if not ok:
            problems.append(f"{fn}: argument {i} is {type(a).__name__} "
                            f"{a!r} for {ty.__name__}")
    return problems


def run_route(route, ops) -> list[str]:
    """Run ``route``'s entry of the module ``ops`` on fake CUDA tensors and
    hold it against the same entry on the real CPU inputs; the problems
    found (empty: it agrees)."""
    import torch

    from repro_torch.kernels import build

    args, kwargs = route.make("cpu")
    entry = getattr(ops, route.entry)
    want = entry(*args, **kwargs)
    want = want if isinstance(want, tuple) else (want,)
    h = _Harness()
    fake_args, fake_kwargs = h.fake(args), h.fake(kwargs)
    with contextlib.ExitStack() as stack:
        stack.enter_context(warnings.catch_warnings())
        warnings.simplefilter("ignore", UserWarning)  # fake data_ptr() is 0
        stack.enter_context(_patched(build, "load_function",
                                     h.load_function))
        stack.enter_context(_patched(build, "check", h.check))
        stack.enter_context(_patched(torch.cuda, "current_stream",
                                     lambda *a, **k: _Stream()))
        stack.enter_context(_patched(torch.cuda, "get_device_properties",
                                     lambda *a, **k: _Props()))
        # A CPU build's contiguous() of a fake CUDA view asks for the CUDA
        # runtime; the same copy as a clone does not.
        stack.enter_context(_patched(torch.Tensor, "contiguous",
                                     _contiguous))
        for name in route.shadow:
            if hasattr(ops, name):
                stack.enter_context(_patched(ops, name,
                                             h.shadow(getattr(ops, name))))
        before = getattr(ops, "launches", 0)
        stack.enter_context(h.mode)
        got = entry(*fake_args, **fake_kwargs)
    ops.launches = before  # a recorded launch is no launch
    got = got if isinstance(got, tuple) else (got,)
    what = route.name
    problems = []
    if len(got) != len(want):
        problems.append(f"{what}: {len(got)} outputs, the plain version "
                        f"{len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if tuple(g.shape) != tuple(w.shape):
            problems.append(f"{what}: output {i} shape {tuple(g.shape)} != "
                            f"the plain version's {tuple(w.shape)}")
        if g.dtype != w.dtype:
            problems.append(f"{what}: output {i} dtype {g.dtype} != the "
                            f"plain version's {w.dtype}")
        if g.device.type != "cuda":
            problems.append(f"{what}: output {i} on {g.device}, not the "
                            "card")
    if not h.launches:
        problems.append(f"{what}: the CUDA branch launched nothing")
    if len(h.checks) != len(h.launches) or any(h.checks):
        problems.append(f"{what}: {len(h.launches)} launch(es), "
                        f"{len(h.checks)} build.check call(s) of their codes")
    expect = route.ints(args, kwargs)
    for fn, largs, argtypes in h.launches:
        problems += [f"{what}: {p}" for p in _arg_problems(fn, largs,
                                                           argtypes)]
        for pos, value in sorted(expect.items()):
            if pos >= len(largs) or largs[pos] != value:
                got_v = largs[pos] if pos < len(largs) else "nothing"
                problems.append(f"{what}: {fn} argument {pos} is {got_v!r}, "
                                f"the shapes give {value!r}")
    return problems


class KernelShapePass(LintPass):
    pass_id = PASS_ID
    description = (
        "each kernel entry's CUDA branch run on fake CUDA tensors (no "
        "device) against its *_ref: output shapes and dtypes, the launch's "
        "argument count, C types and shape-fixed integers; every kernel "
        "package has a public *_ref"
    )

    def applies_to(self, path: str) -> bool:
        return _kernels_parts(path) is not None

    def check_file(self, ctx: FileContext) -> Iterator[Finding]:
        parts = _kernels_parts(ctx.path)
        if parts is None or len(parts) != 3 or parts[-1] != "ref.py":
            return
        if not any(isinstance(n, ast.FunctionDef)
                   and n.name.endswith("_ref") and not n.name.startswith("_")
                   for n in ast.iter_child_nodes(ctx.tree)):
            yield Finding(
                self.pass_id, ctx.path, 1,
                "kernel package ref.py defines no public *_ref plain "
                "version: the entry's CPU branch and every kernel test "
                "need it")

    def finalize(self, files) -> Iterator[Finding]:
        from repro_torch.lint.geometry import ROUTES

        for ctx in files:
            parts = _kernels_parts(ctx.path)
            if parts is None or len(parts) != 3 or parts[-1] != "ops.py":
                continue
            routes = [r for r in ROUTES if r.package == parts[1]]
            if not routes:
                continue
            try:
                ops = _load_ops(ctx.path, parts[1])
            except Exception as e:  # an unloadable entry is a finding
                yield Finding(self.pass_id, ctx.path, 1,
                              f"the entry module does not load: {e!r}")
                continue
            for route in routes:
                try:
                    problems = run_route(route, ops)
                except Exception as e:  # a crashed run is a finding
                    problems = [f"{route.name}: the fake run failed: {e!r}"]
                for msg in problems:
                    yield Finding(self.pass_id, ctx.path, 1, msg)
