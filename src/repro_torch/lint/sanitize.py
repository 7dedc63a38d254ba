"""The device half of ``kernel-memory`` and ``kernel-race``: every route of
the six kernels (:data:`repro_torch.lint.geometry.ROUTES`) run on the card.

The counterpart of JAX's ``absint/{geometry,record,analyze}.py``, which
interpret Pallas bodies over intervals: a CUDA body has no such
interpreter here, so the routes are run, each in three child processes
started together (a route that faults the card cannot take the others
with it: a child that dies is restarted on the routes left):

* **memcheck**: ``compute-sanitizer --tool memcheck`` with
  ``PYTORCH_NO_CUDA_MEMORY_CACHING=1`` (without it torch's caching
  allocator carves tensors out of shared segments, and an overrun into a
  neighbouring tensor is no error to the tool);
* **racecheck**: ``compute-sanitizer --tool racecheck`` (shared memory
  only);
* **guard**: no tool.  Every operand whose pointer reaches the launch is
  moved into a buffer with a 4 KiB guard band on each side, filled with
  0xFF (NaN in f32, -1 in int32) and then with 0x7F (3.4e38, 2^31 - 2^24);
  after the launch the bands must be as they were (no write outside an
  operand) and the outputs the bits of the unguarded launch (no read
  outside an operand that changed a result).  The unguarded launch is
  made three times and must give the same bits each time (the global
  half of ``kernel-race``).  Each route's outputs are held against the
  plain version on the CPU (``max_abs_err``).

A tool that cannot check a route says so (the tool refuses the device; the
route's instructions are ones racecheck does not model): that route is
listed as ``not checked`` with the tool's words — neither failed nor
passed silently.  Every other status is ``clean`` or ``errors: ...``, and
any error is a finding of its pass.  Without a card :func:`run` raises.

The child is ``python -m repro_torch.lint.sanitize --child <kind>
<route>...``; :func:`run` starts it, nothing else should.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Optional

from repro_torch.lint.core import Finding

KINDS = ("memcheck", "racecheck", "guard")
GUARD_BYTES = 4096
FILLS = (0xFF, 0x7F)
REPEATS = 3
CHILD_TIMEOUT_S = 300
# max |kernel - plain| allowed, relative to max |plain|: the f32 kernels
# sum in another order (a few ulps), splade_head's 3xTF32 product, bf16
# rounds each output once more than nothing.
TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}
# What the tool prints when it cannot instrument the card at all.
_TOOL_REFUSALS = ("Device not supported",)
_UNMODELED = re.compile(r"not supported|unsupported|is not modeled",
                        re.IGNORECASE)
_ERROR_LINE = re.compile(r"^=+\s+(Invalid|Error|Race|.*[Hh]azard|"
                         r"Program hit|Barrier error)")
_CU_LINE = re.compile(r"([\w/.-]+\.cu(?:h)?):(\d+)")


def _tool() -> Optional[str]:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "compute-sanitizer")
    return cand if os.path.exists(cand) else shutil.which("compute-sanitizer")


def _src_dir() -> str:
    import repro_torch

    return str(Path(repro_torch.__file__).resolve().parents[1])


def _routes(names):
    from repro_torch.lint.geometry import ROUTES

    by_name = {r.name: r for r in ROUTES}
    return [by_name[n] for n in names]


def _entry(route):
    ops = importlib.import_module(f"repro_torch.kernels.{route.package}.ops")
    return getattr(ops, route.entry)


def _outputs(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def _same_bits(a: tuple, b: tuple) -> bool:
    import torch

    return all(x.shape == y.shape and x.dtype == y.dtype and torch.equal(
        x.contiguous().view(torch.uint8), y.contiguous().view(torch.uint8))
        for x, y in zip(a, b))


def _max_err(got: tuple, want: tuple) -> tuple[float, bool]:
    """(max |got - want| over the float outputs, NaN as inf; whether every
    output lies within TOLERANCE of the plain version and every integer
    output equals it)."""
    import torch

    err, ok = 0.0, True
    for g, w in zip(got, want):
        g = g.cpu()
        if not w.dtype.is_floating_point:
            ok &= torch.equal(g.to(w.dtype), w)
            continue
        d = (g.double() - w.double()).abs()
        finite = torch.isfinite(w)
        d = torch.where(finite, d, torch.where(
            g.double() == w.double(), 0.0, float("inf")))
        e = float(d.max()) if d.numel() else 0.0
        scale = float(w.double()[finite].abs().max()) if finite.any() \
            else 1.0
        ok &= e <= TOLERANCE.get(str(w.dtype).split(".")[-1], 1e-4) * max(
            scale, 1.0)
        err = max(err, e)
    return err, ok


class _Guard:
    """Launches that move each operand into a guard band (see the module
    doc); ``problems`` collects what the bands show."""

    def __init__(self, device, fill: int):
        self.device, self.fill = device, fill
        self.tensors: dict[int, object] = {}
        self.problems: list[str] = []

    def record(self, data_ptr):
        def wrapped(t):
            p = data_ptr(t)
            self.tensors[p] = t
            return p
        return wrapped

    def wrap(self, fn, argtypes, data_ptr):
        import torch

        def launch(*args):
            args, bands = list(args), []
            for i, (a, ty) in enumerate(zip(args, argtypes)):
                t = self.tensors.get(a) if ty is ctypes.c_void_p else None
                if t is None or not t.numel():
                    continue
                span = 1 + sum((s - 1) * st
                               for s, st in zip(t.shape, t.stride()))
                raw = t.as_strided((span,), (1,)).view(torch.uint8)
                n = raw.numel()
                buf = torch.full((2 * GUARD_BYTES + n,), self.fill,
                                 dtype=torch.uint8, device=self.device)
                buf[GUARD_BYTES:GUARD_BYTES + n].copy_(raw)
                args[i] = data_ptr(buf) + GUARD_BYTES
                bands.append((i, raw, buf, n))
            err = fn(*args)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            for i, raw, buf, n in bands:
                for where, band in (("before", buf[:GUARD_BYTES]),
                                    ("after", buf[GUARD_BYTES + n:])):
                    bad = int((band != self.fill).sum())
                    if bad:
                        self.problems.append(
                            f"{bad} byte(s) written {where} operand {i} "
                            f"(fill {self.fill:#x})")
                raw.copy_(buf[GUARD_BYTES:GUARD_BYTES + n])
            return err
        return launch


def _guarded(route, args, kwargs, device, fill: int):
    import torch

    from repro_torch.kernels import build

    guard = _Guard(device, fill)
    data_ptr = torch.Tensor.data_ptr
    load = build.load_function
    torch.Tensor.data_ptr = guard.record(data_ptr)
    build.load_function = lambda name, fn, argtypes: guard.wrap(
        load(name, fn, argtypes), argtypes, data_ptr)
    try:
        out = _outputs(_entry(route)(*args, **kwargs))
    finally:
        torch.Tensor.data_ptr = data_ptr
        build.load_function = load
    return out, guard.problems


def _child_route(route, kind: str, device) -> dict:
    import torch

    cpu_args, cpu_kwargs = route.make("cpu")
    want = _outputs(_entry(route)(*cpu_args, **cpu_kwargs))
    args, kwargs = route.make(device)
    with torch.inference_mode():
        runs = [_outputs(_entry(route)(*args, **kwargs))
                for _ in range(REPEATS if kind == "guard" else 1)]
        err, ok = _max_err(runs[0], want)
        out = {"max_abs_err": err, "agrees": ok}
        if kind != "guard":
            return out
        out["repeat"] = "clean" if all(_same_bits(runs[0], r)
                                       for r in runs[1:]) else \
            f"errors: the bits differ across {REPEATS} launches"
        problems = []
        for fill in FILLS:
            got, bands = _guarded(route, args, kwargs, device, fill)
            problems += bands
            if not _same_bits(got, runs[0]):
                problems.append(f"with fill {fill:#x} the outputs differ "
                                "from the unguarded launch (a read outside "
                                "an operand)")
        out["guard"] = "clean" if not problems else \
            "errors: " + "; ".join(problems)
    return out


def child_main(kind: str, names) -> int:
    """Run ``names`` on card 0, printing ``@@begin``/``@@end`` markers (and
    each route's result as JSON) for :func:`run` to read."""
    import torch

    device = torch.device("cuda", 0)
    for route in _routes(names):
        print(f"@@begin {route.name}", flush=True)
        try:
            res = _child_route(route, kind, device)
        except Exception as e:  # the route's failure is its result
            res = {"failed": f"{type(e).__name__}: {e}"}
        print(f"@@end {route.name} {json.dumps(res)}", flush=True)
    return 0


def _command(kind: str, tool: Optional[str], names) -> list:
    cmd = [sys.executable, "-m", "repro_torch.lint.sanitize", "--child",
           kind, *names]
    if kind == "guard":
        return cmd
    return [tool, "--tool", kind, "--show-backtrace", "no",
            "--print-limit", "200", *cmd]


def _parse(kind: str, text: str, names) -> dict:
    """Route name -> result of one child's output; routes it never reached
    are missing."""
    out, cur, lines = {}, None, []
    for line in text.splitlines():
        if line.startswith("@@begin "):
            cur, lines = line.split(" ", 1)[1], []
        elif line.startswith("@@end ") and cur is not None:
            res = json.loads(line.split(" ", 2)[2])
            errors = [ln for ln in lines if _ERROR_LINE.match(ln)
                      and "SUMMARY" not in ln]
            unmodeled = [ln.strip("= ") for ln in lines
                         if _UNMODELED.search(ln)]
            if kind != "guard":
                if errors:
                    res[kind] = "errors: " + " | ".join(
                        ln.strip("= ") for ln in errors[:8])
                    hit = _CU_LINE.search(" ".join(lines))
                    if hit:
                        res["cu_line"] = [hit.group(1), int(hit.group(2))]
                elif unmodeled:
                    res[kind] = "not checked: " + unmodeled[0]
                else:
                    res[kind] = "clean"
            out[cur] = res
            cur = None
        elif cur is not None:
            lines.append(line)
    return out


def _run_kind(kind: str, tool: Optional[str], names, env) -> dict:
    """Every route of ``names`` under one kind, a child restarted on the
    routes left when one dies mid-route."""
    if kind != "guard" and tool is None:
        return {n: {kind: "not checked: compute-sanitizer not found"}
                for n in names}
    results, left = {}, list(names)
    while left:
        proc = subprocess.run(_command(kind, tool, left), env=env,
                              capture_output=True, text=True,
                              timeout=CHILD_TIMEOUT_S)
        text = proc.stdout + "\n" + proc.stderr
        refusal = next((r for r in _TOOL_REFUSALS if r in text), None)
        if kind != "guard" and refusal is not None:
            for n in left:
                results[n] = {kind: f"not checked: compute-sanitizer: "
                                    f"{refusal} (exit {proc.returncode})"}
            return results
        got = _parse(kind, proc.stdout, left)
        results.update(got)
        left = [n for n in left if n not in got]
        if left:  # the child died in left[0]
            tail = " | ".join(text.strip().splitlines()[-6:])
            results[left[0]] = {kind if kind != "guard" else "guard":
                                f"errors: the child died in this route "
                                f"(exit {proc.returncode}): {tail}"}
            left = left[1:]
    return results


def run(device: str = "cuda", names=None) -> dict:
    """Run ``names`` (default: every route) under every kind; raises
    without a card.  ``{"tool": path or None, "routes": {name: {kind:
    status, "repeat": status, "max_abs_err": x, ...}}}``."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.lint.geometry import ROUTES

    if torch.device(device).type != "cuda":
        raise ValueError(f"the device half runs on a CUDA card, not {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: torch.cuda.is_available() is False; the "
            "kernels' device checks need the card (the static passes run "
            "without --device)")
    names = [r.name for r in ROUTES] if names is None else list(names)
    build.build()  # once, before the children load the libraries
    tool = _tool()
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [_src_dir()] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    with concurrent.futures.ThreadPoolExecutor(len(KINDS)) as pool:
        futures = {k: pool.submit(_run_kind, k, tool, names, env)
                   for k in KINDS}
        by_kind = {k: f.result() for k, f in futures.items()}
    routes = {}
    for n in names:
        res = {}
        for kind in KINDS:
            part = by_kind[kind].get(n, {})
            if "failed" in part:
                part = {**part, kind: f"errors: {part['failed']}"}
            if part.get("max_abs_err") is not None:
                res["max_abs_err"] = max(res.get("max_abs_err", 0.0),
                                         part["max_abs_err"])
            if kind == "guard":
                res["guard"] = part.get("guard", part.get(kind))
                res["repeat"] = part.get("repeat", "not run")
                res["plain"] = {True: "clean", None: "not run"}.get(
                    part.get("agrees"), f"errors: max_abs_err "
                    f"{part.get('max_abs_err')!r} over the plain version's "
                    "tolerance")
            else:
                res[kind] = part.get(kind, "not run")
            if "cu_line" in part:
                res.setdefault("cu_line", part["cu_line"])
        routes[n] = res
    return {"tool": tool, "routes": routes}


def _findings(results: dict, pass_id: str, keys) -> list:
    from repro_torch.kernels import build

    out = []
    for name, res in results["routes"].items():
        pkg = name.split("/", 1)[0]
        for key in keys:
            status = res.get(key) or "not run"
            if status.startswith("not checked"):
                continue
            if status != "clean":
                path, line = str(build.SRC_DIR / f"{pkg}.cu"), 1
                if "cu_line" in res:
                    path, line = res["cu_line"]
                out.append(Finding(pass_id, path, line,
                                   f"{name}: {key}: {status}"))
    return out


def memory_findings(results: dict) -> list:
    """``kernel-memory``'s findings: memcheck, the guard bands, and the
    outputs against the plain version."""
    return _findings(results, "kernel-memory", ("memcheck", "guard",
                                                "plain"))


def race_findings(results: dict) -> list:
    """``kernel-race``'s findings: racecheck and the repeated launches."""
    return _findings(results, "kernel-race", ("racecheck", "repeat"))


def unchecked(results: dict) -> dict:
    """Route -> {kind: the tool's words} for every check the tool could
    not make."""
    out = {}
    for name, res in results["routes"].items():
        for kind in ("memcheck", "racecheck"):
            status = res.get(kind) or ""
            if status.startswith("not checked"):
                out.setdefault(name, {})[kind] = status
    return out


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        sys.exit(child_main(sys.argv[2], sys.argv[3:]))
    print("usage: python -m repro_torch.lint.sanitize --child KIND ROUTE...",
          file=sys.stderr)
    sys.exit(2)
