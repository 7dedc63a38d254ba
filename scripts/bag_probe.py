#!/usr/bin/env python3
"""``embedding_bag`` (``src/repro_torch/csrc/embedding_bag.cu``) alone at
serve_bulk's shape: 262,144 examples x the 39 Criteo-39 fields, bags of 8,
over the 16,596,850-row concatenated table (seeded N(0, 1) rows, D = 10 by
default; ``--dim`` takes several).

Builds the kernel and prints the compiler's report (registers, spills).
For each D, on uniform ids and no weights: every route (vec, ivec) that
the inputs' values reach at 0-, 8- and 4-byte offsets
(``chip_smoke.route_copies``), held bitwise to one another and timed in
turns; then ``chip_smoke.bag_probe``: CUDA-event times under uniform ids,
ids confined to the L2-resident tail of the table, and ids all from the
10M-row field, with the row-sector rate each implies.  ``--parent PATH.cu``
adds the kernel of an earlier commit whose C entry ``embedding_bag_launch``
takes (ids, weights, table, out, n, l, v, d, device, stream), compiled
here with ``build.NVCC_FLAGS``: it is held bitwise to the tree's kernel on
unweighted bags and timed in turns with it.  Run from the root of a
checkout with one CUDA card:

    git show <commit>:src/repro_torch/csrc/embedding_bag.cu > build/parent.cu
    python3 scripts/bag_probe.py [--dim 10 16 18] [--parent build/parent.cu]
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARENT_ARGTYPES = (ctypes.c_void_p,) * 4 + (
    ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p)


def parent_kernel(src: str):
    """``fn(ids, table)`` launching the kernel compiled from ``src`` into
    ``build/probe/parent.so``; prints its registers and spills."""
    import torch

    from repro_torch.kernels import build

    out_dir = os.path.join(ROOT, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "parent.so")
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib_path,
                          src], capture_output=True, text=True)
    for line in (res.stdout + res.stderr).splitlines():
        if "registers" in line or "spill" in line.lower():
            print(f"  parent: {line.strip()}", flush=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}{res.stderr}")
    fn = ctypes.CDLL(lib_path).embedding_bag_launch
    fn.argtypes = list(PARENT_ARGTYPES)
    fn.restype = ctypes.c_int

    def run(ids, table):
        n, l = ids.shape
        v, d = table.shape
        out = torch.empty((n, d), dtype=torch.float32, device=ids.device)
        err = fn(ids.data_ptr(), None, table.data_ptr(), out.data_ptr(), n,
                 l, v, d, ids.device.index,
                 torch.cuda.current_stream(ids.device).cuda_stream)
        if err:
            raise RuntimeError(f"parent kernel: CUDA error {err}")
        return out

    return run


def route_times(table, ids, reps: int, dev) -> None:
    """CUDA-event ms of each route (vec, ivec) the values of ``table`` and
    ``ids`` reach at 0-, 8- and 4-byte offsets, in turns (a, b, ..., b, a;
    each route's mean); raises unless all give the same bits."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.embedding_bag import ops as bag_ops

    copies = cs.route_copies(ids, table, None)
    want = None
    for route, (i, t, _) in copies.items():
        got = bag_ops.embedding_bag(i, t)
        if want is None:
            want = got
        elif not torch.equal(got, want):
            raise AssertionError(f"route {route} gives other bits")
    times = {route: [] for route in copies}
    for route in [*copies, *reversed(copies)]:
        i, t, _ = copies[route]
        times[route].append(cs.event_ms(
            lambda: bag_ops.embedding_bag(i, t), reps, dev))
    for route, ts in times.items():
        cs.log(f"  route (vec, ivec) {route} D={table.shape[1]} uniform ids: "
               f"{sum(ts) / len(ts)!r} ms (turns {ts!r})")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, nargs="+", default=[10])
    ap.add_argument("--batch", type=int, default=262_144)
    ap.add_argument("--hot", type=int, default=8)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parent", metavar="PATH.cu",
                    help="an earlier commit's kernel, timed in turns")
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.configs.recsys_common import CRITEO39
    from repro_torch.kernels import build
    from repro_torch.kernels.embedding_bag import ops as bag_ops

    if not torch.cuda.is_available():
        print("bag_probe: no CUDA device", file=sys.stderr)
        return 2
    cs.log(f"card: {cs.card_line()}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    build.build(["embedding_bag"])
    cs.log(f"build: {time.perf_counter() - t0:.3f} s")
    for line in build.compiler_log.get("embedding_bag", "").splitlines():
        if "registers" in line or "spill" in line.lower():
            cs.log(f"  {line.strip()}")
    fns = {"kernel": lambda ids, table: bag_ops.embedding_bag(ids, table)}
    if args.parent:
        fns["parent"] = parent_kernel(args.parent)
    for d in args.dim:
        g = torch.Generator(device=dev).manual_seed(0)
        table = torch.randn(sum(CRITEO39), d, generator=g, device=dev)
        cs.log(f"table {tuple(table.shape)}, {args.batch} x {len(CRITEO39)} "
               f"bags of {args.hot}")
        ids = cs.bulk_ids("uniform", args.batch, CRITEO39, args.hot, dev,
                          seed=1)
        with torch.inference_mode():
            want = fns["kernel"](ids, table)
            if "parent" in fns and not torch.equal(fns["parent"](ids, table),
                                                   want):
                raise AssertionError("the parent kernel gives other bits")
            del want
            route_times(table, ids, args.reps, dev)
            del ids
            cs.bag_probe(fns, table, CRITEO39, args.batch, args.hot,
                         args.reps, dev)
        del table
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
