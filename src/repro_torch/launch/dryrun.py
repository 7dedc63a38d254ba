"""Dry run: count every (arch x shape) cell on the port's layouts and record
its cost, collective and memory artifacts (``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun                # all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch schnet \\
        --shape full_graph_sm --device cuda

``--device meta`` (the default) builds each cell on ``meta`` tensors and
counts one rank's step (:mod:`repro_torch.analysis.probes`): FLOPs,
bytes, peak live bytes, the aten op histogram, the collective bytes the
step would move (:mod:`repro_torch.analysis.ops`), the H100 roofline
terms and whether the peak fits the card's memory.  ``--device cuda``
also runs, once after a warm-up, the step of each ``"single"`` cell that
the count says fits, on seeded weights and inputs (``--seed``): its ms
(CUDA events), ``torch.cuda.max_memory_allocated`` (the counterpart of
XLA's ``memory_analysis``) and the warm-up's kernels by launch count
(``torch.profiler``).  One JSON artifact a cell lands in
``build/dryrun/<arch>__<shape>__<layout>.json`` (``--out``); failures are
listed at the end and the exit code is 1.
"""
from __future__ import annotations

import argparse
import json
import os
import traceback

from repro_torch.analysis import ops as ops_mod
from repro_torch.analysis import probes
from repro_torch.analysis.roofline import HBM_BYTES, roofline_from_artifacts
from repro_torch.configs.base import get_arch
from repro_torch.launch.cells import all_cells, make_cell, shape_of
from repro_torch.launch.mesh import production_layout
from repro_torch.utils import resolve_device

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "build", "dryrun")


def measure_on_card(arch: str, shape: str, device, seed: int = 0) -> dict:
    """Build the ``"single"`` cell with seeded weights and inputs on
    ``device``, run its step once to warm up under ``torch.profiler``
    (its kernels by launch count), then once timed with CUDA events ->
    ms, the peak of ``max_memory_allocated`` over both runs, the kernel
    histogram and the card's name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    spec = get_arch(arch)
    cell = make_cell(spec, shape_of(spec, shape), "single", dev, seed)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cell.step_fn(*cell.args)
        torch.cuda.synchronize(dev)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    cell.step_fn(*cell.args)
    end.record()
    torch.cuda.synchronize(dev)
    out = {"ms": start.elapsed_time(end),
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "launches": sum(e.count for e in kernels),
           "kernel_histogram": ops_mod.op_histogram(kernels, top=12),
           "device": torch.cuda.get_device_name(dev)}
    del cell
    torch.cuda.empty_cache()
    return out


def run_cell(arch: str, shape: str, layout: str = "single",
             device: str = "meta", seed: int = 0, out_dir: str = RESULTS_DIR,
             save: bool = True, verbose: bool = True) -> dict:
    spec = get_arch(arch)
    shape_spec = shape_of(spec, shape)
    lay = production_layout(layout)
    cell = make_cell(spec, shape_spec, lay)  # meta: model FLOPs, inputs
    cost = probes.spec_cost(spec, shape_spec, lay)
    coll = ops_mod.collective_bytes(cell)
    artifact = {
        "arch": arch,
        "shape": shape,
        "layout": layout,
        "mesh_shape": dict(zip(lay.axis_names, lay.mesh_shape)),
        "chips": lay.cards,
        "cost": cost["total"],
        "cost_parts": cost["parts"],
        "trips": cost["trips"],
        "cost_notes": cost["notes"],
        "collectives": {"total_bytes": coll.total_bytes,
                        "by_kind": coll.by_kind, "counts": coll.counts},
        "model_flops": cell.model_flops,
        "meta": cell.meta,
        "op_histogram": ops_mod.op_histogram(cost["ops"], top=12),
    }
    terms = roofline_from_artifacts(artifact)
    artifact["roofline"] = terms.row()
    artifact["fits"] = cost["total"]["peak_bytes"] <= HBM_BYTES
    if device != "meta":
        if layout != "single":
            raise ValueError(f"--device {device} runs the 'single' cells; "
                             f"{arch}/{shape}/{layout} needs "
                             f"{lay.cards} ranks")
        artifact["measured"] = (
            measure_on_card(arch, shape, device, seed) if artifact["fits"]
            else {"skipped": f"the count's peak "
                             f"{cost['total']['peak_bytes']:.4g} B exceeds "
                             f"the card's {HBM_BYTES} B"})
    if save:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{arch}__{shape}__{layout}.json")
        with open(path, "w") as f:
            json.dump(artifact, f, indent=1, default=str)
    if verbose:
        t = cost["total"]
        print(f"[dryrun] {arch:>14s}/{shape:<14s} layout={layout:<6s} "
              f"flops/dev={t['flops']:.4g} bytes/dev={t['bytes']:.4g} "
              f"peak={t['peak_bytes'] / 1e9:.3f}GB "
              f"fits={artifact['fits']} {terms.dominant} "
              f"bound={terms.bound_time * 1e3:.4g}ms "
              f"coll={coll.total_bytes / 1e6:.1f}MB "
              f"useful={terms.useful_ratio:.3f}")
        if "measured" in artifact:
            print(f"  measured: {artifact['measured']}")
    return artifact


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--layout", choices=["single", "quad", "both"],
                    default="single")
    ap.add_argument("--device", choices=["meta", "cuda"], default="meta")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        resolve_device("cuda")  # raises without a card

    cells = all_cells()
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]
    layouts = ["single", "quad"] if args.layout == "both" else [args.layout]

    failures = []
    for arch, shape in cells:
        for layout in layouts:
            device = args.device if layout == "single" else "meta"
            try:
                run_cell(arch, shape, layout, device, args.seed, args.out)
            except Exception as e:  # a cell's failure is listed, not fatal
                failures.append((arch, shape, layout, repr(e)))
                print(f"[dryrun] FAIL {arch}/{shape}/{layout}: {e}")
                traceback.print_exc()

    print(f"\n[dryrun] done; {len(failures)} failures")
    for f in failures:
        print("  FAIL:", f)
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
