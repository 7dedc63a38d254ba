#!/usr/bin/env python3
"""Drive the PyTorch port's exact-retrieval path on one NVIDIA H100.

Run from the root of a checkout, with one CUDA card and no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. Build both CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and print the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, at
   50,000 docs x 64 queries, V = 30,522, over several index geometries
   (``chunk_size < term_block``, a ragged last doc block, a tile-skipped
   index whose blanked chunks test the padding rule).
3. The main path at the repo's ``serve_1m`` shape (``repro.configs.
   gpusparse``): 1,000,000 docs generated on the card, V = 30,522, 500
   queries, k = 1000, through ``RetrievalEngine.search`` for engines
   ``tiled`` and ``ell``; the kernels' launch counters are zeroed just
   before and read just after.  Exactness against a float64 oracle on 16
   sampled queries: mean overlap@1000 >= 0.999, returned scores within
   1e-5 relative of float64, and the two engines agreeing the same way.
4. Each kernel against its plain version again at the main path's own
   shapes (the serve_1m index, all 500 queries: several query tiles and a
   ragged last one), then per-kernel times with CUDA events at those
   shapes: the kernel, its plain version, one library call computing the
   same scores (``torch.sparse.mm``, used nowhere in the port), and the
   least time the card could take (bytes over 3.35 TB/s or f32 operations
   over 67 TFLOP/s, H100 SXM data sheet).

It prints the ``kernels`` JSON line, the card line, and as its last line
``{"ok": true, "device": {...}}``.  Without a card, or outside a checkout,
it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
# Kernel vs plain version: both sum the same f32 products in another order
# (the plain version's index_add_ in atomic order, the kernel serially with
# fma), over at most a few hundred products per score.
KERNEL_TOL = 1e-5  # max |kernel - plain| <= KERNEL_TOL * max |plain|
OVERLAP_MIN = 0.999  # the paper's exactness bar; residue: f32 near-ties
SCORE_RTOL = 1e-5  # returned f32 scores vs float64


@dataclasses.dataclass(frozen=True)
class Sizes:
    vocab: int = 30522
    check_docs: int = 49_997  # ragged: not a multiple of any doc block
    check_queries: int = 64
    docs: int = 1_000_000  # serve_1m
    queries: int = 500
    k: int = 1000
    oracle_queries: int = 16
    rounds: int = 5
    reps: int = 5
    geometries: tuple = ((512, 256, 512), (512, 128, 256), (256, 64, 128))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(dev) -> None:
    import torch

    torch.cuda.synchronize(dev)


def event_ms(fn, reps: int, dev) -> float:
    """Mean ms of ``fn()`` over ``reps`` runs after one warm-up, timed with
    CUDA events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def padded_queries(queries, index):
    import torch.nn.functional as F

    qw = queries.to_dense()
    v_pad = index.num_term_blocks * index.term_block
    return F.pad(qw, (0, v_pad - qw.shape[1]))


def tiled_args(index):
    return dict(
        local_term=index.local_term, local_doc=index.local_doc,
        value=index.value, chunk_term_block=index.chunk_term_block,
        chunk_doc_block=index.chunk_doc_block,
        block_chunk_start=index.block_chunk_start,
        block_chunk_count=index.block_chunk_count,
        term_block=index.term_block, doc_block=index.doc_block,
        num_doc_blocks=index.num_doc_blocks,
    )


def compare(name: str, got, want) -> float:
    import torch

    sync(got.device)
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite output")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    rel = err / max(scale, 1e-30)
    log(f"  {name}: max_abs_err={err!r} max_abs_plain={scale!r} "
        f"rel={rel!r}")
    if rel > KERNEL_TOL:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (rel {rel} > {KERNEL_TOL})")
    return err


def check_kernels(dev, sizes: Sizes):
    """Phase 2: each kernel against its plain version, several geometries."""
    import torch

    from repro_torch.core import index as index_mod
    from repro_torch.data.synthetic import make_msmarco_like
    from repro_torch.kernels.ell_gather import ell_gather, ell_gather_ref
    from repro_torch.kernels.scatter_score import (
        scatter_score, scatter_score_ref,
    )

    c = make_msmarco_like(sizes.check_docs, sizes.check_queries,
                          vocab_size=sizes.vocab, seed=11, device=dev)
    errs = {"scatter_score": 0.0, "ell_gather": 0.0}
    for tb, db, cs in sizes.geometries:
        idx = index_mod.build_tiled_index(c.docs, term_block=tb, doc_block=db,
                                          chunk_size=cs)
        qw = padded_queries(c.queries, idx)
        for tag, ix in (("", idx),
                        ("/tile-skip", index_mod.filter_tiled_index(
                            idx, c.queries.slice_rows(0, 2)))):
            args = tiled_args(ix)
            got = scatter_score(qw, **args)
            want = scatter_score_ref(qw, **{
                k: v for k, v in args.items()
                if k not in ("block_chunk_start", "block_chunk_count")
            })
            err = compare(f"scatter_score T={tb} D={db} C={cs}{tag}",
                          got, want)
            errs["scatter_score"] = max(errs["scatter_score"], err)
            again = scatter_score(qw, **args)
            if not torch.equal(got, again):
                raise AssertionError("scatter_score is not deterministic")
    ell = index_mod.build_ell_index(c.docs)
    qw = c.queries.to_dense()
    got = ell_gather(qw, ell.terms, ell.values)
    errs["ell_gather"] = compare("ell_gather", got,
                                 ell_gather_ref(qw, ell.terms, ell.values))
    return errs


def docs_csr(docs, dtype):
    """The docs as a CSR [N, V] tensor, for the library products this
    script uses as yardstick and check (the port never calls them)."""
    import torch

    live = docs.term_ids >= 0
    crow = torch.zeros(docs.batch + 1, dtype=torch.int64, device=docs.device)
    crow[1:] = torch.cumsum(live.sum(dim=1), 0)
    return torch.sparse_csr_tensor(
        crow, docs.term_ids[live].long(), docs.values[live].to(dtype),
        size=(docs.batch, docs.vocab_size),
    )


def overlap(a, b, k: int) -> float:
    return sum(len(set(x[:k].tolist()) & set(y[:k].tolist())) / k
               for x, y in zip(a, b)) / len(a)


def check_exact(name: str, vals, ids, oracle, sample, k: int):
    """Overlap@k with the float64 top-k, and returned scores vs float64."""
    import numpy as np
    import torch

    o = oracle.T  # [Bq, N]
    o_ids = torch.topk(o, k, dim=1).indices.cpu().numpy()
    ov = overlap(ids[sample], o_ids, k)
    got = torch.from_numpy(vals[sample]).double().to(o.device)
    want = o.gather(1, torch.from_numpy(ids[sample]).to(o.device))
    rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
    log(f"  {name}: overlap@{k} vs f64 = {ov!r}, max rel score err = {rel!r}")
    if not np.all(ids[sample] >= 0):
        raise AssertionError(f"{name}: missing ids in the top-{k}")
    if ov < OVERLAP_MIN or rel > SCORE_RTOL:
        raise AssertionError(f"{name}: not exact (overlap {ov}, rel {rel})")


def run(dev, sizes: Sizes) -> list[dict]:
    import numpy as np
    import torch

    from repro_torch.core import RetrievalConfig, RetrievalEngine, SparseBatch
    from repro_torch.core.topk import topk_two_stage
    from repro_torch.data.synthetic import make_msmarco_like
    from repro_torch.kernels import build
    from repro_torch.kernels.ell_gather import ops as ell_ops
    from repro_torch.kernels.ell_gather.ref import ell_gather_ref
    from repro_torch.kernels.scatter_score import ops as scatter_ops
    from repro_torch.kernels.scatter_score.ref import scatter_score_ref

    # 1. build
    t0 = time.perf_counter()
    build.build()
    log(f"build: {time.perf_counter() - t0:.3f} s for {', '.join(build.SOURCES)}")
    for name, out in build.compiler_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line.lower():
                log(f"  {name}: {line.strip()}")

    # 2. kernels vs plain versions
    log(f"phase 2: kernels vs plain, {sizes.check_docs} docs x "
        f"{sizes.check_queries} queries, V={sizes.vocab}")
    errs = check_kernels(dev, sizes)

    # 3. main path
    log(f"phase 3: main path, {sizes.docs} docs x {sizes.queries} queries, "
        f"V={sizes.vocab}, k={sizes.k}")
    t0 = time.perf_counter()
    corpus = make_msmarco_like(sizes.docs, sizes.queries,
                               vocab_size=sizes.vocab, seed=0, device=dev)
    sync(dev)
    nnz = int((corpus.docs.term_ids >= 0).sum())
    q_nnz = int((corpus.queries.term_ids >= 0).sum())
    log(f"  corpus on device: {time.perf_counter() - t0:.3f} s; "
        f"{nnz / sizes.docs:.2f} nnz/doc, {q_nnz / sizes.queries:.2f} "
        f"nnz/query, K={corpus.docs.max_terms}")
    scatter_ops.launches = 0
    ell_ops.launches = 0
    engines, results = {}, {}
    for name in ("tiled", "ell"):
        t0 = time.perf_counter()
        eng = RetrievalEngine(corpus.docs, RetrievalConfig(engine=name,
                                                           k=sizes.k),
                              device=dev)
        sync(dev)
        log(f"  {name}: index build {time.perf_counter() - t0:.3f} s, "
            f"{eng.index_bytes()} B ({eng.index_bytes() / sizes.docs:.1f} "
            f"B/doc)")
        results[name] = eng.search(corpus.queries, k=sizes.k)  # warm-up
        times = []
        for _ in range(sizes.rounds):
            t0 = time.perf_counter()
            vals, ids = eng.search(corpus.queries, k=sizes.k)
            times.append(time.perf_counter() - t0)
        ms = 1e3 * float(np.median(times))
        log(f"  {name}: search {ms!r} ms/batch (median of {sizes.rounds}, "
            f"all {[1e3 * t for t in times]!r}), "
            f"{sizes.queries / ms * 1e3!r} QPS at the median, "
            f"{sizes.queries * sizes.rounds / sum(times)!r} QPS over the "
            f"whole window of {sizes.rounds} rounds")
        if vals.shape != (sizes.queries, sizes.k):
            raise AssertionError(f"{name}: result shape {vals.shape}")
        if not np.all(np.isfinite(vals)):
            raise AssertionError(f"{name}: non-finite scores")
        engines[name] = eng
    launches = {"scatter_score": scatter_ops.launches,
                "ell_gather": ell_ops.launches}
    log(f"  launches on the main path: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")

    g = torch.Generator().manual_seed(5)
    sample = torch.randperm(sizes.queries, generator=g)[
        :sizes.oracle_queries].sort().values.numpy()
    sel = torch.from_numpy(sample).to(dev)
    oracle = torch.sparse.mm(
        docs_csr(corpus.docs, torch.float64),
        SparseBatch(corpus.queries.term_ids[sel], corpus.queries.values[sel],
                    sizes.vocab).to_dense(torch.float64).T,
    )
    for name, (vals, ids) in results.items():
        check_exact(name, vals, ids, oracle, sample, sizes.k)
    (tv, ti), (ev, ei) = results["tiled"], results["ell"]
    ov = overlap(ti, ei, sizes.k)
    rel = float(np.max(np.abs(tv - ev) / np.maximum(np.abs(ev), 1e-30)))
    log(f"  tiled vs ell: overlap@{sizes.k} = {ov!r}, max rel = {rel!r}")
    if ov < OVERLAP_MIN or rel > SCORE_RTOL:
        raise AssertionError("tiled and ell disagree")

    # 4. kernels vs plain at the main path's shapes, then times per kernel
    log("phase 4: kernels vs plain at the main shapes; times (CUDA events)")
    tiled = engines["tiled"]._index
    ell = engines["ell"]._index
    qw_t = padded_queries(corpus.queries, tiled)
    qw = corpus.queries.to_dense()
    b = sizes.queries
    specs = {
        "scatter_score": dict(
            kernel=lambda: scatter_ops.scatter_score(qw_t, **tiled_args(tiled)),
            plain=lambda: scatter_score_ref(qw_t, **{
                k: v for k, v in tiled_args(tiled).items()
                if k not in ("block_chunk_start", "block_chunk_count")}),
            bytes=(tiled.num_chunks * tiled.chunk_size * 12
                   + tiled.num_chunks * 4 + tiled.num_doc_blocks * 8
                   + b * qw_t.shape[1] * 4
                   + b * tiled.padded_docs * 4),
            source="src/repro_torch/csrc/scatter_score.cu",
            replaces="src/repro/kernels/scatter_score/kernel.py:98",
        ),
        "ell_gather": dict(
            kernel=lambda: ell_ops.ell_gather(qw, ell.terms, ell.values),
            plain=lambda: ell_gather_ref(qw, ell.terms, ell.values),
            bytes=(ell.terms.numel() * 8 + b * sizes.vocab * 4
                   + b * ell.terms.shape[0] * 4),
            source="src/repro_torch/csrc/ell_gather.cu",
            replaces="src/repro/kernels/ell_gather/kernel.py:57",
        ),
    }
    for name, s in specs.items():
        err = compare(f"{name} at {sizes.docs} docs x {b} queries",
                      s["kernel"](), s["plain"]())
        errs[name] = max(errs[name], err)
    csr = docs_csr(corpus.docs, torch.float32)
    library_ms = event_ms(lambda: torch.sparse.mm(csr, qw.T), sizes.reps, dev)
    del csr
    # Where a search call's time goes besides the kernel: the [B, N] top-k.
    scores = engines["ell"].score(corpus.queries)
    topk_ms = event_ms(lambda: topk_two_stage(scores, sizes.k), sizes.reps,
                       dev)
    del scores
    log(f"  topk_two_stage [{b}, {sizes.docs}] k={sizes.k}: {topk_ms!r} ms")
    flops = 2.0 * nnz * b
    rows = []
    for name, s in specs.items():
        kernel_ms = event_ms(s["kernel"], sizes.reps, dev)
        plain_ms = event_ms(s["plain"], max(1, sizes.reps // 2), dev)
        t_bytes = s["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        row = {
            "name": name, "route": "cuda", "source": s["source"],
            "replaces": s["replaces"], "launches": launches[name],
            "max_abs_err": errs[name], "ms": kernel_ms,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
        }
        log(f"  {name}: kernel {kernel_ms!r} ms, plain {plain_ms!r} ms, "
            f"library {library_ms!r} ms, bound {row['bound_ms']!r} ms "
            f"({row['bound_by']}: {s['bytes']} B, {flops!r} flop)")
        rows.append(row)
    log(f"peak device memory: {torch.cuda.max_memory_allocated(dev)} B")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    card = card_line()
    log(f"card: {card}")
    dev = torch.device("cuda", 0)
    rows = run(dev, Sizes())
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
