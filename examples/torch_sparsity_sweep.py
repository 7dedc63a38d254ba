"""Paper Table 5 in miniature on the PyTorch port (``examples/
sparsity_sweep.py`` on the JAX package is the same sweep): search latency
grows about linearly with document sparsity.

    PYTHONPATH=src python examples/torch_sparsity_sweep.py
    PYTHONPATH=src python examples/torch_sparsity_sweep.py --device cpu

Each row builds a ``tiled`` engine over 2,000 docs of V = 4,096 at a mean
of ``terms/doc`` terms (sd a quarter of it) and searches 16 queries for
their top-10: the median of 3 searches after a warm-up, timed with CUDA
events on the card (``--device cuda``, the default, raises without one)
or with the host clock on the CPU (the plain versions of the kernels).
"""
import argparse
import statistics
import time

import torch

from repro_torch.core import RetrievalConfig, RetrievalEngine
from repro_torch.data.synthetic import make_corpus, make_queries_with_qrels
from repro_torch.utils import resolve_device


def median_ms(fn, dev, iters: int = 3) -> float:
    """Median ms of ``fn()`` over ``iters`` calls after one warm-up: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(iters):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(dev)
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"device: {where}; ms/batch by {clock}")
    print(f"{'terms/doc':>10} {'index MB':>9} {'ms/batch':>9}")
    for terms in (10, 50, 100, 200):
        docs = make_corpus(2000, 4096, seed=terms,
                           doc_terms=(terms, terms * 0.25), device=dev)
        queries, _ = make_queries_with_qrels(docs, 16, seed=1, device=dev)
        eng = RetrievalEngine(docs, RetrievalConfig(engine="tiled", k=10),
                              device=dev)
        ms = median_ms(lambda: eng.search(queries, k=10), dev)
        print(f"{terms:>10} {eng.index_bytes() / 1e6:>9.1f} {ms:>9.3f}")


if __name__ == "__main__":
    main()
