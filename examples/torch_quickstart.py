"""Quickstart on the PyTorch port (``examples/quickstart.py`` on the JAX
package is the same story): build a Retriever over a synthetic SPLADE-like
corpus, run batched exact retrieval, grow the index live, and verify
exactness against the float64 oracle.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The serving API has three layers (see ``repro_torch.core``):

  * engine registry — ``RetrievalConfig(engine=...)`` resolves through
    ``repro_torch.core.registry``; unknown names fail at config
    construction with the registered list.
  * ``Retriever`` — owns the (growable) index on one device;
    ``add_docs`` appends document batches as fresh segments.
  * ``SearchSession`` — per-query-stream cache: repeat searches after
    ``add_docs`` score only the new segments, warm-started at each
    stream's certified threshold.

On the card every search runs the CUDA kernels; ``--device cpu`` runs
their plain PyTorch versions.
"""
import argparse

import numpy as np

from repro_torch.core import (
    RetrievalConfig, Retriever, available_engines, scoring,
)
from repro_torch.core.metrics import mrr_at_k, ranking_overlap, recall_at_k
from repro_torch.data.synthetic import make_msmarco_like


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print("== GPUSparse quickstart (PyTorch + CUDA port) ==")
    print(f"registered engines: {', '.join(available_engines())}")
    corpus = make_msmarco_like(num_docs=2000, num_queries=32,
                               vocab_size=30522, seed=0, device=args.device)
    print(f"corpus: {corpus.docs.batch} docs, vocab {corpus.vocab_size}, "
          f"avg nnz/doc "
          f"{float(corpus.docs.nnz_per_row().float().mean()):.1f}")

    # Serve the first 1500 docs, then grow the index by the remaining 500.
    retriever = Retriever(
        corpus.docs.slice_rows(0, 1500),
        RetrievalConfig(engine="tiled", k=100, tile_skip=True),
        device=args.device,
    )
    print(f"index: {retriever.index_bytes()/1e6:.1f} MB "
          f"(version {retriever.version})")

    session = retriever.open_session(k=100)
    session.search(corpus.queries)  # caches per-stream state

    retriever.add_docs(corpus.docs.slice_rows(1500, 500))
    print(f"grew index to {retriever.num_docs} docs "
          f"(version {retriever.version}); session re-searches only the "
          f"new segment")
    vals, ids = session.search(corpus.queries)

    print(f"mrr@10   = {mrr_at_k(ids, corpus.qrels, 10):.3f}")
    print(f"recall@100 = {recall_at_k(ids, corpus.qrels, 100):.3f}")

    # Exactness vs the float64 oracle (paper §4.3 / Table 10): the
    # incrementally grown, session-served top-k must match a full scan.
    _, oracle_ids = scoring.topk_f64(corpus.queries, corpus.docs, 100)
    print(f"ranking overlap vs float64 oracle @100 = "
          f"{ranking_overlap(ids, oracle_ids.cpu().numpy(), 100):.4f} "
          f"(exact by design)")
    assert np.all(ids >= 0)


if __name__ == "__main__":
    main()
