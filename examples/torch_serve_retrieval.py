"""End-to-end serving on the PyTorch port (``examples/serve_retrieval.py``
on the JAX package is the same story):

  SPLADE encoder -> sparse queries -> device-resident index -> batched
  scoring -> top-k, then the stateful serving stack of
  ``repro_torch.core.session`` and ``repro_torch.sched``.

    PYTHONPATH=src python examples/torch_serve_retrieval.py [--requests 64]
    PYTHONPATH=src python examples/torch_serve_retrieval.py --device cpu

* ``Retriever`` owns the index (``--engine`` picks the scorer); queries
  are encoded by ``SpladeEncoder`` (``ENCODER_SMOKE``, seeded random
  weights) through the ``splade_head`` kernel on the card.
* ``SearchSession`` keeps each stream's certified tau: after a live
  ``add_docs`` a repeat search scores only the new segment, warm-started
  at the cached tau, and equals a cold engine over everything.
* ``QueryScheduler`` admits requests through a bounded queue, assembles
  deadline-ordered micro-batches and serves them through the session on
  ``tiled-bmp-grouped`` — and must return what direct ``search`` does.
* ``--obs-dump PATH`` writes the scheduler's folded obs snapshot (latency
  percentiles, span histograms, plan-cache hit rate, kernel launches,
  Chrome-trace events) as JSON.
"""
import argparse

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch.configs.gpusparse import ENCODER_SMOKE
from repro_torch.core import RetrievalConfig, RetrievalEngine, Retriever
from repro_torch.core import scoring
from repro_torch.core.metrics import ranking_overlap
from repro_torch.core.sparse import dense_to_sparse
from repro_torch.data.synthetic import make_msmarco_like
from repro_torch.models.splade import SpladeEncoder
from repro_torch.sched import QueryScheduler


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--docs", type=int, default=1500)
    ap.add_argument("--engine", default="tiled",
                    choices=["tiled", "ell", "tiled-pruned",
                             "tiled-bmp-fused"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--obs-dump", default=None, metavar="PATH",
                    help="write the queued demo's folded obs snapshot "
                         "(+ Chrome trace) as JSON")
    args = ap.parse_args()
    dev = torch.device(args.device)
    use_kernel = dev.type == "cuda"

    cfg = ENCODER_SMOKE
    encoder = SpladeEncoder(cfg, device=dev,
                            generator=torch.Generator(dev).manual_seed(0))
    corpus = make_msmarco_like(args.docs, args.requests,
                               vocab_size=cfg.vocab_size, seed=3, device=dev)
    retriever = Retriever(corpus.docs, RetrievalConfig(engine=args.engine,
                                                       k=100), device=dev)
    print(f"serving {args.docs} docs via {args.engine!r} on {dev}, index "
          f"{retriever.index_bytes() / 1e6:.1f} MB")

    gen = torch.Generator().manual_seed(0)
    latencies = []
    for start in range(0, args.requests, args.batch):
        b = min(args.batch, args.requests - start)
        toks = torch.randint(0, cfg.vocab_size, (b, 48), generator=gen)
        t0 = obs_mod.clock()
        with torch.inference_mode():
            qvecs = encoder.encode(toks.to(dev), torch.ones(b, 48, device=dev),
                                   use_kernel=use_kernel)
        queries = dense_to_sparse(torch.where(qvecs > 0.05, qvecs, 0.0),
                                  device=dev)
        retriever.search(queries, k=100)  # results come back as numpy
        dt = obs_mod.clock() - t0
        latencies.append(dt / b)
        print(f"  batch {start // args.batch}: {b} reqs, {dt * 1e3:.1f} ms "
              f"total, {dt / b * 1e3:.2f} ms/req")
    print(f"mean per-request latency: {np.mean(latencies) * 1e3:.2f} ms "
          "(encode + score + top-k)")

    _, ids = retriever.search(corpus.queries, k=50)
    oracle = scoring.score_dense_f64(corpus.queries, corpus.docs)
    ov = ranking_overlap(ids, torch.argsort(-oracle, dim=1)[:, :50]
                         .cpu().numpy(), 50)
    print(f"ranking overlap vs float64 oracle: {ov:.4f}")

    # live growth, whole doc blocks a segment: warm session == cold engine
    growth = RetrievalConfig(engine="tiled-pruned", k=50, doc_block=64)
    base_n = max(args.docs // 64, 1) * 64
    base = corpus.docs.slice_rows(0, min(base_n, args.docs))
    extra = make_msmarco_like(64 * 8, 1, vocab_size=cfg.vocab_size, seed=7,
                              device=dev).docs
    grower = Retriever(base, growth, device=dev)
    session = grower.open_session(k=50)
    session.search(corpus.queries)
    grower.add_docs(extra)
    sv, si = session.search(corpus.queries)  # scores only the new segment
    both = dense_to_sparse(torch.cat([base.to_dense(), extra.to_dense()]),
                           device=dev)
    cv, ci = RetrievalEngine(both, growth, device=dev).search(
        corpus.queries, k=50)
    match = bool(np.array_equal(sv, cv) and np.array_equal(si, ci))
    print(f"grew index {base.batch} -> {grower.num_docs} docs (version "
          f"{grower.version}); warm session == cold start: {match}")
    if not match:
        raise SystemExit("session/cold-start mismatch")

    # queued, demand-aware serving
    sched_cfg = RetrievalConfig(engine="tiled-bmp-grouped", k=20,
                                doc_block=64)
    sr = Retriever(corpus.docs, sched_cfg, device=dev)
    sched = QueryScheduler(sr, k=20, capacity=256, max_batch=8,
                           max_entries=64, device=dev)
    qi = corpus.queries.term_ids.cpu().numpy()
    qv = corpus.queries.values.cpu().numpy()
    t0 = obs_mod.clock()
    now = sched.clock()
    for i in range(corpus.queries.batch):
        sched.submit(i, qi[i], qv[i], deadline=now + 0.05 * (i % 4))
    results = sched.drain()
    dt = obs_mod.clock() - t0
    dv, di = sr.search(corpus.queries, k=20)
    ok = len(results) == corpus.queries.batch and all(
        np.array_equal(r.values, dv[r.query_id])
        and np.array_equal(r.ids, di[r.query_id]) for r in results)
    print(f"scheduler served {len(results)} requests ({dt * 1e3:.1f} ms); "
          f"queued == direct search: {ok}")
    if not ok:
        raise SystemExit("scheduler/direct-search mismatch")
    snap = sched.obs_snapshot()
    e2e = snap.histograms["sched.e2e_latency_s"]
    print(f"obs: {int(snap.counters['kernel.launches_total'])} kernel "
          f"launches, e2e p50={e2e['p50'] * 1e3:.1f} ms "
          f"p99={e2e['p99'] * 1e3:.1f} ms, deadline misses "
          f"{snap.counters.get('sched.deadline_miss_total', 0)}, plan "
          f"hit-rate={snap.gauges['plan.cache.hit_rate']:.2f}")
    if args.obs_dump:
        obs_mod.dump(sched_cfg.obs, args.obs_dump, snapshot=snap)
        print(f"obs snapshot -> {args.obs_dump}")


if __name__ == "__main__":
    main()
