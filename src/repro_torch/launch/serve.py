"""Serving driver: the retrieval system, document-sharded over the ranks.

    PYTHONPATH=src python -m repro_torch.launch.serve --docs 2000 --batch 32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --engine tiled-bmp-grouped --sched
    PYTHONPATH=src torchrun --nproc-per-node 4 \\
        -m repro_torch.launch.serve --docs 1000000 --batch 500

Builds the index, shards it over the ranks (one shard a rank: the index
is built with as many shards as the process group has ranks), and serves
batched queries through the sharded step and its top-k merge
(:mod:`repro_torch.core.distributed`); the port of
:mod:`repro.launch.serve`, with the same flags.  Run plainly it serves at
world size 1 with no process group; under ``torchrun`` (``WORLD_SIZE`` >
1) it joins NCCL on ``--device cuda`` (rank r on ``cuda:LOCAL_RANK``) or
gloo on ``--device cpu``.  ``--device`` defaults to ``cuda`` and raises
without a card.

``--engine tiled-bmp-grouped``/``-fused`` run the demand-planned BMP
sweeps.  ``--sched`` pushes the queries through the bounded request
queue (EDF micro-batches of ``--max-batch``), each micro-batch driving the
sharded ``tiled-bmp-grouped`` step.  ``--obs-dump PATH`` writes the run's
metric snapshot and Chrome trace as JSON.  Times come from the obs clock
(``repro_torch.obs.clock``) with the device fenced; the exactness oracle
is the float64 top-k through the docs as CSR (``scoring.topk_f64``).
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch.core import registry, scoring
from repro_torch.core.distributed import (
    build_sharded_ell, build_sharded_tiled, make_serve_step,
)
from repro_torch.core.engine import RetrievalConfig
from repro_torch.core.index import EllIndex
from repro_torch.core.metrics import ranking_overlap
from repro_torch.core.sparse import SparseBatch
from repro_torch.data.synthetic import make_msmarco_like
from repro_torch.utils import resolve_device


def _join_group(device: str):
    """(device, rank, world size, whether this call made the group): the
    process group torchrun describes (``WORLD_SIZE`` > 1), NCCL on the
    card and gloo on the CPU; none at world size 1."""
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    dev = resolve_device(device)
    if world <= 1:
        return dev, 0, 1, False
    rank = int(os.environ["RANK"])
    if dev.type == "cuda":
        dev = resolve_device(
            torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank))))
        torch.cuda.set_device(dev)
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                rank=rank, world_size=world)
    return dev, rank, world, made


def _timed_rounds(serve, rounds: int, obs):
    """A warm-up, then ``rounds`` fenced calls -> (last result, s a call)."""
    out = serve()
    obs_mod.fence(out)
    t0 = obs_mod.clock()
    for _ in range(rounds):
        with obs_mod.timer(obs, "serve.batch_s"):
            out = serve()
            obs_mod.fence(out)
    return out, (obs_mod.clock() - t0) / max(rounds, 1)


def _serve_flat(args, corpus, dev, rank, n, cfg):
    """One sharded step per full query batch."""
    if registry.get_engine(args.engine).index_type is EllIndex:
        idx = build_sharded_ell(corpus.docs, num_shards=n)
        geometry = None
    else:  # tiled-bmp-grouped/-fused: demand-planned micro-batches a step
        idx = build_sharded_tiled(corpus.docs, num_shards=n,
                                  bounds_format=args.bounds_format)
        geometry = idx.geometry()
    idx = idx.keep_shard(rank, dev)
    serve = make_serve_step(engine=args.engine, cfg=cfg, k=args.k,
                            docs_per_shard=idx.docs_per_shard,
                            geometry=geometry)
    (_, ids, _), dt = _timed_rounds(
        lambda: serve(idx, queries=corpus.queries), args.rounds, cfg.obs)
    return ids.cpu().numpy(), dt


def _serve_queued(args, corpus, dev, rank, n, cfg):
    """Bounded-queue micro-batching in front of the sharded grouped step:
    each request is admitted with a deadline, EDF micro-batches of
    ``--max-batch`` drive the step, and results land in the caller's row
    order."""
    from repro_torch.sched import Request, RequestQueue

    idx = build_sharded_tiled(corpus.docs, num_shards=n,
                              bounds_format=args.bounds_format)
    idx = idx.keep_shard(rank, dev)
    serve = make_serve_step(engine=cfg.engine, cfg=cfg, k=args.k,
                            docs_per_shard=idx.docs_per_shard,
                            geometry=idx.geometry())
    q_ids = corpus.queries.term_ids.cpu().numpy()
    q_vals = corpus.queries.values.cpu().numpy()

    def micro_batch(reqs):
        rows = [int(r.query_id) for r in reqs]
        sub = SparseBatch(torch.from_numpy(q_ids[rows]).to(dev),
                          torch.from_numpy(q_vals[rows]).to(dev),
                          corpus.vocab_size)
        _, ids, _ = serve(idx, queries=sub)
        return rows, ids.cpu().numpy()

    def request(i):
        return Request(query_id=i, term_ids=q_ids[i], values=q_vals[i],
                       deadline=(i % 4) * 1e-3, arrival=0.0)

    # Warm-up: one micro-batch.  Nothing compiles per shape here (the JAX
    # driver warms up with a whole drain so that XLA compiles each bucket);
    # the kernels are built at their first launch.
    micro_batch([request(i) for i in range(min(args.max_batch, args.batch))])
    queue = RequestQueue(capacity=max(args.batch, 1))
    t0 = obs_mod.clock()
    with obs_mod.timer(cfg.obs, "serve.drain_s"):
        for i in range(args.batch):  # admission: one request at a time
            queue.submit(request(i))
        all_ids = np.full((args.batch, args.k), -1, np.int64)
        batches = 0
        while len(queue):  # EDF assembly; leftovers roll, never drop
            rows, ids = micro_batch(queue.pop_batch(args.max_batch))
            all_ids[rows] = ids[: len(rows)]
            batches += 1
    dt = obs_mod.clock() - t0
    if rank == 0:
        print(f"[sched] {args.batch} requests -> {batches} micro-batches "
              f"(max_batch={args.max_batch})")
    return all_ids, dt


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--engine", default="ell",
                    choices=["ell", "tiled-bmp-grouped", "tiled-bmp-fused"])
    ap.add_argument("--bounds-format", default="dense",
                    choices=["dense", "csr"],
                    help="fine-bound storage for the tiled engines")
    ap.add_argument("--sched", action="store_true",
                    help="drive the sharded step through the bounded "
                         "request queue (EDF micro-batches; implies "
                         "--engine tiled-bmp-grouped)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="micro-batch size for --sched")
    ap.add_argument("--obs-dump", metavar="PATH", default=None,
                    help="write the run's metric snapshot + Chrome trace "
                         "as JSON to PATH")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the driver with ``argv`` (default: the command line) and return
    what it printed as a dict: ``engine``, ``shards``, ``ms_per_batch``,
    ``us_per_query``, ``overlap``."""
    import torch.distributed as dist

    args = _parser().parse_args(argv)
    dev, rank, n, made_group = _join_group(args.device)
    try:
        corpus = make_msmarco_like(args.docs, args.batch,
                                   vocab_size=args.vocab, seed=0, device=dev)
        if args.sched:
            cfg = RetrievalConfig(engine="tiled-bmp-grouped", k=args.k)
            ids, dt = _serve_queued(args, corpus, dev, rank, n, cfg)
            mode = f"sched[{cfg.engine}]"
        else:
            cfg = RetrievalConfig(engine=args.engine, k=args.k)
            ids, dt = _serve_flat(args, corpus, dev, rank, n, cfg)
            mode = args.engine
        if args.obs_dump and rank == 0:
            from repro_torch.obs import collect

            collect.collect_plan_cache(cfg.obs.metrics, cfg.plan_cache)
            obs_mod.dump(cfg.obs, args.obs_dump)
            print(f"[obs] snapshot + chrome trace -> {args.obs_dump}")
        _, oracle_ids = scoring.topk_f64(corpus.queries, corpus.docs, args.k)
        ov = ranking_overlap(ids, oracle_ids.cpu().numpy(), args.k)
    finally:
        if made_group:
            dist.destroy_process_group()
    out = dict(engine=mode, shards=n, ms_per_batch=dt * 1e3,
               us_per_query=dt / args.batch * 1e6, overlap=ov)
    if rank == 0:
        print(f"[serve] {args.docs} docs x {n} shard(s), batch {args.batch}, "
              f"engine {mode}: {dt * 1e3:.1f} ms/batch "
              f"({dt / args.batch * 1e6:.0f} us/query), "
              f"exactness overlap={ov:.4f}")
    return out


if __name__ == "__main__":
    main()
