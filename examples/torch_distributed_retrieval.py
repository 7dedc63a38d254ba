"""Document-sharded retrieval on the PyTorch port: the multi-card serving
path (``examples/distributed_retrieval.py`` on the JAX package, without
its dry run).

Each rank serves one contiguous shard of the corpus; every rank scores its
shard through the kernels, takes its local top-k, and the global top-k
comes from one gather over ``torch.distributed`` and a merge on the
device.  Run plainly it serves one shard (world size 1, no process
group); under ``torchrun`` one shard a rank (NCCL on the cards, gloo with
``--device cpu``):

    PYTHONPATH=src python examples/torch_distributed_retrieval.py
    PYTHONPATH=src torchrun --nproc-per-node 2 \\
        examples/torch_distributed_retrieval.py --device cpu
"""
import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import scoring
from repro_torch.core.distributed import build_sharded_ell, make_serve_step
from repro_torch.data.synthetic import make_msmarco_like


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    dev = torch.device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if world > 1:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                rank=rank, world_size=world)
    corpus = make_msmarco_like(num_docs=1000, num_queries=16,
                               vocab_size=2048, seed=1, device=dev)
    # Every rank builds the same index and keeps its own shard.
    idx = build_sharded_ell(corpus.docs, num_shards=world).keep_shard(
        rank, dev)
    # One factory for every sharded engine; steps uniformly return
    # (values, global ids, tau) so the serving tier can swap engines
    # without changing its recurrence.
    step = make_serve_step(engine="ell", k=20,
                           docs_per_shard=idx.docs_per_shard)
    vals, ids, _ = step(idx, queries=corpus.queries)
    want, _ = scoring.topk_f64(corpus.queries, corpus.docs, 20)
    ok = np.allclose(vals.cpu().numpy(), want.cpu().numpy(), atol=1e-4)
    if rank == 0:
        print(f"sharded serve over {world} shard(s): top-20 ids[0] = "
              f"{ids[0][:5].tolist()}...")
        print(f"device-side merged top-k exact vs oracle: {ok}")
    if world > 1:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
