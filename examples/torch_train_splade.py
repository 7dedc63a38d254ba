"""Train the SPLADE encoder end to end on the PyTorch port (contrastive +
FLOPS regulariser) with its training substrate: the deterministic
pipeline, AdamW, checkpoints and the fault-tolerance supervisor.  Shows
retrieval quality improving and the representations sparsifying; the
encoding before and after training serves through the ``splade_head``
kernel and the ``tiled`` engine (``scatter_score``).

    PYTHONPATH=src python examples/torch_train_splade.py [--steps 200]
    PYTHONPATH=src python examples/torch_train_splade.py --device cpu

``examples/train_splade.py`` is the same run on the JAX package.
"""
import argparse
import tempfile

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.gpusparse import ENCODER_SMOKE
from repro_torch.core import RetrievalConfig, RetrievalEngine
from repro_torch.core.metrics import mrr_at_k
from repro_torch.core.sparse import dense_to_sparse
from repro_torch.data.pipeline import DeterministicPipeline, paired_batch_fn
from repro_torch.models.splade import SpladeEncoder
from repro_torch.runtime import FaultToleranceSupervisor
from repro_torch.train import (
    AdamWConfig, Trainer, init_state, make_train_step,
)
from repro_torch.train.train_loop import to_device


def eval_retrieval(encoder, vocab, device, seed=9):
    """MRR@10 of 32 queries over their 32 docs (query i's doc is i), and
    the mean nonzeros a doc, encoded through the kernel entry."""
    b = to_device(paired_batch_fn(vocab, 32, 24)(seed, 0), device)
    with torch.inference_mode():
        d = encoder.encode(b["d_tokens"], b["d_mask"], use_kernel=True)
        q = encoder.encode(b["q_tokens"], b["q_mask"], use_kernel=True)
        docs = dense_to_sparse(torch.where(d > 0.01, d, 0.0), device=device)
        queries = dense_to_sparse(torch.where(q > 0.01, q, 0.0),
                                  device=device)
        nnz = float((d > 0.01).sum(dim=1).float().mean())
    eng = RetrievalEngine(docs, RetrievalConfig(
        engine="tiled", k=10, term_block=128, doc_block=64, chunk_size=64),
        device=device)
    _, ids = eng.search(queries, k=10)
    return mrr_at_k(ids, [{i} for i in range(32)], 10), nnz


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = ENCODER_SMOKE
    encoder = SpladeEncoder(cfg, device=args.device,
                            generator=torch.Generator().manual_seed(0))
    dev = encoder.embed.device

    mrr0, nnz0 = eval_retrieval(encoder, cfg.vocab_size, dev)
    print(f"before training: mrr@10={mrr0:.3f}, nnz/doc={nnz0:.0f}")

    adamw = AdamWConfig(lr=2e-3, warmup_steps=10, total_steps=args.steps)
    step = make_train_step(
        lambda b: encoder.contrastive_loss(b, flops_weight=3e-4), adamw)
    state = init_state(dict(encoder.named_parameters()), adamw).as_dict()
    pipe = DeterministicPipeline(
        paired_batch_fn(cfg.vocab_size, 16, 24), seed=0, prefetch=2
    )
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        trainer = Trainer(
            step, state, iter(pipe), checkpointer=ck,
            checkpoint_every=args.ckpt_every,
            supervisor=FaultToleranceSupervisor(),
        )
        log = trainer.run(args.steps)
        ck.wait()
    pipe.close()
    print(f"loss: {log[0]['loss']:.3f} -> {log[-1]['loss']:.3f} "
          f"({args.steps} steps)")

    mrr1, nnz1 = eval_retrieval(encoder, cfg.vocab_size, dev)
    print(f"after training:  mrr@10={mrr1:.3f}, nnz/doc={nnz1:.0f}")
    print("(contrastive signal should raise MRR; FLOPS reg bounds nnz)")


if __name__ == "__main__":
    main()
