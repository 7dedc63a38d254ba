"""Training driver: any LM arch of the registry, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --smoke --steps 20 --checkpoint-dir /tmp/ckpt --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --steps 5 --batch 1 --seq 4096

The port of :mod:`repro.launch.train`, with its flags and behaviour plus
``--device`` (``cuda``, the default, raises without a card).  ``--arch``
is resolved through :func:`repro_torch.configs.get_arch`; ``--smoke``
selects its reduced config.  The weights are drawn from a generator
seeded 0 on the device.  With ``--checkpoint-dir`` it restarts from the
latest checkpoint there and replays the deterministic pipeline from that
step; the supervisor's signal handlers turn SIGTERM/SIGINT into a final
checkpoint and a stop.  Like JAX's driver it trains on one device with
``make_train_step`` (the data-parallel step is
``repro_torch.train.make_ddp_train_step``).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch.checkpoint import Checkpointer, load_latest
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DeterministicPipeline, lm_batch_fn
from repro_torch.models.transformer import TransformerLM
from repro_torch.runtime import FaultToleranceSupervisor
from repro_torch.train import (
    AdamWConfig, Trainer, copy_state, init_state, make_train_step,
)
from repro_torch.utils import resolve_device


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> list[dict]:
    """Run the driver with ``argv`` (default: the command line) and return
    the metrics of the steps it ran (``Trainer.run``'s log)."""
    args = _parser().parse_args(argv)
    spec = get_arch(args.arch)
    if spec.family != "lm":
        raise ValueError(f"{args.arch}: train.py drives LM archs; see "
                         f"serve.py")
    cfg = spec.smoke_config if args.smoke else spec.config
    dev = resolve_device(args.device)
    model = TransformerLM(cfg, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(0))

    adamw = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps)
    step = make_train_step(model.loss_fn, adamw,
                           microbatches=args.microbatches)
    state = init_state(dict(model.named_parameters()), adamw).as_dict()

    start_step = 0
    ck = None
    if args.checkpoint_dir:
        ck = Checkpointer(args.checkpoint_dir)
        restored, start_step = load_latest(args.checkpoint_dir, state)
        if restored is not None:
            copy_state(state, restored)
            print(f"[train] restored from step {start_step}")

    pipe = DeterministicPipeline(
        lm_batch_fn(args.batch, args.seq, cfg.vocab_size),
        seed=0, start_step=start_step,
    )
    sup = FaultToleranceSupervisor(install_signal_handlers=True)
    trainer = Trainer(step, state, iter(pipe), checkpointer=ck,
                      checkpoint_every=args.checkpoint_every,
                      supervisor=sup, start_step=start_step)
    log = trainer.run(args.steps - start_step)
    pipe.close()
    if log:
        print(f"[train] {args.arch}: loss {log[0]['loss']:.3f} -> "
              f"{log[-1]['loss']:.3f} over {len(log)} steps")
    if ck:
        ck.wait()
    return log


if __name__ == "__main__":
    main()
