#!/usr/bin/env python3
"""Where the time of a training step goes, on the card.

Profiles one step of ``make_train_step`` (forward, backward and AdamW) at
the shapes of ``chip_smoke.py``'s phase 7, each after a warm-up step,
under ``torch.profiler``: the SPLADE encoder (``repro_torch.configs.
gpusparse.ENCODER``, 32 pairs x 128 tokens, f32), ``qwen2-0.5b`` (``FULL``,
1 x 4,096 tokens, remat, bf16), a recsys model (``FULL``, B = 8,192,
bags of 8) and SchNet at a GNN_SHAPES cell (``schnet:<shape>``, FULL
width, the cell layer's seeded step and batch: ``launch.cells.
build_cell(..., device="cuda")``), all with seeded weights.  For each it prints the host-clock
time of the step (synchronised), the device time summed over its kernels
(one stream, so the busy share is their ratio) and the kernels that took
the most device time.  Run from the root of a checkout with one CUDA card:

    python3 scripts/profile_train.py [--models encoder lm xdeepfm
        schnet:full_graph_sm schnet:minibatch_lg schnet:molecule]
"""
from __future__ import annotations

import argparse
import itertools
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def profile(name: str, fn, dev, top: int) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()  # warm-up
    torch.cuda.synchronize(dev)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events)
    print(f"{name}: {wall_ms!r} ms on the host clock, {busy_ms!r} ms of "
          f"device kernels ({busy_ms / wall_ms!r} busy), {launches} kernel "
          f"launches")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms:12.3f} ms  {ms / busy_ms:7.2%}  x{e.count:<6d} "
              f"{e.key[:110]}")


def main() -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--models", nargs="+",
                   default=["encoder", "lm", "xdeepfm"])
    p.add_argument("--top", type=int, default=15)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import importlib

    from repro_torch.configs import gpusparse, qwen2_0_5b
    from repro_torch.data.pipeline import lm_batch_fn, paired_batch_fn
    from repro_torch.data.synthetic import make_recsys_batch
    from repro_torch.models.recsys import build_model
    from repro_torch.models.splade import SpladeEncoder
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.train import AdamWConfig, init_state, make_train_step

    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), torch.__version__)
    for name in args.models:
        gen = torch.Generator(device=dev).manual_seed(0)
        if name == "encoder":
            cfg = gpusparse.ENCODER
            model = SpladeEncoder(cfg, device=dev, generator=gen)
            loss_fn = lambda b, m=model: m.contrastive_loss(  # noqa: E731
                b, flops_weight=3e-4)
            batch = paired_batch_fn(cfg.vocab_size, 32, 128)(0, 0)
        elif name == "lm":
            cfg = qwen2_0_5b.FULL
            model = TransformerLM(cfg, device=dev, generator=gen)
            loss_fn = model.loss_fn
            batch = lm_batch_fn(1, 4096, cfg.vocab_size)(0, 0)
        elif name.startswith("schnet:"):
            from repro_torch.launch.cells import build_cell

            cell = build_cell("schnet", name.split(":", 1)[1], device=dev)
            profile(f"{name} train step", lambda c=cell: c.step_fn(*c.args),
                    dev, args.top)
            del cell
            torch.cuda.empty_cache()
            continue
        else:
            cfg = importlib.import_module(f"repro_torch.configs.{name}").FULL
            model = build_model(cfg, device=dev, seed=0)
            loss_fn = model.loss_fn
            batch = make_recsys_batch(8192, cfg.n_sparse, cfg.vocab_sizes,
                                      cfg.seq_len, cfg.item_vocab,
                                      multi_hot=8, seed=0)
        adamw = AdamWConfig(lr=1e-4, warmup_steps=1)
        step = make_train_step(loss_fn, adamw)
        state = init_state(dict(model.named_parameters()), adamw).as_dict()
        profile(f"{cfg.name} train step", lambda: step(state, batch), dev,
                args.top)
        del model, state, step
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
