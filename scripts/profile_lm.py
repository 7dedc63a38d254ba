#!/usr/bin/env python3
"""Where the time of an LM prefill and of a decode step goes, on the card.

Builds ``--arch`` (default ``qwen2-0.5b``; any LM of
``repro_torch.configs.get_arch``, its full config, ``--layers`` cutting its
depth) with seeded random weights, runs one prefill of B x S tokens and a
few decode steps from a cache whose first slots hold seeded K/V (the
shapes of ``chip_smoke.py``'s phase 5 by default), each after a warm-up,
under ``torch.profiler``, and prints for each: the host-clock time of the
window (synchronised), the device time summed over its kernels (one
stream, so the busy share is their ratio) and the kernels that took the
most device time.  For a mixture-of-experts arch it also prints the MoE
layers' share of the window: CUDA events around each ``moe_block`` call
(routing, dispatch, expert products and combine), summed.  Run from the
root of a checkout with one CUDA card:

    python3 scripts/profile_lm.py [--prefill-len 32768] [--decode-batch 32]
    python3 scripts/profile_lm.py --arch olmoe-1b-7b --prefill-batch 4 \
        --prefill-len 2048 --decode-context 2048
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class MoETimer:
    """Wraps ``layers.moe_block`` to record a CUDA event pair around each
    call while ``on``; ``ms()`` sums the pairs recorded since ``reset``."""

    def __init__(self, layers):
        self.layers, self.inner = layers, layers.moe_block
        self.pairs, self.on = [], False
        layers.moe_block = self

    def __call__(self, *args, **kw):
        import torch

        if not self.on:
            return self.inner(*args, **kw)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.inner(*args, **kw)
        end.record()
        self.pairs.append((start, end))
        return out

    def reset(self):
        self.pairs = []

    def ms(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def profile(name: str, fn, dev, top: int, moe=None) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()  # warm-up
    torch.cuda.synchronize(dev)
    if moe is not None:
        moe.reset()
        moe.on = True
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    if moe is not None:
        moe.on = False
        moe_ms = moe.ms()
        print(f"{name}: MoE layers {moe_ms!r} ms between their events over "
              f"{len(moe.pairs)} calls ({moe_ms / wall_ms!r} of the "
              f"window)")
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"{name}: {wall_ms!r} ms on the host clock, {busy_ms!r} ms of "
          f"device kernels ({busy_ms / wall_ms!r} busy)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms:12.3f} ms  {ms / busy_ms:7.2%}  x{e.count:<6d} "
              f"{e.key[:110]}")


def main() -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="qwen2-0.5b")
    p.add_argument("--layers", type=int, default=0,
                   help="cut the depth to this many layers (0: the "
                        "config's)")
    p.add_argument("--prefill-batch", type=int, default=1)
    p.add_argument("--prefill-len", type=int, default=32768)
    p.add_argument("--decode-batch", type=int, default=32)
    p.add_argument("--decode-context", type=int, default=32768)
    p.add_argument("--decode-steps", type=int, default=2)
    p.add_argument("--top", type=int, default=15)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_lm: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.models import layers
    from repro_torch.models.transformer import TransformerLM

    cfg = get_arch(args.arch).config
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    moe = MoETimer(layers) if cfg.moe else None
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), torch.__version__, cfg.name,
          f"{cfg.n_layers} layers")
    lm = TransformerLM(cfg, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0))
    tokens = torch.from_numpy(make_lm_batch(
        args.prefill_batch, args.prefill_len, cfg.vocab_size)["tokens"]).to(dev)
    with torch.inference_mode():
        profile(f"prefill {args.prefill_batch} x {args.prefill_len}",
                lambda: lm.prefill(tokens), dev, args.top, moe)
        db, ctx, steps = (args.decode_batch, args.decode_context,
                          args.decode_steps)
        cache = lm.init_cache(db, ctx + 2 * steps)
        g = torch.Generator(device=dev).manual_seed(3)
        for name in ("k", "v"):
            for li in range(cfg.n_layers):
                cache[name][li, :, :ctx] = torch.randn(
                    (db, ctx, cfg.n_kv_heads, cfg.head_dim), generator=g,
                    device=dev).to(cache[name].dtype)
        cache["pos"][:, :ctx] = torch.arange(ctx, dtype=torch.int32,
                                             device=dev)
        toks = torch.from_numpy(make_lm_batch(db, 2 * steps, cfg.vocab_size,
                                              seed=2)["tokens"]).to(dev)
        pos = [ctx]

        def decode():
            for _ in range(steps):
                lm.decode_step(cache, toks[:, pos[0] - ctx], pos[0])
                pos[0] += 1

        profile(f"decode {db} x {steps} steps from {ctx}", decode, dev,
                args.top, moe)
    return 0


if __name__ == "__main__":
    sys.exit(main())
