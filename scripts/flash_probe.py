#!/usr/bin/env python3
"""A first look at the CUDA ``flash_attention`` kernel on the card.

Builds ``csrc/flash_attention.cu`` and prints the compiler's report
(registers, spills); holds the kernel against ``flash_attention_ref`` and a
float64 softmax on eight shapes in f32 and bf16 (max errors, determinism);
then times it at qwen2-0.5b's prefill shape ([1, 32768, 14, 64] bf16,
random inputs) with CUDA events beside the plain version and each backend
of ``scaled_dot_product_attention`` with ``enable_gqa``.  Run from the
root of a checkout with one CUDA card:

    python3 scripts/flash_probe.py
"""
from __future__ import annotations

import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = (  # (B, S, Hq, Hkv, Dh, causal, window)
    (2, 64, 4, 2, 64, True, None), (1, 128, 6, 3, 64, True, 24),
    (2, 32, 2, 2, 64, False, None), (1, 96, 8, 1, 64, True, None),
    (2, 1000, 14, 2, 64, True, None), (1, 777, 32, 8, 128, True, None),
    (1, 300, 14, 2, 64, True, 100), (1, 200, 32, 8, 128, False, 50))


def naive64(q, k, v, causal, window):
    import torch

    b, sq, hq, dh = q.shape
    skv, g = k.shape[1], hq // k.shape[2]
    qq = q.double().permute(0, 2, 1, 3)
    kk = k.double().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    vv = v.double().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    lg = qq @ kk.transpose(-1, -2) / math.sqrt(dh)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= qp - kp < window
    p = torch.softmax(lg.masked_fill(~mask, float("-inf")), -1)
    return (p.nan_to_num(0.0) @ vv).permute(0, 2, 1, 3)


def event_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention_ref, ops

    t0 = time.perf_counter()
    build.build(["flash_attention"])
    print("build s", time.perf_counter() - t0)
    print(build.compiler_log.get("flash_attention", ""))
    print(sys.version, torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))
    dev = torch.device("cuda")
    with torch.inference_mode():
        for b, s, hq, hkv, dh, causal, window in SHAPES:
            for dt in (torch.float32, torch.bfloat16):
                g = torch.Generator(device=dev).manual_seed(s + hq)
                q, k, v = (torch.randn(b, s, h, dh, generator=g,
                                       device=dev).to(dt)
                           for h in (hq, hkv, hkv))
                got = ops.flash_attention(q, k, v, causal, window)
                want = flash_attention_ref(q, k, v, causal, window)
                exact = naive64(q, k, v, causal, window)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                err64 = (got.double() - exact).abs().max().item()
                same = torch.equal(got, ops.flash_attention(q, k, v, causal,
                                                            window))
                print(b, s, hq, hkv, dh, causal, window, dt, "err", err,
                      "err64", err64, "det", same, flush=True)

        b, s, hq, hkv, dh = 1, 32768, 14, 2, 64
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn(b, s, h, dh, generator=g,
                               device=dev).bfloat16()
                   for h in (hq, hkv, hkv))
        print("kernel ms", event_ms(lambda: ops.flash_attention(q, k, v), 3),
              flush=True)
        want = flash_attention_ref(q, k, v)
        got = ops.flash_attention(q, k, v)
        print("full err", (got.float() - want.float()).abs().max().item(),
              want.float().abs().max().item())
        print("ref ms", event_ms(lambda: flash_attention_ref(q, k, v), 1),
              flush=True)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        for backend in (SDPBackend.FLASH_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION,
                        SDPBackend.CUDNN_ATTENTION):
            with sdpa_kernel([backend]):
                try:  # a backend that does not take these inputs refuses
                    ms = event_ms(lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True), 3)
                except RuntimeError as e:
                    print("sdpa", backend, "refuses:", str(e)[:200])
                    continue
            print("sdpa", backend, ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
