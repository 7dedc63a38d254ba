#!/usr/bin/env python3
"""A first look at the tensor-core kernels on the card: ``flash_attention``
(bf16 wgmma route, f32 SIMT route) and ``splade_head`` (3xTF32 mma.sync).

Builds ``csrc/flash_attention.cu`` and ``csrc/splade_head.cu``, prints the
compiler's report (registers, spills) and the count of ``HGMMA`` / ``HMMA``
instructions in each library; holds ``flash_attention`` against
``flash_attention_ref`` and a float64 softmax on ``chip_smoke.Sizes``'
phase-5a shapes in f32 and bf16 (``chip_smoke.flash_within``: FLASH_TOL,
plus one bf16 ulp in bf16; deterministic), and ``splade_head`` against
``splade_head_ref`` (within KERNEL_TOL of max |plain|) on the card tests'
shapes, a query with no valid token and one with 130, both W layouts.
With ``--time`` it then times, with CUDA events, ``flash_attention`` at
qwen2-0.5b's prefill shape ([1, 32768, 14, 64], random inputs) in bf16 and
f32 beside ``scaled_dot_product_attention``, and ``splade_head`` at the
encode path's shape (B = 500, T = 64, 8-64 valid tokens, d = 768, V =
30,522, W as ``embed.T``) beside one ``torch.matmul``.  With
``--mma-peak`` it measures the TF32 ``mma.sync`` rate the card sustains
(a kernel of 16 independent m16n8k8 accumulators a warp, 8 warps a block,
2-8 blocks an SM), the ceiling of ``splade_head``'s route.  Every check
runs; the exit code is 1 if any failed.  Run from the root of a checkout
with one CUDA card:

    python3 scripts/flash_probe.py [--time] [--mma-peak]
"""
from __future__ import annotations

import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HEAD_SHAPES = (  # (B, T, d, V, layout, valid rows per query or None)
    (3, 37, 64, 1000, "contiguous", None), (2, 130, 96, 513, "embed.T", None),
    (1, 64, 768, 30522, "embed.T", None), (4, 200, 768, 2000, "contiguous", None),
    (2, 7, 64, 257, "embed.T", None), (64, 256, 768, 30522, "contiguous", None),
    (8, 64, 768, 4099, "embed.T", (8, 64, 0, 33, 17, 1, 63, 40)),
    (3, 200, 768, 3000, "embed.T", (130, 0, 200)),
    (3, 200, 768, 3000, "contiguous", (130, 0, 200)))


def check_flash(failures: list) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import flash_attention_ref, ops

    dev = torch.device("cuda")
    for b, s, hq, hkv, dh, causal, window in cs.Sizes().flash_shapes:
        g = torch.Generator(device=dev).manual_seed(s * hq + dh)
        base = [torch.randn(b, s, h, dh, generator=g, device=dev)
                for h in (hq, hkv, hkv)]
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (x.to(dt) for x in base)
            tag = f"flash {b} {s} {hq} {hkv} {dh} {causal} {window} {dt}"
            try:
                got = ops.flash_attention(q, k, v, causal, window)
                e = cs.flash_within(f"{tag} vs plain", got, flash_attention_ref(
                    q, k, v, causal, window))
                e64 = cs.flash_within(f"{tag} vs float64", got,
                                      cs.attention_f64(q, k, v, causal, window))
                same = torch.equal(got, ops.flash_attention(q, k, v, causal,
                                                            window))
                print(tag, "err", e, "err64", e64, "det", same, flush=True)
                if not same:
                    failures.append(f"{tag}: not deterministic")
            except Exception as exc:  # report every shape, then fail
                print(tag, "FAILED", exc, flush=True)
                failures.append(tag)
                if "CUDA error" in str(exc):
                    raise


def check_head(failures: list) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.splade_head import ops, splade_head_ref

    dev = torch.device("cuda")
    for b, t, d, v, layout, valid in HEAD_SHAPES:
        g = torch.Generator(device=dev).manual_seed(b * t + v)
        h = torch.randn(b, t, d, generator=g, device=dev)
        if valid is None:
            mask = (torch.rand(b, t, generator=g, device=dev) > 0.3).float()
            mask[:, 1::3] *= 0.5
            if b > 1:
                mask[-1] = 0.0
        else:
            mask = (torch.arange(t, device=dev)[None, :]
                    < torch.tensor(valid, device=dev)[:, None]).float()
        embed = torch.randn(v, d, generator=g, device=dev) * 0.05
        w = embed.T if layout == "embed.T" else embed.T.contiguous()
        bias = torch.randn(v, generator=g, device=dev) * 0.1
        tag = f"splade_head {b} {t} {d} {v} {layout} valid={valid}"
        try:
            got = ops.splade_head(h, mask, w, bias)
            err = cs.compare(tag, got, splade_head_ref(h, mask, w, bias))
            same = torch.equal(got, ops.splade_head(h, mask, w, bias))
            print(tag, "err", err, "det", same, flush=True)
            if not same:
                failures.append(f"{tag}: not deterministic")
        except Exception as exc:
            print(tag, "FAILED", exc, flush=True)
            failures.append(tag)
            if "CUDA error" in str(exc):
                raise


def time_kernels() -> None:
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from chip_smoke import event_ms
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.splade_head import ops as head_ops

    dev = torch.device("cuda")
    b, s, hq, hkv, dh = 1, 32768, 14, 2, 64
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(b, s, h, dh, generator=g, device=dev).bfloat16()
               for h in (hq, hkv, hkv))
    print("flash bf16 ms", event_ms(lambda: flash_ops.flash_attention(
        q, k, v), 5, dev), flush=True)
    qf, kf, vf = q.float(), k.float(), v.float()
    print("flash f32 ms", event_ms(lambda: flash_ops.flash_attention(
        qf, kf, vf), 2, dev), flush=True)
    del qf, kf, vf
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION]):
        print("sdpa ms", event_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 5, dev), flush=True)
    del q, k, v, qt, kt, vt

    b, t, d, v = 500, 64, 768, 30522
    g = torch.Generator(device=dev).manual_seed(1)
    h = torch.randn(b, t, d, generator=g, device=dev)
    lens = torch.randint(8, t + 1, (b,), generator=g, device=dev)
    mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).float()
    w = (torch.randn(v, d, generator=g, device=dev) * 0.05).T
    bias = torch.randn(v, generator=g, device=dev) * 0.1
    print("splade_head ms", event_ms(lambda: head_ops.splade_head(
        h, mask, w, bias), 5, dev), "valid rows", int(mask.sum()), flush=True)
    print("matmul ms", event_ms(lambda: torch.matmul(h.view(b * t, d), w), 5,
                                dev), flush=True)


MMA_PEAK_CU = r"""
#include <cuda_runtime.h>
#include "hopper.cuh"
__global__ void __launch_bounds__(256) mma_peak(float* out, int iters) {
  float acc[16][4] = {};
  const uint32_t a[4] = {threadIdx.x, 2u, 3u, 4u}, b[2] = {5u, threadIdx.x};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j) hopper::mma_tf32(acc[j], a, b);
  }
  float s = 0.f;
  for (int j = 0; j < 16; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_peak_launch(float* out, int blocks, int iters) {
  mma_peak<<<blocks, 256>>>(out, iters);
  return cudaGetLastError();
}
"""


def mma_peak() -> None:
    import ctypes
    import subprocess

    import torch

    from chip_smoke import event_ms
    from repro_torch.kernels import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "mma_peak.cu"
    lib = build.BUILD_DIR / "mma_peak.so"
    src.write_text(MMA_PEAK_CU)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                    str(build.SRC_DIR), "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).mma_peak_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 8 * 256, device="cuda")
    iters = 4096
    for per_sm in (2, 4, 8):
        blocks = sms * per_sm
        ms = event_ms(lambda: fn(out.data_ptr(), blocks, iters), 3,
                      torch.device("cuda"))
        flop = blocks * 8 * iters * 16 * 2 * 16 * 8 * 8
        print(f"mma.sync m16n8k8 TF32: {blocks} blocks, {ms!r} ms, "
              f"{flop / ms / 1e9!r} TFLOP/s", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    from repro_torch.kernels import build

    print(sys.version, torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    t0 = time.perf_counter()
    build.build(["flash_attention", "splade_head"])
    print("build s", time.perf_counter() - t0)
    for name, op in (("flash_attention", "HGMMA"), ("splade_head", "HMMA")):
        print(build.compiler_log.get(name, ""))
        print(name, op, "instructions:", build.sass_count(name, op))
    failures: list = []
    with torch.inference_mode():
        for check in (check_flash, check_head):
            try:
                check(failures)
            except Exception:
                traceback.print_exc()
                failures.append(check.__name__)
        if "--time" in sys.argv and not failures:
            time_kernels()
    if "--mma-peak" in sys.argv:
        mma_peak()
    print("failures:", failures)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
