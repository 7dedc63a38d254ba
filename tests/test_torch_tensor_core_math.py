"""The precision decisions of the tensor-core kernels, emulated on the CPU.

The CUDA kernels run only on the card; what their arithmetic does to the
result is held here in plain torch, with numpy-seeded inputs:

(a) ``flash_attention``'s bf16 route keeps p in f32 and multiplies it by v
    as two bf16 terms, p_hi = bf16(p) and p_lo = bf16(p - p_hi), summed
    into an f32 accumulator, over kv tiles of 128 (Dh 64) or 64 (Dh 128)
    keys with an exp2 of pre-scaled logits.  Against the f32-p
    ``flash_attention_ref`` at qwen2-0.5b's heads it stays within
    FLASH_TOL (2e-5) plus one bf16 ulp of the output, the bar the card's
    checks hold the kernel to.
(b) ``splade_head`` multiplies in 3xTF32: each f32 operand split into
    tf32(x) and tf32(x - tf32(x)) (TF32: round to nearest, ties away, to 10
    mantissa bits), three products summed in f32.  At d = 768 it stays
    within KERNEL_TOL (1e-5 of max |plain|) of ``splade_head_ref``; one
    TF32 pass does not.
(c) ``splade_head`` runs the product over the rows with mask != 0 only and
    starts the column max at 0 where a row was dropped: the result equals
    ``splade_head_ref`` bit for bit.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.splade_head.ref import splade_head_ref

FLASH_TOL = 2e-5
KERNEL_TOL = 1e-5


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def wgmma_attention(q, k, v, causal, window):
    """The bf16 route's arithmetic: [B, S, Hq, Dh] bf16."""
    b, sq, hq, dh = q.shape
    skv, g = k.shape[1], hq // k.shape[2]
    block = 128 if dh == 64 else 64
    c = math.log2(math.e) / math.sqrt(dh)
    qf = q.float().transpose(1, 2)  # [B, Hq, Sq, Dh]
    kf = k.float().repeat_interleave(g, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(g, dim=2).transpose(1, 2)
    m = torch.full((b, hq, sq), -math.inf)
    l = torch.zeros((b, hq, sq))
    o = torch.zeros((b, hq, sq, dh))
    qp = torch.arange(sq)[:, None]
    for k0 in range(0, skv, block):
        k1 = min(k0 + block, skv)
        kp = torch.arange(k0, k1)[None, :]
        s = qf @ kf[:, :, k0:k1].transpose(-1, -2)  # exact products, f32 sum
        vis = torch.ones((sq, k1 - k0), dtype=torch.bool)
        if causal:
            vis &= qp >= kp
        if window is not None:
            vis &= qp - kp < window
        s = torch.where(vis, s, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(m_new == -math.inf, 0.0, m_new)
        corr = torch.where(m == -math.inf, 0.0, torch.exp2((m - m_safe) * c))
        p = torch.exp2(s * c - (m_safe * c)[..., None])
        l = l * corr + p.sum(-1)
        hi = _bf16(p)
        lo = _bf16(p - hi)
        o = o * corr[..., None] + hi @ vf[:, :, k0:k1] + lo @ vf[:, :, k0:k1]
        m = m_new
    out = o / torch.clamp_min(l, 1e-20)[..., None]
    return out.transpose(1, 2).bfloat16()


def _within_flash_bar(got, want):
    """FLASH_TOL (atol and rtol) plus one bf16 ulp of max(|got|, |want|)."""
    g, w = got.double(), want.double()
    big = torch.maximum(g.abs(), w.abs())
    bar = FLASH_TOL * (1 + w.abs()) + torch.ldexp(
        torch.ones_like(big), torch.frexp(big).exponent - 8)
    return float(((g - w).abs() / bar).max())


@pytest.mark.parametrize("b,s,hq,hkv,dh,causal,window", [
    (1, 256, 14, 2, 64, True, None),  # qwen2-0.5b's heads
    (2, 250, 14, 2, 64, True, None),  # a ragged last kv tile
    (1, 200, 14, 2, 64, True, 60),  # a window
    (1, 130, 4, 1, 64, False, None),  # MQA, not causal
    (1, 150, 8, 2, 128, True, None),  # Dh 128: kv tiles of 64
])
def test_split_p_times_bf16_v_holds_the_flash_bar(b, s, hq, hkv, dh, causal,
                                                  window):
    rng = np.random.default_rng(s + hq + dh)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (b, s, h, dh), dtype=np.float32)).bfloat16() for h in (hq, hkv, hkv))
    got = wgmma_attention(q, k, v, causal, window)
    want = flash_attention_ref(q, k, v, causal, window)
    assert got.dtype == want.dtype == torch.bfloat16
    assert _within_flash_bar(got, want) <= 1.0


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties away from 0,
    on the int32 view (cvt.rna.tf32.f32)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _head_inputs(bsz, t, d, v, seed):
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal((bsz, t, d), dtype=np.float32))
    w = torch.from_numpy(
        (0.05 * rng.standard_normal((v, d))).astype(np.float32)).T
    b = torch.from_numpy((0.1 * rng.standard_normal(v)).astype(np.float32))
    mask = (rng.random((bsz, t)) > 0.3).astype(np.float32)
    mask[:, 1::3] *= 0.5
    mask[-1] = 0.0
    return h, torch.from_numpy(mask), w, b


def _head_with(product, h, mask, w, b):
    logits = product(h.reshape(-1, h.shape[-1]), w).reshape(
        *h.shape[:2], -1) + b
    return (torch.log1p(torch.clamp_min(logits, 0.0))
            * mask[..., None]).amax(dim=1)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 3.0e-3])
    got = tf32(x)
    assert got[0] == 1.0 and got[1] == 1.0 + 2.0 ** -10  # ties away
    assert got[2] == 1.0 + 2.0 ** -9 and got[3] == -(1.0 + 2.0 ** -10)
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    assert abs(float(got[4]) / 3.0e-3 - 1) <= 2.0 ** -11


def test_3xtf32_product_holds_the_kernel_bar():
    h, mask, w, b = _head_inputs(4, 64, 768, 2000, seed=0)
    want = splade_head_ref(h, mask, w, b)
    scale = float(want.abs().max())
    got = _head_with(matmul_3xtf32, h, mask, w, b)
    assert float((got - want).abs().max()) <= KERNEL_TOL * scale
    one_pass = _head_with(lambda x, y: tf32(x) @ tf32(y), h, mask, w, b)
    assert float((one_pass - want).abs().max()) > KERNEL_TOL * scale


@pytest.mark.parametrize("bsz,t", [(3, 37), (4, 130)])
def test_masked_rows_skipped_equal_the_plain_head(bsz, t):
    """Only the rows with mask != 0 go through the product; the max starts
    at 0 where the input dropped a row, at -inf where it dropped none."""
    h, mask, w, b = _head_inputs(bsz, t, 64, 300, seed=t)
    mask[0] = 1.0  # an input with every token valid
    mask[1, 5] = 0.25  # a fractional mask
    logits = torch.einsum("btd,dv->btv", h, w) + b  # as the plain version
    got = torch.empty(bsz, w.shape[1])
    for i in range(bsz):
        keep = torch.nonzero(mask[i] != 0).flatten()
        start = 0.0 if len(keep) < t else -math.inf
        acts = torch.log1p(torch.clamp_min(logits[i, keep], 0.0)) \
            * mask[i, keep][:, None]
        got[i] = torch.cat([torch.full((1, w.shape[1]), start), acts]).amax(0)
    assert torch.equal(got, splade_head_ref(h, mask, w, b))
    assert not got[-1].any()  # the all-zero mask row
