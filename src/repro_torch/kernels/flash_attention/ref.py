"""Plain PyTorch version of the flash-attention forward."""
from __future__ import annotations

import math
from typing import Optional

import torch


def flash_attention_ref(
    q: torch.Tensor,  # [B, Sq, Hq, Dh]
    k: torch.Tensor,  # [B, Skv, Hkv, Dh]
    v: torch.Tensor,  # [B, Skv, Hkv, Dh]
    causal: bool = True,
    window: Optional[int] = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh)) v under the mask ``q_pos >= k_pos`` (when
    ``causal``) and ``q_pos - k_pos < window``, positions counted from 0 in
    both, query head ``h`` reading kv head ``h // (Hq // Hkv)``: [B, Sq, Hq,
    Dh] in q's dtype (``repro.kernels.flash_attention.ref``).

    An online softmax over (q chunk, kv chunk) tiles in f32 (inputs widened
    on load), as the kernel: a fully masked row gives 0, ``l`` is clamped at
    1e-20.  It never holds more than one [B, Hq, q_chunk, kv_chunk] tile of
    logits, and skips the kv chunks that the causal mask or the window hide
    from a whole query chunk (which changes nothing: they add exact zeros).
    Any S: the last chunks are ragged."""
    b, sq, hq, dh = q.shape
    _, skv, hkv, _ = k.shape
    if hq % hkv or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    g = hq // hkv
    scale = 1.0 / math.sqrt(dh)
    dev = q.device
    out = torch.empty((b, sq, hq, dh), dtype=q.dtype, device=dev)
    inf = float("inf")
    for q0 in range(0, sq, q_chunk):
        q1 = min(q0 + q_chunk, sq)
        n = q1 - q0
        qc = q[:, q0:q1].float().reshape(b, n, hkv, g, dh)
        qp = torch.arange(q0, q1, device=dev)
        lo = 0 if window is None else max(0, q0 - window + 1)
        hi = min(skv, q1) if causal else skv
        m = torch.full((b, hkv, g, n), -inf, device=dev)
        l = torch.zeros((b, hkv, g, n), device=dev)
        acc = torch.zeros((b, hkv, g, n, dh), device=dev)
        for k0 in range(lo, hi, kv_chunk):
            k1 = min(k0 + kv_chunk, hi)
            kc, vc = k[:, k0:k1].float(), v[:, k0:k1].float()
            kp = torch.arange(k0, k1, device=dev)
            logits = torch.einsum("bqhgd,bkhd->bhgqk", qc, kc) * scale
            mask = torch.ones((n, k1 - k0), dtype=torch.bool, device=dev)
            if causal:
                mask &= qp[:, None] >= kp[None, :]
            if window is not None:
                mask &= qp[:, None] - kp[None, :] < window
            logits = torch.where(mask, logits, -inf)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.where(mask, torch.exp(logits - m_safe[..., None]), 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vc)
            m = m_new
        o = acc / torch.clamp_min(l, 1e-20)[..., None]
        # [B, Hkv, G, n, Dh] -> [B, n, Hq, Dh]
        out[:, q0:q1] = o.movedim(3, 1).reshape(b, n, hq, dh).to(q.dtype)
    return out
