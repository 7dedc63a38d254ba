"""Transformer building blocks of the SPLADE encoder and the LM, as plain
functions on tensors (``repro.models.layers``).

Weights keep the JAX layout, ``[in, out]`` (``x @ w``), and live in
dict-like containers with the JAX names, so the two packages compute the
same thing from the same numbers.  Norms, RoPE, softmax and accumulation
run in f32; everything else in the activations' dtype.  The plain
attention is PyTorch (``einsum`` and a masked online softmax, as the JAX
chunk loop); the LM's prefill attention can instead go through the CUDA
``flash_attention`` kernel (:func:`attention_block`), which computes the
same function.  Single-token decode against a KV cache stays plain PyTorch,
as it has no Pallas kernel in the JAX package either.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import TransformerConfig
from repro_torch.kernels.flash_attention import flash_attention

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32, scale: Optional[float] = None,
               device=None) -> torch.Tensor:
    """N(0, scale^2) [in_dim, out_dim] from ``gen`` (scale 1/sqrt(in_dim)
    by default), drawn on the generator's device and moved to ``device``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=gen, device=gen.device)
    return (w * scale).to(device=device, dtype=dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    orig = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(orig)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Half-split RoPE.  x: [..., S, H, Dh]; positions: [..., S] (int)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)  # [Dh/2]
    angles = positions[..., None].float() * freqs  # [..., S, Dh/2]
    cos = torch.cos(angles)[..., None, :]  # [..., S, 1, Dh/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_attention(gen: torch.Generator, cfg: TransformerConfig, dtype,
                   device=None) -> dict:
    d, dh = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": dense_init(gen, d, hq * dh, dtype, device=device),
        "wk": dense_init(gen, d, hkv * dh, dtype, device=device),
        "wv": dense_init(gen, d, hkv * dh, dtype, device=device),
        "wo": dense_init(gen, hq * dh, d, dtype, device=device),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            p[name] = torch.zeros(n * dh, dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(dh, dtype=dtype, device=device)
        p["k_norm"] = torch.ones(dh, dtype=dtype, device=device)
    return p


def qkv(params, x: torch.Tensor, cfg: TransformerConfig,
        positions: torch.Tensor):
    """Projections, optional bias and qk-norm, then RoPE:
    [B, S, H, Dh] each (``repro.models.layers._qkv``)."""
    b, s, _ = x.shape
    dh, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(b, s, hq, dh)
    k = k.reshape(b, s, hkv, dh)
    v = v.reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _fit_chunk(chunk: int, n: int) -> int:
    chunk = min(chunk, n)
    while n % chunk:
        chunk //= 2
    return chunk


def chunked_attention(
    q: torch.Tensor,  # [B, Sq, Hq, Dh]
    k: torch.Tensor,  # [B, Skv, Hkv, Dh]
    v: torch.Tensor,  # [B, Skv, Hkv, Dh]
    q_positions: torch.Tensor,  # [Sq] global positions of queries
    kv_positions: torch.Tensor,  # [Skv]
    window: Optional[int] = None,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    causal: bool = True,
) -> torch.Tensor:
    """Online-softmax attention over (query chunk, kv chunk) tiles, as the
    JAX loop: running (max, sum, acc) in f32, a guard for fully-masked
    rows, ``l`` clamped at 1e-20.  GQA (Hq = G * Hkv), causal masking and
    sliding windows.  Returns f32 [B, Sq, Hq, Dh]."""
    b, sq, hq, dh = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = 1.0 / math.sqrt(dh)
    q_chunk = _fit_chunk(q_chunk, sq)
    kv_chunk = _fit_chunk(kv_chunk, skv)
    nq, nkv = sq // q_chunk, skv // kv_chunk

    q = q.reshape(b, nq, q_chunk, hkv, g, dh)
    k = k.reshape(b, nkv, kv_chunk, hkv, dh)
    v = v.reshape(b, nkv, kv_chunk, hkv, dh)
    qpos = q_positions.reshape(nq, q_chunk)
    kpos = kv_positions.reshape(nkv, kv_chunk)
    inf = float("inf")
    outs = []
    for qi in range(nq):
        qc = q[:, qi].float()  # [B, qc, Hkv, G, Dh]
        qp = qpos[qi]
        m = torch.full((b, hkv, g, q_chunk), -inf, device=q.device)
        l = torch.zeros((b, hkv, g, q_chunk), device=q.device)
        acc = torch.zeros((b, hkv, g, q_chunk, dh), device=q.device)
        for ki in range(nkv):
            kc, vc, kp = k[:, ki].float(), v[:, ki].float(), kpos[ki]
            logits = torch.einsum("bqhgd,bkhd->bhgqk", qc, kc) * scale
            mask = None  # every (query, key) pair is visible
            if causal:
                mask = qp[:, None] >= kp[None, :]
            if window is not None:
                near = qp[:, None] - kp[None, :] < window
                mask = near if mask is None else mask & near
            if mask is not None:
                logits = torch.where(mask, logits, -inf)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(logits - m_safe[..., None])
            if mask is not None:
                p = torch.where(mask, p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vc)
            m = m_new
        out = acc / torch.clamp_min(l, 1e-20)[..., None]
        # [B, Hkv, G, qc, Dh] -> [B, qc, Hkv*G, Dh]
        outs.append(out.movedim(3, 1).reshape(b, q_chunk, hq, dh))
    return torch.cat(outs, dim=1)


def attention_block(
    params,
    x: torch.Tensor,  # [B, S, D]
    cfg: TransformerConfig,
    positions: torch.Tensor,  # [S]
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    use_kernel: bool = False,
):
    """Causal self-attention over a full sequence (prefill), with
    ``cfg.sliding_window``: ``(out @ wo, (k, v))``.  ``use_kernel`` runs
    :func:`flash_attention` (the CUDA kernel on a CUDA tensor), which counts
    positions from 0, as the backbone's ``positions = arange(S)`` do;
    otherwise :func:`chunked_attention` with the given chunks."""
    b, s, _ = x.shape
    q, k, v = qkv(params, x, cfg, positions)
    if use_kernel:
        out = flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    else:
        out = chunked_attention(q, k, v, positions, positions,
                                window=cfg.sliding_window, q_chunk=q_chunk,
                                kv_chunk=kv_chunk)
    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim).to(x.dtype)
    return out @ params["wo"], (k, v)


def decode_attention(
    params,
    x: torch.Tensor,  # [B, 1, D]
    cfg: TransformerConfig,
    cache_k: torch.Tensor,  # [B, S_cache, Hkv, Dh]
    cache_v: torch.Tensor,
    position: int,  # absolute position of the token
    cache_positions: torch.Tensor,  # int32 [S_cache], 2**31 - 1 = empty
):
    """Single-token decode against a KV cache, a ring buffer when S_cache is
    shorter than the context: the token's k, v and position go to slot
    ``position % S_cache``, then an f32 softmax over the slots holding a
    position <= ``position`` (and within the window).  The cache tensors
    are updated in place (the JAX function returns new arrays: in place
    saves a copy of the cache a step) and returned as JAX returns them."""
    b = x.shape[0]
    dh, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    g = hq // hkv
    q, k_new, v_new = qkv(params, x, cfg,
                          torch.tensor([position], device=x.device))
    slot = position % cache_k.shape[1]
    cache_k[:, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v_new[:, 0].to(cache_v.dtype)
    cache_positions[slot] = position

    qh = q.reshape(b, hkv, g, dh).float()
    logits = torch.einsum("bhgd,bshd->bhgs", qh,
                          cache_k.float()) / math.sqrt(dh)
    valid = cache_positions <= position
    if cfg.sliding_window is not None:
        valid &= position - cache_positions < cfg.sliding_window
    logits = torch.where(valid, logits, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, cache_v.float())
    out = out.reshape(b, 1, hq * dh).to(x.dtype)
    return out @ params["wo"], (cache_k, cache_v, cache_positions)


def init_mlp(gen: torch.Generator, cfg: TransformerConfig, dtype,
             device=None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "w_gate": dense_init(gen, d, f, dtype, device=device),
            "w_up": dense_init(gen, d, f, dtype, device=device),
            "w_down": dense_init(gen, f, d, dtype, device=device),
        }
    return {
        "w_up": dense_init(gen, d, f, dtype, device=device),
        "w_down": dense_init(gen, f, d, dtype, device=device),
    }


def mlp_block(params, x: torch.Tensor, cfg: TransformerConfig):
    if cfg.act == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:  # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    return h @ params["w_down"]
