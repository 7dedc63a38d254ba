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

The mixture-of-experts layer (:func:`moe_block`) routes each token to its
top-k experts (:func:`route`) and runs them through one of two dispatches:
:func:`moe_einsum`, GShard's, with a capacity per dispatch group and the
tokens past it dropped, and :func:`moe_ragged`, dropless.  Its expert
products are ``torch.bmm``/``matmul`` (``jnp.einsum`` and
``lax.ragged_dot`` in JAX, outside any Pallas kernel).

Tensor and expert parallelism (:class:`TensorParallel`, given by the
sharded LM; ``None`` computes everything here): a rank computes on its
own shards, and each layer whose output is a partial sum over the model
axis closes with one f32 SUM all-reduce (``sharding.ctx``).  Attention
runs on the rank's ``n_heads / tp`` query and ``n_kv_heads / tp`` kv
heads (the head counts are read from the projections' widths) and the
row-parallel ``wo``; where the heads do not divide the axis the rank
computes every head from gathered weights and multiplies its own
columns of the output by its rows of ``wo``.  The MLP's ``w_gate``/
``w_up`` are column-parallel and ``w_down`` row-parallel; the experts
are split on F (TP inside each expert) or on E (expert parallelism).
Decode reads a KV cache split by heads or by sequence
(:func:`decode_attention`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig, TransformerConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.sharding import ctx


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A rank's share of an LM's layers on the model axis.

    ``heads``: the q and kv heads are split over the ranks (the kv heads
    divide the axis); ``wo_rows``: ``wo`` holds this rank's rows of
    ``H Dh``, so the attention's output is a partial sum; ``ffn``: the
    MLP's or the experts' output is a partial sum (F split, or the experts
    split under expert parallelism)."""

    index: int
    heads: bool
    wo_rows: bool
    ffn: bool


def psum(y: torch.Tensor) -> torch.Tensor:
    """The SUM of the ranks' partial ``y`` over the model axis, in f32."""
    return ctx.all_reduce_sum(y.float()).to(y.dtype)


def out_proj(out: torch.Tensor, wo: torch.Tensor,
             tp: Optional[TensorParallel]) -> torch.Tensor:
    """``out @ wo`` on this rank: with ``wo``'s rows split, the rank's
    columns of ``out`` (all of a head-parallel ``out``) times its rows,
    summed over the ranks."""
    if tp is None or not tp.wo_rows:
        return out @ wo
    if out.shape[-1] != wo.shape[0]:  # every head computed here
        out = out.narrow(-1, tp.index * wo.shape[0], wo.shape[0])
    return psum(out @ wo)


def _is_meta(device) -> bool:
    return device is not None and torch.device(device).type == "meta"


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32, scale: Optional[float] = None,
               device=None) -> torch.Tensor:
    """N(0, scale^2) [in_dim, out_dim] from ``gen`` (scale 1/sqrt(in_dim)
    by default), drawn on the generator's device and moved to ``device``;
    on ``meta`` an empty tensor of that shape (nothing drawn anywhere)."""
    if _is_meta(device):
        return torch.empty((in_dim, out_dim), dtype=dtype, device="meta")
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
    [B, S, H, Dh] each (``repro.models.layers._qkv``); H is the heads
    the projections hold (a rank's share under tensor parallelism)."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    hq, hkv = params["wq"].shape[-1] // dh, params["wk"].shape[-1] // dh
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
    tp: Optional[TensorParallel] = None,
):
    """Causal self-attention over a full sequence (prefill), with
    ``cfg.sliding_window``: ``(out @ wo, (k, v))``.  ``use_kernel`` runs
    :func:`flash_attention` (the CUDA kernel on a CUDA tensor), which counts
    positions from 0, as the backbone's ``positions = arange(S)`` do;
    otherwise :func:`chunked_attention` with the given chunks.  Under
    ``tp`` on the rank's heads, the output summed over the ranks."""
    b, s, _ = x.shape
    q, k, v = qkv(params, x, cfg, positions)
    if use_kernel:
        out = flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    else:
        out = chunked_attention(q, k, v, positions, positions,
                                window=cfg.sliding_window, q_chunk=q_chunk,
                                kv_chunk=kv_chunk)
    out = out.reshape(b, s, q.shape[2] * cfg.head_dim).to(x.dtype)
    return out_proj(out, params["wo"], tp), (k, v)


def decode_attention(
    params,
    x: torch.Tensor,  # [B, 1, D]
    cfg: TransformerConfig,
    cache_k: torch.Tensor,  # [B, S_cache, Hkv, Dh]
    cache_v: torch.Tensor,
    position: int,  # absolute position of the token
    cache_positions: torch.Tensor,  # int32 [S_cache], 2**31 - 1 = empty
    tp: Optional[TensorParallel] = None,
    seq=None,  # the mesh axes that split the cache's slots, if any
):
    """Single-token decode against a KV cache, a ring buffer when S_cache is
    shorter than the context: the token's k, v and position go to slot
    ``position % S_cache``, then an f32 softmax over the slots holding a
    position <= ``position`` (and within the window).  The cache tensors
    are updated in place (the JAX function returns new arrays: in place
    saves a copy of the cache a step) and returned as JAX returns them.

    Sharded (``lm_cache_specs``): a cache split by heads holds the rank's
    kv heads, and the attention is local.  A cache whose slots are split
    over the ranks of ``seq`` holds slots ``[j S/n, (j+1) S/n)`` on the
    j-th of n ranks (``cache_positions`` is whole on every rank): the
    rank owning the token's slot writes its k and v, each rank attends
    over its own slots, and a MAX all-reduce of the row maxima, then one
    SUM all-reduce of the rescaled numerators and denominators combine
    the ranks (a rank with no visible slot adds exp(-inf) = 0)."""
    b = x.shape[0]
    dh = cfg.head_dim
    q, k_new, v_new = qkv(params, x, cfg,
                          torch.tensor([position], device=x.device))
    hq, hkv = q.shape[2], k_new.shape[2]
    g = hq // hkv
    n, j = ctx.group_size(seq or ()), ctx.group_index(seq or ())
    s_loc = cache_k.shape[1]
    slot = position % (s_loc * n)
    if slot // s_loc == j:
        cache_k[:, slot - j * s_loc] = k_new[:, 0].to(cache_k.dtype)
        cache_v[:, slot - j * s_loc] = v_new[:, 0].to(cache_v.dtype)
    cache_positions[slot] = position
    positions = cache_positions[j * s_loc:(j + 1) * s_loc]

    qh = q.reshape(b, hkv, g, dh).float()
    logits = torch.einsum("bhgd,bshd->bhgs", qh,
                          cache_k.float()) / math.sqrt(dh)
    valid = positions <= position
    if cfg.sliding_window is not None:
        valid &= position - positions < cfg.sliding_window
    logits = torch.where(valid, logits, float("-inf"))
    if n == 1:
        p = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhgs,bshd->bhgd", p, cache_v.float())
    else:
        m = ctx.all_reduce_max(logits.amax(dim=-1), seq)  # [B, Hkv, G]
        m = torch.where(torch.isfinite(m), m, 0.0)
        p = torch.exp(logits - m[..., None])  # masked slots: exp(-inf) = 0
        num = torch.einsum("bhgs,bshd->bhgd", p, cache_v.float())
        both = ctx.all_reduce_sum(torch.cat([num, p.sum(-1)[..., None]],
                                            dim=-1), seq)
        out = both[..., :dh] / both[..., dh:]
    out = out.reshape(b, 1, hq * dh).to(x.dtype)
    return (out_proj(out, params["wo"], tp),
            (cache_k, cache_v, cache_positions))


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


def mlp_block(params, x: torch.Tensor, cfg: TransformerConfig,
              tp: Optional[TensorParallel] = None):
    """The MLP; under ``tp`` on the rank's F columns, summed over the
    ranks."""
    if cfg.act == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:  # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    y = h @ params["w_down"]
    return psum(y) if tp is not None and tp.ffn else y


# ---------------------------------------------------------------------------
# Mixture of experts


def init_moe(gen: torch.Generator, cfg: TransformerConfig, dtype,
             device=None) -> dict:
    """``router`` [d, E] f32, ``w_gate``/``w_up`` [E, d, F] and ``w_down``
    [E, F, d] in ``dtype``: N(0, 1/d) for the first three, N(0, 1/F) for
    ``w_down``, drawn on the generator's device."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts

    def normal(shape, scale):
        if _is_meta(device):
            return torch.empty(shape, dtype=dtype, device="meta")
        w = torch.randn(shape, generator=gen, device=gen.device).mul_(scale)
        return w.to(device=device, dtype=dtype)

    return {
        "router": dense_init(gen, d, e, torch.float32, device=device),
        "w_gate": normal((e, d, f), 1.0 / math.sqrt(d)),
        "w_up": normal((e, d, f), 1.0 / math.sqrt(d)),
        "w_down": normal((e, f, d), 1.0 / math.sqrt(f)),
    }


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """How often each of 0..n-1 occurs in ``idx`` (int64 [n]).  A
    ``scatter_add_``, where ``bincount`` and ``one_hot`` read the largest
    id back to the host first: no sync, so the host runs ahead."""
    return torch.zeros(n, dtype=torch.long, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))


def route(params, xf: torch.Tensor, moe: MoEConfig):
    """The router over tokens ``xf`` [T, d] -> (gates [T, k] f32, expert ids
    [T, k] int64, aux loss): f32 logits ``xf @ router`` (the router in
    whatever dtype the layer was cast to, promoted to f32, as in JAX), a
    softmax, the top k with ties to the lower expert (a stable descending
    sort: ``lax.top_k``'s order), the gates renormalised to sum 1, and
    Switch's load-balancing loss ``E * sum_e f_e p_e * aux_loss_weight``."""
    e, k = moe.num_experts, moe.top_k
    t = xf.shape[0]
    probs = torch.softmax(xf.float() @ params["router"].float(), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = top.values[:, :k], top.indices[:, :k]
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    me = torch.mean(probs, dim=0)
    ce = _counts(expert_idx.reshape(-1), e).float() / t / k
    aux = e * torch.sum(me * ce) * moe.aux_loss_weight
    return gate_vals, expert_idx, aux


def capacity_positions(expert_idx: torch.Tensor,
                       num_experts: int) -> torch.Tensor:
    """Expert ids [G, g, k] -> each (token, slot)'s position in its
    expert's queue: the number of the group's earlier entries, counted
    token-major and slot-minor, routed to the same expert (the cumsum of
    ``_moe_einsum``'s one-hots, here by a stable sort)."""
    g, tg, k = expert_idx.shape
    dev = expert_idx.device
    groups = torch.arange(g, device=dev)[:, None, None]
    key = (expert_idx + num_experts * groups).reshape(-1)
    order = torch.sort(key, stable=True).indices
    counts = _counts(key, g * num_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(key)
    pos[order] = torch.arange(key.numel(), device=dev) - starts[key[order]]
    return pos.reshape(g, tg, k)


def moe_group_tokens(t: int, moe: MoEConfig) -> int:
    """Tokens a dispatch group of ``t`` tokens: ``group_tokens`` halved
    until it divides ``t`` (1 at worst: an odd ``t``)."""
    g_tok = moe.group_tokens
    while t % g_tok:
        g_tok //= 2
    return g_tok


def moe_capacity(tokens_per_group: int, moe: MoEConfig) -> int:
    """Slots per expert per group: JAX's float expression, truncated."""
    return max(int(tokens_per_group * moe.top_k / moe.num_experts
                   * moe.capacity_factor), 1)


def _local_experts(params, moe: MoEConfig,
                   tp: Optional[TensorParallel]) -> tuple[int, int]:
    """(first, count) of the experts this rank holds: all of them, or its
    share under expert parallelism (``w_gate`` split on E)."""
    e_loc = params["w_gate"].shape[0]
    if e_loc == moe.num_experts:
        return 0, e_loc
    return tp.index * e_loc, e_loc


def moe_einsum(params, xg: torch.Tensor, gate_vals: torch.Tensor,
               expert_idx: torch.Tensor, moe: MoEConfig,
               tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """GShard dispatch over groups: ``xg`` [G, g, d], gates and ids
    [G, g, k] -> [G, g, d] in ``xg``'s dtype.

    Each expert takes at most C = :func:`moe_capacity` (token, slot)
    entries a group, in token-major, slot-minor order; the rest are
    dropped (add nothing).  Where JAX multiplies [G, g, E, C] one-hots,
    the kept entries' rows are gathered into an [E, G C, d] buffer (empty
    slots zero), the experts run as three batched products, and each
    token sums its kept slots' outputs times its gates, the gates rounded
    to the compute dtype first (``gate_vals.astype(dt)`` in JAX).

    Under ``tp`` (the same routing on every rank: tokens and router are
    replicated over the model axis) the rank runs its experts' rows (EP)
    or its F columns of every expert, and the f32 combination is summed
    over the ranks before the cast."""
    g, tg, d = xg.shape
    e = moe.num_experts
    lo, e_loc = _local_experts(params, moe, tp)
    c = moe_capacity(tg, moe)
    dev, dt = xg.device, xg.dtype
    pos = capacity_positions(expert_idx, e)
    kept = pos < c
    n_slots = e * g * c
    groups = torch.arange(g, device=dev)[:, None, None]
    slot = expert_idx * (g * c) + groups * c + pos  # [G, g, k]
    # the token each buffer slot holds (g * tg: none, a zero row); each
    # dropped entry writes a slot of its own past the buffer
    entry = torch.arange(slot.numel(), device=dev).view_as(slot)
    dest = torch.where(kept, slot, n_slots + entry).reshape(-1)
    token = (groups * tg + torch.arange(tg, device=dev)[None, :, None])
    src = torch.full((n_slots + slot.numel(),), g * tg, dtype=torch.long,
                     device=dev)
    src[dest] = token.expand_as(slot).reshape(-1)
    x_pad = torch.cat([xg.reshape(g * tg, d), xg.new_zeros(1, d)])
    mine = src[lo * g * c:(lo + e_loc) * g * c]  # this rank's experts
    expert_in = x_pad[mine].view(e_loc, g * c, d)
    h = F.silu(torch.bmm(expert_in, params["w_gate"])) * torch.bmm(
        expert_in, params["w_up"])
    expert_out = torch.bmm(h, params["w_down"]).view(e_loc * g * c, d)
    if e_loc < e:
        kept = kept & (expert_idx >= lo) & (expert_idx < lo + e_loc)
    y = expert_out[torch.where(kept, slot - lo * g * c, 0)]  # [G, g, k, d]
    gates = torch.where(kept, gate_vals.to(dt), 0).float()
    out = torch.sum(y.float() * gates[..., None], dim=2)
    if tp is not None and tp.ffn:
        out = ctx.all_reduce_sum(out)
    return out.to(dt)


def moe_ragged(params, xf: torch.Tensor, gate_vals: torch.Tensor,
               expert_idx: torch.Tensor, moe: MoEConfig,
               tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """Dropless dispatch: tokens [T, d], gates and ids [T, k] -> [T, d].
    The (token, slot) entries sorted by expert (stable), each expert's
    contiguous rows through its three products (``lax.ragged_dot``; one
    host sync reads the group sizes), the outputs times the gates in the
    outputs' dtype, then each token's k rows summed.  Under ``tp`` the
    rank's experts (their rows of other experts are 0) or F columns, the
    sum then summed over the ranks in f32."""
    t, d = xf.shape
    k = expert_idx.shape[-1]
    lo, e_loc = _local_experts(params, moe, tp)
    flat = expert_idx.reshape(-1)
    sort_idx = torch.sort(flat, stable=True).indices
    xs = xf[sort_idx // k]  # [T k, d] permuted copies
    sizes = torch.bincount(flat, minlength=moe.num_experts).tolist()
    start = sum(sizes[:lo])
    outs = [xs.new_zeros(start, d)]
    for i, n in enumerate(sizes[lo:lo + e_loc]):
        rows = xs[start:start + n]
        h = F.silu(rows @ params["w_gate"][i]) * (rows @ params["w_up"][i])
        outs.append(h @ params["w_down"][i])
        start += n
    outs.append(xs.new_zeros(t * k - start, d))
    ys = torch.cat(outs)
    ys = ys * gate_vals.reshape(-1)[sort_idx][:, None].to(ys.dtype)
    by_entry = torch.empty_like(ys)
    by_entry[sort_idx] = ys
    out = torch.sum(by_entry.view(t, k, d), dim=1)
    return psum(out) if tp is not None and tp.ffn else out


# dispatch volume (T x g x k x capacity factor) above which the einsum
# dispatch runs the sequence in super-chunks of g tokens, one at a time
MOE_SUPER_CHUNK_ELEMS = 4e9


def moe_block(params, x: torch.Tensor, cfg: TransformerConfig,
              tp: Optional[TensorParallel] = None,
              routes: Optional[list] = None, data: int = 1):
    """Top-k mixture of experts over ``x`` [B, S, d] -> (out [B, S, d] in
    x's dtype, aux loss).  The einsum dispatch regroups the B S tokens into
    groups of :func:`moe_group_tokens`; above
    ``MOE_SUPER_CHUNK_ELEMS`` (and when S splits into such groups) it runs
    each super-chunk of g tokens of every row in turn, the same groups, so
    the same result, with one chunk's buffers live.  A ``routes`` list
    gets the layer's expert ids [B S, k] and which (token, slot) entries
    its capacity kept ([B S, k] bool; all of them for ``"ragged"``).

    ``x`` may be this rank's rows of a batch split over ``data`` ranks
    (the data axis): the dispatch groups are the whole batch's, as JAX
    forms them; where one spans the ranks, every rank runs the layer on
    the whole batch (gathered over the data axis) and keeps its rows."""
    moe = cfg.moe
    b, s, d = x.shape
    if data > 1 and moe.dispatch != "ragged" and (
            b * s) % moe_group_tokens(b * s * data, moe):
        out, aux = moe_block(params, ctx.gather(x, 0, "data"), cfg, tp,
                             routes)
        i = ctx.group_index("data")
        return out[i * b:(i + 1) * b], aux
    xf = x.reshape(b * s, d)
    gate_vals, expert_idx, aux = route(params, xf, moe)
    if moe.dispatch == "ragged":
        if routes is not None:
            routes.append((expert_idx, torch.ones_like(expert_idx,
                                                       dtype=torch.bool)))
        out = moe_ragged(params, xf, gate_vals, expert_idx, moe, tp)
        return out.reshape(b, s, d).to(x.dtype), aux
    t, k = b * s, gate_vals.shape[-1]
    g_tok = moe_group_tokens(t * data, moe)
    dispatch_elems = t * g_tok * moe.top_k * moe.capacity_factor
    if (dispatch_elems > MOE_SUPER_CHUNK_ELEMS and s > g_tok
            and s % g_tok == 0):
        gv = gate_vals.reshape(b, s, k)
        ei = expert_idx.reshape(b, s, k)
        chunks = range(0, s, g_tok)
        out = torch.cat([
            moe_einsum(params, x[:, j:j + g_tok], gv[:, j:j + g_tok],
                       ei[:, j:j + g_tok], moe, tp) for j in chunks], dim=1)
        groups = [ei[:, j:j + g_tok] for j in chunks]
    else:
        n = t // g_tok
        out = moe_einsum(params, xf.reshape(n, g_tok, d),
                         gate_vals.reshape(n, g_tok, k),
                         expert_idx.reshape(n, g_tok, k), moe, tp)
        groups = [expert_idx.reshape(n, g_tok, k)]
    if routes is not None:
        kept = torch.cat([capacity_positions(ei, moe.num_experts)
                          < moe_capacity(g_tok, moe) for ei in groups],
                         dim=1)
        routes.append((expert_idx, kept.reshape(t, k)))
    return out.reshape(b, s, d).to(x.dtype), aux
