"""Plain PyTorch version of the fused SPLADE-max encoding head."""
from __future__ import annotations

import torch


def splade_head_ref(
    h: torch.Tensor,  # f32 [B, T, d] token hidden states
    mask: torch.Tensor,  # f32 [B, T], a multiplier (1 = valid token)
    w: torch.Tensor,  # f32 [d, V] MLM head
    b: torch.Tensor,  # f32 [V] bias
) -> torch.Tensor:
    """out[b, v] = max_t mask[b, t] * log1p(relu(h[b, t] @ w[:, v] + b[v])),
    materialising the [B, T, V] logits (``repro.kernels.splade_head.ref``):
    f32 [B, V]."""
    logits = torch.einsum("btd,dv->btv", h, w) + b
    acts = torch.log1p(torch.clamp_min(logits, 0.0)) * mask[..., None]
    return acts.amax(dim=1)
