"""SPLADE encoder (paper Eq. 1): tokens -> bidirectional transformer -> MLM
head -> max-pooled log1p(ReLU(.)) over tokens, and its in-batch contrastive
loss with the FLOPS regulariser (``repro.models.splade``).

``encode(tokens, mask, use_kernel=True)`` pools through the fused CUDA head
(:mod:`repro_torch.kernels.splade_head`); ``use_kernel=False`` (the
default, as in JAX) materialises the [B, T, V] logits.  As in the JAX
encoder, attention ignores the token mask (padding tokens attend and are
attended to); the mask enters only in the head, as an f32 multiplier.
Everything runs in f32: the JAX ``encode`` never casts to its config's
compute ``dtype``, and neither does the port's.  ``contrastive_loss``
encodes with ``use_kernel=False``, as in JAX: the kernel has no backward.

Parameters are the LM backbone's (:class:`repro_torch.models.transformer.
Backbone`, the JAX pytree's names) plus ``mlm_bias``;
:func:`params_from_jax` turns a JAX params pytree (as numpy arrays) into
this module's ``state_dict``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import TransformerConfig
from repro_torch.kernels.splade_head import splade_head, splade_head_ref
from repro_torch.models import layers as L
from repro_torch.models.transformer import Backbone, params_from_jax

__all__ = ["SpladeEncoder", "params_from_jax"]


class SpladeEncoder(Backbone):
    """The encoder of ``cfg`` on ``device`` (default ``"cuda"``: raises
    without a card), initialised from ``generator`` with the JAX init's
    laws (other numbers: carry JAX weights with :func:`params_from_jax`):
    the backbone's parameters, then the head's bias.  A config with
    ``moe`` set raises ``NotImplementedError``."""

    def __init__(self, cfg: TransformerConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        if cfg.moe is not None:
            raise NotImplementedError(
                f"{cfg.name}: the SPLADE encoder has no expert layers (the "
                f"JAX encode reads each block's mlp)")
        super().__init__(cfg, device, generator)
        self.mlm_bias = nn.Parameter(torch.zeros(
            cfg.vocab_size, dtype=torch.float32, device=self.embed.device))

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """[B, T] token ids -> [B, T, d] final-norm hidden states.  Raises
        ``ValueError`` on an id outside [0, V) (``jnp.take`` would fill)."""
        cfg = self.cfg
        x = self.embed_tokens(tokens)
        b, t, _ = x.shape
        positions = torch.arange(t, device=x.device)
        for blk in self.blocks:
            h = L.rms_norm(x, blk.ln_attn, cfg.norm_eps)
            q, k, v = L.qkv(blk.attn, h, cfg, positions)
            o = L.chunked_attention(q, k, v, positions, positions,
                                    causal=False)
            x = x + o.reshape(b, t, -1).to(x.dtype) @ blk.attn["wo"]
            pre = L.rms_norm(x, blk.ln_mlp, cfg.norm_eps)
            x = x + L.mlp_block(blk.mlp, pre, cfg)
        return L.rms_norm(x, self.ln_f, cfg.norm_eps)

    def encode(self, tokens: torch.Tensor, mask: torch.Tensor,
               use_kernel: bool = False) -> torch.Tensor:
        """[B, T] tokens (+ [B, T] mask) -> [B, V] non-negative weights."""
        h = self.hidden(tokens)
        mask = mask.to(device=h.device, dtype=torch.float32)
        w = self.head_weight()
        head = splade_head if use_kernel else splade_head_ref
        return head(h, mask, w, self.mlm_bias)

    def contrastive_loss(self, batch: dict, flops_weight: float = 1e-3):
        """In-batch softmax over query-doc inner products (positives on the
        diagonal) + ``flops_weight`` x the FLOPS regulariser (the squared
        mean activation of each term, summed, for queries and docs) ->
        (loss, ``{"ce", "flops", "q_nnz"}``)."""
        q = self.encode(batch["q_tokens"], batch["q_mask"])
        d = self.encode(batch["d_tokens"], batch["d_mask"])
        logp = torch.log_softmax(q @ d.T, dim=-1)  # [B, B]
        ce = -torch.mean(torch.diagonal(logp))
        flops = torch.sum(torch.mean(q, dim=0) ** 2) + torch.sum(
            torch.mean(d, dim=0) ** 2)
        loss = ce + flops_weight * flops
        return loss, {"ce": ce.detach(), "flops": flops.detach(),
                      "q_nnz": (q > 0).sum(dim=-1).float().mean()}
