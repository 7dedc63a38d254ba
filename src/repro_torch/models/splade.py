"""SPLADE encoder (paper Eq. 1), serving direction: tokens -> bidirectional
transformer -> MLM head -> max-pooled log1p(ReLU(.)) over tokens
(``repro.models.splade``).

``encode(tokens, mask, use_kernel=True)`` pools through the fused CUDA head
(:mod:`repro_torch.kernels.splade_head`); ``use_kernel=False`` (the
default, as in JAX) materialises the [B, T, V] logits.  As in the JAX
encoder, attention ignores the token mask (padding tokens attend and are
attended to); the mask enters only in the head, as an f32 multiplier.
Everything runs in f32: the JAX ``encode`` never casts to its config's
compute ``dtype`` either, and the port's config has no such field.

Parameters carry the JAX pytree's names, one block per layer where JAX
stacks them for ``scan``: ``embed`` [V, d], ``blocks.<i>.attn.{wq,wk,wv,
wo}``, ``blocks.<i>.ln_attn``, ``blocks.<i>.ln_mlp``, ``blocks.<i>.mlp.
{w_up,w_down}`` (``w_gate`` too for swiglu), ``ln_f``, ``mlm_bias`` and
``lm_head`` when the head is untied.  :func:`params_from_jax` turns a JAX
params pytree (as numpy arrays) into this module's ``state_dict``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import TransformerConfig
from repro_torch.kernels.splade_head import splade_head, splade_head_ref
from repro_torch.models import layers as L
from repro_torch.utils import resolve_device


def _params(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tensors.items()})


class _Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, gen: torch.Generator, dtype,
                 device):
        super().__init__()
        self.attn = _params(L.init_attention(gen, cfg, dtype, device))
        self.ln_attn = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                               device=device))
        self.ln_mlp = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                              device=device))
        self.mlp = _params(L.init_mlp(gen, cfg, dtype, device))


class SpladeEncoder(nn.Module):
    """The encoder of ``cfg`` on ``device`` (default ``"cuda"``: raises
    without a card), initialised from ``generator`` with the JAX init's
    laws (other numbers: carry JAX weights with :func:`params_from_jax`)."""

    def __init__(self, cfg: TransformerConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator()
        dtype = torch.float32  # cfg.param_dtype, the only one it allows
        self.cfg = cfg
        self.blocks = nn.ModuleList(
            [_Block(cfg, gen, dtype, dev) for _ in range(cfg.n_layers)])
        self.embed = nn.Parameter(L.dense_init(
            gen, cfg.vocab_size, cfg.d_model, dtype, scale=0.02, device=dev))
        self.ln_f = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                            device=dev))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(L.dense_init(
                gen, cfg.d_model, cfg.vocab_size, dtype, device=dev))
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size,
                                                 dtype=torch.float32,
                                                 device=dev))

    def head_weight(self) -> torch.Tensor:
        """The [d, V] MLM head: the ``embed.T`` view when tied (no copy)."""
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """[B, T] token ids -> [B, T, d] final-norm hidden states.  Raises
        ``ValueError`` on an id outside [0, V) (``jnp.take`` would fill)."""
        cfg = self.cfg
        tokens = tokens.to(self.embed.device)
        if tokens.numel() and (int(tokens.min()) < 0
                               or int(tokens.max()) >= cfg.vocab_size):
            raise ValueError(f"token ids must lie in [0, {cfg.vocab_size})")
        x = self.embed[tokens.long()]
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


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """A JAX ``SpladeEncoder`` params pytree, its leaves as numpy arrays
    and its ``blocks`` stacked [L, ...] for ``scan``, as a ``state_dict`` of
    :class:`SpladeEncoder` (CPU tensors; ``load_state_dict`` copies them to
    the module's device)."""
    state = {}
    for name, leaf in _flatten(params).items():
        leaf = np.asarray(leaf)
        if name.startswith("blocks."):
            rest = name[len("blocks."):]
            for i in range(leaf.shape[0]):
                state[f"blocks.{i}.{rest}"] = torch.from_numpy(leaf[i].copy())
        else:
            state[name] = torch.from_numpy(leaf.copy())
    return state
