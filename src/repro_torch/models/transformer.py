"""Decoder-only transformer LM, dense or mixture-of-experts: prefill and
single-token decode against a KV cache, and the next-token loss of training
(``repro.models.transformer``).

``TransformerLM(cfg, device="cuda", generator=None)`` holds the JAX params
pytree's leaves under the same names, one block per layer where JAX stacks
them for ``scan``: ``embed`` [V, d], ``blocks.<i>.attn.{wq,wk,wv,wo}``
(``bq``/``bk``/``bv`` with ``qkv_bias``, ``q_norm``/``k_norm`` with
``qk_norm``), ``blocks.<i>.ln_attn``, ``blocks.<i>.ln_mlp``,
``blocks.<i>.mlp.{w_gate,w_up,w_down}`` (no ``w_gate`` for gelu) or, with
``cfg.moe``, ``blocks.<i>.moe.{router,w_gate,w_up,w_down}`` in its place,
``ln_f``, and ``lm_head`` when the head is untied.  Parameters are f32;
each layer's are cast to the compute ``cfg.dtype`` as it runs (the
router's too: under bf16 it is rounded to bf16 and promoted back to f32
for the routing logits), and the embedding after the gather, as the JAX
``_cast_floats`` does.
:func:`params_from_jax` turns a JAX params pytree (as numpy arrays) into
the ``state_dict``, and :func:`params_to_jax` the ``state_dict`` back into
the JAX pytree, its blocks restacked [L, ...].

``prefill``'s attention goes through the CUDA ``flash_attention`` kernel
(``use_kernel=True``, the default: the JAX LM has no such switch and runs
its chunked attention, the same function, which ``use_kernel=False``
runs here).  Decode is plain PyTorch.  The kernel has no backward, so run
the LM under ``torch.inference_mode()``.  ``loss_fn`` trains through the
plain chunked attention; with ``cfg.remat`` each block of a forward that
records gradients runs under ``torch.utils.checkpoint`` (its activations
recomputed in the backward, as ``jax.checkpoint`` does in JAX).  A MoE
layer adds its load-balancing loss to ``loss_fn``'s total (summed over the
layers); prefill and decode drop it, as JAX does.  At decode the T = B
tokens of a step form the dispatch groups, so decode drops tokens at
capacity too.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import TransformerConfig
from repro_torch.models import layers as L
from repro_torch.utils import resolve_device, stack_layers, unstack_layers

EMPTY_SLOT = 2**31 - 1  # position of an empty cache slot: masked by <=


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
        self.ffn = "moe" if cfg.moe else "mlp"
        init = L.init_moe if cfg.moe else L.init_mlp
        setattr(self, self.ffn, _params(init(gen, cfg, dtype, device)))

    def cast(self, dtype) -> dict:
        """The layer's parameters as plain tensors in ``dtype`` (every
        float leaf, the router's too, as ``_cast_floats`` does)."""
        return {
            "attn": {k: v.to(dtype) for k, v in self.attn.items()},
            "ln_attn": self.ln_attn.to(dtype),
            "ln_mlp": self.ln_mlp.to(dtype),
            self.ffn: {k: v.to(dtype)
                       for k, v in getattr(self, self.ffn).items()},
        }


class Backbone(nn.Module):
    """The parameters of a JAX ``TransformerLM`` pytree on ``device``
    (default ``"cuda"``: raises without a card), initialised from
    ``generator`` with the JAX init's laws (other numbers: carry JAX
    weights with :func:`params_from_jax`)."""

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

    def head_weight(self) -> torch.Tensor:
        """The [d, V] head: the ``embed.T`` view when tied (no copy)."""
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """The f32 embedding rows of ``tokens``.  Raises ``ValueError`` on
        an id outside [0, V) (``jnp.take`` would fill); ``meta`` tokens
        hold no ids to check."""
        tokens = tokens.to(self.embed.device)
        if tokens.numel() and not tokens.is_meta and (int(tokens.min()) < 0
                               or int(tokens.max()) >= self.cfg.vocab_size):
            raise ValueError(
                f"token ids must lie in [0, {self.cfg.vocab_size})")
        return self.embed[tokens.long()]


class TransformerLM(Backbone):
    """The LM of ``cfg``: ``prefill``, ``decode_step`` and ``loss_fn``."""

    def _mlp_half(self, p: dict, x: torch.Tensor):
        """The block's second half -> (x + the MLP's or the experts'
        output, the experts' aux loss: 0.0 for an MLP)."""
        cfg = self.cfg
        pre = L.rms_norm(x, p["ln_mlp"], cfg.norm_eps)
        if cfg.moe:
            h, aux = L.moe_block(p["moe"], pre, cfg)
            return x + h, aux
        return x + L.mlp_block(p["mlp"], pre, cfg), 0.0

    def _block(self, blk: _Block, x: torch.Tensor, positions: torch.Tensor,
               q_chunk: int, kv_chunk: int, use_kernel: bool):
        cfg = self.cfg
        p = blk.cast(cfg.compute_dtype)
        h, _ = L.attention_block(
            p["attn"], L.rms_norm(x, p["ln_attn"], cfg.norm_eps), cfg,
            positions, q_chunk, kv_chunk, use_kernel)
        return self._mlp_half(p, x + h)

    def backbone(self, tokens: torch.Tensor, q_chunk: Optional[int] = None,
                 kv_chunk: Optional[int] = None, use_kernel: bool = True):
        """[B, S] tokens -> ([B, S, d] final hidden states in
        ``cfg.dtype``, the f32 aux loss summed over the layers).
        ``q_chunk``/``kv_chunk`` (default ``cfg.attn_q_chunk``/
        ``attn_kv_chunk``) tile the plain attention of ``use_kernel=False``.
        With ``cfg.remat``, a forward that records gradients recomputes each
        block (its parameters' cast included) in the backward."""
        cfg = self.cfg
        q_chunk = q_chunk or cfg.attn_q_chunk
        kv_chunk = kv_chunk or cfg.attn_kv_chunk
        x = self.embed_tokens(tokens).to(cfg.compute_dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        remat = cfg.remat and torch.is_grad_enabled()
        aux = x.new_zeros((), dtype=torch.float32)
        for blk in self.blocks:
            args = (blk, x, positions, q_chunk, kv_chunk, use_kernel)
            x, a = (checkpoint(self._block, *args, use_reentrant=False)
                    if remat else self._block(*args))
            aux = aux + a
        return L.rms_norm(x, self.ln_f, cfg.norm_eps), aux

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """``hidden @ head`` in the hidden states' dtype, returned in f32."""
        return (hidden @ self.head_weight().to(hidden.dtype)).float()

    def loss_fn(self, batch: dict):
        """Next-token cross-entropy over ``batch["tokens"]`` [B, S]: the f32
        log-softmax of the logits at ``targets``, averaged over
        ``loss_mask``, plus the layers' aux loss -> (total, ``{"ce",
        "aux"}``; ``aux`` is 0 without experts).  Runs the plain attention
        (the kernel has no backward)."""
        hidden, aux = self.backbone(batch["tokens"], use_kernel=False)
        logp = F.log_softmax(self.logits(hidden), dim=-1)
        targets = batch["targets"].to(logp.device).long()
        ll = logp.gather(-1, targets[..., None])[..., 0]
        mask = batch["loss_mask"].to(device=logp.device, dtype=torch.float32)
        loss = -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
        return loss + aux, {"ce": loss.detach(), "aux": aux.detach()}

    def prefill(self, tokens: torch.Tensor,
                use_kernel: bool = True) -> torch.Tensor:
        """The full forward over [B, S] tokens; the last position's logits,
        f32 [B, 1, V] (the cache is not returned, as in JAX)."""
        hidden, _ = self.backbone(tokens, use_kernel=use_kernel)
        return self.logits(hidden[:, -1:, :])

    def cache_len(self, max_context: int) -> int:
        w = self.cfg.sliding_window
        return max_context if w is None else min(w, max_context)

    def init_cache(self, batch: int, max_context: int) -> dict:
        """An empty KV cache: ``k``/``v`` [L, B, S, Hkv, Dh] in ``cfg.dtype``
        (zeros), ``pos`` int32 [L, S] (every slot empty), S =
        ``cache_len(max_context)``."""
        cfg = self.cfg
        s = self.cache_len(max_context)
        dev = self.embed.device
        shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim)
        return {
            "k": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
            "pos": torch.full((cfg.n_layers, s), EMPTY_SLOT,
                              dtype=torch.int32, device=dev),
        }

    def decode_step(self, cache: dict, tokens: torch.Tensor,
                    position: int):
        """One decode step: tokens [B] at absolute ``position`` -> (f32
        logits [B, V], the cache).  The cache is updated in place."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        x = self.embed_tokens(tokens[:, None]).to(dt)
        for li, blk in enumerate(self.blocks):
            p = blk.cast(dt)
            h = L.rms_norm(x, p["ln_attn"], cfg.norm_eps)
            h, _ = L.decode_attention(p["attn"], h, cfg, cache["k"][li],
                                      cache["v"][li], position,
                                      cache["pos"][li])
            x, _ = self._mlp_half(p, x + h)
        hidden = L.rms_norm(x, self.ln_f, cfg.norm_eps)
        return self.logits(hidden)[:, 0, :], cache


def params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """A JAX ``TransformerLM`` params pytree (or a ``SpladeEncoder``'s, with
    its ``mlm_bias``), its leaves as numpy arrays and its ``blocks`` stacked
    [L, ...] for ``scan``, as a ``state_dict`` of :class:`TransformerLM`
    (or of ``SpladeEncoder``): CPU tensors, which ``load_state_dict`` copies
    to the module's device."""
    return unstack_layers(params, ("blocks",))


def params_to_jax(state: dict) -> dict:
    """The inverse of :func:`params_from_jax`: a ``state_dict`` (tensors or
    numpy arrays) as the JAX params pytree of numpy arrays, nested by the
    dotted names, with ``blocks.<i>.<leaf>`` stacked into
    ``blocks.<leaf>`` [L, ...] in layer order."""
    return stack_layers(state, ("blocks",))
