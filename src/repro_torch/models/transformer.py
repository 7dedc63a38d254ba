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

Under a sharding policy (``TransformerLM(cfg, device, generator,
policy=make_policy(mesh))``; :mod:`repro_torch.sharding`) each rank holds
its shards of every parameter, placed by ``lm_param_specs`` (``specs``
records them): every full leaf is drawn from the generator in the
unsharded order and cut at once, so the ranks hold one set of weights;
:func:`shard_params` cuts JAX's parameters the same way.  A layer's
weights are gathered over the data axis before use (FSDP), and the
layers run tensor- or expert-parallel on the model axis
(``layers.TensorParallel``): the vocabulary-parallel embedding (a masked
local gather, then a SUM all-reduce), the attention on the rank's heads
(or, where JAX's spec splits a head, every head from the block's
gathered ``wq``/``wk``/``wv``), the MLP or experts, and the
vocabulary-parallel head, whose logits are gathered over the model axis.
``init_cache`` takes the global batch and returns the rank's block of the
cache under ``lm_cache_specs`` (split by heads, or by sequence when the
kv heads do not divide the axis); ``prefill`` and ``decode_step`` take
the rank's rows of the batch (``prefill``'s split over the data axis,
``decode_step``'s where ``lm_cache_specs`` split it) and return their
logits, whole over the vocabulary.  A policy
needs a ``DeviceMesh`` over the initialised process group (its
``AbstractMesh`` counts on ``meta`` alone, as rank 0); ``loss_fn`` runs
unsharded only (training under the policy is not ported yet).
"""
from __future__ import annotations

import contextlib
import re
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import TransformerConfig
from repro_torch.models import layers as L
from repro_torch.sharding import ctx
from repro_torch.sharding import policies as pol
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


def _dims_key(name: str) -> str:
    """Every block has the same placements: ``blocks.<i>.x`` -> ``blocks.x``."""
    return re.sub(r"^blocks\.\d+\.", "blocks.", name)


class Backbone(nn.Module):
    """The parameters of a JAX ``TransformerLM`` pytree on ``device``
    (default ``"cuda"``: raises without a card), initialised from
    ``generator`` with the JAX init's laws (other numbers: carry JAX
    weights with :func:`params_from_jax`); under ``policy`` this rank's
    shards of them."""

    def __init__(self, cfg: TransformerConfig, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 policy: Optional[pol.ShardingPolicy] = None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator()
        dtype = torch.float32  # cfg.param_dtype, the only one it allows
        self.cfg = cfg
        self.policy = policy
        self.coords = (None if policy is None
                       else pol.rank_coords(policy, dev))
        self.specs: dict = {}  # name -> placements of the local shard
        self.dims: dict = {}  # _dims_key(name) -> JAX's per-dim entries
        blocks = []
        for i in range(cfg.n_layers):
            blk = _Block(cfg, gen, dtype, dev)
            for name, p in list(blk.named_parameters() if policy else ()):
                mod, _, leaf = name.rpartition(".")
                owner = blk.get_submodule(mod) if mod else blk
                owner.register_parameter(leaf, nn.Parameter(
                    self._shard(f"blocks.{i}.{name}", p.data)))
            blocks.append(blk)
        self.blocks = nn.ModuleList(blocks)
        self.embed = nn.Parameter(self._shard("embed", L.dense_init(
            gen, cfg.vocab_size, cfg.d_model, dtype, scale=0.02,
            device=dev)))
        self.ln_f = nn.Parameter(self._shard("ln_f", torch.ones(
            cfg.d_model, dtype=dtype, device=dev)))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(self._shard("lm_head", L.dense_init(
                gen, cfg.d_model, cfg.vocab_size, dtype, device=dev)))

    def _shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole leaf ``name`` (a copy, so the
        whole leaf is freed), its placements recorded."""
        if self.policy is None:
            return full
        dims = pol.lm_param_dims(self.cfg, self.policy, name, full.shape)
        self.dims[_dims_key(name)] = dims
        self.specs[name] = self.policy.placements(dims)
        return pol.shard_leaf(full, self.specs[name], self.policy.mesh,
                              self.coords).clone(
            memory_format=torch.contiguous_format)

    def _sharded(self, name: str, dim: int, axis: str) -> bool:
        return axis in pol.entry_axes(self.dims[_dims_key(name)][dim])

    def _axes(self):
        """The policy's axes, active for the collectives of a forward."""
        p = self.policy
        return (contextlib.nullcontext() if p is None
                else ctx.axes(p.mesh, p.dp, p.tp))

    def _gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """Leaf ``name``'s shard in the compute layout: gathered over the
        data axis (FSDP), and over the model axis where attention computes
        every head (JAX's spec splits a head there)."""
        if self.policy is None:
            return t
        leaf = name.rsplit(".", 1)[-1]
        every_head = (self.tp is not None and not self.tp.heads
                      and leaf in ("wq", "wk", "wv", "bq", "bk", "bv"))
        for d in range(t.dim()):
            if any(self._sharded(name, d, a) for a in self.policy.dp):
                t = ctx.gather(t, d, self.policy.dp)
            if every_head and self._sharded(name, d, self.policy.tp):
                t = ctx.gather(t, d, "model")
        return t

    def _gathered(self, tree: dict, prefix: str) -> dict:
        return {k: (self._gathered(v, f"{prefix}{k}.")
                    if isinstance(v, dict) else self._gather(prefix + k, v))
                for k, v in tree.items()}

    @property
    def tp(self) -> Optional[L.TensorParallel]:
        """The model axis as the layers compute on it (None at size 1)."""
        p = self.policy
        if p is None or p.tp_size == 1:
            return None
        cfg, tp = self.cfg, p.tp
        ffn = "blocks.moe.w_down" if cfg.moe else "blocks.mlp.w_down"
        return L.TensorParallel(
            index=int(self.coords[
                list(p.mesh.mesh_dim_names).index(tp)]),
            heads=cfg.n_kv_heads % p.tp_size == 0,
            wo_rows=self._sharded("blocks.attn.wo", 0, tp),
            ffn=any(self._sharded(ffn, d, tp) for d in range(2)))

    def head_weight(self) -> torch.Tensor:
        """The [d, V] head: the ``embed.T`` view when tied (no copy); under
        a policy this rank's columns of V, gathered over the data axis."""
        if self.cfg.tie_embeddings:
            return self._gather("embed", self.embed).T
        return self._gather("lm_head", self.lm_head)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """The f32 embedding rows of ``tokens``.  Raises ``ValueError`` on
        an id outside [0, V) (``jnp.take`` would fill); ``meta`` tokens
        hold no ids to check.  With the vocabulary split over the model
        axis each rank gathers the ids of its rows (0 for the others) and
        the ranks' rows are summed."""
        tokens = tokens.to(self.embed.device)
        if tokens.numel() and not tokens.is_meta and (int(tokens.min()) < 0
                               or int(tokens.max()) >= self.cfg.vocab_size):
            raise ValueError(
                f"token ids must lie in [0, {self.cfg.vocab_size})")
        table = self._gather("embed", self.embed)
        if self.policy is None or not self._sharded("embed", 0,
                                                    self.policy.tp):
            return table[tokens.long()]
        v_loc = table.shape[0]
        local = tokens.long() - ctx.group_index("model") * v_loc
        hit = (local >= 0) & (local < v_loc)
        rows = table[torch.where(hit, local, 0)]
        return ctx.all_reduce_sum(torch.where(hit[..., None], rows, 0.0))


class TransformerLM(Backbone):
    """The LM of ``cfg``: ``prefill``, ``decode_step`` and ``loss_fn``."""

    routes: Optional[list] = None  # a list gets each MoE layer's routing

    def layer(self, i: int, dtype=None) -> dict:
        """Block ``i``'s parameters in ``dtype`` (default the compute
        dtype) and in the compute layout (this rank's, under a policy:
        gathered over the data axis, and where every head is computed)."""
        blk = self.blocks[i]
        with self._axes():
            return self._gathered(blk.cast(dtype or self.cfg.compute_dtype),
                                  "blocks.")

    def _mlp_half(self, p: dict, x: torch.Tensor, tp, data: int = 1):
        """The block's second half -> (x + the MLP's or the experts'
        output, the experts' aux loss: 0.0 for an MLP); ``x`` holds one of
        ``data`` ranks' rows of the batch."""
        cfg = self.cfg
        pre = L.rms_norm(x, p["ln_mlp"], cfg.norm_eps)
        if cfg.moe:
            h, aux = L.moe_block(p["moe"], pre, cfg, tp, self.routes, data)
            return x + h, aux
        return x + L.mlp_block(p["mlp"], pre, cfg, tp), 0.0

    def _block(self, i: int, x: torch.Tensor, positions: torch.Tensor,
               q_chunk: int, kv_chunk: int, use_kernel: bool, tp=None):
        cfg = self.cfg
        p = self.layer(i)
        h, _ = L.attention_block(
            p["attn"], L.rms_norm(x, p["ln_attn"], cfg.norm_eps), cfg,
            positions, q_chunk, kv_chunk, use_kernel, tp)
        data = 1 if self.policy is None else self.policy.dp_size
        return self._mlp_half(p, x + h, tp, data)

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
        tp = self.tp
        x = self.embed_tokens(tokens).to(cfg.compute_dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        remat = cfg.remat and torch.is_grad_enabled()
        aux = x.new_zeros((), dtype=torch.float32)
        for i in range(len(self.blocks)):
            args = (i, x, positions, q_chunk, kv_chunk, use_kernel, tp)
            x, a = (checkpoint(self._block, *args, use_reentrant=False)
                    if remat else self._block(*args))
            aux = aux + a
        return L.rms_norm(x, self._gather("ln_f", self.ln_f),
                          cfg.norm_eps), aux

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """``hidden @ head`` in the hidden states' dtype, returned in f32
        (under a policy gathered over the model axis: whole over V)."""
        out = (hidden @ self.head_weight().to(hidden.dtype)).float()
        head, dim = (("embed", 0) if self.cfg.tie_embeddings
                     else ("lm_head", 1))
        if self.policy is not None and self._sharded(head, dim,
                                                     self.policy.tp):
            out = ctx.gather(out, out.dim() - 1, "model")
        return out

    def loss_fn(self, batch: dict):
        """Next-token cross-entropy over ``batch["tokens"]`` [B, S]: the f32
        log-softmax of the logits at ``targets``, averaged over
        ``loss_mask``, plus the layers' aux loss -> (total, ``{"ce",
        "aux"}``; ``aux`` is 0 without experts).  Runs the plain attention
        (the kernel has no backward)."""
        if self.policy is not None:
            raise NotImplementedError("training under a sharding policy is "
                                      "not ported: train unsharded")
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
        with self._axes():
            hidden, _ = self.backbone(tokens, use_kernel=use_kernel)
            return self.logits(hidden[:, -1:, :])

    def cache_len(self, max_context: int) -> int:
        w = self.cfg.sliding_window
        return max_context if w is None else min(w, max_context)

    cache_seq = None  # the axes splitting the last init_cache's slots
    cache_data = 1  # the data ranks splitting its batch (1: whole)

    def init_cache(self, batch: int, max_context: int) -> dict:
        """An empty KV cache: ``k``/``v`` [L, B, S, Hkv, Dh] in ``cfg.dtype``
        (zeros), ``pos`` int32 [L, S] (every slot empty), S =
        ``cache_len(max_context)``; under a policy this rank's block of
        ``k``/``v`` by ``lm_cache_specs`` for the global ``batch`` (``pos``
        whole), the axes splitting the slots kept in ``cache_seq``."""
        cfg = self.cfg
        s = self.cache_len(max_context)
        dev = self.embed.device
        shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim)
        if self.policy is not None:
            dims = pol.lm_cache_dims(self.policy, batch, s, cfg.n_kv_heads)
            shape = pol.local_shape(shape, self.policy.placements(
                dims["k"]), self.policy.mesh)
            self.cache_seq = pol.entry_axes(dims["k"][2]) or None
            self.cache_data = self.policy.dp_size if dims["k"][1] else 1
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
        with self._axes():
            cfg = self.cfg
            tp = self.tp
            x = self.embed_tokens(tokens[:, None]).to(cfg.compute_dtype)
            for li in range(len(self.blocks)):
                p = self.layer(li)
                h = L.rms_norm(x, p["ln_attn"], cfg.norm_eps)
                h, _ = L.decode_attention(p["attn"], h, cfg, cache["k"][li],
                                          cache["v"][li], position,
                                          cache["pos"][li], tp,
                                          self.cache_seq)
                x, _ = self._mlp_half(p, x + h, tp, self.cache_data)
            hidden = L.rms_norm(x, self._gather("ln_f", self.ln_f),
                                cfg.norm_eps)
            return self.logits(hidden)[:, 0, :], cache


def params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """A JAX ``TransformerLM`` params pytree (or a ``SpladeEncoder``'s, with
    its ``mlm_bias``), its leaves as numpy arrays and its ``blocks`` stacked
    [L, ...] for ``scan``, as a ``state_dict`` of :class:`TransformerLM`
    (or of ``SpladeEncoder``): CPU tensors, which ``load_state_dict`` copies
    to the module's device."""
    return unstack_layers(params, ("blocks",))


def shard_params(params: dict, policy: pol.ShardingPolicy, coords,
                 cfg: TransformerConfig) -> dict[str, torch.Tensor]:
    """JAX's ``TransformerLM`` params (numpy leaves, blocks stacked) as the
    ``state_dict`` of the rank at mesh ``coords`` under ``policy``: each
    leaf cut by ``lm_param_specs`` (CPU tensors)."""
    state = params_from_jax(params)
    specs = pol.lm_param_specs(cfg, policy, state)
    return {k: v.clone(memory_format=torch.contiguous_format)
            for k, v in pol.shard_tree(state, specs, policy.mesh,
                                       coords).items()}


def params_to_jax(state: dict) -> dict:
    """The inverse of :func:`params_from_jax`: a ``state_dict`` (tensors or
    numpy arrays) as the JAX params pytree of numpy arrays, nested by the
    dotted names, with ``blocks.<i>.<leaf>`` stacked into
    ``blocks.<leaf>`` [L, ...] in layer order."""
    return stack_layers(state, ("blocks",))
