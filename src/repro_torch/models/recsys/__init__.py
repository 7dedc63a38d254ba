"""The recsys models (``repro.models.recsys``): DIN, DIEN, AutoInt and
xDeepFM on one concatenated field table, whose multi-hot lookups go
through the ``embedding_bag`` kernel entry when serving; ``loss_fn``
trains through the plain bag sums.

``build_model(cfg, device="cuda", seed=0)`` makes the model of
``cfg.model`` with seeded weights (the JAX init's laws, other numbers);
:func:`params_from_jax` turns a JAX recsys params pytree into its
``state_dict``, and :func:`params_to_jax` the ``state_dict`` back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.models.recsys.autoint import AutoInt
from repro_torch.models.recsys.dien import DIEN
from repro_torch.models.recsys.din import DIN
from repro_torch.models.recsys.embeddings import (
    FieldEmbedding, bce_loss, bce_terms, embedding_bag_plain,
)
from repro_torch.models.recsys.xdeepfm import XDeepFM
from repro_torch.utils import nest, resolve_device

MODELS = {"din": DIN, "dien": DIEN, "autoint": AutoInt, "xdeepfm": XDeepFM}

__all__ = ["AutoInt", "DIEN", "DIN", "FieldEmbedding", "MODELS", "XDeepFM",
           "bce_loss", "bce_terms", "build_model", "embedding_bag_plain",
           "params_from_jax", "params_to_jax", "shard_params"]


def build_model(cfg: RecsysConfig, device="cuda", seed: int = 0,
                policy=None, serving: bool = True):
    """The model of ``cfg.model`` on ``device``, its weights drawn from a
    generator on that device seeded with ``seed`` (on ``meta``: empty
    tensors of their shapes, nothing drawn); under a ``policy`` this
    rank's shards of them, by the serving or (``serving=False``) the
    training rule (``ClickModel.shard``)."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator(
        device=dev).manual_seed(seed)
    model = MODELS[cfg.model](cfg, device=dev, generator=gen)
    return model if policy is None else model.shard(policy, serving)


def shard_params(params: dict, policy, coords,
                 serving: bool = True) -> dict[str, torch.Tensor]:
    """JAX's recsys params (numpy leaves) as the ``state_dict`` of the
    rank at mesh ``coords`` under ``recsys_param_specs(policy,
    serving)``: CPU tensors.  Load it into a model sharded the same way
    (``build_model(..., policy=policy)``)."""
    from repro_torch.sharding import policies as pol

    state = params_from_jax(params)
    specs = pol.recsys_param_specs(policy, state, serving=serving)
    return {k: v.clone(memory_format=torch.contiguous_format)
            for k, v in pol.shard_tree(state, specs, policy.mesh,
                                       coords).items()}


def _flatten(tree, prefix: str = "") -> dict:
    """Dotted names of a pytree of dicts and lists (list items by index)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """A JAX recsys params pytree (nested dicts and lists — ``cin``,
    ``attn_layers``, ``mlp.layers`` — of numpy leaves) as the model's
    ``state_dict``: CPU tensors under the same dotted names, which
    ``load_state_dict(..., strict=True)`` copies to the model's device."""
    return {name: torch.from_numpy(np.array(leaf, copy=True))
            for name, leaf in _flatten(params).items()}


def _lists(node):
    """Dict levels keyed ``"0".."n-1"`` as the lists JAX holds there."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        if sorted(map(int, out)) != list(range(len(out))):
            raise ValueError(f"list items {sorted(out)}")
        return [out[str(i)] for i in range(len(out))]
    return out


def params_to_jax(state: dict) -> dict:
    """The inverse of :func:`params_from_jax`: a ``state_dict`` (tensors or
    numpy arrays) as the JAX recsys pytree of numpy arrays (nested dicts,
    and lists where a level's names are the indices ``0..n-1``)."""
    flat = {name: (leaf.detach().to("cpu", copy=True).numpy()
                   if isinstance(leaf, torch.Tensor) else np.asarray(leaf))
            for name, leaf in state.items()}
    return _lists(nest(flat))
