"""Sparse embedding substrate of the recsys models
(``repro.models.recsys.embeddings``).

One concatenated table holds every field's rows, each field at its row
offset (the fused-table layout).  A single-hot lookup ([B, F] ids) is a
row gather.  A multi-hot lookup ([B, F, H] bags) is a weighted bag sum:
``use_kernel=True`` (the default; the JAX package sends it to
``embedding_bag_jnp``, the same function) runs it through the
``embedding_bag`` kernel entry, whose CUDA kernel runs for a table on the
card and whose plain version runs for one on the CPU; ``use_kernel=False``
runs :func:`embedding_bag_plain`.  The kernel has no backward, so serve
under ``torch.inference_mode()``.

The MLP tower is an ``nn.ModuleDict`` whose parameters carry the JAX
pytree's names (``layers.<i>.w``, ``layers.<i>.b``, ``head.w``,
``head.b``).  :class:`ClickModel`, the four models' base, gives them the
JAX ``loss_fn``: :func:`bce_loss` of ``forward(batch, use_kernel=False)``
(the kernel has no backward).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.models.layers import dense_init


def embedding_bag_plain(
    table: torch.Tensor,  # f32 [V, D]
    ids: torch.Tensor,  # int [N, L]  (-1 = padding)
    weights: Optional[torch.Tensor] = None,  # f32 [N, L]
    combiner: str = "sum",
) -> torch.Tensor:
    """EmbeddingBag as a gather and a masked reduce (``embedding_bag_jnp``):
    f32 [N, D].  An id outside [0, V) adds 0 and, for ``"mean"``, counts
    nothing, as in the kernel (``embedding_bag_jnp`` drops -1 but gathers
    NaN for an id at or past V)."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"combiner {combiner!r}; expected 'sum' or 'mean'")
    live = (ids >= 0) & (ids < table.shape[0])
    g = table[torch.where(live, ids, 0).long()]  # [N, L, D]
    m = live.to(g.dtype)[..., None]
    if weights is not None:
        m = m * weights[..., None].to(g.dtype)
    s = (g * m).sum(dim=-2)
    if combiner == "mean":
        s = s / torch.clamp_min(m.sum(dim=-2), 1.0)
    return s


class FieldEmbedding:
    """Concatenated multi-field embedding table with row offsets."""

    def __init__(self, vocab_sizes, embed_dim: int):
        self.vocab_sizes = tuple(int(v) for v in vocab_sizes)
        self.embed_dim = embed_dim

    @property
    def total_rows(self) -> int:
        return int(sum(self.vocab_sizes))

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.vocab_sizes)[:-1]]).astype(
            np.int32)

    def init(self, gen: torch.Generator, device) -> nn.ParameterDict:
        """``table``: N(0, 1/D) f32 [total_rows, D] from ``gen``, on
        ``device``."""
        return nn.ParameterDict({"table": nn.Parameter(dense_init(
            gen, self.total_rows, self.embed_dim,
            scale=1.0 / math.sqrt(self.embed_dim), device=device))})

    def flat_ids(self, sparse_ids: torch.Tensor) -> torch.Tensor:
        """[B, F, H] field ids -> int32 [B F, H] rows of the concatenated
        table, -1 kept at every pad."""
        b, f, h = sparse_ids.shape
        offs = torch.from_numpy(self.offsets).to(sparse_ids.device)
        flat = torch.where(sparse_ids >= 0,
                           sparse_ids + offs[None, :, None], -1)
        return flat.to(torch.int32).reshape(b * f, h)

    def lookup(self, table: torch.Tensor, sparse_ids: torch.Tensor,
               use_kernel: bool = True) -> torch.Tensor:
        """sparse_ids: int [B, F] or [B, F, H] (multi-hot bags per field,
        -1 = pad) -> [B, F, D] per-field pooled embeddings."""
        sparse_ids = sparse_ids.to(table.device)
        if sparse_ids.dim() == 2:
            offs = torch.from_numpy(self.offsets).to(table.device)
            return table[(sparse_ids + offs[None, :]).long()]
        b, f, _ = sparse_ids.shape
        flat = self.flat_ids(sparse_ids)
        bags = (embedding_bag(flat, table) if use_kernel
                else embedding_bag_plain(table, flat))
        return bags.reshape(b, f, self.embed_dim)


def _dense(gen: torch.Generator, d_in: int, d_out: int,
           device) -> nn.ParameterDict:
    return nn.ParameterDict({
        "w": nn.Parameter(dense_init(gen, d_in, d_out, device=device)),
        "b": nn.Parameter(torch.zeros(d_out, device=device)),
    })


def init_mlp_tower(gen: torch.Generator, dims, out_dim: int = 1,
                   device=None) -> nn.ModuleDict:
    """The JAX ``init_mlp_tower``: ``layers.<i>.{w,b}``, dense layers
    ``dims[i] -> dims[i + 1]``, and ``head.{w,b}``, ``dims[-1] ->
    out_dim``; N(0, 1/fan_in) weights, zero biases."""
    return nn.ModuleDict({
        "layers": nn.ModuleList([_dense(gen, dims[i], dims[i + 1], device)
                                 for i in range(len(dims) - 1)]),
        "head": _dense(gen, dims[-1], out_dim, device),
    })


def apply_mlp_tower(tower: nn.ModuleDict, x: torch.Tensor,
                    act: Callable = torch.relu) -> torch.Tensor:
    for layer in tower["layers"]:
        x = act(x @ layer["w"] + layer["b"])
    return x @ tower["head"]["w"] + tower["head"]["b"]


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of f32 logits, the stable form
    max(x, 0) - x y + log1p(exp(-|x|)) (``torch.maximum``, like
    ``jnp.maximum``, splits its gradient at x = 0)."""
    labels = labels.to(logits.device)
    logits = logits.reshape(labels.shape).float()
    return torch.mean(
        torch.maximum(logits, logits.new_zeros(())) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits))))


class ClickModel(nn.Module):
    """A click model's training loss (the JAX models' ``loss_fn``)."""

    def loss_fn(self, batch: dict):
        """-> (the BCE of the logits against ``batch["label"]``,
        ``{"bce": it}``), through the plain bag sums."""
        loss = bce_loss(self.forward(batch, use_kernel=False),
                        batch["label"])
        return loss, {"bce": loss.detach()}
