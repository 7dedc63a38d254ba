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

Row-sharded tables (``ClickModel.shard``, under ``recsys_param_specs``):
for serving a table of at least ``REPLICATE_TABLE_BYTES`` whose rows
divide the model axis, for training (``serving=False``) every table whose
rows divide it, keeps rows [first, first + V / tp) on each rank, and the
batch is split over every axis (``recsys_batch_specs``).  A lookup
(:func:`sharded_lookup`) gathers the ids of the model axis's ranks (an
all-gather), looks every one up in the rank's own rows through
``embedding_bag`` with the ids shifted by ``first`` (an id outside [0,
V / tp) adds 0: the kernel's rule does the masking), sums the ranks'
bags (a SUM all-reduce) and keeps its own rows of the batch; in training
that sum-then-keep is one reduce-scatter, whose backward gathers the
ranks' row gradients, so a rank's table block receives the gradient of
every rank's rows that hit it.  Replicated tables take the unsharded
path.  ``loss_fn`` under a training policy is the BCE over the whole
batch (the rank's sum all-reduced over every axis, then divided), and
``train_plan`` SUMs each leaf's gradient over the axes that do not split
it (the batch is split over all of them).
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.models.layers import dense_init
from repro_torch.sharding import ctx
from repro_torch.sharding import policies as pol


def sharded_lookup(table: torch.Tensor, ids: torch.Tensor, first: int,
                   split: bool, use_kernel: bool = True) -> torch.Tensor:
    """Bag sums [N, D] of ``ids`` [N, L] (rows of the whole table, -1 =
    pad) from a table whose rank holds rows [first, first + len(table)):
    each rank's bags of its own rows, summed over the model axis.
    ``split``: the ids are this rank's rows of a batch split over the
    model axis; the ranks' ids are gathered first and the rank keeps its
    rows of the sum (otherwise every rank holds every id)."""
    n = ids.shape[0]
    if split:
        ids = ctx.gather(ids, 0, "model")
    local = (ids - first).to(torch.int32)
    bags = (embedding_bag(local, table) if use_kernel
            else embedding_bag_plain(table, local))
    if split and torch.is_grad_enabled() and bags.requires_grad:
        return ctx.reduce_scatter(bags, 0, "model")
    bags = ctx.all_reduce_sum(bags)
    if split:
        i = ctx.group_index("model")
        bags = bags[i * n:(i + 1) * n]
    return bags


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
               use_kernel: bool = True, first: Optional[int] = None,
               split: bool = True) -> torch.Tensor:
        """sparse_ids: int [B, F] or [B, F, H] (multi-hot bags per field,
        -1 = pad) -> [B, F, D] per-field pooled embeddings.  ``first``:
        the table is this rank's rows from ``first`` on
        (:func:`sharded_lookup`, ``split`` as there)."""
        sparse_ids = sparse_ids.to(table.device)
        if first is not None:
            ids = sparse_ids if sparse_ids.dim() == 3 else sparse_ids[..., None]
            b, f, _ = ids.shape
            bags = sharded_lookup(table, self.flat_ids(ids), first, split,
                                  use_kernel)
            return bags.reshape(b, f, self.embed_dim)
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


def bce_terms(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each example's binary cross-entropy of f32 logits, the stable form
    max(x, 0) - x y + log1p(exp(-|x|)) (``torch.maximum``, like
    ``jnp.maximum``, splits its gradient at x = 0)."""
    labels = labels.to(logits.device)
    logits = logits.reshape(labels.shape).float()
    return (torch.maximum(logits, logits.new_zeros(())) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of f32 logits (:func:`bce_terms`)."""
    return torch.mean(bce_terms(logits, labels))


class ClickModel(nn.Module):
    """A click model's training loss (the JAX models' ``loss_fn``), and
    its tables' row shards under a serving or training policy."""

    policy = None
    first: dict = {}  # a row-sharded table's name -> its first row here

    def loss_fn(self, batch: dict):
        """-> (the BCE of the logits against ``batch["label"]``,
        ``{"bce": it}``), through the plain bag sums; under a policy
        ``batch`` is this rank's rows and the BCE the whole batch's."""
        logits = self.forward(batch, use_kernel=False)
        with self._axes():
            n = ctx.group_size("all")
            if n == 1:
                loss = bce_loss(logits, batch["label"])
            else:
                terms = bce_terms(logits, batch["label"])
                loss = (ctx.all_reduce_sum(torch.sum(terms), "all")
                        / (terms.numel() * n))
        return loss, {"bce": loss.detach()}

    def shard(self, policy, serving: bool = True) -> "ClickModel":
        """Keep this rank's shards under ``recsys_param_specs(policy,
        serving)`` (``specs``: every parameter's placements); raises
        without a process group of the mesh's size (``meta``: rank 0)."""
        coords = pol.rank_coords(policy, next(self.parameters()).device)
        self.policy, self.first = policy, {}
        self.specs = pol.recsys_param_specs(
            policy, dict(self.named_parameters()), serving=serving)
        for name, p in list(self.named_parameters()):
            pl = self.specs[name]
            if all(isinstance(x, pol.Replicate) for x in pl):
                continue
            block = pol.shard_leaf(p.data, pl, policy.mesh, coords)
            self.first[name] = int(coords[list(
                policy.mesh.mesh_dim_names).index(policy.tp)]) * len(block)
            mod, _, leaf = name.rpartition(".")
            owner = self.get_submodule(mod) if mod else self
            owner.register_parameter(leaf, nn.Parameter(block.clone(
                memory_format=torch.contiguous_format)))
        return self

    def _axes(self):
        p = self.policy
        return (contextlib.nullcontext() if p is None
                else ctx.axes(p.mesh, p.dp, p.tp))

    def train_plan(self) -> pol.TrainPlan:
        """The sharded step's plan: every leaf's gradient SUMmed over the
        axes that do not split it (the batch is split over all of them;
        a row-sharded table's block sees every model rank's ids)."""
        p = self.policy
        if p is None:
            raise ValueError("a train plan needs a policy")
        every = p.dp + (p.tp,)
        return pol.TrainPlan(p, dict(self.specs), {
            name: pol.replicated_axes(pl, p.mesh, every)
            for name, pl in self.specs.items()})

    def rows(self, name: str, table: torch.Tensor, ids: torch.Tensor,
             split: bool = True, use_kernel: bool = True) -> torch.Tensor:
        """``table[ids]`` [*ids.shape, D] of the table ``name``: a gather,
        or :func:`sharded_lookup` with bags of one id where it is
        row-sharded."""
        ids = ids.to(table.device)
        if name not in self.first:
            return table[ids.long()]
        bags = sharded_lookup(table, ids.reshape(-1, 1), self.first[name],
                              split, use_kernel)
        return bags.reshape(*ids.shape, table.shape[1])
