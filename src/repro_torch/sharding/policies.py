"""Sharding policies: FSDP over ``data``, TP over ``model``, as DTensor
placements (``repro.sharding.policies``).

Rules are keyed by parameter name, per architecture family, and are JAX's
rules unchanged (``_divisible`` included).  The port's blocks are not
stacked for ``scan``, so JAX's leading ``L`` dim drops out of each spec:

LM transformer (Megatron TP x ZeRO-3 FSDP):
  embed [V, D]          -> (model, dp)    vocab-sharded TP, FSDP on D
  wq/wk/wv [D, H*Dh]    -> (dp, model)    column parallel
  wo [H*Dh, D]          -> (model, dp)    row parallel
  mlp up/gate [D, F]    -> (dp, model)
  mlp down [F, D]       -> (model, dp)
  MoE experts [E, D, F] -> TP on F, or EP on E (``expert_parallel``)
  lm_head [D, V]        -> (dp, model)
  norms                 -> replicated

A rule first gives JAX's per-dim entries (an axis name, a tuple of axes
or ``None`` for each tensor dim: a ``PartitionSpec``'s); the public rule
functions return them as placements, one ``Shard(d)`` or ``Replicate()``
per mesh dim (:func:`to_placements`), keyed by the port's parameter
names.  A mesh here is anything with ``shape`` and ``mesh_dim_names``: a
``DeviceMesh`` over live ranks, or an :class:`AbstractMesh` (the rules
read nothing else, as JAX's read only ``mesh.shape``).

:func:`shard_leaf` cuts one rank's block out of a whole tensor under its
placements, and :func:`shard_tree` a whole flat tree (JAX's parameters
as numpy arrays, or the port's own ``state_dict``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch.distributed.tensor import Replicate, Shard

Entry = Optional[object]  # an axis name, a tuple of them, or None


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names without ranks (``jax.sharding.
    AbstractMesh``): what the rules and :func:`local_shape` read."""

    shape: tuple
    mesh_dim_names: tuple = ("data", "model")

    def get_coordinate(self) -> list:
        """Rank 0's coordinates: a step counted on ``meta`` is rank 0's."""
        return [0] * len(self.shape)


def axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    mesh: Any  # a DeviceMesh, or an AbstractMesh for the rules alone
    dp: tuple  # data-parallel axes (FSDP + batch)
    tp: str  # tensor-parallel axis
    expert_parallel: bool = False  # EP over the tp axis for the expert dim
    microbatches: int = 1

    @property
    def dp_size(self) -> int:
        sizes = axis_sizes(self.mesh)
        return int(np.prod([sizes[a] for a in self.dp]))

    @property
    def tp_size(self) -> int:
        return int(axis_sizes(self.mesh)[self.tp])

    def placements(self, dims: Sequence[Entry]) -> tuple:
        return to_placements(dims, self.mesh)


def make_policy(mesh, expert_parallel: bool = False,
                microbatches: int = 1) -> ShardingPolicy:
    axes = tuple(mesh.mesh_dim_names)
    dp = tuple(a for a in axes if a in ("pod", "data"))
    tp = "model" if "model" in axes else axes[-1]
    return ShardingPolicy(mesh=mesh, dp=dp, tp=tp,
                          expert_parallel=expert_parallel,
                          microbatches=microbatches)


def rank_coords(policy: ShardingPolicy, device) -> list:
    """This rank's mesh coordinates under ``policy``; raises unless the
    mesh is a ``DeviceMesh`` over the whole initialised process group (an
    ``AbstractMesh`` only on ``meta``, where a step is rank 0's)."""
    mesh = policy.mesh
    if isinstance(mesh, AbstractMesh):
        if torch.device(device).type != "meta":
            raise ValueError("a policy over an AbstractMesh counts on meta "
                             "only; run over a DeviceMesh "
                             "(launch.mesh.make_debug_mesh)")
        return mesh.get_coordinate()
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a sharded model needs an initialised process "
                           "group")
    if dist.get_world_size() != mesh.size():
        raise ValueError(f"the mesh {tuple(mesh.shape)} has {mesh.size()} "
                         f"ranks; the process group {dist.get_world_size()}")
    return list(mesh.get_coordinate())


def entry_axes(entry: Entry) -> tuple:
    """The mesh axes of one per-dim entry (``()`` for ``None``)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def to_placements(dims: Sequence[Entry], mesh) -> tuple:
    """JAX-style per-dim entries -> one placement per mesh dim:
    ``Shard(d)`` where the mesh dim's axis names tensor dim d, else
    ``Replicate()``.  A tensor dim over several axes is split over them
    in mesh order (``P(("data", "model"))``: data-major)."""
    owner = {}
    for d, entry in enumerate(dims):
        for a in entry_axes(entry):
            if a in owner:
                raise ValueError(f"axis {a!r} names two dims of {dims}")
            owner[a] = d
    names = tuple(mesh.mesh_dim_names)
    unknown = set(owner) - set(names)
    if unknown:
        raise ValueError(f"axes {sorted(unknown)} are not in {names}")
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in names)


def _blocks(shape: Sequence[int], placements: Sequence, mesh) -> list:
    """Per tensor dim, the mesh dims that split it (mesh order)."""
    split = [[] for _ in shape]
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            split[p.dim].append(i)
    return split


def local_shape(shape: Sequence[int], placements: Sequence, mesh) -> tuple:
    """The shape of one rank's block: each split dim divided by the
    product of its mesh dims (which must divide it)."""
    sizes = tuple(mesh.shape)
    out = []
    for n, mdims in zip(shape, _blocks(shape, placements, mesh)):
        parts = math.prod(sizes[i] for i in mdims)
        if n % parts:
            raise ValueError(f"dim {n} does not split into {parts} parts")
        out.append(n // parts)
    return tuple(out)


def shard_leaf(x, placements: Sequence, mesh, coords: Sequence[int]):
    """Rank ``coords``' block of the whole tensor (or numpy array) ``x``
    under ``placements``: a view (``narrow``) of each split dim."""
    sizes = tuple(mesh.shape)
    loc = local_shape(x.shape, placements, mesh)
    for d, mdims in enumerate(_blocks(x.shape, placements, mesh)):
        if not mdims:
            continue
        idx = 0
        for i in mdims:  # mixed radix, the first mesh dim most significant
            idx = idx * sizes[i] + int(coords[i])
        lo = idx * loc[d]
        if isinstance(x, torch.Tensor):
            x = x.narrow(d, lo, loc[d])
        else:
            x = np.take(x, np.arange(lo, lo + loc[d]), axis=d)
    return x


def shard_tree(params: dict, specs: dict, mesh,
               coords: Sequence[int]) -> dict:
    """Rank ``coords``' local shards of a flat tree (dotted names, as a
    ``state_dict``) under ``specs`` (the rule functions' output): CPU
    tensors for numpy leaves (JAX's parameters), views for tensors."""
    out = {}
    for name, leaf in params.items():
        block = shard_leaf(leaf, specs[name], mesh, coords)
        if not isinstance(block, torch.Tensor):
            block = torch.from_numpy(np.ascontiguousarray(block))
        out[name] = block
    return out


# ---------------------------------------------------------------------------
# LM transformer


def _divisible(dim: int, size: int) -> bool:
    return dim % size == 0 and dim >= size


def lm_param_dims(cfg, policy: ShardingPolicy, name: str,
                  shape: Sequence[int]) -> tuple:
    """JAX's per-dim entries of one LM parameter (the last component of
    its dotted name), its leading ``L`` dim dropped."""
    dp, tp = policy.dp, policy.tp
    dp_size, tp_size = policy.dp_size, policy.tp_size
    leaf = name.rsplit(".", 1)[-1]

    def dp_if(i: int):
        return dp if _divisible(shape[i], dp_size) else None

    def tp_if(i: int):
        return tp if _divisible(shape[i], tp_size) else None

    if leaf == "embed":  # [V, D]
        return (tp_if(0), dp_if(1))
    if leaf == "lm_head":  # [D, V]
        return (dp_if(0), tp_if(1))
    if leaf in ("wq", "wk", "wv"):  # [D, Hx*Dh]
        return (dp_if(0), tp_if(1))
    if leaf == "wo":  # [H*Dh, D]
        return (tp_if(0), dp_if(1))
    if leaf in ("bq", "bk", "bv"):  # [Hx*Dh]
        return (tp_if(0),)
    if leaf == "router":  # [D, E]
        return (dp_if(0), None)
    if leaf in ("w_gate", "w_up"):
        if len(shape) == 3:  # MoE [E, D, F]
            if policy.expert_parallel and _divisible(shape[0], tp_size):
                return (tp, dp_if(1), None)
            return (None, dp_if(1), tp_if(2))
        return (dp_if(0), tp_if(1))  # dense [D, F]
    if leaf == "w_down":
        if len(shape) == 3:  # MoE [E, F, D]
            if policy.expert_parallel and _divisible(shape[0], tp_size):
                return (tp, None, dp_if(2))
            return (None, tp_if(1), dp_if(2))
        return (tp_if(0), dp_if(1))  # dense [F, D]
    return (None,) * len(shape)  # norms / scalars: replicated


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def lm_param_specs(cfg, policy: ShardingPolicy, params_shape: dict) -> dict:
    """Placements of a TransformerLM's parameters, by dotted name
    (``params_shape``: name -> a tensor, array or shape)."""
    return {name: policy.placements(
        lm_param_dims(cfg, policy, name, _shape(leaf)))
        for name, leaf in params_shape.items()}


def lm_batch_dims(policy: ShardingPolicy) -> dict:
    dp = policy.dp
    return {"tokens": (dp, None), "targets": (dp, None),
            "loss_mask": (dp, None)}


def lm_batch_specs(policy: ShardingPolicy) -> dict:
    return {k: policy.placements(v)
            for k, v in lm_batch_dims(policy).items()}


def lm_cache_dims(policy: ShardingPolicy, batch: int, cache_len: int,
                  n_kv: int) -> dict:
    """KV cache [L, B, S, Hkv, Dh]: batch over dp when divisible (else the
    cache seq dim takes dp: long-context batch=1); the model axis shards
    kv heads when divisible, otherwise the cache seq dim (GQA head counts
    are usually < the TP degree: seq-shard rather than replicate)."""
    dp, tp = policy.dp, policy.tp
    head_ax = tp if n_kv % policy.tp_size == 0 else None
    if batch % policy.dp_size == 0:
        if head_ax is None and cache_len % policy.tp_size == 0:
            kv = (None, dp, tp, None, None)
        else:
            kv = (None, dp, None, head_ax, None)
    else:
        seq_axes: tuple = ()
        if cache_len % policy.dp_size == 0:
            seq_axes = dp
        if (head_ax is None
                and cache_len % (policy.dp_size * policy.tp_size) == 0):
            seq_axes = dp + (tp,)
            head_ax = None
        kv = (None, None, seq_axes or None, head_ax, None)
    return {"k": kv, "v": kv, "pos": (None, None)}


def lm_cache_specs(policy: ShardingPolicy, batch: int, cache_len: int,
                   n_kv: int) -> dict:
    return {k: policy.placements(v) for k, v in
            lm_cache_dims(policy, batch, cache_len, n_kv).items()}


# ---------------------------------------------------------------------------
# SchNet (edge-sharded message passing)


def gnn_param_specs(policy: ShardingPolicy, params_shape: dict) -> dict:
    return {name: policy.placements((None,) * len(_shape(leaf)))
            for name, leaf in params_shape.items()}


def gnn_batch_dims(policy: ShardingPolicy, batched: bool = False) -> dict:
    flat = policy.dp + (policy.tp,)
    if batched:  # [B, n, ...] molecule batches: shard graphs
        return {"node_feat": (flat, None, None), "senders": (flat, None),
                "receivers": (flat, None), "distances": (flat, None),
                "energy": (flat,)}
    # full-graph: shard the EDGE dimension over every axis; nodes replicated
    return {"node_feat": (None, None), "senders": (flat,),
            "receivers": (flat,), "distances": (flat,), "targets": (None,),
            "node_mask": (None,)}


def gnn_batch_specs(policy: ShardingPolicy, batched: bool = False) -> dict:
    return {k: policy.placements(v)
            for k, v in gnn_batch_dims(policy, batched).items()}


# ---------------------------------------------------------------------------
# RecSys (row-sharded embedding tables, batch-sharded activations)


REPLICATE_TABLE_BYTES = 256 * 1024 * 1024


def recsys_param_dims(policy: ShardingPolicy, name: str,
                      shape: Sequence[int], serving: bool = False) -> tuple:
    """SERVING replicates a table under ``REPLICATE_TABLE_BYTES`` (its
    lookups stay local); TRAINING row-shards every table whose rows
    divide the model axis (replicated tables all-reduce whole-table
    gradients).  A table is a leaf named ``table`` or ``item_table`` at
    any level (``fields.table``, ``linear.table``, ``item_table``)."""
    tp, tp_size = policy.tp, policy.tp_size
    if {"table", "item_table"} & set(name.split(".")):
        rows = shape[0]
        nbytes = int(np.prod(shape)) * 4
        shardable = rows % tp_size == 0
        if serving:
            if nbytes >= REPLICATE_TABLE_BYTES and shardable:
                return (tp, None)
            return (None, None)
        return (tp if shardable else None, None)
    return (None,) * len(shape)


def recsys_param_specs(policy: ShardingPolicy, params_shape: dict,
                       serving: bool = False) -> dict:
    return {name: policy.placements(
        recsys_param_dims(policy, name, _shape(leaf), serving))
        for name, leaf in params_shape.items()}


def recsys_batch_dims(policy: ShardingPolicy, keys: dict) -> dict:
    flat = policy.dp + (policy.tp,)  # recsys batches shard over ALL axes
    return {k: (flat, *([None] * (ndim - 1))) for k, ndim in keys.items()}


def recsys_batch_specs(policy: ShardingPolicy, keys: dict) -> dict:
    return {k: policy.placements(v)
            for k, v in recsys_batch_dims(policy, keys).items()}


def default_expert_parallel(cfg, tp_size: int) -> bool:
    """EP when experts divide the model axis and TP inside an expert would
    be skinny (< 128-wide d_ff shards)."""
    moe = getattr(cfg, "moe", None)
    return bool(moe and moe.num_experts % tp_size == 0
                and cfg.d_ff // tp_size < 128)
