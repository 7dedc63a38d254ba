"""Ambient sharding context and the collectives of the sharded paths
(``repro.sharding.ctx``).

The launchers and the sharded models set the policy's axes
(:func:`axes`, :func:`with_axes`); with none set (unit tests, one
device) every function here is a no-op, so model code never depends on
distribution state.

JAX pins activation layouts with ``constrain`` and lets the SPMD
partitioner place the collectives.  The port computes on each rank's
local tensors and issues its collectives itself, through the few
functions below, over the process group of a mesh axis (or of several:
the whole mesh): :func:`all_reduce_sum`, :func:`all_reduce_max` and
:func:`gather` (the list ``dist.all_gather``, concatenated).  Gloo
carries all three for CUDA tensors, so the tensor- and expert-parallel
paths run on two ranks sharing one card.  :func:`constrain` keeps JAX's
call sites' signature and returns its input: a local shard's layout is
the one its collectives give it.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch

_STATE = threading.local()


def set_axes(mesh, dp_axes: tuple, tp_axis: str,
             batch_axes: Optional[tuple] = None) -> None:
    _STATE.ctx = (mesh, tuple(dp_axes), tp_axis,
                  tuple(batch_axes) if batch_axes else tuple(dp_axes))


def clear_axes() -> None:
    _STATE.ctx = None


def get_axes():
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def axes(mesh, dp_axes: tuple, tp_axis: str,
         batch_axes: Optional[tuple] = None):
    prev = get_axes()
    set_axes(mesh, dp_axes, tp_axis, batch_axes)
    try:
        yield
    finally:
        _STATE.ctx = prev


def with_axes(policy, fn, batch_axes: Optional[tuple] = None):
    """Wrap ``fn`` so the policy's axes are active while it runs."""

    def wrapped(*args, **kwargs):
        with axes(policy.mesh, policy.dp, policy.tp, batch_axes):
            return fn(*args, **kwargs)

    return wrapped


def constrain(x, *logical):
    """JAX's activation constraint (entries "batch", "dp", "tp", None):
    ``x`` itself, with or without an active policy."""
    return x


def constrain_leading(x):
    """JAX's constraint of the leading (batch) dim: ``x`` itself."""
    return x


# ---------------------------------------------------------------------------
# Collectives over mesh axes


def _axes_of(which) -> tuple:
    ctx = get_axes()
    if ctx is None:
        return ()
    mesh, dp, tp, _ = ctx
    named = {"model": (tp,), "data": dp, "all": tuple(mesh.mesh_dim_names)}
    return named.get(which, which if isinstance(which, tuple) else (which,))


def group_size(which="model") -> int:
    ctx = get_axes()
    if ctx is None:
        return 1
    sizes = dict(zip(ctx[0].mesh_dim_names, tuple(ctx[0].shape)))
    return math.prod(sizes[a] for a in _axes_of(which))


def group_index(which="model") -> int:
    """This rank's place among the ranks of ``which``'s axes (mesh
    order, the first axis most significant)."""
    ctx = get_axes()
    if ctx is None:
        return 0
    mesh = ctx[0]
    coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    idx = 0
    for a in mesh.mesh_dim_names:
        if a in _axes_of(which):
            idx = idx * sizes[a] + coords[a]
    return idx


def _group(which):
    """The process group of ``which``'s axes: one axis's, or the default
    group for the whole mesh (whose ranks are 0..n-1 in mesh order)."""
    mesh = get_axes()[0]
    ax = _axes_of(which)
    if len(ax) == 1:
        return mesh.get_group(ax[0])
    if set(ax) == set(mesh.mesh_dim_names):
        return None
    raise NotImplementedError(f"a group over the axes {ax} of "
                              f"{tuple(mesh.mesh_dim_names)}")


@contextlib.contextmanager
def recording():
    """Count the collectives issued meanwhile (on ``meta`` too): yields
    ``{kind: [output bytes, calls]}`` for "all-reduce" and "all-gather"."""
    prev = getattr(_STATE, "rec", None)
    _STATE.rec = {"all-reduce": [0, 0], "all-gather": [0, 0]}
    try:
        yield _STATE.rec
    finally:
        _STATE.rec = prev


def _note(kind: str, nbytes: int) -> None:
    rec = getattr(_STATE, "rec", None)
    if rec is not None:
        rec[kind][0] += nbytes
        rec[kind][1] += 1


def all_reduce_sum(x: torch.Tensor, which="model") -> torch.Tensor:
    """The SUM of ``x`` over the ranks of ``which`` (in place; returned;
    nothing moves for a ``meta`` tensor, which holds no values)."""
    if group_size(which) > 1:
        _note("all-reduce", x.numel() * x.element_size())
    if group_size(which) > 1 and not x.is_meta:
        import torch.distributed as dist

        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=_group(which))
    return x


def all_reduce_max(x: torch.Tensor, which="model") -> torch.Tensor:
    """The MAX of ``x`` over the ranks of ``which`` (in place; returned)."""
    if group_size(which) > 1:
        _note("all-reduce", x.numel() * x.element_size())
    if group_size(which) > 1 and not x.is_meta:
        import torch.distributed as dist

        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=_group(which))
    return x


def gather(x: torch.Tensor, dim: int, which="model") -> torch.Tensor:
    """The blocks of ``x`` of the ranks of ``which`` concatenated along
    ``dim`` in rank order: the list ``dist.all_gather`` into the leading
    blocks of one buffer, returned as a view with ``dim`` in its place
    (nothing moves for a ``meta`` tensor)."""
    n = group_size(which)
    if n == 1:
        return x
    import torch.distributed as dist

    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    _note("all-gather", out.numel() * out.element_size())
    if not x.is_meta:
        dist.all_gather(list(out.chunk(n)), x, group=_group(which))
    return out.movedim(0, dim)
