"""Ambient sharding context and the collectives of the sharded paths
(``repro.sharding.ctx``).

The launchers and the sharded models set the policy's axes
(:func:`axes`, :func:`with_axes`); with none set (unit tests, one
device) every function here is a no-op, so model code never depends on
distribution state.

JAX pins activation layouts with ``constrain`` and lets the SPMD
partitioner place the collectives, and their transposes in the backward.
The port computes on each rank's local tensors and issues its collectives
itself, through the functions below, over the process group of a mesh
axis (or of several: the whole mesh).  :func:`constrain` keeps JAX's call
sites' signature and returns its input: a local shard's layout is the one
its collectives give it.

A collective's backward depends on what follows it, which GSPMD works out
and the port writes down: is the next computation the same on every rank
of the group (**replicated**) or does each rank compute its own part
(**distinct**)?  Under autograd (grad enabled, an input that requires
grad) each function is a ``torch.autograd.Function`` with the backward
its case needs:

- :func:`all_reduce_sum`: a SUM of the ranks' partials, then replicated
  use (a row-parallel ``wo``/``w_down``, the experts, the vocabulary-
  parallel embedding, SchNet's messages, a global loss).  Backward:
  identity.  (``torch.distributed.nn.functional.all_reduce``'s backward
  is an all-reduce, which is wrong here.)
- :func:`all_reduce_stat`: a SUM that each rank then uses on its own rows
  (DIN's Dice statistics over a split batch): :func:`enter_split`, then
  :func:`all_reduce_sum`.  Backward: a SUM.
- :func:`enter_split`: a replicated value entering a computation that
  differs by rank (the input of a column-parallel product, SchNet's node
  states gathered over a rank's edges).  Forward: identity; backward: a
  SUM.
- :func:`gather`: shards gathered, then used by each rank on its own
  rows, heads or columns (FSDP's weights over the data axis, split heads'
  weights, the sequence before a column-parallel entry).  Backward: a
  reduce-scatter (SUM).
- :func:`gather_out`: outputs gathered, then used replicated.  Backward:
  the rank's own block, no sum.
- :func:`reduce_scatter`: a SUM of which each rank keeps its block (the
  row-parallel exit under sequence parallelism, a row-sharded table's bag
  sums in training).  Backward: an all-gather.

Sums run in f32 whatever the dtype.  Without autograd (serving, under
``torch.inference_mode``) the all-reduces run in place and the gathers
are the list ``dist.all_gather`` into one buffer, as before.  Gloo
carries every one of them for CUDA tensors, so the tensor- and expert-
parallel paths run on two ranks sharing one card.  A collective's group
is resolved when its forward runs, so its backward needs no active axes
(autograd runs a CUDA backward on a thread of its own); :func:`recording`
counts the collectives of every thread.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional

import torch

_STATE = threading.local()
_RECORDS: list = []  # active recordings, innermost last (every thread's)


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
# Groups of mesh axes


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


@dataclasses.dataclass(frozen=True)
class Group:
    """The ranks of some mesh axes as one collective sees them: their
    count, this rank's place among them and the process group (resolved
    when a transfer needs it: a ``meta`` tensor moves nothing)."""

    size: int
    index: int
    mesh: object = None
    axes: tuple = ()

    def process_group(self):
        if set(self.axes) == set(self.mesh.mesh_dim_names):
            return None  # the default group: ranks 0..n-1 in mesh order
        if len(self.axes) == 1:
            return self.mesh.get_group(self.axes[0])
        raise NotImplementedError(f"a group over the axes {self.axes} of "
                                  f"{tuple(self.mesh.mesh_dim_names)}")


def group(which="model") -> Group:
    """The group of ``which`` (``"model"``, ``"data"``, ``"all"``, an axis
    name or a tuple of them) under the active axes (size 1 without)."""
    ctx = get_axes()
    if ctx is None:
        return Group(1, 0)
    return Group(group_size(which), group_index(which), ctx[0],
                 _axes_of(which))


@contextlib.contextmanager
def recording():
    """Count the collectives issued meanwhile, forward and backward, on
    any thread (on ``meta`` too): yields ``{kind: [output bytes, calls]}``
    for "all-reduce", "all-gather" and "reduce-scatter"."""
    rec = {"all-reduce": [0, 0], "all-gather": [0, 0],
           "reduce-scatter": [0, 0]}
    _RECORDS.append(rec)
    try:
        yield rec
    finally:
        _RECORDS[:] = [r for r in _RECORDS if r is not rec]


def _note(kind: str, out: torch.Tensor) -> None:
    if _RECORDS:
        rec = _RECORDS[-1]
        rec[kind][0] += out.numel() * out.element_size()
        rec[kind][1] += 1


# ---------------------------------------------------------------------------
# The transfers (no autograd), over a Group of more than one rank


def _all_reduce(x: torch.Tensor, g: Group, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``g`` in place (nothing moves on ``meta``)."""
    _note("all-reduce", x)
    if not x.is_meta:
        import torch.distributed as dist

        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
        dist.all_reduce(x, op=ops[op], group=g.process_group())
    return x


def _all_gather(x: torch.Tensor, dim: int, g: Group) -> torch.Tensor:
    """The ranks' blocks concatenated along ``dim`` in rank order: the
    list ``dist.all_gather`` into the leading blocks of one buffer,
    returned as a view with ``dim`` in its place."""
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((g.size * x.shape[0], *x.shape[1:]))
    _note("all-gather", out)
    if not x.is_meta:
        import torch.distributed as dist

        dist.all_gather(list(out.chunk(g.size)), x,
                        group=g.process_group())
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, g: Group) -> torch.Tensor:
    """This rank's block along ``dim`` of the SUM of the ranks' ``x``, in
    f32, returned in ``x``'s dtype."""
    src = x.movedim(dim, 0).float().contiguous()
    if src.shape[0] % g.size:
        raise ValueError(f"dim {src.shape[0]} does not split into "
                         f"{g.size} blocks")
    out = src.new_empty((src.shape[0] // g.size, *src.shape[1:]))
    _note("reduce-scatter", out)
    if not src.is_meta:
        import torch.distributed as dist

        dist.reduce_scatter_tensor(out, src, group=g.process_group())
    return out.to(x.dtype).movedim(0, dim)


def _block(x: torch.Tensor, dim: int, g: Group) -> torch.Tensor:
    n = x.shape[dim] // g.size
    return x.narrow(dim, g.index * n, n)


# ---------------------------------------------------------------------------
# The autograd functions (one case each; see the module docstring)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return _all_reduce(x.clone(), g)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _EnterSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        summed = _all_reduce(dy.to(torch.float32, copy=True), ctx.g)
        return summed.to(dy.dtype), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, g, summed):
        ctx.dim, ctx.g, ctx.summed = dim, g, summed
        return _all_gather(x, dim, g)

    @staticmethod
    def backward(ctx, dy):
        if ctx.summed:
            dx = _reduce_scatter(dy, ctx.dim, ctx.g)
        else:
            dx = _block(dy, ctx.dim, ctx.g)
        return dx, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, g):
        ctx.dim, ctx.g = dim, g
        return _reduce_scatter(x, dim, g)

    @staticmethod
    def backward(ctx, dy):
        return _all_gather(dy, ctx.dim, ctx.g), None, None


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


# ---------------------------------------------------------------------------
# Public collectives over mesh axes


def all_reduce_sum(x: torch.Tensor, which="model") -> torch.Tensor:
    """The SUM of ``x`` over the ranks of ``which``, then used replicated:
    under autograd a new tensor whose backward is the identity, else
    ``x`` reduced in place and returned."""
    g = group(which)
    if g.size == 1:
        return x
    if _tracked(x):
        return _AllReduceSum.apply(x, g)
    return _all_reduce(x, g)


def all_reduce_stat(x: torch.Tensor, which="model") -> torch.Tensor:
    """The SUM of ``x`` over the ranks of ``which``, a statistic that each
    rank then uses on its own rows: :func:`all_reduce_sum` of ``x``
    entering a split computation (:func:`enter_split`), so that the
    backward SUMs the ranks' gradients (in place without autograd)."""
    return all_reduce_sum(enter_split(x, which), which)


def all_reduce_max(x: torch.Tensor, which="model") -> torch.Tensor:
    """The MAX of ``x`` over the ranks of ``which`` (in place; returned;
    no gradient: callers pass a detached ``x``)."""
    g = group(which)
    if g.size == 1:
        return x
    return _all_reduce(x, g, "max")


def enter_split(x: torch.Tensor, which="model") -> torch.Tensor:
    """``x``, replicated over the ranks of ``which``, entering a
    computation that differs by rank: itself, whose gradient the backward
    SUMs over the ranks (``x`` unchanged without autograd)."""
    g = group(which)
    if g.size == 1 or not _tracked(x):
        return x
    return _EnterSplit.apply(x, g)


def gather(x: torch.Tensor, dim: int, which="model") -> torch.Tensor:
    """The blocks of ``x`` of the ranks of ``which`` concatenated along
    ``dim`` in rank order, which each rank then uses on its own part:
    the backward reduce-scatters (SUM) the gradient.  Without autograd
    the list ``dist.all_gather`` into one buffer (nothing moves for a
    ``meta`` tensor)."""
    g = group(which)
    if g.size == 1:
        return x
    if _tracked(x):
        return _Gather.apply(x, dim, g, True)
    return _all_gather(x, dim, g)


def gather_out(x: torch.Tensor, dim: int, which="model") -> torch.Tensor:
    """As :func:`gather`, for outputs then used replicated (the same on
    every rank): the backward keeps the rank's own block of the
    gradient."""
    g = group(which)
    if g.size == 1:
        return x
    if _tracked(x):
        return _Gather.apply(x, dim, g, False)
    return _all_gather(x, dim, g)


def reduce_scatter(x: torch.Tensor, dim: int, which="model") -> torch.Tensor:
    """This rank's block along ``dim`` of the SUM over the ranks of
    ``which`` (in f32, returned in ``x``'s dtype); the backward gathers
    the ranks' gradients."""
    g = group(which)
    if g.size == 1:
        return x
    if _tracked(x):
        return _ReduceScatter.apply(x, dim, g)
    return _reduce_scatter(x, dim, g)
