"""Int8 gradient compression with error feedback
(``repro.train.grad_compress``), over ``torch.distributed``.

The data-parallel all-reduce payload drops 4x (f32 -> int8, carried as
int32 so the sum cannot overflow, + one f32 scale per leaf).  Error
feedback keeps each rank's quantisation residual and adds it to the next
step's gradient (Karimireddy et al. 2019).

The arithmetic is JAX's, operation for operation, in f32: the scale
``max(max |g| over the ranks, 1e-12) / 127``, ``q = clip(round(g /
scale), -127, 127)`` (``torch.round`` and ``jnp.round`` both round half to
even), the reduced gradient ``sum_r q_r * scale / world``, the error ``g -
q * scale`` rounded once (XLA fuses it into a multiply-add); identical
inputs give identical bits.  Where JAX reduces leaf
by leaf (a ``pmax`` and a ``psum`` each), the port packs every leaf's max
into one f32 vector and every payload into one int32 buffer: two
collectives a step, and the same sums.  ``group=None`` with no process
group initialised is world size 1 (nothing to reduce).
"""
from __future__ import annotations

import torch

Tree = dict  # name -> Tensor


def quantize_leaf(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 quantisation, rounding half to even."""
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _grouped(group) -> bool:
    """Whether ``group`` names a process group (``None``: the default one,
    if initialised)."""
    import torch.distributed as dist

    return group is not None or (dist.is_available()
                                 and dist.is_initialized())


def world_size(group=None) -> int:
    """Ranks in ``group``; 1 with ``group=None`` and no process group."""
    import torch.distributed as dist

    return dist.get_world_size(group) if _grouped(group) else 1


def all_reduce(t: torch.Tensor, op: str, group=None) -> torch.Tensor:
    """``t`` reduced in place over ``group`` by ``op`` (``"sum"`` or
    ``"max"``); unchanged with ``group=None`` and no process group."""
    import torch.distributed as dist

    if _grouped(group):
        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
        dist.all_reduce(t, op=ops[op], group=group)
    return t


def _residual(g: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """``g - q * scale`` rounded once to f32, as XLA computes JAX's ``g32 -
    dequantize_leaf(q, scale)`` (a fused multiply-add).  In f64 the
    product (7 by 24 bits) and the difference (of two numbers within half
    a quantum of each other) are exact, so one rounding remains."""
    return (g.double() - q.double() * scale.double()).float()


def compressed_psum(grads: Tree, group=None, error_buf: Tree | None = None):
    """Quantised all-reduce of the gradients ``{name: tensor}`` over
    ``group`` -> (the mean over the ranks, the new error buffer).
    ``error_buf=None`` disables error feedback (first step or stateless
    use)."""
    names = list(grads)
    g32 = {k: grads[k].to(torch.float32) for k in names}
    if error_buf is not None:
        g32 = {k: g32[k] + error_buf[k] for k in names}
    maxes = torch.stack([torch.max(torch.abs(g32[k])) for k in names])
    all_reduce(maxes, "max", group)
    scales = torch.clamp(maxes, min=1e-12) / 127.0
    qs = [quantize_leaf(g32[k], scales[i]) for i, k in enumerate(names)]
    total = all_reduce(torch.cat([q.reshape(-1).to(torch.int32)
                                  for q in qs]), "sum", group)
    n = float(world_size(group))
    reduced, errors, start = {}, {}, 0
    for i, k in enumerate(names):
        size = qs[i].numel()
        part = total[start:start + size].view(qs[i].shape)
        reduced[k] = part.to(torch.float32) * scales[i] / n
        errors[k] = _residual(g32[k], qs[i], scales[i])
        start += size
    return reduced, errors


def compression_ratio(grads: Tree) -> float:
    """Payload ratio f32-allreduce : int8-allreduce (analytic)."""
    f32 = sum(g.numel() * 4 for g in grads.values())
    i8 = sum(g.numel() * 1 + 4 for g in grads.values())
    return f32 / max(i8, 1)
