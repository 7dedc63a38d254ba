"""AdamW, the cosine schedule and global-norm clipping
(``repro.train.optimizer``), as plain functions over a ``dict[str,
Tensor]`` keyed by a module's parameter names.

The arithmetic is the JAX package's, operation for operation: the
learning rate ``schedule(step + 1)`` and the bias corrections ``1 - b **
step`` in f32 on the parameters' device, clipping by ``min(1, clip /
max(norm, 1e-12))``, ``u = mhat / (sqrt(vhat) + eps)``, ``+ weight_decay *
p`` where :func:`decay_mask` says so, then ``p - lr * u``.
``torch.optim.AdamW`` orders these differently (it decays ``p`` before the
step) and schedules in f64, so it is not used.  :func:`adamw_update`
writes the new parameters and moments into the given tensors, in place,
under ``torch.no_grad()``; the JAX function returns new trees.

Over shards (the sharded train step) AdamW runs as it is on each rank's
blocks, elementwise, with the step counter replicated; only the norm
that clipping reads is a collective: :func:`sharded_global_norm`, JAX's
norm of the whole gradient.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

Tree = dict  # name -> Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def cosine_schedule(cfg: AdamWConfig) -> Callable[[torch.Tensor],
                                                  torch.Tensor]:
    """step (an int tensor, or an int) -> the f32 learning rate: linear
    warm-up over ``warmup_steps``, then a cosine down to ``min_lr_frac``
    of ``lr`` at ``total_steps``."""
    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        t = torch.clamp(
            (step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1),
            0.0, 1.0,
        )
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
        return cfg.lr * warm * frac

    return lr


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (0-dim)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def sharded_global_norm(tree: Tree, specs: dict, mesh) -> torch.Tensor:
    """The global norm of a gradient held in shards (each leaf this rank's
    block under ``specs[name]``, as on every rank that holds the same
    block): the leaves' local squares summed by the mesh axes that split
    them, each such sum all-reduced over those axes, so that every
    distinct block counts once and a replicated leaf once, then the
    sums added.  Within the policy's axes (``sharding.ctx``); with
    nothing split it is :func:`global_norm`, operation for operation."""
    from repro_torch.sharding import ctx
    from repro_torch.sharding.policies import sharded_axes

    by_axes: dict = {}
    for name, g in tree.items():
        by_axes.setdefault(sharded_axes(specs[name], mesh), []).append(g)
    total = 0
    for axes in sorted(by_axes):  # the same order on every rank
        part = sum(torch.sum(torch.square(x.float())) for x in by_axes[axes])
        total = total + (ctx.all_reduce_sum(part, axes) if axes else part)
    return torch.sqrt(total)


def clip_by_global_norm(tree: Tree, max_norm: float,
                        norm_fn: Callable = global_norm):
    """-> (the leaves scaled by min(1, max_norm / max(norm, 1e-12)), norm);
    the given leaves are left as they are."""
    norm = norm_fn(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: g * scale for k, g in tree.items()}, norm


def decay_mask(name: str) -> bool:
    """Whether AdamW decays the parameter ``name`` (a dotted
    ``state_dict`` name): the JAX ``_decay_mask`` of the last key of its
    path.  Norms and biases are not decayed.  A list index (``cin.0``) has
    no key in JAX, so it reads ``""`` and decays; embedding tables decay
    too (the JAX docstring says they do not; its code decays them)."""
    last = name.rsplit(".", 1)[-1]
    if last.isdigit():
        last = ""
    if last.startswith(("ln", "b_", "bias")) or last in (
        "b", "bq", "bk", "bv", "q_norm", "k_norm", "ln_f", "embed_bias",
        "mlm_bias",
    ):
        return False
    return True


def adamw_init(params: Tree) -> dict:
    """``{"step": int32 0, "mu": zeros, "nu": zeros}``, f32 moments on
    each parameter's device."""
    first = next(iter(params.values()))
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
        "mu": {k: zeros(p) for k, p in params.items()},
        "nu": {k: zeros(p) for k, p in params.items()},
    }


@torch.no_grad()
def adamw_update(grads: Tree, params: Tree, state: dict, cfg: AdamWConfig,
                 schedule: Optional[Callable] = None,
                 norm_fn: Callable = global_norm):
    """One AdamW step -> (params, state, ``{"lr", "grad_norm"}``).
    ``params``, ``state["mu"]``, ``state["nu"]`` and ``state["step"]`` are
    updated in place and returned; ``grads`` is read only.  ``norm_fn``:
    the gradient's global norm (:func:`sharded_global_norm` over
    shards)."""
    schedule = schedule or cosine_schedule(cfg)
    step = state["step"] + 1
    lr = schedule(step)
    grads = {k: g.float() for k, g in grads.items()}
    if cfg.clip_norm:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, norm_fn)
    else:
        gnorm = norm_fn(grads)

    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())
    for name, p in params.items():
        g = grads[name]
        m, v = state["mu"][name], state["nu"][name]
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay and decay_mask(name):
            u = u + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))
    state["step"].copy_(step)
    return params, state, {"lr": lr, "grad_norm": gnorm}
