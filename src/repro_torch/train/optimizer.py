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


def clip_by_global_norm(tree: Tree, max_norm: float):
    """-> (the leaves scaled by min(1, max_norm / max(norm, 1e-12)), norm);
    the given leaves are left as they are."""
    norm = global_norm(tree)
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
                 schedule: Optional[Callable] = None):
    """One AdamW step -> (params, state, ``{"lr", "grad_norm"}``).
    ``params``, ``state["mu"]``, ``state["nu"]`` and ``state["step"]`` are
    updated in place and returned; ``grads`` is read only."""
    schedule = schedule or cosine_schedule(cfg)
    step = state["step"] + 1
    lr = schedule(step)
    grads = {k: g.float() for k, g in grads.items()}
    if cfg.clip_norm:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)

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
