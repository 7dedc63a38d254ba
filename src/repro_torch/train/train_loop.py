"""The train step and the host-side ``Trainer`` loop
(``repro.train.train_loop``), at world size 1.

A train state is ``{"params": {name: Parameter}, "opt_state": {"step",
"mu", "nu"}}`` where ``params`` are the module's own parameters
(``dict(model.named_parameters())``): the loss reads them, the step writes
them in place.  Two trainers that must start from the same state need two
modules, each given the values with :func:`copy_state`.

``make_train_step(loss_fn, adamw, microbatches)`` returns ``(state, batch)
-> (state, metrics)``: the numpy batch goes to the parameters' device, the
gradients of ``loss_fn(batch) -> (loss, aux)`` are taken with
``torch.autograd.grad`` (over ``microbatches`` contiguous splits of the
leading dim, f32 sums scaled by ``1 / microbatches``, the loss their mean),
and AdamW updates the state.  As in JAX, the metrics are ``loss``, ``lr``
and ``grad_norm``: the loss's own aux metrics are dropped.  The
data-parallel step (``make_ddp_train_step``) is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.train import optimizer as opt


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0

    def as_dict(self):
        return {"params": self.params, "opt_state": self.opt_state}


def init_state(params: dict, cfg: opt.AdamWConfig) -> TrainState:
    return TrainState(params=params, opt_state=opt.adamw_init(params))


@torch.no_grad()
def copy_state(dst, src) -> None:
    """Copy the leaves of the tree ``src`` (tensors or numpy arrays, e.g.
    a loaded checkpoint) into the same-named tensors of ``dst``, in
    place."""
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise KeyError(f"trees differ: {sorted(set(dst) ^ set(src))}")
        for k in dst:
            copy_state(dst[k], src[k])
        return
    dst.copy_(torch.as_tensor(src))


def state_from_jax(state: dict, params_from_jax: Callable) -> dict:
    """A JAX train state (``{"params", "opt_state": {"step", "mu",
    "nu"}}``, numpy leaves, e.g. a checkpoint nested by its keys) as the
    port's, each tree of the model's shape carried by the model family's
    ``params_from_jax``: CPU tensors, for :func:`copy_state`."""
    o = state["opt_state"]
    return {
        "params": params_from_jax(state["params"]),
        "opt_state": {"step": torch.as_tensor(np.asarray(o["step"])),
                      "mu": params_from_jax(o["mu"]),
                      "nu": params_from_jax(o["nu"])},
    }


def to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _accumulate_grads(loss_fn, params: dict, batch: dict, microbatches: int):
    """Mean loss, aux metrics and grads over ``microbatches`` splits of the
    leading dim (the aux metrics of one split only; ``{}`` otherwise)."""
    names = list(params)
    leaves = [params[k] for k in names]

    def grads_of(b):
        loss, metrics = loss_fn(b)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        gs = {k: torch.zeros_like(p) if g is None else g
              for k, p, g in zip(names, leaves, gs)}
        return loss.detach(), metrics, gs

    if microbatches <= 1:
        return grads_of(batch)

    def split(x, i):
        n = x.shape[0] // microbatches
        return x[i * n:(i + 1) * n]

    acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in params.items()}
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=leaves[0].device)
    for i in range(microbatches):
        loss, _metrics, gs = grads_of({k: split(v, i)
                                       for k, v in batch.items()})
        for k in names:
            acc[k] += gs[k].float()
        loss_sum = loss_sum + loss
    inv = 1.0 / microbatches
    return loss_sum * inv, {}, {k: g * inv for k, g in acc.items()}


def make_train_step(loss_fn: Callable, adamw: opt.AdamWConfig,
                    microbatches: int = 1):
    """(state, batch) -> (state, metrics); the state is updated in
    place."""
    schedule = opt.cosine_schedule(adamw)

    def train_step(state: dict, batch: dict):
        params = state["params"]
        device = next(iter(params.values())).device
        loss, _metrics, grads = _accumulate_grads(
            loss_fn, params, to_device(batch, device), microbatches)
        _, new_opt, ometrics = opt.adamw_update(
            grads, params, state["opt_state"], adamw, schedule)
        return ({"params": params, "opt_state": new_opt},
                {"loss": loss, **ometrics})

    return train_step


class Trainer:
    """Host-side loop: steps + checkpoint cadence + fault hooks."""

    def __init__(
        self,
        train_step: Callable,
        state: dict,
        data_iter,
        checkpointer=None,
        checkpoint_every: int = 100,
        supervisor=None,
        start_step: int = 0,
    ):
        self.train_step = train_step
        self.state = state
        self.data_iter = data_iter
        self.checkpointer = checkpointer
        self.checkpoint_every = checkpoint_every
        self.supervisor = supervisor
        self.step = start_step
        self.metrics_log: list[dict] = []

    def run(self, num_steps: int) -> list[dict]:
        for _ in range(num_steps):
            if self.supervisor is not None and self.supervisor.should_stop():
                self._checkpoint(final=True)
                break
            batch = next(self.data_iter)
            self.state, metrics = self.train_step(self.state, batch)
            self.step += 1
            if self.supervisor is not None:
                self.supervisor.heartbeat(self.step)
            metrics = {
                k: float(v) for k, v in metrics.items() if np.ndim(v) == 0
            }
            metrics["step"] = self.step
            self.metrics_log.append(metrics)
            if (
                self.checkpointer is not None
                and self.step % self.checkpoint_every == 0
            ):
                self._checkpoint()
        return self.metrics_log

    def _checkpoint(self, final: bool = False):
        if self.checkpointer is not None:
            self.checkpointer.save(self.step, self.state, blocking=final)
