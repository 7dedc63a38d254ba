"""The train step and the host-side ``Trainer`` loop
(``repro.train.train_loop``).

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
and ``grad_norm``: the loss's own aux metrics are dropped.

``make_ddp_train_step`` is the data-parallel step over a
``torch.distributed`` process group: each rank holds a full replica and
its own rows of the batch, and the gradients and the loss are averaged
over the ranks (optionally as int8, :mod:`repro_torch.train.grad_compress`)
before the same AdamW update runs on every rank.

``make_sharded_train_step(loss_fn, adamw, plan, microbatches)`` is JAX's
``make_train_step`` run on a state laid out by a sharding policy
(``sharding.policies``; the ``plan`` a model's ``train_plan()``): each
rank holds its blocks of the parameters and moments and its share of the
batch (``policies.shard_batch``, in JAX's microbatch order).  The loss is
the whole batch's on every rank (the model's collectives have their
backwards, ``sharding.ctx``), each leaf's gradient is SUMmed over the
axes the plan names (where the rank's is a partial sum: a leaf
replicated over ranks that saw different rows, edges or tokens), the
clipping norm is the whole gradient's (``optimizer.sharded_global_norm``)
and AdamW updates each rank's blocks in place.  It raises without a
process group of the mesh's size: there is no fallback to an unsharded
step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.sharding import ctx
from repro_torch.sharding import policies as pol
from repro_torch.train import optimizer as opt
from repro_torch.train.grad_compress import (
    all_reduce, compressed_psum, world_size,
)


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


def state_to_jax(state: dict, params_to_jax: Callable) -> dict:
    """The inverse of :func:`state_from_jax`: a port train state (tensors
    or numpy leaves) as the JAX one, numpy leaves, each tree of the model's
    shape carried by the model family's ``params_to_jax``."""
    o = state["opt_state"]
    step = o["step"]
    return {
        "params": params_to_jax(state["params"]),
        "opt_state": {"step": np.array(step.cpu() if torch.is_tensor(step)
                                       else step),
                      "mu": params_to_jax(o["mu"]),
                      "nu": params_to_jax(o["nu"])},
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


@torch.no_grad()
def sum_partials(grads: dict, partial: dict) -> dict:
    """Each leaf SUMmed over the mesh axes ``partial[name]`` names (within
    the policy's axes): the leaves of one set of axes packed in a flat f32
    buffer, one all-reduce a set, the sets in the same order on every
    rank."""
    out = dict(grads)
    by_axes: dict = {}
    for name in grads:
        if partial[name]:
            by_axes.setdefault(tuple(partial[name]), []).append(name)
    for axes in sorted(by_axes):
        names = by_axes[axes]
        flat = ctx.all_reduce_sum(torch.cat([grads[k].float().reshape(-1)
                                             for k in names]), axes)
        start = 0
        for k in names:
            size = grads[k].numel()
            out[k] = flat[start:start + size].view(grads[k].shape)
            start += size
    return out


def sharded_grads(loss_fn: Callable, plan: pol.TrainPlan, params: dict,
                  batch: dict, microbatches: int = 1):
    """-> (the whole batch's mean loss, this rank's blocks of the whole
    gradient): the sharded step's gradient, before AdamW.  Raises without
    a process group of the mesh's size."""
    policy = plan.policy
    device = next(iter(params.values())).device
    pol.rank_coords(policy, device)  # raises without a matching group
    with ctx.axes(policy.mesh, policy.dp, policy.tp):
        loss, _metrics, grads = _accumulate_grads(
            loss_fn, params, to_device(batch, device), microbatches)
        return loss, sum_partials(grads, plan.partial)


def make_sharded_train_step(loss_fn: Callable, adamw: opt.AdamWConfig,
                            plan: pol.TrainPlan, microbatches: int = 1):
    """(state, batch) -> (state, metrics) under ``plan.policy``: the state
    is this rank's shards (``dict(model.named_parameters())`` of the
    sharded model, ``adamw_init`` of them), ``batch`` this rank's share in
    JAX's microbatch order; the state is updated in place.  Raises without
    a process group of the mesh's size (a ``policies.AbstractMesh``
    steps ``meta`` tensors alone)."""
    schedule = opt.cosine_schedule(adamw)
    policy = plan.policy

    def norm(grads):
        return opt.sharded_global_norm(grads, plan.specs, policy.mesh)

    def train_step(state: dict, batch: dict):
        params = state["params"]
        loss, grads = sharded_grads(loss_fn, plan, params, batch,
                                    microbatches)
        with ctx.axes(policy.mesh, policy.dp, policy.tp):
            _, new_opt, ometrics = opt.adamw_update(
                grads, params, state["opt_state"], adamw, schedule, norm)
        return ({"params": params, "opt_state": new_opt},
                {"loss": loss, **ometrics})

    train_step.plan = plan  # which policy and plan a step runs under
    return train_step


def _pmean(tree: dict, group) -> dict:
    """The mean of each leaf over ``group``'s ranks: one SUM all-reduce of
    the leaves packed in a flat f32 buffer, then / world size (JAX's
    ``pmean``)."""
    names = list(tree)
    flat = all_reduce(torch.cat([tree[k].float().reshape(-1)
                                 for k in names]), "sum", group)
    n = float(world_size(group))
    out, start = {}, 0
    for k in names:
        size = tree[k].numel()
        out[k] = flat[start:start + size].view(tree[k].shape) / n
        start += size
    return out


def make_ddp_train_step(loss_fn: Callable, adamw: opt.AdamWConfig,
                        group=None, compress: bool = False,
                        microbatches: int = 1):
    """(state, batch) -> (state, metrics), the data-parallel step
    (``repro.train.train_loop.make_ddp_train_step``) over the process
    group ``group`` (``None``: the default group, or world size 1 when
    none is initialised).  The process group takes the place of JAX's
    ``mesh``, ``dp_axes``, ``param_specs`` and ``batch_specs``: every rank
    holds the whole state, and ``batch`` is this rank's own rows.

    The gradients of the local rows are averaged over the ranks, as f32
    (``pmean``: a SUM all-reduce / world size) or, with ``compress``, as
    int8 through :func:`compressed_psum`, whose error buffer rides in the
    state as ``state["err_buf"]`` (absent or ``None``: no feedback on the
    first step).  The loss is averaged the same way; then every rank runs
    the same AdamW update.  The state is updated in place."""
    schedule = opt.cosine_schedule(adamw)

    def train_step(state: dict, batch: dict):
        params = state["params"]
        device = next(iter(params.values())).device
        loss, _metrics, grads = _accumulate_grads(
            loss_fn, params, to_device(batch, device), microbatches)
        if compress:
            grads, err = compressed_psum(grads, group, state.get("err_buf"))
            state = dict(state, err_buf=err)
        else:
            grads = _pmean(grads, group)
        loss = _pmean({"loss": loss}, group)["loss"]
        _, new_opt, ometrics = opt.adamw_update(
            grads, params, state["opt_state"], adamw, schedule)
        return (dict(state, params=params, opt_state=new_opt),
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
