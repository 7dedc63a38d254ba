"""Atomic, asynchronous checkpoints of a train state
(``repro.checkpoint.checkpoint``), at world size 1.

The JAX package's on-disk layout and key space: ``<dir>/step_<N>/
arrays_host0.npz`` (the JAX tree's leaves under their ``/``-joined key
paths) and ``manifest.json`` (``step``, ``keys``, ``process_count``,
``format: 1``), written into ``step_<N>.tmp`` and then renamed, so a
preemption mid-write never corrupts the latest checkpoint.

A port train state (``{"params": {name: tensor}, "opt_state": {"step",
"mu", "nu"}}``, ``name`` a ``state_dict`` name) is written as the JAX
state it stands for: each tree of ``state_dict`` names is nested by its
dots, with the layers JAX stacks for ``scan`` restacked: an LM's
``blocks.<i>.<leaf>`` into ``blocks/<leaf>`` [L, ...], SchNet's
``interactions.<i>.<leaf>`` into ``interactions/<leaf>`` [n_int, ...]
(``utils.stack_layers``), so the keys are ``params/blocks/attn/wq``,
``opt_state/step``, ``opt_state/mu/embed``, ... and ``repro.checkpoint.
load_latest`` opens a port directory.  Loading goes the other way
(``utils.unstack_layers``), so the port opens a JAX directory.  The one
pair serves every family: a recsys model stacks nothing, and its list
items (``cin.0.w``) are written under the same ``/``-joined paths
(``cin/0/w``) as JAX's key paths name them.

``save`` copies every leaf to host memory before it returns, so the next
step may overwrite the live tensors while the writer thread works: on the
CPU ``t.cpu()`` and ``t.numpy()`` share the live tensor's memory, so the
copy is explicit.  ``reshard`` places a host tree on this rank's device:
under data parallelism every rank takes the whole tree, where JAX places
it on a mesh under its specs.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.train.train_loop import state_from_jax, state_to_jax
from repro_torch.utils import (
    nest, resolve_device, stack_layers, unstack_layers,
)

# The subtrees JAX stacks [L, ...] for ``scan``: an LM's and SchNet's.
STACKED = ("blocks", "interactions")


def _host_copy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _flatten(tree, prefix: str = "") -> dict[str, Any]:
    """Leaves under their ``/``-joined key paths (list items by index, as
    JAX's key paths name them)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _like(template, tree):
    """The tree of ``template`` with each leaf taken from ``tree`` (same
    keys): a new tensor of the template leaf's dtype on its device."""
    if isinstance(template, dict):
        return {k: _like(v, tree[k]) for k, v in template.items()}
    arr = torch.as_tensor(tree)
    if isinstance(template, torch.Tensor):
        arr = arr.to(device=template.device, dtype=template.dtype)
    return arr


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._queue: queue.Queue = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self.async_write = async_write

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Any, blocking: bool = False) -> None:
        # Copy to host BEFORE handing to the writer thread: the next step
        # overwrites the live tensors in place.
        host = nest({k: _host_copy(v) for k, v in _flatten(state).items()},
                    sep="/")
        host_state = _flatten(state_to_jax(
            host, lambda tree: stack_layers(tree, STACKED)))
        if self.async_write and not blocking:
            self._ensure_worker()
            self._queue.put((step, host_state))
        else:
            self._write(step, host_state)

    def _ensure_worker(self):
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    def _drain(self):
        while True:
            try:
                step, state = self._queue.get(timeout=1.0)
            except queue.Empty:
                return
            self._write(step, state)
            self._queue.task_done()

    def wait(self):
        if self._worker is not None and self._worker.is_alive():
            self._queue.join()

    def _write(self, step: int, flat: dict[str, np.ndarray]) -> None:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays_host0.npz"), **flat)
        manifest = {
            "step": step,
            "keys": sorted(flat.keys()),
            "process_count": 1,  # world size 1: one host writes it all
            "format": 1,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.list_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s:08d}"),
                ignore_errors=True,
            )

    # -- load ---------------------------------------------------------------
    def list_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def load(self, step: int, template: Any) -> Any:
        """The checkpoint of ``step`` (the port's or the JAX package's) as
        a new port train state shaped like ``template``, each leaf a tensor
        of the template leaf's dtype on its device (restore it into live
        tensors with ``repro_torch.train.copy_state``)."""
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest["step"] != step:
            raise ValueError(f"{d}: manifest says step {manifest['step']}")
        with np.load(os.path.join(d, "arrays_host0.npz")) as z:
            flat = {k: z[k] for k in z.files}
        state = state_from_jax(nest(flat, sep="/"),
                               lambda tree: unstack_layers(tree, STACKED))
        return _like(template, state)


def load_latest(directory: str, template: Any):
    ck = Checkpointer(directory)
    steps = ck.list_steps()
    if not steps:
        return None, 0
    step = steps[-1]
    return ck.load(step, template), step


def reshard(tree, device, specs=None, mesh=None, coords=None):
    """A host tree (numpy arrays or CPU tensors, nested in dicts, lists or
    tuples) as the same tree of tensors on ``device`` (``"cuda"`` raises
    without a card): the whole tree on this rank, as data parallelism
    holds it, or with ``specs`` (the same tree of placements, as the
    sharding rules give them) each leaf's block of the rank at ``coords``
    on ``mesh`` (the counterpart of ``repro.checkpoint.reshard``, which
    places each leaf on a mesh under its spec; an elastic restart reads
    the same tree whatever the writer's world size)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: reshard(v, dev, None if specs is None else specs[k],
                           mesh, coords) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(reshard(v, dev, None if specs is None else s,
                                  mesh, coords)
                          for v, s in zip(tree, specs or [None] * len(tree)))
    leaf = torch.as_tensor(tree)
    if specs is not None:
        from repro_torch.sharding.policies import shard_leaf

        leaf = shard_leaf(leaf, specs, mesh, coords).contiguous()
    return leaf.to(dev)
