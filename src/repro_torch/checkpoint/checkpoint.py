"""Atomic, asynchronous checkpoints of a train state
(``repro.checkpoint.checkpoint``), at world size 1.

The JAX package's on-disk layout: ``<dir>/step_<N>/arrays_host0.npz`` (the
tree's leaves under their ``/``-joined key paths) and ``manifest.json``
(``step``, ``keys``, ``process_count``, ``format: 1``), written into
``step_<N>.tmp`` and then renamed, so a preemption mid-write never
corrupts the latest checkpoint.  A port train state's keys are
``params/<name>``, ``opt_state/step``, ``opt_state/mu/<name>`` and
``opt_state/nu/<name>`` (``<name>`` a ``state_dict`` name).

``save`` copies every leaf to host memory before it returns, so the next
step may overwrite the live tensors while the writer thread works: on the
CPU ``t.cpu()`` and ``t.numpy()`` share the live tensor's memory, so the
copy is explicit.  ``reshard`` (placing a tree on a mesh) is not ported.
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


def _host_copy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _flatten(tree, prefix: str = "") -> dict[str, Any]:
    if not isinstance(tree, dict):
        return {prefix: tree}
    flat = {}
    for k, v in tree.items():
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _unflatten_like(template, flat: dict[str, np.ndarray], prefix: str = ""):
    """The tree of ``template`` with each leaf read from ``flat``: a new
    tensor of the template leaf's dtype on its device."""
    if isinstance(template, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}/{k}" if prefix
                                   else str(k))
                for k, v in template.items()}
    arr = torch.from_numpy(flat[prefix])
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
        host_state = {k: _host_copy(v) for k, v in _flatten(state).items()}
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
        """The checkpoint of ``step`` as a new tree shaped like
        ``template``, each leaf a tensor of the template leaf's dtype on
        its device (restore it into live tensors with
        ``repro_torch.train.copy_state``)."""
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest["step"] != step:
            raise ValueError(f"{d}: manifest says step {manifest['step']}")
        with np.load(os.path.join(d, "arrays_host0.npz")) as z:
            flat = {k: z[k] for k in z.files}
        return _unflatten_like(template, flat)


def load_latest(directory: str, template: Any):
    ck = Checkpointer(directory)
    steps = ck.list_steps()
    if not steps:
        return None, 0
    step = steps[-1]
    return ck.load(step, template), step
