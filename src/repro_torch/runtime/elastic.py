"""Elastic scaling: restart on a different card count, reshard state
(``repro.runtime.elastic``).

The checkpoint is layout-portable (host numpy in JAX's key space), so a
job that loses cards can restart on the survivors: keep the model axis
(its degree is fixed by the parameter shapes; 1 in the port, which shards
no parameter), shrink the data axis to a power of two, and rescale the
per-step microbatch count so the global batch holds.
:func:`elastic_restart_plan` is JAX's arithmetic; :func:`make_mesh_from_plan`
builds its ``DeviceMesh`` over the present process group, and
:func:`remesh_state` places a host-loaded state on this rank's card
through ``checkpoint.reshard`` (data parallelism holds the whole tree on
every rank).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.checkpoint.checkpoint import reshard
from repro_torch.launch.mesh import mesh_over_ranks


@dataclasses.dataclass
class ElasticPlan:
    old_devices: int
    new_devices: int
    mesh_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    batch_scale: float  # keep global batch: scale microbatches by this


def elastic_restart_plan(
    available_devices: int,
    tp_size: int,
    old_data_size: int,
    pod_size: int = 1,
) -> ElasticPlan:
    """Largest (data, model) mesh with fixed TP that fits the survivors."""
    if available_devices < tp_size:
        raise ValueError(
            f"cannot preserve TP={tp_size} with {available_devices} devices"
        )
    new_data = available_devices // tp_size
    # data axis must divide the global batch eventually; prefer powers of 2
    while new_data > 1 and (new_data & (new_data - 1)):
        new_data -= 1
    return ElasticPlan(
        old_devices=old_data_size * tp_size * pod_size,
        new_devices=new_data * tp_size,
        mesh_shape=(new_data, tp_size),
        axis_names=("data", "model"),
        batch_scale=old_data_size * pod_size / new_data,
    )


def make_mesh_from_plan(plan: ElasticPlan, device_type: str = "cuda"):
    """The plan's ``DeviceMesh`` over the default process group's ranks;
    raises when the group's size is not the plan's card count."""
    return mesh_over_ranks(plan.mesh_shape, plan.axis_names, device_type)


def remesh_state(state: Any, new_mesh) -> Any:
    """A host-loaded checkpoint (numpy or CPU tensors) on this rank's
    device of ``new_mesh``: the whole tree, as data parallelism holds it
    (``"cuda"`` raises without a card)."""
    import torch

    device = (torch.device("cuda", torch.cuda.current_device())
              if new_mesh.device_type == "cuda"
              else torch.device(new_mesh.device_type))
    return reshard(state, device)
