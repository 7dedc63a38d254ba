"""The port's production layouts (``repro.launch.mesh``).

JAX's meshes are v5e pods (16 x 16 chips, or two of them), (data,
model).  The port runs on NVIDIA H100s: ``"single"`` is one card (1 x
1), ``"quad"`` four cards of one host joined by NVLink, data-parallel (4
x 1: every rank holds the whole model and its own rows of the batch),
and ``"quad_tp"`` the same four cards as (data 2, model 2), the square
shape of JAX's 16 x 16 mesh: parameters, caches and batches placed by
:mod:`repro_torch.sharding.policies` (FSDP over data, tensor or expert
parallelism over model).  :func:`production_layout` touches no device
state (the cell layer and the dry run read it on any machine);
:func:`make_device_mesh` and :func:`make_debug_mesh` build a
``DeviceMesh`` over the ranks of the process group the caller has
initialised, and raise when there is none or its size is not the mesh's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

LAYOUTS = ("single", "quad", "quad_tp")


@dataclasses.dataclass(frozen=True)
class Layout:
    name: str
    cards: int
    dp: int  # data-parallel ranks
    tp: int = 1  # tensor-parallel ranks (the model axis)
    axis_names: tuple = ("data", "model")
    # MoE experts split over the model axis (None: the policy's default,
    # ``sharding.policies.default_expert_parallel``)
    expert_parallel: Optional[bool] = None

    @property
    def mesh_shape(self) -> tuple:
        return (self.dp, self.tp)

    def abstract_mesh(self):
        """The layout's mesh without ranks, for the sharding rules."""
        from repro_torch.sharding.policies import AbstractMesh

        return AbstractMesh(self.mesh_shape, self.axis_names)


def production_layout(name: str = "single") -> Layout:
    """``"single"``: one H100; ``"quad"``: four, data-parallel;
    ``"quad_tp"``: four as (data 2, model 2)."""
    shapes = {"single": (1, 1), "quad": (4, 1), "quad_tp": (2, 2)}
    if name not in shapes:
        raise ValueError(f"layout {name!r}; one of {LAYOUTS}")
    dp, tp = shapes[name]
    return Layout(name=name, cards=dp * tp, dp=dp, tp=tp)


def make_device_mesh(layout="single", device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``layout``'s shape (data, model) over the ranks
    of the initialised default process group (``tcp://localhost:<port>``
    and a rank each: nothing on the machine names a cluster)."""
    lay = production_layout(layout) if isinstance(layout, str) else layout
    return mesh_over_ranks(lay.mesh_shape, lay.axis_names, device_type)


def make_debug_mesh(data: int = 1, model: int = 1,
                    device_type: str = "cuda"):
    """A (data, model) ``DeviceMesh`` over the ranks of the default
    process group, which must hold exactly data x model ranks (JAX's
    ``make_debug_mesh``; the tests run it on gloo with ``"cpu"``)."""
    return mesh_over_ranks((data, model), ("data", "model"), device_type)


def mesh_over_ranks(shape: tuple, axis_names: tuple,
                    device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over ranks 0..n-1 of the default
    process group, which must hold exactly n ranks."""
    import math

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a mesh of {n} rank(s) needs an initialised process group "
            f"(torch.distributed.init_process_group)")
    size = dist.get_world_size()
    if size != n:
        raise ValueError(f"the mesh {tuple(shape)} needs {n} rank(s); the "
                         f"process group has {size}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names))
