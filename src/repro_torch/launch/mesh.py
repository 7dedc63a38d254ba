"""The port's production layouts (``repro.launch.mesh``).

JAX's meshes are v5e pods (16 x 16 chips, or two of them).  The port
runs on NVIDIA H100s, data-parallel: ``"single"`` is one card, ``"quad"``
four cards of one host joined by NVLink, every rank holding the whole
model and its own rows of the batch.  :func:`production_layout` touches
no device state (the cell layer and the dry run read it on any machine);
:func:`make_device_mesh` builds a ``DeviceMesh`` over the ranks of the
process group the caller has initialised, and raises when its size is not
the layout's.
"""
from __future__ import annotations

import dataclasses

LAYOUTS = ("single", "quad")


@dataclasses.dataclass(frozen=True)
class Layout:
    name: str
    cards: int
    dp: int  # data-parallel ranks (every card one)
    axis_names: tuple = ("data", "model")

    @property
    def mesh_shape(self) -> tuple:
        return (self.dp, 1)  # the port shards no parameter


def production_layout(name: str = "single") -> Layout:
    """``"single"``: one H100; ``"quad"``: four, data-parallel."""
    cards = {"single": 1, "quad": 4}
    if name not in cards:
        raise ValueError(f"layout {name!r}; one of {LAYOUTS}")
    return Layout(name=name, cards=cards[name], dp=cards[name])


def make_device_mesh(layout="single", device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``layout``'s shape (data, model) over the ranks
    of the initialised default process group (``tcp://localhost:<port>``
    and a rank each: nothing on the machine names a cluster)."""
    lay = production_layout(layout) if isinstance(layout, str) else layout
    return mesh_over_ranks(lay.mesh_shape, lay.axis_names, device_type)


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
