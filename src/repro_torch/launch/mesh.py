"""The rank grid of a run: ``(n_nodes, ppn)`` onto ``torch.distributed``,
and the mesh a sharding policy reads.

The port of ``repro/launch/mesh.py``.  :func:`mesh_topology`: the
reference's ``("pod", "data")`` mesh becomes a world of ``n_nodes * ppn``
processes, rank ``node * ppn + lane``: ``pod`` (the slow domain) is the
node index, ``data`` the lane.

:class:`Mesh` is the description a :class:`~repro_torch.models.sharding.
ShardingPolicy` and :func:`~repro_torch.launch.steps.microbatch_split`
read: axis names and a grid of ranks (row-major, as ``jax.sharding.Mesh``
lays out its devices).  Nothing is placed on it yet.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..core.comm import Topology

__all__ = ["Mesh", "make_mesh", "mesh_axis_sizes", "dp_axes",
           "mesh_topology", "DATA_AXES", "MODEL_AXIS", "POD_AXIS"]

POD_AXIS = "pod"
DATA_AXIS = "data"
MODEL_AXIS = "model"
DATA_AXES = (POD_AXIS, DATA_AXIS)  # gradient-sync (DP) axes when present


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and the grid's shape; ``devices`` is the grid of ranks."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} does not match axes "
                             f"{self.axis_names}")

    @property
    def devices(self) -> np.ndarray:
        return np.arange(math.prod(self.shape)).reshape(self.shape)


def make_mesh(shape, axes) -> Mesh:
    return Mesh(tuple(int(s) for s in shape), tuple(axes))


def mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel (gradient sync) axes present in this mesh."""
    return tuple(ax for ax in DATA_AXES if ax in mesh.axis_names)


def mesh_topology(n_nodes: int = 1, ppn: int = 1, *, params=None) -> Topology:
    """The executable :class:`Topology` of this process's world (groups
    built once).  ``torch.distributed`` must be initialised with
    ``n_nodes * ppn`` ranks, or not at all for a grid of one."""
    return Topology.from_world(n_nodes, ppn, params=params)
