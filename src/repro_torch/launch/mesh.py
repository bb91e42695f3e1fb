"""The rank grid of a run: ``(n_nodes, ppn)`` onto ``torch.distributed``,
and the mesh a sharding policy reads and places tensors on.

The port of ``repro/launch/mesh.py``.  :func:`mesh_topology`: the
reference's ``("pod", "data")`` mesh becomes a world of ``n_nodes * ppn``
processes, rank ``node * ppn + lane``: ``pod`` (the slow domain) is the
node index, ``data`` the lane.

:class:`Mesh` is the description a :class:`~repro_torch.models.sharding.
ShardingPolicy`, :func:`~repro_torch.launch.steps.microbatch_split` and
the abstract specs read: axis names and a grid of ranks (row-major, as
``jax.sharding.Mesh`` lays out its devices).  :meth:`Mesh.device_mesh`
gives the ``torch.distributed`` :class:`DeviceMesh` over the same grid,
on which DTensors are placed: rank ``r`` sits where device ``r`` sits in
the reference's mesh.  ``device_mesh(order=)`` builds the same grid with
its dimensions in another order (the ``serve2d`` policy's joint axis is
model-major: ``("model", "data")`` on a ``("data", "model")`` mesh), over
the same rank -> coordinate map.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..core.comm import Topology
from ..device import resolve_device

__all__ = ["Mesh", "make_mesh", "make_production_mesh", "mesh_axis_sizes",
           "dp_axes", "hierarchy_axes", "mesh_topology", "DATA_AXES",
           "MODEL_AXIS", "POD_AXIS"]

POD_AXIS = "pod"
DATA_AXIS = "data"
MODEL_AXIS = "model"
DATA_AXES = (POD_AXIS, DATA_AXIS)  # gradient-sync (DP) axes when present

# (shape, axis names, device type) -> (the default group it was built in,
# its DeviceMesh): a mesh's groups are built once per process group
_DEVICE_MESHES: dict = {}


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

    def device_mesh(self, device=None, order=None):
        """The ``DeviceMesh`` of this grid on ``device``'s type (``cuda``
        unless asked otherwise), with this mesh's axis names, its
        dimensions in ``order`` (a permutation of the names; the mesh's
        own by default): the grid transposed, so rank ``r`` keeps its
        coordinate on every named axis.
        ``torch.distributed`` must be initialised with one rank per grid
        point; every rank calls this in the same order (it
        builds one group per mesh axis and row, once per process group)."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        dev = resolve_device(device)
        if not dist.is_initialized():
            raise RuntimeError(
                f"a {self.shape} mesh needs torch.distributed initialised "
                "with one process per rank"
            )
        if dist.get_world_size() != math.prod(self.shape):
            raise ValueError(f"world size {dist.get_world_size()} != mesh "
                             f"{self.shape}")
        order = tuple(order) if order is not None else self.axis_names
        if sorted(order) != sorted(self.axis_names):
            raise ValueError(f"axis order {order} is not a permutation of "
                             f"{self.axis_names}")
        key = (self.shape, self.axis_names, order, dev.type)
        world = dist.group.WORLD
        hit = _DEVICE_MESHES.get(key)
        if hit is None or hit[0] is not world:
            grid = np.transpose(self.devices,
                                [self.axis_names.index(a) for a in order])
            dm = DeviceMesh(dev.type, grid.tolist(), mesh_dim_names=order)
            hit = _DEVICE_MESHES[key] = (world, dm)
        return hit[1]


def make_mesh(shape, axes) -> Mesh:
    return Mesh(tuple(int(s) for s in shape), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production meshes: 16 x 16 = 256 ranks on ``("data",
    "model")``, or, multi-pod, 2 x 16 x 16 = 512 on ``("pod", "data",
    "model")`` (``pod`` the slow inter-pod domain, the paper's
    inter-node network)."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel (gradient sync) axes present in this mesh."""
    return tuple(ax for ax in DATA_AXES if ax in mesh.axis_names)


def hierarchy_axes(mesh) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """(inter, intra) split of the DP axes for node-aware collectives:
    with a ``pod`` axis the slow domain is the pod boundary; without one
    there is no slow domain and the split is ``((), ("data",))``."""
    names = mesh.axis_names
    intra = tuple(ax for ax in (DATA_AXIS,) if ax in names)
    if POD_AXIS in names:
        return (POD_AXIS,), intra
    return (), intra


def mesh_topology(mesh=1, ppn: int = 1, *, params=None) -> Topology:
    """The executable :class:`Topology` of a mesh or of this process's world.

    ``mesh_topology(mesh)`` (a :class:`Mesh`) is the reference's entry
    point: :meth:`Topology.from_mesh`, the DP hierarchy from
    :func:`hierarchy_axes` (a ``pod`` axis is the slow domain), one DP grid
    per index of the mesh's other axes.  ``mesh_topology(n_nodes, ppn)``
    is the world of ``n_nodes * ppn`` ranks, rank ``node * ppn + lane``
    (groups built once); ``torch.distributed`` must be initialised with
    that many ranks, or not at all for a grid of one.  ``params``
    overrides the machine constants."""
    if isinstance(mesh, Mesh):
        return Topology.from_mesh(mesh, params=params)
    return Topology.from_world(mesh, ppn, params=params)
