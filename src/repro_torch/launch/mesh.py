"""The rank grid of a run: ``(n_nodes, ppn)`` onto ``torch.distributed``.

The port of ``repro/launch/mesh.py::mesh_topology``.  The reference's
``("pod", "data")`` mesh becomes a world of ``n_nodes * ppn`` processes,
rank ``node * ppn + lane``: ``pod`` (the slow domain) is the node index,
``data`` the lane.
"""

from __future__ import annotations

from ..core.comm import Topology

__all__ = ["mesh_topology"]


def mesh_topology(n_nodes: int = 1, ppn: int = 1, *, params=None) -> Topology:
    """The executable :class:`Topology` of this process's world (groups
    built once).  ``torch.distributed`` must be initialised with
    ``n_nodes * ppn`` ranks, or not at all for a grid of one."""
    return Topology.from_world(n_nodes, ppn, params=params)
