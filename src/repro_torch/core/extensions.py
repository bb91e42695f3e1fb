"""Beyond-paper extensions: NAP allgather and NAP reduce-scatter.

The port of ``repro/core/extensions.py``.  Paper §VI: "Natural extensions
exist to the MPI_Allgather ... node-aware extensions could be applied to
larger MPI_Allreduce methods, optimizing the reduce-scatter and allgather
approach."  These apply the NAP exchange pattern to allgather
(``log_ppn(n)`` inter-node steps instead of ``log2(n)``) and to
reduce-scatter (its mirror), which together give a node-aware
large-message allreduce whose latency term is also ``log_ppn(n)``.

Both need a power-of-``ppn`` node count (the ragged donor repair of the
allreduce does not carry over to collectives that move distinct values);
:func:`supported` says where they run.  Each NAP step is one
``batch_isend_irecv`` round over the world group, as the allreduce's.
"""

from __future__ import annotations

import numpy as np
import torch

from . import napalg
from .collectives import _all_gather, _ppermute, _reduce_scatter

__all__ = ["nap_allgather", "nap_reduce_scatter", "nap_allreduce_large",
           "supported"]


def supported(n: int, ppn: int) -> bool:
    """Whether the NAP extensions run on an ``(n, ppn)`` grid: one node,
    or ``n`` a power of ``ppn >= 2``.  (The reference also answers True
    for single-lane grids of several nodes, where its NAP schedule builder
    then raises: NAP needs two lanes.)"""
    if n <= 1:
        return n > 0
    if ppn < 2:
        return False
    steps = napalg.nap_num_steps(n, ppn)
    return ppn**steps == n


def _step_masks(sched, n_ranks):
    out = []
    for step in sched.steps:
        smask = np.zeros(n_ranks, dtype=bool)
        smask[list(step.self_chips)] = True
        out.append((step.rounds[0], smask))
    return out


def _require(name: str, topology) -> None:
    if not supported(topology.n_nodes, topology.ppn):
        raise ValueError(
            f"{name} needs power-of-ppn nodes "
            f"({topology.n_nodes},{topology.ppn})"
        )


def nap_allgather(x: torch.Tensor, *, topology) -> torch.Tensor:
    """Node-aware allgather: returns (p, *x.shape), row ``q`` from rank
    ``q``, in ``log_ppn(n)`` inter-node exchange steps (the payload grows
    ``ppn``-fold per step)."""
    _require("nap_allgather", topology)
    groups = topology.require_groups()
    n, ppn = topology.n_nodes, topology.ppn
    v = _all_gather(x, groups.intra)  # (ppn, ...)
    if n == 1:
        return v
    rank = groups.rank
    for pairs, smask in _step_masks(napalg.build_nap_schedule(n, ppn),
                                    n * ppn):
        recv = _ppermute(v, pairs, groups)
        if smask[rank]:
            recv = v  # the rank's own subgroup keeps its block
        elif recv is None:
            recv = torch.zeros_like(v)
        v = _all_gather(recv, groups.intra).reshape(-1, *v.shape[1:])
    return v


def nap_reduce_scatter(x: torch.Tensor, *, topology) -> torch.Tensor:
    """Node-aware reduce-scatter (sum): ``x`` is (p, ...) rows on every
    rank; rank ``q`` returns the reduced row ``q`` as (1, ...).  The
    mirror of :func:`nap_allgather`: an intra-node reduce-scatter narrows
    the payload ``ppn``-fold before each inter-node exchange, which
    routes each block to the subgroup that owns it."""
    _require("nap_reduce_scatter", topology)
    groups = topology.require_groups()
    n, ppn = topology.n_nodes, topology.ppn
    p = n * ppn
    if x.shape[0] != p:
        raise ValueError(f"leading dim {x.shape[0]} != total ranks {p}")
    rank = groups.rank

    def intra_rs(v):
        # tiled: row block t of the (rows, ...) payload to lane t
        rows = v.shape[0] // ppn
        return _reduce_scatter(v.reshape(ppn, -1), groups.intra).reshape(
            rows, *v.shape[1:])

    v = x
    if n > 1:
        sched = napalg.build_nap_schedule(n, ppn)
        for pairs, smask in reversed(_step_masks(sched, p)):
            v = intra_rs(v)
            recv = _ppermute(v, pairs, groups)
            if not smask[rank]:
                v = torch.zeros_like(v) if recv is None else recv
    return intra_rs(v)


def nap_allreduce_large(x: torch.Tensor, *, topology) -> torch.Tensor:
    """Node-aware large-message allreduce: NAP reduce-scatter then NAP
    allgather (§VI): the bandwidth-optimal volume in ``2 log_ppn(n)``
    inter-node message steps."""
    p = topology.group
    flat = x.reshape(-1)
    size = flat.numel()
    pad = (-size) % p
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    mine = nap_reduce_scatter(flat.reshape(p, -1), topology=topology)
    full = nap_allgather(mine[0], topology=topology)
    return full.reshape(-1)[:size].reshape(x.shape)
