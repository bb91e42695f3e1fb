"""The paper's allreduce engines on ``torch.distributed``.

The port of the engines of ``repro/core/collectives.py``.  Each function
runs on this rank's tensor and reduces it over the two-level grid of a
:class:`repro_torch.core.comm.Topology` built with ``from_world``, whose
process groups stand in for the reference's named mesh axes:

=================================  =======================================
reference (inside ``shard_map``)    port (``torch.distributed``)
=================================  =======================================
``lax.ppermute`` round              ``batch_isend_irecv`` on the world group
``lax.psum_scatter``                ``reduce_scatter_tensor``
``lax.all_gather``                  ``all_gather_into_tensor``
``lax.all_to_all``                  ``all_to_all_single``
``lax.psum`` / ``pmax``             ``all_reduce``
=================================  =======================================

The engines are agnostic of the backend: gloo for CPU tensors, NCCL for
CUDA tensors.  On a grid of one rank every group has size 1 and every
engine returns its input.

* :func:`nap_allreduce` — the paper's NAP (§III): intra allreduce, then
  ``ceil(log_ppn(n))`` inter-node exchange steps each closed by an intra
  allreduce.
* :func:`mla_allreduce` — multi-lane node-aware: intra reduce-scatter
  stripes the node partial over the ``ppn`` lanes, each lane runs RS+AG
  over the nodes, an intra allgather rebuilds the payload; optionally in
  ``C`` ragged pipeline chunks.
* :func:`mla_pipelined_allreduce` — MLA at the model-optimal depth.
* :func:`psum_allreduce` — one native allreduce over the whole grid.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from . import napalg

__all__ = [
    "nap_allreduce",
    "mla_allreduce",
    "mla_pipelined_allreduce",
    "psum_allreduce",
    "ALL_OPS",
    "MLA_OPS",
]

# op registry: (pairwise fold, torch.distributed reduce op)
_OPS: dict[str, tuple[Callable, object]] = {
    "sum": (torch.add, dist.ReduceOp.SUM),
    "max": (torch.maximum, dist.ReduceOp.MAX),
    "min": (torch.minimum, dist.ReduceOp.MIN),
}
ALL_OPS = frozenset(_OPS)
# ops each bandwidth-regime engine can execute
MLA_OPS = frozenset({"sum", "max", "min"})

_AXIS_REDUCERS: dict[str, Callable] = {
    "sum": lambda t: t.sum(dim=0),
    "max": lambda t: t.amax(dim=0),
    "min": lambda t: t.amin(dim=0),
}

# torch 2.13 renames the tensor-form collectives; older releases have only
# the old names
_all_gather_tensor = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor"
)
_reduce_scatter_tensor = getattr(dist, "reduce_scatter_single", None) or (
    getattr(dist, "reduce_scatter_tensor")
)


def _op_identity(op: str, dtype: torch.dtype) -> float | int:
    """Dtype-correct reduction identity (for ragged padding)."""
    if op == "sum":
        return 0
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        return info.min if op == "max" else info.max
    return -math.inf if op == "max" else math.inf


def _needs_f32_accum(dtype: torch.dtype) -> bool:
    """Whether cross-node sums of this dtype must accumulate in f32."""
    return dtype.is_floating_point and dtype.itemsize < 4


def _f32_fold(fold: Callable, op: str, dtype: torch.dtype) -> Callable:
    """Pairwise fold that accumulates sub-f32 float sums in float32 (the
    wire keeps its dtype; only the local accumulate runs wide)."""
    if op != "sum" or not _needs_f32_accum(dtype):
        return fold

    def wide_fold(a, b):
        return fold(a.float(), b.float()).to(dtype)

    return wide_fold


# ---------------------------------------------------------------------------
# group primitives (a group of size 1 is the identity)
# ---------------------------------------------------------------------------


def _all_reduce(x: torch.Tensor, group, op: str) -> torch.Tensor:
    if group.size == 1:
        return x
    y = x.clone()
    dist.all_reduce(y, op=_OPS[op][1], group=group.handle)
    return y


def _reduce_scatter(tiles: torch.Tensor, group) -> torch.Tensor:
    """Sum-reduce-scatter of (k, m) rows: rank ``t`` gets row ``t``."""
    if group.size == 1:
        return tiles[0]
    out = torch.empty(tiles.shape[1:], dtype=tiles.dtype, device=tiles.device)
    _reduce_scatter_tensor(out, tiles.contiguous().reshape(-1),
                           group=group.handle)
    return out


def _all_to_all(tiles: torch.Tensor, group) -> torch.Tensor:
    """(k, ...) rows: row ``t`` goes to rank ``t``; returns the received
    rows, row ``t`` from rank ``t``."""
    if group.size == 1:
        return tiles
    tiles = tiles.contiguous()
    out = torch.empty_like(tiles)
    dist.all_to_all_single(out, tiles, group=group.handle)
    return out


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Stack every rank's ``x``: returns (k, *x.shape), row ``t`` from
    rank ``t``."""
    if group.size == 1:
        return x[None]
    x = x.contiguous()
    out = torch.empty((group.size,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    _all_gather_tensor(out.reshape(-1), x.reshape(-1), group=group.handle)
    return out


def _ppermute(v: torch.Tensor, pairs, rank: int) -> torch.Tensor | None:
    """One permutation round over the world group: every ``(src, dst)``
    pair moves ``src``'s value to ``dst``.  Returns what this rank
    received (``None`` when it is no destination)."""
    flat = v.contiguous().reshape(-1)
    ops, recv = [], None
    for src, dst in pairs:
        if src == rank and dst == rank:
            recv = flat.clone()
            continue
        if src == rank:
            ops.append(dist.P2POp(dist.isend, flat, dst))
        if dst == rank:
            recv = torch.empty_like(flat)
            ops.append(dist.P2POp(dist.irecv, recv, src))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return None if recv is None else recv.reshape(v.shape)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


def nap_allreduce(x: torch.Tensor, *, topology, op: str = "sum",
                  pipeline_chunks=None) -> torch.Tensor:
    """Node-Aware Parallel allreduce (paper §III, Algorithm 1).

    Every rank of the grid gets the reduction of ``x``; a rank sends at
    most ``ceil(log_ppn(n))`` inter-node messages.
    """
    groups = topology.require_groups()
    fold = _f32_fold(_OPS[op][0], op, x.dtype)
    n, ppn = topology.n_nodes, topology.ppn
    sched = napalg.build_nap_schedule(n, ppn)
    v = _all_reduce(x, groups.intra, op)
    if not sched.steps:
        return v
    rank = groups.rank
    ident = _op_identity(op, v.dtype)
    for step, (rmasks, smask) in zip(
        sched.steps, napalg.step_mask_tables(n, ppn)
    ):
        acc = v if smask[rank] else torch.full_like(v, ident)
        for rnd, rmask in zip(step.rounds, rmasks):
            recv = _ppermute(v, rnd, rank)
            if rmask[rank]:
                acc = fold(acc, recv)
        v = _all_reduce(acc, groups.intra, op)
    return v


def _pad_to(flat: torch.Tensor, k: int, op: str) -> torch.Tensor:
    pad = (-flat.numel()) % k
    if not pad:
        return flat
    fill = torch.full((pad,), _op_identity(op, flat.dtype), dtype=flat.dtype,
                      device=flat.device)
    return torch.cat([flat, fill])


def _rabenseifner(x: torch.Tensor, group, op: str) -> torch.Tensor:
    """Reduce-scatter + allgather over one group (the per-lane inter-node
    phase of MLA).  Sub-f32 float sums go through ``all_to_all`` + an f32
    fold so they never accumulate in the wire dtype."""
    p = group.size
    if p == 1:
        return x
    flat = x.reshape(-1)
    size = flat.numel()
    tiles = _pad_to(flat, p, op).reshape(p, -1)
    if op == "sum" and not _needs_f32_accum(flat.dtype):
        shard = _reduce_scatter(tiles, group)
    else:
        gathered = _all_to_all(tiles, group)
        if op == "sum":
            shard = gathered.float().sum(dim=0).to(flat.dtype)
        else:
            shard = _AXIS_REDUCERS[op](gathered)
    out = _all_gather(shard, group).reshape(-1)[:size]
    return out.reshape(x.shape).to(x.dtype)


def _mla_one_chunk(flat: torch.Tensor, groups, ppn: int, op: str):
    """One chunk of the MLA allreduce (flat 1-D payload in, same out)."""
    size = flat.numel()
    tiles = _pad_to(flat, ppn, op).reshape(ppn, -1)
    # phase 1: stripe the node partial across the local lanes
    if op == "sum":
        stripe = _reduce_scatter(tiles, groups.intra)
    else:
        stripe = _AXIS_REDUCERS[op](_all_to_all(tiles, groups.intra))
    # phase 2: per-lane RS+AG across the slow domain
    stripe = _rabenseifner(stripe, groups.inter, op)
    # phase 3: rebuild the full payload inside the node
    return _all_gather(stripe, groups.intra).reshape(-1)[:size]


def mla_allreduce(x: torch.Tensor, *, topology, op: str = "sum",
                  pipeline_chunks: int | None = 1) -> torch.Tensor:
    """Multi-lane node-aware allreduce (the bandwidth-regime engine).

    Per-rank inter-node traffic is ``~2*(s/ppn)*(n-1)/n``.  With
    ``pipeline_chunks=C > 1`` the payload is split into ``C`` ragged chunks
    (:func:`napalg.ragged_splits`) that run the three phases in turn.
    """
    if op not in MLA_OPS:
        raise NotImplementedError(
            f"mla path supports {sorted(MLA_OPS)}, got {op!r}"
        )
    groups = topology.require_groups()
    ppn = topology.ppn
    if ppn == 1:
        return _rabenseifner(x, groups.inter, op)
    flat = x.reshape(-1)
    chunks = max(1, min(int(pipeline_chunks or 1), flat.numel()))
    if chunks == 1:
        out = _mla_one_chunk(flat, groups, ppn, op)
    else:
        parts, off = [], 0
        for ce in napalg.ragged_splits(flat.numel(), chunks):
            if ce == 0:
                continue
            parts.append(_mla_one_chunk(flat[off : off + ce], groups, ppn, op))
            off += ce
        out = torch.cat(parts)
    return out.reshape(x.shape).to(x.dtype)


def mla_pipelined_allreduce(x: torch.Tensor, *, topology, op: str = "sum",
                            pipeline_chunks: int | None = None):
    """MLA at the pipeline depth solved from the §IV cost model
    (``pipeline_chunks=None``) under the topology's machine constants."""
    if pipeline_chunks is None:
        from . import perf_model as pm

        nbytes = float(int(np.prod(tuple(x.shape))) * x.element_size())
        pipeline_chunks = pm.optimal_pipeline_chunks(
            nbytes, topology.n_nodes, topology.ppn, topology.params
        )
    return mla_allreduce(
        x, topology=topology, op=op, pipeline_chunks=pipeline_chunks
    )


def psum_allreduce(x: torch.Tensor, *, topology, op: str = "sum",
                   pipeline_chunks=None) -> torch.Tensor:
    """One native allreduce over the whole grid (the fallback engine); a
    cross-node sub-f32 float sum runs in f32."""
    groups = topology.require_groups()
    if op == "sum" and topology.n_nodes > 1 and _needs_f32_accum(x.dtype):
        return _all_reduce(x.float(), groups.world, op).to(x.dtype)
    return _all_reduce(x, groups.world, op)
