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
* :func:`rd_allreduce` / :func:`smp_allreduce` — the paper's baselines
  (§II, Fig. 3; §II.A, Fig. 4): node-agnostic recursive doubling and
  MPICH's master-process algorithm, executed from their ``napalg``
  point-to-point schedules.
* :func:`ring_allreduce` — the bandwidth-optimal ring reduce-scatter +
  allgather over the whole grid; :func:`rabenseifner_allreduce` — an
  intra-node reduce, then reduce-scatter + allgather over the nodes.
* :func:`mla_allreduce` — multi-lane node-aware: intra reduce-scatter
  stripes the node partial over the ``ppn`` lanes, each lane runs RS+AG
  over the nodes, an intra allgather rebuilds the payload; optionally in
  ``C`` ragged pipeline chunks.
* :func:`mla_pipelined_allreduce` — MLA at the model-optimal depth.
* :func:`psum_allreduce` — one native allreduce over the whole grid.
* :func:`all_to_all` — ``lax.all_to_all(x, axis, 0, 0, tiled=False)``
  over one mesh dimension's process group, with its backward (the same
  exchange): the expert-parallel hop of the MoE routes; :func:`psum`,
  the differentiable sum over such a group.
* :func:`mla_reduce_scatter` / :func:`mla_allgather` — the two halves of
  MLA as collectives of their own: rank ``(node j, lane r)`` owns block
  ``(r, j)`` of the stripe layout, ``ceil(ceil(e/ppn)/n)`` elements;
  :func:`flat_reduce_scatter` / :func:`flat_allgather` — one level over
  the whole grid, in rank order.
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
    "rd_allreduce",
    "smp_allreduce",
    "ring_allreduce",
    "rabenseifner_allreduce",
    "mla_allreduce",
    "mla_pipelined_allreduce",
    "psum_allreduce",
    "mla_reduce_scatter",
    "mla_allgather",
    "flat_reduce_scatter",
    "flat_allgather",
    "all_to_all",
    "psum",
    "auto_crossover_bytes",
    "select_algorithm",
    "hierarchical_allreduce",
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


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        # row t of the output came from rank t's row ``rank``: the
        # transpose sends every row back the same way
        return _AllToAll.apply(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (k, ...) over the k ranks of ``group`` (a ``torch.distributed``
    process group, e.g. ``DeviceMesh.get_group(axis)``): row ``t`` goes to
    rank ``t``, and row ``t`` of the result came from rank ``t`` — the
    reference's ``lax.all_to_all(x, axis, 0, 0, tiled=False)``.
    Differentiable: the gradient takes the same exchange.  A group of one
    rank returns ``x``."""
    k = dist.get_world_size(group)
    if x.shape[0] != k:
        raise ValueError(f"all_to_all over {k} ranks needs {k} rows, got "
                         f"{tuple(x.shape)}")
    if k == 1:
        return x
    return _AllToAll.apply(x, group)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return _PSum.apply(g, ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (a process group), as
    ``lax.psum`` inside the reference's ``shard_map``: differentiable, the
    gradient summed the same way.  A group of one rank returns ``x``."""
    if dist.get_world_size(group) == 1:
        return x
    return _PSum.apply(x, group)


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


def _ppermute(v: torch.Tensor, pairs, groups) -> torch.Tensor | None:
    """One permutation round over the grid: every ``(src, dst)`` pair of
    grid indices moves ``src``'s value to ``dst``.  ``groups`` is this
    rank's :class:`~repro_torch.core.comm.RankGroups`: its ``peers`` map a
    grid index to its world rank, and its ``rounds`` (the SPMD lint's
    fake world only) run the round in place of ``batch_isend_irecv`` on
    the default group.  Returns what this rank received (``None`` when it
    is no destination)."""
    rank = groups.rank
    flat = v.contiguous().reshape(-1)
    ops, recv = [], None  # (isend | irecv, tensor, peer grid index)
    for src, dst in pairs:
        if src == rank and dst == rank:
            recv = flat.clone()
            continue
        if src == rank:
            ops.append((dist.isend, flat, dst))
        if dst == rank:
            recv = torch.empty_like(flat)
            ops.append((dist.irecv, recv, src))
    if groups.rounds is not None:
        groups.rounds(flat, ops)
    elif ops:
        world = ((lambda i: i) if groups.peers is None
                 else groups.peers.__getitem__)
        p2p = [dist.P2POp(fn, t, world(peer)) for fn, t, peer in ops]
        for req in dist.batch_isend_irecv(p2p):
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
            recv = _ppermute(v, rnd, groups)
            if rmask[rank]:
                acc = fold(acc, recv)
        v = _all_reduce(acc, groups.intra, op)
    return v


# ---------------------------------------------------------------------------
# point-to-point schedule executor (RD / SMP baselines)
# ---------------------------------------------------------------------------


def _run_p2p_schedule(x: torch.Tensor, sched, groups, op: str):
    """Execute a :class:`napalg.P2PSchedule`: one ``batch_isend_irecv``
    round per step over the world group; a receiving rank folds the
    payload in (``combine``) or takes it."""
    fold = _f32_fold(_OPS[op][0], op, x.dtype)
    v = x
    for step, rmask in zip(sched.steps, napalg.p2p_recv_masks(sched)):
        recv = _ppermute(v, step.pairs, groups)
        if rmask[groups.rank]:
            v = fold(v, recv) if step.combine else recv
    return v


def rd_allreduce(x: torch.Tensor, *, topology, op: str = "sum",
                 pipeline_chunks=None) -> torch.Tensor:
    """Node-agnostic recursive doubling over the flattened grid (paper
    Fig. 3): ``log2(p)`` pairwise exchange steps, plus the MPICH fold
    before and after for a non-power-of-two ``p``.  Every rank of a node
    crosses the slow domain with the whole payload at each inter-node
    step, the duplicate traffic NAP removes."""
    groups = topology.require_groups()
    sched = napalg.build_rd_schedule(topology.n_nodes, topology.ppn)
    return _run_p2p_schedule(x, sched, groups, op)


def smp_allreduce(x: torch.Tensor, *, topology, op: str = "sum",
                  pipeline_chunks=None) -> torch.Tensor:
    """MPICH SMP allreduce (paper §II.A, Fig. 4): a binomial reduce to
    lane 0 of each node, recursive doubling among those masters, a
    binomial broadcast back.  One active rank per node."""
    groups = topology.require_groups()
    sched = napalg.build_smp_schedule(topology.n_nodes, topology.ppn)
    return _run_p2p_schedule(x, sched, groups, op)


# ---------------------------------------------------------------------------
# bandwidth-regime baselines
# ---------------------------------------------------------------------------


def ring_allreduce(x: torch.Tensor, *, topology, op: str = "sum",
                   pipeline_chunks=None) -> torch.Tensor:
    """Bandwidth-optimal ring allreduce over all ``p`` ranks in rank
    order: ``p - 1`` neighbour shifts of reduce-scatter (rank ``i`` ends
    owning the sum of chunk ``i + 1``), then ``p - 1`` of allgather; each
    rank moves ``2 s (p-1)/p`` bytes."""
    groups = topology.require_groups()
    p = topology.group
    if p == 1:
        return x
    fold = _f32_fold(_OPS[op][0], op, x.dtype)
    flat = x.reshape(-1)
    size = flat.numel()
    chunks = _pad_to(flat, p, op).reshape(p, -1).clone()
    idx = groups.rank
    fwd = [(i, (i + 1) % p) for i in range(p)]
    acc = chunks[idx % p]
    for k in range(p - 1):
        recv = _ppermute(acc, fwd, groups)
        acc = fold(recv, chunks[(idx - k - 1) % p])
    chunks[(idx + 1) % p] = acc
    cur = acc
    for k in range(p - 1):
        cur = _ppermute(cur, fwd, groups)
        chunks[(idx - k) % p] = cur  # chunk (idx - k - 1) + 1 arrives
    out = chunks.reshape(-1)[:size]
    return out.reshape(x.shape).to(x.dtype)


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


def rabenseifner_allreduce(x: torch.Tensor, *, topology, op: str = "sum",
                           pipeline_chunks=None) -> torch.Tensor:
    """The large-message baseline: reduce inside the node first, so that
    one payload per node crosses the slow domain, then reduce-scatter +
    allgather over the nodes (sub-f32 sums folded in f32)."""
    if op not in MLA_OPS:
        raise NotImplementedError(
            f"rabenseifner path supports {sorted(MLA_OPS)}, got {op!r}"
        )
    groups = topology.require_groups()
    v = _all_reduce(x, groups.intra, op)
    return _rabenseifner(v, groups.inter, op)


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


# ---------------------------------------------------------------------------
# reduce-scatter / allgather
# ---------------------------------------------------------------------------


def _level_reduce_scatter(flat: torch.Tensor, group, op: str, *,
                          f32_accum: bool = False) -> torch.Tensor:
    """One reduce-scatter level over ``group``: pad to its size ``k`` with
    the op's identity, rank ``t`` gets the reduced tile ``t``.  ``sum``
    runs the native reduce-scatter; ``max`` / ``min`` (and, with
    ``f32_accum``, a sub-f32 float sum) an ``all_to_all`` and a local
    fold, the same bytes."""
    k = group.size
    if k <= 1:
        return flat
    tiles = _pad_to(flat, k, op).reshape(k, -1)
    wide = f32_accum and op == "sum" and _needs_f32_accum(flat.dtype)
    if op == "sum" and not wide:
        return _reduce_scatter(tiles, group)
    gathered = _all_to_all(tiles, group)
    if wide:
        return gathered.float().sum(dim=0).to(flat.dtype)
    return _AXIS_REDUCERS[op](gathered)


def mla_reduce_scatter(x: torch.Tensor, *, topology,
                       op: str = "sum") -> torch.Tensor:
    """Node-aware striped reduce-scatter, the RS half of the MLA
    allreduce: the node partial is striped over the ``ppn`` lanes (intra
    reduce-scatter), then each lane reduce-scatters its stripe over the
    nodes (a sub-f32 sum folded in f32).  Rank ``(node j, lane r)``
    returns the reduced block ``(r, j)``, ``ceil(ceil(e/ppn)/n)``
    elements (padded with the op's identity to that uniform size).
    Inverse: :func:`mla_allgather`."""
    if op not in MLA_OPS:
        raise NotImplementedError(
            f"mla_reduce_scatter supports {sorted(MLA_OPS)}, got {op!r}"
        )
    groups = topology.require_groups()
    stripe = _level_reduce_scatter(x.reshape(-1), groups.intra, op)
    return _level_reduce_scatter(stripe, groups.inter, op, f32_accum=True)


def mla_allgather(x: torch.Tensor, *, topology,
                  elems: int | None = None) -> torch.Tensor:
    """Node-aware striped allgather, the exact inverse of
    :func:`mla_reduce_scatter`: each lane gathers its blocks over the
    nodes (its stripe), then an intra-node allgather rebuilds the flat
    payload.  ``elems`` is the original size (default: no padding)."""
    groups = topology.require_groups()
    n, ppn = topology.n_nodes, topology.ppn
    shard = x.reshape(-1)
    if elems is None:
        elems = shard.numel() * n * ppn
    stripe_len = -(-int(elems) // ppn)  # the intra reduce-scatter's stripe
    if n > 1:
        stripe = _all_gather(shard, groups.inter).reshape(-1)[:stripe_len]
    else:
        stripe = shard[:stripe_len]
    full = _all_gather(stripe, groups.intra).reshape(-1) if ppn > 1 else stripe
    return full[: int(elems)]


def flat_reduce_scatter(x: torch.Tensor, *, topology, op: str = "sum",
                        f32_accum: bool = False) -> torch.Tensor:
    """Single-level (node-agnostic) reduce-scatter over all ranks in rank
    order, the fallback engine.  ``f32_accum`` (set when the grid crosses
    nodes) folds a sub-f32 sum in f32."""
    if op not in MLA_OPS:
        raise NotImplementedError(
            f"flat_reduce_scatter supports {sorted(MLA_OPS)}, got {op!r}"
        )
    groups = topology.require_groups()
    return _level_reduce_scatter(x.reshape(-1), groups.world, op,
                                 f32_accum=f32_accum)


def flat_allgather(x: torch.Tensor, *, topology,
                   elems: int | None = None) -> torch.Tensor:
    """Single-level allgather over all ranks, the inverse of
    :func:`flat_reduce_scatter`."""
    groups = topology.require_groups()
    shard = x.reshape(-1)
    p = topology.group
    out = shard if p <= 1 else _all_gather(shard, groups.world).reshape(-1)
    if elems is None:
        elems = shard.numel() * p
    return out[: int(elems)]


# ---------------------------------------------------------------------------
# deprecated shims the reference keeps importable
# ---------------------------------------------------------------------------


def __getattr__(name: str):
    # ``ALGORITHMS`` is a read-only view of the engine registry
    # (repro_torch.core.comm), which is the single source of truth
    if name == "ALGORITHMS":
        from . import comm

        return comm.legacy_execute_table()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def auto_crossover_bytes(n: int, ppn: int, params=None) -> float:
    """Legacy alias of :meth:`repro_torch.core.comm.Topology.crossover_bytes`
    (``math.inf`` when NAP never loses)."""
    from . import comm

    return comm.Topology.of(n, ppn, params=params).crossover_bytes()


def select_algorithm(nbytes: int, n: int, ppn: int, params=None,
                     op: str = "sum",
                     small_threshold_bytes: int | None = None) -> str:
    """Legacy wrapper over :func:`repro_torch.core.comm.select_engine`: the
    allreduce engine the dispatch picks for an ``nbytes`` payload."""
    from . import comm

    return comm.select_engine(
        comm.Topology.of(n, ppn, params=params), int(nbytes), op=op,
        small_threshold_bytes=small_threshold_bytes,
    ).engine


def hierarchical_allreduce(x: torch.Tensor, *, inter_axes, intra_axes, mesh,
                           algorithm: str = "auto", op: str = "sum",
                           small_threshold_bytes: int | None = None,
                           pipeline_chunks: int | None = None
                           ) -> torch.Tensor:
    """Deprecated: allreduce of this rank's ``x`` over the ``inter_axes`` x
    ``intra_axes`` grid of ``mesh`` (the reference reads the axes from its
    ``shard_map``; the port takes the mesh).  Builds the
    :class:`~repro_torch.core.comm.Topology` and a default policy, then
    calls :meth:`~repro_torch.core.comm.CommContext.allreduce`.  Warns
    once."""
    from . import comm

    comm.warn_deprecated_once(
        "collectives.hierarchical_allreduce", "CommContext.allreduce"
    )
    ctx = comm.CommContext(
        comm.Topology.from_axes(inter_axes, intra_axes, mesh=mesh),
        comm.CommPolicy(algorithm=algorithm,
                        small_threshold_bytes=small_threshold_bytes,
                        pipeline_chunks=pipeline_chunks),
    )
    return ctx.allreduce(x, op=op)
