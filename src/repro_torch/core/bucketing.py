"""Bucket planning for gradient synchronisation.

The port of ``repro/core/bucketing.py``: pure host-side math that turns the
static metadata of a gradient tree (leaf sizes, dtypes, transport widths)
into a :class:`BucketPlan` the executor (:mod:`repro_torch.core.grad_sync`)
replays.  Every dispatch decision (NAP vs MLA vs pipelined MLA, pipeline
depth, fusion grouping) is solved here from the §IV cost model and pinned
into the plan.

Planning rules (as in the reference):

* **reverse-leaf issue order** — backward produces the last layers'
  gradients first, so buckets are packed and issued from the highest leaf
  index down;
* **per-dtype fusion** — a fused bucket holds exactly one dtype; integer
  leaves never fuse;
* **size-targeted buckets** — the target comes from
  :func:`perf_model.optimal_bucket_bytes`;
* **chunk-aligned boundaries** — a bucket in the pipelined regime has its
  close point snapped so the ragged chunk grid meets leaf boundaries;
* **transport-byte budgeting** — compressed float leaves are budgeted at
  their packed wire width (0.5 B/element at 4 bits).

Dtypes are carried by name (``"float32"``, ``"bfloat16"``, ...), the same
names the reference's plan uses, so the two packages' plans compare equal.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Sequence

import torch

from . import napalg

__all__ = [
    "LeafSpec",
    "Bucket",
    "BucketPlan",
    "plan_buckets",
    "leaf_specs_for",
    "dtype_name",
]

# how many trailing leaves a snap may move to the next bucket, and the
# smallest bucket (as a fraction of the target) a snap may leave behind
_SNAP_WINDOW = 3
_SNAP_MIN_FRACTION = 0.5


@dataclass(frozen=True)
class LeafSpec:
    """Static metadata of one gradient leaf (host-side, hashable).

    ``transport_itemsize`` is the per-element byte width that actually
    crosses the network — the packed wire width for compressed float
    leaves (possibly fractional: 0.5 for two int4 nibbles per byte),
    the native width otherwise.  All budgeting and dispatch decisions
    use transport bytes (rounded up per leaf).
    """

    index: int
    elems: int
    itemsize: int
    dtype: str
    fusible: bool
    transport_itemsize: int | float | None = None

    @property
    def nbytes(self) -> int:
        return self.elems * self.itemsize

    @property
    def transport_bytes(self) -> int:
        it = self.transport_itemsize
        if it is None:
            return self.elems * self.itemsize
        return int(math.ceil(self.elems * it))


@dataclass(frozen=True)
class Bucket:
    """One fused bucket: which leaves, and the pinned dispatch decision.

    ``leaves`` lists original leaf indices in fusion/issue order
    (reverse-leaf).  ``algorithm``/``chunks`` are the planner's dispatch
    decision for the whole bucket — the executor pins them per bucket so no second
    decision happens at run time.
    """

    leaves: tuple[int, ...]
    elems: int
    nbytes: int
    transport_bytes: int
    dtype: str
    algorithm: str
    chunks: int = 1

    @property
    def chunk_splits(self) -> tuple[int, ...]:
        """Element count of each ragged pipeline chunk — the exact splits
        the MLA lowering executes and the simulator replays."""
        return napalg.ragged_splits(self.elems, max(1, self.chunks))

    @property
    def chunk_boundaries(self) -> tuple[int, ...]:
        return napalg.chunk_offsets(self.elems, max(1, self.chunks))


@dataclass(frozen=True)
class BucketPlan:
    """A full bucket schedule for one gradient pytree on one grid."""

    n: int
    ppn: int
    target_bytes: float
    crossover_bytes: float
    buckets: tuple[Bucket, ...]
    signature: tuple[tuple[int, str], ...]  # (elems, dtype) per leaf

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    @property
    def total_transport_bytes(self) -> int:
        return sum(b.transport_bytes for b in self.buckets)

    def sim_rows(self) -> tuple[tuple[float, str, int, int], ...]:
        """(transport_bytes, algorithm, chunks, elems) per bucket, in
        issue order — the simulator's replay input."""
        return tuple(
            (float(b.transport_bytes), b.algorithm, b.chunks, b.elems)
            for b in self.buckets
        )


def leaf_specs_for(
    shaped_leaves: Sequence, *, transport_itemsize_fn=None
) -> tuple[LeafSpec, ...]:
    """LeafSpecs from tensors (any device, ``meta`` included), in
    leaf-index order."""
    specs = []
    for i, leaf in enumerate(shaped_leaves):
        dt = leaf.dtype
        fusible = _fusible(dt)
        tit = (
            transport_itemsize_fn(dt, fusible)
            if transport_itemsize_fn is not None
            else None
        )
        specs.append(
            LeafSpec(
                index=i,
                elems=int(leaf.numel()),
                itemsize=int(dt.itemsize),
                dtype=dtype_name(dt),
                fusible=fusible,
                transport_itemsize=tit,
            )
        )
    return tuple(specs)


def _fusible(dtype) -> bool:
    """Whether a leaf of this dtype may share a bucket.

    The reference decides with ``np.issubdtype(dtype, np.floating)``, and
    numpy does not count ``bfloat16`` (an extension dtype) as floating: its
    planner gives every bf16 leaf a bucket of its own, budgeted at the raw
    2 B/element.  The port keeps that rule so both packages plan the same
    buckets for the same tree (pinned by tests/test_torch_schedules.py).
    """
    return bool(dtype.is_floating_point) and dtype != torch.bfloat16


def dtype_name(dtype) -> str:
    """The numpy-style name of a torch dtype (``torch.bfloat16`` ->
    ``"bfloat16"``), as the reference's plans carry it."""
    return str(dtype).removeprefix("torch.")


def _decide(
    transport_bytes: int,
    topology,
    algorithm: str,
    op: str,
    small_threshold_bytes: int | None,
    pipeline_chunks: int | None,
) -> tuple[str, int]:
    """(engine, pipeline depth) for one bucket — the single dispatch
    decision, made at plan time through the engine registry
    (:func:`repro_torch.core.comm.select_engine`), so the planner and the
    trace-time dispatcher cannot diverge."""
    from . import comm

    if algorithm != "auto":
        spec = comm.get_engine(algorithm)  # validates: listing on typos
        if spec.chunked:
            if pipeline_chunks is not None:
                return algorithm, max(1, int(pipeline_chunks))
            return algorithm, topology.optimal_pipeline_chunks(
                float(transport_bytes)
            )
        if spec.pipelined_variant is not None and pipeline_chunks is not None:
            return algorithm, max(1, int(pipeline_chunks))
        return algorithm, 1
    return tuple(
        comm.select_engine(
            topology,
            int(transport_bytes),
            op=op,
            small_threshold_bytes=small_threshold_bytes,
            pipeline_chunks=pipeline_chunks,
        )
    )


def plan_buckets(
    leaf_specs: tuple[LeafSpec, ...],
    topology,
    ppn: int | None = None,
    *,
    algorithm: str = "auto",
    op: str = "sum",
    small_threshold_bytes: int | None = None,
    pipeline_chunks: int | None = None,
    bucket_bytes: int | None = None,
    fuse: bool = True,
    params=None,
) -> BucketPlan:
    """Pack leaves into size-targeted, dtype-pure, chunk-aligned buckets.

    ``topology`` is a :class:`repro_torch.core.comm.Topology` (preferred) or a
    legacy ``n`` node count with ``ppn`` as the third argument; ``params``
    overrides the topology's machine constants.  Pure in its (hashable)
    inputs and cached — planning runs once per (pytree structure x
    topology x config), off the trace path.  Buckets come back in
    reverse-leaf issue order; every leaf appears in exactly one bucket.
    """
    import dataclasses as _dc

    from . import comm

    if isinstance(topology, comm.Topology):
        topo = topology
        if params is not None:
            topo = _dc.replace(topo, params=params)
    else:
        topo = comm.Topology.of(int(topology), int(ppn or 1), params=params)
    return _plan_buckets_cached(
        leaf_specs,
        topo,
        algorithm,
        op,
        small_threshold_bytes,
        pipeline_chunks,
        bucket_bytes,
        fuse,
    )


@functools.lru_cache(maxsize=None)
def _plan_buckets_cached(
    leaf_specs: tuple[LeafSpec, ...],
    topo,
    algorithm: str,
    op: str,
    small_threshold_bytes: int | None,
    pipeline_chunks: int | None,
    bucket_bytes: int | None,
    fuse: bool,
) -> BucketPlan:
    n, ppn = topo.n_nodes, topo.ppn
    total_fusible = sum(
        ls.transport_bytes for ls in leaf_specs if ls.fusible
    )
    if bucket_bytes is not None:
        target = float(bucket_bytes)
    else:
        target = topo.optimal_bucket_bytes(float(max(total_fusible, 1)))
    xo = topo.crossover_bytes()

    buckets: list[Bucket] = []

    def decide(tbytes: int) -> tuple[str, int]:
        return _decide(
            tbytes, topo, algorithm, op,
            small_threshold_bytes, pipeline_chunks,
        )

    def close(run: list[LeafSpec]) -> None:
        if not run:
            return
        tbytes = sum(ls.transport_bytes for ls in run)
        algo, chunks = decide(tbytes)
        buckets.append(
            Bucket(
                leaves=tuple(ls.index for ls in run),
                elems=sum(ls.elems for ls in run),
                nbytes=sum(ls.nbytes for ls in run),
                transport_bytes=tbytes,
                dtype=run[0].dtype,
                algorithm=algo,
                chunks=chunks,
            )
        )

    def snap(run: list[LeafSpec]) -> list[LeafSpec]:
        """Close point snapped to the ragged chunk grid.

        Considers keeping the whole run or moving up to ``_SNAP_WINDOW``
        trailing leaves to the next bucket; scores each candidate by how
        well its pipeline chunk boundaries coincide with leaf boundaries
        (:func:`napalg.chunk_alignment`).  Returns the leaves deferred to
        the next bucket.
        """
        best_keep, best_score = len(run), -1.0
        for keep in range(len(run), max(len(run) - _SNAP_WINDOW, 1) - 1, -1):
            cand = run[:keep]
            tbytes = sum(ls.transport_bytes for ls in cand)
            if keep < len(run) and tbytes < _SNAP_MIN_FRACTION * target:
                break
            _, chunks = decide(tbytes)
            score = napalg.chunk_alignment(
                tuple(ls.elems for ls in cand), chunks
            )
            if score > best_score + 1e-12:
                best_keep, best_score = keep, score
            if score >= 1.0 and keep == len(run):
                break  # whole run already aligned: no need to shrink
        deferred = run[best_keep:]
        close(run[:best_keep])
        return deferred

    # one open fusion buffer per dtype (the Horovod/DDP idiom): a stray
    # f32 norm between bf16 matmul grads must not flush the bf16 run —
    # it accumulates in its own run instead, so dtype purity costs no
    # fragmentation.  A bucket is only issuable once its *last* leaf is
    # produced, so closing buffers as they fill (and flushing leftovers
    # at the end, most-recently-fed first) preserves readiness order.
    runs: dict[str, list[LeafSpec]] = {}
    touch: list[str] = []
    for ls in sorted(leaf_specs, key=lambda l: -l.index):
        if not fuse or not ls.fusible:
            close([ls])  # int / unfusible leaf: its own bucket, in place
            continue
        run = runs.setdefault(ls.dtype, [])
        if ls.dtype in touch:
            touch.remove(ls.dtype)
        touch.append(ls.dtype)
        run.append(ls)
        if sum(l.transport_bytes for l in run) >= target:
            runs[ls.dtype] = snap(run)
    for dt in touch:
        run = runs.get(dt) or []
        while run:
            run = snap(run)

    return BucketPlan(
        n=n,
        ppn=ppn,
        target_bytes=float(target),
        crossover_bytes=float(xo),
        buckets=tuple(buckets),
        signature=tuple((ls.elems, ls.dtype) for ls in leaf_specs),
    )
