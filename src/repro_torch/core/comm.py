"""Topology-first collective API: ``Topology`` + engine registry + ``CommContext``.

The port of ``repro/core/comm.py``.  Collective dispatch is a function of
the machine's topology (node count, lanes per node, link constants), so a
:class:`Topology` is a frozen, hashable object:

* it owns the grid shape and the :class:`~repro_torch.core.perf_model.MachineParams`
  every cost decision is solved under, and — when built with
  :meth:`Topology.from_world` — this rank's ``torch.distributed`` process
  groups: one intra-node group per node and one inter-node group per lane,
  built once.  Ranks are numbered ``rank = node * ppn + lane`` (napalg);
* the **engine registry** (:func:`register_engine` / :func:`select_engine`)
  declares each engine's capabilities, cost model and executable lowering;
  dispatch is a capability-filtered cost tournament;
* :class:`CommContext` binds a topology to a :class:`CommPolicy` and
  exposes ``allreduce`` and bucket-scheduled ``sync_grads``.

Only the allreduce family is ported so far (``nap``, ``mla``,
``mla_pipelined``, ``psum``); the reduce-scatter / allgather engines, the
baselines (``rd``, ``smp``, ``ring``, ``rabenseifner``) and the
registration-time verifier and lint wait for later slices.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, NamedTuple

import numpy as np
import torch.distributed as dist

from . import collectives, perf_model as pm

__all__ = [
    "Topology",
    "RankGroups",
    "Group",
    "EngineSpec",
    "Decision",
    "register_engine",
    "get_engine",
    "select_engine",
    "CommPolicy",
    "CommContext",
    "COLLECTIVES",
]

#: the collective families the registry dispatches over
COLLECTIVES = ("allreduce",)


# ---------------------------------------------------------------------------
# process groups
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Group:
    """One communication domain as this rank sees it: the
    ``torch.distributed`` group (``None`` when the domain is this rank
    alone), its size, and this rank's index in it."""

    handle: object
    size: int
    index: int

    @classmethod
    def alone(cls) -> "Group":
        return cls(None, 1, 0)


@dataclasses.dataclass(frozen=True)
class RankGroups:
    """This rank's place in an ``(n_nodes, ppn)`` grid and its groups:
    ``intra`` spans its node (index = lane), ``inter`` spans its lane
    across nodes (index = node), ``world`` the whole grid (index = rank)."""

    rank: int
    intra: Group
    inter: Group
    world: Group


def _build_groups(n_nodes: int, ppn: int) -> RankGroups:
    group = n_nodes * ppn
    if group == 1:
        return RankGroups(0, Group.alone(), Group.alone(), Group.alone())
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {n_nodes}x{ppn} topology needs torch.distributed "
            "initialised with one process per rank"
        )
    if dist.get_world_size() != group:
        raise ValueError(
            f"world size {dist.get_world_size()} != {n_nodes}x{ppn} grid"
        )
    rank = dist.get_rank()
    node, lane = divmod(rank, ppn)
    intra = inter = Group.alone()
    # every rank creates every group, in the same order (new_group is
    # collective over the world)
    if ppn > 1:
        for j in range(n_nodes):
            pg = dist.new_group([j * ppn + r for r in range(ppn)])
            if j == node:
                intra = Group(pg, ppn, lane)
    if n_nodes > 1:
        for r in range(ppn):
            pg = dist.new_group([j * ppn + r for j in range(n_nodes)])
            if r == lane:
                inter = Group(pg, n_nodes, node)
    return RankGroups(rank, intra, inter, Group(dist.group.WORLD, group, rank))


# ---------------------------------------------------------------------------
# Topology
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Topology:
    """Frozen, hashable description of a two-level rank grid.

    ``n_nodes`` nodes (the slow domain) of ``ppn`` ranks each, the machine
    constants, and optionally this rank's process groups.  Equality and
    hashing ignore the groups, so equal grids share every cached schedule,
    crossover and bucket plan.
    """

    n_nodes: int
    ppn: int
    params: pm.MachineParams = pm.TPU_V5E_POD
    groups: RankGroups | None = dataclasses.field(
        default=None, compare=False, repr=False
    )

    def __post_init__(self):
        if self.n_nodes < 1 or self.ppn < 1:
            raise ValueError(
                f"topology needs n_nodes >= 1 and ppn >= 1, got "
                f"({self.n_nodes}, {self.ppn})"
            )

    # -- constructors ------------------------------------------------------

    @classmethod
    def of(
        cls, n_nodes: int, ppn: int, *, params: pm.MachineParams | None = None
    ) -> "Topology":
        """Explicit grid shape, no process groups (planning use)."""
        return cls(int(n_nodes), int(ppn), params=params or pm.TPU_V5E_POD)

    @classmethod
    def from_world(
        cls, n_nodes: int, ppn: int, *, params: pm.MachineParams | None = None
    ) -> "Topology":
        """The executable topology of this process: ``torch.distributed``
        must be initialised with ``n_nodes * ppn`` ranks (or not at all for
        a grid of one).  Builds the intra-node and inter-node groups."""
        n_nodes, ppn = int(n_nodes), int(ppn)
        return cls(
            n_nodes, ppn, params=params or pm.TPU_V5E_POD,
            groups=_build_groups(n_nodes, ppn),
        )

    # -- basic shape -------------------------------------------------------

    @property
    def group(self) -> int:
        """Total ranks — the reduction group size."""
        return self.n_nodes * self.ppn

    def require_groups(self) -> RankGroups:
        """Guard for execution entry points: a topology without process
        groups (``Topology.of``) cannot execute — its collectives would
        silently reduce over nothing."""
        if self.groups is None:
            if self.group == 1:
                return _build_groups(1, 1)
            raise ValueError(
                f"topology ({self.n_nodes} nodes x {self.ppn} lanes) "
                "carries no process groups, so collectives cannot execute "
                "on it; build it with Topology.from_world (Topology.of is "
                "planning-only)"
            )
        return self.groups

    # -- cached model-derived state ---------------------------------------

    def crossover_bytes(self) -> float:
        """Model-driven NAP<->MLA crossover for this grid (memoised):
        ``math.inf`` when NAP never loses in the searched range, ``0.0``
        for single-lane nodes."""
        return _crossover_bytes(
            self.n_nodes, self.ppn, self.params, _primary_bandwidth_engine()
        )

    def optimal_pipeline_chunks(self, nbytes: float) -> int:
        """Model-optimal MLA pipeline depth for an ``nbytes`` payload."""
        return pm.optimal_pipeline_chunks(
            float(nbytes), self.n_nodes, self.ppn, self.params
        )

    def optimal_bucket_bytes(
        self,
        total_bytes: float,
        *,
        compute_seconds: float | None = None,
        max_buckets: int = 64,
    ) -> float:
        """Grad-sync fusion bucket target (overlap optimum, always finite)."""
        return pm.optimal_bucket_bytes(
            float(total_bytes), self.n_nodes, self.ppn, self.params,
            compute_seconds=compute_seconds, max_buckets=max_buckets,
        )


def _primary_bandwidth_engine(collective: str = "allreduce") -> str:
    """The crossover's large-message contender: the first-registered
    bandwidth engine with a cost model."""
    for spec in _REGISTRY[collective].values():
        if spec.regime == "bandwidth" and spec.cost is not None:
            return spec.name
    raise ValueError(
        f"no bandwidth {collective} engine with a cost model is "
        "registered; cannot solve a latency/bandwidth crossover"
    )


@functools.lru_cache(maxsize=None)
def _crossover_bytes(
    n: int, ppn: int, params: pm.MachineParams, large: str
) -> float:
    if n <= 1:
        return math.inf  # no slow domain: NAP degenerates to psum
    if ppn <= 1:
        return 0.0  # NAP needs two lanes to trade steps for lanes
    return pm.crossover_bytes(n, ppn, params, large=large)


# ---------------------------------------------------------------------------
# engine registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """One registered collective engine: capabilities + cost + lowering.

    ``execute(x, *, topology, op, pipeline_chunks)`` runs the collective on
    this rank's tensor; ``cost(s, n, ppn, params)`` prices an ``s``-byte
    payload.  ``regime``
    structures the tournament: ``latency`` wins below the crossover,
    ``bandwidth`` engines fight a cost tournament above it, ``fallback``
    catches grids nothing else supports, ``baseline`` never auto-dispatches.
    """

    name: str
    collective: str
    execute: Callable
    cost: Callable | None = None
    ops: frozenset[str] | None = frozenset({"sum"})
    regime: str = "baseline"
    min_nodes: int = 1
    min_ppn: int = 1
    chunked: bool = False
    pipelined_variant: str | None = None

    def supports(self, topology: Topology, op: str) -> bool:
        """Capability check: op + grid constraints."""
        if self.ops is not None and op not in self.ops:
            return False
        return (
            topology.n_nodes >= self.min_nodes
            and topology.ppn >= self.min_ppn
        )


_REGISTRY: dict[str, dict[str, EngineSpec]] = {c: {} for c in COLLECTIVES}


def register_engine(
    name: str,
    *,
    collective: str = "allreduce",
    ops: frozenset[str] | set[str] | None = frozenset({"sum"}),
    execute: Callable,
    cost: Callable | None = None,
    regime: str = "baseline",
    min_nodes: int = 1,
    min_ppn: int = 1,
    chunked: bool = False,
    pipelined_variant: str | None = None,
    override: bool = False,
) -> EngineSpec:
    """Register a collective engine; registration order breaks cost ties."""
    if collective not in _REGISTRY:
        raise ValueError(
            f"unknown collective {collective!r}; one of {COLLECTIVES}"
        )
    if name in _REGISTRY[collective] and not override:
        raise ValueError(
            f"{collective} engine {name!r} is already registered; "
            "pass override=True to replace it deliberately"
        )
    spec = EngineSpec(
        name=name,
        collective=collective,
        execute=execute,
        cost=cost,
        ops=frozenset(ops) if ops is not None else None,
        regime=regime,
        min_nodes=min_nodes,
        min_ppn=min_ppn,
        chunked=chunked,
        pipelined_variant=pipelined_variant,
    )
    _REGISTRY[collective][name] = spec
    return spec


def get_engine(name: str, collective: str = "allreduce") -> EngineSpec:
    """Resolve an engine by name, with a listing error on typos."""
    table = _REGISTRY[collective]
    spec = table.get(name)
    if spec is None:
        raise ValueError(
            f"unknown {collective} engine {name!r}; registered engines: "
            f"{sorted(table)} (or 'auto' for the model-driven dispatch)"
        )
    return spec


class Decision(NamedTuple):
    """One dispatch decision: the engine and its pipeline depth."""

    engine: str
    chunks: int


def select_engine(
    topology: Topology,
    nbytes: int,
    op: str = "sum",
    *,
    collective: str = "allreduce",
    small_threshold_bytes: int | None = None,
    pipeline_chunks: int | None = None,
) -> Decision:
    """Capability-filtered cost tournament over the registered engines.

    1. filter engines by declared ops and grid constraints (``baseline``
       engines never auto-dispatch);
    2. with both a latency and a bandwidth engine eligible, the latency
       engine wins at or below ``small_threshold_bytes`` (default: the
       memoised model crossover);
    3. above it the bandwidth engines compete on declared cost, earlier
       registration winning ties;
    4. grids/ops no latency or bandwidth engine supports go to the
       fallback engine.

    ``pipeline_chunks`` pins the depth of a chunked winner (and promotes a
    plain bandwidth winner to its ``pipelined_variant`` when above 1).
    """
    table = _REGISTRY[collective]
    eligible = [
        s
        for s in table.values()
        if s.regime in ("latency", "bandwidth", "fallback")
        and s.supports(topology, op)
    ]
    latency = [s for s in eligible if s.regime == "latency"]
    bandwidth = [s for s in eligible if s.regime == "bandwidth"]
    fallback = [s for s in eligible if s.regime == "fallback"]

    if not latency and not bandwidth:
        if not fallback:
            raise NotImplementedError(
                f"no registered {collective} engine supports op={op!r} on "
                f"grid (n={topology.n_nodes}, ppn={topology.ppn})"
            )
        return Decision(fallback[0].name, 1)

    if latency and bandwidth:
        threshold = (
            float(small_threshold_bytes)
            if small_threshold_bytes is not None
            else topology.crossover_bytes()
        )
        if nbytes <= threshold:
            return Decision(latency[0].name, 1)
    if not bandwidth:
        return Decision(latency[0].name, 1)

    n, ppn, mp = topology.n_nodes, topology.ppn, topology.params
    best = bandwidth[0]
    best_cost = (
        best.cost(float(nbytes), n, ppn, mp) if best.cost else math.inf
    )
    for s in bandwidth[1:]:
        c = s.cost(float(nbytes), n, ppn, mp) if s.cost else math.inf
        if c < best_cost:
            best, best_cost = s, c

    if best.chunked:
        chunks = (
            max(1, int(pipeline_chunks))
            if pipeline_chunks is not None
            else topology.optimal_pipeline_chunks(nbytes)
        )
        return Decision(best.name, chunks)
    if pipeline_chunks is not None and best.pipelined_variant is not None:
        c = max(1, int(pipeline_chunks))
        return Decision(best.pipelined_variant if c > 1 else best.name, c)
    return Decision(best.name, 1)


# ---------------------------------------------------------------------------
# engine registrations (registration order = the reference's)
# ---------------------------------------------------------------------------


def _cost_mla_pipelined_opt(s, n, ppn, p):
    return pm.cost_mla_pipelined(s, n, ppn, p, chunks=None)


register_engine(
    "nap", ops=collectives.ALL_OPS, regime="latency", min_nodes=2, min_ppn=2,
    cost=pm.cost_nap, execute=collectives.nap_allreduce,
)
register_engine(
    "mla", ops=collectives.MLA_OPS, regime="bandwidth", min_nodes=2,
    cost=pm.cost_mla, execute=collectives.mla_allreduce,
    pipelined_variant="mla_pipelined",
)
register_engine(
    "mla_pipelined", ops=collectives.MLA_OPS, regime="bandwidth",
    min_nodes=2, min_ppn=2, cost=_cost_mla_pipelined_opt, chunked=True,
    execute=collectives.mla_pipelined_allreduce,
)
register_engine(
    "psum", ops=collectives.ALL_OPS, regime="fallback", cost=pm.cost_psum,
    execute=collectives.psum_allreduce,
)


# ---------------------------------------------------------------------------
# policy + context facade
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CommPolicy:
    """How a :class:`CommContext` dispatches and syncs.

    algorithm: allreduce engine name or ``"auto"`` (see
      :func:`select_engine`); validated against the registry.
    mean: grad sync divides by the group size (integer leaves rounded).
    compress_bits: None (off) or 2..8 — quantised grad transport on the
      fused transport kernels (:mod:`repro_torch.kernels.transport`) with
      per-leaf max-abs scales: 8 moves ``int8`` wire bytes, 4 packs two
      int4 nibbles per ``uint8`` byte.
    error_feedback: carry per-rank EF residuals through
      :meth:`CommContext.sync_grads` (``ef_state=``).  Requires
      ``compress_bits``.
    small_threshold_bytes: fixed latency/bandwidth switch override.
    fuse_small_buckets: let the bucket planner fuse same-dtype float leaves.
    bucket_bytes: fusion bucket target; ``None`` = the model's optimum.
    pipeline_chunks: MLA pipeline depth; ``None`` = model-optimal.
    transport_impl: ``"auto"`` (CUDA kernel for a CUDA tensor, plain
      version for a CPU tensor) or ``"plain"`` (the plain version on any
      device — a check route only, never the main path).
    """

    algorithm: str = "auto"
    mean: bool = True
    compress_bits: int | None = None
    small_threshold_bytes: int | None = None
    fuse_small_buckets: bool = True
    bucket_bytes: int | None = None
    pipeline_chunks: int | None = None
    error_feedback: bool = False
    transport_impl: str = "auto"

    def __post_init__(self):
        if self.algorithm != "auto":
            get_engine(self.algorithm)  # raises with the engine listing
        if self.compress_bits is not None and not (
            2 <= int(self.compress_bits) <= 8
        ):
            raise ValueError(
                f"compress_bits must be None or 2..8, got "
                f"{self.compress_bits!r}"
            )
        if self.error_feedback and self.compress_bits is None:
            raise ValueError(
                "error_feedback=True requires compress_bits (residuals "
                "of an exact sync are identically zero)"
            )
        if self.transport_impl not in ("auto", "plain"):
            raise ValueError(
                f"transport_impl must be 'auto' or 'plain', got "
                f"{self.transport_impl!r}"
            )


@dataclasses.dataclass(frozen=True)
class CommContext:
    """Facade binding a :class:`Topology` to a dispatch policy.

    Dispatch decisions are host-side and depend only on payload sizes, so
    every rank takes the same decision and runs the same collectives.
    """

    topology: Topology
    policy: CommPolicy = CommPolicy()

    def dispatch(
        self,
        nbytes: int,
        op: str = "sum",
        *,
        algorithm: str | None = None,
        pipeline_chunks: int | None = None,
    ) -> Decision:
        """The (engine, chunks) decision for an ``nbytes`` payload."""
        algo = algorithm if algorithm is not None else self.policy.algorithm
        pin = (
            pipeline_chunks
            if pipeline_chunks is not None
            else self.policy.pipeline_chunks
        )
        if algo != "auto":
            spec = get_engine(algo)
            if spec.chunked:
                chunks = (
                    max(1, int(pin))
                    if pin is not None
                    else self.topology.optimal_pipeline_chunks(nbytes)
                )
                return Decision(spec.name, chunks)
            if spec.pipelined_variant is not None and pin is not None:
                return Decision(spec.name, max(1, int(pin)))
            return Decision(spec.name, 1)
        return select_engine(
            self.topology,
            nbytes,
            op,
            small_threshold_bytes=self.policy.small_threshold_bytes,
            pipeline_chunks=pin,
        )

    def allreduce(
        self,
        x,
        op: str = "sum",
        *,
        algorithm: str | None = None,
        pipeline_chunks: int | None = None,
    ):
        """Allreduce over the topology's whole grid (model dispatched)."""
        self.topology.require_groups()
        nbytes = int(np.prod(tuple(x.shape))) * x.element_size()
        d = self.dispatch(
            nbytes, op, algorithm=algorithm, pipeline_chunks=pipeline_chunks
        )
        spec = get_engine(d.engine)
        if spec.ops is not None and op not in spec.ops:
            raise NotImplementedError(
                f"allreduce engine {spec.name!r} supports "
                f"{sorted(spec.ops)}, got op={op!r}"
            )
        return spec.execute(
            x, topology=self.topology, op=op, pipeline_chunks=d.chunks
        )

    def sync_grads(self, grads, *, plan=None, ef_state=None):
        """Bucket-scheduled gradient allreduce of a tree of tensors (see
        :mod:`repro_torch.core.grad_sync`); with ``ef_state`` returns
        ``(synced, new_ef)``."""
        from . import grad_sync

        return grad_sync.sync_with_context(
            grads, self, plan=plan, ef_state=ef_state
        )

    def plan(self, tree):
        """Host-side bucket plan for a gradient tree under this context."""
        from . import grad_sync

        return grad_sync.plan_for_tree(
            tree, cfg=self.policy, topology=self.topology
        )
