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
  exposes ``allreduce``, ``reduce_scatter`` and ``allgather`` as peer
  collectives, bucket-scheduled ``sync_grads`` and the sharded
  ``sync_grads_sharded``.

The reference's twelve engines are registered under the same names and
collectives: allreduce ``nap``, ``mla``, ``mla_pipelined``, ``psum`` and
the baselines ``rd``, ``smp``, ``ring``, ``rabenseifner`` (never
auto-dispatched); reduce-scatter ``mla_rs`` / ``psum_scatter``; allgather
``mla_ag`` / ``all_gather``.

Engines are proved by the layers of :mod:`repro_torch.analysis`:
:func:`verify_engine` runs the schedule verifier (layer 1) over an
engine's schedules, and :func:`lint_lowering` the SPMD lint (layer 2) over
the program its ``execute`` runs, traced as every rank of a grid, with
the inter-node bytes held to the schedule's bound.  (Layer 0, the
protocol model check, proves the serving control plane; layer 3, the
trace lint, one rank's issued collectives.)  With
``REPRO_VERIFY_ON_REGISTER`` set, :func:`register_engine` runs both gates
before an engine enters the tournament and rolls a failing registration
back.  The lint makes fake process groups of its own and registers none,
so inside a live ``torch.distributed`` world (the test suite's gloo
workers import this module after ``init_process_group``) the gate runs
the same and leaves the default group as it was.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
import types
import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch.distributed as dist

from . import collectives, napalg, perf_model as pm

__all__ = [
    "Topology",
    "RankGroups",
    "Group",
    "EngineSpec",
    "Decision",
    "register_engine",
    "get_engine",
    "registered_engines",
    "find_engine",
    "engine_schedule",
    "verify_engine",
    "lint_lowering",
    "select_engine",
    "CommPolicy",
    "CommContext",
    "COLLECTIVES",
    "legacy_execute_table",
    "warn_deprecated_once",
]

#: the collective families the registry dispatches over
COLLECTIVES = ("allreduce", "reduce_scatter", "allgather")


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
    across nodes (index = node), ``world`` the whole grid (index = rank).
    ``peers`` maps a grid index to its ``torch.distributed`` rank when the
    grid is part of a larger world (a mesh's DP grid at one ``model``
    index); ``None`` when grid index and rank are one.  ``rounds`` runs a
    permutation round ``rounds(value, [(isend | irecv, tensor, peer grid
    index), ...])`` in place of ``batch_isend_irecv`` on the default
    group: only the SPMD lint's fake world
    (:mod:`repro_torch.analysis.spmd_lint`) sets it."""

    rank: int
    intra: Group
    inter: Group
    world: Group
    peers: tuple[int, ...] | None = None
    rounds: Callable | None = None


# process group name -> the partition of the world its group belongs to
# (every grid's group of the same axis), for the trace lint's replica-group
# rule (repro_torch.analysis.trace_lint)
GROUP_PARTITIONS: dict[str, tuple] = {}


def _build_groups(n_nodes: int, ppn: int) -> RankGroups:
    """This rank's groups in the ``(n_nodes, ppn)`` grid of the whole
    world (``rank = node * ppn + lane``)."""
    return _build_grid_groups(np.arange(n_nodes * ppn).reshape(
        1, n_nodes, ppn))


def _build_grid_groups(grids: np.ndarray) -> RankGroups:
    """This rank's groups in one of several disjoint ``(n_nodes, ppn)``
    grids of ``torch.distributed`` ranks, ``grids`` of shape ``(copies,
    n_nodes, ppn)`` (a mesh's DP grid at every index of its other axes).
    Every rank creates every group, in the same order (``new_group`` is
    collective over the world).  A single grid of the whole world in rank
    order uses the world group itself."""
    copies, n_nodes, ppn = grids.shape
    group = n_nodes * ppn
    if grids.size == 1:
        return RankGroups(0, Group.alone(), Group.alone(), Group.alone())
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {n_nodes}x{ppn} topology needs torch.distributed "
            "initialised with one process per rank"
        )
    if dist.get_world_size() != grids.size:
        raise ValueError(
            f"world size {dist.get_world_size()} != {grids.size} ranks of "
            f"{copies} {n_nodes}x{ppn} grid(s)"
        )
    whole = copies == 1 and bool(
        (grids.reshape(-1) == np.arange(grids.size)).all())
    (o,), (node,), (lane,) = np.nonzero(grids == dist.get_rank())
    intra = inter = world = Group.alone()
    rows = lambda g: tuple(tuple(int(r) for r in x) for x in g)  # noqa: E731
    for c in range(copies):
        if ppn > 1:
            for j in range(n_nodes):
                pg = dist.new_group(grids[c, j].tolist())
                if (c, j) == (o, node):
                    intra = Group(pg, ppn, int(lane))
                    GROUP_PARTITIONS[pg.group_name] = rows(
                        grids.reshape(-1, ppn))
        if n_nodes > 1:
            for r in range(ppn):
                pg = dist.new_group(grids[c, :, r].tolist())
                if (c, r) == (o, lane):
                    inter = Group(pg, n_nodes, int(node))
                    GROUP_PARTITIONS[pg.group_name] = rows(
                        grids.transpose(0, 2, 1).reshape(-1, n_nodes))
        if group > 1:
            pg = (dist.group.WORLD if whole
                  else dist.new_group(grids[c].reshape(-1).tolist()))
            if c == o:
                world = Group(pg, group, int(node * ppn + lane))
                GROUP_PARTITIONS[pg.group_name] = rows(
                    grids.reshape(copies, -1))
    return RankGroups(int(node * ppn + lane), intra, inter, world,
                      peers=None if whole else tuple(
                          int(r) for r in grids[o].reshape(-1)))


# (axis names, mesh shape, inter, intra) -> (the default group they were
# built in, this rank's groups): a mesh's groups are built once per world
_GRID_GROUPS: dict = {}


def _axes_tuple(axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


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
    inter_axes: tuple[str, ...] = ()
    intra_axes: tuple[str, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "inter_axes", _axes_tuple(self.inter_axes))
        object.__setattr__(self, "intra_axes", _axes_tuple(self.intra_axes))
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

    @classmethod
    def from_mesh(cls, mesh, *, inter_axes=None, intra_axes=None,
                  params: pm.MachineParams | None = None) -> "Topology":
        """The DP topology of a mesh: ``inter_axes`` the slow domain,
        ``intra_axes`` the lanes (defaults from
        :func:`repro_torch.launch.mesh.hierarchy_axes`: a ``"pod"`` axis is
        the slow domain, ``"data"`` the lanes; overriding one level keeps
        the other's default).  ``mesh`` needs only ``axis_names`` and
        ``devices`` (a grid of ranks, row-major).

        When ``torch.distributed`` runs a world of the mesh's size, this
        rank's groups are built: one DP grid for every index of the mesh's
        other axes (every ``model`` index has its own).  Otherwise the
        topology is for planning only."""
        if inter_axes is None or intra_axes is None:
            from ..launch.mesh import hierarchy_axes

            d_inter, d_intra = hierarchy_axes(mesh)
            inter_axes = d_inter if inter_axes is None else inter_axes
            intra_axes = d_intra if intra_axes is None else intra_axes
        inter, intra = _axes_tuple(inter_axes), _axes_tuple(intra_axes)
        overlap = set(inter) & set(intra)
        if overlap:
            raise ValueError(
                f"axes {sorted(overlap)} appear in both inter_axes "
                f"{inter} and intra_axes {intra}"
            )
        names = tuple(mesh.axis_names)
        for ax in inter + intra:
            if ax not in names:
                raise ValueError(f"axis {ax!r} not in mesh axes {names}")
        ranks = np.asarray(mesh.devices)
        sizes = dict(zip(names, ranks.shape))
        n = math.prod(sizes[a] for a in inter)
        ppn = math.prod(sizes[a] for a in intra)
        groups = None
        key = (names, ranks.shape, inter, intra)
        hit = _GRID_GROUPS.get(key)
        if hit is not None and hit[0] is dist.group.WORLD:
            groups = hit[1]
        elif dist.is_initialized() and dist.get_world_size() == ranks.size:
            others = [i for i, a in enumerate(names)
                      if a not in inter + intra]
            order = others + [names.index(a) for a in inter + intra]
            grids = np.transpose(np.arange(ranks.size).reshape(ranks.shape),
                                 order)
            groups = _build_grid_groups(grids.reshape(-1, n, ppn))
            _GRID_GROUPS[key] = (dist.group.WORLD, groups)
        return cls(n, ppn, params=params or pm.TPU_V5E_POD, groups=groups,
                   inter_axes=inter, intra_axes=intra)

    @classmethod
    def from_axes(cls, inter_axes, intra_axes, *, mesh,
                  params: pm.MachineParams | None = None) -> "Topology":
        """The topology over the named axes of ``mesh``, both levels
        given.  The reference reads the axis sizes from the traced
        ``shard_map`` it runs in; the port has no such context, so the
        mesh is passed (the same as :meth:`from_mesh` with both levels)."""
        return cls.from_mesh(mesh, inter_axes=_axes_tuple(inter_axes),
                             intra_axes=_axes_tuple(intra_axes),
                             params=params)

    # -- basic shape -------------------------------------------------------

    @property
    def group(self) -> int:
        """Total ranks — the reduction group size."""
        return self.n_nodes * self.ppn

    @property
    def axes(self) -> tuple[str, ...]:
        """Joint (inter + intra) mesh axis names, slow domain first."""
        return self.inter_axes + self.intra_axes

    def require_axes(self) -> "Topology":
        """Guard for execution entry points (returns ``self``): a
        multi-rank topology with neither mesh axes nor process groups
        (``Topology.of``, planning-only) cannot execute."""
        if self.group > 1 and not self.axes and self.groups is None:
            raise ValueError(
                f"topology ({self.n_nodes} nodes x {self.ppn} lanes) "
                "carries no mesh axis names, so collectives cannot "
                "execute on it; build it with Topology.from_mesh / "
                "Topology.from_world (Topology.of is planning-only)"
            )
        return self

    @property
    def has_slow_domain(self) -> bool:
        """The grid spans more than one node (inter-node links exist)."""
        return self.n_nodes > 1

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

    def dispatched_cost(self, nbytes: float) -> float:
        """Modeled cost of one auto-dispatched allreduce of ``nbytes``."""
        return pm.dispatched_allreduce_cost(
            float(nbytes), self.n_nodes, self.ppn, self.params
        )

    # -- schedules / geometry ---------------------------------------------

    def schedule(self, engine: str, *, chunks: int = 1,
                 elems: int | None = None):
        """The message schedule a registered engine would execute here."""
        return engine_schedule(
            engine, self.n_nodes, self.ppn, chunks=chunks, elems=elems
        )

    def chunk_splits(self, elems: int, chunks: int) -> tuple[int, ...]:
        """Ragged pipeline-chunk sizes (the exact executed splits)."""
        return napalg.ragged_splits(elems, max(1, chunks))

    def chunk_offsets(self, elems: int, chunks: int) -> tuple[int, ...]:
        return napalg.chunk_offsets(elems, max(1, chunks))

    def stripe_geometry(self, elems: int):
        """Ragged MLA stripe/block geometry ``(stripes, blocks)``."""
        return napalg.mla_stripe_geometry(self.n_nodes, self.ppn, elems)

    def internode_lower_bound(
        self, elems: int, collective: str = "allreduce"
    ) -> int:
        """Uneven-block lower bound on per-rank inter-node *elements*: the
        round trip for allreduce, the one-way halves for reduce_scatter /
        allgather."""
        if collective == "allreduce":
            return napalg.mla_internode_lower_bound(
                self.n_nodes, self.ppn, elems
            )
        if collective == "reduce_scatter":
            return napalg.rs_internode_lower_bound(
                self.n_nodes, self.ppn, elems
            )
        if collective == "allgather":
            return napalg.ag_internode_lower_bound(
                self.n_nodes, self.ppn, elems
            )
        raise ValueError(
            f"unknown collective {collective!r}; one of {COLLECTIVES}"
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

    ``execute`` runs the collective on this rank's tensor:
    ``execute(x, *, topology, op, pipeline_chunks)`` for allreduce,
    ``(x, *, topology, op)`` for reduce_scatter and
    ``(x, *, topology, elems)`` for allgather.  ``cost(s, n, ppn, params)``
    prices an ``s``-byte payload; ``build_schedule`` builds the message
    schedule the verifier and the simulator replay (``chunked``:
    ``builder(n, ppn, chunks, elems)``; ``ragged``:
    ``builder(n, ppn, elems)``; else ``builder(n, ppn)``).  ``regime``
    structures the tournament: ``latency`` wins below the crossover,
    ``bandwidth`` engines fight a cost tournament above it, ``fallback``
    catches grids nothing else supports, ``baseline`` never
    auto-dispatches.  ``ops=None``: op-independent (allgather).
    """

    name: str
    collective: str
    execute: Callable
    cost: Callable | None = None
    build_schedule: Callable | None = None
    ops: frozenset[str] | None = frozenset({"sum"})
    regime: str = "baseline"
    min_nodes: int = 1
    min_ppn: int = 1
    chunked: bool = False
    ragged: bool = False
    pipelined_variant: str | None = None

    def supports(self, topology: Topology, op: str) -> bool:
        """Capability check: op + grid constraints."""
        if self.ops is not None and op not in self.ops:
            return False
        return (
            topology.n_nodes >= self.min_nodes
            and topology.ppn >= self.min_ppn
        )

    def describe(self) -> dict:
        """JSON-safe capability row."""
        return {
            "name": self.name,
            "collective": self.collective,
            "regime": self.regime,
            "ops": sorted(self.ops) if self.ops is not None else "any",
            "min_nodes": self.min_nodes,
            "min_ppn": self.min_ppn,
            "chunked": self.chunked,
            "has_cost_model": self.cost is not None,
            "has_schedule": self.build_schedule is not None,
        }


_REGISTRY: dict[str, dict[str, EngineSpec]] = {c: {} for c in COLLECTIVES}


def register_engine(
    name: str,
    *,
    collective: str = "allreduce",
    ops: frozenset[str] | set[str] | None = frozenset({"sum"}),
    execute: Callable | None = None,
    cost: Callable | None = None,
    build_schedule: Callable | None = None,
    regime: str = "baseline",
    min_nodes: int = 1,
    min_ppn: int = 1,
    chunked: bool = False,
    ragged: bool = False,
    pipelined_variant: str | None = None,
    override: bool = False,
    verify: bool = True,
):
    """Register a collective engine; registration order breaks cost ties.

    Usable directly (``execute=`` given: returns the :class:`EngineSpec`)
    or as a decorator of the execute function (returns it)::

        @register_engine("my_rs", collective="reduce_scatter",
                         ops={"sum"}, regime="baseline")
        def _execute(x, *, topology, op="sum"):
            ...

    **Verify-on-register.**  With ``REPRO_VERIFY_ON_REGISTER`` set in the
    environment (the test suite sets it), a registration with a schedule
    builder is first proved by
    :mod:`repro_torch.analysis.schedule_verifier` over the registration
    grids (``verify=False`` opts out: exotic schedules with proofs of
    their own, native lowerings with no schedule).

    **Lint-on-register.**  Under the same flag every registration,
    ``verify=False`` included, is traced as every rank of the
    :data:`_LINT_GRIDS` and linted (:func:`lint_lowering`): collective
    uniformity, axis discipline, numerics flow and byte equality with
    the schedule.  The lint runs in a fake world of its own, so it needs
    no process group and leaves the caller's default group (a live gloo
    or NCCL world) as it was.

    A registration that fails either gate is rolled back out of the
    registry and raises ``ValueError`` with the violation list.
    """
    if collective not in _REGISTRY:
        raise ValueError(
            f"unknown collective {collective!r}; one of {COLLECTIVES}"
        )

    def _register(execute_fn: Callable) -> EngineSpec:
        if name in _REGISTRY[collective] and not override:
            raise ValueError(
                f"{collective} engine {name!r} is already registered; "
                "pass override=True to replace it deliberately"
            )
        spec = EngineSpec(
            name=name,
            collective=collective,
            execute=execute_fn,
            cost=cost,
            build_schedule=build_schedule,
            ops=frozenset(ops) if ops is not None else None,
            regime=regime,
            min_nodes=min_nodes,
            min_ppn=min_ppn,
            chunked=chunked,
            ragged=ragged,
            pipelined_variant=pipelined_variant,
        )
        previous = _REGISTRY[collective].get(name)
        _REGISTRY[collective][name] = spec
        if _verify_on_register_enabled():
            try:
                if verify:
                    _verify_spec_quick(spec)
                # the lint is not gated on ``verify``: an engine with no
                # schedule (a native lowering) still has a program to prove
                _lint_spec_quick(spec)
            except Exception:
                if previous is None:
                    _REGISTRY[collective].pop(name, None)
                else:
                    _REGISTRY[collective][name] = previous
                raise
        return spec

    if execute is not None:
        return _register(execute)

    def decorator(execute_fn: Callable) -> Callable:
        _register(execute_fn)
        return execute_fn

    return decorator


def registered_engines(
    collective: str | None = None,
) -> dict[str, EngineSpec]:
    """The registry (one collective family, or all of them flattened as
    ``"collective:name"``)."""
    if collective is not None:
        if collective not in _REGISTRY:
            raise ValueError(
                f"unknown collective {collective!r}; one of {COLLECTIVES}"
            )
        return dict(_REGISTRY[collective])
    return {
        f"{c}:{n}": s for c, tab in _REGISTRY.items() for n, s in tab.items()
    }


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


def find_engine(name: str) -> EngineSpec:
    """Resolve an engine by name across all collective families."""
    for table in _REGISTRY.values():
        if name in table:
            return table[name]
    raise ValueError(
        f"unknown engine {name!r}; registered: "
        f"{sorted(registered_engines())}"
    )


def engine_schedule(
    name: str,
    n_nodes: int,
    ppn: int,
    *,
    chunks: int = 1,
    elems: int | None = None,
):
    """The message schedule a registered engine executes on an
    ``(n_nodes, ppn)`` grid, built by the calling convention its flags
    declare."""
    spec = find_engine(name)
    if spec.build_schedule is None:
        raise ValueError(f"engine {spec.name!r} has no schedule builder")
    if spec.chunked:
        return spec.build_schedule(n_nodes, ppn, max(1, chunks), elems)
    if spec.ragged:
        return spec.build_schedule(n_nodes, ppn, elems)
    return spec.build_schedule(n_nodes, ppn)


def verify_engine(
    name: str,
    topology: Topology | None = None,
    *,
    n_nodes: int | None = None,
    ppn: int | None = None,
    elems: int | None = None,
    chunks: int = 1,
    grids=None,
    raise_on_violation: bool = True,
):
    """Statically verify a registered engine's schedules with the four
    passes of :mod:`repro_torch.analysis.schedule_verifier` (match
    completeness, deadlock-freedom, exactly-once reduction, byte
    accounting) over one grid (``topology`` or ``n_nodes`` / ``ppn``) or a
    grid list (``grids``; default the registration grids).  Returns the
    reports; raises ``ValueError`` listing every violation unless
    ``raise_on_violation=False``."""
    from ..analysis import schedule_verifier as _sv

    spec = find_engine(name)
    if topology is not None:
        grid_list = [(topology.n_nodes, topology.ppn)]
    elif n_nodes is not None and ppn is not None:
        grid_list = [(n_nodes, ppn)]
    elif grids is not None:
        grid_list = list(grids)
    else:
        grid_list = list(_sv.REGISTER_GRIDS)
    reports = [
        _sv.verify_spec(
            spec, n, p, elems=elems,
            chunks=chunks if chunks > 1 else (2 if spec.chunked else 1),
        )
        for n, p in grid_list
    ]
    bad = [r for r in reports if not r.ok]
    if bad and raise_on_violation:
        raise ValueError(
            f"engine {name!r} failed static verification:\n"
            + "\n".join(_violation_lines(bad))
        )
    return reports


def _verify_on_register_enabled() -> bool:
    return os.environ.get("REPRO_VERIFY_ON_REGISTER", "").lower() in (
        "1", "true", "yes",
    )


def _violation_lines(bad) -> list[str]:
    return [
        f"  ({r.n_nodes}x{r.ppn}, elems={r.elems}) [{v.rule}] {v.message}"
        for r in bad
        for v in r.violations
    ]


def _verify_spec_quick(spec: EngineSpec) -> None:
    """The verify-on-register gate: sweep the registration grids and
    raise (so the caller rolls the registry back) on any violation."""
    from ..analysis import schedule_verifier as _sv

    bad = []
    for n, ppn in _sv.REGISTER_GRIDS:
        for elems in (None, 19):
            r = _sv.verify_spec(
                spec, n, ppn, elems=elems, chunks=2 if spec.chunked else 1
            )
            if not r.ok:
                bad.append(r)
    if bad:
        raise ValueError(
            f"{spec.collective} engine {spec.name!r} failed static "
            "verification on registration:\n"
            + "\n".join(_violation_lines(bad))
        )


#: grids the registration-time lint traces (smaller than the schedule
#: verifier's REGISTER_GRIDS: tracing every rank costs more than graph
#: checks, and the rules are generic in the grid's shape)
_LINT_GRIDS = ((2, 2), (3, 2))


def lint_lowering(
    name: str,
    topology: Topology | None = None,
    *,
    n_nodes: int | None = None,
    ppn: int | None = None,
    elems: int | None = None,
    dtype="float32",
    op: str = "sum",
    chunks: int = 1,
    raise_on_violation: bool = True,
):
    """Lint a registered engine's *executed* program on every rank.

    Runs the engine's ``execute`` as each rank of an ``n_nodes x ppn``
    grid (a ``topology`` or ``n_nodes`` / ``ppn``; default the first of
    :data:`_LINT_GRIDS`) in the SPMD lint's fake world, which needs no
    process group, and lints the set of traces
    (:mod:`repro_torch.analysis.spmd_lint`): collective uniformity,
    axis discipline, numerics flow, and byte accounting, the maximum
    over ranks of the inter-node bytes each sends against the bound the
    engine's *schedule* declares.

    The payload defaults to ``n * ppn * chunks * 4`` elements.  The bound
    comes from the engine's flags, as in the reference: a non-ragged
    schedule builder gives the exact ``max_internode_bytes_per_chip``;
    ragged and chunked engines are held to
    :meth:`Topology.internode_lower_bound` when ``elems`` divides evenly
    (the default payload does); engines with no schedule are byte-audited
    report-only.

    Returns the :class:`~repro_torch.analysis.spmd_lint.SpmdLintReport`;
    raises ``ValueError`` listing every violation unless
    ``raise_on_violation=False``.
    """
    import torch

    from ..analysis import spmd_lint as _sl

    spec = find_engine(name)
    if topology is not None:
        n, p = topology.n_nodes, topology.ppn
    elif n_nodes is not None and ppn is not None:
        n, p = int(n_nodes), int(ppn)
    else:
        n, p = _LINT_GRIDS[0]
    if n < spec.min_nodes or p < spec.min_ppn:
        raise ValueError(
            f"engine {name!r} needs at least "
            f"{spec.min_nodes}x{spec.min_ppn}, got {n}x{p}"
        )
    eff_chunks = chunks if chunks > 1 else (2 if spec.chunked else 1)
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    dt_name = str(dt).replace("torch.", "")
    if elems is None:
        elems = n * p * eff_chunks * 4
    elems = int(elems)

    if spec.collective == "allgather":
        shard = -(-(-(-elems // p)) // n)  # ceil(ceil(e/ppn)/n)
        x = torch.zeros((shard,), dtype=dt)

        def fn(topo, v):
            return spec.execute(v, topology=topo, elems=elems)
    elif spec.collective == "reduce_scatter":
        x = torch.zeros((elems,), dtype=dt)

        def fn(topo, v):
            return spec.execute(v, topology=topo, op=op)
    else:
        x = torch.zeros((elems,), dtype=dt)

        def fn(topo, v):
            return spec.execute(v, topology=topo, op=op,
                                pipeline_chunks=eff_chunks)

    declared = None
    if spec.ragged or spec.chunked:
        if elems % (n * p * eff_chunks) == 0:
            declared = (
                Topology.of(n, p).internode_lower_bound(elems,
                                                        spec.collective)
                * dt.itemsize
            )
    elif spec.build_schedule is not None:
        declared = engine_schedule(
            name, n, p
        ).max_internode_bytes_per_chip(elems * dt.itemsize)

    report = _sl.lint_traced(
        fn, x, n_nodes=n, ppn=p,
        declared_internode_bytes=declared,
        label=f"{spec.collective}:{name}@{n}x{p}/{dt_name}",
        params=topology.params if topology is not None else None,
    )
    if not report.ok and raise_on_violation:
        lines = [f"  [{v.rule}] {v.message}" for v in report.violations]
        raise ValueError(
            f"engine {name!r} program failed the spmd lint on "
            f"{n}x{p} ({dt_name}):\n" + "\n".join(lines)
        )
    return report


def _lint_spec_quick(spec: EngineSpec) -> None:
    """The lint-on-register gate: lint the engine's program over the lint
    grids, raising (so the caller rolls the registry back) on any
    violation.  Runs for every registration, ``verify=False`` included."""
    bad = []
    for n, p in _LINT_GRIDS:
        if n < spec.min_nodes or p < spec.min_ppn:
            continue
        r = lint_lowering(
            spec.name, n_nodes=n, ppn=p, raise_on_violation=False
        )
        if not r.ok:
            bad.append((n, p, r))
    if bad:
        lines = [
            f"  ({n}x{p}) [{v.rule}] {v.message}"
            for n, p, r in bad
            for v in r.violations
        ]
        raise ValueError(
            f"{spec.collective} engine {spec.name!r} program failed the "
            "spmd lint on registration:\n" + "\n".join(lines)
        )


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
    cost=pm.cost_nap, build_schedule=napalg.build_nap_schedule,
    execute=collectives.nap_allreduce,
)
register_engine(
    "mla", ops=collectives.MLA_OPS, regime="bandwidth", min_nodes=2,
    cost=pm.cost_mla, build_schedule=napalg.build_mla_schedule, ragged=True,
    execute=collectives.mla_allreduce, pipelined_variant="mla_pipelined",
)
register_engine(
    "mla_pipelined", ops=collectives.MLA_OPS, regime="bandwidth",
    min_nodes=2, min_ppn=2, cost=_cost_mla_pipelined_opt,
    build_schedule=napalg.build_mla_pipelined_schedule, chunked=True,
    execute=collectives.mla_pipelined_allreduce,
)
register_engine(
    "psum", ops=collectives.ALL_OPS, regime="fallback", cost=pm.cost_psum,
    execute=collectives.psum_allreduce,
)
register_engine(
    "rd", ops=collectives.ALL_OPS, regime="baseline", cost=pm.cost_rd,
    build_schedule=napalg.build_rd_schedule, execute=collectives.rd_allreduce,
)
register_engine(
    "smp", ops=collectives.ALL_OPS, regime="baseline", cost=pm.cost_smp,
    build_schedule=napalg.build_smp_schedule,
    execute=collectives.smp_allreduce,
)
register_engine(
    "ring", ops=collectives.MLA_OPS, regime="baseline",
    execute=collectives.ring_allreduce,
)
register_engine(
    "rabenseifner", ops=collectives.MLA_OPS, regime="baseline",
    execute=collectives.rabenseifner_allreduce,
)


def _exec_flat_rs(x, *, topology, op="sum"):
    return collectives.flat_reduce_scatter(
        x, topology=topology, op=op, f32_accum=topology.n_nodes > 1,
    )


register_engine(
    "mla_rs", collective="reduce_scatter", ops=collectives.MLA_OPS,
    regime="bandwidth", min_nodes=2, cost=pm.cost_reduce_scatter,
    build_schedule=napalg.build_mla_rs_schedule, ragged=True,
    execute=collectives.mla_reduce_scatter,
)
register_engine(
    "psum_scatter", collective="reduce_scatter", ops=collectives.MLA_OPS,
    regime="fallback", cost=pm.cost_reduce_scatter_flat,
    execute=_exec_flat_rs,
)
register_engine(
    "mla_ag", collective="allgather", ops=None, regime="bandwidth",
    min_nodes=2, cost=pm.cost_allgather,
    build_schedule=napalg.build_mla_ag_schedule, ragged=True,
    execute=collectives.mla_allgather,
)
register_engine(
    "all_gather", collective="allgather", ops=None, regime="fallback",
    cost=pm.cost_allgather_flat, execute=collectives.flat_allgather,
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
        collective: str = "allreduce",
        algorithm: str | None = None,
        pipeline_chunks: int | None = None,
    ) -> Decision:
        """The (engine, chunks) decision for an ``nbytes`` payload (the
        policy's ``algorithm`` pins allreduce only)."""
        algo = algorithm if algorithm is not None else (
            self.policy.algorithm if collective == "allreduce" else "auto"
        )
        pin = (
            pipeline_chunks
            if pipeline_chunks is not None
            else self.policy.pipeline_chunks
        )
        if algo != "auto":
            spec = get_engine(algo, collective)
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
            collective=collective,
            small_threshold_bytes=self.policy.small_threshold_bytes,
            pipeline_chunks=pin,
        )

    def _engine_for(
        self, decision: Decision, op: str, collective: str
    ) -> EngineSpec:
        spec = get_engine(decision.engine, collective)
        if spec.ops is not None and op not in spec.ops:
            supporting = sorted(
                s.name
                for s in _REGISTRY[collective].values()
                if s.ops is None or op in s.ops
            )
            raise NotImplementedError(
                f"{collective} engine {spec.name!r} supports "
                f"{sorted(spec.ops)}, got op={op!r}; engines supporting "
                f"it: {supporting}"
            )
        return spec

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
        spec = self._engine_for(d, op, "allreduce")
        return spec.execute(
            x, topology=self.topology, op=op, pipeline_chunks=d.chunks
        )

    def reduce_scatter(self, x, op: str = "sum", *,
                       algorithm: str | None = None):
        """Striped reduce-scatter of the flattened ``x``: rank
        ``(node j, lane r)`` returns the reduced block ``(r, j)`` of the
        MLA stripe layout, padded to the uniform size
        ``ceil(ceil(s/ppn)/n)``."""
        self.topology.require_groups()
        nbytes = int(np.prod(tuple(x.shape))) * x.element_size()
        d = self.dispatch(
            nbytes, op, collective="reduce_scatter", algorithm=algorithm
        )
        spec = self._engine_for(d, op, "reduce_scatter")
        return spec.execute(x, topology=self.topology, op=op)

    def allgather(self, x, *, elems: int | None = None,
                  algorithm: str | None = None):
        """Inverse of :meth:`reduce_scatter`: the full flat payload from
        every rank's block.  ``elems`` is the original size (default
        ``x.numel() * group``, no padding)."""
        self.topology.require_groups()
        total = int(
            elems if elems is not None
            else int(np.prod(tuple(x.shape))) * self.topology.group
        )
        d = self.dispatch(
            total * x.element_size(), "sum", collective="allgather",
            algorithm=algorithm,
        )
        spec = self._engine_for(d, "sum", "allgather")
        return spec.execute(x, topology=self.topology, elems=total)

    def sync_grads(self, grads, *, plan=None, ef_state=None):
        """Bucket-scheduled gradient allreduce of a tree of tensors (see
        :mod:`repro_torch.core.grad_sync`); with ``ef_state`` returns
        ``(synced, new_ef)``."""
        from . import grad_sync

        return grad_sync.sync_with_context(
            grads, self, plan=plan, ef_state=ef_state
        )

    def sync_grads_sharded(self, grads):
        """Sharded sync: reduce-scatter each leaf and return the tree of
        this rank's 1-D shards (see
        :func:`repro_torch.core.grad_sync.sync_grads_sharded`)."""
        from . import grad_sync

        return grad_sync.sync_grads_sharded(grads, ctx=self)

    def plan(self, tree):
        """Host-side bucket plan for a gradient tree under this context."""
        from . import grad_sync

        return grad_sync.plan_for_tree(
            tree, cfg=self.policy, topology=self.topology
        )


# ---------------------------------------------------------------------------
# the legacy ``collectives.ALGORITHMS`` view and deprecation bookkeeping
# ---------------------------------------------------------------------------

#: the allreduce engines the old ``ALGORITHMS`` table named
_LEGACY_NAMES = ("nap", "rd", "smp", "mla", "mla_pipelined", "psum")
_LEGACY_VIEW = types.MappingProxyType(
    {name: _REGISTRY["allreduce"][name].execute for name in _LEGACY_NAMES}
)


def legacy_execute_table():
    """The old ``collectives.ALGORITHMS`` view, derived from the registry:
    read-only (``ALGORITHMS["custom"] = fn`` raises); new engines register
    through :func:`register_engine`."""
    return _LEGACY_VIEW


_DEPRECATION_WARNED: set[str] = set()


def warn_deprecated_once(key: str, replacement: str) -> None:
    """One ``DeprecationWarning`` per shim per process."""
    if key in _DEPRECATION_WARNED:
        return
    _DEPRECATION_WARNED.add(key)
    warnings.warn(
        f"{key} is deprecated; use {replacement} "
        f"(repro_torch.core.comm: Topology + CommContext)",
        DeprecationWarning,
        stacklevel=3,
    )
