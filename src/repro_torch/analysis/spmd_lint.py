"""SPMD lint of the program each rank runs: the middle layer of the proof
chain.

The port of ``repro/analysis/spmd_lint.py``.  The reference lints one
traced jaxpr: one SPMD program whose rank dependence is explicit
(``axis_index``, ``cond``).  The port runs an eager program per rank, which
differs from rank to rank through plain Python (``_ppermute``'s ``if src ==
rank``), so a lint of one rank cannot see a hang.  This module traces
*every* rank of an ``n x ppn`` world and lints the set of traces
(:func:`trace_ranks`, then :func:`lint_ranks`; :func:`lint_traced` does
both):

* **The fake world.**  Each rank runs with a
  :class:`~repro_torch.core.comm.Topology` whose groups (its node group,
  its lane group, the world) are fake process groups of torch's ``fake``
  backend, made for the lint and registered nowhere: every collective
  returns at once, and the lint writes zeros into what it returns (the
  same on every rank).  Permutation rounds go through the groups'
  ``rounds`` hook, not ``batch_isend_irecv`` on the default group.  So the
  lint needs no default process group and leaves the caller's alone: it
  runs beside a live gloo world or the dry run's fake world.  A
  collective on any other group is a finding, and runs on a fake group
  in its place.
* **Data flow** (a ``TorchDispatchMode``), per storage, since c10d
  collectives write in place and views share storage.  Each storage
  carries the levels it may vary over (``inter``: across nodes,
  ``intra``: across a node's lanes), and three flags: ``scale`` (an
  ``abs`` / ``amax`` / ``max`` / max-all-reduce ancestor), ``wire``
  (quantized wire words) and ``net`` (received from another node and not
  yet re-accumulated).  The traced call's tensor arguments vary on every
  level, except those the caller marks uniform (replicated state), and so
  does any tensor first seen as an operand (a closure's); tensors the
  call makes from nothing are uniform.  An all-reduce or all-gather over
  a level's group makes a value uniform on that level; a reduce-scatter,
  an all-to-all or a receive makes it vary.  A kernel region
  (:func:`repro_torch.trace_regions.kernel_region`) is one node from its
  named inputs to its outputs, on the kernel route and the plain route
  alike.

The rules (:data:`SPMD_RULES`), in eager form:

1. **collective-uniformity** — (a) a host read (``.item()``, ``bool()``,
   ``aten.nonzero``...) of a value that may vary, followed by any
   collective in the same trace; (b) the members of a group issue
   different sequences of collectives on it (kind, reduce op, dtype,
   element count), the eager form of a rank-dependent branch.  A
   divergence is also an axis-discipline finding (the sequence is not
   the same on every path), and is reported with the last host read
   before it.
2. **axis-discipline** — every collective's group is one of the rank's
   topology groups; every send has its receive (same pair, count and
   dtype, in the same round); no process group is made inside the traced
   call (``dist.new_group``: the eager way to rebind a communicator the
   caller's topology does not own, the counterpart of ``shard_map``
   shadowing).
3. **numerics-flow** — no sum all-reduce or reduce-scatter of a sub-f32
   float over a group that spans nodes; no ``add`` / ``sum`` fold of a
   sub-f32 value received from another node without an f32 upcast; every
   ``transport.quantize_pack`` scale has max-abs ancestry; wire words
   have the transport's dtype and no wider integer carries them.
4. **byte-accounting** — each rank's inter-node send bytes by the
   reference's model, charged on *input* bytes: ``2 b / g x cross`` for
   an all-reduce, ``b / g x cross`` for a reduce-scatter or all-to-all,
   ``b x cross`` for an all-gather and ``b`` for a send to another node
   (``cross``: the group's members on other nodes; nodes are ``rank //
   ppn``); the maximum over ranks must equal the declared bound.
5. **alias-donation** — a tensor donated to a transport region is never
   read after it, and is never a result of the traced call.

Only Python's rank dependence the tensors cannot see (a slice taken at a
rank-dependent offset) escapes the data flow; the sequence comparison
(b) still catches any that changes what a rank sends.  A program on a
``DeviceMesh`` needs a default group, which the lint never makes: such
programs are not traced here.

Entry points: :func:`lint_traced` over any callable ``fn(topology,
*args)``; :func:`repro_torch.core.comm.lint_lowering` per registered
engine, with the schedule's declared byte bound.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from .. import trace_regions

__all__ = [
    "SPMD_RULES",
    "COLLECTIVE_OPS",
    "SpmdViolation",
    "SpmdLintReport",
    "RankTrace",
    "fake_group",
    "trace_ranks",
    "lint_ranks",
    "lint_traced",
    "assert_spmd_clean",
]

#: the four rule families (+ the donation rule) with one-line contracts
SPMD_RULES = {
    "collective-uniformity": (
        "no collective after a host read of a rank-varying value; every "
        "member of a group issues the same collective sequence"
    ),
    "axis-discipline": (
        "collectives run on the topology's groups, every send meets its "
        "receive, and no group is made inside the traced call"
    ),
    "numerics-flow": (
        "no sub-f32 accumulation across the slow domain; quantize scales "
        "are measured; wire words stay within declared width"
    ),
    "byte-accounting": (
        "trace-recomputed inter-node bytes equal the declared bound"
    ),
    "alias-donation": (
        "a donated transport operand is never read after the call"
    ),
}

#: c10d collectives -> (kind, position of the output argument, position of
#: the input argument); permutation rounds come through the rounds hook
COLLECTIVE_OPS = {
    "c10d.allreduce_": ("all-reduce", 0, 0),
    "c10d._allgather_base_": ("all-gather", 0, 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 0, 1),
    "c10d.alltoall_base_": ("all-to-all", 0, 1),
}
_REDUCE_OPS = {0: "sum", 1: "avg", 2: "product", 3: "min", 4: "max"}

# host reads: the value leaves the device and can steer Python
_HOST_READS = frozenset({
    "aten._local_scalar_dense", "aten.is_nonzero", "aten.equal",
    "aten.nonzero", "aten.nonzero_static", "aten.masked_select",
    "aten.unique", "aten._unique", "aten._unique2", "aten.unique_dim",
    "aten.unique_consecutive",
})
# local sum folds the f32-accumulation rule watches
_FOLD_OPS = frozenset({"aten.add", "aten.add_", "aten.sum"})
# ops that seed scale provenance (max-abs scale computations)
_SCALE_SEEDS = frozenset({
    "aten.abs", "aten.amax", "aten.amin", "aten.max", "aten.min",
    "aten.maximum", "aten.minimum", "aten.clamp_min", "aten.clamp_max",
})
_CONVERTS = frozenset({"aten._to_copy", "aten.to", "aten.copy_"})
_SUB_F32 = frozenset({torch.bfloat16, torch.float16})
_WIDE_INT = frozenset({torch.int16, torch.int32, torch.int64, torch.uint16,
                       torch.uint32, torch.uint64})
_REL_TOL = 1e-6  # byte-accounting comparison tolerance (relative)


@dataclasses.dataclass(frozen=True)
class SpmdViolation:
    """One SPMD lint rule violation."""

    rule: str
    message: str

    def to_row(self) -> dict:
        return {"rule": self.rule, "message": self.message}


@dataclasses.dataclass
class SpmdLintReport:
    """Result of linting one program over every rank of its world."""

    label: str
    violations: list = dataclasses.field(default_factory=list)
    collectives: int = 0
    internode_bytes_per_chip: float | None = None
    declared_bytes: tuple | None = None
    notes: list = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_row(self) -> dict:
        return {
            "label": self.label,
            "ok": self.ok,
            "collectives": self.collectives,
            "internode_bytes_per_chip": self.internode_bytes_per_chip,
            "declared_bytes": (
                list(self.declared_bytes)
                if self.declared_bytes is not None
                else None
            ),
            "notes": list(self.notes),
            "violations": [v.to_row() for v in self.violations],
        }


def _sub_f32(dtype) -> bool:
    return dtype in _SUB_F32 or "float8" in str(dtype)


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------


def fake_group(rank: int, size: int, name: str):
    """A process group of torch's ``fake`` backend, ``rank`` of ``size``,
    registered nowhere (it needs no default group): every collective on it
    returns at once and moves nothing."""
    from torch._C._distributed_c10d import FakeProcessGroup, ProcessGroup
    from torch.testing._internal.distributed.fake_pg import FakeStore

    make = getattr(FakeProcessGroup, "_create_internal", FakeProcessGroup)
    backend = make(int(rank), int(size))
    pg = ProcessGroup(FakeStore(), int(rank), int(size))
    kind = ProcessGroup.BackendType.CUSTOM
    for device in ("cpu", "cuda"):
        pg._register_backend(torch.device(device), kind, backend)
    pg._set_default_backend(kind)
    pg._set_group_name(name)
    return pg


_WORLD_IDS = itertools.count()


@dataclasses.dataclass(frozen=True)
class _GroupInfo:
    key: str  # "intra:<node>", "inter:<lane>" or "world"
    levels: frozenset  # the levels its members differ on
    members: tuple  # grid indices, in group order


class _World:
    """The fake groups of one rank of an ``n x ppn`` grid."""

    def __init__(self, n_nodes, ppn, rank, params, levels):
        from ..core import comm

        self.n, self.ppn, self.rank = n_nodes, ppn, rank
        node, lane = divmod(rank, ppn)
        wid = next(_WORLD_IDS)
        self.groups: dict[str, _GroupInfo] = {}

        def make(key, members, index, lv):
            if len(members) == 1:
                return comm.Group.alone()
            pg = fake_group(index, len(members), f"spmd_lint.{wid}.{key}")
            self.groups[pg.group_name] = _GroupInfo(
                key, frozenset(lv) & levels, tuple(members))
            return comm.Group(pg, len(members), index)

        self.intra = make(f"intra:{node}",
                          range(node * ppn, node * ppn + ppn), lane, {"intra"})
        self.inter = make(f"inter:{lane}", range(lane, n_nodes * ppn, ppn),
                          node, {"inter"})
        self.world = make("world", range(n_nodes * ppn), rank,
                          {"inter", "intra"})
        self.params = params

    def topology(self, rounds):
        """This rank's topology, its permutation rounds run by ``rounds``."""
        from ..core import comm

        return comm.Topology(
            self.n, self.ppn, params=self.params,
            groups=comm.RankGroups(self.rank, self.intra, self.inter,
                                   self.world, rounds=rounds))


# ---------------------------------------------------------------------------
# per-storage data-flow state
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _St:
    """Lattice state of one storage: ``var`` the levels it may vary over;
    ``scale`` max-abs ancestry; ``wire`` quantized wire words; ``net``
    crossed the slow domain without re-accumulation."""

    var: frozenset = frozenset()
    scale: bool = False
    wire: bool = False
    net: bool = False

    def join(self, other: "_St") -> "_St":
        return _St(self.var | other.var, self.scale or other.scale,
                   self.wire or other.wire, self.net or other.net)


_UNIFORM = _St()


def _join(states) -> _St:
    out = _UNIFORM
    for s in states:
        out = out.join(s)
    return out


def _tensors(x, out: list) -> list:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    elif callable(getattr(x, "params", None)):  # a Model
        _tensors(x.params(), out)
    return out


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _whole(t: torch.Tensor) -> bool:
    """Whether ``t`` covers its whole storage."""
    return t.numel() * t.element_size() == t.untyped_storage().nbytes()


def _nbytes(tensors) -> float:
    return float(sum(t.numel() * t.element_size() for t in tensors))


def _op_name(func) -> str:
    return func._schema.name.replace("::", ".")


def _process_group(args):
    from torch._C._distributed_c10d import ProcessGroup

    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return a, ProcessGroup.unbox(a)
            except RuntimeError:  # a ReduceOp, not the group
                continue
    return None, None


def _reduce_op(args) -> str | None:
    for a in args:
        if isinstance(a, torch.ScriptObject) and "ReduceOp" in str(a._type()):
            return _REDUCE_OPS.get(int(a.op()), "other")
    return None


# ---------------------------------------------------------------------------
# one rank's trace
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RankTrace:
    """What one rank's program did, as the rules read it: its collectives
    on each group (``(kind, reduce op, dtype, elems)`` in order, with the
    index of the last host read before each), its permutation rounds
    (``[(send | recv, peer, elems, dtype)]`` each), its inter-node send
    bytes, the transport regions it ran, and the violations found while
    tracing."""

    rank: int
    n_nodes: int
    ppn: int
    sequences: dict = dataclasses.field(default_factory=dict)
    rounds: list = dataclasses.field(default_factory=list)
    host_reads: list = dataclasses.field(default_factory=list)
    internode_bytes: float = 0.0
    collectives: int = 0
    regions: list = dataclasses.field(default_factory=list)
    violations: list = dataclasses.field(default_factory=list)
    bytes_unknown: bool = False


class _Region:
    """An open kernel region of the lint's mode."""

    def __init__(self, mode, name, kind, donate):
        self.mode, self.name, self.kind, self.donate = mode, name, kind, donate
        self.named: dict = {}
        self.outputs: list = []
        self.made: set = set()

    def inputs(self, **named) -> None:
        self.named.update(named)

    def output(self, *tensors) -> None:
        self.outputs.extend(tensors)

    def __enter__(self):
        self.mode._regions.append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        self.mode._regions.pop()
        if exc_type is None:
            self.mode._close(self)
        return False


class _RankMode(TorchDispatchMode):
    """The lint's dispatch mode for one rank (module docstring)."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # nothing runs compiled under the lint: keep __torch_dispatch__
        # unwrapped, so that the first lint does not import torch._dynamo
        # (about 2 s, at engine registration)
        return False

    def __init__(self, world: _World, trace: RankTrace, levels: frozenset):
        super().__init__()
        self.world, self.trace, self.levels = world, trace, levels
        self._state: dict[int, _St] = {}
        self._donated: dict[int, str] = {}
        self._regions: list = []
        self._paused = 0
        self._pending_read = None  # the first varying host read unflagged
        self._flagged: set = set()
        self._fakes: dict = {}

    # -- state -------------------------------------------------------------

    def mark(self, tensors, state: _St) -> None:
        for t in tensors:
            self._set(t, state)

    def _set(self, t, state: _St) -> None:
        key = _key(t)
        if key not in self._state:
            weakref.finalize(t.untyped_storage(), self._forget, key)
        self._state[key] = state

    def _forget(self, key) -> None:
        self._state.pop(key, None)
        self._donated.pop(key, None)

    def _get(self, t) -> _St:
        key = _key(t)
        st = self._state.get(key)
        if st is None:  # first seen as an operand: data of this rank
            st = _St(var=self.levels)
            self._set(t, st)
        return st

    def _update(self, t, state: _St) -> None:
        """A write into ``t``: the whole storage takes ``state``, part of
        it joins."""
        self._set(t, state if _whole(t) else self._get(t).join(state))

    def _flag(self, rule: str, message: str) -> None:
        if (rule, message) not in self._flagged:
            self._flagged.add((rule, message))
            self.trace.violations.append(SpmdViolation(rule, message))

    # -- kernel regions ------------------------------------------------------

    def region(self, name, io_bytes, flops, kind, donate=None):
        return _Region(self, name, kind, donate)

    def _close(self, region: _Region) -> None:
        if region.kind != "kernel":
            return
        tensors = {k: v for k, v in region.named.items()
                   if isinstance(v, torch.Tensor)}
        ins = {k: self._get(v) for k, v in tensors.items()}
        j = _join(ins.values())
        transport = region.name.startswith("transport.")
        self.trace.regions.append((region.name, bool(tensors)))
        if transport and region.name.endswith("quantize_pack"):
            self._check_quantize(region, ins)
            out = _St(j.var, False, True, False)
        elif transport:
            out = _St(j.var, j.scale, False, False)
        else:
            out = j
        for t in region.outputs:
            self._set(t, out)
        declared = {_key(t) for t in region.outputs}
        for key in region.made - declared:
            if key in self._state:
                self._state[key] = out
        if region.donate is not None:
            t = tensors.get(region.donate)
            if t is None:
                raise ValueError(f"{region.name} donates {region.donate!r}, "
                                 "which is not one of its named inputs")
            self._donated[_key(t)] = region.name

    def _check_quantize(self, region, ins) -> None:
        name = region.name
        if "scales" in ins and not ins["scales"].scale:
            self._flag("numerics-flow",
                       f"{name}: its scales operand has no max-abs ancestry "
                       "(undominated scale)")
        bits = region.named.get("bits")
        for t in region.outputs:
            if bits is not None:
                want = torch.uint8 if bits == 4 else torch.int8
                if t.dtype != want:
                    self._flag("numerics-flow",
                               f"{name} emits {t.dtype} wire words; "
                               f"{bits}-bit transport declares {want}")
            elif t.element_size() != 1:
                self._flag("numerics-flow",
                           f"{name} emits {t.dtype} wire words (wider than "
                           "one byte)")

    # -- dispatch ------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._paused:
            return func(*args, **kwargs)
        name = _op_name(func)
        flat = tuple(args) + tuple(kwargs.values())
        if name.startswith("c10d."):
            return self._c10d(func, name, args, kwargs)
        ins = _tensors(flat, [])
        self._check_donated(name, ins)
        out = func(*args, **kwargs)
        outs = _tensors(out, [])
        if self._regions and self._regions[-1].kind == "kernel":
            # one node: its state is set from its operands at its close
            in_keys = {_key(t) for t in ins}
            self._regions[-1].made.update(
                _key(t) for t in outs if _key(t) not in in_keys)
            for t in outs:
                if _key(t) not in self._state:
                    self._set(t, _UNIFORM)
            return out
        states = [self._get(t) for t in ins]
        j = _join(states)
        if name in _HOST_READS and ins:
            self._host_read(name, j)
        if name in _FOLD_OPS and outs and any(s.net for s in states) \
                and _sub_f32(outs[0].dtype):
            self._flag("numerics-flow",
                       f"{name} folds a value received from another node in "
                       f"{outs[0].dtype} without an f32 upcast (accumulation "
                       "must be float32 across the slow domain)")
        if name in _SCALE_SEEDS:
            j = dataclasses.replace(j, scale=True)
        if name in _CONVERTS and outs and outs[0].dtype in (torch.float32,
                                                            torch.float64):
            j = dataclasses.replace(j, net=False)
        self._write_outputs(func, args, kwargs, ins, outs, j)
        return out

    def _write_outputs(self, func, args, kwargs, ins, outs, j) -> None:
        in_keys = {_key(t) for t in ins}
        for t in outs:
            if _key(t) not in in_keys:  # storage of its own
                self._set(t, j)
        for i, arg in enumerate(func._schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            val = args[i] if i < len(args) else kwargs.get(arg.name)
            for t in _tensors(val, []):
                self._set(t, self._get(t).join(j))

    def _check_donated(self, name, ins) -> None:
        for t in ins:
            region = self._donated.get(_key(t))
            if region is not None:
                self._flag("alias-donation",
                           f"{region} declares its operand donated but the "
                           f"buffer is read again by {name} after the call "
                           "(alias hazard)")

    def _host_read(self, name, state: _St) -> None:
        self.trace.host_reads.append((name, tuple(sorted(state.var))))
        if state.var and self._pending_read is None:
            self._pending_read = (name, len(self.trace.host_reads) - 1,
                                  tuple(sorted(state.var)))

    def _before_collective(self, what: str) -> None:
        self.trace.collectives += 1
        if self._pending_read is not None:
            name, idx, var = self._pending_read
            self._pending_read = None
            self._flag("collective-uniformity",
                       f"host read #{idx} ({name}) of a value that may vary "
                       f"over {list(var)} is followed by {what}: group "
                       "members may disagree on reaching it (static hang)")

    # -- collectives -----------------------------------------------------------

    def _c10d(self, func, name, args, kwargs):
        boxed, pg = _process_group(args)
        info = self.world.groups.get(pg.group_name) if pg is not None \
            else None
        if pg is not None and info is None:
            self._flag("axis-discipline",
                       f"{name} runs on a process group of {pg.size()} "
                       "ranks that is none of this rank's topology groups "
                       "(its node, its lane, the world)")
            # never run on a real group: a fake of its shape stands in
            fake = self._fakes.get(pg.group_name)
            if fake is None:
                fake = self._fakes[pg.group_name] = fake_group(
                    pg.rank(), pg.size(), f"spmd_lint.stand_in.{pg.group_name}")
            args = tuple(fake.boxed() if a is boxed else a for a in args)
        self._paused += 1
        try:
            out = func(*args, **kwargs)
        finally:
            self._paused -= 1
        if name in ("c10d.send", "c10d.recv_"):
            # a point-to-point op outside the permutation rounds: no
            # matching and no bytes for it
            self._before_collective(name)
            self.trace.bytes_unknown = True
            if name == "c10d.recv_":
                self.mark(_tensors(args[0], []), _St(var=self.levels))
            return out
        if name not in COLLECTIVE_OPS:
            return out
        kind, out_arg, in_arg = COLLECTIVE_OPS[name]
        outs = _tensors(args[out_arg], [])
        ins = _tensors(args[in_arg], [])
        reduce = _reduce_op(args)
        self._check_donated(name, ins)
        self._before_collective(f"{kind} #{self.trace.collectives}")
        levels = info.levels if info is not None else self.levels
        spans = "inter" in levels  # the group's members are on two nodes
        states = [self._get(t) for t in ins]
        j = _join(states)
        dtype = ins[0].dtype if ins else None
        if kind in ("all-reduce", "reduce-scatter") and reduce in (
                "sum", "avg") and spans and _sub_f32(dtype):
            self._flag("numerics-flow",
                       f"{kind} over a group that spans nodes sum-reduces a "
                       f"{dtype} payload: cross-node accumulation must be "
                       "float32")
        if j.wire and dtype in _WIDE_INT:
            self._flag("numerics-flow",
                       f"{kind} moves a {dtype} value carrying packed wire "
                       "words: exceeds the declared wire width")
        if kind == "all-reduce":
            st = _St(j.var - levels, j.scale or reduce in ("max", "min"),
                     j.wire, False)
        elif kind == "all-gather":
            st = _St(j.var - levels, j.scale, j.wire, j.net or spans)
        else:  # reduce-scatter, all-to-all: position dependent
            st = _St(j.var | levels, j.scale, j.wire,
                     False if kind == "reduce-scatter" else j.net or spans)
        self._paused += 1
        try:
            for t in outs:
                t.zero_()  # the same result on every rank
        finally:
            self._paused -= 1
        for t in outs:
            self._update(t, st)
        if info is not None:
            elems = sum(t.numel() for t in ins)
            self.trace.sequences.setdefault(info.key, []).append(
                ((kind, reduce, str(dtype).replace("torch.", ""), elems),
                 len(self.trace.host_reads) - 1))
            self._account(kind, info, _nbytes(ins))
        else:
            self.trace.bytes_unknown = True
        return out

    def _account(self, kind, info: _GroupInfo, b: float) -> None:
        ppn = self.world.ppn
        me = self.trace.rank // ppn
        g = len(info.members)
        cross = sum(1 for m in info.members if m // ppn != me)
        if kind == "all-reduce":
            self.trace.internode_bytes += 2.0 * b / g * cross
        elif kind in ("reduce-scatter", "all-to-all"):
            self.trace.internode_bytes += b / g * cross
        else:
            self.trace.internode_bytes += b * cross  # all-gather

    # -- permutation rounds ------------------------------------------------------

    def round(self, value, ops) -> None:
        """One ``_ppermute`` round of this rank (every rank calls it, even
        with nothing to move): the sends and receives it posts."""
        ppn = self.world.ppn
        me = self.trace.rank
        src = self._get(value)
        entries = []
        if ops:
            self._before_collective(
                f"permutation round #{len(self.trace.rounds)}")
        for fn, t, peer in ops:
            send = fn is dist.isend
            entries.append(("send" if send else "recv", int(peer),
                            t.numel(), str(t.dtype).replace("torch.", "")))
            crosses = peer // ppn != me // ppn
            if send:
                self._check_donated("a permutation send", [t])
                if crosses:
                    self.trace.internode_bytes += _nbytes([t])
                if src.wire and t.dtype in _WIDE_INT:
                    self._flag("numerics-flow",
                               f"a permutation send moves a {t.dtype} value "
                               "carrying packed wire words: exceeds the "
                               "declared wire width")
                continue
            diff = set()
            if crosses:
                diff.add("inter")
            if peer % ppn != me % ppn:
                diff.add("intra")
            self._paused += 1
            try:
                t.zero_()
            finally:
                self._paused -= 1
            self._set(t, _St(src.var | (frozenset(diff) & self.levels),
                             src.scale, src.wire, src.net or crosses))
        self.trace.rounds.append(entries)


# ---------------------------------------------------------------------------
# tracing every rank
# ---------------------------------------------------------------------------


class _NewGroupGuard:
    """While active, a ``dist.new_group`` inside the traced call is a
    finding and hands back a fake group (a real one would be a collective
    on the caller's world)."""

    def __init__(self, mode: _RankMode):
        self.mode = mode
        self.saved = []

    def __enter__(self):
        from torch.distributed import distributed_c10d as c10d

        mode = self.mode

        def new_group(ranks=None, *a, **k):
            members = sorted(ranks) if ranks else list(
                range(mode.world.n * mode.world.ppn))
            mode._flag("axis-discipline",
                       f"dist.new_group({members}) inside the traced call: "
                       "a communicator the caller's topology does not own "
                       "(the eager form of axis shadowing)")
            me = mode.trace.rank
            index = members.index(me) if me in members else 0
            return fake_group(index, len(members),
                              f"spmd_lint.new_group.{next(_WORLD_IDS)}")

        for mod in (dist, c10d):
            self.saved.append((mod, mod.new_group))
            mod.new_group = new_group
        return self

    def __exit__(self, *exc):
        for mod, fn in reversed(self.saved):
            mod.new_group = fn
        return False


def _levels(n_nodes: int, ppn: int) -> frozenset:
    return frozenset(
        (["inter"] if n_nodes > 1 else []) + (["intra"] if ppn > 1 else []))


def trace_ranks(fn, *args, n_nodes: int, ppn: int, uniform=(),
                params=None) -> list[RankTrace]:
    """Run ``fn(topology, *args)`` as every rank of an ``n_nodes x ppn``
    world, in turn, under the lint (module docstring), and return the
    traces.  Every rank gets its own deep copy of ``args`` (the same
    values on every rank); ``uniform`` lists the positions of arguments
    that are the same on every rank in the real program (replicated
    state); the others are rank-local data.  ``params`` is the topology's
    machine constants."""
    from ..core import perf_model as pm

    levels = _levels(n_nodes, ppn)
    params = params or pm.TPU_V5E_POD
    uniform = set(uniform)
    traces = []
    for rank in range(n_nodes * ppn):
        world = _World(n_nodes, ppn, rank, params, levels)
        trace = RankTrace(rank, n_nodes, ppn)
        mode = _RankMode(world, trace, levels)
        local = copy.deepcopy(args)
        for i, a in enumerate(local):
            mode.mark(_tensors(a, []), _UNIFORM if i in uniform
                      else _St(var=levels))
        topo = world.topology(mode.round)
        trace_regions.ACTIVE.append(mode)
        try:
            with _NewGroupGuard(mode), mode:
                out = fn(topo, *local)
        finally:
            trace_regions.ACTIVE.remove(mode)
        for t in _tensors(out, []):
            region = mode._donated.get(_key(t))
            if region is not None:
                mode._flag("alias-donation",
                           f"{region} declares its operand donated but the "
                           "buffer is returned by the traced call (alias "
                           "hazard)")
        traces.append(trace)
    return traces


# ---------------------------------------------------------------------------
# the rules over the set of traces
# ---------------------------------------------------------------------------


def _sequence_violations(traces) -> list[SpmdViolation]:
    """(b): every member of a group issues the same collective sequence on
    it; the send / receive matching of the permutation rounds."""
    out = []
    by_group: dict[str, dict[int, list]] = {}
    for tr in traces:
        for key, seq in tr.sequences.items():
            by_group.setdefault(key, {})[tr.rank] = seq
    n, ppn = traces[0].n_nodes, traces[0].ppn
    for key in sorted(by_group):
        if key == "world":
            members = range(n * ppn)
        elif key.startswith("intra:"):
            node = int(key.split(":")[1])
            members = range(node * ppn, node * ppn + ppn)
        else:
            lane = int(key.split(":")[1])
            members = range(lane, n * ppn, ppn)
        seqs = {r: by_group[key].get(r, []) for r in members}
        calls = {r: [c for c, _ in s] for r, s in seqs.items()}
        first = next(iter(calls))
        for r in calls:
            if calls[r] == calls[first]:
                continue
            a, b = calls[first], calls[r]
            at = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                      min(len(a), len(b)))
            show = lambda s: s[at] if at < len(s) else "nothing"  # noqa
            reads = []
            for who in (first, r):
                seq = seqs[who]
                idx = seq[min(at, len(seq) - 1)][1] if seq else -1
                if idx >= 0:
                    op, var = traces[who].host_reads[idx]
                    reads.append(f"rank {who}'s host read #{idx} ({op}, "
                                 f"varying over {list(var)})")
            cause = (" after " + " / ".join(reads)) if reads else ""
            what = (f"group {key}: rank {first} issues {show(a)} and rank "
                    f"{r} {show(b)} as collective #{at}{cause}")
            out.append(SpmdViolation(
                "collective-uniformity",
                f"{what}: the members disagree on reaching it (static "
                "hang)"))
            out.append(SpmdViolation(
                "axis-discipline",
                f"{what}: the collective sequence differs between the "
                "members' paths"))
            break
    rounds = {tr.rank: tr.rounds for tr in traces}
    depth = max(len(r) for r in rounds.values())
    for k in range(depth):
        for tr in traces:
            mine = rounds[tr.rank][k] if k < len(rounds[tr.rank]) else []
            for kind, peer, elems, dtype in mine:
                other = rounds.get(peer)
                theirs = other[k] if other is not None and k < len(other) \
                    else []
                want = ("recv" if kind == "send" else "send", tr.rank,
                        elems, dtype)
                if want not in theirs:
                    out.append(SpmdViolation(
                        "axis-discipline",
                        f"permutation round #{k}: rank {tr.rank}'s {kind} "
                        f"({elems} x {dtype}) with rank {peer} has no "
                        f"matching {want[0]} there"))
    return out


def lint_ranks(traces: list[RankTrace], *, declared_internode_bytes=None,
               label: str = "") -> SpmdLintReport:
    """Lint the set of per-rank traces of one program (module docstring):
    the violations found while tracing, the sequence and matching rules
    across ranks, and the byte accounting against
    ``declared_internode_bytes`` (a float or a ``(lo, hi)`` range; None:
    report only)."""
    report = SpmdLintReport(label=label or "program")
    seen = set()
    for tr in traces:
        for v in tr.violations:
            if v not in seen:
                seen.add(v)
                report.violations.append(v)
    report.violations += _sequence_violations(traces)
    report.collectives = max(tr.collectives for tr in traces)
    n, ppn = traces[0].n_nodes, traces[0].ppn
    report.notes.append(f"traced {len(traces)} ranks of {n}x{ppn}")
    regions = [r for tr in traces for r in tr.regions]
    if regions:
        named = sum(1 for _, has in regions if has)
        report.notes.append(f"{len(regions)} kernel regions, {named} with "
                            "named operands")
    if any(tr.bytes_unknown for tr in traces):
        report.notes.append("a collective outside the topology's groups: "
                            "inter-node bytes not modeled")
        return report
    got = max(tr.internode_bytes for tr in traces)
    report.internode_bytes_per_chip = got
    declared = declared_internode_bytes
    if declared is not None:
        if not isinstance(declared, (tuple, list)):
            declared = (float(declared), float(declared))
        lo, hi = float(declared[0]), float(declared[1])
        report.declared_bytes = (lo, hi)
        tol = _REL_TOL * max(1.0, hi)
        if not (lo - tol <= got <= hi + tol):
            report.violations.append(SpmdViolation(
                "byte-accounting",
                f"trace-recomputed inter-node bytes/chip {got:.1f} outside "
                f"the declared bound [{lo:.1f}, {hi:.1f}]"))
    return report


def lint_traced(fn, *args, n_nodes: int, ppn: int, uniform=(),
                declared_internode_bytes=None, label: str = "",
                params=None) -> SpmdLintReport:
    """Trace ``fn(topology, *args)`` as every rank of an ``n_nodes x ppn``
    world (:func:`trace_ranks`) and lint the traces (:func:`lint_ranks`).
    This is what the tests and the ``--spmd`` sweep use;
    :func:`repro_torch.core.comm.lint_lowering` wraps it per registered
    engine with the schedule-declared byte bound filled in."""
    traces = trace_ranks(fn, *args, n_nodes=n_nodes, ppn=ppn,
                         uniform=uniform, params=params)
    return lint_ranks(traces, declared_internode_bytes=declared_internode_bytes,
                      label=label)


def assert_spmd_clean(report: SpmdLintReport) -> None:
    """Raise ``AssertionError`` listing every violation (test helper)."""
    if not report.ok:
        raise AssertionError(
            f"{report.label}: {len(report.violations)} SPMD lint "
            "violation(s):\n"
            + "\n".join(
                f"  [{v.rule}] {v.message}" for v in report.violations
            )
        )
