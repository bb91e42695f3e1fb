"""Op-trace analysis of one rank's program: flops, memory traffic and
collectives.

The port of ``repro/launch/hlo_analysis.py``.  The port has no compiled
HLO: its counterpart is the op trace of one rank's program, taken by
running the program once under a ``TorchDispatchMode`` (:class:`Tracer`).
The mode sees every aten op below autograd, the backward included, and
every collective, both the functional ones DTensor issues
(``_c10d_functional.*``) and the in-place ``c10d.*`` ops of explicit
``torch.distributed`` calls.  The trace is aggregated by op signature
(op, input and output shapes and dtypes, region) and serialises to JSON
(:meth:`Trace.save`), so :func:`analyze_trace` can re-derive the stats
without tracing again (``repro_torch.launch.reanalyze``).

* **Per chip.**  On a mesh the program runs on DTensors: the mode returns
  ``NotImplemented`` for an op with a DTensor argument, so it sees the
  *local* ops DTensor runs on this rank's shards, and it skips the ops
  DTensor's sharding propagation runs on global shapes (those run under
  a ``FakeTensorMode``).  So the counts are this rank's, as the
  reference's per-device module is.
* **flops**: matrix products (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  ``mv``, ``dot``, and what ``matmul`` / ``einsum`` / ``linear`` lower to)
  at 2 x |out| x K, as the reference's analyzer counts ``dot``s;
  convolutions in ``conv_flops`` of their own; ``flops_by_dtype`` by the
  first operand's type.
* **memory_bytes**: input plus output bytes of every op that moves data;
  views, metadata ops and allocations are skipped (the reference's
  ``_SKIP_MEM_OPS`` / ``_VIEW_OPS``); gathers count twice their result,
  in-place scatters twice their values (the reference's slice rule).
  This is the *eager* program's traffic: every op's operands cross HBM,
  where XLA fuses elementwise chains and counts only fusion boundaries,
  so it is an upper bound on the reference's count.
* **collectives**: kind, dtype, result bytes, group size and the group's
  ranks (``dist.get_process_group_ranks``), and the partition of the world
  the group belongs to where it is known (a ``DeviceMesh`` dimension of
  :mod:`repro_torch.launch.mesh`, a ``Topology``'s grid groups, the world);
  wire bytes by the reference's ring model (:func:`wire_bytes`).
* **Kernel regions** (:func:`repro_torch.trace_regions.kernel_region`):
  a hand-written kernel's declared work replaces the ops inside its
  wrapper; the models' attention score block (``attn``) and recurrences
  (``timescan``) are attributed, forward and backward (through the
  autograd nodes made inside the region), and their declared fused-kernel
  I/O gives ``memory_bytes_kernel``.  A region whose result needs a
  gradient charges twice its I/O again for the backward kernel (it reads
  the forward's streams and the output gradient and writes the input
  gradients).

There are no trip counts to multiply: eager code runs every layer and
microbatch.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import weakref
from collections import Counter
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import trace_regions
from ..trace_regions import kernel_region

__all__ = ["TraceStats", "Trace", "Tracer", "trace_call", "analyze_trace",
           "CollectiveOp", "iter_collectives", "kernel_region", "wire_bytes",
           "COLLECTIVE_KINDS"]

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# op -> (the reference's kind, where the result is: "out" for the returned
# tensors, else the argument holding them).  A broadcast or a send moves
# its tensor once a chip, as a collective-permute does; a receive is the
# other end of a send and is not counted again.
_COLLECTIVE_OPS = {
    "_c10d_functional.all_reduce": ("all-reduce", "out"),
    "_c10d_functional.all_reduce_": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", "out"),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", "out"),
    "_c10d_functional.all_gather_into_tensor_out": ("all-gather", "out"),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather",
                                                          "out"),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", "out"),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter",
                                                         "out"),
    "_c10d_functional.all_to_all_single": ("all-to-all", "out"),
    "_c10d_functional.broadcast": ("collective-permute", "out"),
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allreduce_coalesced_": ("all-reduce", 0),
    "c10d._allgather_base_": ("all-gather", 0),
    "c10d.allgather_": ("all-gather", 0),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 0),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 0),
    "c10d.reduce_scatter_": ("reduce-scatter", 0),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "c10d.alltoall_base_": ("all-to-all", 0),
    "c10d.alltoall_": ("all-to-all", 0),
    "c10d.broadcast_": ("collective-permute", 0),
    "c10d.send": ("collective-permute", 0),
}

# allocations: they move no data, but their storage is live
_ALLOC_OPS = frozenset({"aten.empty", "aten.empty_strided", "aten.empty_like",
                        "aten.new_empty", "aten.new_empty_strided"})
# ops that move no data: allocations, waits, host reads, bookkeeping
_SKIP_OPS = _ALLOC_OPS | frozenset({
    "aten._unsafe_view", "aten._local_scalar_dense",
    "aten.lift_fresh", "aten.set_", "aten.resize_", "aten.record_stream",
    "_c10d_functional.wait_tensor", "_c10d_functional_autograd.wait_tensor",
    "_c10d_functional._wrap_tensor_autograd", "c10d.recv_", "c10d.barrier",
    "c10d.monitored_barrier_",
})
# gathers read what they return: twice the result (the reference's rule)
_GATHER_OPS = frozenset({"aten.index", "aten.gather", "aten.index_select",
                         "aten.embedding"})
# in-place scatters touch what they write: twice the values
_SCATTER_OPS = frozenset({"aten.index_put_", "aten._index_put_impl_",
                          "aten.index_add_", "aten.scatter_add_",
                          "aten.scatter_", "aten.scatter_reduce_"})
# in-place fills write their output and read nothing
_WRITE_OPS = frozenset({"aten.fill_", "aten.zero_", "aten.normal_",
                        "aten.uniform_", "aten.bernoulli_", "aten.random_"})

_DTYPE_BYTES = {
    "float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
    "float8_e4m3fn": 1, "float8_e5m2": 1, "int64": 8, "uint64": 8,
    "int32": 4, "uint32": 4, "int16": 2, "uint16": 2, "int8": 1, "uint8": 1,
    "bool": 1, "complex64": 8, "complex128": 16,
}


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def _sig_bytes(sigs) -> float:
    return float(sum(_numel(s) * _DTYPE_BYTES.get(d, 0) for s, d in sigs))


def wire_bytes(kind: str, result_bytes: float, g: int) -> float:
    """Wire bytes a chip moves for one collective, by the reference's
    ring-traffic model (``repro/launch/roofline.py::collective_bytes``):
    all-reduce 2 x size x (g-1)/g; all-gather size x (g-1)/g (size the
    gathered result); reduce-scatter size x (g-1) (size the scattered
    result); all-to-all size x (g-1)/g; collective-permute size."""
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind == "all-gather":
        return result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return float(result_bytes * (g - 1))
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    if kind == "collective-permute":
        return float(result_bytes)
    raise ValueError(f"unknown collective kind {kind!r}")


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One collective of a traced program, as lint input."""

    kind: str  # the reference's kind
    op: str  # the traced op, e.g. "_c10d_functional.all_gather_into_tensor"
    index: int  # position among the trace's collectives
    dtypes: tuple[str, ...]  # every dtype of the result
    shapes: tuple[tuple[int, ...], ...]  # the result's shapes
    elems: int  # elements of the result
    bytes: float  # result bytes
    group_size: int
    group: tuple[int, ...]  # this rank's group (global ranks)
    replica_groups: tuple[tuple[int, ...], ...]  # its partition; () unknown
    region: str  # the kernel region it ran in ("" outside one)


@dataclasses.dataclass
class Trace:
    """One rank's traced program: op signatures with their counts, the
    collectives in order, the kernel-region events in order, and the peak
    bytes of the tensors the program made (live at once)."""

    rank: int = 0
    world: int = 1
    # (op, ((shape, dtype), ...) inputs, outputs, region kind) -> count
    ops: Counter = dataclasses.field(default_factory=Counter)
    collectives: list = dataclasses.field(default_factory=list)
    events: list = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    # the op signatures in order (kept only when asked: lint_stable_trace)
    sequence: list | None = None

    def to_json(self) -> dict:
        return {
            "version": 1, "rank": self.rank, "world": self.world,
            "peak_bytes": self.peak_bytes,
            "ops": [[op, [[list(s), d] for s, d in ins],
                     [[list(s), d] for s, d in outs], region, n]
                    for (op, ins, outs, region), n in self.ops.items()],
            "collectives": [dataclasses.asdict(c) for c in self.collectives],
            "events": list(self.events),
        }

    @classmethod
    def from_json(cls, obj: dict) -> "Trace":
        sig = lambda xs: tuple((tuple(s), d) for s, d in xs)  # noqa: E731
        ops = Counter({(op, sig(ins), sig(outs), region): n
                       for op, ins, outs, region, n in obj["ops"]})
        cols = []
        for c in obj["collectives"]:
            c = dict(c)
            c["dtypes"] = tuple(c["dtypes"])
            c["shapes"] = tuple(tuple(s) for s in c["shapes"])
            c["group"] = tuple(c["group"])
            c["replica_groups"] = tuple(tuple(g) for g in c["replica_groups"])
            cols.append(CollectiveOp(**c))
        return cls(rank=obj["rank"], world=obj["world"], ops=ops,
                   collectives=cols, events=list(obj["events"]),
                   peak_bytes=obj["peak_bytes"])

    def save(self, path) -> None:
        """Gzipped JSON at ``path``."""
        with gzip.open(Path(path), "wt") as fh:
            json.dump(self.to_json(), fh)

    @classmethod
    def load(cls, path) -> "Trace":
        with gzip.open(Path(path), "rt") as fh:
            return cls.from_json(json.load(fh))


def iter_collectives(trace: Trace):
    """Every collective of a trace, in program order."""
    yield from trace.collectives


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

def _tensors(x, out: list) -> list:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    return out


_DTYPE_NAMES: dict = {}


def _sig(t: torch.Tensor) -> tuple:
    name = _DTYPE_NAMES.get(t.dtype)
    if name is None:
        name = _DTYPE_NAMES[t.dtype] = str(t.dtype).replace("torch.", "")
    return tuple(t.shape), name


def _known_partition(pg, ranks: tuple) -> tuple:
    """The partition of the world that ``pg`` belongs to, where known."""
    import torch.distributed as dist

    world = dist.get_world_size()
    if sorted(ranks) == list(range(world)):
        return (tuple(range(world)),)
    from ..core import comm
    from . import mesh as mesh_mod

    name = pg.group_name
    for _, dm in mesh_mod._DEVICE_MESHES.values():
        for i in range(dm.ndim):
            if dm.get_group(i).group_name == name:
                rows = dm.mesh.movedim(i, -1).reshape(-1, dm.size(i))
                return tuple(tuple(int(r) for r in row)
                             for row in rows.tolist())
    return comm.GROUP_PARTITIONS.get(name, ())


def _process_group(func_name: str, args):
    """The process group a collective op runs on: a functional op names
    it, an in-place ``c10d`` op passes it."""
    if func_name.startswith("_c10d_functional."):
        from torch.distributed.distributed_c10d import _resolve_process_group

        return _resolve_process_group(
            next(a for a in reversed(args) if isinstance(a, str)))
    unbox = torch._C._distributed_c10d.ProcessGroup.unbox
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return unbox(a)
            except RuntimeError:  # a ReduceOp, not the group
                continue
    raise ValueError(f"{func_name}: no process group among its arguments")


class _Region:
    """An open kernel region of a :class:`Tracer`."""

    def __init__(self, tracer, name, io_bytes, flops, kind):
        if kind not in ("kernel", "attn", "timescan"):
            raise ValueError(f"unknown region kind {kind!r}")
        self.tracer, self.name, self.kind = tracer, name, kind
        self.io_bytes, self.flops = io_bytes, flops
        self.outputs: list = []
        self.dtypes: set = set()
        self.seq0 = None

    def output(self, *tensors) -> None:
        self.outputs.extend(tensors)

    def __enter__(self):
        tr = self.tracer
        if self.kind != "kernel" and torch.is_grad_enabled():
            self.seq0 = tr._autograd_seq()
        tr._regions.append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        tr = self.tracer
        tr._regions.pop()
        if exc_type is None:
            tr._close(self)
        return False


class Tracer(TorchDispatchMode):
    """Records one rank's program into :attr:`trace` while active (module
    docstring).  Also the active tracer of
    :func:`~repro_torch.trace_regions.kernel_region`."""

    def __init__(self, *, keep_sequence: bool = False):
        super().__init__()
        import torch.distributed as dist

        on = dist.is_available() and dist.is_initialized()
        self.trace = Trace(rank=dist.get_rank() if on else 0,
                           world=dist.get_world_size() if on else 1,
                           sequence=[] if keep_sequence else None)
        self._regions: list = []
        # id(autograd node) -> (region kind, its sequence number, the
        # region's pending backward event)
        self._bwd: dict = {}
        self._live = 0
        self._storages: dict = {}
        self._paused = False
        self._funcs: dict = {}
        self._groups: dict = {}  # group name -> (ranks, partition)

    def __enter__(self):
        trace_regions.ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            trace_regions.ACTIVE.remove(self)
            self._bwd.clear()

    def region(self, name, io_bytes, flops, kind) -> _Region:
        return _Region(self, name, io_bytes, flops, kind)

    # -- dispatch ------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if types and any(issubclass(t, _dtensor_type()) for t in types):
            # DTensor runs its local ops next, and this mode sees them
            return NotImplemented
        out = func(*args, **kwargs)
        if self._paused or torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            # DTensor's sharding propagation on global shapes: not work
            return out
        self._record(func, args, kwargs, out)
        return out

    def _info(self, func) -> tuple:
        hit = self._funcs.get(func)
        if hit is None:
            name = func._schema.name.replace("::", ".")
            if name in _COLLECTIVE_OPS:
                cat = "collective"
            elif func.is_view or name in _SKIP_OPS:
                cat = "skip"
            else:
                cat = "op"
            # outputs in storage of their own, counted as live bytes
            fresh = (cat == "op" or name in _ALLOC_OPS) \
                and not func._schema.is_mutable
            hit = self._funcs[func] = (name, cat, fresh)
        return hit

    def _record(self, func, args, kwargs, out) -> None:
        name, cat, fresh = self._info(func)
        outs = _tensors(out, [])
        if fresh:
            self._track(outs)
        if cat == "collective":
            self._collective(name, args, kwargs, outs)
            return
        region = self._regions[-1] if self._regions else None
        if region is not None and region.kind == "kernel":
            # charged as the region's declared work; the dtypes it makes
            # (its output's among them) are kept for the wire lint
            region.dtypes.update(_sig(t)[1] for t in outs)
            return
        if cat == "skip":
            return
        tag = region.kind if region is not None else ""
        if not tag and self._bwd:
            node = torch._C._current_autograd_node()
            if node is not None:
                hit = self._bwd.get(id(node))
                if hit is not None and hit[1] == node._sequence_nr():
                    tag = hit[0]
                    self._charge_backward(hit[2])
        ins = tuple(_sig(t) for t in _tensors((args, tuple(kwargs.values())),
                                              []))
        key = (name, ins, tuple(_sig(t) for t in outs), tag)
        self.trace.ops[key] += 1
        if self.trace.sequence is not None:
            self.trace.sequence.append(key)

    def _collective(self, name, args, kwargs, outs) -> None:
        kind, where = _COLLECTIVE_OPS[name]
        res = outs if where == "out" else _tensors(args[where], [])
        sigs = [_sig(t) for t in res]
        group, partition = self._group_info(name, tuple(args)
                                            + tuple(kwargs.values()))
        region = self._regions[-1].name if self._regions else ""
        op = CollectiveOp(
            kind=kind, op=name, index=len(self.trace.collectives),
            dtypes=tuple(d for _, d in sigs),
            shapes=tuple(s for s, _ in sigs),
            elems=sum(_numel(s) for s, _ in sigs),
            bytes=_sig_bytes(sigs), group_size=len(group), group=group,
            replica_groups=partition, region=region)
        self.trace.collectives.append(op)
        if self.trace.sequence is not None:
            self.trace.sequence.append((name, tuple(sigs), group))

    def _group_info(self, func_name: str, args) -> tuple:
        """``(ranks, partition)`` of a collective's group."""
        import torch.distributed as dist

        pg = _process_group(func_name, args)
        hit = self._groups.get(pg.group_name)
        if hit is None:
            ranks = tuple(int(r) for r in dist.get_process_group_ranks(pg))
            hit = self._groups[pg.group_name] = (
                ranks, _known_partition(pg, ranks))
        return hit

    # -- live bytes ----------------------------------------------------------

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = n
            self._live += n
            if self._live > self.trace.peak_bytes:
                self.trace.peak_bytes = self._live
            weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self._live -= self._storages.pop(key, 0)

    # -- regions -------------------------------------------------------------

    def _autograd_seq(self) -> int:
        """The sequence number the next autograd node will get."""
        self._paused = True
        try:
            with torch.enable_grad():
                t = torch.zeros((), requires_grad=True)
                return (t * 1).grad_fn._sequence_nr() + 1
        finally:
            self._paused = False

    def _close(self, region: _Region) -> None:
        value = lambda v: float(v() if callable(v) else v)  # noqa: E731
        io, flops = value(region.io_bytes), value(region.flops)
        ev = {"name": region.name, "kind": region.kind, "io_bytes": io,
              "flops": flops, "phase": "forward",
              "dtypes": sorted(region.dtypes)}
        self.trace.events.append(ev)
        if self.trace.sequence is not None:
            self.trace.sequence.append(("region", region.name, io, flops))
        if region.seq0 is None:
            return
        # the autograd nodes made inside the region: their backward ops are
        # the region's too
        stack = [t.grad_fn for t in region.outputs
                 if isinstance(t, torch.Tensor) and t.grad_fn is not None]
        if not stack:
            return
        seen = set()
        # the backward kernel's event, recorded when the backward first runs
        # one of these nodes (a remat recompute's nodes never run backward)
        pending = {**ev, "io_bytes": 2.0 * io, "flops": 0.0,
                   "phase": "backward"}
        while stack:
            node = stack.pop()
            if node is None or id(node) in seen:
                continue
            seen.add(id(node))
            if not region.seq0 <= node._sequence_nr() < 2 ** 63:
                continue  # made before the region (or a leaf's accumulator)
            # no reference to the node: a remat recompute's graph must die
            # with its saved tensors (an id is matched with its number)
            self._bwd[id(node)] = (region.kind, node._sequence_nr(), pending)
            stack.extend(f for f, _ in node.next_functions)

    def _charge_backward(self, pending: dict) -> None:
        if not pending.get("done"):
            pending["done"] = True
            self.trace.events.append(
                {k: v for k, v in pending.items() if k != "done"})


_DTENSOR = []


def _dtensor_type():
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor

        _DTENSOR.append(DTensor)
    return _DTENSOR[0]


def trace_call(fn, *args, keep_sequence: bool = False, **kwargs):
    """``(fn(*args, **kwargs), trace)``: one call traced."""
    tracer = Tracer(keep_sequence=keep_sequence)
    with tracer:
        out = fn(*args, **kwargs)
    return out, tracer.trace


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TraceStats:
    """The reference's ``HloStats`` fields, per chip, from a trace."""

    flops: float = 0.0
    conv_flops: float = 0.0
    flops_by_dtype: dict = dataclasses.field(default_factory=dict)
    memory_bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: dict = dataclasses.field(
        default_factory=lambda: {
            k: {"bytes": 0.0, "count": 0.0} for k in COLLECTIVE_KINDS
        }
    )
    dots: int = 0
    # per-token recurrences (Mamba, RWKV6): all their traffic, and what a
    # fused scan kernel must still move (its inputs and outputs)
    timescan_memory_bytes: float = 0.0
    timescan_io_bytes: float = 0.0
    # the attention score block, and its flash kernel's q / k / v / o
    attn_memory_bytes: float = 0.0
    attn_io_bytes: float = 0.0
    # launches of hand-written kernels (kernel-region events) by name
    kernel_launches: dict = dataclasses.field(default_factory=dict)

    @property
    def memory_bytes_kernel(self) -> float:
        return (
            self.memory_bytes
            - self.timescan_memory_bytes
            + self.timescan_io_bytes
            - self.attn_memory_bytes
            + self.attn_io_bytes
        )


def _matmul_flops(op: str, ins) -> tuple[float, str] | None:
    """(flops, dtype) of a matrix product, None for anything else."""
    if op in ("aten.mm", "aten.bmm"):
        a, b = ins[0][0], ins[1][0]
        return 2.0 * _numel(a[:-1]) * b[-1] * a[-1], ins[0][1]
    if op in ("aten.addmm", "aten.baddbmm", "aten.addbmm"):
        a, b = ins[1][0], ins[2][0]
        batch = a[0] if len(a) == 3 else 1
        return 2.0 * batch * a[-2] * b[-1] * a[-1], ins[1][1]
    if op in ("aten.mv", "aten.dot", "aten.vdot"):
        a = ins[0][0]
        return 2.0 * _numel(a), ins[0][1]
    if op == "aten.addmv":
        return 2.0 * _numel(ins[1][0]), ins[1][1]
    return None


def _conv_flops(op: str, ins, outs) -> float:
    if op == "aten.convolution":
        w = ins[1][0]
        return 2.0 * _numel(outs[0][0]) * _numel(w[1:])
    if op == "aten.convolution_backward":
        g, w = ins[0][0], ins[2][0]
        return 2.0 * 2.0 * _numel(g) * _numel(w[1:])
    return 0.0


def _mem_bytes(op: str, ins, outs) -> float:
    if op in _GATHER_OPS:
        return 2.0 * _sig_bytes(outs)
    if op in _SCATTER_OPS:
        return 2.0 * _sig_bytes(ins[1:])
    if op == "aten.copy_":
        return _sig_bytes(ins[:2])
    if op in _WRITE_OPS:
        return _sig_bytes(outs)
    return _sig_bytes(ins) + _sig_bytes(outs)


def analyze_trace(trace: Trace) -> TraceStats:
    """The stats of one rank's trace (module docstring)."""
    st = TraceStats()
    by_dtype: Counter = Counter()
    for (op, ins, outs, tag), n in trace.ops.items():
        mm = _matmul_flops(op, ins)
        if mm is not None:
            st.flops += mm[0] * n
            by_dtype[mm[1]] += mm[0] * n
            st.dots += n
        st.conv_flops += _conv_flops(op, ins, outs) * n
        nbytes = _mem_bytes(op, ins, outs) * n
        st.memory_bytes += nbytes
        if tag == "attn":
            st.attn_memory_bytes += nbytes
        elif tag == "timescan":
            st.timescan_memory_bytes += nbytes
    for c in trace.collectives:
        wire = wire_bytes(c.kind, c.bytes, c.group_size)
        st.collectives[c.kind]["bytes"] += wire
        st.collectives[c.kind]["count"] += 1
        st.collective_bytes += wire
        st.memory_bytes += c.bytes  # collectives move HBM bytes too
    launches: Counter = Counter()
    for ev in trace.events:
        if ev["kind"] == "kernel":
            st.memory_bytes += ev["io_bytes"]
            st.flops += ev["flops"]
            by_dtype["kernel"] += ev["flops"]
            launches[ev["name"]] += 1
        elif ev["kind"] == "attn":
            st.attn_io_bytes += ev["io_bytes"]
        else:
            st.timescan_io_bytes += ev["io_bytes"]
    st.flops_by_dtype = {k: v for k, v in sorted(by_dtype.items()) if v}
    st.kernel_launches = dict(sorted(launches.items()))
    return st
