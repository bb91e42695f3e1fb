"""Rule-based lint over a traced program (one rank's op trace).

The port of ``repro/analysis/hlo_lint.py``: the reference's rules read
compiled HLO; these read the op trace of
:mod:`repro_torch.launch.trace_analysis` (its collectives, with their
dtypes, sizes and groups, and its kernel-region events):

* :func:`lint_compressed_wire` — a ``compress_bits``-configured gradient
  sync must put the compressed dtype (``int8`` at 5-8 bits, packed
  ``uint8`` below) on its collectives and must never move a wide-integer
  or payload-sized float across the slow domain.
* :func:`lint_collective_counts` — count budgets (e.g. the fused bucket
  path stays exactly 4 transport launches per bucket no matter how many
  leaves it fuses).
* :func:`lint_stable_trace` — tracing the same step twice must give the
  same op sequence; a divergence means the step's program depends on host
  state (the reference's ``lint_stable_lowering``: under ``jax.jit`` that
  is a silent recompile every step).
* :func:`lint_replica_groups` — every collective's group must belong to a
  partition of the ranks: no rank in two groups, none missing, none out of
  range.

Rules return a list of :class:`LintViolation` (empty = clean); the
:func:`assert_clean` helper turns them into one readable failure.
"""

from __future__ import annotations

import dataclasses

from ..launch.trace_analysis import (CollectiveOp, Trace,  # noqa: F401
                                     iter_collectives, trace_call)

__all__ = [
    "LintViolation",
    "collective_ops",
    "expected_wire_dtype",
    "lint_compressed_wire",
    "lint_collective_counts",
    "lint_stable_trace",
    "lint_replica_groups",
    "assert_clean",
]


@dataclasses.dataclass(frozen=True)
class LintViolation:
    """One lint rule violation on a traced program."""

    rule: str
    message: str

    def to_row(self) -> dict:
        return {"rule": self.rule, "message": self.message}


def collective_ops(trace: Trace) -> list[CollectiveOp]:
    """All collectives of a trace, in program order."""
    return list(iter_collectives(trace))


#: integer dtypes wider than the widest compressed wire word: none of
#: these ever belongs on a compressed transport collective
_WIDE_INT = frozenset({"int16", "uint16", "int32", "uint32", "int64",
                       "uint64"})
_WIDE_FLOAT = frozenset({"float32", "float64"})


def expected_wire_dtype(bits: int) -> str:
    """The on-wire dtype of ``bits``-bit compressed transport: ``int8``
    holds one 5-8 bit word per byte, ``uint8`` packs two <=4-bit nibbles."""
    if not 2 <= bits <= 8:
        raise ValueError(f"compressed transport is 2..8 bits, got {bits}")
    return "int8" if bits >= 5 else "uint8"


def _is_intra_node(c: CollectiveOp, ppn: int | None) -> bool:
    """Whether every group of ``c`` stays inside one node (ranks grouped as
    ``rank // ppn``); a collective whose groups are unknown counts as
    inter-node."""
    groups = c.replica_groups or ((c.group,) if c.group else ())
    if ppn is None or not groups:
        return False
    return all(len({d // ppn for d in g}) <= 1 for g in groups)


def _where(c: CollectiveOp) -> str:
    region = f" in {c.region}" if c.region else ""
    return f"collective #{c.index} ({c.op}){region}"


def lint_compressed_wire(
    trace: Trace,
    *,
    bits: int,
    payload_elems: int | None = None,
    ppn: int | None = None,
) -> list[LintViolation]:
    """Wire-dtype rules for a ``bits``-bit compressed collective step.

    * the compressed dtype must actually appear on a collective (a step
      that quantizes but ships float32 pays the full wire cost), or, with
      no collective at all (one rank), on some op of the program;
    * no collective moves a wide-integer payload;
    * with ``payload_elems``, no *inter-node* collective moves a
      payload-sized float tensor (the uncompressed-gradient leak); with
      ``ppn`` given, collectives whose groups stay inside one node (the
      intra-node phases, float32 by design) are exempt;
    * whole-trace screens: no ``int16`` tensor anywhere, and no
      payload-sized ``int32`` tensor (the unpacked-wire regression).
    """
    out: list[LintViolation] = []
    want = expected_wire_dtype(bits)
    cols = collective_ops(trace)
    sigs = [sig for key in trace.ops for part in key[1:3] for sig in part]
    if cols:
        if not any(want in c.dtypes for c in cols):
            out.append(LintViolation(
                "wire-dtype",
                f"no collective carries the {want} wire dtype expected for "
                f"{bits}-bit compressed transport ({len(cols)} collectives "
                "inspected)"))
        for c in cols:
            for d in c.dtypes:
                if d in _WIDE_INT:
                    out.append(LintViolation(
                        "wire-dtype",
                        f"{_where(c)} moves a wide-integer {d} payload: "
                        f"{c.shapes}"))
                elif (d in _WIDE_FLOAT and payload_elems is not None
                      and c.elems >= payload_elems
                      and not _is_intra_node(c, ppn)):
                    out.append(LintViolation(
                        "wire-dtype",
                        f"{_where(c)} moves a payload-sized {d} tensor "
                        f"({c.elems} elems >= {payload_elems}): "
                        "uncompressed wire"))
    elif not any(d == want for _, d in sigs) and not any(
            want in e.get("dtypes", ()) for e in trace.events):
        # one rank: no collective; the kernels still make the wire
        out.append(LintViolation(
            "wire-dtype",
            f"{want} appears nowhere in the trace (expected for {bits}-bit "
            "compressed transport)"))
    if any(d == "int16" for _, d in sigs):
        out.append(LintViolation(
            "wire-dtype",
            "an int16 tensor appears in the trace: some wire word was "
            "widened to 16 bits"))
    if payload_elems is not None and any(
            d == "int32" and _numel(s) == payload_elems for s, d in sigs):
        out.append(LintViolation(
            "wire-dtype",
            f"an int32 tensor of {payload_elems} elements appears in the "
            "trace: a payload-sized unpacked integer tensor survived"))
    return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def lint_replica_groups(trace: Trace, *,
                        num_devices: int) -> list[LintViolation]:
    """Every collective's groups must *partition* the ranks.

    Where the trace knows the partition a collective's group belongs to
    (``replica_groups``: a ``DeviceMesh`` dimension, a ``Topology``'s grid
    groups, the world) the rule checks the three partition axioms: no rank
    in two groups (double participation double-counts or deadlocks), no
    rank of ``range(num_devices)`` missing (a rank that never joins hangs
    the group), none out of range.  Where it knows only this rank's group,
    the group must hold this rank, lie in range and match its size."""
    out: list[LintViolation] = []
    want = set(range(num_devices))
    for c in iter_collectives(trace):
        where = _where(c)
        if c.replica_groups:
            seen: dict[int, int] = {}
            for g in c.replica_groups:
                for d in g:
                    seen[d] = seen.get(d, 0) + 1
            dup = sorted(d for d, n in seen.items() if n > 1)
            if dup:
                out.append(LintViolation(
                    "replica-groups",
                    f"{where}: ranks {dup} appear in more than one group "
                    f"(overlap): {c.replica_groups}"))
            bogus = sorted(set(seen) - want)
            if bogus:
                out.append(LintViolation(
                    "replica-groups",
                    f"{where}: ranks {bogus} are outside the "
                    f"{num_devices}-rank range: {c.replica_groups}"))
            missing = sorted(want - set(seen))
            if missing:
                out.append(LintViolation(
                    "replica-groups",
                    f"{where}: ranks {missing} appear in no group (gap): "
                    f"{c.replica_groups}"))
            if c.group and c.group not in c.replica_groups:
                out.append(LintViolation(
                    "replica-groups",
                    f"{where}: its group {c.group} is not one of its "
                    f"partition's {c.replica_groups}"))
        else:
            bogus = sorted(set(c.group) - want)
            if bogus or trace.rank not in c.group:
                out.append(LintViolation(
                    "replica-groups",
                    f"{where}: group {c.group} of rank {trace.rank} holds "
                    f"ranks outside the {num_devices}-rank range {bogus} or "
                    "not this rank"))
        if c.group and len(c.group) != c.group_size:
            out.append(LintViolation(
                "replica-groups",
                f"{where}: group size {c.group_size} != {len(c.group)} "
                "ranks"))
    return out


_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
          "collective-permute")


def lint_collective_counts(
    trace: Trace, budgets: dict[str, int | tuple[int, int]]
) -> list[LintViolation]:
    """Count budgets over a trace.

    ``budgets`` maps a key to an exact expected count or an inclusive
    ``(lo, hi)`` range.  A key naming a collective kind (``all-reduce``
    etc.) counts the trace's collectives of that kind; any other key
    counts the kernel launches (forward kernel-region events) whose name
    is the key or starts with ``key + "."`` (``"transport"`` counts both
    transport kernels)."""
    out: list[LintViolation] = []
    for key, budget in budgets.items():
        lo, hi = budget if isinstance(budget, tuple) else (budget, budget)
        if key in _KINDS:
            count = sum(1 for c in iter_collectives(trace) if c.kind == key)
        else:
            count = sum(
                1 for e in trace.events
                if e["kind"] == "kernel" and (
                    e["name"] == key or e["name"].startswith(key + ".")))
        if not lo <= count <= hi:
            want = str(lo) if lo == hi else f"[{lo}, {hi}]"
            out.append(LintViolation(
                "collective-count", f"{count} x {key!r}, budget {want}"))
    return out


def lint_stable_trace(fn, *args, **kwargs) -> list[LintViolation]:
    """Trace ``fn(*args, **kwargs)`` twice and require the same op
    sequence (ops, shapes, dtypes, collectives and their groups, kernel
    regions).  A step whose program depends on host state (a closure
    counter, a size read from a varying attribute) traces differently
    each time: under compilation that is a recompile every step, and
    across ranks a divergence that can hang a collective."""
    _, first = trace_call(fn, *args, keep_sequence=True, **kwargs)
    _, second = trace_call(fn, *args, keep_sequence=True, **kwargs)
    a, b = first.sequence, second.sequence
    if a == b:
        return []
    at = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
              min(len(a), len(b)))
    show = lambda s: s[at] if at < len(s) else "<end>"  # noqa: E731
    return [LintViolation(
        "stable-trace",
        f"tracing the same step twice gave different programs ({len(a)} "
        f"and {len(b)} entries; first divergence at #{at}: {show(a)} vs "
        f"{show(b)}): the step captures varying host state")]


def assert_clean(violations: list[LintViolation], context: str = "") -> None:
    """Raise ``AssertionError`` listing every violation (test helper)."""
    if violations:
        head = f"{context}: " if context else ""
        raise AssertionError(
            head
            + f"{len(violations)} lint violation(s):\n"
            + "\n".join(f"  [{v.rule}] {v.message}" for v in violations)
        )
