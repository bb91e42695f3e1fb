"""Static schedule verifier: prove a built schedule correct, per engine.

The port of ``repro/analysis/schedule_verifier.py`` (NumPy only), run on
the schedules of :mod:`repro_torch.core.napalg`.

The paper's claims are *structural* — NAP removes duplicate inter-node
messages, MLA bounds the bytes any chip pushes across the slow domain —
and this module proves those structures hold for **any** schedule a
registered engine builds, instead of spot-checking each engine with
bespoke example tests.  Four passes, each an independent re-derivation
that does not trust the schedules' own accounting helpers:

``match``
    Match-completeness of the message endpoints: every send has exactly
    one matching receive (each chip at most once as source and once as
    destination per round — the partial-permutation contract of the
    ``lax.ppermute`` lowering), no orphan receives (a ``recv_chips``
    mask entry with no message behind it folds garbage), no duplicate
    ``(src, dst)`` message within a step, indices in range, fractions
    in ``(0, 1]``.

``deadlock``
    Deadlock-freedom: the ``P2PStep.dep`` chains plus per-chip,
    per-domain (intra- vs inter-node) port ordering must form a DAG consistent
    with emission order.  Cycle detection reports a counterexample
    trace; a forward dep (``dep >= index``) breaks the replay contract
    and is flagged even when no port cycle closes.

``reduction``
    Reduction correctness by symbolic contribution dataflow: each
    chip's state is an integer *count per original contributor* (per
    element for striped engines), folded through every message of the
    schedule.  The postcondition — every chip ends holding every chip's
    contribution **exactly once** — catches duplicates (the precise bug
    class the paper eliminates: a duplicated inter-node message double
    counts a node partial) and drops symmetrically.  ``mla_rs`` /
    ``mla_ag`` get ownership postconditions instead: the RS output
    blocks tile the payload with exactly-once contributions at each
    owner.  The symbolic counts are cross-checked against the NumPy
    replay oracles (``napalg.simulate_allreduce`` /
    ``simulate_mla_allreduce``) on random integer payloads.

``bytes``
    Byte-accounting equality: per-chip inter-node bytes are recomputed
    from the raw endpoint stream (:func:`repro_torch.core.napalg.iter_messages`)
    and must agree with (a) the schedule's own
    ``max_internode_bytes_per_chip`` helper, (b) the simulator's replay
    accounting (:func:`repro_torch.core.simulator.replay_internode_bytes`),
    and (c) the engine's *declared* bound —
    ``napalg.mla_internode_lower_bound`` for the striped allreduce, the
    one-way ``rs``/``ag`` bounds for the halves — rather than trusting
    any one of them.

Entry points: :func:`verify_schedule` (any schedule object),
:func:`verify_spec` (a registered :class:`repro_torch.core.comm.EngineSpec`,
duck-typed so this module never imports ``comm``), and the grid-matrix
sweep :func:`verify_spec_grid`.  ``comm.verify_engine`` is a thin
wrapper over these.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Iterable, Sequence

import numpy as np


class _LazyModule:
    """Deferred import of ``repro_torch.core.napalg``, so that this
    module can be imported from anywhere in the ``repro_torch.core``
    import order (``comm`` imports it inside :func:`verify_engine`)."""

    def __init__(self, name: str):
        self._name = name

    def __getattr__(self, attr):
        mod = importlib.import_module(self._name)
        self.__dict__.update(mod.__dict__)  # short-circuit next access
        return getattr(mod, attr)


napalg = _LazyModule("repro_torch.core.napalg")

__all__ = [
    "Violation",
    "VerificationReport",
    "verify_schedule",
    "verify_spec",
    "verify_spec_grid",
    "build_spec_schedule",
    "GRID_MATRIX",
    "PAYLOAD_ELEMS",
    "REGISTER_GRIDS",
    "STRIPED_KINDS",
    "RULES",
]

RULES = ("match", "deadlock", "reduction", "bytes")

#: schedule kinds whose messages carry payload *fractions* derived from
#: the ragged stripe geometry (element-exact dataflow applies)
STRIPED_KINDS = frozenset({"mla", "mla_pipelined", "mla_rs", "mla_ag"})

#: the default verification grid matrix: degenerate grids (``n=1``,
#: ``ppn=1``), prime node counts, a power grid and mixed shapes — the
#: shapes where balanced-subgroup raggedness, donor rounds and uneven
#: blocks all differ structurally.
GRID_MATRIX = (
    (1, 1), (1, 4), (2, 1), (2, 2), (3, 1), (3, 2), (3, 3), (4, 4),
    (5, 2), (5, 4), (7, 3), (8, 4), (13, 2), (13, 4), (16, 4),
)

#: payload element counts swept per grid: ``None`` is the even
#: (divisibility-ideal) accounting, the rest are ragged (prime or
#: otherwise non-divisible) sizes including the 1-element degenerate.
PAYLOAD_ELEMS = (None, 1, 7, 96, 193)

#: the small grid set ``comm.verify_engine`` proves an engine on by default
#: (a power grid and two ragged ones with prime node counts)
REGISTER_GRIDS = ((2, 2), (3, 2), (5, 3))

_REL_TOL = 1e-6  # float fraction accounting tolerance (pytest.approx's)


@dataclasses.dataclass(frozen=True)
class Violation:
    """One invariant violation found by a verifier pass."""

    rule: str
    message: str

    def __post_init__(self):
        if self.rule not in RULES:
            raise ValueError(f"unknown rule {self.rule!r}; one of {RULES}")


@dataclasses.dataclass(frozen=True)
class VerificationReport:
    """The result of verifying one (engine, grid, payload) cell."""

    engine: str
    collective: str
    n_nodes: int
    ppn: int
    elems: int | None
    chunks: int
    checked: tuple[str, ...] = ()
    violations: tuple[Violation, ...] = ()
    notes: tuple[str, ...] = ()

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_row(self) -> dict:
        """JSON-safe row of the verification table."""
        return {
            "engine": self.engine,
            "collective": self.collective,
            "n": self.n_nodes,
            "ppn": self.ppn,
            "elems": self.elems,
            "chunks": self.chunks,
            "checked": list(self.checked),
            "ok": self.ok,
            "violations": [
                {"rule": v.rule, "message": v.message}
                for v in self.violations
            ],
            "notes": list(self.notes),
        }


# ---------------------------------------------------------------------------
# pass 1: match-completeness
# ---------------------------------------------------------------------------


def check_match(schedule) -> list[Violation]:
    """Endpoint matching: permutation validity, orphans, dup messages."""
    out: list[Violation] = []
    n_chips = schedule.n_chips

    def bad(msg: str) -> None:
        out.append(Violation("match", msg))

    if isinstance(schedule, napalg.NapSchedule):
        for i, step in enumerate(schedule.steps):
            step_dsts: set[int] = set()
            step_pairs: set[tuple[int, int]] = set()
            for rnd_idx, rnd in enumerate(step.rounds):
                srcs: set[int] = set()
                dsts: set[int] = set()
                for src, dst in rnd:
                    if not (0 <= src < n_chips and 0 <= dst < n_chips):
                        bad(
                            f"step {i} round {rnd_idx}: endpoint "
                            f"({src}, {dst}) outside [0, {n_chips})"
                        )
                        continue
                    if src == dst:
                        bad(f"step {i} round {rnd_idx}: self-send on chip {src}")
                    if src in srcs:
                        bad(
                            f"step {i} round {rnd_idx}: chip {src} sends "
                            "twice in one round (not a partial permutation)"
                        )
                    if dst in dsts:
                        bad(
                            f"step {i} round {rnd_idx}: chip {dst} receives "
                            "twice in one round (not a partial permutation)"
                        )
                    if (src, dst) in step_pairs:
                        bad(
                            f"step {i}: duplicate message {src}->{dst} "
                            "(duplicate inter-node payload)"
                        )
                    srcs.add(src)
                    dsts.add(dst)
                    step_pairs.add((src, dst))
                dup = dsts & step_dsts
                for d in sorted(dup):
                    bad(
                        f"step {i}: chip {d} receives in more than one "
                        "round (double-counted partial)"
                    )
                step_dsts |= dsts
            declared = set(step.recv_chips)
            for orphan in sorted(declared - step_dsts):
                bad(
                    f"step {i}: recv_chips lists chip {orphan} but no "
                    "message delivers to it (orphan recv — the fold "
                    "mask would admit garbage)"
                )
            for orphan in sorted(step_dsts - declared):
                bad(
                    f"step {i}: message delivers to chip {orphan} but "
                    "recv_chips omits it (orphan send — the payload "
                    "would be dropped by the fold mask)"
                )
            if len(step.recv_chips) != len(declared):
                bad(f"step {i}: recv_chips contains duplicates")
            for c in step.self_chips:
                if not 0 <= c < n_chips:
                    bad(f"step {i}: self chip {c} outside [0, {n_chips})")
        return out

    for i, step in enumerate(schedule.steps):
        fracs = step.pair_fracs()
        if len(fracs) != len(step.pairs):
            bad(
                f"step {i}: {len(step.pairs)} pairs but {len(fracs)} "
                "fractions"
            )
            continue
        srcs: set[int] = set()
        dsts: set[int] = set()
        pairs_seen: set[tuple[int, int]] = set()
        for (src, dst), f in zip(step.pairs, fracs):
            if not (0 <= src < n_chips and 0 <= dst < n_chips):
                bad(f"step {i}: endpoint ({src}, {dst}) outside [0, {n_chips})")
                continue
            if src == dst:
                bad(f"step {i}: self-send on chip {src}")
            if src in srcs:
                bad(
                    f"step {i}: chip {src} sends twice in one step "
                    "(not a partial permutation)"
                )
            if dst in dsts:
                bad(
                    f"step {i}: chip {dst} receives twice in one step "
                    "(not a partial permutation)"
                )
            if (src, dst) in pairs_seen:
                bad(f"step {i}: duplicate message {src}->{dst}")
            if not (0.0 < f <= 1.0 + 1e-9):
                bad(
                    f"step {i}: message {src}->{dst} carries fraction "
                    f"{f!r} outside (0, 1]"
                )
            srcs.add(src)
            dsts.add(dst)
            pairs_seen.add((src, dst))
    return out


# ---------------------------------------------------------------------------
# pass 2: deadlock-freedom
# ---------------------------------------------------------------------------


def check_deadlock(schedule) -> list[Violation]:
    """``dep`` chains + per-chip/per-domain port order must form a DAG."""
    if isinstance(schedule, napalg.NapSchedule):
        # NAP steps (and rounds within them) execute strictly in
        # sequence — the dependency order is the emission order, acyclic
        # by construction.
        return []

    out: list[Violation] = []
    n_steps = len(schedule.steps)
    ppn = schedule.ppn
    edges: dict[int, set[int]] = {i: set() for i in range(n_steps)}
    edge_kind: dict[tuple[int, int], str] = {}

    for i, step in enumerate(schedule.steps):
        dep = step.dep
        if dep < -1 or dep >= n_steps:
            out.append(
                Violation(
                    "deadlock",
                    f"step {i}: dep {dep} outside [-1, {n_steps})",
                )
            )
            continue
        if dep == i:
            out.append(Violation("deadlock", f"step {i} depends on itself"))
            continue
        if dep >= 0:
            edges[dep].add(i)
            edge_kind[(dep, i)] = "dep"
            if dep > i:
                # a forward dep breaks the replay contract (the
                # event-driven replay resolves deps in emission order)
                # even when no port cycle closes through it
                out.append(
                    Violation(
                        "deadlock",
                        f"step {i} depends on later step {dep} "
                        "(forward dep: replay order cannot satisfy it)",
                    )
                )

    # port-order edges: steps touching the same (chip, domain) port
    # serialize in emission order
    last_use: dict[tuple[int, bool], int] = {}
    for i, step in enumerate(schedule.steps):
        for src, dst in step.pairs:
            inter = src // ppn != dst // ppn
            for chip in (src, dst):
                key = (chip, inter)
                prev = last_use.get(key)
                if prev is not None and prev != i:
                    edges[prev].add(i)
                    edge_kind.setdefault((prev, i), "port")
                last_use[key] = i

    # cycle detection (iterative DFS) with a counterexample trace
    WHITE, GREY, BLACK = 0, 1, 2
    color = [WHITE] * n_steps
    parent: dict[int, int] = {}
    for root in range(n_steps):
        if color[root] != WHITE:
            continue
        stack: list[tuple[int, Iterable[int]]] = [(root, iter(sorted(edges[root])))]
        color[root] = GREY
        while stack:
            node, it = stack[-1]
            advanced = False
            for nxt in it:
                if color[nxt] == GREY:
                    # unwind the counterexample trace nxt -> ... -> node -> nxt
                    trace = [node]
                    cur = node
                    while cur != nxt:
                        cur = parent[cur]
                        trace.append(cur)
                    trace.reverse()
                    trace.append(node)
                    arcs = " -> ".join(
                        f"step {a} ({edge_kind.get((a, b), 'port')})"
                        for a, b in zip(trace, trace[1:])
                    )
                    out.append(
                        Violation(
                            "deadlock",
                            "dependency cycle: "
                            + arcs
                            + f" -> step {trace[-1]}",
                        )
                    )
                    return out
                if color[nxt] == WHITE:
                    color[nxt] = GREY
                    parent[nxt] = node
                    stack.append((nxt, iter(sorted(edges[nxt]))))
                    advanced = True
                    break
            if not advanced:
                color[node] = BLACK
                stack.pop()
    return out


# ---------------------------------------------------------------------------
# pass 3: reduction correctness (symbolic contribution dataflow)
# ---------------------------------------------------------------------------


def _local_counts(counts: np.ndarray, n_nodes: int, ppn: int) -> np.ndarray:
    """Intra-node allreduce over a (n_chips, n_chips) count matrix."""
    m = counts.reshape(n_nodes, ppn, -1)
    m = np.broadcast_to(m.sum(axis=1, keepdims=True), m.shape)
    return m.reshape(counts.shape).copy()


def nap_contribution_counts(schedule: napalg.NapSchedule) -> np.ndarray:
    """Symbolic dataflow over a NAP schedule.

    ``counts[chip, contributor]`` after the final intra-node allreduce;
    a correct schedule yields the all-ones matrix: every chip holds
    every chip's contribution exactly once.
    """
    n, ppn = schedule.n_nodes, schedule.ppn
    n_chips = n * ppn
    counts = _local_counts(np.eye(n_chips, dtype=np.int64), n, ppn)
    for step in schedule.steps:
        snap = counts
        contrib = np.zeros_like(counts)
        for src, dst in step.messages:
            contrib[dst] += snap[src]
        for chip in step.self_chips:
            contrib[chip] += snap[chip]
        counts = _local_counts(contrib, n, ppn)
    return counts


def p2p_contribution_counts(schedule: napalg.P2PSchedule) -> np.ndarray:
    """Symbolic dataflow over a whole-payload P2P schedule (rd/smp/...).

    ``combine=True`` folds the sender's pre-step counts into the
    receiver's; ``combine=False`` *replaces* the receiver's counts (the
    broadcast/return semantics of the executed lowering).
    """
    n_chips = schedule.n_chips
    counts = np.eye(n_chips, dtype=np.int64)
    for step in schedule.steps:
        snap = counts.copy()
        for src, dst in step.pairs:
            if step.combine:
                counts[dst] = counts[dst] + snap[src]
            else:
                counts[dst] = snap[src]
    return counts


def striped_contribution_counts(
    n_nodes: int, ppn: int, elems: int, chunks: int = 1
) -> np.ndarray:
    """Element-exact contribution dataflow of the striped (MLA) engines.

    Walks the exact ragged chunk -> stripe -> block geometry the
    schedule's per-pair fractions are derived from (the ``bytes`` pass
    proves that derivation byte-exact against the schedule itself) with
    integer contribution counters: returns
    ``counts[chip, contributor, elem]``, all-ones iff every chip ends
    holding every contribution of every element exactly once.
    """
    n_chips = n_nodes * ppn
    counts = np.zeros((n_chips, n_chips, elems), dtype=np.int16)
    counts[np.arange(n_chips), np.arange(n_chips), :] = 1
    out = np.zeros_like(counts)
    c_off = 0
    for ce in napalg.ragged_splits(elems, max(1, chunks)):
        if ce == 0:
            continue
        stripes, blocks = napalg.mla_stripe_geometry(n_nodes, ppn, ce)
        s_off = c_off
        for r, sr in enumerate(stripes):
            if sr == 0:
                continue
            sl = slice(s_off, s_off + sr)
            # phase 1 (intra RS): lane-r chip of node j holds node j's
            # stripe partial
            node_part = np.stack(
                [
                    counts[j * ppn : (j + 1) * ppn, :, sl].sum(
                        axis=0, dtype=np.int16
                    )
                    for j in range(n_nodes)
                ]
            )
            # phase 2 (per-lane inter RS): node j reduces its sub-block
            reduced = np.zeros((n_chips, sr), dtype=np.int16)
            b_off = 0
            for bj in blocks[r]:
                if bj:
                    reduced[:, b_off : b_off + bj] = node_part[
                        :, :, b_off : b_off + bj
                    ].sum(axis=0, dtype=np.int16)
                    b_off += bj
            # phases 3/4 (inter + intra AG): every chip gets the stripe
            out[:, :, sl] = reduced[None, :, :]
            s_off += sr
        c_off += ce
    return out


def rs_ownership(
    n_nodes: int, ppn: int, elems: int
) -> tuple[np.ndarray, np.ndarray]:
    """RS postcondition state: ``(owner, counts)``.

    ``owner[elem]`` is the chip that ends holding element ``elem``'s
    fully reduced block (chip ``(node j, lane r)`` owns block ``(r, j)``
    of the stripe geometry); ``counts[contributor, elem]`` are the
    contribution counts at that owner.
    """
    n_chips = n_nodes * ppn
    owner = np.full(elems, -1, dtype=np.int64)
    counts = np.zeros((n_chips, elems), dtype=np.int16)
    stripes, blocks = napalg.mla_stripe_geometry(n_nodes, ppn, elems)
    s_off = 0
    for r, sr in enumerate(stripes):
        b_off = s_off
        for j, bj in enumerate(blocks[r]):
            if bj:
                chip = j * ppn + r
                owner[b_off : b_off + bj] = chip
                counts[:, b_off : b_off + bj] += 1
                b_off += bj
        s_off += sr
    return owner, counts


def _defect_triples(counts: np.ndarray, limit: int = 3) -> str:
    bad = np.argwhere(counts != 1)
    shown = ", ".join(
        f"{tuple(int(v) for v in idx)}: count {int(counts[tuple(idx)])}"
        for idx in bad[:limit]
    )
    more = f" (+{len(bad) - limit} more)" if len(bad) > limit else ""
    return shown + more


def check_reduction(
    schedule,
    *,
    collective: str = "allreduce",
    elems: int | None = None,
    chunks: int = 1,
) -> list[Violation]:
    """Symbolic contribution-set dataflow per chip per step.

    Proves every chip ends holding every chip's contribution exactly
    once (allreduce), or the RS/AG ownership postconditions, and
    cross-checks the symbolic counts against the NumPy replay oracles.
    """
    out: list[Violation] = []
    n, ppn = schedule.n_nodes, schedule.ppn
    n_chips = n * ppn
    rng = np.random.default_rng(n * 1009 + ppn)

    def bad(msg: str) -> None:
        out.append(Violation("reduction", msg))

    if isinstance(schedule, napalg.NapSchedule):
        counts = nap_contribution_counts(schedule)
        if not (counts == 1).all():
            dup = int((counts > 1).sum())
            drop = int((counts == 0).sum())
            bad(
                f"{dup} duplicated and {drop} dropped contributions; "
                "defect (chip, contributor) cells: "
                + _defect_triples(counts)
            )
        # cross-check the symbolic counts against the numeric replay
        vals = rng.integers(1, 97, size=(n_chips, 3)).astype(np.float64)
        predicted = counts.astype(np.float64) @ vals
        replayed = napalg.simulate_allreduce(schedule, vals)
        if not np.array_equal(predicted, replayed):
            bad(
                "symbolic contribution counts disagree with the "
                "simulate_allreduce replay (verifier/oracle drift)"
            )
        return out

    kind = getattr(schedule, "kind", "generic")
    if kind in ("mla", "mla_pipelined"):
        e = elems if elems is not None else n_chips
        counts = striped_contribution_counts(n, ppn, e, chunks)
        if not (counts == 1).all():
            dup = int((counts > 1).sum())
            drop = int((counts == 0).sum())
            bad(
                f"{dup} duplicated and {drop} dropped contributions; "
                "defect (chip, contributor, elem) cells: "
                + _defect_triples(counts)
            )
        vals = rng.integers(1, 97, size=(n_chips, e)).astype(np.float64)
        predicted = np.einsum("pce,ce->pe", counts.astype(np.float64), vals)
        replayed = napalg.simulate_mla_allreduce(
            n, ppn, vals, chunks=max(1, chunks)
        )
        if not np.array_equal(predicted, replayed):
            bad(
                "symbolic contribution counts disagree with the "
                "simulate_mla_allreduce replay (verifier/oracle drift)"
            )
        return out

    if kind == "mla_rs":
        e = elems if elems is not None else n_chips
        owner, counts = rs_ownership(n, ppn, e)
        if (owner < 0).any():
            bad(
                f"{int((owner < 0).sum())} elements of {e} have no "
                "owning chip (RS output blocks do not tile the payload)"
            )
        if not (counts == 1).all():
            bad(
                "RS owners do not hold every contribution exactly "
                "once; defect (contributor, elem) cells: "
                + _defect_triples(counts)
            )
        return out

    if kind == "mla_ag":
        e = elems if elems is not None else n_chips
        owner, _ = rs_ownership(n, ppn, e)
        if (owner < 0).any():
            bad(
                f"{int((owner < 0).sum())} elements of {e} have no "
                "owner in the AG input partition"
            )
        counts_o = np.bincount(owner[owner >= 0], minlength=n_chips)
        stripes, blocks = napalg.mla_stripe_geometry(n, ppn, e)
        for j in range(n):
            for r in range(ppn):
                want = blocks[r][j]
                got = int(counts_o[j * ppn + r])
                if got != want:
                    bad(
                        f"chip ({j}, {r}) owns {got} elements, stripe "
                        f"geometry says {want}"
                    )
        return out

    # whole-payload P2P schedules (rd / smp / generic): fractions must
    # be 1.0 for the multiset semantics to apply — anything fractional
    # of an unknown kind is *unverifiable*, which is a violation, not a
    # vacuous pass.
    fractional = [
        m for m in napalg.iter_messages(schedule) if m.frac != 1.0
    ]
    if fractional:
        m = fractional[0]
        bad(
            f"schedule kind {kind!r} carries fractional payloads (e.g. "
            f"step {m.step} {m.src}->{m.dst} frac {m.frac:.4g}) but "
            "declares no striped kind the verifier can prove; register "
            "it with a known kind or extend the verifier"
        )
        return out
    counts = p2p_contribution_counts(schedule)
    if not (counts == 1).all():
        dup = int((counts > 1).sum())
        drop = int((counts == 0).sum())
        bad(
            f"{dup} duplicated and {drop} dropped contributions; "
            "defect (chip, contributor) cells: " + _defect_triples(counts)
        )
    return out


# ---------------------------------------------------------------------------
# pass 4: byte-accounting equality
# ---------------------------------------------------------------------------


def endpoint_internode_bytes(schedule, s: float) -> np.ndarray:
    """Per-chip inter-node bytes recomputed from the raw endpoint
    stream — the verifier's own accounting, independent of the
    schedules' helpers and the simulator's replay."""
    sends = np.zeros(schedule.n_chips, dtype=np.float64)
    for m in napalg.iter_messages(schedule):
        if m.inter:
            sends[m.src] += m.frac * s
    return sends


def _expected_striped_bytes(
    kind: str, n: int, ppn: int, elems: int, chunks: int, s: float
) -> np.ndarray:
    """Geometry-derived per-chip inter-node bytes for striped engines."""
    ways = 2.0 if kind in ("mla", "mla_pipelined") else 1.0
    sends = np.zeros(n * ppn, dtype=np.float64)
    per_elem = s / float(max(elems, 1))
    for ce in napalg.ragged_splits(elems, max(1, chunks)):
        if ce == 0:
            continue
        stripes, blocks = napalg.mla_stripe_geometry(n, ppn, ce)
        for j in range(n):
            for r in range(ppn):
                sends[j * ppn + r] += (
                    ways * (stripes[r] - blocks[r][j]) * per_elem
                )
    return sends


#: engine kind -> napalg bound-function name (resolved at use so module
#: import stays lazy, see ``_LazyModule``)
_STRIPED_BOUND_NAMES = {
    "mla": "mla_internode_lower_bound",
    "mla_rs": "rs_internode_lower_bound",
    "mla_ag": "ag_internode_lower_bound",
}


def check_bytes(
    schedule,
    *,
    elems: int | None = None,
    chunks: int = 1,
    itemsize: float = 4.0,
) -> list[Violation]:
    """Recompute per-chip inter-node bytes from the schedule itself and
    require equality with the accounting helpers, the simulator replay
    and the engine's declared bound."""
    from ..core import simulator

    out: list[Violation] = []
    n, ppn = schedule.n_nodes, schedule.ppn

    def bad(msg: str) -> None:
        out.append(Violation("bytes", msg))

    e = elems
    s = float((e if e is not None else n * ppn) * itemsize)
    atol = _REL_TOL * max(s, 1.0)

    computed = endpoint_internode_bytes(schedule, s)

    helper = float(schedule.max_internode_bytes_per_chip(s))
    if not math.isclose(
        computed.max(initial=0.0), helper, rel_tol=_REL_TOL, abs_tol=atol
    ):
        bad(
            f"endpoint recomputation gives max {computed.max(initial=0.0):.6g} "
            f"inter-node bytes/chip but max_internode_bytes_per_chip "
            f"reports {helper:.6g}"
        )

    replayed = simulator.replay_internode_bytes(schedule, s)
    if not np.allclose(computed, replayed, rtol=_REL_TOL, atol=atol):
        worst = int(np.argmax(np.abs(computed - replayed)))
        bad(
            f"endpoint recomputation disagrees with the simulator "
            f"replay accounting (chip {worst}: {computed[worst]:.6g} vs "
            f"{replayed[worst]:.6g})"
        )

    if isinstance(schedule, napalg.NapSchedule):
        # NAP messages each carry the full payload: per-chip bytes are
        # (messages sent) x s, already proven equal to the helper above;
        # additionally the declared shape bound: nobody sends more
        # rounds than exist.
        max_rounds = sum(len(st.rounds) for st in schedule.steps)
        if computed.max(initial=0.0) > max_rounds * s + atol:
            bad(
                "a chip sends more inter-node bytes than one full "
                "payload per round"
            )
        return out

    kind = getattr(schedule, "kind", "generic")
    if kind in STRIPED_KINDS:
        ways = 2.0 if kind in ("mla", "mla_pipelined") else 1.0
        if e is None:
            # even (divisibility-ideal) accounting: the builder keeps
            # raw butterfly weights, so chips of nodes that skip steps
            # (non-power node counts) send *less* — the per-chip vector
            # is non-uniform.  The binding chip (node 0 participates in
            # every step) must hit the divisible-stripe closed form
            # exactly.
            expect_max = ways * (s / ppn) * (n - 1) / n
            if not math.isclose(
                computed.max(initial=0.0), expect_max,
                rel_tol=_REL_TOL, abs_tol=atol,
            ):
                bad(
                    f"max inter-node bytes/chip "
                    f"{computed.max(initial=0.0):.6g} != even-stripe "
                    f"closed form {expect_max:.6g}"
                )
            return out
        expected = _expected_striped_bytes(kind, n, ppn, e, chunks, s)
        if not np.allclose(computed, expected, rtol=_REL_TOL, atol=atol):
            worst = int(np.argmax(np.abs(computed - expected)))
            bad(
                f"per-chip bytes diverge from the ragged stripe "
                f"geometry (chip {worst}: schedule {computed[worst]:.6g} "
                f"vs geometry {expected[worst]:.6g})"
            )
        bound_name = _STRIPED_BOUND_NAMES.get(kind)
        if bound_name is not None:
            declared = getattr(napalg, bound_name)(n, ppn, e) * itemsize
            if not math.isclose(
                computed.max(initial=0.0), declared,
                rel_tol=_REL_TOL, abs_tol=atol,
            ):
                bad(
                    f"max inter-node bytes/chip "
                    f"{computed.max(initial=0.0):.6g} != declared "
                    f"uneven-block bound {declared:.6g}"
                )
        else:  # mla_pipelined: chunking may not beat the bound
            floor = (
                napalg.mla_internode_lower_bound(n, ppn, e) * itemsize
            )
            if computed.max(initial=0.0) < floor - atol:
                bad(
                    f"max inter-node bytes/chip "
                    f"{computed.max(initial=0.0):.6g} below the "
                    f"uneven-block lower bound {floor:.6g} "
                    "(accounting must be wrong: no schedule beats it)"
                )
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def verify_schedule(
    schedule,
    *,
    engine: str = "",
    collective: str = "allreduce",
    elems: int | None = None,
    chunks: int = 1,
    itemsize: float = 4.0,
) -> VerificationReport:
    """Run all four verifier passes over one built schedule."""
    violations: list[Violation] = []
    violations += check_match(schedule)
    violations += check_deadlock(schedule)
    violations += check_reduction(
        schedule, collective=collective, elems=elems, chunks=chunks
    )
    violations += check_bytes(
        schedule, elems=elems, chunks=chunks, itemsize=itemsize
    )
    return VerificationReport(
        engine=engine or getattr(schedule, "kind", "?"),
        collective=collective,
        n_nodes=schedule.n_nodes,
        ppn=schedule.ppn,
        elems=elems,
        chunks=chunks,
        checked=RULES,
        violations=tuple(violations),
    )


def build_spec_schedule(spec, n_nodes: int, ppn: int, *, chunks: int = 1,
                        elems: int | None = None):
    """Build the schedule an engine spec executes, from its declared
    calling-convention flags (mirrors ``comm.engine_schedule`` without
    importing ``comm`` — the registry calls into this module at import
    time, so the dependency must point one way only)."""
    if spec.build_schedule is None:
        return None
    if spec.chunked:
        return spec.build_schedule(n_nodes, ppn, max(1, chunks), elems)
    if spec.ragged:
        return spec.build_schedule(n_nodes, ppn, elems)
    return spec.build_schedule(n_nodes, ppn)


def verify_spec(
    spec,
    n_nodes: int,
    ppn: int,
    *,
    elems: int | None = None,
    chunks: int = 1,
    itemsize: float = 4.0,
) -> VerificationReport:
    """Verify one registered engine spec on one grid/payload cell.

    ``spec`` is duck-typed (``name`` / ``collective`` / ``min_nodes`` /
    ``min_ppn`` / ``build_schedule`` / ``chunked`` / ``ragged``) so
    this module never imports the registry.  Engines below their
    declared grid minimum are reported as skipped (the dispatcher never
    sends them there); engines without a schedule builder are reported
    as native single-collective lowerings with nothing to verify.
    """
    base = dict(
        engine=spec.name, collective=spec.collective,
        n_nodes=n_nodes, ppn=ppn, elems=elems,
        chunks=chunks if spec.chunked else 1,
    )
    if n_nodes < spec.min_nodes or ppn < spec.min_ppn:
        return VerificationReport(
            **base,
            notes=(
                f"skipped: grid below engine minimum "
                f"(min_nodes={spec.min_nodes}, min_ppn={spec.min_ppn})",
            ),
        )
    if spec.build_schedule is None:
        return VerificationReport(
            **base,
            notes=(
                "native: engine lowers to a single native collective "
                "(no message schedule to verify)",
            ),
        )
    try:
        schedule = build_spec_schedule(
            spec, n_nodes, ppn,
            chunks=chunks if spec.chunked else 1, elems=elems,
        )
    except Exception as exc:  # builder crash IS a verification failure
        return VerificationReport(
            **base,
            checked=("match",),
            violations=(
                Violation(
                    "match",
                    f"schedule builder crashed: {type(exc).__name__}: {exc}",
                ),
            ),
        )
    return verify_schedule(
        schedule,
        engine=spec.name,
        collective=spec.collective,
        elems=elems,
        chunks=chunks if spec.chunked else 1,
        itemsize=itemsize,
    )


def verify_spec_grid(
    spec,
    grids: Sequence[tuple[int, int]] = GRID_MATRIX,
    payloads: Sequence[int | None] = PAYLOAD_ELEMS,
    *,
    chunk_depths: Sequence[int] = (1, 2, 3),
) -> list[VerificationReport]:
    """Sweep one engine spec over a grid x payload (x chunks) matrix."""
    reports = []
    depths = list(chunk_depths) if spec.chunked else [1]
    for n, ppn in grids:
        for elems in payloads:
            for chunks in depths:
                reports.append(
                    verify_spec(
                        spec, n, ppn, elems=elems, chunks=chunks
                    )
                )
    return reports
