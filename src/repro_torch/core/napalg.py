"""NAP (Node-Aware Parallel) allreduce schedule construction.

The port of ``repro/core/napalg.py`` (pure Python/NumPy, no torch needed):
the static communication schedules of the paper

    "Node-Aware Improvements to Allreduce", Bienz, Olson, Gropp (2019)

over a logical grid of ``n_nodes`` nodes with ``ppn`` ranks each.

* :func:`build_nap_schedule` — the latency-regime NAP allreduce: an
  intra-node allreduce, ``ceil(log_ppn(n_nodes))`` inter-node exchange
  steps over balanced (possibly ragged, with donor repair) subgroups, and
  an intra-node allreduce after each step (paper §III, §III.A).
* :func:`build_mla_schedule` / :func:`build_mla_pipelined_schedule` — the
  bandwidth-regime multi-lane engine (striped RS+AG over ``ppn`` lanes,
  optionally split into ``C`` ragged pipeline chunks), with ragged
  per-pair byte fractions from :func:`mla_stripe_geometry`.
* :func:`build_mla_rs_schedule` / :func:`build_mla_ag_schedule` — the
  striped reduce-scatter (the first two MLA phases) and allgather (the
  last two), whose per-rank inter-node bytes equal the one-way lower
  bounds.
* :func:`build_rd_schedule` / :func:`build_smp_schedule` — the paper's
  baselines: node-agnostic recursive doubling (§II, Fig. 3) and MPICH's
  SMP master-process allreduce (§II.A, Fig. 4), with the MPICH fold for
  non-power-of-two counts.
* :func:`iter_messages` — every message of any schedule in one normal
  form (:class:`ScheduleMessage`), the schedule verifier's input;
  :func:`p2p_recv_masks` / :func:`step_mask_tables` — the host-constant
  receive masks the engines execute; :func:`message_counts` — NAP's
  inter-node message statistics.
* :func:`simulate_allreduce` / :func:`simulate_mla_allreduce` — NumPy
  interpreters of the schedules, the tests' oracles.

Rank numbering is SMP-style (paper §III): ``rank = node * ppn + lane``.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, replace as dataclass_replace
from typing import Callable, Sequence

import numpy as np

__all__ = [
    "NapStep",
    "NapSchedule",
    "P2PStep",
    "P2PSchedule",
    "ScheduleMessage",
    "iter_messages",
    "build_nap_schedule",
    "build_rd_schedule",
    "build_smp_schedule",
    "build_mla_schedule",
    "build_mla_rs_schedule",
    "build_mla_ag_schedule",
    "build_mla_pipelined_schedule",
    "ragged_splits",
    "chunk_offsets",
    "chunk_alignment",
    "mla_stripe_geometry",
    "mla_internode_lower_bound",
    "rs_internode_lower_bound",
    "ag_internode_lower_bound",
    "step_mask_tables",
    "p2p_recv_masks",
    "simulate_allreduce",
    "simulate_mla_allreduce",
    "message_counts",
    "nap_num_steps",
]

# ---------------------------------------------------------------------------
# schedule data structures
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NapStep:
    """One inter-node step of the NAP allreduce.

    Attributes:
      rounds: tuple of ppermute rounds; each round is a tuple of
        ``(src_chip, dst_chip)`` pairs forming a partial permutation (each
        chip appears at most once as a source and at most once as a
        destination per round).  Round 0 carries the main pairwise
        exchange; later rounds exist only when ragged subgroups make one
        donor chip serve several orphaned receivers.
      recv_chips: chips that receive a partial this step (any round).
      self_chips: idle chips whose *own* value participates in the
        following intra-node allreduce (local rank == own subgroup index).
      groups: the node grouping this step reduces over — a tuple of groups,
        each a tuple of subgroups, each a tuple of node ids.  Kept for
        introspection, simulation and tests.
    """

    rounds: tuple[tuple[tuple[int, int], ...], ...]
    recv_chips: tuple[int, ...]
    self_chips: tuple[int, ...]
    groups: tuple[tuple[tuple[int, ...], ...], ...]

    @property
    def messages(self) -> list[tuple[int, int]]:
        """All (src, dst) messages of this step, across rounds."""
        return [pair for rnd in self.rounds for pair in rnd]


@dataclass(frozen=True)
class NapSchedule:
    """A full NAP allreduce schedule over ``n_nodes`` x ``ppn`` chips."""

    n_nodes: int
    ppn: int
    steps: tuple[NapStep, ...]

    @property
    def n_chips(self) -> int:
        return self.n_nodes * self.ppn

    @property
    def num_internode_steps(self) -> int:
        return len(self.steps)

    def max_messages_per_chip(self) -> int:
        """Maximum number of inter-node messages *sent* by any chip."""
        sends = np.zeros(self.n_chips, dtype=np.int64)
        for step in self.steps:
            for src, dst in step.messages:
                if src != dst:
                    sends[src] += 1
        return int(sends.max(initial=0))

    def total_internode_messages(self) -> int:
        return sum(
            sum(1 for s, d in step.messages if s != d) for step in self.steps
        )

    def max_internode_bytes_per_chip(self, s: float) -> float:
        """Every NAP message carries the full payload."""
        return float(self.max_messages_per_chip() * s)


# ---------------------------------------------------------------------------
# grouping: balanced, top-down
# ---------------------------------------------------------------------------


def nap_num_steps(n_nodes: int, ppn: int) -> int:
    """ceil(log_ppn(n_nodes)); 0 for a single node."""
    if n_nodes <= 1:
        return 0
    if ppn < 2:
        raise ValueError("NAP requires ppn >= 2 for multi-node reductions")
    return max(1, math.ceil(math.log(n_nodes) / math.log(ppn) - 1e-12))


def _balanced_split(nodes: Sequence[int], k: int) -> list[list[int]]:
    """Split ``nodes`` into ``k`` contiguous parts with sizes differing <=1.

    Larger parts come first, so ragged "extra" positions live in the
    leading subgroups — matching the paper's "subgroups with extra nodes".
    """
    n = len(nodes)
    base, rem = divmod(n, k)
    out, start = [], 0
    for i in range(k):
        size = base + (1 if i < rem else 0)
        out.append(list(nodes[start : start + size]))
        start += size
    return [p for p in out if p]


def _build_levels(
    nodes: list[int], n_steps: int, ppn: int
) -> list[list[list[list[int]]]]:
    """Recursive balanced grouping.

    Returns ``levels`` where ``levels[i]`` is the list of *groups* reduced
    at step ``i`` (0 = first inter-node step), each group being a list of
    subgroups (node-id lists).  Step ``i``'s subgroups are exactly step
    ``i-1``'s groups, so the §III invariant (all chips of a subgroup hold
    the identical partial) holds by construction.
    """
    levels: list[list[list[list[int]]]] = [[] for _ in range(n_steps)]
    if n_steps == 0 or len(nodes) <= 1:
        return levels

    # Number of subgroups of the (final) top-level step.  Each subgroup must
    # be reducible within the remaining n_steps - 1 steps, i.e. its size
    # must not exceed ppn ** (n_steps - 1).
    cap = ppn ** (n_steps - 1)
    k = min(ppn, math.ceil(len(nodes) / cap))
    subgroups = _balanced_split(nodes, k)
    levels[n_steps - 1] = [subgroups]

    for sg in subgroups:
        sub_levels = _build_levels(sg, n_steps - 1, ppn)
        for i in range(n_steps - 1):
            levels[i].extend(sub_levels[i])
    return levels


# ---------------------------------------------------------------------------
# schedule construction
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def build_nap_schedule(n_nodes: int, ppn: int) -> NapSchedule:
    """Build the full NAP schedule (paper Algorithm 1 + §III.A extension).

    Cached: schedule construction is pure in ``(n_nodes, ppn)`` and sits on
    the trace-time hot path of every ``nap_allreduce`` call, so repeated
    traces at the same grid shape hit ``lru_cache`` instead of re-running
    the recursive grouping.
    """
    if n_nodes < 1 or ppn < 1:
        raise ValueError("n_nodes and ppn must be positive")
    n_steps = nap_num_steps(n_nodes, ppn) if n_nodes > 1 else 0
    levels = _build_levels(list(range(n_nodes)), n_steps, ppn)

    steps: list[NapStep] = []
    for level in levels:
        rounds: list[list[tuple[int, int]]] = [[]]
        # per-round source occupancy to keep each round a valid permutation
        used_src: list[set[int]] = [set()]
        used_dst: list[set[int]] = [set()]
        recv: set[int] = set()
        selfc: set[int] = set()

        def emit(src: int, dst: int) -> None:
            """Place (src, dst) in the earliest round where both are free."""
            for i in range(len(rounds)):
                if src not in used_src[i] and dst not in used_dst[i]:
                    rounds[i].append((src, dst))
                    used_src[i].add(src)
                    used_dst[i].add(dst)
                    return
            rounds.append([(src, dst)])
            used_src.append({src})
            used_dst.append({dst})

        covered: set[int] = set()
        for group in level:
            k = len(group)
            for sg in group:
                covered.update(sg)
            if k <= 1:
                # degenerate group: its single subgroup already holds the
                # partial.  Exactly ONE rank per node re-contributes it so
                # the closing intra-node allreduce is value-preserving for
                # non-idempotent ops (sum/prod).
                for sg in group:
                    for node in sg:
                        selfc.add(node * ppn)
                continue
            sizes = [len(sg) for sg in group]
            # round-robin donor cursor per target subgroup
            donor_cursor = [0] * k
            for m, sg in enumerate(group):
                for q, node in enumerate(sg):
                    for r in range(ppn):
                        chip = node * ppn + r
                        if r == m:
                            # idle/self chip: own value feeds the local
                            # reduction (and may donate, handled below).
                            selfc.add(chip)
                            continue
                        if r >= k:
                            continue  # inactive rank: contributes identity
                        if q < sizes[r]:
                            partner_node = group[r][q]
                            partner = partner_node * ppn + m
                            emit(chip, partner)  # deliver subgroup m partial
                            recv.add(partner)
                        # else: our partner node does not exist; subgroup
                        # m's partial still reaches subgroup r through the
                        # positions that do exist.  Our own *receive* is
                        # repaired by a donor below.
            # donor repair: chip (m, q, r) with q >= sizes[r] receives the
            # subgroup-r partial from subgroup r's idle chip (paper §III.A,
            # Fig. 9: P14 <- P34).
            for m, sg in enumerate(group):
                for q, node in enumerate(sg):
                    for r in range(k):
                        if r == m or q < sizes[r]:
                            continue
                        orphan = node * ppn + r
                        donor_node = group[r][donor_cursor[r] % sizes[r]]
                        donor_cursor[r] += 1
                        donor = donor_node * ppn + r  # idle chip of sg r
                        emit(donor, orphan)
                        recv.add(orphan)

        # Nodes untouched by any group this step (singleton subtrees of the
        # ragged recursion) keep their value: one rank re-contributes it.
        for node in range(n_nodes):
            if node not in covered:
                selfc.add(node * ppn)

        steps.append(
            NapStep(
                rounds=tuple(tuple(rnd) for rnd in rounds if rnd),
                recv_chips=tuple(sorted(recv)),
                self_chips=tuple(sorted(selfc)),
                groups=tuple(
                    tuple(tuple(sg) for sg in group) for group in level
                ),
            )
        )
    return NapSchedule(n_nodes=n_nodes, ppn=ppn, steps=tuple(steps))

# ---------------------------------------------------------------------------
# baseline schedules (for the simulator / message-count comparisons)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class P2PStep:
    """One step of a point-to-point baseline schedule.

    ``pairs`` is a list of (src, dst) messages issued concurrently;
    ``combine`` marks whether receivers fold the payload into their value;
    ``frac`` is the fraction of the full reduction payload each message of
    this step carries (1.0 for whole-payload exchanges; striped schedules
    like MLA move ``1/ppn`` or ``1/(n*ppn)`` of the bytes per message).

    Ragged / pipelined extensions:

    ``fracs`` (optional) gives a *per-pair* payload fraction, overriding
    the scalar ``frac`` — uneven-block (ragged) stripes make messages of
    one step carry different byte counts.  ``chunk`` tags the pipeline
    chunk this step belongs to, and ``dep`` is the index (into the owning
    schedule's ``steps``) of the same-chunk predecessor that must complete
    before this step may start (``-1`` for none).  Steps of *different*
    chunks carry no data dependency — only per-chip, per-domain port
    contention serialises them, which is exactly the overlap the
    pipelined MLA engine exploits.
    """

    pairs: tuple[tuple[int, int], ...]
    combine: bool = True
    frac: float = 1.0
    fracs: tuple[float, ...] | None = None
    chunk: int = 0
    dep: int = -1

    def pair_fracs(self) -> tuple[float, ...]:
        """Per-pair payload fractions (scalar ``frac`` broadcast)."""
        if self.fracs is not None:
            return self.fracs
        return (self.frac,) * len(self.pairs)


@dataclass(frozen=True)
class P2PSchedule:
    """A flat schedule of point-to-point steps plus metadata."""

    n_nodes: int
    ppn: int
    steps: tuple[P2PStep, ...]
    kind: str = "generic"
    chunks: int = 1

    @property
    def n_chips(self) -> int:
        return self.n_nodes * self.ppn

    def max_internode_messages_per_chip(self) -> int:
        sends = np.zeros(self.n_chips, dtype=np.int64)
        for step in self.steps:
            for src, dst in step.pairs:
                if src // self.ppn != dst // self.ppn:
                    sends[src] += 1
        return int(sends.max(initial=0))

    def max_internode_bytes_per_chip(self, s: float) -> float:
        """Max over chips of inter-node bytes *sent* for an ``s``-byte
        reduction — the quantity the striped MLA path divides by ppn."""
        sends = np.zeros(self.n_chips, dtype=np.float64)
        for step in self.steps:
            for (src, dst), f in zip(step.pairs, step.pair_fracs()):
                if src // self.ppn != dst // self.ppn:
                    sends[src] += f * s
        return float(sends.max(initial=0.0))


@dataclass(frozen=True)
class ScheduleMessage:
    """One send/recv endpoint pair of any schedule, in a uniform shape.

    The normal form the static analyses (:mod:`repro_torch.analysis`) iterate:
    NAP steps flatten their donor rounds into ``(step, round)`` positions
    with ``frac=1.0`` (every NAP message carries the full payload);
    P2P steps broadcast their scalar/ragged fractions per pair.  ``inter``
    is the slow-domain flag (``src`` and ``dst`` live on different
    nodes), derived once here so every consumer shares one definition.
    """

    step: int
    round: int
    src: int
    dst: int
    frac: float
    chunk: int
    combine: bool
    inter: bool


def iter_messages(schedule):
    """Yield every message of a :class:`NapSchedule` or
    :class:`P2PSchedule` as a :class:`ScheduleMessage`.

    The single endpoint-iteration point for schedule-shape consumers
    that must not trust the schedules' own accounting helpers (the
    verifier recomputes byte totals from these records and *checks* the
    helpers against them).
    """
    ppn = schedule.ppn
    if isinstance(schedule, NapSchedule):
        for i, step in enumerate(schedule.steps):
            for rnd_idx, rnd in enumerate(step.rounds):
                for src, dst in rnd:
                    yield ScheduleMessage(
                        step=i, round=rnd_idx, src=src, dst=dst,
                        frac=1.0, chunk=0, combine=True,
                        inter=src // ppn != dst // ppn,
                    )
        return
    for i, step in enumerate(schedule.steps):
        for (src, dst), frac in zip(step.pairs, step.pair_fracs()):
            yield ScheduleMessage(
                step=i, round=0, src=src, dst=dst, frac=float(frac),
                chunk=step.chunk, combine=step.combine,
                inter=src // ppn != dst // ppn,
            )


@functools.lru_cache(maxsize=None)
def build_rd_schedule(n_nodes: int, ppn: int) -> P2PSchedule:
    """Node-agnostic recursive doubling over all p = n*ppn chips.

    Non-power-of-two counts use the standard MPICH fold: the first
    ``2*rem`` chips pre-combine into ``rem`` survivors, a power-of-two core
    runs the butterfly, and results are returned to the folded chips.
    """
    p = n_nodes * ppn
    steps: list[P2PStep] = []
    pow2 = 1 << (p.bit_length() - 1)
    rem = p - pow2
    # fold: odd chips of the first 2*rem send to their even neighbour
    if rem:
        steps.append(
            P2PStep(tuple((2 * i + 1, 2 * i) for i in range(rem)))
        )
    core = [2 * i for i in range(rem)] + list(range(2 * rem, p))
    for bit in range(int(math.log2(pow2)) if pow2 > 1 else 0):
        pairs = []
        for idx, chip in enumerate(core):
            partner = core[idx ^ (1 << bit)]
            pairs.append((chip, partner))
        steps.append(P2PStep(tuple(pairs)))
    if rem:
        steps.append(
            P2PStep(
                tuple((2 * i, 2 * i + 1) for i in range(rem)), combine=False
            )
        )
    return P2PSchedule(n_nodes, ppn, tuple(steps), kind="rd")


@functools.lru_cache(maxsize=None)
def build_smp_schedule(n_nodes: int, ppn: int) -> P2PSchedule:
    """MPICH SMP allreduce: local tree reduce -> RD among masters -> bcast."""
    steps: list[P2PStep] = []

    # intra-node binomial-tree reduction to local rank 0
    span = 1
    while span < ppn:
        pairs = []
        for node in range(n_nodes):
            base = node * ppn
            for r in range(0, ppn, 2 * span):
                if r + span < ppn:
                    pairs.append((base + r + span, base + r))
        if pairs:
            steps.append(P2PStep(tuple(pairs)))
        span *= 2
    # recursive doubling among masters (chip = node*ppn)
    masters = [node * ppn for node in range(n_nodes)]
    pow2 = 1 << (n_nodes.bit_length() - 1)
    rem = n_nodes - pow2
    if rem:
        steps.append(
            P2PStep(tuple((masters[2 * i + 1], masters[2 * i]) for i in range(rem)))
        )
    core = [masters[2 * i] for i in range(rem)] + masters[2 * rem :]
    for bit in range(int(math.log2(pow2)) if pow2 > 1 else 0):
        pairs = []
        for idx, chip in enumerate(core):
            partner = core[idx ^ (1 << bit)]
            pairs.append((chip, partner))
        steps.append(P2PStep(tuple(pairs)))
    if rem:
        steps.append(
            P2PStep(
                tuple((masters[2 * i], masters[2 * i + 1]) for i in range(rem)),
                combine=False,
            )
        )
    # intra-node binomial-tree broadcast from rank 0
    span = 1 << max(0, (ppn - 1).bit_length() - 1)
    bcast_steps = []
    while span >= 1:
        pairs = []
        for node in range(n_nodes):
            base = node * ppn
            for r in range(0, ppn, 2 * span):
                if r + span < ppn:
                    pairs.append((base + r, base + r + span))
        if pairs:
            bcast_steps.append(P2PStep(tuple(pairs), combine=False))
        span //= 2
    steps.extend(bcast_steps)
    return P2PSchedule(n_nodes, ppn, tuple(steps), kind="smp")


def ragged_splits(total: int, k: int) -> tuple[int, ...]:
    """Split ``total`` items into ``k`` blocks with sizes differing <= 1.

    Larger blocks come first (matching :func:`_balanced_split`).  This is
    the single source of truth for the *ragged* (uneven-block) stripe and
    chunk geometry: the schedule builders, the executed
    ``collectives.mla_allreduce`` lowering and the NumPy oracle all derive
    their offsets from it, so no zero padding is ever introduced.
    """
    if k < 1:
        raise ValueError("k must be positive")
    base, rem = divmod(total, k)
    return tuple(base + 1 if i < rem else base for i in range(k))


def chunk_offsets(total: int, k: int) -> tuple[int, ...]:
    """Interior boundaries of the ragged ``k``-way chunk grid.

    The cumulative offsets of :func:`ragged_splits` (excluding 0 and
    ``total``) — the exact positions at which the chunk-pipelined MLA
    lowering splits a flat payload.  The bucket planner snaps fused-bucket
    boundaries to this grid so a bucket's pipeline chunks align with leaf
    boundaries instead of straddling leaf fragments.
    """
    out, off = [], 0
    for ce in ragged_splits(total, k)[:-1]:
        off += ce
        out.append(off)
    return tuple(out)


def chunk_alignment(part_sizes: Sequence[int], k: int) -> float:
    """Fraction of the ragged ``k``-chunk grid's interior boundaries that
    coincide with part (leaf) boundaries of a fused payload.

    ``part_sizes`` are the element counts of the payload's constituent
    parts, in fusion order.  1.0 means every pipeline chunk is a whole
    number of leaves (no chunk straddles a leaf fragment); ``k <= 1`` is
    trivially aligned.  Used by the bucket planner to score candidate
    bucket close points.
    """
    total = int(sum(part_sizes))
    if k <= 1 or total == 0:
        return 1.0
    bounds = chunk_offsets(total, k)
    if not bounds:
        return 1.0
    leaf_bounds, off = set(), 0
    for sz in part_sizes:
        off += int(sz)
        leaf_bounds.add(off)
    hit = sum(1 for b in bounds if b in leaf_bounds)
    return hit / len(bounds)


def mla_stripe_geometry(
    n_nodes: int, ppn: int, elems: int
) -> tuple[tuple[int, ...], tuple[tuple[int, ...], ...]]:
    """Ragged MLA stripe geometry for an ``elems``-element payload.

    Returns ``(stripes, blocks)`` where ``stripes[r]`` is the element
    count of lane ``r``'s stripe (the intra reduce-scatter output) and
    ``blocks[r][j]`` is the element count of node ``j``'s sub-block of
    stripe ``r`` (the per-lane inter-node reduce-scatter output).  All
    sizes differ by at most one — no padded elements exist, so none can
    cross the slow domain.
    """
    stripes = ragged_splits(elems, ppn)
    blocks = tuple(ragged_splits(sr, n_nodes) for sr in stripes)
    return stripes, blocks


def _one_way_internode_lower_bound(n_nodes: int, ppn: int, elems: int) -> int:
    """Worst-chip inter-node *elements* for one direction (RS or AG).

    The chip of lane ``r`` on node ``j`` must push its contributions to
    every sub-block it does not own across the slow domain
    (``stripes[r] - blocks[r][j]`` elements).  The binding chip is the one
    owning the smallest sub-block of the largest stripe.
    """
    if n_nodes <= 1:
        return 0
    stripes, blocks = mla_stripe_geometry(n_nodes, ppn, elems)
    return max(
        (sr - min(bl) for sr, bl in zip(stripes, blocks) if sr > 0),
        default=0,
    )


def rs_internode_lower_bound(n_nodes: int, ppn: int, elems: int) -> int:
    """Uneven-block lower bound on per-chip inter-node elements sent by
    the striped *reduce-scatter* (the RS half of the MLA allreduce)."""
    return _one_way_internode_lower_bound(n_nodes, ppn, elems)


def ag_internode_lower_bound(n_nodes: int, ppn: int, elems: int) -> int:
    """Uneven-block lower bound on per-chip inter-node elements sent by
    the striped *allgather* (the AG half of the MLA allreduce)."""
    return _one_way_internode_lower_bound(n_nodes, ppn, elems)


def mla_internode_lower_bound(n_nodes: int, ppn: int, elems: int) -> int:
    """Uneven-block lower bound on per-chip inter-node *elements* sent.

    The chip of lane ``r`` on node ``j`` must push its contributions to
    every sub-block it does not own across the slow domain during the
    reduce-scatter (``stripes[r] - blocks[r][j]`` elements) and the same
    amount back during the allgather — the sum of the
    :func:`rs_internode_lower_bound` and :func:`ag_internode_lower_bound`
    one-way bounds.
    """
    return rs_internode_lower_bound(
        n_nodes, ppn, elems
    ) + ag_internode_lower_bound(n_nodes, ppn, elems)


def _phase_weights(k: int) -> list[float]:
    """Normalised per-step weights of a k-way halving RS (sum to 1)."""
    if k <= 1:
        return []
    n_steps = math.ceil(math.log2(k))
    raw = [2.0 ** -(i + 1) for i in range(n_steps)]
    tot = sum(raw)
    return [f / tot for f in raw]


def _mla_phase_steps(
    n_nodes: int,
    ppn: int,
    elems: int | None,
    scale: float,
    chunk: int,
) -> tuple[list[P2PStep], list[P2PStep], list[P2PStep], list[P2PStep]]:
    """The four MLA phases as step lists (intra-RS, inter-RS, inter-AG,
    intra-AG).

    ``elems=None`` produces the even (divisibility-assumed) fractions of
    the original builder; an integer ``elems`` produces *ragged* per-pair
    fractions from :func:`mla_stripe_geometry` — each chip's sent bytes
    across a phase total exactly its uneven-block share, with zero padded
    bytes.  ``scale`` multiplies every fraction (chunked schedules pass
    the chunk's share of the payload); ``chunk`` tags the emitted steps.
    """
    intra_w = _phase_weights(ppn)
    inter_w = _phase_weights(n_nodes)
    li, lo = len(intra_w), len(inter_w)

    if elems is None:
        # even fractions, rescaled so phase byte totals are exactly
        # (k-1)/k of the phase payload (the divisible-stripe ideal)
        intra_tot = [(ppn - 1) / ppn] * (n_nodes * ppn)
        inter_tot = [(1.0 / ppn) * (n_nodes - 1) / n_nodes] * (
            n_nodes * ppn
        )
    else:
        stripes, blocks = mla_stripe_geometry(n_nodes, ppn, elems)
        e = float(max(elems, 1))
        intra_tot = [
            (elems - stripes[r]) / e
            for _ in range(n_nodes)
            for r in range(ppn)
        ]
        inter_tot = [
            (stripes[r] - blocks[r][node]) / e
            for node in range(n_nodes)
            for r in range(ppn)
        ]

    def _wsum(k: int, bits: Sequence[int], weights: Sequence[float]):
        """Per-position sum of the weights of the steps it takes part in.

        Non-power counts skip a position in steps where its partner does
        not exist; normalising by this sum keeps each chip's *phase*
        byte total exact (ragged accounting) instead of losing the
        skipped steps' weight mass.
        """
        out = [0.0] * k
        for bit, w in zip(bits, weights):
            for j in range(k):
                if (j ^ bit) < k:
                    out[j] += w
        return out

    intra_bits = [1 << (li - 1 - i) for i in range(li)]
    inter_bits = [1 << (lo - 1 - i) for i in range(lo)]
    intra_wsum = _wsum(ppn, intra_bits, intra_w)
    inter_wsum = _wsum(n_nodes, inter_bits, inter_w)

    def step(bit: int, w: float, combine: bool, inter: bool) -> P2PStep:
        pairs: list[tuple[int, int]] = []
        fr: list[float] = []
        for node in range(n_nodes):
            for r in range(ppn):
                if inter:
                    if (node ^ bit) >= n_nodes:
                        continue
                    pair = (node * ppn + r, (node ^ bit) * ppn + r)
                    wn = w if elems is None else w / inter_wsum[node]
                else:
                    if (r ^ bit) >= ppn:
                        continue
                    pair = (node * ppn + r, node * ppn + (r ^ bit))
                    wn = w if elems is None else w / intra_wsum[r]
                tot = (inter_tot if inter else intra_tot)[pair[0]]
                f = wn * tot * scale
                if f <= 0.0:
                    continue  # ragged zero-size message: never sent
                pairs.append(pair)
                fr.append(f)
        if elems is None and pairs and len(set(fr)) == 1:
            # even, uniform fractions: keep the scalar-``frac`` form
            return P2PStep(
                tuple(pairs), combine=combine, frac=fr[0], chunk=chunk
            )
        return P2PStep(
            tuple(pairs), combine=combine, fracs=tuple(fr), chunk=chunk
        )

    intra_rs = [
        step(intra_bits[i], intra_w[i], True, False) for i in range(li)
    ]
    inter_rs = [
        step(inter_bits[i], inter_w[i], True, True) for i in range(lo)
    ]
    rev_inter = list(reversed(inter_w))
    inter_ag = [
        step(1 << i, rev_inter[i], False, True) for i in range(lo)
    ]
    rev_intra = list(reversed(intra_w))
    intra_ag = [
        step(1 << i, rev_intra[i], False, False) for i in range(li)
    ]
    drop_empty = lambda steps: [st for st in steps if st.pairs]
    return (
        drop_empty(intra_rs),
        drop_empty(inter_rs),
        drop_empty(inter_ag),
        drop_empty(intra_ag),
    )


@functools.lru_cache(maxsize=None)
def build_mla_schedule(
    n_nodes: int, ppn: int, elems: int | None = None
) -> P2PSchedule:
    """Multi-lane node-aware (MLA) allreduce message schedule.

    The bandwidth-regime mirror of NAP: instead of each chip carrying the
    *full* payload across the slow domain, the pod-local partial is striped
    across the ``ppn`` local ranks (intra reduce-scatter), every lane ``r``
    then runs an independent reduce-scatter + allgather over the
    ``n_nodes`` nodes with its ``s/ppn``-byte stripe, and an intra
    allgather rebuilds the full payload.  Per-chip inter-node traffic
    drops from ``~2s`` (node-agnostic RS+AG) to ``~2*(s/ppn)*(n-1)/n`` —
    the paper's §VI "future work" regime, executed as ppn concurrent
    lanes.

    Both RS/AG phases are realized as recursive halving/doubling
    butterflies — ``ceil(log2(k))`` latency steps with message sizes
    halving per step — matching what ``cost_mla`` models and what the
    executed ``mla_allreduce`` lowers to, so the simulator's replay, the
    closed-form model and the real path agree on both the latency-step
    count and the byte totals.  (A ring realization would charge ``k-1``
    alpha-steps and materialize O(k^2) pairs, which is neither.)

    ``elems=None`` keeps the even-fraction accounting (per-chip bytes
    exactly ``(k-1)/k`` of each phase payload).  Passing the payload's
    element count instead builds the *ragged-stripe* schedule: per-pair
    fractions follow :func:`mla_stripe_geometry`'s uneven blocks, so
    ``max_internode_bytes_per_chip`` equals the uneven-block lower bound
    (:func:`mla_internode_lower_bound`) — no zero-padded bytes ever cross
    the slow domain, unlike pad-to-power striping.

    Message sizes are carried as payload *fractions* (of the full ``s``)
    in ``P2PStep.frac``/``fracs`` so the event-driven simulator can replay
    the striped schedule exactly.
    """
    if n_nodes < 1 or ppn < 1:
        raise ValueError("n_nodes and ppn must be positive")
    phases = _mla_phase_steps(n_nodes, ppn, elems, 1.0, 0)
    steps = [st for phase in phases for st in phase]
    return P2PSchedule(n_nodes, ppn, tuple(steps), kind="mla")


@functools.lru_cache(maxsize=None)
def build_mla_rs_schedule(
    n_nodes: int, ppn: int, elems: int | None = None
) -> P2PSchedule:
    """Striped *reduce-scatter* schedule: the first two MLA phases.

    Intra-pod reduce-scatter stripes the pod partial across the ``ppn``
    lanes, then every lane runs an independent reduce-scatter over the
    slow domain — chip ``(j, r)`` ends up owning the fully reduced block
    ``(r, j)`` of :func:`mla_stripe_geometry`.  With ``elems`` the
    per-pair fractions are ragged, so
    ``max_internode_bytes_per_chip`` equals the one-way lower bound
    (:func:`rs_internode_lower_bound`) — half the allreduce's round trip.
    """
    if n_nodes < 1 or ppn < 1:
        raise ValueError("n_nodes and ppn must be positive")
    intra_rs, inter_rs, _, _ = _mla_phase_steps(n_nodes, ppn, elems, 1.0, 0)
    return P2PSchedule(
        n_nodes, ppn, tuple(intra_rs + inter_rs), kind="mla_rs"
    )


@functools.lru_cache(maxsize=None)
def build_mla_ag_schedule(
    n_nodes: int, ppn: int, elems: int | None = None
) -> P2PSchedule:
    """Striped *allgather* schedule: the last two MLA phases.

    The exact mirror of :func:`build_mla_rs_schedule`: every lane
    allgathers its blocks over the slow domain, then an intra-pod
    allgather rebuilds the payload — per-chip inter-node bytes equal the
    one-way lower bound (:func:`ag_internode_lower_bound`).
    """
    if n_nodes < 1 or ppn < 1:
        raise ValueError("n_nodes and ppn must be positive")
    _, _, inter_ag, intra_ag = _mla_phase_steps(n_nodes, ppn, elems, 1.0, 0)
    return P2PSchedule(
        n_nodes, ppn, tuple(inter_ag + intra_ag), kind="mla_ag"
    )


@functools.lru_cache(maxsize=None)
def build_mla_pipelined_schedule(
    n_nodes: int, ppn: int, chunks: int, elems: int | None = None
) -> P2PSchedule:
    """Chunked, pipelined MLA schedule (doubly-pipelined reduction-to-all).

    The payload is split into ``chunks`` ragged chunks; each chunk runs
    the four MLA phases, and chunk ``c``'s inter-pod phases overlap chunk
    ``c+1``'s intra-pod phases because they occupy *different* network
    domains (ICI vs DCI) — the chunk-level overlap of Träff's
    doubly-pipelined allreduce (arXiv:2109.12626) applied to the
    multi-lane engine.

    Steps are emitted in wavefront order (chunk ``c`` phase ``p`` before
    chunk ``c+1`` phase ``p``), each tagged with its ``chunk`` and chained
    to its same-chunk predecessor through ``dep``; cross-chunk order is
    constrained only by per-chip, per-domain port availability, which is
    how the simulator's replay exhibits the overlap win.  Total bytes are
    identical to the unpipelined schedule — pipelining trades extra alpha
    steps (``chunks`` x the latency) for intra/inter overlap, which is why
    the dispatcher only selects it when the §IV model says the payload
    amortises the latency.
    """
    if chunks < 1:
        raise ValueError("chunks must be positive")
    if elems is not None:
        chunk_elems = ragged_splits(elems, chunks)
        scales = [ce / float(max(elems, 1)) for ce in chunk_elems]
        per_chunk = [
            _mla_phase_steps(n_nodes, ppn, ce, sc, c) if ce else ([], [], [], [])
            for c, (ce, sc) in enumerate(zip(chunk_elems, scales))
        ]
    else:
        per_chunk = [
            _mla_phase_steps(n_nodes, ppn, None, 1.0 / chunks, c)
            for c in range(chunks)
        ]

    steps: list[P2PStep] = []
    last_idx = [-1] * chunks  # index of each chunk's last emitted step
    n_phases = 4
    for wave in range(chunks + n_phases - 1):
        for c in range(chunks):
            ph = wave - c
            if not 0 <= ph < n_phases:
                continue
            for st in per_chunk[c][ph]:
                steps.append(
                    dataclass_replace(st, dep=last_idx[c])
                )
                last_idx[c] = len(steps) - 1
    return P2PSchedule(
        n_nodes, ppn, tuple(steps), kind="mla_pipelined", chunks=chunks
    )


# ---------------------------------------------------------------------------
# host-constant mask tables (trace-time hot path)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def step_mask_tables(
    n_nodes: int, ppn: int
) -> tuple[tuple[tuple[np.ndarray, ...], np.ndarray], ...]:
    """Per-step (receive-mask-per-round, self-mask) boolean tables.

    Computed once per (n_nodes, ppn) on the host and embedded as tiny
    constants by the collective lowering, replacing the per-trace Python
    loops that previously rebuilt each mask on every ``nap_allreduce``
    trace.  Entry ``i`` pairs with ``build_nap_schedule(...).steps[i]``.
    """
    sched = build_nap_schedule(n_nodes, ppn)
    n_chips = sched.n_chips
    tables = []
    for step in sched.steps:
        rmasks = []
        for rnd in step.rounds:
            m = np.zeros(n_chips, dtype=bool)
            for _, dst in rnd:
                m[dst] = True
            m.setflags(write=False)
            rmasks.append(m)
        smask = np.zeros(n_chips, dtype=bool)
        for c in step.self_chips:
            smask[c] = True
        smask.setflags(write=False)
        tables.append((tuple(rmasks), smask))
    return tuple(tables)


@functools.lru_cache(maxsize=None)
def p2p_recv_masks(sched: P2PSchedule) -> tuple[np.ndarray, ...]:
    """Per-step receive masks for a P2P schedule (host constants)."""
    out = []
    for step in sched.steps:
        m = np.zeros(sched.n_chips, dtype=bool)
        for _, dst in step.pairs:
            m[dst] = True
        m.setflags(write=False)
        out.append(m)
    return tuple(out)


# ---------------------------------------------------------------------------
# NumPy interpreter (test oracle + simulator substrate)
# ---------------------------------------------------------------------------

_OPS: dict[str, tuple[Callable[[np.ndarray, np.ndarray], np.ndarray], float]] = {
    "sum": (np.add, 0.0),
    "max": (np.maximum, -np.inf),
    "min": (np.minimum, np.inf),
    "prod": (np.multiply, 1.0),
}


def simulate_allreduce(
    schedule: NapSchedule, values: np.ndarray, op: str = "sum"
) -> np.ndarray:
    """Execute a NAP schedule on host, returning per-chip results.

    ``values`` has shape (n_chips, ...).  This is the correctness oracle
    used by the tests: the result must equal the op-reduction of ``values``
    along axis 0, replicated to every chip.
    """
    fold, ident = _OPS[op]
    n, ppn = schedule.n_nodes, schedule.ppn
    v = np.array(values, dtype=np.float64, copy=True)
    if v.shape[0] != n * ppn:
        raise ValueError("values must have one leading row per chip")

    def local_allreduce(x: np.ndarray) -> np.ndarray:
        out = np.empty_like(x)
        for node in range(n):
            sl = slice(node * ppn, (node + 1) * ppn)
            red = x[sl][0]
            for row in x[sl][1:]:
                red = fold(red, row)
            out[sl] = red
        return out

    v = local_allreduce(v)
    for step in schedule.steps:
        snapshot = v.copy()
        contrib = np.full_like(v, ident)
        for src, dst in step.messages:
            contrib[dst] = fold(contrib[dst], snapshot[src])
        for chip in step.self_chips:
            contrib[chip] = fold(contrib[chip], snapshot[chip])
        v = local_allreduce(contrib)
    return v


def simulate_mla_allreduce(
    n_nodes: int,
    ppn: int,
    values: np.ndarray,
    op: str = "sum",
    chunks: int = 1,
) -> np.ndarray:
    """Execute the ragged (optionally chunked) MLA algorithm on host.

    Walks the exact uneven-block geometry the schedule builders and the
    ``collectives.mla_allreduce`` lowering share — chunk split, per-lane
    stripes, per-node sub-blocks — reducing each sub-block only along the
    path the real algorithm uses.  The test oracle: the result must equal
    the op-reduction of ``values`` along axis 0 on every chip, proving
    the ragged offsets partition the payload exactly (no element dropped,
    none double-counted, no padding needed).
    """
    fold, _ = _OPS[op]
    n_chips = n_nodes * ppn
    v = np.asarray(values, dtype=np.float64)
    if v.ndim != 2 or v.shape[0] != n_chips:
        raise ValueError("values must have shape (n_chips, elems)")
    elems = v.shape[1]
    result = np.empty(elems, dtype=np.float64)
    c_off = 0
    for ce in ragged_splits(elems, chunks):
        if ce == 0:
            continue
        sub = v[:, c_off : c_off + ce]
        stripes, blocks = mla_stripe_geometry(n_nodes, ppn, ce)
        s_off = 0
        for r, sr in enumerate(stripes):
            if sr == 0:
                continue
            stripe_vals = sub[:, s_off : s_off + sr]
            # phase 1 (intra RS): lane-r chip of node j holds node j's
            # partial of stripe r
            node_part = np.empty((n_nodes, sr))
            for j in range(n_nodes):
                acc = stripe_vals[j * ppn]
                for row in stripe_vals[j * ppn + 1 : (j + 1) * ppn]:
                    acc = fold(acc, row)
                node_part[j] = acc
            # phase 2 (per-lane inter RS): node j reduces its sub-block
            b_off = 0
            reduced = np.empty(sr)
            for j, bj in enumerate(blocks[r]):
                if bj == 0:
                    continue
                blk = node_part[0, b_off : b_off + bj]
                for row in node_part[1:, b_off : b_off + bj]:
                    blk = fold(blk, row)
                reduced[b_off : b_off + bj] = blk
                b_off += bj
            # phases 2b/3 (inter AG + intra AG): everyone gets the stripe
            result[c_off + s_off : c_off + s_off + sr] = reduced
            s_off += sr
        c_off += ce
    return np.broadcast_to(result, v.shape).copy()


def message_counts(schedule: NapSchedule) -> dict[str, int]:
    """Inter-node message statistics for comparisons/figures."""
    per_chip = np.zeros(schedule.n_chips, dtype=np.int64)
    total = 0
    for step in schedule.steps:
        for src, dst in step.messages:
            if src // schedule.ppn != dst // schedule.ppn:
                per_chip[src] += 1
                total += 1
    return {
        "steps": schedule.num_internode_steps,
        "max_per_chip": int(per_chip.max(initial=0)),
        "total": total,
    }
