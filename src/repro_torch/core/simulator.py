"""Event-driven schedule simulator under the max-rate model.

The port of ``repro/core/simulator.py`` (NumPy only): the schedules of
:mod:`repro_torch.core.napalg` are replayed on a virtual cluster with
per-rank clocks.  Every message advances its endpoints' clocks with
node-aware costs; the injection penalty comes from the number of
concurrent inter-node senders per node at each step; ragged node counts,
donor rounds, the SMP master bottleneck and the fold steps of
non-power-of-two recursive doubling all shape the time.

* Chunked (pipelined MLA) schedules replay with per-domain ports: each
  rank owns an intra-node and an inter-node port, a chunk's phases follow
  their ``dep`` chain and different chunks contend only for ports.
* Ragged stripes replay with their exact per-pair message sizes.
* :func:`simulate_bucketed_sync` replays a bucket plan with a compute
  port, so the overlap of bucket transfers with backward shows as wall
  clock.
* :func:`replay_internode_bytes` accounts each rank's inter-node bytes
  from the same message stream, independently of the schedules' own
  helpers; the schedule verifier checks the two against each other.

The machine constants are the cost model's (the JAX package's
:data:`~repro_torch.core.perf_model.TPU_V5E_POD` and
:data:`~repro_torch.core.perf_model.BLUE_WATERS`): the times are model
times for those machines, not measurements of a GPU host.
"""

from __future__ import annotations

import math

import numpy as np

from . import napalg
from .perf_model import MachineParams

__all__ = [
    "simulate_time",
    "simulate_algorithm",
    "simulate_collective",
    "simulate_bucketed_sync",
    "internode_bytes_per_chip",
    "replay_internode_bytes",
]


def _local_allreduce_time(
    t: np.ndarray, n_nodes: int, ppn: int, s: float, p: MachineParams
) -> np.ndarray:
    """Advance clocks through a recursive-doubling intra-node allreduce."""
    if ppn <= 1:
        return t
    t = t.reshape(n_nodes, ppn)
    steps = math.ceil(math.log2(ppn))
    pow2 = 1 << steps
    cost = p.alpha_l + p.beta_l * s + p.gamma * s
    if pow2 == ppn:
        for bit in range(steps):
            partner = np.arange(ppn) ^ (1 << bit)
            t = np.maximum(t, t[:, partner]) + cost
    else:
        # non-power ppn: everyone synchronises on the node's max clock for
        # each tree level (fold + butterfly approximation).
        for _ in range(steps + 1):
            t = np.broadcast_to(
                t.max(axis=1, keepdims=True), t.shape
            ).copy()
            t = t + cost
    return t.reshape(-1)


def _pair_costs(
    pairs: np.ndarray,
    ppn: int,
    s,
    p: MachineParams,
    combine: bool,
    n_nodes: int,
) -> tuple[np.ndarray, np.ndarray]:
    """(inter-mask, per-message cost) for one round of messages.

    ``s`` may be a scalar (every message the same size) or a per-pair
    byte array (ragged stripes).  The injection penalty counts the
    concurrent inter-node senders per node *within this round*.
    """
    src, dst = pairs[:, 0], pairs[:, 1]
    inter = (src // ppn) != (dst // ppn)
    s = np.broadcast_to(np.asarray(s, dtype=np.float64), src.shape)
    senders = src[inter] // ppn
    if senders.size:
        counts = np.bincount(senders, minlength=n_nodes)
        k = counts[src // ppn]
    else:
        k = np.zeros_like(src)
    k = np.maximum(k, 1)
    cost = np.where(
        inter,
        p.alpha + (k * s) / np.minimum(p.R_N, k * p.R_b),
        p.alpha_l + p.beta_l * s,
    )
    if combine:
        cost = cost + p.gamma * s
    return inter, cost


def _message_step_time(
    t: np.ndarray,
    pairs: np.ndarray,
    ppn: int,
    s,
    p: MachineParams,
    combine: bool,
) -> np.ndarray:
    """Advance clocks through one round of point-to-point messages."""
    if pairs.size == 0:
        return t
    src, dst = pairs[:, 0], pairs[:, 1]
    inter, cost = _pair_costs(
        pairs, ppn, s, p, combine, int(t.size // ppn)
    )
    t_new = t.copy()
    np.maximum.at(t_new, dst, np.maximum(t[src], t[dst]) + cost)
    # senders are busy until their message is injected (latency portion)
    np.maximum.at(t_new, src, t[src] + np.where(inter, p.alpha, p.alpha_l))
    return t_new


def _simulate_chunked(schedule, s: float, p: MachineParams) -> float:
    """Replay a chunked (pipelined MLA) schedule with per-domain ports.

    Each chip owns two independent network ports — intra-pod (ICI) and
    inter-pod (DCI).  A step's start time on a pair is the max of (a) the
    endpoints' *data* readiness within the step's chunk (the ``dep``
    chain: phases of one chunk serialize) and (b) the endpoints' port
    availability in the step's domain (steps of *different* chunks
    contend only for ports).  Chunk ``c+1``'s intra phases therefore
    overlap chunk ``c``'s inter phases — the pipelined win — while two
    inter phases can never overlap on one chip, so the DCI is never
    oversubscribed.  Per-chip clock skew (ragged stripes, non-power
    grids) emerges naturally, exactly as in the unchunked replay.
    """
    n, ppn = schedule.n_nodes, schedule.ppn
    n_chips = n * ppn
    zeros = np.zeros(n_chips)
    # cumulative per-chip data-readiness *after* each step; a step's
    # baseline readiness comes from its declared ``dep`` predecessor
    ready_after: dict[int, np.ndarray] = {}
    avail = {
        False: np.zeros(n_chips),  # intra (ICI) port free time
        True: np.zeros(n_chips),  # inter (DCI) port free time
    }
    for idx, step in enumerate(schedule.steps):
        rc = ready_after[step.dep] if step.dep >= 0 else zeros
        pairs = np.asarray(step.pairs, dtype=np.int64).reshape(-1, 2)
        if pairs.size == 0:
            ready_after[idx] = rc
            continue
        src, dst = pairs[:, 0], pairs[:, 1]
        msg_bytes = np.asarray(step.pair_fracs(), dtype=np.float64) * s
        inter, cost = _pair_costs(
            pairs, ppn, msg_bytes, p, step.combine, n
        )
        av_src = np.where(inter, avail[True][src], avail[False][src])
        av_dst = np.where(inter, avail[True][dst], avail[False][dst])
        start = np.maximum(
            np.maximum(rc[src], rc[dst]), np.maximum(av_src, av_dst)
        )
        finish = start + cost
        alpha_dom = np.where(inter, p.alpha, p.alpha_l)
        # data readiness: receivers wait for the payload, senders are busy
        # only through injection
        rc_new = rc.copy()
        np.maximum.at(rc_new, dst, finish)
        np.maximum.at(rc_new, src, start + alpha_dom)
        ready_after[idx] = rc_new
        # port occupancy per domain
        for dom in (False, True):
            m = inter == dom
            if not m.any():
                continue
            np.maximum.at(avail[dom], dst[m], finish[m])
            np.maximum.at(avail[dom], src[m], start[m] + alpha_dom[m])
    if not ready_after:
        return 0.0
    return float(max(r.max() for r in ready_after.values()))


def simulate_time(
    schedule, s: float, p: MachineParams
) -> float:
    """Simulated wall-time (max chip clock) of one allreduce of ``s`` bytes."""
    n, ppn = schedule.n_nodes, schedule.ppn
    t = np.zeros(n * ppn)
    if isinstance(schedule, napalg.NapSchedule):
        t = _local_allreduce_time(t, n, ppn, s, p)
        for step in schedule.steps:
            for rnd in step.rounds:
                t = _message_step_time(
                    t, np.asarray(rnd, dtype=np.int64).reshape(-1, 2),
                    ppn, s, p, combine=True,
                )
            t = _local_allreduce_time(t, n, ppn, s, p)
        return float(t.max())
    if getattr(schedule, "kind", "") == "mla_pipelined":
        # chunked schedules: per-domain ports let chunks overlap
        return _simulate_chunked(schedule, s, p)
    # P2P schedules (RD / SMP / MLA).  Striped schedules carry a payload
    # fraction per step (per-pair for ragged stripes), so the striped MLA
    # path is replayed with the real uneven message sizes.
    for step in schedule.steps:
        fracs = (
            np.asarray(step.fracs, dtype=np.float64)
            if getattr(step, "fracs", None) is not None
            else getattr(step, "frac", 1.0)
        )
        t = _message_step_time(
            t,
            np.asarray(step.pairs, dtype=np.int64).reshape(-1, 2),
            ppn,
            s * fracs,
            p,
            combine=step.combine,
        )
    return float(t.max())


def _build(algo, n_nodes, ppn, s, p, chunks=None, elems=None):
    """Resolve an engine's schedule through the registry."""
    from . import comm

    if chunks is None and comm.find_engine(algo).chunked:
        from . import perf_model as pm

        # chunked engines replay at the model-optimal depth (so the
        # dispatcher's decision and the replay agree)
        chunks = pm.optimal_pipeline_chunks(s, n_nodes, ppn, p)
    return comm.engine_schedule(
        algo, n_nodes, ppn, chunks=chunks or 1, elems=elems
    )


def simulate_algorithm(
    algo: str,
    n_nodes: int,
    ppn: int,
    s: float,
    p: MachineParams,
    *,
    chunks: int | None = None,
    elems: int | None = None,
) -> float:
    """Simulated wall-time of one ``s``-byte allreduce.

    ``algo="mla_pipelined"`` replays the chunked schedule; ``chunks=None``
    takes the model-optimal depth (so the dispatcher's decision and the
    replay agree).  ``elems`` switches MLA flavours to exact ragged-stripe
    message sizes instead of the even ideal.  ``algo="mla_rs"`` /
    ``"mla_ag"`` replay the striped reduce-scatter / allgather halves —
    the first-class RS/AG collectives of :mod:`repro_torch.core.comm`.
    """
    # the schedule builders are lru_cached, so no cache layer needed here
    return simulate_time(_build(algo, n_nodes, ppn, s, p, chunks, elems), s, p)


def simulate_collective(
    topology,
    algo: str,
    s: float,
    *,
    chunks: int | None = None,
    elems: int | None = None,
) -> float:
    """Topology-first wrapper of :func:`simulate_algorithm`: the grid
    shape and machine constants come from one
    :class:`repro_torch.core.comm.Topology` instead of loose kwargs."""
    return simulate_algorithm(
        algo, topology.n_nodes, topology.ppn, s, topology.params,
        chunks=chunks, elems=elems,
    )


def _bucket_duration(
    nbytes: float,
    algo: str,
    n_nodes: int,
    ppn: int,
    p: MachineParams,
    chunks: int | None,
    elems: int | None,
) -> float:
    """Replayed wall-time of one bucket's collective."""
    if algo == "psum" or n_nodes <= 1:
        # single-level native reduce: intra RD rounds only
        rounds = math.ceil(math.log2(max(2, n_nodes * ppn)))
        return rounds * (p.alpha_l + p.beta_l * nbytes + p.gamma * nbytes)
    return simulate_time(
        _build(algo, n_nodes, ppn, nbytes, p, chunks, elems), nbytes, p
    )


def simulate_bucketed_sync(
    buckets,
    n_nodes: int,
    ppn: int,
    p: MachineParams,
    *,
    compute_times=None,
    overlap: bool = True,
) -> float:
    """Wall-clock of a bucketed grad sync replayed with a compute port.

    ``buckets`` is a sequence of ``(nbytes, algorithm, chunks, elems)``
    rows in issue order — exactly what ``BucketPlan.sim_rows()`` emits.
    A row may carry an optional fifth element ``raw_bytes`` for
    compressed buckets (``nbytes`` = packed wire bytes < ``raw_bytes``):
    such rows are priced with
    :func:`repro_torch.core.perf_model.cost_mla_compressed` — f32 intra
    stages at the raw width, inter exchange at the wire width, four
    fused kernel passes on the compute side.  ``compute_times[i]`` is
    the clock at which backward has produced
    bucket ``i``'s gradients (the compute port; defaults to all zero).
    Each bucket's collective is replayed through the event-driven
    schedule simulator (ragged stripes, pipelined chunks, donor rounds
    and all) to get its duration; the network port then executes buckets
    back to back:

    * ``overlap=True`` (the async executor): bucket ``i`` starts at
      ``max(network free, compute_times[i])`` — transfers hide behind
      the compute that produces later buckets;
    * ``overlap=False`` (the old serial sync): nothing starts until the
      *last* gradient exists, then every bucket runs in sequence.

    The async wall-clock is never worse than the serial one (asserted in
    tests on a 16x16 grid) — the measurable form of the bucket-overlap
    claim rather than an assumed formula.
    """
    rows = list(buckets)
    if not rows:
        return 0.0
    if compute_times is None:
        compute_times = [0.0] * len(rows)
    if len(compute_times) != len(rows):
        raise ValueError("compute_times must have one entry per bucket")
    durations = []
    for row in rows:
        nb, algo, ch, el = row[:4]
        raw = float(row[4]) if len(row) > 4 else float(nb)
        if raw > float(nb) and n_nodes > 1:
            from . import perf_model as pm

            durations.append(
                pm.cost_mla_compressed(raw, n_nodes, ppn, p, float(nb) / raw)
            )
            continue
        durations.append(
            _bucket_duration(float(nb), algo, n_nodes, ppn, p, ch, el)
        )
    if overlap:
        free = 0.0
        for ready, dur in zip(compute_times, durations):
            free = max(free, float(ready)) + dur
        return free
    return float(max(compute_times)) + sum(durations)


def replay_internode_bytes(schedule, s: float) -> np.ndarray:
    """Per-chip inter-node bytes *sent*, from replaying the schedule.

    Vectorised per-step accumulation over the same message stream the
    timing replay walks — an accounting path independent of both the
    schedules' own ``max_internode_bytes_per_chip`` helpers and the
    verifier's per-endpoint iteration
    (:func:`repro_torch.core.napalg.iter_messages`).  The schedule verifier
    cross-checks all three against each other, so a bug in any one of
    them surfaces as a byte-accounting violation instead of silently
    shifting every figure built on the accounting.
    """
    ppn = schedule.ppn
    sends = np.zeros(schedule.n_chips, dtype=np.float64)
    if isinstance(schedule, napalg.NapSchedule):
        for step in schedule.steps:
            for rnd in step.rounds:
                if not rnd:
                    continue
                pairs = np.asarray(rnd, dtype=np.int64).reshape(-1, 2)
                inter = (pairs[:, 0] // ppn) != (pairs[:, 1] // ppn)
                np.add.at(sends, pairs[inter, 0], float(s))
        return sends
    for step in schedule.steps:
        if not step.pairs:
            continue
        pairs = np.asarray(step.pairs, dtype=np.int64).reshape(-1, 2)
        fracs = np.asarray(step.pair_fracs(), dtype=np.float64)
        inter = (pairs[:, 0] // ppn) != (pairs[:, 1] // ppn)
        np.add.at(sends, pairs[inter, 0], fracs[inter] * float(s))
    return sends


def internode_bytes_per_chip(
    algo: str,
    n_nodes: int,
    ppn: int,
    s: float,
    *,
    chunks: int | None = None,
    elems: int | None = None,
) -> float:
    """Max inter-node bytes any chip sends for an ``s``-byte reduction.

    The quantity the MLA stripe divides by ppn: replaying the schedules
    shows ``~2s`` for node-agnostic RS+AG lowerings, ``steps*s`` for NAP,
    and ``~2*(s/ppn)*(n-1)/n`` for MLA.  With ``elems`` the MLA flavours
    account ragged stripes exactly (the uneven-block lower bound — no
    padded bytes cross the slow domain).
    """
    from .perf_model import TPU_V5E_POD

    sched = _build(algo, n_nodes, ppn, s, TPU_V5E_POD, chunks, elems)
    return sched.max_internode_bytes_per_chip(s)
