"""Node-aware performance model — paper §IV, Equations (1)-(6).

The port of ``repro/core/perf_model.py``: the postal model (Eq 1), the
max-rate message cost (Eq 3), recursive doubling (Eq 4, also the ``psum``
fallback's price), SMP (Eq 5), NAP (Eq 6), the MLA, compressed-MLA and
pipelined-MLA costs, the striped and flat reduce-scatter / allgather
costs, the NAP<->MLA crossover, the model-optimal pipeline depth, the
model-optimal grad-sync bucket size, and :meth:`MachineParams.fit`, which
fits the inter-node constants to measured message times.

Three sets of constants ship.  :data:`TPU_V5E_POD` (the JAX package's
default) and :data:`BLUE_WATERS` (the paper's) are the reference's own, kept
so that the port plans and dispatches exactly as the reference does.
:data:`H100_NVLINK_HOST` is the port's: fitted by
``tools/fit_machine_4gpu.py`` on four H100s of one host, whose two levels
are both NVLink, so it describes an NVLink host with no slow domain.  An
executable topology on an NCCL world takes it by default
(``comm.world_params``); planning (``comm.Topology.of``), gloo worlds and
the SPMD lint keep :data:`TPU_V5E_POD`.  Constants for InfiniBand wait for
a machine of more than one host.  All sizes are bytes, all times seconds.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

__all__ = [
    "MachineParams",
    "BLUE_WATERS",
    "TPU_V5E_POD",
    "H100_NVLINK_HOST",
    "postal_cost",
    "maxrate_message_cost",
    "cost_rd",
    "cost_smp",
    "cost_nap",
    "cost_mla",
    "cost_mla_compressed",
    "cost_mla_pipelined",
    "cost_psum",
    "cost_reduce_scatter",
    "cost_allgather",
    "cost_reduce_scatter_flat",
    "cost_allgather_flat",
    "optimal_pipeline_chunks",
    "crossover_bytes",
    "dispatched_allreduce_cost",
    "optimal_bucket_bytes",
]


@dataclasses.dataclass(frozen=True)
class MachineParams:
    """Two-level max-rate machine model (paper Eq 3)."""

    alpha_l: float  # intra-node per-message latency  [s]
    beta_l: float   # intra-node per-byte cost        [s/B]
    alpha: float    # inter-node per-message latency  [s]
    R_b: float      # inter-node per-process bandwidth [B/s] (1/beta)
    R_N: float      # per-node injection bandwidth     [B/s]
    gamma: float    # local reduction cost             [s/B]
    name: str = "machine"

    @classmethod
    def fit(cls, measurements, *, base: "MachineParams | None" = None,
            name: str = "fitted") -> "MachineParams":
        """Least-squares fit of the inter-node constants from measured
        message times.

        ``measurements``: rows ``(nbytes, seconds)`` or ``(nbytes,
        seconds, active_per_node)``, each the wall time of ONE inter-node
        message step with ``active_per_node`` concurrent senders per node
        (default 1), which :func:`maxrate_message_cost` models as
        ``alpha + k*s / min(R_N, k*R_b)``:

        * ``alpha`` and ``R_b`` from a linear least-squares fit of
          ``t = alpha + s/R_b`` over the ``k == 1`` rows (at least two
          distinct sizes);
        * ``R_N`` from the ``k > 1`` rows the per-process model cannot
          explain (more than 2% slower): a through-origin fit of
          ``t - alpha = k*s/R_N``; without such rows ``base``'s is kept.

        The intra-node constants come from ``base`` (default
        :data:`TPU_V5E_POD`): message timings do not observe them."""
        base = base or TPU_V5E_POD
        rows = [(float(r[0]), float(r[1]), int(r[2]) if len(r) > 2 else 1)
                for r in measurements]
        single = [(s, t) for s, t, k in rows if k <= 1]
        if len({s for s, _ in single}) < 2:
            raise ValueError(
                "MachineParams.fit needs >= 2 single-sender (k == 1) "
                "measurements at distinct sizes to identify alpha and R_b"
            )
        A = np.array([[1.0, s] for s, _ in single])
        t = np.array([tt for _, tt in single])
        (alpha, slope), *_ = np.linalg.lstsq(A, t, rcond=None)
        alpha = max(float(alpha), 0.0)
        if slope <= 0:
            raise ValueError(
                "measured times do not grow with message size; cannot "
                "identify R_b (check the measurement units)"
            )
        R_b = 1.0 / float(slope)
        R_N = base.R_N
        limited = [(k * s, tt - alpha) for s, tt, k in rows
                   if k > 1 and tt - alpha > (s / R_b) * 1.02]
        if limited:
            x = np.array([v for v, _ in limited])
            y = np.array([v for _, v in limited])
            inv_rn = float((x * y).sum() / (x * x).sum())
            if inv_rn > 0:
                R_N = 1.0 / inv_rn
        return cls(alpha_l=base.alpha_l, beta_l=base.beta_l, alpha=alpha,
                   R_b=R_b, R_N=R_N, gamma=base.gamma, name=name)


# Gemini-class constants (order of magnitude from the max-rate papers).
BLUE_WATERS = MachineParams(
    alpha_l=5.0e-7,
    beta_l=1.8e-10,   # ~5.5 GB/s shared-memory copy
    alpha=2.6e-6,
    R_b=2.3e9,        # ~2.3 GB/s per process pair
    R_N=5.5e9,        # ~5.5 GB/s node injection
    gamma=2.5e-11,    # ~40 GB/s local reduce stream
    name="blue_waters",
)

# TPU mapping: node = pod. Intra-"node" transport is ICI (per-link ~50 GB/s,
# ~1 us software latency through XLA collectives); inter-pod is the data
# centre network with per-host NICs shared by 4 chips.
TPU_V5E_POD = MachineParams(
    alpha_l=1.0e-6,
    beta_l=2.2e-11,   # ~45 GB/s ICI effective
    alpha=1.0e-5,
    R_b=6.25e9,       # ~6.25 GB/s per chip across the DCN
    R_N=2.5e10,       # ~25 GB/s per-host NIC (4 chips)
    gamma=1.25e-12,   # 819 GB/s HBM-bound vector add
    name="tpu_v5e_pod",
)

# Four NVIDIA H100 80GB HBM3 at 700.00 W of one host (nvidia-smi
# --query-gpu=name,power.limit --format=csv,noheader), as printed by
# ``tools/fit_machine_4gpu.py`` on its 2x2 grid (2 "pod" x 2 "data", one
# rank a card, NCCL): NVLink, one host, both levels, so there is no slow
# domain.  Host clock: the median of 5 repeats of R back-to-back engine
# rounds (``collectives._ppermute``) ending in one synchronise, over R, the
# slowest rank's; Python between the NCCL calls included.  ``alpha`` /
# ``R_b`` / ``R_N`` from ``MachineParams.fit`` over the pod exchanges at
# k = 1 and k = 2, 4 B to 64 MB; ``alpha_l`` / ``beta_l`` from the fit over
# the data exchanges; ``gamma`` from an in-place float32 add of 1 to 256 MB
# on CUDA events.  Not tuned by hand.
H100_NVLINK_HOST = MachineParams(
    alpha_l=0.00024379380817420192,
    beta_l=1.1408393299822555e-12,
    alpha=0.0004121778432599465,
    R_b=191813638654.04333,
    R_N=128285901032.43329,
    gamma=9.823636927774175e-13,
    name="h100_nvlink_host",
)


def _log2(x: int) -> float:
    return math.log2(x) if x > 1 else 0.0


def _log_ppn(n: int, ppn: int) -> int:
    """ceil(log_ppn(n)) — inter-node steps of NAP (non-powers pay the next
    power's step count, paper §VI)."""
    if n <= 1:
        return 0
    if ppn < 2:
        return max(0, math.ceil(_log2(n)))
    return max(1, math.ceil(math.log(n) / math.log(ppn) - 1e-12))


def postal_cost(t: float, s: float, c: float, p: MachineParams) -> float:
    """Eq 1: T = alpha t + beta s + gamma c (node-agnostic postal model)."""
    return p.alpha * t + s / p.R_b + p.gamma * c


def maxrate_message_cost(
    s: float, p: MachineParams, active_per_node: int = 1
) -> float:
    """Eq 3 inter-node term for one message step with ``active_per_node``
    concurrent senders per node: alpha + ppn_act*s / min(R_N, ppn_act*R_b).
    """
    k = max(1, active_per_node)
    return p.alpha + (k * s) / min(p.R_N, k * p.R_b)


def cost_rd(s: float, n: int, ppn: int, p: MachineParams) -> float:
    """Eq 4: recursive doubling. Every chip crosses the network log2(n)
    times with ppn concurrent senders per node (injection-limited)."""
    intra = (p.alpha_l + p.beta_l * s) * _log2(ppn)
    inter = maxrate_message_cost(s, p, active_per_node=ppn) * _log2(n)
    comp = p.gamma * s * _log2(n * ppn)
    return intra + inter + comp


def cost_smp(s: float, n: int, ppn: int, p: MachineParams) -> float:
    """Eq 5: SMP/master algorithm. One active chip per node: full R_b."""
    intra = (p.alpha_l + p.beta_l * s) * _log2(ppn)
    inter = (p.alpha + s / p.R_b) * _log2(n)
    comp = p.gamma * s * _log2(n * ppn)
    return intra + inter + comp


def cost_nap(s: float, n: int, ppn: int, p: MachineParams) -> float:
    """Eq 6: NAP. log_ppn(n) inter steps (all ppn chips inject), intra
    cost grows to log2(p), plus log_ppn(n) extra local combines."""
    steps = _log_ppn(n, ppn)
    intra = (p.alpha_l + p.beta_l * s) * _log2(n * ppn)
    inter = maxrate_message_cost(s, p, active_per_node=ppn) * steps
    comp = p.gamma * s * (_log2(n * ppn) + steps)
    return intra + inter + comp


def cost_mla(s: float, n: int, ppn: int, p: MachineParams) -> float:
    """Multi-lane node-aware (MLA) allreduce under the max-rate model.

    Intra: psum_scatter + allgather each move ``s*(ppn-1)/ppn`` bytes over
    the fast domain in ``log2(ppn)`` message rounds.  Inter: all ``ppn``
    lanes run reduce-scatter + allgather concurrently, so each chip crosses
    the slow domain with ``2*(s/ppn)*(n-1)/n`` bytes at the per-chip rate
    ``min(R_b, R_N/ppn)`` (all lanes inject at once) over ``2*log2(n)``
    latency steps.  The serialized sum of the shared stage times — the
    one-chunk special case of :func:`cost_mla_pipelined`.
    """
    t_rs, t_inter, t_ag = _mla_stage_times(s, n, ppn, p)
    comp = p.gamma * s * 2.0  # local stripe reduce + per-lane RS folds
    return t_rs + t_inter + t_ag + comp


def cost_mla_compressed(
    s: float, n: int, ppn: int, p: MachineParams, wire_ratio: float
) -> float:
    """Quantised two-level transport cost (the fused-kernel engine in
    :mod:`repro.core.grad_sync`) for a raw ``s``-byte payload.

    The intra-node pre-combine and rebuild stay exact f32 — they pay the
    raw width — while the inter-node exchange (the RS-half all_to_all
    and the AG-half all_gather) moves ``s * wire_ratio`` bytes
    (``wire_ratio`` = packed wire itemsize / raw itemsize: 1/4 for int8
    over f32, 1/8 for packed int4).  The compute port pays four fused
    kernel passes over the payload (quantize-pack, unpack+fold,
    requantize, unpack) instead of :func:`cost_mla`'s two reduce
    streams.  This is the cost the dispatcher/planner quote for
    compressed buckets — the same packed widths the executor moves.
    """
    t_rs, _, t_ag = _mla_stage_times(s, n, ppn, p)
    _, t_inter, _ = _mla_stage_times(s * wire_ratio, n, ppn, p)
    comp = p.gamma * s * 4.0
    return t_rs + t_inter + t_ag + comp


def _mla_stage_times(
    s_c: float, n: int, ppn: int, p: MachineParams
) -> tuple[float, float, float]:
    """(intra-RS, inter RS+AG, intra-AG) times for one ``s_c``-byte chunk.

    The single source of the MLA stage formulas: :func:`cost_mla` sums
    them serially and :func:`cost_mla_pipelined` pipelines them, so the
    two models cannot drift apart.
    """
    lanes = max(1, ppn)
    li = math.ceil(_log2(ppn)) if ppn > 1 else 0
    t_intra = li * p.alpha_l + p.beta_l * s_c * (lanes - 1) / lanes
    if n > 1:
        lo = math.ceil(_log2(n))
        lane_bytes = 2.0 * (s_c / lanes) * (n - 1) / n
        rate = min(p.R_b, p.R_N / lanes)
        t_inter = 2 * lo * p.alpha + lane_bytes / rate
    else:
        t_inter = 0.0
    return t_intra, t_inter, t_intra


def cost_mla_pipelined(
    s: float, n: int, ppn: int, p: MachineParams, chunks: int | None = None
) -> float:
    """Chunked, pipelined MLA cost under the max-rate model.

    The payload is split into ``chunks`` pieces; chunk ``c``'s inter-pod
    reduce-scatter/allgather overlaps chunk ``c±1``'s intra-pod phases
    (distinct networks: ICI vs DCI).  The makespan is the classic pipeline
    bound — whichever network domain is the bottleneck processes all
    ``chunks`` of its stages back to back, plus the fill/drain cost of the
    other domain's first and last chunk:

        T = max(C*t_inter + t_rs + t_ag,  C*(t_rs + t_ag) + t_inter) + comp

    ``chunks=1`` degenerates exactly to :func:`cost_mla`.  ``chunks=None``
    picks the model-optimal depth (:func:`optimal_pipeline_chunks`) — the
    bandwidth term is unchanged by chunking while the alpha term grows
    linearly in ``C``, so the optimum balances overlap savings against
    the ``C * 2*log2(n) * alpha`` latency bill.
    """
    if chunks is None:
        chunks = optimal_pipeline_chunks(s, n, ppn, p)
    c = max(1, int(chunks))
    t_rs, t_inter, t_ag = _mla_stage_times(s / c, n, ppn, p)
    span = max(c * t_inter + t_rs + t_ag, c * (t_rs + t_ag) + t_inter)
    return span + p.gamma * s * 2.0


def optimal_pipeline_chunks(
    s: float, n: int, ppn: int, p: MachineParams, max_chunks: int = 16
) -> int:
    """Model-optimal MLA pipeline depth (1 = don't pipeline).

    Evaluates the closed form over ``1..max_chunks`` — cheap enough to be
    exact rather than using the sqrt rule of thumb, and naturally returns
    1 whenever the alpha bill outweighs the overlap (small payloads,
    latency-dominated machines).
    """
    if n <= 1 or ppn <= 1:
        return 1  # no second domain to overlap with
    best_c, best_t = 1, None
    for c in range(1, max(1, max_chunks) + 1):
        t = cost_mla_pipelined(s, n, ppn, p, chunks=c)
        if best_t is None or t < best_t:
            best_c, best_t = c, t
    return best_c


def _cost_mla_pipelined_opt(
    s: float, n: int, ppn: int, p: MachineParams
) -> float:
    return cost_mla_pipelined(s, n, ppn, p, chunks=None)


def cost_psum(s: float, n: int, ppn: int, p: MachineParams) -> float:
    """Native single-level reduce over the joint grid — the fallback
    engine's price.  Modeled as node-agnostic recursive doubling over all
    ``n*ppn`` chips (what XLA's psum costs at worst on a flat ring/tree).
    """
    if n <= 1:
        return (p.alpha_l + p.beta_l * s + p.gamma * s) * _log2(ppn)
    return cost_rd(s, n, ppn, p)


def _striped_one_way_cost(
    s: float, n: int, ppn: int, p: MachineParams
) -> float:
    """Shared transport term of one striped RS *or* AG direction: intra
    stripe phase + per-lane inter phase (all ``ppn`` lanes inject at
    once).  The single source both directions price from — RS adds the
    fold pass on top."""
    lanes = max(1, ppn)
    li = math.ceil(_log2(ppn)) if ppn > 1 else 0
    t_intra = li * p.alpha_l + p.beta_l * s * (lanes - 1) / lanes
    if n > 1:
        lo = math.ceil(_log2(n))
        lane_bytes = (s / lanes) * (n - 1) / n
        rate = min(p.R_b, p.R_N / lanes)
        t_inter = lo * p.alpha + lane_bytes / rate
    else:
        t_inter = 0.0
    return t_intra + t_inter


def cost_reduce_scatter(s: float, n: int, ppn: int, p: MachineParams) -> float:
    """Node-aware striped reduce-scatter (the RS half of the MLA
    allreduce): intra stripe + per-lane inter RS, one fold pass."""
    return _striped_one_way_cost(s, n, ppn, p) + p.gamma * s


def cost_allgather(s: float, n: int, ppn: int, p: MachineParams) -> float:
    """Node-aware striped allgather (the AG half of the MLA allreduce):
    per-lane inter AG + intra AG, no reduction work."""
    return _striped_one_way_cost(s, n, ppn, p)


def _flat_one_way_cost(s: float, n: int, ppn: int, p: MachineParams) -> float:
    """Shared transport term of one flat (node-agnostic) RS or AG
    direction over all ``n*ppn`` chips: every chip's ``s*(p-1)/p`` bytes
    cross the slow domain injection-limited whenever ``n > 1``."""
    chips = max(1, n * ppn)
    steps = math.ceil(_log2(chips))
    bytes_moved = s * (chips - 1) / chips
    if n > 1:
        rate = min(p.R_b, p.R_N / max(1, ppn))
        return steps * p.alpha + bytes_moved / rate
    return steps * p.alpha_l + p.beta_l * bytes_moved


def cost_reduce_scatter_flat(
    s: float, n: int, ppn: int, p: MachineParams
) -> float:
    """Node-agnostic flat reduce-scatter — the baseline the striped
    engine beats whenever ``n > 1``."""
    return _flat_one_way_cost(s, n, ppn, p) + p.gamma * s


def cost_allgather_flat(
    s: float, n: int, ppn: int, p: MachineParams
) -> float:
    """Node-agnostic flat allgather — mirror of
    :func:`cost_reduce_scatter_flat` without the fold pass."""
    return _flat_one_way_cost(s, n, ppn, p)


# The engine registry (``repro_torch.core.comm``) is the single place an
# engine declares its cost model; ``crossover_bytes`` resolves the ``large``
# contender there (a plain callable is also accepted).
def _resolve_large_cost(large):
    if callable(large):
        return large
    from . import comm

    return comm.get_engine(large).cost


def crossover_bytes(
    n: int,
    ppn: int,
    p: MachineParams,
    lo: float = 8.0,
    hi: float = 1 << 22,
    large: str = "smp",
) -> float:
    """Smallest message size where the ``large``-regime algorithm becomes
    cheaper than NAP (the paper measured ~2048 B vs SMP at 32 768
    processes).  ``large="mla"`` yields the dispatcher's NAP↔MLA switch
    point.  ``large`` is a registered engine name (its declared cost
    model is used) or a bare cost callable.

    Returns ``math.inf`` when NAP is still cheaper at the search cap
    ``hi`` — there is no crossover in the searched range, and callers
    (``comm.Topology.crossover_bytes``, the grad-sync planner) treat
    the saturated result as "latency regime everywhere" instead of
    mistaking the cap for a real 4 MiB switch point.
    """
    cost_large = _resolve_large_cost(large)
    if cost_nap(lo, n, ppn, p) > cost_large(lo, n, ppn, p):
        return lo
    if cost_nap(hi, n, ppn, p) <= cost_large(hi, n, ppn, p):
        return math.inf
    while hi / lo > 1.01:
        mid = math.sqrt(lo * hi)
        if cost_nap(mid, n, ppn, p) <= cost_large(mid, n, ppn, p):
            lo = mid
        else:
            hi = mid
    return math.sqrt(lo * hi)


def dispatched_allreduce_cost(
    s: float, n: int, ppn: int, p: MachineParams
) -> float:
    """Modeled cost of one ``s``-byte allreduce under the auto dispatch.

    Mirrors ``collectives.select_algorithm``'s regime choice in pure
    closed form: NAP at or below the NAP↔MLA crossover, the best of
    plain/pipelined MLA above it, single-domain costs on degenerate
    grids.  This is the per-bucket cost term the bucket-size optimum
    integrates over, so the planner and the dispatcher price a bucket
    identically.
    """
    if n <= 1:
        # single-level: intra recursive doubling only
        return (p.alpha_l + p.beta_l * s + p.gamma * s) * _log2(ppn)
    if ppn <= 1:
        # degenerate lanes: RS+AG over the slow domain (the mla fallback)
        return cost_mla(s, n, 1, p)
    xo = crossover_bytes(n, ppn, p, large="mla")
    if s <= xo:
        return cost_nap(s, n, ppn, p)
    return cost_mla_pipelined(s, n, ppn, p, chunks=None)


@functools.lru_cache(maxsize=None)
def _optimal_bucket_count(
    total_bytes: float,
    n: int,
    ppn: int,
    p: MachineParams,
    compute_seconds: float | None,
    max_buckets: int,
) -> int:
    best_k, best_t = 1, math.inf
    t_one = dispatched_allreduce_cost(total_bytes, n, ppn, p)
    tc = compute_seconds if compute_seconds is not None else t_one
    for k in range(1, max(1, max_buckets) + 1):
        s = total_bytes / k
        t = dispatched_allreduce_cost(s, n, ppn, p)
        free = 0.0
        for i in range(k):
            ready = (i + 1) * tc / k
            free = max(free, ready) + t
        if free < best_t - 1e-15:
            best_k, best_t = k, free
    return best_k


def optimal_bucket_bytes(
    total_bytes: float,
    n: int,
    ppn: int,
    p: MachineParams,
    *,
    compute_seconds: float | None = None,
    max_buckets: int = 64,
) -> float:
    """Model-optimal grad-sync bucket size for backward/comm overlap.

    Backward is modeled as producing gradient bytes at a uniform rate
    over ``compute_seconds`` (default: the unbucketed sync time — the
    comm ≈ compute regime where bucketing matters most), and the network
    as one port executing bucket allreduces back to back.  With ``k``
    equal buckets, bucket ``i`` becomes ready at ``(i+1)/k * T_c`` and
    the makespan follows the serial-port recurrence

        free_i = max(free_{i-1}, ready_i) + T_allreduce(S/k)

    More buckets expose more overlap but pay the per-bucket alpha bill
    ``k`` times; fewer serialize the whole sync behind the last gradient.
    The optimum is found by evaluating ``k = 1..max_buckets`` exactly
    (each candidate is a closed-form sum — cheap) under the same
    dispatch costs the executor will incur per bucket.
    """
    if total_bytes <= 0:
        return float(total_bytes)
    k = _optimal_bucket_count(
        float(total_bytes), n, ppn, p, compute_seconds, max_buckets
    )
    return float(total_bytes) / k
