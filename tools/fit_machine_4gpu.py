#!/usr/bin/env python3
"""The port's machine model fitted on four NVIDIA GPUs of one host (NCCL,
one rank a card), and held against the paper's engines timed on the same
cards: the constants that ``perf_model`` and the dispatcher run on.

Run from the root of a checkout on a machine with four cards::

    python3 tools/fit_machine_4gpu.py                # four ranks on the cards
    python3 tools/fit_machine_4gpu.py --device cpu   # a rehearsal on gloo

The ranks start through ``repro_torch.examples._world.launch``, as
``tools/mesh_train_4gpu.py``'s do.  Rank 0 prints one JSON line per row,
the card's name and power limit, and last one summary line ``{"ok": ...,
"constants": ...}``; the command fails if a check fails.  The rehearsal
runs at three sizes (``CPU_SIZES``) on gloo, where every time is the
CPU's.

All four cards sit in one host: ``pod`` and ``data`` are both NVLink.  The
constants describe an NVLink host with no slow domain (``LINKS``).

On each grid (2x2, 4x1, 1x4), with the groups ``Topology.from_world``
builds:

1. **Inter-node rows** (the ``pod`` group): each node exchanges a float32
   buffer with its partner node (node ``j ^ 1``) through the engines' own
   permutation round (``collectives._ppermute``, ``batch_isend_irecv``), at
   ``k = 1`` (lane 0 sends, the other lanes stay idle) and at ``k = ppn``
   (every lane sends at once): the ``(nbytes, seconds, active_per_node)``
   rows :meth:`MachineParams.fit` reads.
2. **Intra-node rows** (the ``data`` group): lanes 0 and 1 of node 0
   exchange the same buffers; ``MachineParams.fit`` over them gives
   ``alpha_l`` (its ``alpha``) and ``beta_l`` (its ``1 / R_b``).
3. **gamma**: the engines' local reduction, an in-place float32 add of 1 MB
   to 256 MB, timed with CUDA events (median of 5); the slope of a least
   squares line through ``(bytes, seconds)``.
4. **The clock**: the host clock around ``R`` back-to-back rounds that end
   in one ``torch.cuda.synchronize()`` (after one untimed round that lines
   the partners up), divided by ``R``, median of 5 repeats with the spread
   printed; the slowest rank's median is the row.  The CUDA-event time of
   the same rounds is printed beside it.  The fit is made on the host
   clock (what a round of an engine costs the port, Python between NCCL
   calls included); the fit on the event times is printed beside it as the
   NCCL floor.
5. **The fit**: ``MachineParams.fit(inter rows, base=<alpha_l, beta_l,
   gamma measured, R_N the k = ppn rows' aggregate rate>)`` on the 2x2
   grid, whose first four-card run's print is the package's
   ``perf_model.H100_NVLINK_HOST``.  Rows that do not grow with size make
   the fit raise: a failed check, after which the validation still runs.
6. **Validation**: ``psum``, ``nap``, ``mla``, ``mla_pipelined`` (at the
   chunk counts the model picks under either set of constants) and the
   paper's baselines ``rd`` and ``smp``, each where the grid admits it, at
   float32 payloads of 4 B to 64 MB (powers of 4), 3.93 MB (the
   tensor-parallel logits allreduce of 8 minicpm-2b slots) and the byte
   sizes of minicpm-2b-4l's gradient buckets; the same clock.  For each
   grid and size: each engine's measured ms and its ms predicted under
   this run's fit, the package's ``H100_NVLINK_HOST`` and ``TPU_V5E_POD``,
   what ``CommContext.dispatch`` picks under each, and that pick's
   regret, ``(measured ms of the pick -
   fastest measured ms) / fastest measured ms`` over the engines ``auto``
   may pick, and over those its cost tournament ranks (``nap``, ``mla``,
   ``mla_pipelined``: ``psum`` enters only as a fallback).  Every
   engine's result is held equal to the exact sum.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))
from mesh_train_4gpu import (  # noqa: E402
    GRIDS, LINKS, WORLD_GRID, Report, conclude, cuda_sync, gather,
)

#: the grid whose fit the package keeps: the only one with both levels
FIT_GRID = "2x2"
#: the constants' name in ``perf_model``
NAME = "h100_nvlink_host"
#: the engines ``auto`` may pick for an allreduce, and the paper's baselines
AUTO = ("psum", "nap", "mla", "mla_pipelined")
ENGINES = AUTO + ("rd", "smp")
#: the engines the cost tournament ranks (``psum`` enters as a fallback)
RANKED = ("nap", "mla", "mla_pipelined")
#: the tensor-parallel logits allreduce of 8 minicpm-2b slots (8 rows of
#: the 122,753-token vocabulary in float32; ``serve.engine.decode_dispatch``)
LOGITS_BYTES = 8 * 122_753 * 4

CARD_SIZES = {
    "payloads": [4 ** k for k in range(1, 14)],  # 4 B .. 64 MB
    "gamma": [1 << (20 + 2 * k) for k in range(5)],  # 1 MB .. 256 MB
    "model_sizes": True,  # 3.93 MB and minicpm-2b-4l's bucket sizes
    # rounds a repeat: many where a round is short, few where it is long
    "rounds": {"small": 50, "large": 5, "split": 16 << 20},
    "repeats": 5, "timeout": 600,
}
CPU_SIZES = {
    "payloads": [4, 1 << 16, 1 << 22], "gamma": [1 << 16, 1 << 20, 1 << 22],
    "model_sizes": False,
    "rounds": {"small": 2, "large": 2, "split": 0},
    "repeats": 3, "timeout": 300,
}


# ---------------------------------------------------------------------------
# the fit (pure: the rows in, the constants out)
# ---------------------------------------------------------------------------


def fit_gamma(rows) -> float:
    """Seconds a byte of the local reduction: the slope of a least squares
    line through ``(nbytes, seconds)`` (its intercept is the launch's)."""
    s = np.array([float(r[0]) for r in rows])
    t = np.array([float(r[1]) for r in rows])
    if len(set(s)) < 2:
        raise ValueError("gamma needs rows at two sizes or more")
    (_, slope), *_ = np.linalg.lstsq(np.stack([np.ones_like(s), s], 1), t,
                                     rcond=None)
    if slope <= 0:
        raise ValueError("the local reduction's times do not grow with "
                         "size; cannot identify gamma")
    return float(slope)


def injection_rate(inter) -> float:
    """A node's aggregate rate from the ``k > 1`` rows: the through-origin
    fit of ``t - alpha = k * s / R_N`` over all of them (``alpha`` from the
    ``k == 1`` rows), as :meth:`MachineParams.fit` makes it over the rows
    its per-process model cannot explain.  Without such rows, ``k * R_b``
    of the widest ``k`` seen (one lane's rate)."""
    from repro_torch.core import perf_model as pm

    one = pm.MachineParams.fit(inter, name="per_process")
    wide = [(k * s, t - one.alpha) for s, t, k in inter if k > 1]
    if not wide:
        return max(k for _, _, k in inter) * one.R_b
    x = np.array([v for v, _ in wide])
    y = np.array([v for _, v in wide])
    inv = float((x * y).sum() / (x * x).sum())
    if inv <= 0:
        raise ValueError("the k > 1 rows do not grow with size; cannot "
                         "identify R_N")
    return 1.0 / inv


def fit_constants(inter, intra, gamma_rows, *, name: str = NAME):
    """The machine constants from measured rows: ``inter`` ``(nbytes,
    seconds, active_per_node)`` of the slow level, ``intra`` ``(nbytes,
    seconds)`` within a node, ``gamma_rows`` ``(nbytes, seconds)`` of the
    local reduction.  ``alpha_l`` and ``beta_l`` are ``MachineParams.fit``'s
    ``alpha`` and ``1 / R_b`` over the intra rows, then
    ``MachineParams.fit(inter, base=...)`` the rest.  Raises
    ``ValueError`` on rows that do not grow with size."""
    from repro_torch.core import perf_model as pm

    inter = [(float(s), float(t), int(k)) for s, t, k in inter]
    lo = pm.MachineParams.fit(intra, name="intra")
    base = pm.MachineParams(
        alpha_l=lo.alpha, beta_l=1.0 / lo.R_b, alpha=lo.alpha, R_b=lo.R_b,
        R_N=injection_rate(inter), gamma=fit_gamma(gamma_rows), name=name)
    return pm.MachineParams.fit(inter, base=base, name=name)


def residuals(rows, params) -> list[dict]:
    """Each row's time against ``maxrate_message_cost`` under ``params``."""
    from repro_torch.core import perf_model as pm

    out = []
    for s, t, *k in rows:
        model = pm.maxrate_message_cost(float(s), params, *k)
        out.append({"nbytes": int(s), "k": int(k[0]) if k else 1,
                    "measured_ms": t * 1e3, "model_ms": model * 1e3,
                    "rel": (t - model) / model})
    return out


def intra_residuals(rows, params) -> list[dict]:
    """Each intra row against ``alpha_l + beta_l * s``."""
    return [{"nbytes": int(s), "measured_ms": t * 1e3,
             "model_ms": (params.alpha_l + params.beta_l * s) * 1e3,
             "rel": (t - params.alpha_l - params.beta_l * s)
             / (params.alpha_l + params.beta_l * s)} for s, t in rows]


# ---------------------------------------------------------------------------
# the clock
# ---------------------------------------------------------------------------


def rounds_for(nbytes: int, sizes: dict) -> int:
    r = sizes["rounds"]
    return r["small"] if nbytes <= r["split"] else r["large"]


def clock(fn, rounds: int, repeats: int, device) -> dict:
    """``fn`` timed as the module docstring's step 4 says: the host clock
    around ``rounds`` calls that end in one synchronise, over ``rounds``,
    median of ``repeats`` (and their spread); the CUDA-event time of the
    same calls beside it (``None`` on the CPU).  Every rank calls it at the
    same point; a barrier starts each repeat, one untimed call lines the
    partners up."""
    import torch.distributed as dist

    on_card = device.type == "cuda"
    fn()
    host, dev = [], []
    for _ in range(repeats):
        dist.barrier()
        fn()
        cuda_sync(device)
        if on_card:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        for _ in range(rounds):
            fn()
        if on_card:
            end.record()
        cuda_sync(device)
        host.append((time.perf_counter() - t0) / rounds)
        if on_card:
            dev.append(start.elapsed_time(end) / 1e3 / rounds)
    return {"host_s": statistics.median(host),
            "host_spread_s": [min(host), max(host)],
            "device_s": statistics.median(dev) if dev else None}


def slowest(t: dict) -> dict:
    """The slowest rank's clock (a step ends when its last rank does)."""
    every = gather(t)
    worst = max(every, key=lambda v: v["host_s"])
    dev = [v["device_s"] for v in every]
    return {**worst, "device_s": None if None in dev else max(dev),
            "host_s_by_rank": [v["host_s"] for v in every]}


# ---------------------------------------------------------------------------
# the rows
# ---------------------------------------------------------------------------


def exchange_pairs(n: int, ppn: int, level: str, k: int) -> list:
    """``(src, dst)`` grid indices of one exchange round: ``inter``, nodes
    ``j`` and ``j ^ 1`` on lanes ``0 .. k-1``; ``intra``, lanes 0 and 1 of
    node 0."""
    if level == "intra":
        return [(0, 1), (1, 0)]
    return [(j * ppn + r, (j ^ 1) * ppn + r)
            for j in range(n - n % 2) for r in range(k)]


def message_rows(topo, sizes, device, rep: Report, grid: str) -> dict:
    """The grid's inter (``k = 1`` and ``k = ppn``) and intra rows."""
    from repro_torch.core import collectives

    n, ppn = topo.n_nodes, topo.ppn
    kinds = []
    if n > 1:
        kinds += [("inter", 1)] + ([("inter", ppn)] if ppn > 1 else [])
    if ppn > 1:
        kinds.append(("intra", 1))
    out = {"inter": [], "inter_device": [], "intra": [], "intra_device": []}
    for level, k in kinds:
        pairs = exchange_pairs(n, ppn, level, k)
        for nbytes in sizes["payloads"]:
            buf = torch.ones(nbytes // 4, device=device)
            t = slowest(clock(
                lambda: collectives._ppermute(buf, pairs, topo.groups),
                rounds_for(nbytes, sizes), sizes["repeats"], device))
            row = (nbytes, t["host_s"], k) if level == "inter" \
                else (nbytes, t["host_s"])
            out[level].append(row)
            if t["device_s"] is not None:
                out[f"{level}_device"].append(
                    (nbytes, t["device_s"], *row[2:]))
            rep.emit({"check": "message_row", "grid": grid, "level": level,
                      "k": k, "pairs": pairs, "nbytes": nbytes,
                      "rounds": rounds_for(nbytes, sizes),
                      "host_ms": t["host_s"] * 1e3,
                      "host_ms_spread": [v * 1e3 for v in
                                         t["host_spread_s"]],
                      "host_ms_by_rank": [v * 1e3 for v in
                                          t["host_s_by_rank"]],
                      "device_ms": None if t["device_s"] is None
                      else t["device_s"] * 1e3, "links": LINKS})
            del buf
    return out


def gamma_rows(sizes, device, rep: Report) -> list:
    """``(nbytes, seconds)`` of an in-place float32 add: CUDA events on
    the card (median of ``repeats`` of ``rounds`` adds), the host clock on
    the CPU; the slowest rank's."""
    on_card = device.type == "cuda"
    rows = []
    for nbytes in sizes["gamma"]:
        a = torch.ones(nbytes // 4, device=device)
        b = torch.ones_like(a)
        reps = []
        for _ in range(sizes["repeats"]):
            a.add_(b)
            cuda_sync(device)
            if on_card:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                for _ in range(10):
                    a.add_(b)
                end.record()
                torch.cuda.synchronize()
                reps.append(start.elapsed_time(end) / 1e3 / 10)
            else:
                t0 = time.perf_counter()
                for _ in range(10):
                    a.add_(b)
                reps.append((time.perf_counter() - t0) / 10)
        sec = max(gather(statistics.median(reps)))
        rows.append((nbytes, sec))
        rep.emit({"check": "gamma_row", "nbytes": nbytes, "ms": sec * 1e3,
                  "clock": "cuda_events" if on_card else "host",
                  "GB_per_s": nbytes / sec / 1e9})
        del a, b
    return rows


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------


def bucket_sizes(n: int, ppn: int, constants) -> list:
    """The distinct byte sizes of minicpm-2b-4l's gradient buckets planned
    on an ``n x ppn`` grid under each set of ``constants``."""
    from repro_torch.configs import MINICPM_2B_4L
    from repro_torch.core import CommPolicy, Topology, grad_sync
    from repro_torch.models import init_params

    tree = init_params(MINICPM_2B_4L, device="meta")
    return sorted({b.nbytes for p in constants for b in grad_sync.plan_for_tree(
        tree, cfg=CommPolicy(), topology=Topology.of(n, ppn, params=p)
    ).buckets})


def validation_sizes(sizes, n, ppn, constants) -> list[tuple[int, str]]:
    out = [(s, "power_of_4") for s in sizes["payloads"]]
    if sizes["model_sizes"]:
        out.append((LOGITS_BYTES, "tp_logits_8_slots"))
        out += [(s, "minicpm-2b-4l_bucket")
                for s in bucket_sizes(n, ppn, constants)]
    return sorted(out)


def predicted_ms(engine: str, chunks: int, nbytes: int, n, ppn, params):
    from repro_torch.core import comm
    from repro_torch.core import perf_model as pm

    if engine == "mla_pipelined":
        return pm.cost_mla_pipelined(float(nbytes), n, ppn, params,
                                     chunks=chunks) * 1e3
    return comm.get_engine(engine).cost(float(nbytes), n, ppn, params) * 1e3


def validate(rank, topo, sizes, device, rep: Report, grid: str,
             constants: dict) -> dict:
    """Every admitted engine timed at every size; the predictions, picks
    and regrets under each set of ``constants`` (name -> params): the
    grid's rows."""
    from repro_torch.core import CommContext, Topology, comm

    n, ppn = topo.n_nodes, topo.ppn
    ctx = CommContext(topo)
    world = n * ppn
    plans = {c: CommContext(Topology.of(n, ppn, params=p))
             for c, p in constants.items()}
    admitted = [e for e in ENGINES
                if n >= comm.get_engine(e).min_nodes
                and ppn >= comm.get_engine(e).min_ppn]
    rows = []
    for nbytes, what in validation_sizes(sizes, n, ppn,
                                         list(constants.values())):
        elems = nbytes // 4
        picks = {c: tuple(plans[c].dispatch(nbytes)) for c in constants}
        runs = []  # (engine, chunks)
        for e in admitted:
            if e == "mla_pipelined":
                runs += [(e, c) for c in sorted({
                    plans[k].topology.optimal_pipeline_chunks(nbytes)
                    for k in constants})]
            else:
                runs.append((e, 1))
        x = torch.full((elems,), float(rank + 1), device=device)
        measured = {}
        for e, c in runs:
            call = lambda e=e, c=c: ctx.allreduce(  # noqa: E731
                x, algorithm=e, pipeline_chunks=c)
            # ranks' values 1..world: every element sums to world(world+1)/2
            exact = bool(torch.all(call() == world * (world + 1) / 2))
            rep.hold(all(gather(exact)),
                     f"{grid} {e}/{c} at {nbytes} B: not the exact sum")
            t = slowest(clock(call, rounds_for(nbytes, sizes),
                              sizes["repeats"], device))
            key = f"{e}/{c}" if e == "mla_pipelined" else e
            measured[key] = {
                "host_ms": t["host_s"] * 1e3,
                "host_ms_spread": [v * 1e3 for v in t["host_spread_s"]],
                "device_ms": None if t["device_s"] is None
                else t["device_s"] * 1e3,
                **{f"predicted_ms_{k}": predicted_ms(e, c, nbytes, n, ppn, p)
                   for k, p in constants.items()}}
        del x
        row = {"check": "validation", "grid": grid, "nbytes": nbytes,
               "size": what, "engines": measured,
               "fastest_overall": min(measured,
                                      key=lambda k: measured[k]["host_ms"]),
               "links": LINKS}
        for k, (eng, c) in picks.items():
            row[f"pick_{k}"] = f"{eng}/{c}" if eng == "mla_pipelined" else eng
            row[f"regret_{k}"] = regret(measured, row[f"pick_{k}"], AUTO)
            row[f"regret_ranked_{k}"] = regret(measured, row[f"pick_{k}"],
                                               RANKED)
        rep.emit(row)
        rows.append(row)
    return rows


def regret(engines: dict, pick: str, among) -> float | None:
    """``(measured ms of pick - fastest measured ms) / fastest`` over the
    measured engines named in ``among`` (``None`` if ``pick`` is not one
    of them)."""
    cands = {k: v["host_ms"] for k, v in engines.items()
             if k.split("/")[0] in among}
    if pick not in cands:
        return None
    best = min(cands.values())
    return (cands[pick] - best) / best


def regret_summary(rows, names) -> dict:
    """Per grid and set of constants (``names``): the largest and mean
    regret of ``auto``'s pick over the sizes, among the engines it may
    pick (``auto``) and among those the tournament ranks (``ranked``),
    and at how many sizes it picked the fastest."""
    acc: dict = {}
    for r in rows:
        for k in names:
            for label in ("auto", "ranked"):
                v = r[f"regret_{k}" if label == "auto"
                      else f"regret_ranked_{k}"]
                if v is not None:
                    acc.setdefault(r["grid"], {}).setdefault(
                        k, {}).setdefault(label, []).append(v)
    return {g: {k: {label: {"max": max(v), "mean": statistics.fmean(v),
                            "zero_regret_sizes": sum(1 for x in v if x == 0),
                            "sizes": len(v)}
                    for label, v in by.items()}
                for k, by in ks.items()}
            for g, ks in acc.items()}


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------


def _finite(p) -> bool:
    return all(math.isfinite(getattr(p, f)) and getattr(p, f) >= 0
               for f in ("alpha_l", "beta_l", "alpha", "R_b", "R_N",
                         "gamma"))


def rank_main(rank, topology, device, *, sizes) -> dict:
    """One rank: the rows of every grid, the fits, then the validation."""
    from repro_torch.core import Topology
    from repro_torch.core import perf_model as pm

    rep = Report(rank)
    dev = torch.device(device.type)  # the rank's card is the current one
    topos = {g: topology if shape == WORLD_GRID else Topology.from_world(
        *shape) for g, shape in GRIDS.items()}
    rows = {g: message_rows(t, sizes, dev, rep, g) for g, t in topos.items()}
    gam = gamma_rows(sizes, dev, rep)

    # every rank fits the same rows (the slowest rank's): one answer; a
    # rehearsal's constants are the CPU's, and named so
    name = NAME if dev.type == "cuda" else "gloo_rehearsal"
    r = rows[FIT_GRID]
    fit = {"grid": FIT_GRID, "gamma_rows": [[s, t * 1e3] for s, t in gam],
           "links": LINKS}
    fitted = None
    try:
        fitted = fit_constants(r["inter"], r["intra"], gam, name=name)
    except ValueError as e:  # the rows do not grow with size
        rep.hold(False, f"the fit: {e}")
        fit["error"] = str(e)
    if fitted is not None:
        rep.hold(_finite(fitted), f"the fit is not finite: {fitted}")
        fit.update(
            constants=dataclasses.asdict(fitted),
            # the slow level alone on the other grids, the rest as 2x2's
            fits_by_grid={g: dataclasses.asdict(pm.MachineParams.fit(
                rr["inter"], base=fitted, name=f"{name}_{g}"))
                for g, rr in rows.items() if g != FIT_GRID and rr["inter"]},
            inter_residuals=residuals(r["inter"], fitted),
            intra_residuals=intra_residuals(r["intra"], fitted))
    if r["inter_device"]:  # beside the fit: the same rows on CUDA events
        try:
            fit["constants_device_clock"] = dataclasses.asdict(fit_constants(
                r["inter_device"], r["intra_device"], gam,
                name=f"{name}_device_clock"))
        except ValueError as e:
            fit["device_clock_error"] = str(e)
    rep.emit({"check": "fit", **fit})
    # this run's fit (in sample), the package's constants (out of sample
    # but for the run that printed them) and the reference's
    constants = {"package": pm.H100_NVLINK_HOST, "tpu_v5e_pod": pm.TPU_V5E_POD}
    if fitted is not None:
        constants = {"fitted": fitted, **constants}
    checked = [row for g, t in topos.items()
               for row in validate(rank, t, sizes, dev, rep, g, constants)]
    return {"bad": rep.bad, "rows": rep.rows,
            "summary": {"constants": fit.get("constants"),
                        "constants_device_clock": fit.get(
                            "constants_device_clock"),
                        # as strings: "inf" where NAP never loses below
                        # the search's cap
                        "crossover_bytes_2x2": {
                            k: str(Topology.of(2, 2, params=p)
                                   .crossover_bytes())
                            for k, p in constants.items()},
                        "regret": regret_summary(checked, constants)}}


def run(device=None) -> list:
    """The tool on four ranks (the cards unless ``device="cpu"``); every
    rank's :func:`rank_main` value."""
    from repro_torch.device import resolve_device
    from repro_torch.examples import _world

    dev = resolve_device(device)
    sizes = CPU_SIZES if dev.type == "cpu" else CARD_SIZES
    return _world.launch(rank_main, device=dev.type, grid=WORLD_GRID,
                         cpu_grid=WORLD_GRID, timeout=sizes["timeout"],
                         sizes=sizes)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default: four cards, NCCL) or cpu (a "
                         "rehearsal on four gloo processes)")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    try:
        ranks = run(dev.type)
    except (RuntimeError, TimeoutError) as e:
        print(json.dumps({"ok": False, "error": str(e)}), flush=True)
        raise SystemExit(1)
    conclude(ranks, dev, ("fit", "validation"), t0, **ranks[0]["summary"])


if __name__ == "__main__":
    main()
