"""The command: one run of one cell, one JSON line as its result.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``.  A one-chip cell runs in this process; a four-chip cell
starts one process a card (``spawn``), NCCL with ``device_id=`` over a
free ``localhost`` port, and rank 0 hands its result back here.  The
last line of standard output is the result; the last lines of standard
error are the numbers compared, each beside its limit.  The run fails,
printing no result, without the cards the cell asks for, or if this
process or a rank has loaded JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import multiprocessing as mp
import os
import queue as queue_mod
import socket
import statistics
import sys
import time
import traceback

import numpy as np

from . import manifest as mf
from .manifest import HERE

__all__ = ["main", "result_line", "spawn"]

RANK_TIMEOUT_S = 1100.0


def _log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _setup_env() -> None:
    """Every cache of the program inside the checkout, at fixed paths."""
    cache = HERE / "out" / "cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("USE_FLAX", "0")


def _rank_entry(fn, rank, world, port, device_type, args, queue) -> None:
    """A spawned rank: ``fn(rank, world, port, device, *args)``; rank 0's
    value goes back on ``queue``."""
    try:
        device = f"cuda:{rank}" if device_type == "cuda" else "cpu"
        res = fn(rank, world, port, device, *args)
        if rank == 0:
            queue.put(("ok", res))
    except BaseException:
        text = f"rank {rank}:\n{traceback.format_exc()}"
        _log(text)
        queue.put(("error", text))
        sys.stderr.flush()
        os._exit(1)


def in_world(rank, world, port, device, fn, *args):
    """``fn(rank, device, *args)`` inside this rank's process group (TF32
    off on a card, one thread on the CPU)."""
    import torch

    from .rank import close_world, init_world

    if str(device).startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    init_world(rank, world, torch.device(device), port)
    try:
        return fn(rank, device, *args)
    finally:
        close_world()


def _cell_run(rank, device, cell, seed, seconds, trace, fault, window):
    from .rank import run_rank

    return run_rank(cell, seed, rank=rank, world=cell.chips, device=device,
                    seconds=seconds, trace=trace, fault=fault,
                    window=window, log=_log)


def launch(fn, world: int, *args, device_type: str = "cuda"):
    """Rank 0's value of ``in_world(..., fn, *args)`` on ``world`` ranks:
    this process alone for one rank on a card, else one spawned process a
    rank (``fn`` importable by name)."""
    if world == 1 and device_type == "cuda":
        return in_world(0, 1, _free_port(), "cuda:0", fn, *args)
    if device_type == "cuda":
        from repro_torch.kernels import transport

        transport.build_library()   # once, before the ranks load it
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_entry, args=(
        in_world, r, world, port, device_type, (fn,) + args, queue))
        for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_TIMEOUT_S
    got = None
    try:
        while got is None:
            try:
                got = queue.get(timeout=1.0)
            except queue_mod.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    raise RuntimeError("a rank failed: exit codes "
                                       f"{[p.exitcode for p in procs]}")
                if time.monotonic() > deadline:
                    raise TimeoutError("the ranks did not finish")
        if got[0] == "error":
            raise RuntimeError(got[1])
        for p in procs:
            p.join(timeout=120)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return got[1]


def spawn(cell, seed, seconds, trace, fault=None, device_type="cuda",
          window=True):
    """Rank 0's result of one run of ``cell``."""
    return launch(_cell_run, cell.chips, cell, seed, seconds, trace, fault,
                  window, device_type=device_type)


def result_line(cell, res, trace: bool, t_start: float, counts: dict,
                peaks: dict, power: list) -> dict:
    """The result's JSON object from rank 0's gathered result."""
    from .spans import idle_gaps_by_span
    from .trace import TraceRun, busy_seconds

    ranks = res.check["ranks"]
    world = len(ranks)
    tokens = cell.traffic["global_batch"] * cell.traffic["seq_len"]
    failed = sum(1 for v in res.check_losses + [res.final_loss]
                 if not math.isfinite(v))
    peak = max(r.peak_bytes for r in ranks)
    setup_s = max(r.window_start for r in ranks) - t_start
    device = {"platform": "gpu", "kind": res.kind, "count": world,
              "memory_peak_bytes": peak}
    if power:
        device["nvidia_smi"] = power
    metrics: dict = {}
    out = {"correct": res.check["correct"], "attempted": res.steps,
           "failed": failed, "metrics": metrics, "device": device}
    if trace:
        run = TraceRun(steps=res.steps, chips=world,
                       ranks=[r.trace for r in ranks], counts=counts,
                       peaks=peaks)
        device["busy_s"] = statistics.mean(busy_seconds(t.kernels)
                                           for t in run.ranks)
        device["window_s"] = statistics.mean(t.window_s for t in run.ranks)
        for m in cell.per_layer:
            value = mf.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        totals: dict = {}
        for name, _, d in run.ranks[0].kernels:
            totals[name] = totals.get(name, 0.0) + d
        out["breakdown"] = {
            "device_ops": [[n[:120], s] for n, s in sorted(
                totals.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[n[:120], s] for n, s in run.ranks[0].idle_gaps],
            "idle_gaps_by_span": [[n[:120], s] for n, s in
                                  idle_gaps_by_span(run.ranks[0])],
        }
    else:
        step_ms = np.max(np.array([r.step_ms for r in ranks]), axis=0)
        window_s = max(r.window_ms for r in ranks) / 1e3
        values = {
            "tokens_per_s": res.steps * tokens / window_s,
            "step_ms_p90": float(np.percentile(step_ms, 90)),
            "peak_mem_gib": peak / 2 ** 30,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    out["checks"] = [{"name": n, "value": v, "limit": lim}
                     for n, v, lim in res.check["rows"]]
    return out


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.time() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _setup_env()
    cell = mf.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        _log(f"{cell.name} needs {cell.chips} CUDA card(s); "
             f"{torch.cuda.device_count()} visible")
        return 2
    from . import counts as cnt
    from . import peaks as pk

    power = pk.smi()
    _log(f"cards: {power}")
    counts = cnt.of_cell(cell)
    trace = bool(args.trace)
    res = spawn(cell, args.seed, args.seconds, trace)
    _log("plan (leaves, bytes, dtype, engine, chunks):",
         json.dumps(res.plan))
    bad = sorted(set(sum((r.forbidden for r in res.check["ranks"]), [])))
    from .rank import forbidden_modules

    bad = sorted(set(bad) | set(forbidden_modules()))
    if bad:
        _log(f"JAX or the JAX package was loaded: {bad}")
        return 3
    out = result_line(cell, res, trace, t_start, counts,
                      pk.card_peaks(res.kind), power)
    for c in out["checks"]:
        _log(f"check {c['name']} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0
