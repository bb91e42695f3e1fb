"""The traced window: ``torch.profiler`` over a few steps, and its reading.

:func:`profile_steps` runs the steps under the profiler (CPU and CUDA
activities) inside one ``perfbench.window`` annotation that ends with a
device synchronise, writes the Chrome trace to a fixed path and reads it
back: the device kernels inside the window (name, start, duration, in
seconds from the window's start), the window's length, and the host
operations on the window's thread (to say what the host was doing while
the device sat idle).  The per-layer readers (``metrics/*.py``) take
these kernels; :func:`kernel_class` is a copy of ``chip_smoke.py``'s
classes (``phase_profile``) with cuBLAS's ``nvjet`` kernels among the
matrix products.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

__all__ = ["RankTrace", "TraceRun", "profile_steps", "read_trace", "kernel_class",
           "busy_intervals", "busy_seconds", "idle_gaps"]

WINDOW = "perfbench.window"


@dataclasses.dataclass
class RankTrace:
    """One rank's traced window."""

    window_s: float
    kernels: list            # (name, start_s, dur_s), start from the window
    counters: dict           # the program's counters over the window
    idle_gaps: list          # [(what the host was doing, seconds)], summed


@dataclasses.dataclass
class TraceRun:
    """What a per-layer reader reads: every rank's traced window over
    ``steps`` steps, the benchmark's counts for the cell (``flops`` and,
    with compression, ``transport_bytes`` of one step) and the card's
    peaks (``bf16_flops``, ``bytes_per_s``)."""

    steps: int
    chips: int
    ranks: list
    counts: dict
    peaks: dict

    def per_step(self, value: float) -> float:
        return value / self.steps

    def class_seconds(self, rank: int, cls: str) -> float:
        """Device seconds of rank ``rank``'s kernels of class ``cls``."""
        return sum(d for n, _, d in self.ranks[rank].kernels
                   if kernel_class(n) == cls)

    def class_count(self, rank: int, cls: str) -> int:
        return sum(1 for n, _, _ in self.ranks[rank].kernels
                   if kernel_class(n) == cls)


def kernel_class(name: str) -> str:
    low = name.lower()
    if "quantize_pack_kernel" in low or "unpack_dequantize_kernel" in low:
        return "transport"
    if low.startswith("nccl"):
        return "nccl"
    if any(k in low for k in ("gemm", "cutlass", "xmma", "cublas",
                              "nvjet")):
        return "matmul"
    return "other"


def busy_intervals(kernels) -> list[tuple[float, float]]:
    """The union of the kernels' intervals, as sorted disjoint spans."""
    spans = sorted((s, s + d) for _, s, d in kernels)
    out: list[list[float]] = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_seconds(kernels) -> float:
    return sum(b - a for a, b in busy_intervals(kernels))


def idle_gaps(kernels, host_ops, window_s: float, top: int = 10) -> list:
    """The device's idle time inside the window, summed by the innermost
    host operation running at each gap's middle (``"(no host op)"`` where
    none is), the ``top`` largest."""
    busy = busy_intervals(kernels)
    gaps, t = [], 0.0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < window_s:
        gaps.append((t, window_s))
    # host operations on one thread nest: a stack swept along the gaps'
    # middles finds the innermost one running at each
    ops = sorted(host_ops, key=lambda o: (o[1], -o[2]))
    by: dict[str, float] = {}
    stack: list = []
    i = 0
    for a, b in gaps:
        mid = (a + b) / 2
        while i < len(ops) and ops[i][1] <= mid:
            while stack and stack[-1][1] + stack[-1][2] < ops[i][1]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] + stack[-1][2] < mid:
            stack.pop()
        label = stack[-1][0] if stack else "(no host op)"
        by[label] = by.get(label, 0.0) + (b - a)
    return sorted(by.items(), key=lambda kv: -kv[1])[:top]


def read_trace(path: Path) -> tuple[float, list, list]:
    """``(window_s, kernels, host_ops)`` of a Chrome trace written by
    :func:`profile_steps`: the events inside its ``perfbench.window``,
    times in seconds from the window's start; host operations on the
    window's thread only."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise RuntimeError(f"{path}: {len(win)} {WINDOW} annotations")
    t0, dur, tid = float(win[0]["ts"]), float(win[0]["dur"]), win[0]["tid"]
    t1 = t0 + dur
    kernels, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if s < t0 or s > t1:
            continue
        cat = e.get("cat")
        if cat == "kernel":
            kernels.append((e["name"], (s - t0) * 1e-6, d * 1e-6))
        elif cat == "cpu_op" and e.get("tid") == tid:
            host.append((e["name"], (s - t0) * 1e-6, d * 1e-6))
    return dur * 1e-6, kernels, host


def profile_steps(run_steps, path: Path, counters) -> RankTrace:
    """Run ``run_steps()`` under the profiler and read the trace back.
    ``counters()`` gives the program's counters (a dict of numbers); the
    trace keeps their growth over the window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    path.parent.mkdir(parents=True, exist_ok=True)
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    before = counters()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            run_steps()
            if cuda:
                torch.cuda.synchronize()
    after = counters()
    prof.export_chrome_trace(str(path))
    window_s, kernels, host = read_trace(path)
    return RankTrace(
        window_s=window_s, kernels=kernels,
        counters={k: after[k] - before[k] for k in after},
        idle_gaps=idle_gaps(kernels, host, window_s))
