"""The traced window: ``torch.profiler`` over a few steps, and its reading.

:func:`profile_steps` runs the steps under the profiler (CPU and CUDA
activities) inside one ``perfbench.window`` annotation that ends with a
device synchronise, writes the Chrome trace to a fixed path and reads it
back (:func:`read_trace`): the device kernels inside the window (name,
start, duration, in seconds from the window's start), the window's
length, the host operations on the window's thread (to say what the host
was doing while the device sat idle), the program's spans and the span
and host operator each kernel was launched under, and the program's
counters' growth over the window.  The per-layer readers
(``metrics/*.py``) take these; :func:`kernel_class` is a copy of
``chip_smoke.py``'s classes (``phase_profile``) with cuBLAS's ``nvjet``
kernels among the matrix products.

**The program's spans.**  While a profiler records, the program opens a
``record_function`` named ``repro_torch.<layer>`` at each layer boundary
(``repro_torch.trace_regions.span``); they land in the trace beside the
kernels, on the profiler's clock.  A kernel is matched by its
``correlation`` to the call that launched it (``cudaLaunchKernel``,
``cuLaunchKernel``: events of the categories in ``LAUNCH_CATS``).  The
launch is charged to the innermost ``repro_torch.`` span open at that
moment on the launch's own thread; where that thread has none open (on a
card autograd runs the backward on a thread of its own, which opens spans
only in a recompute) it is charged to the innermost span open on the
window's thread, the cross-thread parent.  So the backward's kernels fall
under ``repro_torch.backward``, and a recompute nests under it.  A span's
parent is found the same way from its start.  The host operator that
launched a kernel is the innermost ``cpu_op`` open at the launch on its
thread.  ``perfbench/spans.py`` reads them per layer.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

__all__ = ["RankTrace", "TraceRun", "profile_steps", "read_trace",
           "kernel_class", "busy_intervals", "busy_seconds", "idle_gaps"]

WINDOW = "perfbench.window"
PREFIX = "repro_torch."      # every span of the program starts with it
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class RankTrace:
    """One rank's traced window.

    ``spans`` are the program's ``(name, tid, start_s, dur_s, parent)``,
    times from the window's start, ``parent`` an index into ``spans`` or
    ``None``; ``kernel_span[i]`` indexes ``spans`` for kernel ``i``
    (``None``: launched under no span, or no launch found) and
    ``kernel_op[i]`` names the host operator that launched it."""

    window_s: float
    kernels: list            # (name, start_s, dur_s), start from the window
    counters: dict           # the program's counters over the window
    idle_gaps: list          # [(what the host was doing, seconds)], summed
    spans: list = dataclasses.field(default_factory=list)
    kernel_span: list = dataclasses.field(default_factory=list)
    kernel_op: list = dataclasses.field(default_factory=list)

    def chain(self, i) -> list[str]:
        """The names of span ``i`` and its ancestors, innermost first."""
        out = []
        while i is not None:
            out.append(self.spans[i][0])
            i = self.spans[i][4]
        return out


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


def _innermost(intervals, queries) -> dict:
    """``{key: value}``: for each ``(t, key)`` of ``queries`` the value of
    the innermost of ``intervals`` ``[(start, end, value)]`` (one
    thread's, so they nest) with ``start <= t <= end``, or ``None``."""
    ivs = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    out: dict = {}
    stack: list = []
    i = 0
    for t, key in sorted(queries, key=lambda q: q[0]):
        while i < len(ivs) and ivs[i][0] <= t:
            while stack and stack[-1][1] < ivs[i][0]:
                stack.pop()
            stack.append(ivs[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[key] = stack[-1][2] if stack else None
    return out


def _by_thread(items) -> dict:
    out: dict = {}
    for tid, item in items:
        out.setdefault(tid, []).append(item)
    return out


def _charge(queries, spans_of, win_tid) -> dict:
    """``{key: span index}`` for ``queries`` ``[(tid, t, key)]``: the
    innermost span open at ``t`` on ``tid``, else on the window's
    thread."""
    got: dict = {}
    for tid, qs in _by_thread((q[0], (q[1], q[2])) for q in queries).items():
        got.update(_innermost(spans_of.get(tid, []), qs))
    lost = [(t, key) for tid, t, key in queries if got[key] is None]
    if lost:
        got.update(_innermost(spans_of.get(win_tid, []), lost))
    return got


def read_trace(path: Path, counters: dict | None = None) -> RankTrace:
    """The window of a Chrome trace written by :func:`profile_steps`: the
    events inside its ``perfbench.window``, times in seconds from the
    window's start; the idle gaps by the host operations on the window's
    thread; the program's spans with each kernel charged to one (module
    docstring).  ``counters`` are the rank's counters over the window."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise RuntimeError(f"{path}: {len(win)} {WINDOW} annotations")
    t0, dur, win_tid = float(win[0]["ts"]), float(win[0]["dur"]), \
        win[0]["tid"]
    t1 = t0 + dur
    kernels, host, corr, spans, ops, launch = [], [], [], [], [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        cat = e.get("cat")
        if cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = (e["tid"], (s - t0) * 1e-6)
        if s < t0 or s > t1:
            continue
        if cat == "kernel":
            kernels.append((e["name"], (s - t0) * 1e-6, d * 1e-6))
            corr.append(e.get("args", {}).get("correlation"))
        elif cat == "cpu_op":
            if e.get("tid") == win_tid:
                host.append((e["name"], (s - t0) * 1e-6, d * 1e-6))
            ops.append((e["tid"], ((s - t0) * 1e-6, (s - t0 + d) * 1e-6,
                                   e["name"])))
        elif cat == "user_annotation" and e["name"].startswith(PREFIX):
            spans.append((e["name"], e["tid"], (s - t0) * 1e-6, d * 1e-6))
    window_s = dur * 1e-6
    spans_of = _by_thread((sp[1], (sp[2], sp[2] + sp[3], i))
                          for i, sp in enumerate(spans))
    # a span's parent: the innermost other span open at its start on its
    # thread, else on the window's thread
    parent: dict = {}
    for tid, ivs in spans_of.items():
        stack: list = []
        for a, b, i in sorted(ivs, key=lambda iv: (iv[0], -iv[1])):
            while stack and stack[-1][1] <= a:    # a sibling ending at a
                stack.pop()
            parent[i] = stack[-1][2] if stack else None
            stack.append((a, b, i))
    lost = [(spans[i][2], i) for i, p in parent.items()
            if p is None and spans[i][1] != win_tid]
    for i, p in _innermost(spans_of.get(win_tid, []), lost).items():
        parent[i] = p
    spans = [sp + (parent[i],) for i, sp in enumerate(spans)]
    queries = [launch[c] + (k,) for k, c in enumerate(corr) if c in launch]
    charged = _charge(queries, spans_of, win_tid)
    op: dict = {}
    ops_of = _by_thread(ops)
    for tid, qs in _by_thread((q[0], (q[1], q[2])) for q in queries).items():
        op.update(_innermost(ops_of.get(tid, []), qs))
    return RankTrace(
        window_s=window_s, kernels=kernels, counters=dict(counters or {}),
        idle_gaps=idle_gaps(kernels, host, window_s), spans=spans,
        kernel_span=[charged.get(k) for k in range(len(kernels))],
        kernel_op=[op.get(k) for k in range(len(kernels))])


def profile_steps(run_steps, path: Path, counters) -> RankTrace:
    """Run ``run_steps()`` under the profiler and read the trace back.
    ``counters()`` gives the program's counters (a dict of numbers), read
    before and after the window and never inside it; the trace keeps their
    growth over the window."""
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
    return read_trace(path, {k: after[k] - before[k] for k in after})
