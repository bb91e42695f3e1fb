"""The program's spans in a traced window, and the kernels charged to them.

While a profiler records, the program opens a ``record_function`` named
``repro_torch.<layer>`` at each layer boundary
(``repro_torch.trace_regions.span``): the DP step's forward and backward,
a remat checkpoint's recompute inside the backward, the gradient sync,
AdamW, the MoE route and its experts.  They land in the Chrome trace that
``trace.profile_steps`` writes, on the profiler's clock, beside the
kernels.  No switch turns them on: a recording profiler does.

**Charging a kernel to a span.**  A kernel is matched by its ``correlation``
to the call that launched it (``cudaLaunchKernel``, ``cuLaunchKernel``:
events of the categories in ``LAUNCH_CATS``).  The launch is charged to the
innermost ``repro_torch.`` span open at that moment on the launch's own
thread; where that thread has none open (on a card autograd runs the
backward on a thread of its own, which opens spans only in a recompute) it
is charged to the innermost span open on the window's thread, the
cross-thread parent.  So the backward's kernels fall under
``repro_torch.backward``, and a recompute nests under it.  A span's parent
is found the same way from its start.  The host operator that launched a
kernel is the innermost ``cpu_op`` open at the launch on its thread.

**Idle gaps by span.**  Each idle gap of the device inside the window is
charged to the span and the host operator that launched the kernel ending
the gap, whatever thread that was on (``trace.idle_gaps`` charges it to
the window thread's operator at the gap's middle).

**What the readers read.**  :func:`read_spans` reads a trace file into a
:class:`SpanTrace`: ``trace.read_trace``'s window, kernels and idle gaps,
as a ``trace.RankTrace``, with three more fields (empty by default) for
the spans.  The span readers (``metrics/*_ms.py``, through
:func:`span_ms`) take those fields from a ``TraceRun``'s rank, and the
counter readers (``metrics/moe_*.py``, through :func:`moe_counter`) the
program's MoE counter from the rank's ``counters`` under the keys
``moe_routed`` (items offered, tokens x top-k), ``moe_slots`` (expert rows
computed) and ``moe_kept`` (items kept under the capacity), each the
growth over the window of ``trace_regions.moe_counts()``.  Each finds
nothing where the rank holds neither, as the harness's own ranks do until
``trace.profile_steps`` keeps the spans and ``rank._counters`` reads the
counter (``PERF.md`` §7).

``python3 -m perfbench.spans <trace.json> [--steps N]`` prints a trace's
spans, the step's phases and the idle gaps by span as one JSON line.
``PYTHONPATH=src python3 -m perfbench.spans --workload <cell> --seed <n>``
runs a one-chip cell's traced run in this process (``run.py --trace 1``),
reads the MoE counter before and after it, and prints the run's result
line with the span and counter metrics of ``METRICS``, the counter's
totals a step and ``breakdown.idle_gaps_by_span`` added.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
from pathlib import Path

from . import manifest as mf
from .trace import (WINDOW, RankTrace, TraceRun, busy_intervals, idle_gaps,
                    read_trace)

__all__ = ["PREFIX", "PHASES", "METRICS", "MOE_KEYS", "SpanTrace",
           "read_spans", "span_seconds", "span_ms", "moe_counter",
           "phase_ms", "idle_gaps_by_span", "traced_run"]

PREFIX = "repro_torch."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NO_SPAN = "(no span)"
NO_OP = "(no host op)"
WINDOW_END = "(window end)"
MOE_KEYS = ("moe_routed", "moe_slots", "moe_kept")
# the step's phases: (metric, span, spans left out of it)
PHASES = (
    ("forward_ms", "repro_torch.forward", ()),
    ("backward_ms", "repro_torch.backward", ("repro_torch.recompute",)),
    ("recompute_ms", "repro_torch.recompute", ()),
    ("sync_ms", "repro_torch.grad_sync", ()),
    ("adamw_ms", "repro_torch.adamw", ()),
)
# the readers of this module's fields, with their units
METRICS = {"forward_ms": "ms/step", "backward_ms": "ms/step",
           "recompute_ms": "ms/step", "sync_ms": "ms/step",
           "adamw_ms": "ms/step", "moe_dispatch_ms": "ms/step",
           "moe_slot_use": "%", "moe_drop_share": "%"}


@dataclasses.dataclass
class SpanTrace(RankTrace):
    """A rank's traced window with the program's spans.

    ``spans`` are ``(name, tid, start_s, dur_s, parent)``, times from the
    window's start, ``parent`` an index into ``spans`` or ``None``;
    ``kernel_span[i]`` indexes ``spans`` for kernel ``i`` (``None``:
    launched under no span, or no launch found) and ``kernel_op[i]``
    names the host operator that launched it."""

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


def read_spans(path: Path, counters: dict | None = None) -> SpanTrace:
    """``trace.read_trace``'s reading of ``path`` with the program's spans
    and each kernel charged to one (module docstring); ``counters`` are
    the rank's counters over the window."""
    window_s, kernels, host = read_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    win = next(e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation")
    t0, t1, win_tid = float(win["ts"]), float(win["ts"]) + float(
        win["dur"]), win["tid"]
    corr, spans, ops, launch = [], [], [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        cat = e.get("cat")
        if cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = (e["tid"], (s - t0) * 1e-6)
        if s < t0 or s > t1:
            continue
        if cat == "kernel":     # the kernels of read_trace, in its order
            corr.append(e.get("args", {}).get("correlation"))
        elif cat == "user_annotation" and e["name"].startswith(PREFIX):
            spans.append((e["name"], e["tid"], (s - t0) * 1e-6, d * 1e-6))
        elif cat == "cpu_op":
            ops.append((e["tid"], ((s - t0) * 1e-6, (s - t0 + d) * 1e-6,
                                   e["name"])))
    if len(corr) != len(kernels):
        raise RuntimeError(f"{path}: {len(corr)} kernels, read_trace "
                           f"read {len(kernels)}")
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
    return SpanTrace(
        window_s=window_s, kernels=kernels, counters=dict(counters or {}),
        idle_gaps=idle_gaps(kernels, host, window_s), spans=spans,
        kernel_span=[charged.get(k) for k in range(len(kernels))],
        kernel_op=[op.get(k) for k in range(len(kernels))])


def span_seconds(rt: RankTrace, name: str, *, self_only: bool = False,
                 leave_out=()) -> float | None:
    """Device seconds of the kernels charged to span ``name`` (with
    ``self_only``) or to it and every span under it, less those under any
    span of ``leave_out``; ``None`` where no span ``name`` was opened (a
    ``RankTrace`` with no span fields has none)."""
    if not any(sp[0] == name for sp in getattr(rt, "spans", ())):
        return None
    total = 0.0
    for (_, _, d), i in zip(rt.kernels, rt.kernel_span):
        if i is None:
            continue
        chain = rt.chain(i)
        inside = chain[0] == name if self_only else name in chain
        if inside and not any(n in chain for n in leave_out):
            total += d
    return total


def span_ms(run: TraceRun, name: str, *, rank: int = 0,
            self_only: bool = False, leave_out=()) -> float | None:
    """Device ms a step charged to span ``name`` in rank ``rank``'s window
    of ``run`` (:func:`span_seconds`); ``None`` where it has no such
    span."""
    s = span_seconds(run.ranks[rank], name, self_only=self_only,
                     leave_out=leave_out)
    return None if s is None else 1e3 * run.per_step(s)


def moe_counter(run: TraceRun, rank: int = 0) -> dict | None:
    """Rank ``rank``'s MoE counter over ``run``'s window (``MOE_KEYS``),
    or ``None`` where its counters lack a key or routed nothing."""
    c = run.ranks[rank].counters
    if any(k not in c for k in MOE_KEYS) or not c["moe_routed"] \
            or not c["moe_slots"]:
        return None
    return {k: c[k] for k in MOE_KEYS}


def phase_ms(rt: SpanTrace, steps: int) -> dict:
    """The step's phases (``PHASES``), device ms a step; a phase whose
    span was never opened is left out."""
    out = {}
    for metric, name, leave_out in PHASES:
        s = span_seconds(rt, name, leave_out=leave_out)
        if s is not None:
            out[metric] = 1e3 * s / steps
    return out


def idle_gaps_by_span(rt: SpanTrace, top: int = 10) -> list:
    """The device's idle time inside the window, summed by ``"<span> |
    <host op>"`` of the kernel that ends each gap (module docstring), the
    ``top`` largest; the gap after the last kernel is ``(window end)``."""
    first: dict = {}
    for k, (_, s, _) in enumerate(rt.kernels):
        if s not in first:
            first[s] = k
    by: dict = {}
    t = 0.0
    for a, b in busy_intervals(rt.kernels) + [(rt.window_s, rt.window_s)]:
        if a > t:
            if a >= rt.window_s:
                label = WINDOW_END
            else:
                k = first[a]
                i = rt.kernel_span[k]
                label = (f"{rt.spans[i][0] if i is not None else NO_SPAN} | "
                         f"{rt.kernel_op[k] or NO_OP}")
            by[label] = by.get(label, 0.0) + (a - t)
        t = max(t, b)
    return sorted(by.items(), key=lambda kv: -kv[1])[:top]


def _summary(rt: SpanTrace, steps: int) -> dict:
    per = 1e3 / steps
    return {
        "kernel_ms": sum(d for _, _, d in rt.kernels) * per,
        "no_span_ms": sum(d for (_, _, d), i in zip(rt.kernels,
                                                    rt.kernel_span)
                          if i is None) * per,
        "phases_ms": phase_ms(rt, steps),
        "spans": {n: {"opened": sum(1 for sp in rt.spans if sp[0] == n),
                      "ms": span_seconds(rt, n) * per,
                      "self_ms": span_seconds(rt, n, self_only=True) * per}
                  for n in sorted({sp[0] for sp in rt.spans})},
    }


def _moe_totals() -> dict:
    """The program's MoE counter, or nothing where the program has none."""
    from repro_torch import trace_regions

    read = getattr(trace_regions, "moe_counts", None)
    return read() if read is not None else {}


def traced_run(workload: str, seed: int) -> tuple[int, dict | None]:
    """``(exit code, result line)`` of one traced run of the one-chip cell
    ``workload`` through ``harness.main`` in this process, with the span
    and counter metrics, the counter's totals a step and
    ``breakdown.idle_gaps_by_span`` added (module docstring)."""
    from . import harness
    from . import rank as rank_mod

    cell = mf.load_cell(workload)
    if cell.chips != 1:
        raise ValueError(f"{workload}: the ranks of a {cell.chips}-chip "
                         "cell count in their own processes")
    before = _moe_totals()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.main([
            "--workload", workload, "--seed", str(seed), "--seconds",
            str(mf.load_manifest()["run_seconds"]), "--trace", "1"])
    if rc != 0:
        return rc, None
    after = _moe_totals()
    line = json.loads(out.getvalue().splitlines()[-1])
    steps = line["attempted"]
    # where rank.run_rank writes rank 0's trace
    rt = read_spans(rank_mod.HERE / "out" / cell.name / "trace_rank0.json",
                    counters={k: after[k] - before[k] for k in after})
    run = TraceRun(steps=steps, chips=1, ranks=[rt], counts={}, peaks={})
    for name, unit in METRICS.items():
        value = mf.metric_reader(name)(run)
        if value is not None:
            line["metrics"][name] = {"value": value, "unit": unit}
    line["moe_counts_per_step"] = {k: v / steps
                                   for k, v in rt.counters.items()}
    line.update(_summary(rt, steps))
    line["breakdown"]["idle_gaps_by_span"] = [
        [n[:120], s] for n, s in idle_gaps_by_span(rt)]
    return 0, line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", type=Path, nargs="?")
    ap.add_argument("--steps", type=int, default=1,
                    help="steps in the trace's window (per-step ms)")
    ap.add_argument("--workload", help="run this one-chip cell, traced")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if (args.trace is None) == (args.workload is None):
        ap.error("give a trace file or --workload")
    if args.workload is not None:
        rc, line = traced_run(args.workload, args.seed)
        if line is not None:
            print(json.dumps(line), flush=True)
        return rc
    rt = read_spans(args.trace)
    print(json.dumps({
        "window_s": rt.window_s, "steps": args.steps,
        "kernels": len(rt.kernels),
        "busy_ms": sum(b - a for a, b in busy_intervals(rt.kernels))
        * 1e3 / args.steps,
        **_summary(rt, args.steps),
        "idle_gaps_by_span": [[n[:120], s] for n, s in
                              idle_gaps_by_span(rt)],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
