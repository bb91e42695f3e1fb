"""The program's spans and counters in a traced window, read per layer.

``trace.read_trace`` reads each rank's spans (``repro_torch.<layer>``,
opened by ``repro_torch.trace_regions.span`` while a profiler records:
the DP step's forward and backward, a remat checkpoint's recompute inside
the backward, the gradient sync, AdamW, the MoE route and its experts)
and charges every kernel to one, across threads (its docstring).  This
module reads them for the per-layer metrics: the span readers
(``metrics/*_ms.py``, through :func:`span_ms`) take the device time of
the kernels charged to a span from a ``TraceRun``'s rank, and the counter
readers (``metrics/moe_*.py``, through :func:`moe_counter`) the program's
MoE counter from the rank's ``counters`` under the keys ``moe_routed``
(items offered, tokens x top-k), ``moe_slots`` (expert rows computed) and
``moe_kept`` (items kept under the capacity), each the growth over the
window of the counters the port publishes (``rank._counters``).  Each
finds nothing where the rank holds neither.

**Idle gaps by span.**  Each idle gap of the device inside the window is
charged to the span and the host operator that launched the kernel ending
the gap, whatever thread that was on (``trace.idle_gaps`` charges it to
the window thread's operator at the gap's middle); the result line's
``breakdown.idle_gaps_by_span``.

``python3 -m perfbench.spans <trace.json> [--steps N]`` prints a trace's
spans, the step's phases and the idle gaps by span as one JSON line (a
traced run writes ``perfbench/out/<cell>/trace_rank<r>.json``).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from .trace import RankTrace, TraceRun, busy_intervals, read_trace

__all__ = ["PHASES", "METRICS", "MOE_KEYS", "span_seconds", "span_ms",
           "moe_counter", "phase_ms", "idle_gaps_by_span"]

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
# the readers of the spans and the MoE counter, with their units
METRICS = {"forward_ms": "ms/step", "backward_ms": "ms/step",
           "recompute_ms": "ms/step", "sync_ms": "ms/step",
           "adamw_ms": "ms/step", "moe_dispatch_ms": "ms/step",
           "moe_slot_use": "%", "moe_drop_share": "%"}


def span_seconds(rt: RankTrace, name: str, *, self_only: bool = False,
                 leave_out=()) -> float | None:
    """Device seconds of the kernels charged to span ``name`` (with
    ``self_only``) or to it and every span under it, less those under any
    span of ``leave_out``; ``None`` where no span ``name`` was opened."""
    if not any(sp[0] == name for sp in rt.spans):
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


def phase_ms(rt: RankTrace, steps: int) -> dict:
    """The step's phases (``PHASES``), device ms a step; a phase whose
    span was never opened is left out."""
    out = {}
    for metric, name, leave_out in PHASES:
        s = span_seconds(rt, name, leave_out=leave_out)
        if s is not None:
            out[metric] = 1e3 * s / steps
    return out


def idle_gaps_by_span(rt: RankTrace, top: int = 10) -> list:
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


def _summary(rt: RankTrace, steps: int) -> dict:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", type=Path)
    ap.add_argument("--steps", type=int, default=1,
                    help="steps in the trace's window (per-step ms)")
    args = ap.parse_args(argv)
    rt = read_trace(args.trace)
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
