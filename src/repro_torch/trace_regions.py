"""Kernel regions and spans: where a traced program charges its work.

:func:`kernel_region` marks a block of code for the op tracer of
:mod:`repro_torch.launch.trace_analysis` (the counterpart of the
reference's ``memory_bytes_kernel`` / ``timescan_*`` / ``attn_*``
accounting in ``repro/launch/hlo_analysis.py``).  This module holds only
the hook, so that kernels and models can mark their regions without
importing the launch package.

* ``kind="kernel"`` (a hand-written kernel's wrapper): the region's
  declared ``io_bytes`` and ``flops`` are charged in place of the ops
  inside it, and one launch event is recorded, so the kernel route (a
  ``ctypes`` call no dispatch mode sees) and the plain route (its
  step-by-step ops) count the same work;
* ``kind="attn"`` / ``kind="timescan"`` (the models' own attention score
  block and recurrences): the ops inside are counted as usual and also
  attributed to the region, forward and backward; ``io_bytes`` is what a
  fused kernel would still move (the reference's flash and scan-kernel
  targets), which feeds the roofline's ``memory_kernel_s``.

``io_bytes`` and ``flops`` may be numbers or zero-argument callables,
evaluated only while a tracer is active.  With no tracer active,
:func:`kernel_region` is one module-level check and returns a shared
no-op context.

A kernel region may also name its operands, for the SPMD lint
(:mod:`repro_torch.analysis.spmd_lint`), which follows data through it
as one node: ``region.inputs(x=..., scales=..., bits=...)`` names the
tensors it reads (and any plain attributes), ``region.output(...)`` the ones it returns, and ``donate=`` the
input the caller is done with (its buffer may be reused: it must not be
read after the region, nor returned by the traced call).  The op counter
of :mod:`repro_torch.launch.trace_analysis` ignores both.

**Spans** (:func:`span`) mark the program's layer boundaries for
``torch.profiler``: while a profiler records, ``span("forward")`` opens
``record_function("repro_torch.forward")``, so the span lands in the same
Chrome trace as the kernels, on the profiler's clock; while none records
it is one check and returns the shared no-op context (an idle
``record_function`` costs far more than the check).  There is no switch:
tracing is on exactly when a profiler records.  The spans, each read by
one per-layer metric of ``perfbench/``:

* ``repro_torch.forward`` / ``repro_torch.backward``: the DP step's (and
  the trainer's) ``model(batch)`` and ``torch.autograd.grad``;
* ``repro_torch.recompute`` (:func:`recompute_span`): a remat
  checkpoint's body when autograd's engine runs it, inside the backward
  (on a card, on the engine's own thread);
* ``repro_torch.grad_sync``: ``core.grad_sync.sync_with_context``;
* ``repro_torch.adamw``: ``optim.adamw_update``;
* ``repro_torch.moe.route`` / ``repro_torch.moe.experts``: the local MoE
  route, router to gather, and the experts' batched GLU inside it.

**The MoE counter** (:func:`count_moe_route`, read by :func:`moe_counts`,
zeroed by :func:`reset_moe_counts`), like ``kernels.transport.LAUNCHES``
a running total that a reader takes before and after a window: while a
profiler records, each local route outside a recompute adds the items it
was offered (``moe_routed``, tokens x top-k), the expert rows it computes
(``moe_slots``) and the items kept under the capacity (``moe_kept``).  The
route hands over its keep mask and launches nothing for the count: the
masks are summed when :func:`moe_counts` reads them (a synchronise, after
the window), or on the device once 64 are held.  Off, it touches no
tensor; on or off, nothing of the step's arithmetic changes.
"""

from __future__ import annotations

import torch

__all__ = ["kernel_region", "ACTIVE", "span", "recompute_span",
           "count_moe_route", "moe_counts", "reset_moe_counts", "PREFIX"]

#: every span's name starts with this
PREFIX = "repro_torch."

#: the active op tracers (innermost last); empty when nothing counts
ACTIVE: list = []


class _NoRegion:
    """The region when no tracer is active: does nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def inputs(self, **tensors) -> None:
        pass

    def output(self, *tensors) -> None:
        pass


_NO_REGION = _NoRegion()


def kernel_region(name: str, io_bytes=0, flops=0, *, kind: str = "kernel",
                  donate: str | None = None):
    """A context charging ``name``'s declared work to the active tracer
    (module docstring).  Inside an ``attn`` / ``timescan`` region, call
    ``region.output(*tensors)`` on its results so that their backward is
    attributed to it too.  ``donate`` names the input (of
    ``region.inputs``) whose buffer the caller gives up."""
    if not ACTIVE:
        return _NO_REGION
    return ACTIVE[-1].region(name, io_bytes, flops, kind, donate)


_profiling = torch._C._autograd._profiler_enabled


def _in_backward() -> bool:
    """Whether autograd's engine is running the caller (a checkpoint's
    recompute inside the backward); -1 is the id outside any graph task."""
    return torch._C._current_graph_task_id() != -1


def span(name: str):
    """``record_function(PREFIX + name)`` while a profiler records on this
    thread, the shared no-op context otherwise (module docstring)."""
    if not _profiling():
        return _NO_REGION
    return torch.autograd.profiler.record_function(PREFIX + name)


def recompute_span():
    """``span("recompute")`` where autograd's engine runs the caller, the
    no-op context elsewhere (a checkpoint's first forward)."""
    if _profiling() and _in_backward():
        return span("recompute")
    return _NO_REGION


_MOE = {"moe_routed": 0, "moe_slots": 0, "moe_kept": 0}
_KEEP: list = []      # keep masks counted since the last read, on the device
_KEEP_FOLD = 64


def count_moe_route(routed: int, slots: int, keep: torch.Tensor) -> None:
    """Count one local MoE route (module docstring): ``routed`` items
    offered, ``slots`` expert rows computed, ``keep`` the items' bool
    keep mask.  Counts only while a profiler records, and not in a
    recompute, so that each routed item counts once a step."""
    if not _profiling() or _in_backward():
        return
    _MOE["moe_routed"] += routed
    _MOE["moe_slots"] += slots
    _KEEP.append(keep)
    if len(_KEEP) >= _KEEP_FOLD:
        _KEEP[:] = [torch.stack([k.sum() for k in _KEEP]).sum()]


def moe_counts() -> dict:
    """``{"moe_routed", "moe_slots", "moe_kept"}``, the running totals
    since the last reset (the held masks summed: a synchronise)."""
    _MOE["moe_kept"] += sum(int(k.sum()) for k in _KEEP)
    _KEEP.clear()
    return dict(_MOE)


def reset_moe_counts() -> None:
    _MOE.update(moe_routed=0, moe_slots=0, moe_kept=0)
    _KEEP.clear()
