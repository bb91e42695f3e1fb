"""Kernel regions: where a traced program charges declared work.

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
"""

from __future__ import annotations

__all__ = ["kernel_region", "ACTIVE"]

#: the active op tracers (innermost last); empty when nothing counts
ACTIVE: list = []


class _NoRegion:
    """The region when no tracer is active: does nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def output(self, *tensors) -> None:
        pass


_NO_REGION = _NoRegion()


def kernel_region(name: str, io_bytes=0, flops=0, *, kind: str = "kernel"):
    """A context charging ``name``'s declared work to the active tracer
    (module docstring).  Inside an ``attn`` / ``timescan`` region, call
    ``region.output(*tensors)`` on its results so that their backward is
    attributed to it too."""
    if not ACTIVE:
        return _NO_REGION
    return ACTIVE[-1].region(name, io_bytes, flops, kind)
