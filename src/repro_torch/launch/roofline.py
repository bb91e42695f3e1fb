"""Roofline terms of a dry-run cell, for the H100.

The port of ``repro/launch/roofline.py``.  Three terms per (arch x shape x
mesh) cell, from one rank's op trace
(:mod:`repro_torch.launch.trace_analysis`):

  compute_s    = flops_per_chip / peak_flops
  memory_s     = bytes_per_chip / hbm_bw
  collective_s = collective_bytes_per_chip / link_bw

:data:`H100_SXM` holds the spec sheet's rates for the NVIDIA H100 SXM
(80 GB HBM3): 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of
HBM3, and NVLink 4 at 450 GB/s a direction (900 GB/s both ways); they are
``chip_smoke.py``'s ``CARDS["H100 80GB HBM3"]`` rates.  The reference's
single link term ``ici_bw`` is :attr:`HW.link_bw` here.  A cell whose
products run in float32 (``flops_by_dtype``) takes longer than the bf16
peak says.

Also reported: MODEL_FLOPS = 6 x N_active x tokens (train) or 2 x N_active
x tokens (inference), and the useful-compute ratio MODEL_FLOPS / flops,
which exposes remat recompute and dispatch overheads.  The bytes are the
eager program's (every op's operands), an upper bound on a fused
program's; ``memory_kernel_s`` is the memory term with the attention score
block and the recurrences replaced by their fused kernels' I/O.
"""

from __future__ import annotations

import dataclasses

from .trace_analysis import (COLLECTIVE_KINDS, TraceStats, iter_collectives,
                             wire_bytes)

__all__ = ["HW", "H100_SXM", "Roofline", "collective_bytes", "analyze",
           "model_flops"]


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12    # bf16 dense, per card
    hbm_bw: float = 3.35e12       # B/s
    link_bw: float = 450e9        # B/s a direction (NVLink 4)
    name: str = "h100_sxm"


H100_SXM = HW()


def collective_bytes(collectives) -> dict[str, dict[str, float]]:
    """Per-kind *wire* bytes (per chip) and counts of a trace's collective
    records (:class:`~repro_torch.launch.trace_analysis.CollectiveOp`, or
    a :class:`~repro_torch.launch.trace_analysis.Trace`), by the
    reference's ring-traffic model (:func:`wire_bytes`)."""
    if not isinstance(collectives, (list, tuple)):
        collectives = list(iter_collectives(collectives))
    out = {k: {"bytes": 0.0, "count": 0} for k in COLLECTIVE_KINDS}
    for c in collectives:
        out[c.kind]["bytes"] += wire_bytes(c.kind, c.bytes, c.group_size)
        out[c.kind]["count"] += 1
    return out


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    model_flops_per_chip: float
    useful_flops_ratio: float
    collectives: dict
    hw: str = "h100_sxm"
    # the memory term with fused attention / scan kernels: their I/O in
    # place of the eager ops' traffic.  Equals memory_s without either.
    memory_kernel_s: float = 0.0
    timescan_bytes_per_chip: float = 0.0

    def to_dict(self):
        return dataclasses.asdict(self)


def analyze(stats: TraceStats, n_chips: int, model_flops_total: float,
            hw: HW = H100_SXM) -> Roofline:
    """Roofline terms from one rank's trace stats."""
    flops, nbytes = stats.flops, stats.memory_bytes
    cbytes = stats.collective_bytes
    terms = {
        "compute": flops / hw.peak_flops,
        "memory": nbytes / hw.hbm_bw,
        "collective": cbytes / hw.link_bw,
    }
    model = model_flops_total / n_chips
    return Roofline(
        compute_s=terms["compute"],
        memory_s=terms["memory"],
        collective_s=terms["collective"],
        dominant=max(terms, key=terms.get),
        flops_per_chip=flops,
        bytes_per_chip=nbytes,
        collective_bytes_per_chip=cbytes,
        model_flops_per_chip=model,
        useful_flops_ratio=(model / flops) if flops else 0.0,
        collectives=stats.collectives,
        hw=hw.name,
        memory_kernel_s=stats.memory_bytes_kernel / hw.hbm_bw,
        timescan_bytes_per_chip=stats.timescan_memory_bytes,
    )


def model_flops(cfg, shape) -> float:
    """6*N_active*tokens for train, 2*N_active*tokens for inference."""
    n = cfg.active_param_count()
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * tokens
