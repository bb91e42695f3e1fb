"""The benchmark's own counts of the work a step needs, from shapes.

They count what the algorithm needs, not what an implementation does;
each input byte read once and each output byte written once.  A step's
FLOPs are the model file's (``models/<model>.py``: ``step_flops``); the
sync's bytes follow from the tree alone.
"""

from __future__ import annotations

from ..weights import n_elements

__all__ = ["of_cell", "transport_bytes"]


def of_cell(cell) -> dict:
    """The counts a per-layer reader takes (``trace.TraceRun.counts``):
    ``flops`` of one step over the traffic's global batch and, with a
    compressed sync, ``transport_bytes`` of one step."""
    out = {"flops": cell.model.step_flops(
        cell.config, cell.traffic["global_batch"], cell.traffic["seq_len"])}
    bits = cell.spec["sync"].get("compress_bits")
    if bits:
        out["transport_bytes"] = transport_bytes(cell.specs, bits)
    return out


def transport_bytes(specs: dict, bits: int) -> float:
    """Bytes a one-rank compressed sync of every leaf of ``specs`` moves
    through the two transport kernels: the float32 gradient read and the
    ``bits``-bit wire and one float32 scale a leaf written, then the wire
    and scales read and the float32 gradient written."""
    E = n_elements(specs)
    return 2.0 * (4 * E + E * bits / 8 + 4 * len(specs))
