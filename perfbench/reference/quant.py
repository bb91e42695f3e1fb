"""The sync's quantize round trip, a frozen copy of the plain arithmetic.

At one rank the compressed sync keeps the wire's round trip: each leaf
of ``c = g + r`` (the gradient plus this rank's error-feedback residual)
is quantized at its own scale ``max(absmax(c) / qmax, 1e-30)``, ``qmax =
2**(bits-1) - 1``, rounded half to even and clipped, and dequantized;
the new residual is what the round trip lost.
"""

from __future__ import annotations

import torch

__all__ = ["round_trip"]


def round_trip(c: torch.Tensor, bits: int) -> torch.Tensor:
    """``Q(c)``: ``c`` (float32) through the ``bits``-bit wire at its own
    per-leaf scale."""
    qmax = float(2 ** (bits - 1) - 1)
    amax = c.abs().amax()
    scale = torch.clamp_min(amax / torch.full((), qmax, device=c.device),
                            1e-30)
    q = torch.clamp(torch.round(c / scale), -qmax, qmax)
    return q * scale
