"""Error-feedback residual state for compressed gradient transport.

The port of ``repro/optim/error_feedback.py``.  Each rank keeps a float32
residual per gradient leaf, adds it to its local gradient before the
quantised sync (``c = g + r``) and stores back its share of what the wire
could not represent (measured by
:func:`repro_torch.core.grad_sync._compressed_fused_allreduce`).  The
residual is per-rank state: never averaged, never replicated.
"""

from __future__ import annotations

from typing import Any

import torch

from .. import tree as tree_util

__all__ = ["ef_init", "ef_residual"]


def ef_init(params: Any, *, group: int | None = None) -> Any:
    """Zero residual tree matching ``params`` (float32 leaves).

    With ``group=G`` every leaf gains a leading ``G`` axis: the global form
    of the reference's train state (one slice per rank).  A rank of the
    port holds its own slice only, so its train step takes ``group=None``.
    """

    def zeros(p):
        shape = tuple(p.shape)
        if group is not None:
            shape = (int(group),) + shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return tree_util.tree_map(zeros, params)


def ef_residual(c: torch.Tensor, scale, qmax: float) -> torch.Tensor:
    """``c - Q(c)``: what a round-to-nearest clip quantizer at ``scale``
    drops from ``c`` (the analytic single-scale residual, in float32,
    with no integer casts)."""
    c = c.to(torch.float32)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=c.device)
    q = torch.clamp(torch.round(c / scale), -float(qmax), float(qmax))
    return c - q * scale
