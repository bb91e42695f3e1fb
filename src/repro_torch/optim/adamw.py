"""AdamW with global-norm clipping and a configurable moment dtype.

The port of ``repro/optim/adamw.py``.  Parameters and moments are updated
in place (the reference returns new arrays; the port keeps one copy of
each to save device memory).  Every scalar the update divides by is a
0-dim tensor on the parameters' device, so the division is IEEE on the
card as on the CPU.

Leaves may be DTensors (a model on a mesh): the moments take each
parameter's placements, the update runs on each rank's shards, and
:func:`global_norm` is the norm of the full tensors.

Routing (:func:`adamw_update`), by what the leaves are: plain CUDA leaves
take the two kernels of :mod:`repro_torch.kernels.adamw`, the norm's sum
of squares and one pass a leaf, bit for bit the plain update below given
the same norm (the norm's sum is taken in another order, so it may differ
in its last bits); CPU and ``meta`` leaves and DTensor leaves (their norm
needs ``full_tensor()``) take the plain version, :func:`global_norm` and
``_update_leaves``.  For the op tracer both routes of plain leaves are two
kernel regions that declare the kernels' bytes, so that a step counts
alike on the card and on ``meta``.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from .. import tree as tree_util
from ..kernels import _build
from ..kernels import adamw as adamw_kernels
from ..models.sharding import is_dtensor, replicated_scope
from ..trace_regions import kernel_region, span

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class AdamWState(NamedTuple):
    step: int
    mu: list
    nu: list


def adamw_init(params, *, moment_dtype: str = "float32") -> AdamWState:
    """Zero moments, one per parameter leaf (tree order)."""
    md = _DTYPES[moment_dtype]
    leaves = tree_util.leaves(params)
    zeros = lambda p: torch.zeros_like(  # noqa: E731
        p.detach(), dtype=md, memory_format=torch.contiguous_format)
    return AdamWState(
        step=0,
        mu=[zeros(p) for p in leaves],
        nu=[zeros(p) for p in leaves],
    )


def _full(s: torch.Tensor) -> torch.Tensor:
    """A DTensor scalar as the plain tensor of its full value."""
    return s.full_tensor() if is_dtensor(s) else s


def global_norm(grads) -> torch.Tensor:
    sq = [
        _full(torch.sum(torch.square(g.to(torch.float32))))
        for g in tree_util.leaves(grads)
    ]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _mesh_scope(leaves):
    """Plain scalars count as replicated beside DTensor leaves."""
    if leaves and is_dtensor(leaves[0]):
        return replicated_scope()
    return contextlib.nullcontext()


@torch.no_grad()
def adamw_update(
    grads,
    state: AdamWState,
    params,
    *,
    lr,
    betas=(0.9, 0.95),
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float | None = 1.0,
):
    """Update ``params`` and the moments in place; returns
    ``(new_state, metrics)``."""
    with span("adamw"):
        b1, b2 = betas
        flat_p = tree_util.leaves(params)
        flat_g = tree_util.leaves(grads)
        fused = _use_kernels(flat_g, state, flat_p)
        plain_leaves = not is_dtensor(flat_p[0])
        with _region("adamw.sq_norm", plain_leaves,
                     lambda: sum(_nbytes(g) for g in flat_g), flat_g):
            gnorm = (torch.sqrt(adamw_kernels.sq_norm(flat_g)) if fused
                     else global_norm(flat_g))
        dev = gnorm.device
        f32 = lambda v: torch.full((), v, dtype=torch.float32, device=dev)
        scale = None
        if grad_clip is not None:
            scale = torch.minimum(
                f32(1.0), f32(grad_clip) / torch.maximum(gnorm, f32(1e-12))
            )
        step = state.step + 1
        c1 = 1.0 - torch.pow(f32(b1), f32(step))
        c2 = 1.0 - torch.pow(f32(b2), f32(step))
        lr_t = f32(float(lr))
        # g read, p, m and v read and written, once each
        apply_bytes = lambda: sum(  # noqa: E731
            _nbytes(g) + 2 * (_nbytes(p) + _nbytes(m) + _nbytes(v))
            for g, m, v, p in zip(flat_g, state.mu, state.nu, flat_p))
        state_leaves = [*flat_p, *state.mu, *state.nu]
        with _region("adamw.apply", plain_leaves, apply_bytes,
                     [*flat_g, *state_leaves, scale, c1, c2, lr_t],
                     state_leaves):
            if fused:
                adamw_kernels.adamw_apply(
                    flat_g, state.mu, state.nu, flat_p, scale=scale, c1=c1,
                    c2=c2, lr_t=lr_t, b1=b1, b2=b2, eps=eps,
                    weight_decay=weight_decay)
            else:
                # one leaf at a time, in place where the arithmetic allows:
                # the temporaries are a few copies of one leaf, never of the
                # whole tree (gemma2-27b's 256,000 x 4,608 embedding is 4.7
                # GB in float32)
                with _mesh_scope(flat_p):
                    _update_leaves(flat_g, state, flat_p, scale=scale, b1=b1,
                                   b2=b2, c1=c1, c2=c2, lr_t=lr_t, eps=eps,
                                   weight_decay=weight_decay)
        return AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm}


def _use_kernels(flat_g, state: AdamWState, flat_p) -> bool:
    """True where the CUDA kernels take the update (module docstring);
    raises on leaves on several devices or non-contiguous CUDA leaves."""
    if is_dtensor(flat_p[0]) or flat_p[0].device.type == "meta":
        return False
    return _build.use_kernel("auto", *flat_g, *state.mu, *state.nu, *flat_p)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@contextlib.contextmanager
def _region(name: str, plain_leaves: bool, io_bytes, inputs, outputs=()):
    """The op tracer's kernel region of ``name`` over plain leaves, with
    its operands named for the SPMD lint (``outputs``: the tensors it
    writes in place); none over DTensor leaves, whose plain ops run as
    they are counted."""
    if not plain_leaves:
        yield
        return
    with kernel_region(name, io_bytes) as region:
        region.inputs(**{f"x{i}": t for i, t in enumerate(inputs)
                         if t is not None})
        region.output(*outputs)
        yield


def _update_leaves(flat_g, state, flat_p, *, scale, b1, b2, c1, c2, lr_t,
                   eps, weight_decay):
    for g, m, v, p in zip(flat_g, state.mu, state.nu, flat_p):
        if scale is not None:
            g = g * scale.to(g.dtype)
        g32 = g.to(torch.float32)
        del g
        m32 = m if m.dtype == torch.float32 else m.to(torch.float32)
        v32 = v if v.dtype == torch.float32 else v.to(torch.float32)
        m32.mul_(b1).add_(g32 * (1 - b1))
        v32.mul_(b2).add_(torch.square(g32).mul_(1 - b2))
        del g32
        update = m32 / c1
        update.div_(torch.sqrt_(v32 / c2).add_(eps))
        p32 = p.to(torch.float32)
        if p.dim() >= 2:
            update.add_(weight_decay * p32)
        p.copy_(p32.sub_(update.mul_(lr_t)))
        if m32 is not m:
            m.copy_(m32)
            v.copy_(v32)
