"""Shared layer primitives: RMS norm, dense projections, GLU MLP, RoPE and
qwen2-vl's M-RoPE.

The port of ``repro/models/layers.py``.  A
projection keeps its input dtype (bf16 in, bf16 out, f32 accumulation in
cuBLAS); :func:`head_dot` gives float32 logits from float32 products of
the (possibly bf16) inputs, as the reference's
``preferred_element_type=float32`` does.

Under :class:`mixed_bwd` (the config's ``bf16_bwd`` lever) :func:`dense`
and :func:`head_dot` route operands of one dtype through autograd
functions whose backward casts the incoming cotangent to the weight's
dtype first, so the two backward products run in bf16 with float32
accumulation, ``dx`` rounded to the input's dtype and ``dw`` to the
weight's (the reference's ``_mdot`` / ``_mdot_f32out``).  The forward
values are the same with the lever on or off.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = [
    "softcap",
    "rms_norm",
    "layer_norm",
    "mixed_bwd",
    "init_dense",
    "dense",
    "head_dot",
    "glu_mlp",
    "init_glu_mlp",
    "rope_angles",
    "apply_rope",
]


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """Logit soft-capping: ``cap * tanh(x / cap)`` (identity without a cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32 over the last dim (the population variance),
    back to ``x``'s dtype (exported; no model calls it, as in the
    reference)."""
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    out = out * scale.to(torch.float32) + bias.to(torch.float32)
    return out.to(dtype)


def init_dense(shape, dtype, *, generator, device, scale: float | None = None):
    """Normal init scaled by ``1/sqrt(d_in)`` (``shape[-2]``); any leading
    dims are stacked layers."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


# Whether projections take the bf16 backward; set while a forward pass
# runs (the autograd function is chosen then), as the reference's flag is
# read while it traces.
_MIXED_BWD: list[bool] = [False]


class mixed_bwd:
    """Context manager: projections in its scope take the bf16 backward."""

    def __init__(self, enabled: bool):
        self.enabled = bool(enabled)

    def __enter__(self):
        self.prev = _MIXED_BWD[0]
        _MIXED_BWD[0] = self.enabled
        return self

    def __exit__(self, *exc):
        _MIXED_BWD[0] = self.prev
        return False


def mixed_bwd_enabled() -> bool:
    return _MIXED_BWD[0]


def _mdot_backward(x, w, g):
    """``(dx, dw)`` of ``x @ w`` from the cotangent ``g``, cast to the
    weight's dtype: products with float32 accumulation, ``dx`` rounded to
    ``x``'s dtype and ``dw`` to ``w``'s."""
    g16 = g.to(w.dtype)
    dx = torch.matmul(g16, w.transpose(-1, -2)).to(x.dtype)
    dw = torch.matmul(x.reshape(-1, x.shape[-1]).transpose(0, 1),
                      g16.reshape(-1, g16.shape[-1])).to(w.dtype)
    return dx, dw


class _MDot(torch.autograd.Function):
    """``x @ w`` in ``x``'s dtype, with the bf16 backward."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        return _mdot_backward(*ctx.saved_tensors, g)


class _MDotF32Out(torch.autograd.Function):
    """``x @ w`` with a float32 output (the head), with the bf16 backward.
    The operands are upcast (exact) and multiplied in float32."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.matmul(x.to(torch.float32), w.to(torch.float32))

    @staticmethod
    def backward(ctx, g):
        return _mdot_backward(*ctx.saved_tensors, g)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None):
    if _MIXED_BWD[0] and x.dtype == w.dtype:
        y = _MDot.apply(x, w)
    else:
        y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y


def head_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Projection with float32 output (logits)."""
    if _MIXED_BWD[0] and x.dtype == w.dtype:
        return _MDotF32Out.apply(x, w)
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


# gelu is the tanh form: the reference's ``jax.nn.gelu`` defaults to
# ``approximate=True``
_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def init_glu_mlp(d_model: int, d_ff: int, dtype, *, lead=(), generator,
                 device):
    mk = lambda shape: init_dense(lead + shape, dtype, generator=generator,
                                  device=device)
    return {
        "w_gate": mk((d_model, d_ff)),
        "w_up": mk((d_model, d_ff)),
        "w_down": mk((d_ff, d_model)),
    }


def glu_mlp(params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    h = _ACTS[act](dense(x, params["w_gate"])) * dense(x, params["w_up"])
    return dense(h, params["w_down"])


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for positions (..., S) -> (..., S, head_dim/2)."""
    half = head_dim // 2
    freq = 1.0 / (
        theta ** (torch.arange(0, half, dtype=torch.float32,
                               device=positions.device) / half)
    )
    ang = positions.to(torch.float32)[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: tuple[int, int, int] | None = None):
    """Rotate q/k: x (B, S, H, hd); positions (B, S), or (3, B, S) with
    M-RoPE.

    M-RoPE (qwen2-vl): the head_dim/2 frequency slots are split into
    (temporal, height, width) sections, each rotated by its own position
    stream; text-only (B, S) positions serve all three streams."""
    hd = x.shape[-1]
    half = hd // 2
    if mrope_sections is not None:
        if positions.dim() == 2:
            positions = positions.expand((3,) + tuple(positions.shape))
        cos_parts, sin_parts = [], []
        start = 0
        for sec, pos in zip(mrope_sections, positions):
            freq = 1.0 / (theta ** (torch.arange(
                start, start + sec, dtype=torch.float32,
                device=positions.device) / half))
            ang = pos.to(torch.float32)[..., None] * freq
            cos_parts.append(torch.cos(ang))
            sin_parts.append(torch.sin(ang))
            start += sec
        cos = torch.cat(cos_parts, dim=-1)
        sin = torch.cat(sin_parts, dim=-1)
    else:
        cos, sin = rope_angles(positions, hd, theta)
    cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
