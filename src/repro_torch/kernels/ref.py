"""Plain PyTorch versions of the transport kernels (the correctness references).

Line-for-line ports of ``repro/kernels/ref.py::quantize_pack_ref`` and
``unpack_dequantize_ref``: ``torch.round`` rounds half to even like
``jnp.round``, and ``/`` on float32 is IEEE division on the CPU and on the
card.  The CPU tests hold these against the JAX package; on the card
``chip_smoke.py`` holds the CUDA kernels against them.
"""

from __future__ import annotations

import torch

__all__ = ["quantize_pack_ref", "unpack_dequantize_ref"]


def _transport_scale(rows, cols, scales, offsets, base, row_stride, device):
    """(R, C) per-element scale grid from the global flat-bucket index
    ``base + i*row_stride + c`` and the per-leaf start offsets."""
    scales = scales.to(device=device, dtype=torch.float32).reshape(-1)
    scale = scales[0].expand(rows, cols)
    if len(offsets) > 1:
        idx = (
            int(base)
            + torch.arange(rows, dtype=torch.int64, device=device)[:, None]
            * int(row_stride)
            + torch.arange(cols, dtype=torch.int64, device=device)[None, :]
        )
        for l in range(1, len(offsets)):
            scale = torch.where(idx >= int(offsets[l]), scales[l], scale)
    return scale


def quantize_pack_ref(
    x: torch.Tensor,
    scales: torch.Tensor,
    *,
    offsets,
    bits: int,
    base: int = 0,
    row_stride: int = 0,
    block: int = 256,
) -> torch.Tensor:
    """Plain quantize-and-pack of an already column-padded (R, C) input
    (C a multiple of ``block``).  Split-half int4 layout: the low nibble
    of wire byte k of a block is element k, the high nibble k + block/2."""
    R, C = x.shape
    scale = _transport_scale(
        R, C, scales, offsets, base, row_stride, x.device
    )
    qmax = float(2 ** (bits - 1) - 1)
    q = torch.clamp(
        torch.round(x.to(torch.float32) / scale), -qmax, qmax
    ).to(torch.int32)
    if bits != 4:
        return q.to(torch.int8)
    half = block // 2
    t = q.reshape(R, C // block, block)
    lo, hi = t[:, :, :half], t[:, :, half:]
    packed = (lo & 0xF) | ((hi & 0xF) << 4)
    return packed.reshape(R, C // 2).to(torch.uint8)


def unpack_dequantize_ref(
    wire: torch.Tensor,
    scales: torch.Tensor,
    *,
    offsets,
    bits: int,
    base: int = 0,
    row_stride: int = 0,
    block: int = 256,
) -> torch.Tensor:
    """Plain inverse: wire (R, Cw) -> (R, C) f32 ``q * scale`` at the
    padded width (the public wrapper slices to the caller's ``cols``)."""
    R, Cw = wire.shape
    if bits == 4:
        half = block // 2
        b = wire.reshape(R, Cw // half, half).to(torch.int32)
        lo = b & 0xF
        hi = (b >> 4) & 0xF
        lo = torch.where(lo > 7, lo - 16, lo)
        hi = torch.where(hi > 7, hi - 16, hi)
        q = torch.cat([lo, hi], dim=2).reshape(R, Cw * 2)
    else:
        q = wire.to(torch.int32)
    C = q.shape[1]
    scale = _transport_scale(
        R, C, scales, offsets, base, row_stride, wire.device
    )
    return q.to(torch.float32) * scale
