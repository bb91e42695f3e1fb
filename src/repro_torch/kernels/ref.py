"""Plain PyTorch versions of the port's kernels (the correctness references).

Line-for-line ports of ``repro/kernels/ref.py``:

* ``quantize_pack_ref`` / ``unpack_dequantize_ref``: ``torch.round``
  rounds half to even like ``jnp.round``, and ``/`` on float32 is IEEE
  division on the CPU and on the card;
* ``flash_attention_ref``: plain masked softmax attention on (BH, S, hd);
* ``rwkv6_scan_ref`` / ``mamba_scan_ref``: the sequential recurrences, as
  Python loops over time (``lax.scan`` in the reference).

Each does its arithmetic in float32, as the JAX oracles do.  The CPU
tests hold these against the JAX package; on the card ``chip_smoke.py``
holds the CUDA kernels against them.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "flash_attention_ref",
    "rwkv6_scan_ref",
    "mamba_scan_ref",
    "quantize_pack_ref",
    "unpack_dequantize_ref",
]


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """q/k/v: (BH, S, hd) -> (BH, S, hd) in q's type, plain softmax
    attention; a row with no valid key gives 0."""
    hd = q.shape[-1]
    s = torch.einsum(
        "bqh,bkh->bqk", q.to(torch.float32), k.to(torch.float32)
    ) / math.sqrt(hd)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qi = torch.arange(q.shape[1], device=q.device)[:, None]
    ki = torch.arange(k.shape[1], device=q.device)[None, :]
    rel = qi - ki
    mask = torch.ones_like(rel, dtype=torch.bool)
    if causal:
        mask &= rel >= 0
    if window is not None:
        mask &= rel < window
    s = torch.where(mask[None], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)  # fully-masked rows -> 0
    return torch.einsum("bqk,bkh->bqh", p, v.to(torch.float32)).to(q.dtype)


def rwkv6_scan_ref(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor,
) -> torch.Tensor:
    """Sequential RWKV6 recurrence. r/k/v/w (BH, S, hd), u (BH, hd) ->
    (BH, S, hd) float32."""
    r, k, v, w = (t.to(torch.float32) for t in (r, k, v, w))
    u = u.to(torch.float32)
    BH, S, hd = r.shape
    state = torch.zeros((BH, hd, hd), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(S):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]  # (BH, hd)
        kv = kt[:, :, None] * vt[:, None, :]                  # (BH, hd, hd)
        outs.append(torch.einsum("bi,bij->bj", rt, state + u[:, :, None] * kv))
        state = wt[:, :, None] * state + kv
    return torch.stack(outs, dim=1)


def mamba_scan_ref(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor,
) -> torch.Tensor:
    """Sequential selective scan. x/dt (Bsz, S, d), A (d, N), B/C
    (Bsz, S, N) -> (Bsz, S, d) float32."""
    x, dt, A, B, C = (t.to(torch.float32) for t in (x, dt, A, B, C))
    Bsz, S, d = x.shape
    N = A.shape[1]
    state = torch.zeros((Bsz, d, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        xt, dtt, Bt, Ct = x[:, t], dt[:, t], B[:, t], C[:, t]
        dA = torch.exp(dtt[..., None] * A[None])
        state = state * dA + (dtt * xt)[..., None] * Bt[:, None, :]
        ys.append(torch.einsum("bdn,bn->bd", state, Ct))
    return torch.stack(ys, dim=1)


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
