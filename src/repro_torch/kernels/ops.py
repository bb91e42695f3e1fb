"""The public kernel API, with the signatures and layouts of
``repro/kernels/ops.py``.

``flash_attention`` takes q (B, S, H, hd) and k/v (B, Sk, KV, hd) with
H % KV == 0 and any Sk >= 1, and returns (B, S, H, hd) in q's type;
``rwkv6_scan`` takes r/k/v/w (B, S, H, hd) and u (H, hd); ``mamba_scan``
takes x/dt (Bsz, S, d), A (d, N), B/C (Bsz, S, N).  The scans return
float32; a bf16 u or A is cast to float32, as the reference's kernels do.

``impl``: ``"auto"`` launches the hand-written CUDA kernel for a CUDA
tensor and takes the plain version for a CPU tensor; ``"plain"`` routes a
CUDA tensor to the plain version (checks only).  The reference's TPU
tiling arguments (``block_q``, ``block_k``, ``chunk``, ``block_d``) have no
counterpart: the Hopper kernels choose their own tiles.  GQA and the head
layout are handled inside the kernels, so model code passes
(B, S, H, hd) tensors straight in.
"""

from __future__ import annotations

import torch

from ..trace_regions import kernel_region
from .flash_attention import LAUNCHES as _FLASH_LAUNCHES
from .flash_attention import flash_attention_bshd
from .flash_attention import reset_launch_counts as _reset_flash
from .mamba_scan import LAUNCHES as _MAMBA_LAUNCHES
from .mamba_scan import mamba_scan as _mamba_scan
from .mamba_scan import reset_launch_counts as _reset_mamba
from .rwkv6_scan import LAUNCHES as _RWKV_LAUNCHES
from .rwkv6_scan import reset_launch_counts as _reset_rwkv
from .rwkv6_scan import rwkv6_scan_bshd

__all__ = ["flash_attention", "rwkv6_scan", "mamba_scan", "launch_counts",
           "reset_launch_counts"]


def launch_counts() -> dict[str, int]:
    """Kernel launches of the three wrappers since their last reset."""
    return {**_FLASH_LAUNCHES, **_RWKV_LAUNCHES, **_MAMBA_LAUNCHES}


def reset_launch_counts() -> None:
    _reset_flash()
    _reset_rwkv()
    _reset_mamba()


def _bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# Each op is a kernel region of the op tracer (repro_torch.trace_regions):
# its inputs read and output written once, and the matrix products its
# plain version computes, on the kernel route and the plain route alike.

def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int | None = None,
    softcap: float | None = None, impl: str = "auto",
) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, Sk, KV, hd).  Returns (B, S, H, hd) in
    q's type (:func:`~repro_torch.kernels.flash_attention.
    flash_attention_bshd`)."""
    B, S, H, hd = q.shape
    with kernel_region("ops.flash_attention",
                       lambda: 2 * _bytes(q) + _bytes(k, v),
                       lambda: 4 * B * H * S * k.shape[1] * hd):
        return flash_attention_bshd(q, k, v, causal=causal, window=window,
                                    softcap=softcap, impl=impl)


def rwkv6_scan(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor, *, impl: str = "auto",
) -> torch.Tensor:
    """r/k/v/w: (B, S, H, hd); u: (H, hd) float32 or bf16.  Returns
    (B, S, H, hd) float32."""
    if u.dim() != 2:
        raise ValueError(f"u must be (H, hd), got {tuple(u.shape)}")
    B, S, H, hd = r.shape
    # per step and head: k^T v and r S, hd x hd products each
    with kernel_region("ops.rwkv6_scan",
                       lambda: _bytes(r, k, v, w, u) + r.numel() * 4,
                       lambda: 4 * B * S * H * hd * hd):
        return rwkv6_scan_bshd(r, k, v, w, u.unsqueeze(0), impl=impl)


def mamba_scan(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, *, impl: str = "auto",
) -> torch.Tensor:
    """x/dt: (Bsz, S, d); A: (d, N); B/C: (Bsz, S, N).  Returns y (Bsz, S,
    d) float32 (:func:`~repro_torch.kernels.mamba_scan.mamba_scan`)."""
    # per step: y = state C, a (d, N) x (N,) product
    with kernel_region("ops.mamba_scan",
                       lambda: _bytes(x, dt, A, B, C) + x.numel() * 4,
                       lambda: 2 * x.numel() * A.shape[1]):
        return _mamba_scan(x, dt, A, B, C, impl=impl)
