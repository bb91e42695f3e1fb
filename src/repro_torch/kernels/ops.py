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

from .flash_attention import LAUNCHES as _FLASH_LAUNCHES
from .flash_attention import flash_attention_bshd as flash_attention
from .flash_attention import reset_launch_counts as _reset_flash
from .mamba_scan import LAUNCHES as _MAMBA_LAUNCHES
from .mamba_scan import mamba_scan
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


def rwkv6_scan(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor, *, impl: str = "auto",
) -> torch.Tensor:
    """r/k/v/w: (B, S, H, hd); u: (H, hd) float32 or bf16.  Returns
    (B, S, H, hd) float32."""
    if u.dim() != 2:
        raise ValueError(f"u must be (H, hd), got {tuple(u.shape)}")
    return rwkv6_scan_bshd(r, k, v, w, u.unsqueeze(0), impl=impl)
