"""Blockwise online-softmax attention (CUDA, Hopper).

The port of ``repro/kernels/flash_attention.py::flash_attention_pallas``
(and of the GQA head expansion in ``repro/kernels/ops.py``): causal
masking, a sliding window (``0 <= q - k < window`` with causal,
``q - k < window`` without), the tanh soft-cap ``c * tanh(s / c)`` applied
before the mask, and scale ``1/sqrt(hd)``.  Keys may be more or fewer than
the queries (Sk != S); the masks are start-aligned (``q - k`` counts from
the first query and the first key, as in the reference), and a query row
with no valid key gives 0, as the plain version and the reference's jnp
oracle give.  The kernel
(``csrc/flash_attention.cu``) reads the (B, S, H, hd) layout directly and
maps query head h to KV head ``h // (H // KV)``, so neither the head
flattening nor the GQA repeat is materialised.  Both types run on the
tensor cores (wgmma fed by TMA).  bf16: P is rounded to bf16 before P·V.
float32: every product in 3xTF32 (x_hi·y_hi + x_hi·y_lo + x_lo·y_hi, with
tf32 hi and lo parts), which keeps the reference's float32 contract where
one TF32 product would break it.  wgmma takes tf32 operands only K-major,
so a pre-pass kernel, launched by the same call, first writes the hi and
lo parts of K and of V transposed (V^T, keys contiguous) into scratch
that the call allocates.

Routing (:func:`._build.use_kernel`): a CUDA tensor launches the kernel, a
CPU tensor takes the plain version :func:`.ref.flash_attention_ref`;
``impl="plain"`` routes a CUDA tensor to the plain version (checks only).
Nothing falls back: a build or launch failure raises.  Launches are counted
in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build, ref

__all__ = ["flash_attention", "flash_attention_bshd", "HEAD_DIMS",
           "KEY_PAD", "LAUNCHES", "reset_launch_counts"]

#: head widths the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 128)
#: float32: the split V^T's key axis is padded to a multiple of this
#: (kKeyPad in csrc/flash_attention.cu)
KEY_PAD = 64
_DTYPES = (torch.float32, torch.bfloat16)

#: kernel launches, counted where the kernel is launched
LAUNCHES: dict[str, int] = {"flash_attention": 0}

_SOURCE = _build.source("flash_attention")
_LIB: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    LAUNCHES["flash_attention"] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load(_SOURCE)
        ptrs, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
        fn = lib.repro_flash_attention
        fn.argtypes = [ptrs] * 4 + [i64] * 8 + [f32] * 2 + [i64, ptrs]
        fn.restype = ctypes.c_int
        fn = lib.repro_flash_attention_tf32x3_split
        fn.argtypes = [ptrs] * 4 + [i64] * 6 + [ptrs]
        fn.restype = ctypes.c_int
        fn = lib.repro_flash_attention_tf32x3
        fn.argtypes = [ptrs] * 4 + [i64] * 9 + [f32] * 2 + [i64, ptrs]
        fn.restype = ctypes.c_int
        smem = lib.repro_flash_attention_smem
        smem.argtypes = [ctypes.c_int64, ctypes.c_int64]
        smem.restype = ctypes.c_int64
        _LIB = lib
    return _LIB


def _check(q, k, v, window, softcap) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"q/k/v must be (B, S, H, hd) / (B, Sk, KV, hd), got "
            f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}"
        )
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"q/k/v must share one type of {list(_DTYPES)}, got "
            f"{q.dtype} {k.dtype} {v.dtype}"
        )
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] < 1 \
            or k.shape[3] != hd:
        raise ValueError(
            f"k/v {tuple(k.shape)} {tuple(v.shape)} do not fit q "
            f"{tuple(q.shape)}"
        )
    KV = k.shape[2]
    if KV < 1 or H % KV:
        raise ValueError(f"H = {H} is not a multiple of KV = {KV}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head width {hd} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")


def _plain(q, k, v, causal, window, softcap) -> torch.Tensor:
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    flat = lambda t: t.transpose(1, 2).reshape(B * H, t.shape[1], hd)
    of = ref.flash_attention_ref(
        flat(q), flat(k), flat(v), causal=causal, window=window,
        softcap=softcap,
    )
    return of.reshape(B, H, S, hd).transpose(1, 2)


def flash_attention_bshd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    impl: str = "auto",
) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, Sk, KV, hd) with H % KV == 0 and any
    Sk >= 1.  Returns (B, S, H, hd) in q's type.  The layout of
    ``repro.kernels.ops``."""
    _check(q, k, v, window, softcap)
    if not _build.use_kernel(impl, q, k, v):
        return _plain(q, k, v, causal, window, softcap)
    B, S, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    # the kernels' tensor maps want 16-byte aligned bases
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    out = torch.empty_like(q)
    index, stream = _build.stream_args(q)
    mask = (int(bool(causal)), 0 if window is None else int(window),
            1.0 / math.sqrt(hd), 0.0 if softcap is None else float(softcap))
    lib = _lib()
    if q.dtype == torch.bfloat16:
        rc = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, Sk, H, KV, hd, *mask, index, stream,
        )
    else:
        # 3xTF32: K's tf32 hi / lo planes, and V^T's with Sk padded
        Sp = -(-Sk // KEY_PAD) * KEY_PAD
        ks = torch.empty((2, B, Sk, KV, hd), dtype=q.dtype, device=q.device)
        vts = torch.empty((2, B, KV, hd, Sp), dtype=q.dtype, device=q.device)
        rc = lib.repro_flash_attention_tf32x3_split(
            k.data_ptr(), v.data_ptr(), ks.data_ptr(), vts.data_ptr(),
            B, Sk, KV, hd, Sp, index, stream,
        )
        _build.check(rc, "flash_attention (tf32x3 split)")
        rc = lib.repro_flash_attention_tf32x3(
            q.data_ptr(), ks.data_ptr(), vts.data_ptr(), out.data_ptr(),
            B, S, Sk, H, KV, hd, Sp, *mask, index, stream,
        )
    _build.check(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    impl: str = "auto",
) -> torch.Tensor:
    """q: (BH, S, hd), k, v: (BH, Sk, hd) with heads flattened (GQA
    expanded), as ``flash_attention_pallas`` takes them.  Returns
    (BH, S, hd) in q's type."""
    if q.dim() != 3:
        raise ValueError(f"q must be (BH, S, hd), got {tuple(q.shape)}")
    out = flash_attention_bshd(
        q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2), causal=causal,
        window=window, softcap=softcap, impl=impl,
    )
    return out.squeeze(2)
