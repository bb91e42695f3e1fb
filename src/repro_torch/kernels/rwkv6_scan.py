"""The RWKV6 time-mix recurrence (CUDA, Hopper).

The port of ``repro/kernels/rwkv6_scan.py::rwkv6_scan_pallas``: per
(batch, head), with an hd x hd float32 state that starts at 0,

    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t),   S_t = diag(w_t) S_{t-1} + k_t^T v_t.

The kernel (``csrc/rwkv6_scan.cu``) reads the (B, S, H, hd) layout
directly, so the head flattening of ``repro/kernels/ops.py`` is not
materialised; the bonus u is one (H, hd) table shared by the batch (the
reference tiles it), or one row per flattened (batch, head).

Routing (:func:`._build.use_kernel`): a CUDA tensor launches the kernel, a
CPU tensor takes the plain version :func:`.ref.rwkv6_scan_ref`;
``impl="plain"`` routes a CUDA tensor to the plain version (checks only).
Nothing falls back.  Launches are counted in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ref

__all__ = ["rwkv6_scan", "rwkv6_scan_bshd", "HEAD_DIMS", "CHUNK", "LAUNCHES",
           "reset_launch_counts"]

#: head widths the kernel is compiled for (a thread holds a tile of the
#: state: 8 rows x 4 columns at hd 64)
HEAD_DIMS = (16, 32, 64)
#: time steps per staged chunk, fixed in the kernel (kChunk in
#: csrc/rwkv6_scan.cu): it keeps a ring of 3 input chunks and 2 chunks of
#: partial sums in shared memory, 112 KB at hd 64 in float32, so that two
#: blocks fit an SM
CHUNK = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches, counted where the kernel is launched
LAUNCHES: dict[str, int] = {"rwkv6_scan": 0}

_SOURCE = _build.source("rwkv6_scan")
_LIB: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    LAUNCHES["rwkv6_scan"] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load(_SOURCE)
        fn = lib.repro_rwkv6_scan
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_rwkv6_scan_smem.argtypes = [ctypes.c_int64] * 2
        lib.repro_rwkv6_scan_smem.restype = ctypes.c_int64
        _LIB = lib
    return _LIB


def rwkv6_scan_bshd(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor, *, impl: str = "auto",
) -> torch.Tensor:
    """r/k/v/w: (B, S, H, hd); u: (Bu, H, hd) float32 or bf16 (cast to
    float32, as the reference's kernel does) with Bu = 1 (shared by the
    batch) or B.  Returns (B, S, H, hd) float32."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(
            f"r/k/v/w must share one (B, S, H, hd) shape, got "
            f"{[tuple(t.shape) for t in (r, k, v, w)]}"
        )
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype for t in (k, v, w)):
        raise ValueError(
            f"r/k/v/w must share one type of {list(_DTYPES)}, got "
            f"{[t.dtype for t in (r, k, v, w)]}"
        )
    B, S, H, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head width {hd} not in {HEAD_DIMS}")
    if u.dtype not in _DTYPES or u.dim() != 3 \
            or u.shape[0] not in (1, B) or tuple(u.shape[1:]) != (H, hd):
        raise ValueError(
            f"u must be float32 or bf16 (1 or {B}, {H}, {hd}), got "
            f"{u.dtype} {tuple(u.shape)}"
        )
    u = u.to(torch.float32)
    if not _build.use_kernel(impl, r, k, v, w, u):
        flat = lambda t: t.transpose(1, 2).reshape(B * H, S, hd)
        uf = u.expand(B, H, hd).reshape(B * H, hd)
        of = ref.rwkv6_scan_ref(flat(r), flat(k), flat(v), flat(w), uf)
        return of.reshape(B, H, S, hd).transpose(1, 2)
    # the kernel stages its inputs with 16-byte copies
    r, k, v, w = (t.clone() if t.data_ptr() % 16 else t for t in (r, k, v, w))
    out = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    index, stream = _build.stream_args(r)
    rc = _lib().repro_rwkv6_scan(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), out.data_ptr(), B, S, H, hd,
        0 if u.shape[0] == 1 else H * hd, _DTYPES[r.dtype], index, stream,
    )
    _build.check(rc, "rwkv6_scan")
    LAUNCHES["rwkv6_scan"] += 1
    return out


def rwkv6_scan(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor, *, impl: str = "auto",
) -> torch.Tensor:
    """r/k/v/w: (BH, S, hd); u: (BH, hd) float32, as ``rwkv6_scan_pallas``
    takes them.  Returns (BH, S, hd) float32."""
    if r.dim() != 3 or u.dim() != 2:
        raise ValueError(
            f"r must be (BH, S, hd) and u (BH, hd), got {tuple(r.shape)} "
            f"{tuple(u.shape)}"
        )
    out = rwkv6_scan_bshd(
        r.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2), w.unsqueeze(2),
        u.unsqueeze(1), impl=impl,
    )
    return out.squeeze(2)
