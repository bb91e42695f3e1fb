"""The Mamba (S6) selective scan (CUDA, Hopper).

The port of ``repro/kernels/mamba_scan.py::mamba_scan_pallas``: per batch
row and channel, with N float32 state values that start at 0,

    state_t = exp(dt_t A) * state_{t-1} + (dt_t x_t) B_t,   y_t = state_t . C_t.

The caller adds the D-skip and the gating.  The kernel is
``csrc/mamba_scan.cu``; x, dt, B and C may be float32 or bf16 (one type
for all four, read as such by the kernel: no cast pass), A is float32.
The kernel stages its inputs with 16-byte copies: the wrapper hands it
copies of views that do not start on 16 bytes, and of x and dt padded to
a row of a whole number of 16-byte pieces when d is not one (the output
is then sliced back to d columns).

Routing (:func:`._build.use_kernel`): a CUDA tensor launches the kernel, a
CPU tensor takes the plain version :func:`.ref.mamba_scan_ref`;
``impl="plain"`` routes a CUDA tensor to the plain version (checks only).
Nothing falls back.  Launches are counted in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ref

__all__ = ["mamba_scan", "STATE_SIZES", "CHANNELS", "CHUNK", "LAUNCHES",
           "reset_launch_counts"]

#: state sizes N the kernel is compiled for (up to 8 states a thread)
STATE_SIZES = (4, 8, 16)
#: channels per block and time steps per staged chunk, fixed in the kernel
#: (kChannels, kChunk in csrc/mamba_scan.cu)
CHANNELS = 32
CHUNK = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches, counted where the kernel is launched
LAUNCHES: dict[str, int] = {"mamba_scan": 0}

_SOURCE = _build.source("mamba_scan")
_LIB: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    LAUNCHES["mamba_scan"] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load(_SOURCE)
        fn = lib.repro_mamba_scan
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def mamba_scan(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, *, impl: str = "auto",
) -> torch.Tensor:
    """x/dt: (Bsz, S, d); A: (d, N) float32 or bf16 (cast to float32, as
    the reference's kernel does); B/C: (Bsz, S, N).  Returns y (Bsz, S, d)
    float32."""
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(
            f"x/dt must share one (Bsz, S, d) shape, got {tuple(x.shape)} "
            f"{tuple(dt.shape)}"
        )
    Bsz, S, d = x.shape
    if A.dim() != 2 or A.shape[0] != d or A.dtype not in _DTYPES:
        raise ValueError(
            f"A must be float32 or bf16 ({d}, N), got {A.dtype} "
            f"{tuple(A.shape)}"
        )
    A = A.to(torch.float32)
    N = A.shape[1]
    if N not in STATE_SIZES:
        raise ValueError(f"state size N = {N} not in {STATE_SIZES}")
    if B.shape != (Bsz, S, N) or C.shape != (Bsz, S, N):
        raise ValueError(
            f"B/C must be ({Bsz}, {S}, {N}), got {tuple(B.shape)} "
            f"{tuple(C.shape)}"
        )
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (dt, B, C)):
        raise ValueError(
            f"x/dt/B/C must share one type of {list(_DTYPES)}, got "
            f"{[t.dtype for t in (x, dt, B, C)]}"
        )
    if not _build.use_kernel(impl, x, dt, A, B, C):
        return ref.mamba_scan_ref(x, dt, A, B, C)
    # rows of x / dt (and y) of whole 16-byte pieces, from 16-byte bases
    ld = -(-d * x.element_size() // 16) * 16 // x.element_size()
    if ld != d:
        x, dt = (torch.nn.functional.pad(t, (0, ld - d)) for t in (x, dt))
    x, dt, B, C = (t.clone() if t.data_ptr() % 16 else t
                   for t in (x, dt, B, C))
    y = torch.empty((Bsz, S, ld), dtype=torch.float32, device=x.device)
    index, stream = _build.stream_args(x)
    rc = _lib().repro_mamba_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), Bsz, S, d, ld, N, _DTYPES[x.dtype],
        index, stream,
    )
    _build.check(rc, "mamba_scan")
    LAUNCHES["mamba_scan"] += 1
    return y if ld == d else y[..., :d].contiguous()
