"""Fused quantize-pack / unpack-dequantize transport kernels (CUDA, Hopper).

The port of ``repro/kernels/transport.py``.  The compressed gradient sync
quantizes every transport hop in one pass: each element of an (R, C) f32
block sits at the global flat-bucket index ``base + i*row_stride + c``,
takes its leaf's scale from the leaf start ``offsets`` and is rounded and
clipped to the wire width:

* ``bits == 4``: two int4 nibbles per ``uint8`` byte, split-half per
  256-element block (wire byte ``k`` of a block holds element ``k`` in its
  low nibble and element ``k + 128`` in its high nibble);
* every other width in 2..8: one ``int8`` byte per element.

:func:`unpack_dequantize` is the exact inverse on receive.

Routing: a CUDA tensor launches the hand-written kernel in
``csrc/transport.cu`` (built with ``nvcc`` for ``sm_90a`` at first use into
``build/repro_torch/`` and loaded with ``ctypes``, by :mod:`._build`); a CPU tensor takes the
plain version in :mod:`repro_torch.kernels.ref`.  ``impl="plain"`` routes a
CUDA tensor to the plain version explicitly (checks only).  Nothing falls
back: a build or launch failure raises.

Each wrapper counts its kernel launches in :data:`LAUNCHES`, so a run can
show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch
import torch.nn.functional as F

from ..trace_regions import kernel_region
from . import _build, ref

__all__ = [
    "quantize_pack",
    "unpack_dequantize",
    "wire_dtype",
    "wire_itemsize",
    "DEFAULT_BLOCK",
    "LAUNCHES",
    "reset_launch_counts",
    "build_library",
]

DEFAULT_BLOCK = 256

#: kernel launches per wrapper, counted where the kernel is launched
LAUNCHES: dict[str, int] = {"quantize_pack": 0, "unpack_dequantize": 0}

_SOURCE = _build.source("transport")


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def wire_dtype(bits: int) -> torch.dtype:
    """Dtype of the on-wire tensor: packed ``uint8`` for int4, ``int8``
    for every other supported width (2..8)."""
    return torch.uint8 if bits == 4 else torch.int8


def wire_itemsize(bits: int) -> float:
    """Bytes per *element* on the wire (0.5 for packed int4, 1 else)."""
    return 0.5 if bits == 4 else 1.0


# ---------------------------------------------------------------------------
# build and binding
# ---------------------------------------------------------------------------


def build_library() -> Path:
    """Compile ``csrc/transport.cu`` into a shared library (once per
    source hash) and return its path.  Raises on a compiler error."""
    return _build.build(_SOURCE)[_SOURCE]


_LIB: ctypes.CDLL | None = None
_OFFSETS_ON_DEVICE: dict[tuple, torch.Tensor] = {}


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load(_SOURCE)
        args = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 7 + [ctypes.c_void_p]
        for fn in (lib.repro_quantize_pack, lib.repro_unpack_dequantize):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.repro_transport_block.argtypes = []
        lib.repro_transport_block.restype = ctypes.c_int
        if lib.repro_transport_block() != DEFAULT_BLOCK:
            raise RuntimeError("transport library built for another block")
        _LIB = lib
    return _LIB


def _device_offsets(offsets: tuple[int, ...], device) -> torch.Tensor:
    key = (offsets, str(device))
    t = _OFFSETS_ON_DEVICE.get(key)
    if t is None:
        t = torch.tensor(offsets, dtype=torch.int64, device=device)
        _OFFSETS_ON_DEVICE[key] = t
    return t


def _launch(fn_name, src, out, scales, offsets, rows, cols, base, row_stride,
            bits):
    index, stream = _build.stream_args(src)
    rc = getattr(_lib(), fn_name)(
        src.data_ptr(), out.data_ptr(),
        _device_offsets(offsets, src.device).data_ptr(), scales.data_ptr(),
        len(offsets), rows, cols, int(base), int(row_stride), int(bits),
        index, stream,
    )
    _build.check(rc, fn_name)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_args(bits: int, block: int, scales: torch.Tensor, offsets) -> None:
    if not (2 <= bits <= 8):
        raise ValueError(f"transport bits must be in 2..8, got {bits}")
    if block % 2 or block < 2:
        raise ValueError(f"block must be even and >= 2, got {block}")
    if scales.dtype != torch.float32 or scales.dim() != 1:
        raise ValueError(
            f"scales must be a 1-D float32 tensor, got {scales.dtype} "
            f"{tuple(scales.shape)}"
        )
    if len(offsets) != scales.shape[0]:
        raise ValueError(
            f"{scales.shape[0]} scales but {len(offsets)} leaf offsets"
        )
    if list(offsets) != sorted(offsets) or offsets[0] != 0:
        raise ValueError(f"offsets must be sorted and start at 0: {offsets}")


def _use_kernel(t: torch.Tensor, scales: torch.Tensor, impl: str,
                block: int) -> bool:
    """True for the CUDA kernel, False for the plain version; raises on a
    tensor the kernel does not take."""
    if not _build.use_kernel(impl, t, scales):
        return False
    if block != DEFAULT_BLOCK:
        raise ValueError(
            f"the CUDA kernels are built for block={DEFAULT_BLOCK}, "
            f"got {block}"
        )
    return True


def quantize_pack(
    x: torch.Tensor,
    scales: torch.Tensor,
    *,
    offsets,
    bits: int,
    base: int = 0,
    row_stride: int = 0,
    block: int = DEFAULT_BLOCK,
    impl: str = "auto",
    donate_input: bool = False,
) -> torch.Tensor:
    """Quantize-and-pack ``x`` (R, C) f32 into wire bytes in one pass.

    Returns (R, ceil(C/block)*block * wire_itemsize(bits)) wire bytes: the
    columns are zero-padded up to a ``block`` multiple here, and the pad
    quantizes to 0.  ``scales`` is the (L,) per-leaf scale vector,
    ``offsets`` the leaf start indices, ``base``/``row_stride`` the
    global-index plumbing (module docstring).

    ``donate_input=True`` declares that the caller is done with ``x``.  It
    is a declaration only, carried on the kernel region: the SPMD lint's
    alias-donation rule proves that ``x`` is neither read after the call
    nor returned (:mod:`repro_torch.analysis.spmd_lint`).  It changes no
    value and no launch.  Do not set it where the caller still needs
    ``x`` (the error-feedback path reads its stripe again).
    """
    # a kernel region of the op tracer: x read and the wire written once,
    # on the kernel route and the plain route alike
    with kernel_region("transport.quantize_pack", lambda: x.shape[0] * (
            4 * x.shape[1]
            + -(-x.shape[1] // block) * block * wire_itemsize(bits)),
            donate="x" if donate_input else None) as region:
        region.inputs(x=x, scales=scales, bits=bits)
        offsets = tuple(int(o) for o in offsets)
        scales = scales.reshape(-1)
        _check_args(bits, block, scales, offsets)
        if x.dim() != 2 or x.dtype != torch.float32:
            raise ValueError(
                f"x must be a 2-D float32 tensor, got {x.dtype} "
                f"{tuple(x.shape)}")
        pad = (-x.shape[1]) % block
        xp = F.pad(x, (0, pad)) if pad else x
        R, Cp = xp.shape
        if not _use_kernel(xp, scales, impl, block):
            out = ref.quantize_pack_ref(
                xp, scales, offsets=offsets, bits=bits, base=base,
                row_stride=row_stride, block=block,
            )
        else:
            if xp.data_ptr() % 16:
                xp = xp.clone()  # the kernel loads x as float4s
            out_cols = Cp // 2 if bits == 4 else Cp
            out = torch.empty((R, out_cols), dtype=wire_dtype(bits),
                              device=xp.device)
            _launch("repro_quantize_pack", xp, out, scales, offsets, R, Cp,
                    base, row_stride, bits)
            LAUNCHES["quantize_pack"] += 1
        region.output(out)
        return out


def unpack_dequantize(
    wire: torch.Tensor,
    scales: torch.Tensor,
    *,
    offsets,
    bits: int,
    cols: int,
    base: int = 0,
    row_stride: int = 0,
    block: int = DEFAULT_BLOCK,
    impl: str = "auto",
    donate_input: bool = False,
) -> torch.Tensor:
    """Inverse of :func:`quantize_pack`: wire bytes (R, Cw) back to
    (R, cols) f32 values ``q * scale``, the block padding sliced off.

    ``base``/``row_stride``/``scales``/``offsets`` describe the global
    indices of the *received* rows: all-to-all-received copies of one
    block use ``row_stride=0``.  ``donate_input=True`` declares the wire
    buffer dead after the call (see :func:`quantize_pack`).
    """
    # a kernel region of the op tracer: the wire read and the values
    # written once, on the kernel route and the plain route alike
    with kernel_region("transport.unpack_dequantize",
                       lambda: wire.numel() + 4 * wire.shape[0] * cols,
                       donate="wire" if donate_input else None) as region:
        region.inputs(wire=wire, scales=scales, bits=bits)
        offsets = tuple(int(o) for o in offsets)
        scales = scales.reshape(-1)
        _check_args(bits, block, scales, offsets)
        if wire.dim() != 2 or wire.dtype != wire_dtype(bits):
            raise ValueError(
                f"wire must be a 2-D {wire_dtype(bits)} tensor at "
                f"bits={bits}, got {wire.dtype} {tuple(wire.shape)}"
            )
        R, Cw = wire.shape
        wblock = block // 2 if bits == 4 else block
        if Cw % wblock:
            raise ValueError(
                f"wire width {Cw} is not a multiple of the {wblock}-byte "
                f"wire block (bits={bits}, block={block})"
            )
        if not _use_kernel(wire, scales, impl, block):
            out = ref.unpack_dequantize_ref(
                wire, scales, offsets=offsets, bits=bits, base=base,
                row_stride=row_stride, block=block,
            )[:, :cols]
        else:
            if wire.data_ptr() % 16:
                wire = wire.clone()  # the kernel loads 16 wire bytes a time
            out = torch.empty((R, (Cw // wblock) * block),
                              dtype=torch.float32, device=wire.device)
            _launch("repro_unpack_dequantize", wire, out, scales, offsets,
                    R, Cw, base, row_stride, bits)
            LAUNCHES["unpack_dequantize"] += 1
            out = out[:, :cols]
        region.output(out)
        return out
