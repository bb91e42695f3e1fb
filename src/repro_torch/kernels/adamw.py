"""AdamW's update and the sum of squares of its gradients (CUDA, Hopper).

The port's own kernels: the JAX package has none here (its
``optim/adamw.py`` is plain ``jnp``, which XLA fuses into one pass a
leaf).  Run eagerly, the plain version in
:mod:`repro_torch.optim.adamw` makes about twenty float32 passes over each
leaf on the card; ``csrc/adamw.cu`` (built with ``nvcc`` for ``sm_90a`` at
first use into ``build/repro_torch/`` and loaded with ``ctypes``, by
:mod:`._build`) does the same work in two kernels:

* :func:`sq_norm`: the sum of every gradient leaf's squared elements in
  float32, one pass over the gradients, deterministic (per-block partial
  sums, then one ordered sum; no float atomics);
* :func:`adamw_apply`: one pass a leaf, reading g, p, m and v and writing
  p, m and v, bit for bit the plain ``_update_leaves`` given the same clip
  scale (the arithmetic in ``csrc/adamw.cu``'s header).

Both take CUDA tensors only, contiguous and of float32 or bfloat16;
:func:`repro_torch.optim.adamw_update` routes (CUDA leaves here; CPU,
``meta`` and DTensor leaves to the plain version).
Nothing falls back: a build, argument or launch error raises.

Each wrapper counts its C calls in :data:`LAUNCHES` (one a call of
:func:`sq_norm`, one a leaf of :func:`adamw_apply`), so that a run can
show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["sq_norm", "adamw_apply", "LAUNCHES", "reset_launch_counts"]

#: C calls per wrapper, counted where the kernels are launched
LAUNCHES: dict[str, int] = {"sq_norm": 0, "adamw_apply": 0}

_SOURCE = _build.source("adamw")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load(_SOURCE)
        lib.repro_sq_norm_partials.argtypes = [ctypes.c_int64]
        lib.repro_sq_norm_partials.restype = ctypes.c_int64
        lib.repro_sq_norm.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_void_p] * 2
            + [ctypes.c_int64, ctypes.c_void_p])
        lib.repro_sq_norm.restype = ctypes.c_int
        lib.repro_adamw_apply.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4
            + [ctypes.c_void_p] * 4 + [ctypes.c_float] * 6
            + [ctypes.c_int64] * 2 + [ctypes.c_void_p])
        lib.repro_adamw_apply.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _code(t: torch.Tensor, what: str) -> int:
    code = _DTYPE_CODES.get(t.dtype)
    if code is None:
        raise ValueError(f"{what} must be float32 or bfloat16, got {t.dtype}")
    return code


def _check_on_card(tensors) -> None:
    """Raise unless ``tensors`` are contiguous and on one CUDA device."""
    if not _build.use_kernel("auto", *tensors):
        raise ValueError("the AdamW kernels take CUDA tensors, got "
                         f"{tensors[0].device}")


def _scalar_ptr(t: torch.Tensor, device, what: str) -> int:
    if t.dtype != torch.float32 or t.numel() != 1 or t.device != device:
        raise ValueError(f"{what} must be one float32 value on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.data_ptr()


def sq_norm(leaves) -> torch.Tensor:
    """The 0-dim float32 sum over ``leaves`` of their squared elements
    (``global_norm`` before its square root), in one C call; two calls on
    the same leaves give the same bits."""
    leaves = list(leaves)
    if not leaves:
        raise ValueError("sq_norm of no leaves")
    dev = leaves[0].device
    _check_on_card(leaves)
    L = len(leaves)
    codes = [_code(t, "a gradient") for t in leaves]
    lib = _lib()
    partials = torch.empty(lib.repro_sq_norm_partials(L),
                           dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    index, stream = _build.stream_args(leaves[0])
    rc = lib.repro_sq_norm(
        (ctypes.c_void_p * L)(*(t.data_ptr() for t in leaves)),
        (ctypes.c_int64 * L)(*(t.numel() for t in leaves)),
        (ctypes.c_int64 * L)(*codes), L, partials.data_ptr(),
        out.data_ptr(), index, stream)
    _build.check(rc, "repro_sq_norm")
    LAUNCHES["sq_norm"] += 1
    return out


def adamw_apply(flat_g, mu, nu, flat_p, *, scale, c1, c2, lr_t, b1, b2,
                eps, weight_decay) -> None:
    """One AdamW step on every leaf in place, one C call a leaf: the
    parameters ``flat_p``, the moments ``mu`` / ``nu`` from the gradients
    ``flat_g``.  ``scale`` (``None``: no clipping), ``c1``, ``c2`` and
    ``lr_t`` are float32 scalars on the card; ``b1``, ``b2``, ``eps`` and
    ``weight_decay`` python numbers, passed as the float32 values PyTorch
    casts them to (``1 - b1`` and ``1 - b2`` taken in double first, as the
    plain version takes them).  Leaves of two or more dimensions decay."""
    dev = flat_p[0].device
    lens = {len(flat_g), len(mu), len(nu), len(flat_p)}
    if len(lens) != 1:
        raise ValueError(f"leaf counts differ: {sorted(lens)}")
    scalars = [None if scale is None else _scalar_ptr(scale, dev, "scale"),
               _scalar_ptr(c1, dev, "c1"), _scalar_ptr(c2, dev, "c2"),
               _scalar_ptr(lr_t, dev, "lr_t")]
    hyper = [b1, b2, 1 - b1, 1 - b2, eps, weight_decay]
    lib = _lib()
    for g, m, v, p in zip(flat_g, mu, nu, flat_p):
        _check_on_card((g, m, v, p))
        if not g.shape == m.shape == v.shape == p.shape:
            raise ValueError(
                f"shapes differ: g {tuple(g.shape)}, m {tuple(m.shape)}, "
                f"v {tuple(v.shape)}, p {tuple(p.shape)}")
        if m.dtype != v.dtype:
            raise ValueError(f"moments of two dtypes: {m.dtype}, {v.dtype}")
        if p.numel() == 0:
            continue
        index, stream = _build.stream_args(p)
        rc = lib.repro_adamw_apply(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            p.numel(), _code(p, "a parameter"), _code(g, "a gradient"),
            _code(m, "a moment"), *scalars, *hyper, int(p.dim() >= 2),
            index, stream)
        _build.check(rc, "repro_adamw_apply")
        LAUNCHES["adamw_apply"] += 1
