"""Build, load and route the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, once per hash of the source and
the flags, under ``build/repro_torch/`` (ignored by git), and loaded with
``ctypes``.  :func:`build` starts one ``nvcc`` per missing library, all
at once.  Built without ``--use_fast_math``: the kernels' divisions,
``tanhf`` and ``expf`` stay IEEE-accurate.

The routing rule every wrapper shares (:func:`use_kernel`): a CPU tensor
takes the plain version, a CUDA tensor the kernel; ``impl="plain"`` routes
a CUDA tensor to the plain version (checks only).  Nothing falls back: a
build, argument or launch error raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["IMPLS", "NVCC_FLAGS", "build", "build_dir", "check", "load",
           "source", "stream_args", "use_kernel"]

IMPLS = ("auto", "plain")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_CSRC = Path(__file__).resolve().parent / "csrc"
_REPO_ROOT = Path(__file__).resolve().parents[3]
_DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")


def source(name: str) -> Path:
    """Path of the kernel source ``csrc/<name>.cu``."""
    return _CSRC / f"{name}.cu"


def build_dir() -> Path:
    return _REPO_ROOT / "build" / "repro_torch"


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or (
        str(_DEFAULT_NVCC) if _DEFAULT_NVCC.exists() else None
    )
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels are built from source at first use"
        )
    return found


def _target(src: Path) -> Path:
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()
    return build_dir() / f"lib{src.stem}-{digest[:16]}.so"


def build(*sources: Path) -> dict[Path, Path]:
    """Compile every source whose library is not built yet, one ``nvcc``
    each, all started together, and return ``{source: library}``.  The
    compiler's output (``-Xptxas -v``: registers, spills) is kept beside
    each library as ``.log``.  Raises if any compile fails."""
    libs = {src: _target(src) for src in sources}
    todo = {src: lib for src, lib in libs.items() if not lib.exists()}
    if not todo:
        return libs
    exe = nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    running = []
    for src, lib in todo.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [exe, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        running.append((src, lib, tmp, proc))
    failed = []
    for src, lib, tmp, proc in running:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(
                f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                f"{out}\n{err}"
            )
            continue
        lib.with_suffix(".log").write_text(out + err)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


_LOADED: dict[Path, ctypes.CDLL] = {}


def load(src: Path) -> ctypes.CDLL:
    """The loaded library of ``src``, built first if need be (one load per
    process)."""
    lib = _LOADED.get(src)
    if lib is None:
        lib = _LOADED[src] = ctypes.CDLL(str(build(src)[src]))
    return lib


def use_kernel(impl: str, *tensors: torch.Tensor) -> bool:
    """True for the CUDA kernel, False for the plain version.  Raises on
    an unknown ``impl``, tensors on different devices, a device with no
    kernel, or a non-contiguous CUDA tensor."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(
            f"tensors on several devices: {[str(t.device) for t in tensors]}"
        )
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if impl == "plain":
        return False
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernels take contiguous tensors")
    return True


def stream_args(t: torch.Tensor) -> tuple[int, int]:
    """(device index, current stream handle) for a launch on ``t``'s card."""
    dev = t.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(dev).cuda_stream


def check(rc: int, name: str) -> None:
    """Raise on a non-zero CUDA error code returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")
