"""Device selection for the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "require_on"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is asked for (or defaulted to) and is
    absent — an entry point never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def require_on(model, device=None) -> torch.device:
    """:func:`resolve_device` of ``device``, checked against the device the
    model's parameters are on (``cuda`` and ``cuda:<current>`` are one)."""
    dev = resolve_device(device)
    have = model.device
    same = have.type == dev.type
    if same and dev.type == "cuda" and have.index != dev.index:
        cur = torch.cuda.current_device()
        same = (have.index if have.index is not None else cur) == (
            dev.index if dev.index is not None else cur)
    if not same:
        raise ValueError(f"the model is on {have}, not on {dev}")
    return dev
