"""LR schedules: cosine, constant, and WSD (minicpm's warmup-stable-decay).

The port of ``repro/optim/schedules.py``: ``make_schedule(cfg)(step)``
gives the learning rate at an integer step, in float32 as the reference
computes it.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["make_schedule"]

_f = np.float32


def make_schedule(cfg):
    """cfg: OptimizerConfig -> (step: int) -> lr (float)."""
    warm, base = cfg.warmup_steps, cfg.lr

    def wfrac(step):
        return min(_f(step) / _f(max(warm, 1)), _f(1.0))

    if cfg.schedule == "constant":
        def sched(step):
            return float(_f(base) * wfrac(step))
        return sched

    if cfg.schedule == "cosine":
        decay = max(cfg.decay_steps, 1)

        def sched(step):
            t = np.clip(_f(step - warm) / _f(decay), _f(0.0), _f(1.0))
            cos = _f(0.5) * (_f(1.0) + np.cos(_f(math.pi) * t))
            return float(_f(base) * wfrac(step) * (_f(0.1) + _f(0.9) * cos))
        return sched

    if cfg.schedule == "wsd":
        stable = max(cfg.stable_steps, 1)
        decay = max(cfg.decay_steps, 1)

        def sched(step):
            in_decay = step > (warm + stable)
            t = np.clip(
                _f(step - warm - stable) / _f(decay), _f(0.0), _f(1.0)
            )
            tail = _f(0.5) ** (t * _f(10.0))
            return float(
                _f(base) * wfrac(step) * (tail if in_decay else _f(1.0))
            )
        return sched

    raise ValueError(f"unknown schedule {cfg.schedule!r}")
