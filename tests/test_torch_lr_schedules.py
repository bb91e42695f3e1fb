"""The learning-rate schedules (``optim.schedules.make_schedule``) against
the JAX package's, traced as its trainer traces them (``jit(vmap(sched))``
over int32 steps), at rel 1e-6.

The port computes in host numpy float32; the reference in XLA float32.
Both round the warm-up division, ``cos`` and ``0.5 ** t`` on their own, so
a few float32 ulps apart (up to about 8e-7 relative at the defaults) is the
expected difference, and a long ``cosine`` or ``wsd`` run is not bitwise
equal to the reference's.  Covered: each schedule at the default
``OptimizerConfig`` (100 warm-up steps, 10,000 decay steps) over steps 0 to
10,109, and the edge cases: no warm-up, no decay, long plateaus.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import OptimizerConfig as JOpt
from repro.optim.schedules import make_schedule as j_make_schedule
from repro_torch.configs import OptimizerConfig
from repro_torch.optim import make_schedule

STEPS = np.arange(0, 10_110)

CASES = {
    "default": {},
    "no_warmup": {"warmup_steps": 0},
    "no_decay": {"decay_steps": 0},
    "long_plateau": {"warmup_steps": 10, "stable_steps": 8_000,
                     "decay_steps": 1_000},
    "short": {"warmup_steps": 3, "decay_steps": 7, "stable_steps": 5,
              "lr": 1e-2},
}


def _lrs(fields: dict):
    port = make_schedule(OptimizerConfig(**fields))
    ref = j_make_schedule(JOpt(**fields))
    got = np.asarray([port(int(s)) for s in STEPS], dtype=np.float64)
    want = np.asarray(jax.jit(jax.vmap(ref))(jnp.asarray(STEPS, jnp.int32)),
                      dtype=np.float64)
    return got, want


@pytest.mark.parametrize("schedule", ["constant", "cosine", "wsd"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_matches_reference(schedule, case):
    fields = dict(CASES[case], schedule=schedule)
    got, want = _lrs(fields)
    assert np.all(np.isfinite(got)) and np.all(got >= 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_the_trainer_default_is_cosine_with_warmup():
    cfg = OptimizerConfig()
    assert (cfg.schedule, cfg.warmup_steps) == ("cosine", 100)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JOpt())
    sched = make_schedule(cfg)
    assert sched(0) == 0.0 and sched(100) == pytest.approx(cfg.lr, rel=1e-6)
    # the floor after the decay window: 0.1 of the peak
    assert sched(20_000) == pytest.approx(0.1 * cfg.lr, rel=1e-6)


def test_long_runs_differ_by_a_few_ulps():
    """The kept-on-purpose divergence: not bitwise, within a few ulps."""
    got, want = _lrs({"schedule": "cosine"})
    assert np.any(got != want)
    ulp = np.spacing(want.astype(np.float32)).astype(np.float64)
    assert np.max(np.abs(got - want) / np.where(want > 0, ulp, 1)) <= 8
