"""The data-parallel train step of the port against the JAX package's
``make_dp_train_step`` on the reduced MoE, hybrid and RWKV families, in
float32 on the CPU, from the same (perturbed, ``tests/_torch_archs.py``)
parameters: two int4+EF steps at a 1x1 grid for deepseek-moe (the aux
loss), jamba (Mamba + MoE, 3-D expert leaves in the bucket planner) and
rwkv6 (the (H, hd) bonus).  Losses and parameters at rtol 1e-4, atol 1e-5
(the minicpm train test's tolerance), except an element that crossed an
int4 rounding boundary on one side only: its error-feedback residual
shows the flip (it differs by a quantization step), at most 0.1% of a
leaf, and there the parameter may differ by up to twice Adam's step per
step.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs.base import OptimizerConfig as JOpt
from repro.core import comm as jcomm
from repro.data import SyntheticLM as JData
from repro.launch.mesh import make_mesh
from repro.launch.steps import make_dp_train_step as j_make_step
from repro.optim import adamw_init as j_adamw_init
from repro.optim import ef_init as j_ef_init
from repro_torch import tree
from repro_torch.configs import OptimizerConfig
from repro_torch.core import CommPolicy
from repro_torch.data import SyntheticLM
from repro_torch.launch import (
    init_train_state, make_dp_train_step, mesh_topology,
)
from repro_torch.models import params_from_jax, params_to_numpy

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_archs import exact_group_norm, make_pair  # noqa: E402

TRAIN_SEQ, TRAIN_BATCH = 32, 4


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "jamba-1.5-large-398b",
                                  "rwkv6-1.6b"])
def test_train_step_1x1_matches_jax(name, monkeypatch):
    if name.startswith("rwkv6"):
        exact_group_norm(monkeypatch)
    p = make_pair(name)
    jopt = JOpt(lr=1e-3, schedule="constant", warmup_steps=1)
    jpol = jcomm.CommPolicy(algorithm="nap", mean=True, compress_bits=4,
                            error_feedback=True)
    mesh = make_mesh((1, 1), ("pod", "data"))
    jstep = jax.jit(j_make_step(p.jcfg, jopt, mesh, jpol))
    jdata = JData(p.jcfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0,
                  mesh=mesh, batch_axes=("pod", "data"))
    # on the step's own output sharding, so step 2 does not compile again
    jstate = jax.device_put(
        {"params": p.jparams, "opt": j_adamw_init(p.jparams),
         "ef": j_ef_init(p.jparams, group=1)}, NamedSharding(mesh, P()))
    jlosses = []
    for s in range(2):
        jstate, m = jstep(jstate, jdata.batch(s))
        jlosses.append(float(m["loss"]))

    opt = OptimizerConfig(lr=1e-3, schedule="constant", warmup_steps=1)
    pol = CommPolicy(algorithm="nap", mean=True, compress_bits=4,
                     error_feedback=True)
    step = make_dp_train_step(p.cfg, opt, mesh_topology(1, 1), pol,
                              device="cpu")
    state = init_train_state(p.cfg, opt, pol, device="cpu",
                             params=params_from_jax(p.np_params, p.cfg,
                                                    "cpu"))
    data = SyntheticLM(p.cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    losses = []
    for s in range(2):
        state, m = step(state, data.batch(s, "cpu"))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-5)
    got = tree.leaves(params_to_numpy(state["model"]))
    ef = [e.numpy() for e in tree.leaves(state["ef"])]
    for a, ja, e, je in zip(got, jax.tree.leaves(jstate["params"]), ef,
                            jax.tree.leaves(jstate["ef"])):
        ja, je = np.asarray(ja), np.asarray(je)[0]
        bad = ~np.isclose(a, ja, rtol=1e-4, atol=1e-5)
        flipped = ~np.isclose(e, je, rtol=1e-4, atol=1e-5 * max(
            1.0, float(np.abs(je).max())))
        # an element whose gradient lies on an int4 rounding boundary may
        # go over the wire one quantization step apart on the two sides:
        # its residual then differs by that step, and only there may the
        # parameter differ (by Adam's step at most)
        assert not (bad & ~flipped).any()
        assert flipped.sum() <= max(1, flipped.size // 1000)
        assert np.abs(a - ja).max() <= 2 * 2 * opt.lr
