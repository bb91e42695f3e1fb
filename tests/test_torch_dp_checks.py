"""The reference's two DP-training acceptance checks held against the
port's ``make_dp_train_step``, exactly as ``tests/_multidevice_checks.py``
sets them (``check_dp_training_ef_convergence``, lines 902-976, and
``check_dp_training_nap_equals_psum``, 979-1020), which cannot run for the
reference itself on jax 0.9.0 (ROADMAP, Queue 3 caveat):

* a 4x4 grid: one gloo world of 16 ranks (``tests/_torch_world.py`` mode
  ``dp_checks``) on ``reduced(minicpm-2b)`` in float32 from the
  reference's ``model.init(PRNGKey(0))``, ``SyntheticLM(seq 32, global
  batch 16, seed 3)``;
* convergence: 120 steps each of uncompressed, int4 + EF and raw int4
  ``nap`` sync, AdamW at constant lr 1e-2, and the reference's five
  criteria: finite, learned (tail < first loss - 0.5), ``gap_ef < 0.15 x
  tail(base)``, ``gap_raw > gap_ef``, ``dev_raw > 1.4 x dev_ef``;
* ``nap`` equal to ``psum``: 4 steps at lr 1e-3, rtol 1e-4, atol 1e-5,
  finite;
* the same convergence check at 1x1 (one process, the whole batch) from
  the port's seeded parameters (``torch.Generator`` seed 0 on the CPU),
  which is what ``chip_smoke.py`` phase ``dp_ef`` runs on the card with
  the CUDA transport kernels: the five criteria hold here, so the card
  phase holds them too.
"""

from __future__ import annotations

import sys
from pathlib import Path

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.archs import MINICPM_2B as J_MINICPM
from repro.configs.archs import reduced as jreduced
from repro.models import build_model as j_build
from repro_torch.configs import MINICPM_2B, OptimizerConfig, reduced
from repro_torch.core import CommPolicy
from repro_torch.data import SyntheticLM
from repro_torch.launch import mesh_topology
from repro_torch.models import init_params

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_world as tw  # noqa: E402

WORLD = 16


@pytest.fixture(scope="module")
def world_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_checks")
    cfg = dataclasses.replace(jreduced(J_MINICPM), dtype="float32")
    params = jax.jit(j_build(cfg).init)(jax.random.PRNGKey(0))
    np.savez(out / "params0.npz", **{
        f"leaf{i}": np.asarray(p)
        for i, p in enumerate(jax.tree.leaves(params))
    })
    return tw.spawn_world("dp_checks", out, timeout=900.0, world=WORLD)


def test_every_rank_sees_the_same_losses(world_runs):
    for r in world_runs:
        for name in ("base", "ef4", "raw4", "psum", "nap"):
            np.testing.assert_array_equal(r[name], world_runs[0][name])
    assert len(world_runs[0]["base"]) == tw.DP_EF_STEPS


def test_dp_training_ef_convergence_4x4(world_runs):
    r = world_runs[0]
    res = tw.ef_criteria(r["base"], r["ef4"], r["raw4"])
    assert all(res["criteria"].values()), res


def test_dp_training_nap_equals_psum_4x4(world_runs):
    r = world_runs[0]
    assert np.all(np.isfinite(r["nap"]))
    np.testing.assert_allclose(r["psum"], r["nap"], rtol=1e-4, atol=1e-5)


def test_dp_training_ef_convergence_1x1():
    cfg = reduced(MINICPM_2B)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    data = SyntheticLM(cfg.vocab_size, tw.DP_SEQ, tw.DP_BATCH,
                       seed=tw.DP_SEED)
    opt = OptimizerConfig(lr=1e-2, schedule="constant", warmup_steps=1)
    topo = mesh_topology(1, 1)
    runs = {name: tw.dp_losses(cfg, params, topo, CommPolicy(**kw), opt,
                               data, tw.DP_EF_STEPS)
            for name, kw in tw.DP_EF_RUNS}
    res = tw.ef_criteria(runs["base"], runs["ef4"], runs["raw4"])
    assert all(res["criteria"].values()), res
