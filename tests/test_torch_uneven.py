"""Layouts that do not divide, on a 4-rank gloo world (mode ``uneven`` of
``tests/_torch_world.py``), beside ``mesh=None`` and the reference.

* The microbatch split on a data axis wider than ``n_micro``: reduced
  minicpm-2b's ``make_train_step`` at n_micro 2 on a 4x1 mesh, whose view
  ``(n_micro, -1)`` split the 8 rows' 4-way shard unevenly.  Its losses
  and parameters equal ``mesh=None``'s, which equal the reference's step.
* Head views on a model axis the heads do not divide: a 3-head, 3-KV-head
  reduced minicpm on 2x2, with a vocabulary of 511 (the embedding's
  lookup on each rank's block of the table).  Loss, gradients and cached decode (train layout
  and ``serve2d``) equal ``mesh=None``'s; ``mesh=None``'s loss and
  gradients equal the reference's.
* The reference's side runs in a subprocess of 4 virtual devices
  (:func:`jax_side`): its jitted steps under the same ``NamedSharding``
  layouts (4x1 for the microbatches, 2x2 for the heads), from the same
  parameters.
* The trace lint over the traced int4 / int8 ``make_dp_train_step`` on the
  2x2 grid over the plain transport: clean wire dtypes, groups that
  partition the world, four transport launches per compressed bucket (six
  with error feedback: two more decodes), and a stable trace.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from _torch_world import (UNEVEN_BATCH, UNEVEN_LINT, UNEVEN_MICRO,
                          UNEVEN_SEED, UNEVEN_SEQ, UNEVEN_STEPS, shard_opt,
                          spawn_world, uneven_heads_cfg, uneven_params)
from repro.configs.archs import MINICPM_2B as J_MINICPM
from repro.configs.archs import reduced as j_reduced
from repro.configs.base import OptimizerConfig as JOpt
from repro.data import SyntheticLM as JData
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import build_model as j_build
from repro.optim import adamw_init as j_adamw_init
from repro_torch import tree
from repro_torch.configs import MINICPM_2B, reduced
from repro_torch.models import params_to_numpy

WORLD = 4
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_world("uneven", tmp_path_factory.mktemp("uneven"),
                       timeout=600)


def _j_cfg(cfg):
    return dataclasses.replace(j_reduced(J_MINICPM), dtype="float32",
                               num_heads=cfg.num_heads,
                               num_kv_heads=cfg.num_kv_heads,
                               vocab_size=cfg.vocab_size)


def jax_side(out_dir) -> None:
    """The reference's side under ``NamedSharding`` (run with 4 virtual
    devices, :func:`reference`): ``make_train_step`` at n_micro 2 on a 4x1
    ``("data", "model")`` mesh (losses, parameters), and the 3-head
    model's loss and gradients on 2x2."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.launch.mesh import make_mesh
    from repro.launch.steps import make_policy

    out = {}
    cfg = reduced(MINICPM_2B)
    mesh = make_mesh((4, 1), ("data", "model"))
    jcfg = _j_cfg(cfg)
    policy = make_policy(jcfg, mesh)
    model = j_build(jcfg, policy)
    params0 = _jax_params(cfg)
    shardings = jax.tree.map(lambda s: NamedSharding(mesh, s),
                             policy.param_specs(params0),
                             is_leaf=lambda s: isinstance(s, P))
    step = jax.jit(j_make_train_step(model, JOpt(**_opt_kw()),
                                     n_micro=UNEVEN_MICRO,
                                     grad_shardings=shardings))
    params = policy.shard_params(params0)
    state = {"params": params, "opt": j_adamw_init(params)}
    data = JData(jcfg.vocab_size, UNEVEN_SEQ, UNEVEN_BATCH, seed=UNEVEN_SEED,
                 mesh=mesh, batch_axes=("data",))
    losses = []
    for s in range(UNEVEN_STEPS):
        state, m = step(state, data.batch(s))
        losses.append(float(m["loss"]))
    out["f1_losses"] = np.asarray(losses)
    for i, p in enumerate(jax.tree.leaves(state["params"])):
        out[f"f1_param{i}"] = np.asarray(p)

    cfg3 = uneven_heads_cfg()
    mesh = make_mesh((2, 2), ("data", "model"))
    jcfg = _j_cfg(cfg3)
    policy = make_policy(jcfg, mesh)
    model = j_build(jcfg, policy)
    params = policy.shard_params(_jax_params(cfg3))
    batch = JData(jcfg.vocab_size, UNEVEN_SEQ, UNEVEN_BATCH, seed=UNEVEN_SEED,
                  mesh=mesh, batch_axes=("data",)).batch(0)
    (loss, _), grads = jax.jit(jax.value_and_grad(model.loss,
                                                  has_aux=True))(params,
                                                                 batch)
    out["f2_loss"] = np.asarray(loss)
    for i, g in enumerate(jax.tree.leaves(grads)):
        out[f"f2_grad{i}"] = np.asarray(g)
    np.savez(Path(out_dir) / "jax.npz", **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("uneven_jax")
    here = Path(__file__).resolve().parent
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(here.parent / "src"),
                                           str(here)]))
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import test_torch_uneven as t; t.jax_side({str(out)!r})"],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out / "jax.npz") as z:
        return {k: z[k] for k in z.files}


def _leaves(out: dict, prefix: str) -> list:
    n = sum(1 for k in out if k.startswith(prefix)
            and k[len(prefix):].isdigit())
    return [out[f"{prefix}{i}"] for i in range(n)]


def _jax_params(cfg):
    return jax.tree.map(np.asarray, params_to_numpy(uneven_params(cfg)))


def _opt_kw() -> dict:
    o = shard_opt()
    return dict(lr=o.lr, schedule=o.schedule, warmup_steps=o.warmup_steps)


def test_microbatches_on_4x1_equal_unmeshed(world):
    want = _leaves(world[0], "f1_param_none")
    assert len(want) > 0
    for r in range(WORLD):
        np.testing.assert_allclose(world[r]["f1_losses"],
                                   world[0]["f1_losses_none"], **TOL)
        got = _leaves(world[r], "f1_param")
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)


def test_microbatches_equal_reference_on_4x1(world, reference):
    np.testing.assert_allclose(world[0]["f1_losses"], reference["f1_losses"],
                               **TOL)
    want = _leaves(reference, "f1_param")
    got = _leaves(world[0], "f1_param")
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("mode", ["train", "serve2d"])
def test_uneven_heads_on_2x2_equal_unmeshed(world, mode):
    none = {k[len(f"f2_{mode}_none_"):]: v for k, v in world[0].items()
            if k.startswith(f"f2_{mode}_none_")}
    assert any(k.startswith("logits") for k in none)
    if mode == "train":
        assert "loss" in none and "grad0" in none
    for r in range(WORLD):
        for k, want in none.items():
            np.testing.assert_allclose(world[r][f"f2_{mode}_{k}"], want,
                                       err_msg=f"rank {r} {mode} {k}", **TOL)


def test_uneven_heads_equal_reference_on_2x2(world, reference):
    cfg = uneven_heads_cfg()
    np.testing.assert_allclose(world[0]["f2_train_loss"],
                               reference["f2_loss"], **TOL)
    got = _leaves(world[0], "f2_train_grad")
    want = _leaves(reference, "f2_grad")
    assert len(got) == len(want) == len(tree.leaves(uneven_params(cfg)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("bits,ef", UNEVEN_LINT)
def test_dp_step_trace_lint_clean(world, bits, ef):
    tag = f"lint_int{bits}{'_ef' if ef else ''}"
    wire = "int8" if bits >= 5 else "uint8"
    for r in range(WORLD):
        out = world[r]
        for rule in ("wire", "groups", "counts", "stable"):
            msgs = list(out[f"{tag}_{rule}"])
            assert msgs == [], f"rank {r} {rule}: {msgs}"
        buckets = int(out[f"{tag}_buckets"])
        assert buckets >= 1
        # 2 + 2 transport launches a bucket, and AdamW's two kernels
        assert int(out[f"{tag}_launches"]) == 4 * buckets + 2
        assert wire in set(out[f"{tag}_wire_dtypes"])
