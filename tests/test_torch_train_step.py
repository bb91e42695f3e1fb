"""The slice end to end: the port's data-parallel train step against the
JAX package's ``make_dp_train_step`` on ``reduced(minicpm-2b)`` in float32,
with the reference's initial parameters carried over by
``params_from_jax``.

* forward loss and gradients at a 1x1 grid: rtol 1e-5 (XLA and torch add
  in other orders);
* 4 int4+EF steps at 1x1 (JAX in-process on a 1x1 mesh): losses and
  parameters at rtol 1e-4, atol 1e-5 — the tolerance of the reference's
  ``dp_train_nap_equals_psum`` check;
* 2 int4+EF steps at 2x2 (a 4-rank gloo world against the JAX step in a
  4-device subprocess): losses at rtol 1e-4, and the synced gradients of
  step 1 element by element within one quantization step of the leaf's
  hop-2 scale.  Reason: the f32 intra-node pre-combine and the fold sum in
  another order on the two sides, which can move a value across a rounding
  boundary.  Parameters after AdamW are not compared there: Adam's
  normalisation makes such a difference nonlinear.
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
import torch

from repro.configs.archs import MINICPM_2B as J_MINICPM
from repro.configs.archs import reduced as jreduced
from repro.configs.base import OptimizerConfig as JOpt
from repro.core import comm as jcomm
from repro.data import SyntheticLM as JData
from repro.launch.mesh import make_mesh
from repro.launch.steps import make_dp_train_step as j_make_step
from repro.models import build_model as j_build
from repro.optim import adamw_init as j_adamw_init
from repro.optim import ef_init as j_ef_init
from repro_torch import tree
from repro_torch.configs import MINICPM_2B, OptimizerConfig, reduced
from repro_torch.core import CommPolicy
from repro_torch.data import SyntheticLM
from repro_torch.launch import (
    init_train_state, make_dp_train_step, mesh_topology,
)
from repro_torch.models import build_model, params_from_jax, params_to_numpy

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_world as tw  # noqa: E402

SEQ, BATCH, SEED = 64, 8, 0


def _jax_setup():
    cfg = dataclasses.replace(jreduced(J_MINICPM), dtype="float32")
    model = j_build(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    return cfg, model, params


def _to_numpy_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_init():
    return _jax_setup()


def test_forward_and_grads_match(jax_init):
    jcfg, jmodel, jparams = jax_init
    cfg = reduced(MINICPM_2B)
    batch = JData(cfg.vocab_size, SEQ, BATCH, seed=SEED).batch(0)
    (jloss, _), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jparams, batch
    )
    model = build_model(
        cfg, params_from_jax(_to_numpy_tree(jparams), cfg, "cpu"),
        device="cpu",
    )
    tbatch = SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=SEED).batch(0, "cpu")
    loss, _ = model(tbatch)
    grads = torch.autograd.grad(loss, model.leaves())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        assert tuple(g.shape) == jg.shape
        np.testing.assert_allclose(
            g.numpy(), np.asarray(jg), rtol=1e-5,
            atol=1e-5 * float(np.abs(np.asarray(jg)).max()),
        )


def test_params_roundtrip(jax_init):
    _, _, jparams = jax_init
    cfg = reduced(MINICPM_2B)
    np_tree = _to_numpy_tree(jparams)
    back = params_to_numpy(params_from_jax(np_tree, cfg, "cpu"))
    for a, b in zip(tree.leaves(back), jax.tree.leaves(np_tree)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        params_from_jax({"embedding": np_tree["embedding"]}, cfg, "cpu")


def test_train_step_1x1_matches_jax(jax_init):
    jcfg, _, jparams = jax_init
    jopt = JOpt(lr=1e-3, schedule="constant", warmup_steps=1)
    jpol = jcomm.CommPolicy(algorithm="nap", mean=True, compress_bits=4,
                            error_feedback=True)
    mesh = make_mesh((1, 1), ("pod", "data"))
    jstep = jax.jit(j_make_step(jcfg, jopt, mesh, jpol))
    jdata = JData(jcfg.vocab_size, SEQ, BATCH, seed=SEED, mesh=mesh,
                  batch_axes=("pod", "data"))
    jstate = {"params": jparams, "opt": j_adamw_init(jparams),
              "ef": j_ef_init(jparams, group=1)}
    jlosses = []
    for s in range(4):
        jstate, m = jstep(jstate, jdata.batch(s))
        jlosses.append(float(m["loss"]))

    cfg = reduced(MINICPM_2B)
    opt = OptimizerConfig(lr=1e-3, schedule="constant", warmup_steps=1)
    pol = CommPolicy(algorithm="nap", mean=True, compress_bits=4,
                     error_feedback=True)
    step = make_dp_train_step(cfg, opt, mesh_topology(1, 1), pol,
                              device="cpu")
    state = init_train_state(
        cfg, opt, pol, device="cpu",
        params=params_from_jax(_to_numpy_tree(jparams), cfg, "cpu"),
    )
    data = SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=SEED)
    losses = []
    for s in range(4):
        state, m = step(state, data.batch(s, "cpu"))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-5)
    got = tree.leaves(params_to_numpy(state["model"]))
    for p, jp in zip(got, jax.tree.leaves(jstate["params"])):
        np.testing.assert_allclose(p, np.asarray(jp), rtol=1e-4, atol=1e-5)
    for e, je in zip(tree.leaves(state["ef"]), jax.tree.leaves(jstate["ef"])):
        np.testing.assert_allclose(
            e.numpy(), np.asarray(je)[0], rtol=1e-4,
            atol=1e-5 * max(1.0, float(np.abs(np.asarray(je)).max())),
        )


@pytest.fixture(scope="module")
def runs_2x2(tmp_path_factory, jax_init):
    """The JAX 4-device reference and the port's 4-rank world, run side
    by side from the same initial parameters."""
    out = tmp_path_factory.mktemp("train2x2")
    _, _, jparams = jax_init
    np.savez(out / "params0.npz", **{
        f"leaf{i}": np.asarray(p)
        for i, p in enumerate(jax.tree.leaves(jparams))
    })
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    jproc = subprocess.Popen(
        [sys.executable, str(tw.__file__), "jax_train", str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        ranks = tw.spawn_world("train", out)
        log = jproc.communicate(timeout=600)[0]
    finally:
        if jproc.poll() is None:
            jproc.kill()
            jproc.wait()
    assert jproc.returncode == 0, log[-3000:]
    with np.load(out / "jax.npz") as z:
        ref = {k: z[k] for k in z.files}
    for i, p in enumerate(jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(ref[f"init{i}"], np.asarray(p))
    return ranks, ref


def test_train_step_2x2_losses_match(runs_2x2):
    ranks, ref = runs_2x2
    for r in ranks:
        assert np.all(np.isfinite(r["losses"]))
        np.testing.assert_array_equal(r["losses"], ranks[0]["losses"])
        for k in r:
            if k.startswith("param"):
                np.testing.assert_array_equal(r[k], ranks[0][k])
    np.testing.assert_allclose(ranks[0]["losses"], ref["losses"], rtol=1e-4)


def test_train_step_2x2_synced_grads_match(runs_2x2):
    ranks, ref = runs_2x2
    qmax = 2 ** (4 - 1) - 1
    n_leaves = sum(1 for k in ref if k.startswith("grad"))
    assert n_leaves == 11
    for i in range(n_leaves):
        jg = ref[f"grad{i}"]  # (4, ...): every chip's synced copy
        for c in range(1, jg.shape[0]):
            np.testing.assert_array_equal(jg[c], jg[0])
        # one quantization step of the leaf's hop-2 scale: the largest
        # over its stripes is max|sum| / qmax, i.e. max|mean| / qmax in
        # the units of the averaged gradient
        step = np.abs(jg[0].astype(np.float64)).max() / qmax
        for r in ranks:
            got = r[f"grad{i}"]
            assert got.shape == jg[0].shape
            assert np.abs(got - jg[0]).max() <= step * (1 + 1e-5) + 1e-12, i
