"""The single-device training driver of the port against the JAX package,
on ``reduced(minicpm-2b)`` in float32 with the reference's initial
parameters carried over by ``params_from_jax``:

* ``make_train_step`` at ``n_micro`` 1 and 4, 2 steps: losses at rtol
  1e-4, parameters at rtol 1e-4, atol 1e-5 (the tolerance of
  ``test_torch_train_step.py``: XLA and torch add in other orders);
* ``n_micro`` 4 equal to the mean of the per-microbatch gradients written
  out by hand (each its own masked mean), at 1e-6, and not the gradients
  of one masked mean over the whole batch;
* ``microbatch_split`` equal to the reference's over every arch x
  ``SHAPES`` x grids, and the ``SHAPES`` / ``TrainConfig`` fields;
* ``build_training``: a run stopped at step 4 after a checkpoint at step
  2, resumed by a fresh loop to step 6, equal bitwise to a straight run;
  ``main --reduced --device cpu --steps 3``;
* ``Prefetcher`` order and ``close``.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs.archs import MINICPM_2B as J_MINICPM
from repro.configs.archs import reduced as jreduced
from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import OptimizerConfig as JOpt
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import SyntheticLM as JData
from repro.launch.steps import make_train_step as j_make_train_step
from repro.launch.steps import microbatch_split as j_microbatch_split
from repro.models import build_model as j_build
from repro.optim import adamw_init as j_adamw_init
from repro_torch import tree
from repro_torch.configs import (
    ARCHS, MINICPM_2B, SHAPES, OptimizerConfig, TrainConfig, reduced,
)
from repro_torch.data import Prefetcher, SyntheticLM
from repro_torch.launch import (
    build_training, init_train_state, make_mesh, make_train_step,
    microbatch_split,
)
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, params_from_jax, params_to_numpy
from repro_torch.optim import adamw_init

SEQ, BATCH, SEED = 32, 8, 0
OPT = dict(lr=1e-3, schedule="constant", warmup_steps=1)
GRIDS = (
    None,
    ((8,), ("data",)),
    ((4, 4), ("pod", "data")),
    ((16, 16), ("data", "model")),
    ((2, 4, 4), ("pod", "data", "model")),
    ((2, 16, 16), ("pod", "data", "model")),
)


@pytest.fixture(scope="module")
def jax_init():
    cfg = dataclasses.replace(jreduced(J_MINICPM), dtype="float32")
    model = j_build(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    return cfg, model, params


def _port_model(jparams):
    cfg = reduced(MINICPM_2B)
    np_tree = jax.tree.map(np.asarray, jparams)
    return cfg, build_model(cfg, params_from_jax(np_tree, cfg, "cpu"),
                            device="cpu")


@pytest.mark.parametrize("n_micro", [1, 4])
def test_train_step_matches_jax(jax_init, n_micro):
    jcfg, jmodel, jparams = jax_init
    jstep = jax.jit(j_make_train_step(jmodel, JOpt(**OPT), n_micro=n_micro))
    jdata = JData(jcfg.vocab_size, SEQ, BATCH, seed=SEED)
    jstate = {"params": jparams, "opt": j_adamw_init(jparams)}
    jlosses, jlrs = [], []
    for s in range(2):
        jstate, m = jstep(jstate, jdata.batch(s))
        jlosses.append(float(m["loss"]))
        jlrs.append(float(m["lr"]))

    cfg, model = _port_model(jparams)
    opt_cfg = OptimizerConfig(**OPT)
    step = make_train_step(model, opt_cfg, n_micro=n_micro, device="cpu")
    state = {"model": model, "opt": adamw_init(model.params())}
    data = SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=SEED)
    losses, lrs = [], []
    for s in range(2):
        state, m = step(state, data.batch(s, "cpu"))
        losses.append(float(m["loss"]))
        lrs.append(m["lr"])
        assert set(m) == {"loss", "lr", "grad_norm"}
    assert state["opt"].step == 2
    assert lrs == jlrs
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    got = tree.leaves(params_to_numpy(state["model"]))
    for p, jp in zip(got, jax.tree.leaves(jstate["params"])):
        np.testing.assert_allclose(p, np.asarray(jp), rtol=1e-4, atol=1e-5)


def test_microbatched_grads_are_the_mean_of_microbatch_grads(jax_init):
    """The step's gradient at n_micro 4 is the mean of the four
    microbatches' own gradients (rows 2i, 2i+1), each of its own masked
    mean; a masked mean over the whole batch is another function."""
    _, _, jparams = jax_init
    cfg, model = _port_model(jparams)
    batch = SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=SEED).batch(0, "cpu")
    batch["loss_mask"][1, :5] = 0.0   # microbatches of unequal mask counts
    leaves = model.leaves()
    per_micro = []
    for i in range(4):
        mb = {k: v[2 * i : 2 * i + 2] for k, v in batch.items()}
        loss, _ = model(mb)
        per_micro.append(torch.autograd.grad(loss, leaves))
    want = [sum(g[j] for g in per_micro) / 4 for j in range(len(leaves))]
    whole = torch.autograd.grad(model(batch)[0], leaves)

    captured = {}

    def capture(grads, state, params, **kw):
        captured["grads"] = tree.leaves(grads)
        return state, {}

    step = make_train_step(model, OptimizerConfig(**OPT), n_micro=4,
                           device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr("repro_torch.launch.steps.adamw_update", capture)
    try:
        step({"model": model, "opt": adamw_init(model.params())}, batch)
    finally:
        mp.undo()
    got = captured["grads"]
    assert all(g.dtype == torch.float32 for g in got)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(w.abs().max()))
    assert max(float((g - w).abs().max()) for g, w in zip(got, whole)) > 1e-4


def test_microbatch_split_rows_in_order():
    from repro_torch.launch.steps import _microbatches

    batch = {"tokens": torch.arange(24).reshape(8, 3)}
    mbs = _microbatches(batch, 4)
    for i, mb in enumerate(mbs):
        assert torch.equal(mb["tokens"], batch["tokens"][2 * i : 2 * i + 2])
    with pytest.raises(ValueError, match="microbatches"):
        _microbatches(batch, 3)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "none" if g is None
                         else "x".join(map(str, g[0])))
def test_microbatch_split_matches_jax(grid):
    """Every arch x shape x grid; the reference reads only the mesh's axis
    names and ``devices.shape``, so both take the port's mesh."""
    mesh = None if grid is None else make_mesh(*grid)
    for arch in sorted(ARCHS):
        for name, shape in SHAPES.items():
            got = microbatch_split(ARCHS[arch], shape, mesh)
            want = j_microbatch_split(J_ARCHS[arch], J_SHAPES[name], mesh)
            assert got == want, (arch, name, grid)


def test_shapes_and_train_config_match_jax():
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in J_SHAPES.items()}
    ours = dataclasses.asdict(TrainConfig())
    theirs = dataclasses.asdict(JTrainConfig())
    assert ours == theirs


def _train_cfg(**kw):
    base = dict(steps=6, seq_len=SEQ, global_batch=BATCH, microbatch=2,
                checkpoint_every=3, keep_checkpoints=1,
                optimizer=OptimizerConfig(**OPT))
    base.update(kw)
    return TrainConfig(**base)


def test_build_training_resumes_bitwise(tmp_path):
    cfg = reduced(MINICPM_2B)
    straight = build_training(cfg, _train_cfg(checkpoint_every=0),
                              ckpt_dir=tmp_path / "straight", device="cpu")
    straight.run(6)
    first = build_training(cfg, _train_cfg(), ckpt_dir=tmp_path / "resume",
                           device="cpu")
    first.run(4)
    assert first.ckpt.all_steps() == [2]
    assert first.ckpt.writes[0]["bytes"] > 0
    second = build_training(cfg, _train_cfg(), ckpt_dir=tmp_path / "resume",
                            device="cpu")
    assert second.start_step == 3
    assert second.state["opt"].step == 3
    second.run(6)
    losses = [m["loss"] for m in straight.metrics_log]
    resumed = ([m["loss"] for m in first.metrics_log][:3]
               + [m["loss"] for m in second.metrics_log])
    assert losses == resumed
    assert all(np.isfinite(losses))
    for a, b in zip(straight.state["model"].leaves(),
                    second.state["model"].leaves()):
        assert torch.equal(a, b)
    for a, b in zip(straight.state["opt"].mu + straight.state["opt"].nu,
                    second.state["opt"].mu + second.state["opt"].nu):
        assert torch.equal(a, b)


def test_restore_fills_the_live_model_in_place(tmp_path):
    cfg = reduced(MINICPM_2B)
    loop = build_training(cfg, _train_cfg(), ckpt_dir=tmp_path, device="cpu")
    model = loop.state["model"]
    loop.run(3)
    saved = [p.detach().clone() for p in model.leaves()]
    again = build_training(cfg, _train_cfg(), ckpt_dir=tmp_path,
                           device="cpu")
    restored = again.state["model"]
    assert restored is not model
    for p, q in zip(restored.leaves(), saved):
        assert torch.equal(p, q) and isinstance(p, torch.nn.Parameter)


def test_main_runs_on_cpu(tmp_path, capsys):
    launch_train.main(["--arch", "minicpm-2b", "--reduced", "--device", "cpu",
                       "--steps", "3", "--batch", "4", "--seq", "32",
                       "--ckpt-dir", str(tmp_path)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    fields = dict(kv.split("=") for kv in line.split())
    assert set(fields) == {"steps", "first_loss", "last_loss", "wall_s",
                           "stragglers"}
    assert fields["steps"] == "3"
    assert np.isfinite(float(fields["last_loss"]))


def test_prefetcher_order_and_close():
    data = SyntheticLM(512, 16, 4, seed=5)
    pf = Prefetcher(data, start_step=3, depth=2, device="cpu")
    try:
        for want in (3, 4, 5, 6):
            step, batch = pf.next()
            assert step == want
            ref = data.batch(want, "cpu")
            for k in ref:
                assert torch.equal(batch[k], ref[k])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_train_state_checkpoint_template_keeps_types(tmp_path):
    """The train state round-trips through the checkpoint manager: the
    AdamW state stays a named tuple with an int step."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import CommPolicy

    cfg = reduced(MINICPM_2B)
    state = init_train_state(cfg, OptimizerConfig(), CommPolicy(),
                             generator=torch.Generator().manual_seed(0),
                             device="cpu")
    state["opt"] = state["opt"]._replace(step=7)
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(7, state)
    fresh = init_train_state(cfg, OptimizerConfig(), CommPolicy(),
                             generator=torch.Generator().manual_seed(1),
                             device="cpu")
    restored, meta = mgr.restore_latest(fresh)
    assert type(restored["opt"]) is type(state["opt"])
    assert restored["opt"].step == 7 and meta["step"] == 7
    assert restored["model"] is fresh["model"]
    for a, b in zip(restored["model"].leaves(), state["model"].leaves()):
        assert torch.equal(a, b)
