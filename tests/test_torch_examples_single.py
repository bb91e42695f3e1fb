"""The port's single-rank examples against the reference's, on the CPU
(the multi-rank ones and the launcher: ``tests/test_torch_examples.py``).

* ``train_lm``: ``LM_100M`` field by field against the reference's
  (imported from ``examples/train_lm.py``, which sets ``XLA_FLAGS`` only
  under ``--compressed-smoke``), with ``reduced()`` of each; the crash and
  resume at ``reduced(LM_100M)``, bitwise equal to a straight run; the
  main mode end to end at reduced width and its loss-drop check.
* ``serve_decode``'s schedule for the four archs: every request's tokens
  equal to the reference ``ServeEngine``'s from carried parameters, with
  the same submissions.

Both run in this process, on one torch thread.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduced as j_reduced
from repro.models import build_model as j_build
from repro.serve import PromptBuckets as JBuckets
from repro.serve import ServeEngine as JEngine
from repro_torch import tree
from repro_torch.configs import reduced
from repro_torch.examples import serve_decode, train_lm
from repro_torch.launch.train import build_training
from repro_torch.models import params_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_examples import _same_config  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def one_thread():
    """The in-process runs on one torch thread: the suite's workers share
    the box, and oversubscribed threads slow a small model a hundredfold."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# train_lm


def _reference_train_lm():
    spec = importlib.util.spec_from_file_location(
        "reference_train_lm", ROOT / "examples" / "train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    flags = os.environ.get("XLA_FLAGS")
    spec.loader.exec_module(mod)
    assert os.environ.get("XLA_FLAGS") == flags
    return mod


def test_lm_100m_matches_reference():
    ref = _reference_train_lm().LM_100M
    _same_config(train_lm.LM_100M, ref)
    assert train_lm.LM_100M.param_count() == ref.param_count() == 66_727_936
    small = reduced(train_lm.LM_100M)
    _same_config(small, j_reduced(ref))
    assert small.param_count() == 106_752


def test_train_lm_resume_is_bitwise_a_straight_run(capsys, one_thread):
    cfg = reduced(train_lm.LM_100M)
    train_cfg = train_lm.train_config(10, 4, 32, checkpoint_every=3)
    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() \
            as b:
        loop, report = train_lm.train_with_crash(cfg, train_cfg, Path(a),
                                                 device="cpu")
        straight = build_training(cfg, train_cfg, ckpt_dir=Path(b),
                                  device="cpu")
        straight.run(10)
    assert report["crash_at"] == 6 and report["resumed_at"] == 6
    assert "auto-resumed at step 6" in capsys.readouterr().out
    got = tree.leaves(loop.state["model"].params())
    want = tree.leaves(straight.state["model"].params())
    assert len(got) == len(want) > 0
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert loop.metrics_log[-1]["loss"] == straight.metrics_log[-1]["loss"]


def test_train_lm_main_mode_at_reduced_width(tmp_path, monkeypatch, capsys,
                                             one_thread):
    monkeypatch.setattr(train_lm, "LM_100M", reduced(train_lm.LM_100M))
    report = train_lm.main(["--device", "cpu", "--steps", "100", "--seq",
                            "64", "--ckpt-dir", str(tmp_path / "ckpt"),
                            "--report", str(tmp_path / "report.json")])
    assert report["crash_at"] == 60 and report["resumed_at"] == 50
    assert report["last_loss"] < report["first_loss"] - 0.5
    assert "[phase 2] auto-resumed at step 50" in capsys.readouterr().out
    assert (tmp_path / "report.json").is_file()


def test_train_lm_main_mode_checks_the_loss_drop(tmp_path, monkeypatch,
                                                 one_thread):
    monkeypatch.setattr(train_lm, "LM_100M", reduced(train_lm.LM_100M))
    every = train_lm.train_config
    monkeypatch.setattr(train_lm, "train_config",
                        lambda *a: every(*a, checkpoint_every=1))
    with pytest.raises(AssertionError, match="drop materially"):
        train_lm.main_mode(steps=4, batch=2, seq=16, ckpt_dir=tmp_path,
                           device="cpu")


# ---------------------------------------------------------------------------
# serve_decode


def _reference_streams(arch: str, gen: int = 8):
    """The reference script's ``demo`` (examples/serve_decode.py:29-91),
    returning every request's tokens in submit order."""
    cfg = j_reduced(J_ARCHS[arch])
    model = j_build(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    extras_template = None
    if cfg.encoder_layers:
        extras_template = {
            "frames": jax.ShapeDtypeStruct((1, 16, cfg.d_model), cfg.dtype)}
    engine = JEngine(model, params, num_slots=2, max_len=32,
                     buckets=JBuckets([8, 16]),
                     extras_template=extras_template)
    rng = np.random.default_rng(1)

    def make_extras():
        if extras_template is None:
            return None
        return {"frames": jax.numpy.asarray(
            rng.standard_normal((1, 16, cfg.d_model)), cfg.dtype)}

    reqs = [engine.submit(rng.integers(0, cfg.vocab_size, size=n).tolist(),
                          max_new_tokens=g, extras=make_extras())
            for n, g in [(12, gen), (5, gen + 2)]]
    engine.step()
    reqs.append(engine.submit(
        rng.integers(0, cfg.vocab_size, size=9).tolist(),
        max_new_tokens=gen - 2, extras=make_extras()))
    out = engine.run()
    return [list(out[r.rid]) for r in reqs], params


@pytest.mark.parametrize("arch", serve_decode.ARCH_NAMES)
def test_serve_decode_matches_reference_engine(arch, one_thread):
    want, jparams = _reference_streams(arch)
    cfg = reduced(serve_decode.ARCHS[arch])
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    got = serve_decode.demo(arch, params=params, device="cpu")
    assert got["tokens"] == want
    assert [len(t) for t in got["tokens"]] == [8, 10, 6]
