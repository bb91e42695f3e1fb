"""The port's checkpoint manager and fault runtime: the counterparts of
the reference's checkpoint and fault tests (``tests/test_substrates.py``)
on trees of tensors — round trip with keep-k, async and atomic saves, a
bf16 leaf kept bit for bit, shapes checked against the template, the
resumable loop surviving an injected crash, the straggler monitor."""

from __future__ import annotations

import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.runtime import ResumableLoop, StragglerMonitor, elastic_remesh


def _tiny_state():
    g = torch.Generator().manual_seed(0)
    return {
        "params": {"w": torch.randn((4, 3), generator=g),
                   "b": torch.randn((3,), generator=g).to(torch.bfloat16)},
        "step": [torch.zeros((), dtype=torch.int32)],
    }


def test_checkpoint_roundtrip_and_keep_k(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    state = _tiny_state()
    for s in [10, 20, 30]:
        state["params"]["w"] = state["params"]["w"] + s
        state["params"]["b"] = state["params"]["b"] * 3
        mgr.save(s, state, block=True)
    assert mgr.all_steps() == [20, 30]  # keep-2 GC
    restored, meta = mgr.restore_latest(_tiny_state())
    assert meta["step"] == 30
    for a, b in zip((restored["params"]["w"], restored["params"]["b"]),
                    (state["params"]["w"], state["params"]["b"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert restored["step"][0].dtype == torch.int32


def test_checkpoint_async_and_atomic(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3, async_save=True)
    mgr.save(1, _tiny_state())
    mgr.wait()
    assert mgr.latest_step() == 1
    # a stale .tmp dir must never be listed as a checkpoint
    (tmp_path / "step_00000099.tmp").mkdir()
    assert mgr.latest_step() == 1


def test_checkpoint_restore_checks_shapes(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(0, {"w": torch.zeros((2, 3))})
    with pytest.raises(ValueError):
        mgr.restore(0, {"w": torch.zeros((3, 2))})
    # restore == reshard: the template decides dtype and device
    state, meta = elastic_remesh(mgr, lambda: {"w": torch.ones((2, 3))})
    assert meta["step"] == 0 and torch.equal(state["w"], torch.zeros((2, 3)))


def test_resumable_loop_survives_crash(tmp_path):
    calls = {"n": 0}

    def step_fn(state, step):
        calls["n"] += 1
        if step == 7 and calls["n"] <= 8:  # crash once at step 7
            raise RuntimeError("injected failure")
        return {"x": state["x"] + 1}, {"loss": float(step)}

    mgr = CheckpointManager(tmp_path, keep=3, async_save=False)
    loop = ResumableLoop(
        step_fn=step_fn, make_state=lambda: {"x": torch.zeros(())},
        ckpt=mgr, checkpoint_every=5, max_retries=2,
    )
    final = loop.run(10)
    # crash at 7 -> resume from ckpt@4 (x=5) -> replay 5..9 => x = 10
    assert float(final["x"]) == 10.0
    # a fresh loop resumes from the newest checkpoint, not from zero
    loop2 = ResumableLoop(
        step_fn=step_fn, make_state=lambda: {"x": torch.zeros(())},
        ckpt=mgr, checkpoint_every=5,
    )
    assert loop2.start_step == 10


def test_straggler_monitor_detects_slow_step():
    mon = StragglerMonitor(threshold=2.0, warmup=2)
    for s in range(6):
        mon.record(s, 0.1)
    ev = mon.record(6, 0.5)
    assert ev is not None and ev.ratio > 2.0
    assert len(mon.events) == 1
    # EWMA not poisoned by the outlier
    assert mon.ewma == pytest.approx(0.1, rel=1e-6)
