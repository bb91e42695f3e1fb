"""The port's multi-rank examples (``repro_torch.examples``) and their
launcher against the reference's ``examples/*.py``, on the CPU (the
single-rank ones: ``tests/test_torch_examples_single.py``).

* ``quickstart`` on a 4x4 gloo world through the launcher: every rank
  holds 120, and the engines issue 4 / 6 / 1 permutation rounds, held
  against the lines the unedited reference script prints (run as a
  subprocess on 16 virtual devices) and against ``napalg``'s schedules;
  and on 2x2.
* ``nap_gradient_sync`` on 4x4 from the reference's ``model.init(PRNGKey(0))``
  parameters carried across (``params_from_jax``): the 5 psum and nap
  losses against the reference script's printed ones (atol 2e-4: they are
  printed to 4 decimals), psum against nap at the reference's rtol 1e-4 /
  atol 1e-5, the NAP step's 4 rounds, and the simulated costs against the
  reference simulator's (rel 1e-9).
* ``train_lm --compressed-smoke`` on 2x4 gloo, 2 steps each: finite
  losses and the trace lint's transport budget (four calls a bucket at
  int8 and with error feedback alike).
* the launcher: no card without ``--device cpu`` raises, a grid without
  one rank a card raises, a failing or hung rank fails the launch.
"""

from __future__ import annotations

import dataclasses
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import SubLayer as JSubLayer
from repro.core import perf_model as j_pm
from repro.core import simulator as j_sim
from repro.models import build_model as j_build
from repro_torch.examples import (
    _world, nap_gradient_sync, quickstart, serve_decode, train_lm,
)
from repro_torch.models import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent


def _reference_env() -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module")
def reference_runs():
    """The unedited reference scripts' output, both started at once."""
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"{name}.py")],
        cwd=ROOT, env=_reference_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for name in ("quickstart", "nap_gradient_sync")}
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=600)
            assert p.returncode == 0, stderr[-3000:]
            out[name] = stdout
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _reference_quickstart(text: str) -> dict:
    rows = {}
    for algo, res, exp, steps in re.findall(
            r"^(\w+)\s+allreduce -> \[([\d.]+)\] \(expected ([\d.]+)\), "
            r"inter-chip permute steps = (\d+)$", text, re.M):
        rows[algo] = (float(res), float(exp), int(steps))
    return rows


def _reference_nap(text: str) -> dict:
    permutes, all_reduces = re.search(
        r"NAP train-step HLO: (\d+) collective-permutes, (\d+) all-reduces",
        text).groups()
    losses = {
        algo: [float(v) for v in re.findall(r"'([\d.]+)'", re.search(
            rf"^{algo}\s+losses: \[(.*)\]$", text, re.M).group(1))]
        for algo in ("psum", "nap")}
    costs = {algo: float(us) * 1e-6 for algo, us in re.findall(
        r"^\s+(\w+)\s*:\s+([\d.]+) us$", text, re.M)}
    return {"permutes": int(permutes), "all_reduces": int(all_reduces),
            "losses": losses, "costs": costs}


# ---------------------------------------------------------------------------
# quickstart


def test_quickstart_4x4_matches_reference(reference_runs):
    ref = _reference_quickstart(reference_runs["quickstart"])
    assert set(ref) == set(quickstart.ALGORITHMS)
    rows = quickstart.run(device="cpu", grid=(4, 4))
    for algo, (result, expected, steps) in ref.items():
        assert rows[algo]["result"] == result == 120.0
        assert rows[algo]["expected"] == expected
        assert rows[algo]["rounds"] == steps
        assert rows[algo]["rounds"] == quickstart.schedule_rounds(algo, 4, 4)
    assert [ref[a][2] for a in ("rd", "smp", "nap")] == [4, 6, 1]


def test_quickstart_2x2():
    rows = quickstart.run(device="cpu", grid=(2, 2))
    for algo, row in rows.items():
        assert row["result"] == 6.0
        assert row["rounds"] == quickstart.schedule_rounds(algo, 2, 2)
    assert [rows[a]["rounds"] for a in ("rd", "smp", "nap")] == [2, 3, 1]


# ---------------------------------------------------------------------------
# nap_gradient_sync

# the reference script's CFG (examples/nap_gradient_sync.py:36-48); the
# script is not imported, since it sets XLA_FLAGS when imported
J_NAP_CFG = JModelConfig(
    name="nap-demo-lm", family="dense", num_layers=4, d_model=128,
    num_heads=4, num_kv_heads=4, d_ff=512, vocab_size=1024,
    pattern=(JSubLayer("attn"),), dtype="float32", remat="none",
)


def _same_config(port_cfg, jax_cfg) -> None:
    for f in dataclasses.fields(port_cfg):
        got, want = getattr(port_cfg, f.name), getattr(jax_cfg, f.name)
        if f.name == "pattern" or f.name == "encoder_pattern":
            got = [(s.mixer, s.ffn) for s in got]
            want = [(s.mixer, s.ffn) for s in want]
        assert got == want, f.name


def _carried(cfg_jax, cfg_port) -> dict:
    params = jax.jit(j_build(cfg_jax).init)(jax.random.PRNGKey(0))
    return params_from_jax(jax.tree.map(np.asarray, params), cfg_port, "cpu")


def test_nap_demo_config_matches_reference():
    _same_config(nap_gradient_sync.CFG, J_NAP_CFG)
    assert nap_gradient_sync.CFG.param_count() == J_NAP_CFG.param_count()


def test_nap_gradient_sync_4x4_matches_reference(reference_runs):
    ref = _reference_nap(reference_runs["nap_gradient_sync"])
    params = _carried(J_NAP_CFG, nap_gradient_sync.CFG)
    report = nap_gradient_sync.run(device="cpu", grid=(4, 4), params=params)
    r0 = report["rank0"]
    for algo in ("psum", "nap"):
        np.testing.assert_allclose(r0[algo]["losses"], ref["losses"][algo],
                                   rtol=0, atol=2e-4)
        assert len(r0[algo]["losses"]) == 5
    np.testing.assert_allclose(r0["psum"]["losses"], r0["nap"]["losses"],
                               rtol=1e-4, atol=1e-5)
    assert r0["nap_rounds"] == ref["permutes"] == 4
    assert r0["nap_rounds"] == nap_gradient_sync.expected_rounds(
        r0["buckets"], 4, 4)
    assert r0["nap_all_reduces"] > 0
    for algo, t in report["simulated_s"].items():
        want = j_sim.simulate_algorithm(algo, 2048, 16, 8.0,
                                        j_pm.BLUE_WATERS)
        np.testing.assert_allclose(t, want, rtol=1e-9)
        assert abs(t - ref["costs"][algo]) <= 0.5e-8


# ---------------------------------------------------------------------------
# train_lm


def test_compressed_smoke_2x4():
    out = train_lm.compressed_smoke(steps=2, device="cpu", grid=(2, 4))
    assert set(out) == {"int8", "int4+ef"}
    for label, row in out.items():
        assert len(row["losses"]) == 2
        assert np.all(np.isfinite(row["losses"]))
        assert row["lint"] == []
        assert row["buckets"] >= 1
        assert row["launches"] == row["expected_launches"] == {
            "quantize_pack": 0, "unpack_dequantize": 0}
    assert train_lm.launches_per_bucket(8) == {
        "quantize_pack": 2, "unpack_dequantize": 2}
    assert train_lm.launches_per_bucket(1) == {
        "quantize_pack": 1, "unpack_dequantize": 1}


# ---------------------------------------------------------------------------
# the launcher


def _fail_on_rank_one(rank, topology, device):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    torch.distributed.barrier()  # rank 0 waits for a peer that is gone
    return rank


def _hang(rank, topology, device):
    time.sleep(600)


def _rank_and_grid(rank, topology, device):
    return rank, topology.n_nodes, topology.ppn, str(device)


@pytest.fixture
def tests_importable(monkeypatch):
    # the ranks import this module's functions by name
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (str(TESTS), os.environ.get("PYTHONPATH")) if p))


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("device", [None, "cuda"])
@pytest.mark.parametrize("mod", [quickstart, nap_gradient_sync, train_lm,
                                 serve_decode])
def test_examples_raise_without_a_card(no_cuda, mod, device):
    argv = [] if device is None else ["--device", device]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)


def test_world_grid_on_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for cards, grid in ((4, (2, 2)), (2, (1, 2)), (1, (1, 1)), (8, (4, 2)),
                        (3, (1, 3))):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=cards: c)
        assert _world.world_grid("cuda")[1] == grid
        assert _world.world_grid(None)[1] == grid
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert _world.world_grid("cuda", (4, 1))[1] == (4, 1)
    with pytest.raises(ValueError, match="one a card"):
        _world.world_grid("cuda", (4, 4))
    with pytest.raises(ValueError, match="one a card"):
        _world.world_grid("cuda", (1, 1))


def test_world_grid_on_the_cpu():
    assert _world.world_grid("cpu")[1] == (4, 4)
    assert _world.world_grid("cpu", cpu_grid=(2, 4))[1] == (2, 4)
    assert _world.world_grid("cpu", (3, 2))[1] == (3, 2)
    assert _world.parse_grid("2x4") == (2, 4)
    for bad in ("4", "4x", "0x2", "2x-1", "axb"):
        with pytest.raises(ValueError, match="grid"):
            _world.parse_grid(bad)


def test_launch_returns_every_rank_in_order(tests_importable):
    got = _world.launch(_rank_and_grid, device="cpu", grid=(1, 2),
                        timeout=300)
    assert got == [(r, 1, 2, "cpu") for r in range(2)]


def test_launch_fails_when_a_rank_fails(tests_importable):
    with pytest.raises(RuntimeError, match="a rank failed"):
        _world.launch(_fail_on_rank_one, device="cpu", grid=(1, 2),
                      timeout=300)


def test_launch_times_out(tests_importable):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        _world.launch(_hang, device="cpu", grid=(1, 1), timeout=10)
    assert time.monotonic() - t0 < 120


def test_launch_refuses_a_nested_function():
    def local(rank, topology, device):
        return rank

    with pytest.raises(ValueError, match="module-level"):
        _world.launch(local, device="cpu", grid=(1, 1))
