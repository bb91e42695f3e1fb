"""Guards of the port: it imports neither JAX nor the JAX package, and its
entry points run on the card unless the caller asks for the CPU."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs import ARCHS, MINICPM_2B, OptimizerConfig, reduced
from repro_torch.configs import TrainConfig
from repro_torch.core import CommPolicy, Topology
from repro_torch.data import Prefetcher, SyntheticLM
from repro_torch.launch import (
    build_training, init_train_state, make_dp_train_step, make_prefill_step,
    make_serve_step, make_train_step,
)
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, cache_from_jax, params_from_jax
from repro_torch.serve import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
] + sorted((ROOT / "tools").glob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
    return mods


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES]
)
def test_no_jax_or_reference_import(path):
    bad = [
        m for m in _imported_modules(path)
        if m.split(".")[0] in FORBIDDEN
    ]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_sees_every_module():
    assert len(PORT_FILES) >= 25
    assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
            / "transport.cu").is_file()


def test_guard_sees_the_kernel_modules():
    kernels = ROOT / "src" / "repro_torch" / "kernels"
    for name in ("_build", "ops", "flash_attention", "rwkv6_scan",
                 "mamba_scan", "transport", "ref"):
        assert kernels / f"{name}.py" in PORT_FILES


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_guard_sees_the_serving_modules():
    port = ROOT / "src" / "repro_torch"
    for rel in ("serve/__init__.py", "serve/scheduler.py", "serve/router.py",
                "serve/decode.py", "serve/engine.py", "runtime/fault.py",
                "checkpoint/manager.py", "analysis/protocol_check.py",
                "launch/serve.py"):
        assert port / rel in PORT_FILES, rel


def test_guard_sees_the_model_family_modules():
    models = ROOT / "src" / "repro_torch" / "models"
    for name in ("moe", "mamba", "rwkv", "attention", "transformer",
                 "layers", "model"):
        assert models / f"{name}.py" in PORT_FILES, name


def test_guard_sees_the_training_driver_modules():
    port = ROOT / "src" / "repro_torch"
    for rel in ("launch/train.py", "launch/steps.py", "launch/mesh.py",
                "models/sharding.py", "data/pipeline.py",
                "configs/base.py"):
        assert port / rel in PORT_FILES, rel


def test_guard_sees_the_encoder_decoder_modules():
    port = ROOT / "src" / "repro_torch"
    for rel in ("configs/base.py", "configs/archs.py", "configs/__init__.py",
                "models/attention.py", "models/transformer.py",
                "models/model.py", "serve/engine.py", "serve/__init__.py",
                "launch/serve.py", "launch/steps.py", "launch/train.py",
                "launch/__init__.py"):
        assert port / rel in PORT_FILES, rel
    assert ROOT / "tools" / "probe_stack_backward.py" in PORT_FILES


def test_guard_sees_the_dry_run_modules():
    port = ROOT / "src" / "repro_torch"
    for rel in ("launch/dryrun.py", "launch/roofline.py",
                "launch/trace_analysis.py", "launch/reanalyze.py",
                "analysis/trace_lint.py", "trace_regions.py"):
        assert port / rel in PORT_FILES, rel


def test_guard_sees_the_analysis_driver_modules():
    port = ROOT / "src" / "repro_torch"
    for rel in ("analysis/spmd_lint.py", "analysis/__main__.py",
                "analysis/__init__.py", "core/comm.py"):
        assert port / rel in PORT_FILES, rel


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_launch_serve_runs_every_arch_on_cpu(arch, capsys):
    launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "4", "--gen", "3"])
    assert "generated (2, 3) tokens" in capsys.readouterr().out


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert repro_torch.resolve_device().type == "cuda"
    assert repro_torch.resolve_device("cpu").type == "cpu"


def test_entry_points_raise_without_cuda(no_cuda):
    cfg = reduced(MINICPM_2B)
    opt = OptimizerConfig()
    pol = CommPolicy(compress_bits=8)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg, generator=gen)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_dp_train_step(cfg, opt, Topology.from_world(1, 1), pol)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(cfg, opt, pol, generator=gen)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({}, cfg)


def test_entry_points_run_on_cpu_when_asked(no_cuda):
    cfg = reduced(MINICPM_2B)
    opt = OptimizerConfig()
    pol = CommPolicy(compress_bits=8)
    gen = torch.Generator().manual_seed(0)
    state = init_train_state(cfg, opt, pol, generator=gen, device="cpu")
    assert all(p.device.type == "cpu" for p in state["model"].leaves())
    step = make_dp_train_step(cfg, opt, Topology.from_world(1, 1), pol,
                              device="cpu")
    assert step.plan.num_buckets >= 1


def _cpu_model():
    gen = torch.Generator().manual_seed(0)
    return build_model(reduced(MINICPM_2B), generator=gen, device="cpu")


def test_serving_entry_points_raise_without_cuda(no_cuda):
    model = _cpu_model()
    prompts = torch.zeros((1, 2), dtype=torch.long)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(model, num_slots=1, max_len=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.serve_batch(model, prompts, gen_len=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_serve_step(model)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_prefill_step(model)
    with pytest.raises(RuntimeError, match="CUDA"):
        cache_from_jax({"index": 0, "stack": {}})
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--arch", "minicpm-2b", "--reduced"])


def test_encoder_decoder_entry_points_raise_without_cuda(no_cuda):
    from repro_torch.configs import WHISPER_TINY

    cfg = reduced(WHISPER_TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg, generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--arch", "whisper-tiny", "--reduced"])
    model = build_model(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    template = {"frames": torch.empty((1, 4, cfg.d_model), device="meta")}
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(model, num_slots=1, max_len=8, extras_template=template)
    eng = ServeEngine(model, num_slots=1, max_len=8,
                      extras_template=template, device="cpu")
    req = eng.submit([1, 2], 2, extras={"frames": torch.zeros(
        (1, 4, cfg.d_model))})
    assert len(eng.run()[req.rid]) == 2


def test_serving_entry_points_run_on_cpu_when_asked(no_cuda, capsys):
    model = _cpu_model()
    eng = ServeEngine(model, num_slots=2, max_len=8, device="cpu")
    req = eng.submit([1, 2], 3)
    assert len(eng.run()[req.rid]) == 3
    out = launch_serve.serve_batch(model, torch.ones((2, 3), dtype=torch.long),
                                   gen_len=2, device="cpu")
    assert out.shape == (2, 2) and out.device.type == "cpu"
    step = make_serve_step(model, device="cpu")
    tok, _ = step(model.init_decode(1, 4), torch.ones((1, 1),
                                                      dtype=torch.long))
    assert tok.shape == (1, 1)
    assert make_prefill_step(model, tail=2, device="cpu")(
        {"tokens": torch.ones((1, 3), dtype=torch.long)}).shape == (
        1, 2, model.cfg.vocab_size)
    launch_serve.main(["--arch", "minicpm-2b", "--reduced", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "3",
                       "--gen", "2"])
    assert "generated (2, 2) tokens" in capsys.readouterr().out


def _tiny_train_cfg():
    return TrainConfig(steps=2, seq_len=16, global_batch=2,
                       checkpoint_every=0)


def test_training_entry_points_raise_without_cuda(no_cuda, tmp_path):
    cfg = reduced(MINICPM_2B)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_training(cfg, _tiny_train_cfg(), ckpt_dir=tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "minicpm-2b", "--reduced", "--steps",
                           "1", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(_cpu_model(), OptimizerConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        Prefetcher(SyntheticLM(16, 4, 2))


def test_training_entry_points_run_on_cpu_when_asked(no_cuda, tmp_path):
    loop = build_training(reduced(MINICPM_2B), _tiny_train_cfg(),
                          ckpt_dir=tmp_path, device="cpu")
    loop.run(2)
    assert loop.state["model"].device.type == "cpu"
    assert len(loop.metrics_log) == 2
    step = make_train_step(_cpu_model(), OptimizerConfig(), device="cpu")
    assert callable(step)
    pf = Prefetcher(SyntheticLM(16, 4, 2), device="cpu")
    try:
        assert pf.next()[1]["tokens"].device.type == "cpu"
    finally:
        pf.close()
