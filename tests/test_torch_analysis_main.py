"""The verification driver ``python -m repro_torch.analysis`` against the
reference's ``python -m repro.analysis``: the schedule table row for row,
the ``--spmd`` sweep clean in a subprocess, the default run (schedules and
the trace wire lint) clean in a subprocess, and the protocol sweep's first
three scopes at the recorded state floors with the reference's layer-0
link."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import __main__ as driver
from repro_torch.analysis import protocol_check as pc

ROOT = Path(__file__).resolve().parents[1]


def _run(tmp_path, *flags):
    out = tmp_path / "table.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *flags,
         "--json", str(out)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return json.loads(out.read_text()), proc.stdout


def test_schedule_table_matches_reference(monkeypatch):
    # the reference's driver sets XLA_FLAGS on import unless it is set:
    # keep this process's value as it was
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.analysis import __main__ as ref

    port = driver.run_schedule_sweep()
    want = ref.run_schedule_sweep()
    assert port["engines"] == want["engines"]
    assert port["rows"] == want["rows"]
    assert (port["grid_matrix"], port["payload_elems"]) == (
        want["grid_matrix"], want["payload_elems"])
    assert port["violations"] == 0


def test_spmd_sweep_exits_clean(tmp_path):
    table, stdout = _run(tmp_path, "--spmd")
    sweep = table["spmd_lint"]
    assert table["ok"] and sweep["violations"] == 0, stdout
    labels = [r["label"] for r in sweep["rows"]]
    for want in ("grad_sync[bits=8]", "grad_sync[bits=4]", "train_step[nap]",
                 "serve_decode[eos early-exit]",
                 "serve_engine[continuous batching]"):
        assert want in labels
    # every engine cell of every grid and both dtypes, as the reference's
    assert sum(e["cells"] for e in sweep["engines"].values()) == 72
    assert sweep["byte_verified_cells"] == 42


def test_default_run_exits_clean(tmp_path):
    table, stdout = _run(tmp_path)
    assert table["ok"], stdout
    assert table["schedule_verification"]["violations"] == 0
    lint = table["hlo_lint"]
    assert lint["violations"] == 0 and lint["world"] == [2, 4]
    assert "stable trace" in stdout and "compressed wire" in stdout


def test_default_tables_go_under_reports(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--skip-hlo"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    table = json.loads(
        (tmp_path / "reports" / "analysis_torch" / "schedules.json")
        .read_text())
    assert "hlo_lint" not in table and table["ok"]


def test_protocol_sweep_meets_the_floors():
    from repro.analysis.protocol_check import (
        verify_decode_geometry_link as ref_link)

    sweep = driver.run_protocol_sweep(pc.PROTOCOL_GRID[:3])
    assert [r["states"] for r in sweep["rows"]] == [230, 3591, 9890]
    assert [r["min_states"] for r in sweep["rows"]] == [230, 3591, 9890]
    assert sweep["violations"] == 0 and sweep["coverage_failures"] == 0
    assert sweep["layer2_link"]["b_max"] == ref_link(8, 8)["b_max"]
    assert sweep["layer2_link"] == ref_link(8, 8)


def test_help_names_every_flag(capsys):
    with pytest.raises(SystemExit):
        driver.main(["--help"])
    out = capsys.readouterr().out
    for flag in ("--json", "--spmd", "--protocol", "--skip-hlo",
                 "--skip-schedules"):
        assert flag in out
