"""A rehearsal of ``tools/mesh_train_4gpu.py`` (the port's four-card
battery) on one 4-rank gloo world at its reduced sizes (``CPU_SIZES``):
its rank function through ``repro_torch.examples._world.launch``, every
section, ``full_width`` at ``reduced()`` widths.  Every check holds, and
each compressed bucket shows 2 + 2 transport regions in the op trace,
error feedback included (on the cards the tool holds ``LAUNCHES`` to the
same count)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

TOOLS = Path(__file__).resolve().parents[1] / "tools"
sys.path.insert(0, str(TOOLS))

import mesh_train_4gpu as tool  # noqa: E402

TWO_TWO = {"all_gather", "mla_ag", "mla", "mla_pipelined", "nap", "psum",
           "rabenseifner", "rd", "ring", "smp", "mla_rs", "psum_scatter"}
ENGINES = {"2x2": TWO_TWO, "4x1": TWO_TWO - {"nap", "mla_pipelined"},
           "1x4": TWO_TWO - {"mla", "mla_pipelined", "nap", "mla_rs",
                             "mla_ag"}}


@pytest.fixture(scope="module")
def ranks():
    return tool.run("cpu")


@pytest.fixture(scope="module")
def rows(ranks):
    return ranks[0]["rows"]


def _of(rows, check):
    return [r for r in rows if r.get("check") == check]


def test_every_check_holds_on_every_rank(ranks, rows):
    assert [r["bad"] for r in ranks] == [[]] * 4
    done = [r["section"] for r in rows if "section" in r]
    assert done == list(tool.SECTIONS)
    assert not any("error" in r for r in rows)


def test_engines_cover_every_admitted_grid(rows):
    for grid, names in ENGINES.items():
        got = {r["engine"] for r in _of(rows, "engines") if r["grid"] == grid}
        assert got == names, grid
    for r in _of(rows, "engines"):
        assert r["max_excess_vs_oracle"] <= 1 and r["bitwise_equal_gloo"]
        assert r["cases"] == 3 * len(tool.DTYPES) * (
            1 if r["collective"] == "allgather" else 3)
    ext = {r["grid"]: r["supported"] for r in _of(rows, "engines_extensions")}
    assert ext == {"2x2": True, "4x1": False, "1x4": True}
    assert {(r["grid"], r["rs"]) for r in _of(rows, "engines_roundtrip")} \
        == {("2x2", "mla_rs"), ("2x2", "psum_scatter"), ("4x1", "mla_rs"),
            ("4x1", "psum_scatter"), ("1x4", "psum_scatter")}


def test_sync_regions_are_two_plus_two_a_compressed_bucket(rows):
    sync = _of(rows, "sync")
    assert len(sync) == 2 * (4 + 3)
    for r in sync:
        assert r["launches"] == {"quantize_pack": 0, "unpack_dequantize": 0}
        assert r["regions"] == r["expected_regions"]
        if r["policy"] != "none":
            assert r["kernel_bitwise_equal_plain"]
            assert r["regions"]["quantize_pack"] > 0
        if r["route"] == "allreduce" and r["policy"] != "none":
            # every bucket of this tree but the int32 one is compressed
            assert r["regions"] == {"quantize_pack": 2 * (r["buckets"] - 1),
                                    "unpack_dequantize": 2 * (r["buckets"]
                                                              - 1)}
        assert r["int_leaves_exact"] and r["max_error_over_bound"] <= 1
    ef = [r for r in sync if r["policy"] == "int4+ef"]
    assert len(ef) == 2
    assert all(r["ef_residual_sum_vs_error_sent_over_slack"] <= 1
               for r in ef)
    # the decodes before F3's repair (on the transport kernel) give the
    # same values; on the CPU neither route launches a kernel
    for r in ef:
        assert r["ef_decodes"]["bitwise_equal"]
        assert r["ef_decodes"]["kernel_decodes_launches"] == r["launches"]


def test_grad_sync_mesh_is_sync_with_context(rows):
    mesh = _of(rows, "grad_sync_mesh")
    assert [r["policy"] for r in mesh] == ["none", "int8", "int4+ef"]
    for r in mesh:
        assert r["bitwise_equal_sync_with_context"] and r["dtensor_out"]
        per = 2 * r["buckets"] if r["policy"] != "none" else 0
        assert r["regions"] == {"quantize_pack": per,
                                "unpack_dequantize": per}


def test_train_mesh_resumes_bitwise(rows):
    train = _of(rows, "train_mesh")
    assert [r["config"] for r in train] == ["minicpm-2b-smoke",
                                            "deepseek-moe-16b-smoke"]
    for r in train:
        assert r["make_train_step"]["err_vs_mesh_none"] <= 1
        assert r["build_training"]["err_vs_mesh_none"] <= 1
        assert r["build_training"]["resume_start_step"] == 2
        assert r["build_training"]["resume_bitwise_equal"]


def test_full_width_rehearsal(rows):
    dp = _of(rows, "full_width_dp")
    assert [(r["policy"], r["route"]) for r in dp] == [
        ("psum", "auto"), ("nap", "auto"), ("psum", "auto"), ("nap", "auto"),
        ("int8", "auto"), ("int8", "plain"), ("int4+ef", "auto"),
        ("int4+ef", "plain")]
    assert all(r["dtype"] == "float32" for r in dp)  # reduced() widths
    assert all(r["bitwise_equal_kernel_route"] for r in dp
               if r["route"] == "plain")
    assert dp[1]["loss_rel_diff_vs_psum"] <= 1e-6
    for r in dp:  # psum against the same step at world size 1
        assert ("vs_world_1" in r) == (r["policy"] == "psum")
    for r in (dp[0], dp[2]):
        one = r["vs_world_1"]
        assert one["loss_rel_diff"] <= tool.WORLD_ONE_TOL["float32"][0]
        assert one["param_diff_over_change"] <= tool.WORLD_ONE_TOL[
            "float32"][1]
        assert len(one["losses"]) == r["steps"]
    assert dp[3]["loss_rel_diff_vs_psum"] <= 1e-6
    [trainer] = _of(rows, "full_width_mesh_trainer")
    assert trainer["loss_max_diff_over_max"] <= 2.0 ** -7
    assert len(trainer["losses"]) == trainer["steps"] == 3


@pytest.mark.parametrize("argv", [[], ["--device", "cuda"]])
def test_tool_refuses_without_a_card(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(argv)


def test_tool_refuses_fewer_than_four_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one a card"):
        tool.run("cuda")


def test_launcher_imports_a_script_from_its_directory():
    from repro_torch.examples import _world

    assert _world._target(tool.rank_main) == (
        "mesh_train_4gpu:rank_main", str(TOOLS))
    assert _world._target(_world.parse_grid) == (
        "repro_torch.examples._world:parse_grid", None)
