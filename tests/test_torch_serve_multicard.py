"""A rehearsal of ``tools/serve_tp_4gpu.py`` (the tensor-parallel serving
spine across four cards) on one 4-rank gloo world at its reduced sizes
(``CPU_SIZES``): its rank function through
``repro_torch.examples._world.launch``, every section.  Every check holds:
the reference's continuous-batching check on 2x2 / 4x1 / 1x4 with its
dispatch, ``serve_batch`` with the group-agreed EOS exit, the grids and
pinned engines of ``full_width`` and the families at reduced widths
against ``ctx=None``, and the router over two engines of one group, fed
durations the ranks agree on, with equal placements on every rank."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

TOOLS = Path(__file__).resolve().parents[1] / "tools"
sys.path.insert(0, str(TOOLS))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import serve_tp_4gpu as tool  # noqa: E402

import _torch_world as tw  # noqa: E402


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


def test_check_is_the_reference_check():
    assert tool.SERVE_WORKLOAD == tw.SERVE_WORKLOAD
    assert (tool.CHECK["num_slots"], tool.CHECK["max_len"],
            tuple(tool.CHECK["buckets"])) == (
        tw.SERVE_SLOTS, tw.SERVE_MAX_LEN, tuple(tw.SERVE_BUCKETS))


def test_check_on_every_grid(rows):
    from repro_torch.core import napalg

    check = _of(rows, "check")
    assert [r["grid"] for r in check] == ["2x2", "4x1", "1x4"]
    assert [r["engine_built_with"] for r in check] == ["mesh", "ctx", "ctx"]
    b_max = max(napalg.ragged_splits(tw.SERVE_SLOTS, 4))
    for r in check:
        assert tuple(r["dispatch"]) == tool.CHECK_DISPATCH[r["grid"]]
        assert r["continuous_equals_serial"] and r["equal_to_gloo"]
        assert r["same_on_every_rank"] and r["b_max"] == b_max == 3
        assert [len(s) for s in r["tokens"]] == [
            b for _, b in tw.SERVE_WORKLOAD]
        assert r["tokens"] == check[0]["tokens"]
    assert tuple(check[0]["dispatch"]) == ("nap", "mla_ag", "psum")


def test_serve_batch_rows_equal_the_whole_batch(rows):
    batch = _of(rows, "serve_batch")
    assert [r["grid"] for r in batch] == ["2x2", "4x1", "1x4"]
    for r in batch:
        assert r["rows_equal_whole_batch"]
        assert len(r["whole_batch"]) == 4


def test_full_width_every_grid_and_pin(rows):
    fw = _of(rows, "full_width")
    assert [(r["grid"], r["pin"]) for r in fw] == [
        (g, p) for g, pins in tool.PINS.items() for p in pins]
    spec = tool.CPU_SIZES["full_width"]
    plan = spec["plan"]
    ran = [r for r in fw if "ran_as" not in r]
    # a pin equal to auto's planned engine is auto's run
    assert [(r["grid"], r["pin"]) for r in fw if "ran_as" in r] == [
        (g, plan[g]) for g in tool.PINS if plan[g] in tool.PINS[g]]
    for r in ran:
        logits = r["dispatch"]["logits_allreduce"][0]
        assert logits == (plan[r["grid"]] if r["pin"] == "auto"
                          else r["pin"])
        assert r["dispatch_is_plan"] and r["continuous_equals_serial"]
        assert r["same_on_every_rank"] and r["b_max"] == 2
        assert r["no_kernel_launched"] and len(r["kernel_launches"]) == 5
        # every request in the continuous run, the cheapest served alone
        assert r["requests"] == spec["requests"]
        assert len(r["served_alone"]) == spec["serial"]
        assert all(v["ok"] for v in r["vs_one_card"])
        assert len(r["vs_one_card"]) == spec["serial"]
        assert "vs_one_card_all_slots" not in r
        assert r["ms_per_step_median"] > 0 and r["tokens_per_s"] > 0
        assert r["profiled_step"]["device_busy_ms"] is None  # no card
        assert r["links"] == tool.LINKS
    [one] = _of(rows, "full_width_one_card")
    assert len(one["requests"]) == spec["requests"]
    assert one["ms_per_step_median"] > 0 and one["tokens_per_s"] > 0


def test_full_width_traffic_is_chip_smokes_serve():
    """The card's full_width traffic is chip_smoke.py's SERVE (read from
    its source: the script exits on import without a card), all 8 slots
    filled at the start."""
    import ast

    src = (TOOLS.parent / "chip_smoke.py").read_text()
    tree = ast.parse(src)
    values = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and [t.id for t in node.targets
                     if isinstance(t, ast.Name)] == ["SERVE"]):
            values = {k.arg: ast.literal_eval(k.value)
                      for k in node.value.keywords}
        if (isinstance(node, ast.Assign) and [
                t.id for t in node.targets
                if isinstance(t, ast.Name)] == ["SEED"]):
            assert ast.literal_eval(node.value) == tool.SEED
    card = tool.CARD_SIZES["full_width"]
    assert values and {k: card[k] for k in values} == values
    assert card["first"] == card["num_slots"] == 8 and card["after"] == 2


def test_serial_pick_takes_the_cheapest_requests():
    traffic = [([1] * 5, 9), ([1] * 2, 3), ([1] * 9, 1), ([1] * 1, 1)]
    assert tool.serial_pick(traffic, 2) == [1, 3]
    assert tool.serial_pick(traffic, 4) == [0, 1, 2, 3]


def test_families_on_two_by_two(rows):
    fam = _of(rows, "families")
    assert [r["config"] for r in fam] == [
        f"{n}-smoke" for n in tool.CPU_SIZES["families"]["configs"]]
    for r in fam:
        assert r["grid"] == "2x2" and r["logits_engine_held"]
        assert r["continuous_equals_serial"] and r["dispatch_is_plan"]
        assert all(v["ok"] for v in r["vs_one_card"])
        assert r["tokens_generated"] == 4 * 6
        assert r["served_alone"] == [0, 1, 2, 3]


def test_router_agreed_durations_keep_placements_equal(rows):
    [r] = _of(rows, "router")
    spec = tool.CPU_SIZES["router"]
    assert r["every_request_finished"] and r["streams_equal_uninterrupted"]
    assert r["placements_equal_on_every_rank"]
    assert r["health_events_equal_on_every_rank"]
    assert r["stall_degraded_replica_1"] and r["rerouted"] > 0
    # only rank 1's own clock saw its stall: fed those clocks, the ranks
    # would have parted ways
    own = [[tuple(e) for e in events]
           for events in r["own_clock_events_by_rank"]]
    stall = (1, spec["straggle_step"])
    assert stall in own[1]
    assert any(stall not in own[k] for k in (0, 2, 3))
    assert not r["own_clocks_agree"]


def test_groups_are_counted(rows):
    # the mesh engine's 2x2 (two intra, two inter), 4x1's one inter-node
    # group and 1x4's one intra-node group
    assert _of(rows, "groups") == [{"check": "groups", "groups_created": 6}]


def test_near_tie_criterion():
    one = torch.tensor([[0.0, 1.0, 3.0], [2.0, 2.0 + 1e-6, 0.0]])
    flip = torch.tensor([[0.0, 1.0, 3.0], [2.0 + 2e-6, 2.0, 0.0]])
    assert tool.near_tie([2, 1], [2, 1], flip, one) == {"equal": True,
                                                        "ok": True}
    got = tool.near_tie([2, 0], [2, 1], flip, one)
    assert got["ok"] and got["first_diff"] == 1
    assert got["top2_gap"] <= got["logit_err_spread"]
    far = torch.tensor([[0.0, 1.0, 3.0], [2.5, 2.0, 0.0]])
    one_far = torch.tensor([[0.0, 1.0, 3.0], [2.0, 2.4, 0.0]])
    # a flip the error explains, but an error of the logits' own scale
    got = tool.near_tie([2, 0], [2, 1], far, one_far)
    assert got["rows_replay_tokens"] and got["logit_err_rel"] > 0.2
    assert not got["ok"]
    # rows that do not give their own stream's token are not a near tie
    got = tool.near_tie([2, 2], [2, 1], flip, one)
    assert not got["rows_replay_tokens"] and not got["ok"]
    assert not tool.near_tie([2, 1], [2, 1, 0], flip, one)["ok"]


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


def test_tool_runs_the_sections_asked_for(monkeypatch, capsys):
    got = {}

    def fake_run(device, sections):
        got["sections"] = sections
        return [{"bad": [], "rows": []}] * 4

    monkeypatch.setattr(tool, "run", fake_run)
    tool.main(["--device", "cpu", "--sections", "router,full_width"])
    assert got["sections"] == ("full_width", "router")  # the tool's order
    assert '"ok": true' in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tool.main(["--device", "cpu", "--sections", "full_width,nope"])


def test_slot_witness_rehearsal(capsys):
    """tools/serve_slots_witness.py at reduced sizes: the 8- and 2-slot
    one-card engines on each model and dtype, float32 held."""
    import json

    import serve_slots_witness as witness

    witness.main(["--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert lines[-1] == {"ok": True, "failed": [], "device": "cpu"}
    rows = lines[:-1]
    assert [(r["config"], r["dtype"]) for r in rows] == [
        (f"{c}-smoke", d) for c in witness.CONFIGS for d in witness.DTYPES]
    for r in rows:
        assert len(r["by_request"]) == tool.CPU_SIZES["families"]["requests"]
        if r["dtype"] == "float32":
            assert r["near_tie_ok"]
        moe = r["config"].startswith("jamba")
        assert all(("router_calls" in q) == moe for q in r["by_request"])


def test_launcher_imports_the_script_from_its_directory():
    from repro_torch.examples import _world

    assert _world._target(tool.rank_main) == (
        "serve_tp_4gpu:rank_main", str(TOOLS))
