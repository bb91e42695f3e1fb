"""The manifest and the files it names: every rule on names, units and
keys holds, every cell loads with its configuration, traffic and spec,
and every per-layer metric has a reader that finds nothing in an empty
trace."""

import copy
import json

import pytest

from perfbench import manifest as mf
from perfbench.trace import RankTrace, TraceRun

MANIFEST = mf.load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]
PER_LAYER = [m["name"] for m in MANIFEST["per_layer"]]


def test_the_manifest_keeps_every_rule():
    assert mf.check_manifest(MANIFEST) == []


def test_the_manifest_has_the_contract_keys_and_nothing_else():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "perfbench/run.py"]
    assert MANIFEST["paths"] == ["perfbench"]
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source",
                           "workloads"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}}
    for group, allowed in keys.items():
        for entry in MANIFEST[group]:
            assert set(entry) <= allowed, entry
    assert "setup_s" in {m["name"] for m in MANIFEST["end_to_end"]}
    assert len(json.dumps(MANIFEST)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_loads_with_its_files(cell):
    c = mf.load_cell(cell)
    assert c.chips == c.grid[0] * c.grid[1]
    assert c.config["num_layers"] >= 1 and c.traffic["global_batch"] % \
        c.chips == 0
    numbers = {"loss", "loss3", "grad", "grad_elem", "change"}
    if c.spec["sync"].get("error_feedback"):
        numbers.add("ef")
    assert set(c.spec["limits"]) == numbers
    assert set(c.spec) == {"grid", "sync", "optimizer", "trace_steps",
                           "limits"}, "config, chips and why: the manifest's"
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reduces_no_width(cell):
    c = mf.load_cell(cell)
    entry = next(x for x in MANIFEST["configs"] if x["name"] ==
                 c.config_name)
    assert set(entry["reduced"]) == set(c.config["reduced"])
    for key in entry["reduced"]:
        assert not key.endswith(("_dim", "_rank", "_size")), key
        assert key not in ("d_model", "d_ff", "num_heads", "num_kv_heads",
                           "head_dim", "top_k", "d_expert")


@pytest.mark.parametrize("name", PER_LAYER)
def test_each_reader_finds_nothing_in_an_empty_trace(name):
    empty = TraceRun(steps=4, chips=1, ranks=[RankTrace(
        window_s=1.0, kernels=[], counters={}, idle_gaps=[])],
        counts={"flops": 1e12}, peaks={"bf16_flops": 989e12,
                                       "bytes_per_s": 3.35e12})
    value = mf.metric_reader(name)(empty)
    assert value is None or name == "step_mfu"


@pytest.mark.parametrize("bad, rule", [
    (lambda m: m["end_to_end"][0].update(unit="tokens per s"), "bad unit"),
    (lambda m: m["end_to_end"][0].update(name="a b"), "bad name"),
    (lambda m: m["end_to_end"][0].update(bound=0.3), "bound"),
    (lambda m: m["per_layer"][0].update(moves="nothing"), "moves"),
    (lambda m: m["per_layer"][0].update(source="guess"), "source"),
    (lambda m: m["workloads"].append(dict(m["workloads"][0])), "twice"),
    (lambda m: m["per_layer"][0].update(workloads=["no_such_cell"]),
     "unknown cell"),
])
def test_a_breach_is_found(bad, rule):
    m = copy.deepcopy(MANIFEST)
    bad(m)
    assert any(rule in p for p in mf.check_manifest(m))
