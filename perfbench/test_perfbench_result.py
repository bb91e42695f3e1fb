"""The result line: the contract's keys, the cell's metrics with their
units, and the numbers compared last, from a gathered result made up by
hand (no card here): its traced window holds the program's spans, each
kernel charged to one, and its MoE counter, so that every registered
per-layer metric reads a number."""

import json

import pytest

from perfbench import manifest as mf
from perfbench.harness import result_line
from perfbench.rank import RankResult
from perfbench.trace import RankTrace

CELLS = [w["name"] for w in mf.load_manifest()["workloads"]]
PEAKS = {"bf16_flops": 989e12, "bytes_per_s": 3.35e12}


P = "repro_torch."
# (name, thread, start_s, dur_s, parent): a step's spans, the recompute
# and a route inside the backward
SPANS = [(P + "forward", 1, 0.0, 0.04, None), (P + "moe.route", 1, 0.01,
                                                0.02, 0),
         (P + "backward", 1, 0.04, 0.05, None),
         (P + "recompute", 2, 0.045, 0.01, 2),
         (P + "moe.route", 2, 0.046, 0.005, 3),
         (P + "grad_sync", 1, 0.09, 0.04, None),
         (P + "adamw", 1, 0.13, 0.05, None)]
COUNTERS = {"transport_launches": 4, "moe_routed": 48, "moe_slots": 64,
            "moe_kept": 40}


def gathered(cell, trace: bool) -> RankResult:
    # (kernel, start, duration), the span each was launched under
    kernels = [("gemm_kernel", 0.0, 0.03), ("scan_kernel", 0.03, 0.005),
               ("gemm_bwd_kernel", 0.04, 0.004),
               ("gemm_rec_kernel", 0.045, 0.004),
               ("scan_rec_kernel", 0.05, 0.002),
               ("ncclDevKernel_AllReduce", 0.09, 0.02),
               ("quantize_pack_kernel", 0.11, 0.004),
               ("unpack_dequantize_kernel", 0.12, 0.004),
               ("adamw_apply_kernel", 0.14, 0.03)]
    kernel_span = [0, 1, 2, 3, 4, 5, 5, 5, 6]
    ranks = [RankResult(
        rank=r, window_start=100.0 + r, step_ms=[100.0 + i for i in range(10)],
        window_ms=1050.0, steps=10 if not trace else 2, peak_bytes=2 ** 30,
        trace=RankTrace(window_s=0.2, kernels=kernels,
                        counters=dict(COUNTERS),
                        idle_gaps=[("aten::mm", 0.1)], spans=SPANS,
                        kernel_span=kernel_span,
                        kernel_op=["aten::mm"] * len(kernels))
        if trace else None,
        forbidden=[], final_loss=1.0, check_losses=[1.0, 1.0, 1.0],
        kind="NVIDIA H100 80GB HBM3") for r in range(cell.chips)]
    res = ranks[0]
    res.check = {"correct": True, "rows": [["loss", 1e-5, 3e-4],
                                           ["grad", 0.01, 0.2],
                                           ["change", 0.01, 0.3]],
                 "ranks": ranks}
    return res


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line_keeps_the_contract(cell, trace):
    c = mf.load_cell(cell)
    out = result_line(c, gathered(c, trace), trace, 90.0,
                      {"flops": 1e13, "transport_bytes": 1e9}, PEAKS, [])
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["count"] == c.chips
    assert dev["memory_peak_bytes"] == 2 ** 30
    wanted = c.per_layer if trace else c.end_to_end
    assert set(out["metrics"]) == {m["name"] for m in wanted}
    for m in wanted:
        assert out["metrics"][m["name"]]["unit"] == m["unit"]
    if trace:
        assert dev["busy_s"] > 0 and dev["window_s"] == 0.2
        assert len(out["breakdown"]["device_ops"]) <= 10
        by_span = dict(out["breakdown"]["idle_gaps_by_span"])
        assert by_span[f"{P}grad_sync | aten::mm"] == pytest.approx(0.044)
        assert by_span["(window end)"] == pytest.approx(0.03)
        metrics = out["metrics"]
        # two steps: half of each span's kernels a step, in ms
        if "forward_ms" in metrics:
            assert metrics["forward_ms"]["value"] == pytest.approx(17.5)
            assert metrics["backward_ms"]["value"] == pytest.approx(2.0)
            assert metrics["recompute_ms"]["value"] == pytest.approx(3.0)
            assert metrics["moe_dispatch_ms"]["value"] == pytest.approx(3.5)
            assert metrics["moe_slot_use"]["value"] == pytest.approx(62.5)
            assert metrics["moe_drop_share"]["value"] == pytest.approx(
                100 * 8 / 48)
    else:
        metrics = out["metrics"]
        assert metrics["tokens_per_s"]["value"] == pytest.approx(
            10 * 4096 / 1.05)
        assert metrics["setup_s"]["value"] == pytest.approx(
            10.0 + c.chips - 1)
        assert metrics["peak_mem_gib"]["value"] == 1.0
    json.dumps(out)
