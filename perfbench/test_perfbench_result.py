"""The result line: the contract's keys, the cell's metrics with their
units, and the numbers compared last, from a gathered result made up by
hand (no card here)."""

import json

import pytest

from perfbench import manifest as mf
from perfbench.harness import result_line
from perfbench.rank import RankResult
from perfbench.trace import RankTrace

CELLS = [w["name"] for w in mf.load_manifest()["workloads"]]
PEAKS = {"bf16_flops": 989e12, "bytes_per_s": 3.35e12}


def gathered(cell, trace: bool) -> RankResult:
    kernels = [("gemm_kernel", 0.0, 0.05), ("ncclDevKernel_AllReduce", 0.05,
                                           0.02),
               ("quantize_pack_kernel", 0.08, 0.004),
               ("unpack_dequantize_kernel", 0.09, 0.004)]
    ranks = [RankResult(
        rank=r, window_start=100.0 + r, step_ms=[100.0 + i for i in range(10)],
        window_ms=1050.0, steps=10 if not trace else 2, peak_bytes=2 ** 30,
        trace=RankTrace(window_s=0.2, kernels=kernels,
                        counters={"transport_launches": 4},
                        idle_gaps=[("aten::mm", 0.1)]) if trace else None,
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
    else:
        metrics = out["metrics"]
        assert metrics["tokens_per_s"]["value"] == pytest.approx(
            10 * 4096 / 1.05)
        assert metrics["setup_s"]["value"] == pytest.approx(
            10.0 + c.chips - 1)
        assert metrics["peak_mem_gib"]["value"] == 1.0
    json.dumps(out)
