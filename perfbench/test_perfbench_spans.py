"""The program's spans read from a traced window (``trace.read_trace``)
and the readers that take them (``spans.py``), on a Chrome trace made up
by hand: two host threads (the window's, and autograd's that launches the
backward), launches linked to their kernels by ``correlation`` through
both launch calls (``cudaLaunchKernel``, ``cuLaunchKernel``), a recompute
on autograd's thread, and an idle gap before a kernel of each phase.  The
spans change nothing of the window's kernels and idle gaps; each reader
finds nothing in a ``RankTrace`` without spans or the MoE counter's keys,
in an empty run or in a trace without the program's spans.  And a traced
run of the cell, as ``run.py --trace 1`` makes it, prints every reader's
metric."""

import dataclasses
import json

import pytest
import torch

from perfbench import counts
from perfbench import manifest as mf
from perfbench import spans
from perfbench.test_perfbench_faults import (  # noqa: F401 (a fixture)
    SEED, one_rank_world, tiny)
from perfbench.trace import RankTrace, TraceRun, idle_gaps, read_trace

PEAKS = {"bf16_flops": 989e12, "bytes_per_s": 3.35e12}
READERS = ["forward_ms", "backward_ms", "recompute_ms", "sync_ms",
           "adamw_ms", "moe_dispatch_ms", "moe_slot_use", "moe_drop_share"]
T0 = 5_000_000.0          # the window's start on the profiler's clock, us
MAIN, AUTOGRAD, STREAM = 11, 12, 7
P = "repro_torch."
# (name, thread, start, end), us from the window's start
SPANS = [
    (P + "forward", MAIN, 10, 200), (P + "moe.route", MAIN, 50, 150),
    (P + "moe.experts", MAIN, 80, 120), (P + "backward", MAIN, 200, 600),
    (P + "recompute", AUTOGRAD, 300, 450),
    (P + "moe.route", AUTOGRAD, 320, 400),
    (P + "moe.experts", AUTOGRAD, 340, 380),
    (P + "grad_sync", MAIN, 600, 750), (P + "adamw", MAIN, 750, 950),
]
OPS = [
    ("aten::mm", MAIN, 12, 18), ("aten::cumsum", MAIN, 52, 58),
    ("aten::bmm", MAIN, 82, 88), ("aten::linear", MAIN, 150, 159),
    ("aten::addmm", MAIN, 152, 158), ("aten::mm", AUTOGRAD, 205, 215),
    ("aten::addmm", AUTOGRAD, 302, 308), ("aten::cumsum", AUTOGRAD, 328, 332),
    ("aten::bmm", AUTOGRAD, 342, 348),
    ("aten::index_put_", AUTOGRAD, 455, 465), ("aten::add_", MAIN, 752, 758),
    ("aten::div", MAIN, 952, 958),
]
# (kernel, start, duration, launching thread, launch time, launch call:
# rt cudaLaunchKernel, cu cuLaunchKernel, None no launch)
KERNELS = [
    ("gemm_fwd", 20, 40, MAIN, 15, "rt"),           # forward
    ("scan_outer_dim", 65, 10, MAIN, 55, "rt"),     # route
    ("bmm_fwd", 90, 30, MAIN, 85, "rt"),            # experts
    ("head_gemm", 160, 30, MAIN, 155, "rt"),        # forward
    ("gemm_bwd", 220, 50, AUTOGRAD, 210, "rt"),     # backward, across
    ("gemm_rec", 310, 20, AUTOGRAD, 305, "rt"),     # recompute
    ("scan_rec", 335, 5, AUTOGRAD, 330, "rt"),      # route in recompute
    ("bmm_rec", 350, 20, AUTOGRAD, 345, "rt"),      # experts in recompute
    ("scatter_bwd", 470, 60, AUTOGRAD, 460, "rt"),  # backward
    ("quantize_pack_kernel", 620, 10, MAIN, 610, "cu"),  # grad_sync
    ("adam_add", 760, 100, MAIN, 755, "rt"),        # adamw
    ("loss_div", 960, 5, MAIN, 955, "rt"),          # no span
    ("memset_like", 975, 5, None, None, None),      # no launch
    ("after_window", 1100, 5, MAIN, 990, "rt"),     # outside
]
WINDOW_US = 1000
US = 1e-6
# device us a step by phase, as the readers should read them
WANT_MS = {"forward_ms": 0.110, "backward_ms": 0.110, "recompute_ms": 0.045,
           "sync_ms": 0.010, "adamw_ms": 0.100, "moe_dispatch_ms": 0.015}
WANT_GAPS = {
    f"{P}forward | aten::mm": 20, f"{P}moe.route | aten::cumsum": 5 + 5,
    f"{P}moe.experts | aten::bmm": 15 + 10,
    f"{P}forward | aten::addmm": 40, f"{P}backward | aten::mm": 30,
    f"{P}recompute | aten::addmm": 40,
    f"{P}backward | aten::index_put_": 100,
    f"{P}grad_sync | (no host op)": 90, f"{P}adamw | aten::add_": 130,
    "(no span) | aten::div": 100, "(no span) | (no host op)": 10,
    "(window end)": 20,
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the small ops of these steps thrash with more
    under the test workers' load."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _x(name, cat, tid, start, dur, **args):
    e = {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
         "ts": T0 + start, "dur": dur}
    if args:
        e["args"] = args
    return e


def events(with_spans: bool = True) -> list:
    ev = [_x("perfbench.window", "user_annotation", MAIN, 0, WINDOW_US)]
    if with_spans:
        for name, tid, a, b in SPANS:
            ev.append(_x(name, "user_annotation", tid, a, b - a))
            # the device's copy of a span, which the reader leaves alone
            ev.append(_x(name, "gpu_user_annotation", STREAM, a, b - a))
    ev += [_x(n, "cpu_op", tid, a, b - a) for n, tid, a, b in OPS]
    for corr, (name, start, dur, tid, at, api) in enumerate(KERNELS):
        ev.append(_x(name, "kernel", STREAM, start, dur, correlation=corr,
                     stream=STREAM))
        if api is not None:
            cat, call = {"rt": ("cuda_runtime", "cudaLaunchKernel"),
                         "cu": ("cuda_driver", "cuLaunchKernel")}[api]
            ev.append(_x(call, cat, tid, at, 2, correlation=corr))
    ev.append({"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 3,
               "pid": 1, "tid": MAIN, "ts": T0 + 15})
    return ev


def write(path, with_spans: bool = True):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"traceEvents": events(with_spans)}))
    return path


@pytest.fixture
def traced(tmp_path):
    """``(path, run)``: the trace file and its ``TraceRun`` of one step
    read with the spans."""
    path = write(tmp_path / "trace_rank0.json")
    return path, run_of(read_trace(path))


def harness_trace(path, counters=None) -> RankTrace:
    """The rank's window with the span fields at their defaults, as a
    reading that keeps no spans holds it."""
    rt = read_trace(path, counters)
    return RankTrace(window_s=rt.window_s, kernels=rt.kernels,
                     counters=rt.counters, idle_gaps=rt.idle_gaps)


def run_of(rank: RankTrace, steps: int = 1) -> TraceRun:
    return TraceRun(steps=steps, chips=1, ranks=[rank],
                    counts={"flops": 1e12},
                    peaks={"bf16_flops": 989e12, "bytes_per_s": 3.35e12})


def test_the_harness_s_reading_is_kept_as_it_is(traced, tmp_path):
    """The spans change nothing of the window, the kernels and the idle
    gaps: the same trace without them reads the same to the bit, with the
    counters it is handed."""
    path, _ = traced
    counters = {"transport_launches": 4}
    rs = read_trace(path, counters)
    old = read_trace(write(tmp_path / "bare.json", with_spans=False),
                     counters)
    assert (rs.window_s, rs.kernels, rs.counters, rs.idle_gaps) == (
        old.window_s, old.kernels, old.counters, old.idle_gaps)
    assert rs.idle_gaps == idle_gaps(rs.kernels, [
        (n, a * US, (b - a) * US) for n, tid, a, b in OPS if tid == MAIN],
        rs.window_s)
    assert [n for n, _, _ in rs.kernels] == [k[0] for k in KERNELS[:-1]]
    assert old.spans == [] and len(rs.spans) == len(SPANS)


def test_each_kernel_is_charged_to_its_span(traced):
    path, _ = traced
    rs = read_trace(path)
    chains = {n: rs.chain(i) if i is not None else []
              for (n, _, _), i in zip(rs.kernels, rs.kernel_span)}
    assert chains["gemm_fwd"] == [P + "forward"]
    assert chains["bmm_fwd"] == [P + "moe.experts", P + "moe.route",
                                 P + "forward"]
    # autograd's thread has no span open: charged across to the window's
    assert chains["gemm_bwd"] == [P + "backward"]
    assert chains["bmm_rec"] == [P + "moe.experts", P + "moe.route",
                                 P + "recompute", P + "backward"]
    assert chains["quantize_pack_kernel"] == [P + "grad_sync"]
    assert chains["loss_div"] == chains["memset_like"] == []
    ops = dict(zip([n for n, _, _ in rs.kernels], rs.kernel_op))
    assert ops["head_gemm"] == "aten::addmm"        # the innermost op
    assert ops["quantize_pack_kernel"] is None


def test_the_spans_partition_the_attributed_kernels(traced):
    path, _ = traced
    rs = read_trace(path)
    phases = spans.phase_ms(rs, steps=1)
    unspanned = 1e3 * sum(d for (_, _, d), i in zip(rs.kernels,
                                                    rs.kernel_span)
                          if i is None)
    total = 1e3 * sum(d for _, _, d in rs.kernels)
    assert sum(phases.values()) + unspanned == pytest.approx(total)
    assert phases == pytest.approx(
        {k: v for k, v in WANT_MS.items() if k != "moe_dispatch_ms"})


@pytest.mark.parametrize("name", sorted(WANT_MS))
def test_each_span_reader_reads_its_phase(traced, name):
    _, run = traced
    assert mf.metric_reader(name)(run) == pytest.approx(WANT_MS[name])


def test_a_reader_divides_by_the_steps(traced):
    path, _ = traced
    run = run_of(read_trace(path), steps=4)
    assert mf.metric_reader("adamw_ms")(run) == pytest.approx(0.025)


def test_idle_gaps_are_charged_to_the_kernel_ending_each(traced):
    path, _ = traced
    rs = read_trace(path)
    got = dict(spans.idle_gaps_by_span(rs, top=20))
    assert got == pytest.approx({k: v * US for k, v in WANT_GAPS.items()})
    assert sum(got.values()) == pytest.approx(sum(
        s for _, s in idle_gaps(rs.kernels, [], rs.window_s, top=1000)))
    assert len(spans.idle_gaps_by_span(rs)) == 10


def test_the_counter_readers_read_the_rank_s_counters(traced):
    path, _ = traced
    run = run_of(harness_trace(path, {
        "transport_launches": 4, "moe_routed": 48, "moe_slots": 64,
        "moe_kept": 40}))
    assert mf.metric_reader("moe_slot_use")(run) == pytest.approx(
        100 * 40 / 64)
    assert mf.metric_reader("moe_drop_share")(run) == pytest.approx(
        100 * 8 / 48)


@pytest.mark.parametrize("counters", [
    {"transport_launches": 4},                  # the harness's keys today
    {"moe_routed": 48, "moe_slots": 64},        # a key missing
    {"moe_routed": 0, "moe_slots": 0, "moe_kept": 0},   # nothing routed
])
def test_the_counter_readers_find_nothing_without_the_counter(
        traced, counters):
    path, _ = traced
    run = run_of(harness_trace(path, counters))
    for name in ("moe_slot_use", "moe_drop_share"):
        assert mf.metric_reader(name)(run) is None


@pytest.mark.parametrize("name", READERS)
def test_each_reader_finds_nothing_without_the_program_s_spans(
        tmp_path, name):
    """The harness's own ``RankTrace`` of a trace with spans, a trace of a
    program that opens no span (the parent's), and the manifest test's
    empty run."""
    path = write(tmp_path / "trace_rank0.json")
    assert mf.metric_reader(name)(run_of(harness_trace(path))) is None
    bare = write(tmp_path / "bare.json", with_spans=False)
    assert mf.metric_reader(name)(run_of(read_trace(bare))) is None
    empty = TraceRun(steps=4, chips=1, ranks=[RankTrace(
        window_s=1.0, kernels=[], counters={}, idle_gaps=[])],
        counts={"flops": 1e12}, peaks={"bf16_flops": 989e12,
                                       "bytes_per_s": 3.35e12})
    assert mf.metric_reader(name)(empty) is None


def test_the_command_prints_a_trace_s_phases(traced, capsys):
    path, _ = traced
    assert spans.main([str(path), "--steps", "1"]) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["phases_ms"] == pytest.approx(
        {k: v for k, v in WANT_MS.items() if k != "moe_dispatch_ms"})
    assert line["kernel_ms"] == pytest.approx(
        sum(line["phases_ms"].values()) + line["no_span_ms"])
    assert line["spans"][P + "moe.route"] == {
        "opened": 2, "ms": pytest.approx(0.065),
        "self_ms": pytest.approx(WANT_MS["moe_dispatch_ms"])}
    assert dict(line["idle_gaps_by_span"])["(window end)"] == \
        pytest.approx(20 * US)


def test_the_command_runs_a_one_chip_cell_traced(
        tmp_path, monkeypatch, one_rank_world):
    """A traced run as ``run.py --trace 1`` makes it (here the cell's rank
    run at the faults test's small size on the CPU, in a one-rank gloo
    world, and its result line): the eight span and counter metrics and
    the idle gaps by span are in it.  Every span of the DP step opens in
    each window step, and the counter's growth over the run is the
    window's routes alone (set-up's five steps run with no profiler)."""
    from perfbench import harness
    from perfbench import rank as rank_mod

    cell = dataclasses.replace(tiny(), per_layer=tuple(
        m for m in mf.load_manifest()["per_layer"] if m["name"] in
        spans.METRICS))
    monkeypatch.setattr(rank_mod, "HERE", tmp_path)
    res = rank_mod.run_rank(cell, SEED, rank=0, world=1, device="cpu",
                            seconds=0.0, trace=True)
    line = harness.result_line(cell, res, True, 0.0, counts.of_cell(cell),
                               PEAKS, [])
    json.dumps(line)
    steps = cell.spec["trace_steps"]
    assert line["correct"] and line["attempted"] == steps
    assert set(line["metrics"]) == set(spans.METRICS)
    for name, unit in spans.METRICS.items():
        assert line["metrics"][name]["unit"] == unit
    rt = res.trace
    layers = cell.config["num_layers"]
    opened = {n: s["opened"] for n, s in spans._summary(rt, steps)[
        "spans"].items()}
    assert opened == {
        P + "forward": steps, P + "backward": steps,
        P + "grad_sync": steps, P + "adamw": steps,
        P + "recompute": steps * layers,
        P + "moe.route": 2 * steps * layers,
        P + "moe.experts": 2 * steps * layers}
    tokens = cell.traffic["global_batch"] * cell.traffic["seq_len"]
    moe = cell.config["moe"]
    assert rt.counters["moe_routed"] == steps * layers * tokens * moe[
        "top_k"]
    assert 0 < rt.counters["moe_kept"] <= rt.counters["moe_routed"]
    assert line["breakdown"]["idle_gaps_by_span"]
