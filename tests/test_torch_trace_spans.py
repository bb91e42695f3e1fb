"""The program's spans and MoE counter (``repro_torch.trace_regions``).

Off (no profiler recording), a span is the shared no-op context and no
``record_function`` is built, and the counter touches no tensor.  On,
under ``torch.profiler`` on the CPU, a reduced deepseek-moe DP step at
one rank (int4 + error feedback, remat "full") opens each span the
expected number of times a step, the recompute only inside the backward;
three steps traced and untraced end bit for bit alike; and the counter
counts each routed item once a step, its kept items those of
``moe._bucket_positions``, launching nothing in the step.
"""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace_regions as tr
from repro_torch import tree as tree_util
from repro_torch.configs import ARCHS, OptimizerConfig, reduced
from repro_torch.core import CommPolicy
from repro_torch.data import SyntheticLM
from repro_torch.launch import (init_train_state, make_dp_train_step,
                                make_train_step, mesh_topology)
from repro_torch.models import moe

CFG = reduced(ARCHS["deepseek-moe-16b"])
OPT = OptimizerConfig(lr=1e-3, schedule="constant", warmup_steps=1)
POL = CommPolicy(algorithm="auto", mean=True, compress_bits=4,
                 error_feedback=True, transport_impl="plain")
BATCH, SEQ, STEPS = 2, 32, 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the small ops of these steps thrash with more
    under the test workers' load."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run(traced: bool, trace_path=None):
    """``STEPS`` DP steps from one seed: ``(state, losses)``; with
    ``traced`` under the profiler, the Chrome trace written to
    ``trace_path``."""
    step = make_dp_train_step(CFG, OPT, mesh_topology(1, 1), POL,
                              device="cpu")
    state = init_train_state(CFG, OPT, POL,
                             generator=torch.Generator().manual_seed(0),
                             device="cpu")
    data = SyntheticLM(CFG.vocab_size, SEQ, BATCH, seed=0)
    losses = []

    def go():
        nonlocal state
        for s in range(STEPS):
            state, m = step(state, data.batch(s, "cpu"))
            losses.append(m["loss"])

    if not traced:
        go()
        return state, losses
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        go()
    prof.export_chrome_trace(str(trace_path))
    return state, losses


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The traced run, its spans ``[(name, tid, start, end)]`` and the
    counter's reading over it."""
    path = tmp_path_factory.mktemp("spans") / "trace.json"
    tr.reset_moe_counts()
    state, losses = _run(True, path)
    counts = tr.moe_counts()
    tr.reset_moe_counts()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["name"], e["tid"], e["ts"], e["ts"] + e["dur"])
             for e in events if e.get("cat") == "user_annotation"
             and e.get("ph") == "X"]
    return state, losses, spans, counts


def test_off_a_span_is_the_shared_no_op(monkeypatch):
    def built(*args, **kwargs):
        raise AssertionError("a record_function was built while off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", built)
    assert not torch._C._autograd._profiler_enabled()
    assert tr.span("forward") is tr._NO_REGION
    assert tr.recompute_span() is tr._NO_REGION
    with tr.span("adamw"), tr.recompute_span():
        pass


def test_off_the_counter_touches_no_tensor():
    class NotATensor:
        def __getattr__(self, name):
            raise AssertionError(f"the counter read .{name} while off")

    tr.reset_moe_counts()
    tr.count_moe_route(48, 64, NotATensor())
    assert tr.moe_counts() == {"moe_routed": 0, "moe_slots": 0,
                               "moe_kept": 0}


def test_the_count_launches_nothing_and_reads_a_running_total():
    """On, a route hands its mask over and no operator runs; a read sums
    the held masks into the running totals, and 64 held masks fold into
    one on the device."""
    keep = torch.tensor([True] * 40 + [False] * 8)
    tr.reset_moe_counts()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tr.count_moe_route(48, 64, keep)
        assert not [e.name for e in prof.events()]
        first = tr.moe_counts()
        assert first == {"moe_routed": 48, "moe_slots": 64, "moe_kept": 40}
        assert tr.moe_counts() == first
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(tr._KEEP_FOLD + 6):
                tr.count_moe_route(48, 64, keep)
        assert len(tr._KEEP) == 7
        n = tr._KEEP_FOLD + 7
        assert tr.moe_counts() == {"moe_routed": 48 * n,
                                   "moe_slots": 64 * n, "moe_kept": 40 * n}
    finally:
        tr.reset_moe_counts()


def test_each_span_opens_as_often_as_expected(traced):
    _, _, spans, _ = traced
    assert spans and all(n.startswith(tr.PREFIX) for n, *_ in spans)
    count = {}
    for name, *_ in spans:
        count[name] = count.get(name, 0) + 1
    layers = CFG.num_layers
    assert count == {
        "repro_torch.forward": STEPS, "repro_torch.backward": STEPS,
        "repro_torch.grad_sync": STEPS, "repro_torch.adamw": STEPS,
        "repro_torch.recompute": STEPS * CFG.num_super_layers,
        # each MoE layer routes in the forward and again in the recompute
        "repro_torch.moe.route": 2 * STEPS * layers,
        "repro_torch.moe.experts": 2 * STEPS * layers,
    }


@pytest.mark.parametrize("n_micro", [1, 2])
def test_the_trainer_opens_the_same_spans(n_micro):
    """``make_train_step`` marks each microbatch's forward and backward and
    the step's AdamW (no gradient sync there)."""
    state = init_train_state(CFG, OPT, POL,
                             generator=torch.Generator().manual_seed(0),
                             device="cpu")
    step = make_train_step(state["model"], OPT, n_micro=n_micro,
                           device="cpu")
    batch = SyntheticLM(CFG.vocab_size, SEQ, BATCH, seed=0).batch(0, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step({"model": state["model"], "opt": state["opt"]}, batch)
    count = {}
    for e in prof.events():
        if e.name.startswith(tr.PREFIX):
            count[e.name] = count.get(e.name, 0) + 1
    assert count == {
        "repro_torch.forward": n_micro, "repro_torch.backward": n_micro,
        "repro_torch.recompute": n_micro * CFG.num_super_layers,
        "repro_torch.moe.route": 2 * n_micro * CFG.num_layers,
        "repro_torch.moe.experts": 2 * n_micro * CFG.num_layers,
        "repro_torch.adamw": 1,
    }


def _inside(span, outer) -> bool:
    return span[2] >= outer[2] and span[3] <= outer[3]


def test_the_recompute_runs_only_inside_the_backward(traced):
    _, _, spans, _ = traced
    by = lambda n: [s for s in spans if s[0] == f"repro_torch.{n}"]
    for r in by("recompute"):
        assert any(_inside(r, b) for b in by("backward"))
        assert not any(_inside(r, f) for f in by("forward"))
    routes = by("moe.route")
    in_fwd = [r for r in routes if any(_inside(r, f) for f in by("forward"))]
    in_rec = [r for r in routes
              if any(_inside(r, c) for c in by("recompute"))]
    assert len(in_fwd) == len(in_rec) == len(routes) // 2
    for e in by("moe.experts"):
        assert any(_inside(e, r) for r in routes)


def test_tracing_changes_nothing_of_the_steps(traced):
    state, losses, _, _ = traced
    plain, plain_losses = _run(False)
    assert [float(x) for x in losses] == [float(x) for x in plain_losses]
    pairs = [(state["model"].leaves(), plain["model"].leaves()),
             (state["opt"].mu, plain["opt"].mu),
             (state["opt"].nu, plain["opt"].nu),
             (tree_util.leaves(state["ef"]), tree_util.leaves(plain["ef"]))]
    for a, b in pairs:
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert torch.equal(x.detach(), y.detach())


def test_the_counter_counts_each_routed_item_once_a_step(traced):
    _, _, _, c = traced
    m, tokens = CFG.moe, BATCH * SEQ
    cap = moe._capacity(tokens, m.top_k, m.num_experts, m.capacity_factor)
    routes = STEPS * CFG.num_layers     # the forward's; not the recompute's
    assert c["moe_routed"] == routes * tokens * m.top_k
    assert c["moe_slots"] == routes * m.num_experts * min(cap, tokens)
    assert 0 < c["moe_kept"] <= min(c["moe_routed"], c["moe_slots"])


@pytest.mark.parametrize("groups", [1, 4])
def test_kept_items_are_the_bucket_positions_kept(groups):
    """At capacity factor 0.5 the cap drops items; the counter's kept
    items equal a plain count of ``_bucket_positions``' keep."""
    m = CFG.moe
    g = torch.Generator().manual_seed(1)
    params = moe.init_moe(CFG, torch.float32, generator=g, device="cpu")
    x = torch.randn(2, 64, CFG.d_model, generator=g)
    cfg = dataclasses.replace(CFG, moe=dataclasses.replace(
        m, capacity_factor=0.5))
    tr.reset_moe_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        moe.moe_apply(params, x, cfg=cfg, groups=groups)
    c = tr.moe_counts()
    tr.reset_moe_counts()
    _, top_idx, _, _ = moe._router(params["w_router"], x, m)
    tokens, tg = x.shape[0] * x.shape[1], x.shape[0] * x.shape[1] // groups
    cap = moe._capacity(tg, m.top_k, m.num_experts, 0.5)
    _, keep = moe._bucket_positions(
        top_idx.reshape(groups, tg * m.top_k), m.num_experts, cap)
    assert c["moe_kept"] == int(keep.sum()) < c["moe_routed"]
    assert c["moe_routed"] == tokens * m.top_k
    assert c["moe_slots"] == groups * m.num_experts * min(cap, tg)
