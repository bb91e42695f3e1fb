"""The port's machine model for the H100 host
(``perf_model.H100_NVLINK_HOST``, fitted by ``tools/fit_machine_4gpu.py``)
against the JAX package's cost model, and the rule that gives it to the
executable topologies of an NCCL world.

(a) Under the card's constants the port's and the reference's
    ``Topology.of`` give the same crossover, the same dispatch for every
    collective, the same pipeline depth and bucket size, and the same
    dispatched cost (relative 1e-12).
(b) Both packages' ``MachineParams.fit`` recover the card's ``alpha`` and
    ``R_N`` from rows the model itself gives, and the rate those rows
    identify for ``R_b`` (the fit gave ``R_N < R_b``, so one sender is
    already held to ``R_N``: :data:`IDENTIFIED`).
(c) The tool's fitting recovers the constants from noisy seeded rows and
    raises on rows that do not grow with size.
(d) ``Topology.of`` and a gloo world keep ``TPU_V5E_POD``; a world whose
    backend reports NCCL takes the card's constants.
(e) A rehearsal of the tool on one 4-rank gloo world at three sizes.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import comm as jc
from repro.core import perf_model as jp
from repro_torch.core import comm as tc
from repro_torch.core import perf_model as tp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import fit_machine_4gpu as tool  # noqa: E402

CARD = tp.H100_NVLINK_HOST
GRIDS = [(2, 2), (4, 1), (1, 4), (2, 4), (2, 16), (8, 16), (64, 16)]
SIZES = sorted({1 << k for k in range(2, 29)}          # 4 B .. 256 MB
               | {3, 7, 1000, 98_765, 3_928_096, 42_467_334, 100_000_003,
                  268_435_455})
FIELDS = ("alpha_l", "beta_l", "alpha", "R_b", "R_N", "gamma")


def _reference(params):
    return jp.MachineParams(**dataclasses.asdict(params))


def test_card_constants_are_exported_and_named():
    assert "H100_NVLINK_HOST" in tp.__all__
    assert CARD.name == "h100_nvlink_host"
    assert all(math.isfinite(getattr(CARD, f)) and getattr(CARD, f) > 0
               for f in FIELDS)
    # the reference's constants stay as the reference has them
    for name in ("TPU_V5E_POD", "BLUE_WATERS"):
        assert dataclasses.asdict(getattr(tp, name)) == dataclasses.asdict(
            getattr(jp, name))


# ---------------------------------------------------------------------------
# (a) dispatcher parity under the card's constants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("collective", tc.COLLECTIVES)
@pytest.mark.parametrize("n,ppn", GRIDS)
def test_dispatch_equals_reference(n, ppn, collective):
    ours = tc.CommContext(tc.Topology.of(n, ppn, params=CARD))
    theirs = jc.CommContext(jc.Topology.of(n, ppn, params=_reference(CARD)))
    for s in SIZES:
        assert tuple(ours.dispatch(s, collective=collective)) == tuple(
            theirs.dispatch(s, collective=collective)), s


@pytest.mark.parametrize("n,ppn", GRIDS)
def test_crossover_chunks_buckets_and_cost_equal_reference(n, ppn):
    ours = tc.Topology.of(n, ppn, params=CARD)
    theirs = jc.Topology.of(n, ppn, params=_reference(CARD))
    assert ours.crossover_bytes() == theirs.crossover_bytes()
    for s in SIZES:
        assert ours.optimal_pipeline_chunks(s) == (
            theirs.optimal_pipeline_chunks(s)), s
        assert ours.dispatched_cost(s) == pytest.approx(
            theirs.dispatched_cost(s), rel=1e-12, abs=0.0), s
    for total in (4096, 3_928_096, 1_442_676_736, 1 << 28):
        assert ours.optimal_bucket_bytes(total) == (
            theirs.optimal_bucket_bytes(total)), total
        assert ours.optimal_bucket_bytes(total, compute_seconds=0.05) == (
            theirs.optimal_bucket_bytes(total, compute_seconds=0.05)), total


# ---------------------------------------------------------------------------
# (b) fit recovers the constants
# ---------------------------------------------------------------------------


def _model_rows(cost, params, ppn):
    rows = []
    for s in (4 ** k for k in range(1, 14)):
        rows.append((s, cost(float(s), params, 1), 1))
        rows.append((s, cost(float(s), params, ppn), ppn))
    return rows


#: what message timings identify of the card's constants.  The fit gave
#: ``R_N < R_b``: under Eq 3 one sender is then already held to ``R_N``
#: (``min(R_N, 1 * R_b)``), so every ``maxrate_message_cost`` is that of
#: ``R_b = R_N`` and a fit over such rows returns ``min(R_b, R_N)``.
IDENTIFIED = dataclasses.replace(CARD, R_b=min(CARD.R_b, CARD.R_N))


def test_message_costs_see_only_the_identified_rate():
    assert CARD.R_N < CARD.R_b  # the four-card fit's finding
    for k in (1, 2, 4, 16):
        for s in (4.0, 3_928_096.0, 1 << 26):
            assert tp.maxrate_message_cost(s, CARD, k) == (
                tp.maxrate_message_cost(s, IDENTIFIED, k))
    # SMP's one sender a node runs at R_b itself: there the two differ
    assert tp.cost_smp(1 << 26, 2, 2, CARD) < tp.cost_smp(1 << 26, 2, 2,
                                                          IDENTIFIED)


@pytest.mark.parametrize("ppn", [2, 4, 16])
@pytest.mark.parametrize("which", ["card", "consistent"])
def test_fit_recovers_the_card_constants(ppn, which):
    """Both packages' ``fit`` over rows of Eq 3 at ``k = 1`` and ``k =
    ppn`` return ``alpha``, ``R_b`` and ``R_N`` within 1e-9: the card's
    ``alpha`` and ``R_N`` and the rate the rows identify for ``R_b``
    (:data:`IDENTIFIED`); all three of a variant with ``R_N = ppn *
    R_b``, whose single sender is not injection-limited."""
    params = CARD if which == "card" else dataclasses.replace(
        CARD, R_N=ppn * CARD.R_b)
    want = IDENTIFIED if which == "card" else params
    ours = tp.MachineParams.fit(
        _model_rows(tp.maxrate_message_cost, params, ppn), base=params)
    ref = _reference(params)
    theirs = jp.MachineParams.fit(
        _model_rows(jp.maxrate_message_cost, ref, ppn), base=ref)
    for got in (ours, theirs):
        for f in ("alpha", "R_b", "R_N"):
            assert getattr(got, f) == pytest.approx(getattr(want, f),
                                                    rel=1e-9), (ppn, f)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


# ---------------------------------------------------------------------------
# (c) the tool's fitting on noisy rows
# ---------------------------------------------------------------------------


#: multiplicative noise on every row, and what the fit must then recover
#: (relative): at this noise 200 seeds stayed within half of each; the
#: rates fall out of the few rows where bytes outweigh alpha, so they move
#: most (beta_l most of all: 64 MB within a node is 24% of a row)
NOISE = 0.005
TOL = {"alpha": 0.01, "R_b": 0.05, "R_N": 0.05, "alpha_l": 0.01,
       "beta_l": 0.15, "gamma": 0.05}


def _noisy_rows(params, seed):
    rng = np.random.default_rng(seed)
    noise = lambda: 1.0 + NOISE * rng.standard_normal()  # noqa: E731
    sizes = [4 ** k for k in range(1, 14)]
    inter = [(s, tp.maxrate_message_cost(float(s), params, k) * noise(), k)
             for s in sizes for k in (1, 2)]
    intra = [(s, (params.alpha_l + params.beta_l * s) * noise())
             for s in sizes]
    gamma = [(s, (2e-6 + params.gamma * s) * noise())
             for s in (1 << (20 + 2 * k) for k in range(5))]
    return inter, intra, gamma


@pytest.mark.parametrize("seed", range(4))
def test_tool_fit_recovers_constants_from_noisy_rows(seed):
    inter, intra, gamma = _noisy_rows(CARD, seed)
    got = tool.fit_constants(inter, intra, gamma)
    assert got.name == tool.NAME
    for f, tol in TOL.items():
        assert getattr(got, f) == pytest.approx(getattr(IDENTIFIED, f),
                                                rel=tol), f


@pytest.mark.parametrize("which", ["inter", "intra", "gamma"])
def test_tool_fit_raises_on_rows_that_do_not_grow(which):
    inter, intra, gamma = _noisy_rows(CARD, 0)
    flat = {"inter": [(s, 1e-3 / s ** 0.1, k) for s, _, k in inter],
            "intra": [(s, 1e-3 / s ** 0.1) for s, _ in intra],
            "gamma": [(s, 1e-3 / s ** 0.1) for s, _ in gamma]}
    rows = {"inter": inter, "intra": intra, "gamma": gamma, which:
            flat[which]}
    with pytest.raises(ValueError, match="grow"):
        tool.fit_constants(rows["inter"], rows["intra"], rows["gamma"])


def test_injection_rate_from_the_wide_rows():
    # a node injecting at R_N < ppn * R_b: the k = 4 rows show it
    p = dataclasses.replace(CARD, R_N=CARD.R_b * 1.5)
    rows = _model_rows(tp.maxrate_message_cost, p, 4)
    assert tool.injection_rate(rows) == pytest.approx(p.R_N, rel=1e-9)
    # no k > 1 row: one lane's rate
    one = [r for r in rows if r[2] == 1]
    assert tool.injection_rate(one) == pytest.approx(CARD.R_b, rel=1e-9)


# ---------------------------------------------------------------------------
# (d) the default rule
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank_world(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _executable(kind: str):
    from repro_torch.launch import make_mesh
    from repro_torch.launch.mesh import mesh_topology

    mesh = make_mesh((1, 1), ("pod", "data"))
    return {"from_world": lambda: tc.Topology.from_world(1, 1),
            "from_mesh": lambda: tc.Topology.from_mesh(mesh),
            "from_axes": lambda: tc.Topology.from_axes("pod", "data",
                                                       mesh=mesh),
            "mesh_topology": lambda: mesh_topology(1, 1)}[kind]()


KINDS = ["from_world", "from_mesh", "from_axes", "mesh_topology"]


def test_planning_topology_keeps_the_reference_constants():
    assert tc.Topology.of(2, 2).params is tp.TPU_V5E_POD
    assert not dist.is_initialized()
    assert tc.world_params() is tp.TPU_V5E_POD
    assert tc.Topology.from_world(1, 1).params is tp.TPU_V5E_POD


@pytest.mark.parametrize("kind", KINDS)
def test_gloo_world_keeps_the_reference_constants(one_rank_world, kind):
    assert dist.get_backend() == "gloo"
    assert _executable(kind).params is tp.TPU_V5E_POD


@pytest.mark.parametrize("backend,want", [
    ("nccl", "card"), ("cpu:gloo,cuda:nccl", "card"), ("gloo", "ref"),
    ("cpu:gloo,cuda:gloo", "ref"), ("fake", "ref")])
@pytest.mark.parametrize("kind", KINDS)
def test_nccl_world_takes_the_card_constants(one_rank_world, monkeypatch,
                                             kind, backend, want):
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    got = _executable(kind).params
    assert got is (CARD if want == "card" else tp.TPU_V5E_POD)
    # planning and given constants are untouched by the world
    assert tc.Topology.of(2, 2).params is tp.TPU_V5E_POD
    assert tc.Topology.from_world(1, 1, params=tp.BLUE_WATERS).params \
        is tp.BLUE_WATERS


def test_spmd_lint_keeps_the_reference_constants(one_rank_world,
                                                 monkeypatch):
    from repro_torch.analysis import spmd_lint

    monkeypatch.setattr(dist, "get_backend",
                        lambda group=None: "cpu:gloo,cuda:nccl")
    seen = []

    def program(topo, x):
        seen.append(topo.params)
        return tc.CommContext(topo).allreduce(x)

    spmd_lint.trace_ranks(program, torch.ones(8), n_nodes=2, ppn=2)
    assert seen and all(p is tp.TPU_V5E_POD for p in seen)


# ---------------------------------------------------------------------------
# (e) a rehearsal of the tool
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lines():
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "fit_machine_4gpu.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=240,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(v) for v in out.stdout.splitlines() if v.strip()]


#: the constants the validation prices every engine under
SETS = ("fitted", "package", "tpu_v5e_pod")


def _of(lines, check):
    return [r for r in lines if r.get("check") == check]


def test_rehearsal_lines_parse_and_end_ok(lines):
    last = lines[-1]
    assert last["ok"] and last["failed"] == [] and last["device"] == "cpu"
    assert set(last["constants"]) == set(FIELDS) | {"name"}
    assert last["constants"]["name"] == "gloo_rehearsal"
    assert all(math.isfinite(last["constants"][f]) for f in FIELDS)
    assert last["constants_device_clock"] is None  # no events on the CPU
    assert set(last["regret"]) == {"2x2", "4x1", "1x4"}
    for name, grid in last["regret"].items():
        assert set(grid) == set(SETS)
        for by in grid.values():
            assert set(by) == ({"auto"} if name == "1x4"
                               else {"auto", "ranked"})
            assert all(v["sizes"] == len(tool.CPU_SIZES["payloads"])
                       for v in by.values())


def test_rehearsal_message_rows(lines):
    rows = _of(lines, "message_row")
    kinds = {(r["grid"], r["level"], r["k"]) for r in rows}
    assert kinds == {("2x2", "inter", 1), ("2x2", "inter", 2),
                     ("2x2", "intra", 1), ("4x1", "inter", 1),
                     ("1x4", "intra", 1)}
    assert len(rows) == len(kinds) * len(tool.CPU_SIZES["payloads"])
    for r in rows:
        assert r["host_ms"] > 0 and r["device_ms"] is None
        lo, hi = r["host_ms_spread"]
        assert lo <= r["host_ms"] <= hi and len(r["host_ms_by_rank"]) == 4
    assert len(_of(lines, "gamma_row")) == len(tool.CPU_SIZES["gamma"])


def test_rehearsal_fit_and_validation(lines):
    [fit] = _of(lines, "fit")
    assert fit["constants"] == lines[-1]["constants"]
    assert set(fit["fits_by_grid"]) == {"4x1"}  # the slow level alone
    assert "error" not in fit
    assert len(fit["inter_residuals"]) == 2 * len(tool.CPU_SIZES["payloads"])
    rows = _of(lines, "validation")
    assert len(rows) == 3 * len(tool.CPU_SIZES["payloads"])
    admitted = {"2x2": {"psum", "nap", "mla", "mla_pipelined", "rd", "smp"},
                "4x1": {"psum", "mla", "rd", "smp"},
                "1x4": {"psum", "rd", "smp"}}
    for r in rows:
        assert {k.split("/")[0] for k in r["engines"]} == admitted[r["grid"]]
        for e in r["engines"].values():
            assert e["host_ms"] > 0
            assert all(e[f"predicted_ms_{k}"] > 0 for k in SETS)
        for k in SETS:
            assert r[f"pick_{k}"] in r["engines"]
            assert r[f"regret_{k}"] >= 0
            # 1x4 has no engine the tournament ranks: psum is the fallback
            ranked = r[f"regret_ranked_{k}"]
            assert (ranked is None) == (r["grid"] == "1x4")
            assert ranked is None or ranked >= 0
