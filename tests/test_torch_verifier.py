"""The port's schedule verifier, baseline and RS / AG schedules, costs,
dispatch and simulator against the JAX package's, with no ranks.

Pure host-side code on both sides: equal inputs must give equal outputs
(schedules array for array, costs to a relative 1e-12, dispatch decisions
and simulated times exactly, verifier reports row for row).  The
reference's engine registry is the JAX package's own
(``repro.core.comm``), imported beside the port's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

from repro.analysis import schedule_verifier as jsv
from repro.core import comm as jc
from repro.core import extensions as jx
from repro.core import napalg as jn
from repro.core import perf_model as jp
from repro.core import simulator as jsim
from repro_torch.analysis import schedule_verifier as tsv
from repro_torch.core import comm as tc
from repro_torch.core import extensions as tx
from repro_torch.core import napalg as tn
from repro_torch.core import perf_model as tp
from repro_torch.core import simulator as tsim

NS = (1, 2, 3, 4, 5, 6, 7, 8, 13, 16)
GRIDS = [(n, ppn) for n in NS for ppn in range(1, 5)]
SIZES = (8, 100, 4096, 65_536, 1 << 20, 1 << 24, 3 * (1 << 26))
ELEMS = (None, 1, 7, 19, 96, 193, 1000)


def _params(params):
    return tp.MachineParams(**dataclasses.asdict(params))


def _rel_equal(a, b, rel=1e-12):
    assert a == pytest.approx(b, rel=rel, abs=0.0)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_the_twelve_engines_are_registered_as_in_the_reference():
    theirs = jc.registered_engines()
    ours = tc.registered_engines()
    assert list(ours) == list(theirs)
    assert len(ours) == 12
    for key, spec in ours.items():
        ref = theirs[key]
        for f in ("name", "collective", "ops", "regime", "min_nodes",
                  "min_ppn", "chunked", "ragged", "pipelined_variant"):
            assert getattr(spec, f) == getattr(ref, f), (key, f)
        assert (spec.cost is None) == (ref.cost is None), key
        assert (spec.build_schedule is None) == (
            ref.build_schedule is None), key
        assert spec.describe() == ref.describe()
    assert tc.COLLECTIVES == jc.COLLECTIVES


@pytest.mark.parametrize("n,ppn", GRIDS)
def test_engine_schedules_equal(n, ppn):
    for key, spec in tc.registered_engines().items():
        if spec.build_schedule is None:
            continue
        if n < spec.min_nodes or ppn < spec.min_ppn:
            continue
        for elems in ELEMS:
            for chunks in ((1, 2, 3) if spec.chunked else (1,)):
                t = tc.engine_schedule(spec.name, n, ppn, chunks=chunks,
                                       elems=elems)
                j = jc.engine_schedule(spec.name, n, ppn, chunks=chunks,
                                       elems=elems)
                assert dataclasses.asdict(t) == dataclasses.asdict(j), key
                assert tc.Topology.of(n, ppn).schedule(
                    spec.name, chunks=chunks, elems=elems) == t
                assert [dataclasses.asdict(m) for m in tn.iter_messages(t)] \
                    == [dataclasses.asdict(m) for m in jn.iter_messages(j)]
                if isinstance(t, tn.P2PSchedule):
                    for a, b in zip(tn.p2p_recv_masks(t),
                                    jn.p2p_recv_masks(j)):
                        np.testing.assert_array_equal(a, b)
                    assert t.max_internode_messages_per_chip() == (
                        j.max_internode_messages_per_chip())
                else:
                    assert tn.message_counts(t) == jn.message_counts(j)
                for s in (1.0, 4096.0):
                    assert t.max_internode_bytes_per_chip(s) == (
                        j.max_internode_bytes_per_chip(s))


@pytest.mark.parametrize("n,ppn", GRIDS)
def test_topology_has_slow_domain_equal(n, ppn):
    assert tc.Topology.of(n, ppn).has_slow_domain == (
        jc.Topology.of(n, ppn).has_slow_domain)


@pytest.mark.parametrize("n,ppn", GRIDS)
def test_topology_geometry_equal(n, ppn):
    tt_, jt_ = tc.Topology.of(n, ppn), jc.Topology.of(n, ppn)
    for elems in (0, 1, 7, 19, 1000, 12345):
        assert tt_.stripe_geometry(elems) == jt_.stripe_geometry(elems)
        for chunks in (0, 1, 3):
            assert tt_.chunk_splits(elems, chunks) == (
                jt_.chunk_splits(elems, chunks))
            assert tt_.chunk_offsets(elems, chunks) == (
                jt_.chunk_offsets(elems, chunks))
        for coll in tc.COLLECTIVES:
            assert tt_.internode_lower_bound(elems, coll) == (
                jt_.internode_lower_bound(elems, coll))
    with pytest.raises(ValueError):
        tt_.internode_lower_bound(7, "broadcast")


# ---------------------------------------------------------------------------
# costs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,ppn", GRIDS)
def test_costs_equal(n, ppn):
    for params in (jp.TPU_V5E_POD, jp.BLUE_WATERS):
        tpar = _params(params)
        for s in SIZES:
            for name in ("cost_smp", "cost_reduce_scatter", "cost_allgather",
                         "cost_reduce_scatter_flat", "cost_allgather_flat",
                         "cost_rd", "cost_nap", "cost_mla", "cost_psum"):
                _rel_equal(getattr(tp, name)(s, n, ppn, tpar),
                           getattr(jp, name)(s, n, ppn, params))
            for ratio in (1 / 4, 1 / 8):
                _rel_equal(tp.cost_mla_compressed(s, n, ppn, tpar, ratio),
                           jp.cost_mla_compressed(s, n, ppn, params, ratio))
            for t, c in ((1, 0), (3, 7.0), (n, s)):
                _rel_equal(tp.postal_cost(t, s, c, tpar),
                           jp.postal_cost(t, s, c, params))
        for large in ("smp", "mla", "rd"):
            assert tp.crossover_bytes(n, ppn, tpar, large=large) == (
                jp.crossover_bytes(n, ppn, params, large=large))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,ppn", GRIDS)
def test_select_engine_equal_for_every_collective(n, ppn):
    jt_, tt_ = jc.Topology.of(n, ppn), tc.Topology.of(n, ppn)
    for coll in tc.COLLECTIVES:
        for s in SIZES:
            for op in ("sum", "max", "min", "prod"):
                for thr in (None, 0, 4096):
                    kw = dict(collective=coll, small_threshold_bytes=thr)
                    try:
                        want = tuple(jc.select_engine(jt_, s, op, **kw))
                    except NotImplementedError:
                        with pytest.raises(NotImplementedError):
                            tc.select_engine(tt_, s, op, **kw)
                        continue
                    assert tuple(tc.select_engine(tt_, s, op, **kw)) == want


def test_context_dispatch_equal():
    for n, ppn in [(1, 4), (2, 2), (4, 1), (3, 2), (8, 4)]:
        jctx = jc.CommContext(jc.Topology.of(n, ppn))
        tctx = tc.CommContext(tc.Topology.of(n, ppn))
        for coll in tc.COLLECTIVES:
            for s in SIZES:
                assert tuple(tctx.dispatch(s, collective=coll)) == tuple(
                    jctx.dispatch(s, collective=coll))
        for algo in ("rd", "smp", "ring", "rabenseifner"):
            pol_j = jc.CommPolicy(algorithm=algo)
            pol_t = tc.CommPolicy(algorithm=algo)
            assert tuple(tc.CommContext(tc.Topology.of(n, ppn), pol_t)
                         .dispatch(4096)) == tuple(
                jc.CommContext(jc.Topology.of(n, ppn), pol_j).dispatch(4096))
    with pytest.raises(ValueError, match="registered engines"):
        tc.CommContext(tc.Topology.of(2, 2)).dispatch(
            8, collective="reduce_scatter", algorithm="nap")


# ---------------------------------------------------------------------------
# simulator
# ---------------------------------------------------------------------------


SIM_GRIDS = [(2, 2), (3, 2), (4, 4), (5, 3), (6, 1), (7, 2), (13, 4)]


@pytest.mark.parametrize("n,ppn", SIM_GRIDS)
def test_simulator_equal(n, ppn):
    for params in (jp.TPU_V5E_POD, jp.BLUE_WATERS):
        tpar = _params(params)
        ttop = tc.Topology.of(n, ppn, params=tpar)
        jtop = jc.Topology.of(n, ppn, params=params)
        for name, spec in tc.registered_engines("allreduce").items():
            if spec.build_schedule is None or n < spec.min_nodes \
                    or ppn < spec.min_ppn:
                continue
            for s in (64.0, 1e6):
                for elems in (None, 193):
                    kw = dict(elems=elems)
                    assert tsim.simulate_algorithm(name, n, ppn, s, tpar,
                                                   **kw) == (
                        jsim.simulate_algorithm(name, n, ppn, s, params, **kw))
                    assert tsim.simulate_collective(ttop, name, s, **kw) == (
                        jsim.simulate_collective(jtop, name, s, **kw))
                    assert tsim.internode_bytes_per_chip(
                        name, n, ppn, s, **kw) == jsim.internode_bytes_per_chip(
                        name, n, ppn, s, **kw)
        for name in ("mla_rs", "mla_ag"):
            for elems in (None, 7, 193):
                t = tsim.simulate_algorithm(name, n, ppn, 1e5, tpar,
                                            elems=elems)
                assert t == jsim.simulate_algorithm(name, n, ppn, 1e5, params,
                                                    elems=elems)
                np.testing.assert_array_equal(
                    tsim.replay_internode_bytes(
                        tc.engine_schedule(name, n, ppn, elems=elems), 4.0),
                    jsim.replay_internode_bytes(
                        jc.engine_schedule(name, n, ppn, elems=elems), 4.0))
        rows = [(4096, "nap" if ppn > 1 else "mla", 1, None),
                (1 << 22, "mla_pipelined" if ppn > 1 else "mla", 3, 1 << 20),
                (1 << 20, "mla", 1, 1 << 18, 1 << 22),
                (256, "psum", 1, None)]
        for overlap in (True, False):
            for ct in (None, [0.0, 1e-4, 2e-4, 3e-4]):
                assert tsim.simulate_bucketed_sync(
                    rows, n, ppn, tpar, compute_times=ct, overlap=overlap
                ) == jsim.simulate_bucketed_sync(
                    rows, n, ppn, params, compute_times=ct, overlap=overlap)


# ---------------------------------------------------------------------------
# the schedule verifier
# ---------------------------------------------------------------------------


def test_verifier_constants_equal():
    assert tsv.GRID_MATRIX == jsv.GRID_MATRIX
    assert tsv.PAYLOAD_ELEMS == jsv.PAYLOAD_ELEMS
    assert tsv.REGISTER_GRIDS == jsv.REGISTER_GRIDS
    assert tsv.RULES == jsv.RULES
    assert tsv.STRIPED_KINDS == jsv.STRIPED_KINDS


@pytest.mark.parametrize("key", list(tc.registered_engines()))
def test_verify_spec_grid_has_no_violation_and_matches_the_reference(key):
    ours = tsv.verify_spec_grid(tc.registered_engines()[key])
    theirs = jsv.verify_spec_grid(jc.registered_engines()[key])
    assert [r.to_row() for r in ours] == [r.to_row() for r in theirs]
    assert all(r.ok for r in ours)
    assert len(ours) == len(tsv.GRID_MATRIX) * len(tsv.PAYLOAD_ELEMS) * (
        3 if tc.registered_engines()[key].chunked else 1)


@pytest.mark.parametrize("name", [k.split(":")[1]
                                  for k in tc.registered_engines()])
def test_verify_engine_reports_no_violation(name):
    reports = tc.verify_engine(name)
    assert [r.to_row() for r in reports] == [
        r.to_row() for r in jc.verify_engine(name)]
    assert len(reports) == len(tsv.REGISTER_GRIDS)
    assert all(r.ok for r in tc.verify_engine(name, n_nodes=7, ppn=3,
                                              elems=193))
    assert all(r.ok for r in tc.verify_engine(
        name, tc.Topology.of(4, 4), elems=96))


def test_verifier_catches_a_duplicated_message():
    """A schedule with one inter-node message sent twice double counts a
    node partial: the reduction pass must say so, as the reference's."""
    good = tn.build_rd_schedule(4, 2)
    steps = list(good.steps)
    steps.append(tn.P2PStep(steps[-1].pairs[:1]))
    bad = dataclasses.replace(good, steps=tuple(steps))
    r = tsv.verify_schedule(bad, engine="rd")
    j = jsv.verify_schedule(
        dataclasses.replace(jn.build_rd_schedule(4, 2), steps=tuple(
            list(jn.build_rd_schedule(4, 2).steps)
            + [jn.P2PStep(jn.build_rd_schedule(4, 2).steps[-1].pairs[:1])])),
        engine="rd")
    assert not r.ok and r.to_row() == j.to_row()
    assert "reduction" in {v.rule for v in r.violations}


# ---------------------------------------------------------------------------
# extensions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,ppn", GRIDS)
def test_extensions_supported(n, ppn):
    if n > 1 and ppn < 2:
        # the reference answers True and its NAP schedule then raises
        assert not tx.supported(n, ppn) and jx.supported(n, ppn)
        with pytest.raises(ValueError):
            jn.build_nap_schedule(n, ppn)
        return
    assert tx.supported(n, ppn) == jx.supported(n, ppn)


def test_costs_of_the_baselines_order_as_the_paper_says():
    """Paper §IV at Blue Waters scale: NAP beats SMP and RD for small
    messages, SMP beats RD for large ones."""
    p = tp.BLUE_WATERS
    n, ppn = 2048, 16
    assert tp.cost_nap(64, n, ppn, p) < tp.cost_smp(64, n, ppn, p)
    assert tp.cost_nap(64, n, ppn, p) < tp.cost_rd(64, n, ppn, p)
    assert tp.cost_smp(1 << 20, n, ppn, p) < tp.cost_rd(1 << 20, n, ppn, p)
    assert math.isfinite(tp.cost_reduce_scatter(1 << 20, n, ppn, p))
