"""The port's layer-0 protocol model checker, on the port's scheduler,
router and replica health: the counterparts of the reference's
``tests/test_protocol_check.py`` (seeded mutations caught with replayable
minimal traces, full small-scope closure, deterministic replay, the decode
geometry link, the regression traces), and the first three scopes of the
small-scope grid, which must give exactly the reference's canonical state
counts (230, 3,591, 9,890) with no violation.  The fourth scope (77,796
states) takes about 100 s on a CPU core and is run by hand.
"""

import dataclasses

import pytest

from repro.analysis import protocol_check as jpc
from repro_torch.analysis import protocol_check as pc
from repro_torch.runtime.fault import ReplicaHealth
from repro_torch.serve.router import Router
from repro_torch.serve.scheduler import ACTIVE, EVICTED, QUEUED, Scheduler


# ---------------------------------------------------------------------------
# seeded protocol bugs (never shipped — they exist to prove the checker
# would catch them)
# ---------------------------------------------------------------------------


class DoubleAdmitScheduler(Scheduler):
    """Seeded bug: admit reads the lowest free slot but never removes
    it from the free list, so two requests land in the same slot."""

    def admit(self, *, now=0.0):
        admitted = []
        while self._free and self.queue:
            req = self.queue.popleft()
            slot = self._free[0]  # bug: slot never popped from _free
            req.slot = slot
            req.state = ACTIVE
            req.admitted_at = now
            self.slots[slot] = req
            admitted.append(req)
        return admitted


class SlotLeakScheduler(Scheduler):
    """Seeded bug: evicting an ACTIVE request empties the slot but
    never returns it to the free list."""

    def _release(self, req, state, *, now):
        if state == EVICTED:
            slot = req.slot
            self.slots[slot] = None
            req.slot = None
            req.state = state
            req.finished_at = now
            # bug: self._free never gets the slot back
        else:
            super()._release(req, state, now=now)


class DropOnDrainScheduler(Scheduler):
    """Seeded bug: draining the queue silently loses the newest
    queued request (it stays QUEUED but is held by no container)."""

    def drain_queue(self):
        out = list(self.queue)[:-1]
        self.queue.clear()
        for req in out:
            self.requests.pop(req.rid, None)
        return out


class RerouteActiveRouter(Router):
    """Seeded bug: reroute also moves ACTIVE requests, demoting them
    to QUEUED without releasing their slot (their KV state stays on
    the degraded replica)."""

    def reroute(self, replica):
        moved = super().reroute(replica)
        src = self.replicas[replica].scheduler
        peers = [i for i in self._eligible() if i != replica]
        for req in list(src.active()):
            req.state = QUEUED  # bug: slot not released, KV orphaned
            self.replicas[peers[0]].scheduler.enqueue(req, force=True)
        return moved


class OffByOneHealth(ReplicaHealth):
    """Seeded bug: recovery demands one clean step too many."""

    def record(self, step, duration):
        event = self.monitor.record(step, duration)
        if event is not None:
            if self.healthy:
                self.n_degraded += 1
            self.healthy = False
            self._clean = 0
        elif not self.healthy:
            self._clean += 1
            if self._clean > self.recovery:  # bug: > instead of >=
                self.healthy = True
                self._clean = 0
        return self.healthy


_SMALL = pc.CheckConfig(
    replicas=2, slots=1, queue=1, requests=2, budgets=(2, 1),
    recovery=2, depth=8,
)

_MUTANTS = [
    ("double-admit", dict(scheduler_cls=DoubleAdmitScheduler),
     {"conservation", "slot-accounting", "fifo"}),
    ("slot-leak-on-evict", dict(scheduler_cls=SlotLeakScheduler),
     {"slot-accounting"}),
    ("lost-queued-on-drain", dict(scheduler_cls=DropOnDrainScheduler),
     {"conservation"}),
    ("reroute-active", dict(router_cls=RerouteActiveRouter),
     {"conservation", "slot-accounting", "ownership"}),
    # the quiesce drain exercises recovery before BFS reaches a bare
    # recover event, so the boundary bug may surface as a liveness
    # violation whose detail names the nested hysteresis failure
    ("recovery-off-by-one", dict(health_cls=OffByOneHealth),
     {"hysteresis", "liveness"}),
]


@pytest.mark.parametrize(
    "name,classes,rules", _MUTANTS, ids=[m[0] for m in _MUTANTS]
)
def test_seeded_mutation_is_caught_with_replayable_trace(
    name, classes, rules
):
    report = pc.check_protocol(_SMALL, max_violations=1, **classes)
    assert not report.ok, f"checker missed seeded bug {name!r}"
    v = report.violations[0]
    assert v.rule in rules, (name, v.rule, v.detail)
    if name == "recovery-off-by-one":
        assert "hysteresis" in v.detail or v.rule == "hysteresis"
    # the emitted counterexample replays deterministically against the
    # same mutant and reproduces the same rule
    pc.assert_trace_violates(_SMALL, v.trace, v.rule, **classes)
    # ... and it doubles as a pytest
    assert "assert_trace_clean" in v.pytest_snippet()


def test_counterexample_trace_is_minimal():
    report = pc.check_protocol(
        _SMALL, max_violations=1, scheduler_cls=SlotLeakScheduler
    )
    trace = report.violations[0].trace
    rule = report.violations[0].rule
    # 1-minimality: removing any single event kills the violation
    for i in range(len(trace)):
        cand = trace[:i] + trace[i + 1:]
        try:
            vs = pc.run_trace(
                _SMALL, cand, scheduler_cls=SlotLeakScheduler
            )
        except pc.TraceNotApplicable:
            continue
        assert not any(v.rule == rule for v in vs), (
            f"dropping event {i} of {trace} still violates {rule}"
        )


def test_clean_protocol_full_small_scope_closure():
    # full closure (no depth cap): every reachable state of the real
    # control plane at this scope, zero violations
    cfg = pc.CheckConfig(
        replicas=2, slots=1, queue=1, requests=2, budgets=(2, 1),
        recovery=2, depth=None,
    )
    report = pc.check_protocol(cfg)
    assert report.ok, report.violations[0].to_row()
    assert report.complete
    assert report.states > 100
    assert report.occupancies == (0, 1)


def test_deterministic_bit_identical_replay():
    # same events, two fresh worlds: canonical states and placements
    # must agree exactly (Router placement never depends on dict/set
    # iteration order)
    cfg = pc.CheckConfig(
        replicas=3, slots=1, queue=2, requests=4, budgets=(2, 1),
        recovery=2,
    )
    trace = (
        ("submit",), ("submit",), ("degrade", 0), ("submit",),
        ("admit", 1), ("token", 1, 0), ("recover", 0), ("recover", 0),
        ("submit",), ("loss", 2), ("admit", 0),
    )
    worlds = []
    for _ in range(2):
        w = pc.World(cfg)
        for ev in trace:
            w.apply(ev)
        worlds.append(w)
    a, b = worlds
    assert a.canonical() == b.canonical()

    def placement_by_submission(w):
        # rids are process-global, so key placement by submission index
        return {
            k: w.router.placement.get(req.rid)
            for k, req in enumerate(w.submitted)
        }

    assert placement_by_submission(a) == placement_by_submission(b)
    assert a.router.loads() == b.router.loads()


def test_decode_geometry_link():
    # the occupancies the protocol admits are exactly the ragged slot
    # geometry the engine's decode slice runs at
    link = pc.verify_decode_geometry_link(8, 8)
    assert link["ok"]
    assert link["admissible_occupancies"] == list(range(9))
    assert link["b_max"] == max(link["geometry"])
    with_remainder = pc.verify_decode_geometry_link(5, 3)
    assert with_remainder["geometry"] == [2, 2, 1]
    assert with_remainder["b_max"] == 2


# ---------------------------------------------------------------------------
# regression traces: the checker's own pre-fix counterexamples
# ---------------------------------------------------------------------------


def test_regression_reroute_kept_stale_ownership():
    # pre-fix: drain_queue left the drained rid in the source
    # scheduler's registry, so after (submit, degrade) the live rid was
    # registered with both replicas — the 'ownership' violation whose
    # concrete harm is the stale-evict crash below
    pc.assert_trace_clean(_SMALL, (("submit",), ("degrade", 0)))


def test_regression_reroute_rejected_accepted_request():
    # pre-fix: rerouting into a full peer queue flipped an accepted
    # (QUEUED) request to REJECTED — the 'acceptance' violation; now
    # the request stays on the degraded replica when no peer has room
    cfg = pc.CheckConfig(
        replicas=2, slots=1, queue=1, requests=3, budgets=(2, 1),
        recovery=2, depth=8,
    )
    pc.assert_trace_clean(cfg, (("submit",), ("submit",), ("degrade", 0)))
    pc.assert_trace_clean(cfg, (("submit",), ("submit",), ("degrade", 1)))


def test_regression_evict_after_reroute_goes_to_real_owner():
    # pre-fix: evicting through the stale owner crashed in
    # deque.remove; now ownership moved with the reroute and the evict
    # succeeds through the new owner
    pc.assert_trace_clean(
        _SMALL, (("submit",), ("degrade", 0), ("evict", 0, 1))
    )


def test_regression_replica_loss_drains_into_replan():
    # replica death mid-flight: queued and active requests must drain
    # into a re-plan on the survivor, never a stall 
    cfg = pc.CheckConfig(
        replicas=2, slots=2, queue=2, requests=3, budgets=(2, 1),
        recovery=2,
    )
    pc.assert_trace_clean(
        cfg,
        (("submit",), ("submit",), ("admit", 0), ("token", 0, 0),
         ("submit",), ("loss", 0)),
    )


def _reference_grid():
    from repro.analysis.__main__ import _protocol_grid

    return _protocol_grid()


@pytest.mark.parametrize("scope", [0, 1, 2])
def test_protocol_grid_state_counts(scope):
    cfg, states = pc.PROTOCOL_GRID[scope]
    report = pc.check_protocol(cfg)
    assert report.ok, report.violations[0].to_row()
    assert report.states == states
    # the same scope and count as the reference's grid
    jcfg, jstates = _reference_grid()[scope]
    assert jstates == states
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)


def test_protocol_grid_matches_reference_scopes():
    assert len(pc.PROTOCOL_GRID) == len(_reference_grid()) == 4
    assert pc.PROTOCOL_GRID[3][1] == _reference_grid()[3][1] == 77796
    assert dataclasses.asdict(_reference_grid()[3][0]) == (
        dataclasses.asdict(pc.PROTOCOL_GRID[3][0]))
