"""Layer 0 of the proof chain: exhaustive protocol model checking for
the serving control plane.

The port of ``repro/analysis/protocol_check.py``, retargeted onto the
port's control-plane objects.  The schedule verifier (layer 1) proves the
collectives *below* the decode-step boundary.  This module extends the
chain downward to the host protocol that fires those collectives: an
explicit-state, bounded exhaustive model checker that drives the **real**
control-plane objects —
:class:`repro_torch.serve.scheduler.Scheduler`,
:class:`repro_torch.serve.router.Router`,
:class:`repro_torch.runtime.fault.ReplicaHealth` /
:class:`~repro_torch.runtime.fault.StragglerMonitor` — through every
interleaving of a nondeterministic event alphabet, with no re-modeling:
a checker bug cannot hide a product bug behind an idealized model,
because there is no model.

Event alphabet (one event = one atomic control-plane call, exactly what
the engine / router / driver perform between decode slices)::

    ("submit",)          router.submit() — admission or backpressure-reject
    ("admit", r)         decode-step boundary admission on replica r
    ("token", r, s)      one generated (non-EOS) token for slot s
    ("eos", r, s)        EOS token for slot s (early finish)
    ("evict", k, r)      cancel submission k through replica r's registry
    ("degrade", r)       straggler signal -> ReplicaHealth degraded (+ reroute)
    ("recover", r)       one clean step toward recovery hysteresis
    ("reroute", r)       explicit router.reroute of a degraded replica
    ("loss", r)          replica death -> router.fail_replica re-plan

State-space machinery:

* **canonical state hashing** — worlds are deduped by a canonical tuple
  with *symmetry reduction over request ids*: live requests are
  renumbered in structural scan order (replica index, queue position,
  slot index), so states that differ only by rid relabeling merge; and
  **terminal collapse**: finished/evicted/rejected requests have no
  future protocol behavior, so they fold into per-class counts.
* **breadth-first exploration** — the first counterexample found is at
  minimal event depth, then :func:`shrink_trace` delta-debugs it to a
  locally-minimal replayable trace.

At every reachable state the checker asserts **safety**:

* conservation — each submitted rid is in exactly one of
  queued/active/finished/evicted/rejected across **all** replicas, and
  sits in exactly the container its state names;
* ownership — a live rid is registered with exactly one replica (a
  stale second registry entry is how evict races a reroute);
* slot accounting — ``Scheduler.check_invariants`` at every state;
* FIFO — admission takes exactly the queue head into the lowest free
  slot, and no queue is ever reordered by a reroute/drain;
* acceptance is binding — a request that was ever QUEUED is never
  later REJECTED (backpressure happens at submit, not mid-flight);
* placement — the router's ``placement`` map points at the replica
  actually holding each live request;
* silence after terminal states — a terminal request's token list
  never grows, its slot is released, its remaining budget is 0;
* hysteresis — ``ReplicaHealth`` recovers after exactly ``recovery``
  consecutive clean steps, not one early or late;

and **quiescence-style liveness**: from every reachable state,
stop-admissions plus drain events (recover, admit, token) must reach
``idle`` — no stuck slot, no request stranded on a degraded or lost
replica.

Any violation is emitted as a minimal replayable event trace that
doubles as a pytest (:func:`assert_trace_clean` /
:func:`assert_trace_violates` replay it against fixed or seeded-buggy
control planes).

Quickstart::

    from repro_torch.analysis import protocol_check as pc

    report = pc.check_protocol(pc.CheckConfig(replicas=2, slots=2,
                                              queue=1, requests=4))
    assert report.ok, report.violations[0].detail
    # a seeded bug is rejected with a replayable counterexample:
    bad = pc.check_protocol(cfg, scheduler_cls=LeakyScheduler)
    print(bad.violations[0].trace)   # paste into a regression test

:data:`PROTOCOL_GRID` is the small-scope grid with its canonical state
counts.  This module imports :mod:`repro_torch.serve` only inside
functions: the analysis package stays torch-free at module scope.
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter

__all__ = [
    "CheckConfig",
    "CheckReport",
    "Violation",
    "World",
    "check_protocol",
    "run_trace",
    "shrink_trace",
    "quiesce",
    "assert_trace_clean",
    "assert_trace_violates",
    "verify_decode_geometry_link",
    "TraceNotApplicable",
    "PROTOCOL_GRID",
]

# request lifecycle states, mirrored as literals so this module stays
# import-free at module scope (importing repro_torch.serve pulls in
# torch via the engine); World.__init__ asserts they match the real constants
_QUEUED = "queued"
_ACTIVE = "active"
_FINISHED = "finished"
_EVICTED = "evicted"
_REJECTED = "rejected"

#: clean / straggling step durations fed to the real StragglerMonitor.
#: All clean steps are exactly the EWMA baseline, so the monitor's EWMA
#: is a constant of the exploration (straggler outliers are quarantined
#: by the monitor itself) and canonical hashing stays exact.
_CLEAN_DT = 1.0
_STRAGGLE_DT = 10.0


class TraceNotApplicable(Exception):
    """Raised when replaying an event that is not enabled in the
    current state (shrinking may produce such candidates)."""


class ProtocolError(Exception):
    """A named protocol-rule violation detected while applying an event."""

    def __init__(self, rule: str, detail: str):
        super().__init__(f"{rule}: {detail}")
        self.rule = rule
        self.detail = detail


@dataclasses.dataclass(frozen=True)
class CheckConfig:
    """Small-scope bounds for one exhaustive exploration."""

    replicas: int = 2        #: serving replicas behind the Router
    slots: int = 1           #: decode slots per replica
    queue: int | None = 1    #: per-replica max_queue (None = unbounded)
    requests: int = 3        #: total submission budget
    budgets: tuple[int, ...] = (2, 1)  #: max_new_tokens, cycled by index
    recovery: int = 2        #: ReplicaHealth recovery hysteresis
    eos_id: int = 7          #: EOS token id
    depth: int | None = None  #: max event depth (None = full closure)
    faults: bool = True      #: include degrade/recover/reroute events
    losses: bool = True      #: include replica-loss events (needs faults)
    liveness: bool = True    #: quiescence drain from every reachable state


@dataclasses.dataclass
class Violation:
    """One protocol violation with its replayable counterexample."""

    rule: str
    detail: str
    trace: tuple
    config: CheckConfig

    def to_row(self) -> dict:
        return {
            "rule": self.rule,
            "detail": self.detail,
            "trace": [list(e) for e in self.trace],
        }

    def pytest_snippet(self) -> str:
        """A paste-ready regression test replaying this trace."""
        events = ",\n        ".join(repr(e) for e in self.trace)
        cfg = ", ".join(
            f"{f.name}={getattr(self.config, f.name)!r}"
            for f in dataclasses.fields(self.config)
        )
        return (
            f"def test_regression_{self.rule.replace('-', '_')}():\n"
            f"    from repro_torch.analysis import protocol_check as pc\n"
            f"    pc.assert_trace_clean(pc.CheckConfig({cfg}), (\n"
            f"        {events},\n"
            f"    ))  # violated {self.rule!r} before the fix\n"
        )


class _Replica:
    """The replica surface :class:`repro_torch.serve.router.Router` documents
    (``submit`` / ``outstanding_tokens`` / ``scheduler``) over a real
    :class:`Scheduler` — the device plane abstracted to exactly its
    scheduler effects, the control plane fully real."""

    __slots__ = ("scheduler",)

    def __init__(self, scheduler):
        self.scheduler = scheduler

    def submit(self, prompt, max_new_tokens, **kw):
        return self.scheduler.submit(prompt, max_new_tokens, **kw)

    def outstanding_tokens(self):
        return self.scheduler.outstanding_tokens()

    @property
    def idle(self):
        return self.scheduler.idle


def _clone_request(req, memo):
    c = memo.get(req.rid)
    if c is None:
        c = object.__new__(type(req))
        c.__dict__.update(req.__dict__)
        c.generated = list(req.generated)
        c.token_times = list(req.token_times)
        memo[req.rid] = c
    return c


class World:
    """One explorable control-plane state: a real Router over real
    Schedulers with real health monitors, plus the checker's harness
    bookkeeping (submission order, acceptance, frozen token counts)."""

    def __init__(
        self,
        cfg: CheckConfig,
        *,
        scheduler_cls=None,
        router_cls=None,
        health_cls=None,
        monitor_cls=None,
        _blank: bool = False,
    ):
        from repro_torch.runtime.fault import ReplicaHealth, StragglerMonitor
        from repro_torch.serve import scheduler as _sched_mod
        from repro_torch.serve.router import Router

        assert (_QUEUED, _ACTIVE, _FINISHED, _EVICTED, _REJECTED) == (
            _sched_mod.QUEUED, _sched_mod.ACTIVE, _sched_mod.FINISHED,
            _sched_mod.EVICTED, _sched_mod.REJECTED,
        )
        self.cfg = cfg
        self._scheduler_cls = scheduler_cls or _sched_mod.Scheduler
        self._router_cls = router_cls or Router
        self._health_cls = health_cls or ReplicaHealth
        self._monitor_cls = monitor_cls or StragglerMonitor
        if _blank:
            return
        replicas = [
            _Replica(
                self._scheduler_cls(
                    cfg.slots, max_queue=cfg.queue, eos_id=cfg.eos_id
                )
            )
            for _ in range(cfg.replicas)
        ]
        health = [
            self._health_cls(
                self._monitor_cls(threshold=2.0, alpha=0.5, warmup=1),
                recovery=cfg.recovery,
            )
            for _ in range(cfg.replicas)
        ]
        self.router = self._router_cls(replicas, health=health)
        self.lost: set[int] = set()
        self.submitted: list = []     # Request objects, submission order
        self.n_submitted = 0
        self.accepted: set[int] = set()   # rids that were ever QUEUED
        self.frozen: dict[int, int] = {}  # rid -> len(generated) at terminal
        self.trace: tuple = ()
        self._step_no = 0
        # pre-warm every straggler monitor past warmup with baseline
        # steps so degrade/recover signals are live from depth 0
        for r in range(cfg.replicas):
            for _ in range(2):
                self.router.observe_step(r, self._next_step(), _CLEAN_DT)

    # -- plumbing ----------------------------------------------------------

    def _next_step(self) -> int:
        self._step_no += 1
        return self._step_no

    def _sched(self, r: int):
        return self.router.replicas[r].scheduler

    def clone(self) -> "World":
        w = World(
            self.cfg,
            scheduler_cls=self._scheduler_cls,
            router_cls=self._router_cls,
            health_cls=self._health_cls,
            monitor_cls=self._monitor_cls,
            _blank=True,
        )
        memo: dict = {}
        replicas = [
            _Replica(self._clone_scheduler(rep.scheduler, memo))
            for rep in self.router.replicas
        ]
        health = [self._clone_health(h) for h in self.router.health]
        w.router = self._clone_router(self.router, replicas, health)
        w.lost = set(self.lost)
        w.submitted = [_clone_request(r, memo) for r in self.submitted]
        w.n_submitted = self.n_submitted
        w.accepted = set(self.accepted)
        w.frozen = dict(self.frozen)
        w.trace = self.trace
        w._step_no = self._step_no
        return w

    def _clone_scheduler(self, s, memo):
        from collections import deque

        c = type(s).__new__(type(s))
        c.num_slots = s.num_slots
        c.max_queue = s.max_queue
        c.buckets = s.buckets
        c.eos_id = s.eos_id
        c.queue = deque(_clone_request(r, memo) for r in s.queue)
        c.slots = [
            None if r is None else _clone_request(r, memo) for r in s.slots
        ]
        c._free = list(s._free)
        c._ids = s._ids  # the process-global id counter is shared
        c.requests = {
            rid: _clone_request(r, memo) for rid, r in s.requests.items()
        }
        c.n_rejected = s.n_rejected
        # mutation subclasses may carry extra (immutable) state
        for k, v in vars(s).items():
            if k not in vars(c):
                setattr(c, k, v)
        return c

    def _clone_health(self, h):
        m = h.monitor
        mc = type(m).__new__(type(m))
        mc.threshold, mc.alpha, mc.warmup = m.threshold, m.alpha, m.warmup
        mc.on_event = m.on_event
        mc.ewma, mc.count = m.ewma, m.count
        mc.events = list(m.events)
        hc = type(h).__new__(type(h))
        hc.monitor = mc
        hc.recovery = h.recovery
        hc.healthy = h.healthy
        hc._clean = h._clean
        hc.n_degraded = h.n_degraded
        for k, v in vars(h).items():
            if k not in vars(hc):
                setattr(hc, k, v)
        return hc

    def _clone_router(self, router, replicas, health):
        c = type(router).__new__(type(router))
        c.replicas = replicas
        c.health = health
        c.placement = dict(router.placement)
        c.n_rerouted = router.n_rerouted
        for k, v in vars(router).items():
            if k not in vars(c):
                setattr(c, k, set(v) if isinstance(v, set) else v)
        return c

    # -- event alphabet ----------------------------------------------------

    def enabled_events(self) -> list[tuple]:
        cfg = self.cfg
        out: list[tuple] = []
        if self.n_submitted < cfg.requests:
            out.append(("submit",))
        for r in range(cfg.replicas):
            if r in self.lost:
                continue
            s = self._sched(r)
            if s.queue and s.free_slots:
                out.append(("admit", r))
            for slot, req in enumerate(s.slots):
                if req is not None:
                    out.append(("token", r, slot))
                    if req.remaining >= 2:
                        out.append(("eos", r, slot))
        for k, req in enumerate(self.submitted):
            if req.done:
                continue
            for r in range(cfg.replicas):
                if req.rid in self._sched(r).requests:
                    out.append(("evict", k, r))
        if cfg.faults:
            alive = [r for r in range(cfg.replicas) if r not in self.lost]
            for r in alive:
                out.append(("degrade", r))
                h = self.router.health[r]
                if not h.healthy:
                    out.append(("recover", r))
                if not h.healthy and self._sched(r).queue:
                    out.append(("reroute", r))
                if cfg.losses and len(alive) >= 2:
                    out.append(("loss", r))
        return out

    def apply(self, ev: tuple) -> None:
        """Apply one event to the real objects, enforcing the event's
        protocol postconditions.  Raises :class:`ProtocolError` on a
        rule violation, :class:`TraceNotApplicable` when the event is
        not enabled (replay of a shrunk trace)."""
        kind = ev[0]
        self.trace = self.trace + (ev,)
        handler = getattr(self, f"_ev_{kind}", None)
        if handler is None:
            raise TraceNotApplicable(f"unknown event {ev!r}")
        handler(*ev[1:])

    def apply_checked(self, ev: tuple) -> Violation | None:
        """Apply one event; any crash or rule violation becomes a
        :class:`Violation` carrying the replayable trace."""
        try:
            self.apply(ev)
        except TraceNotApplicable:
            raise
        except ProtocolError as e:
            return Violation(e.rule, e.detail, self.trace, self.cfg)
        except Exception as e:  # a crash reachable via the public API
            return Violation(
                "crash",
                f"{type(e).__name__}: {e} (applying {ev!r})",
                self.trace,
                self.cfg,
            )
        return None

    def _require(self, ok: bool, why: str) -> None:
        if not ok:
            raise TraceNotApplicable(why)

    def _alive(self) -> list[int]:
        return [r for r in range(self.cfg.replicas) if r not in self.lost]

    def _ev_submit(self) -> None:
        self._require(
            self.n_submitted < self.cfg.requests, "submission budget spent"
        )
        k = self.n_submitted
        budget = self.cfg.budgets[k % len(self.cfg.budgets)]
        req = self.router.submit([1], budget)
        self.submitted.append(req)
        self.n_submitted += 1
        if req.state == _QUEUED:
            self.accepted.add(req.rid)

    def _ev_admit(self, r: int) -> None:
        self._require(r not in self.lost, f"replica {r} lost")
        s = self._sched(r)
        free_before = list(s.free_slots)
        want = [q.rid for q in list(s.queue)[: len(free_before)]]
        got = s.admit()
        if [q.rid for q in got] != want:
            raise ProtocolError(
                "fifo",
                f"admit on replica {r} took {[q.rid for q in got]}, "
                f"FIFO head order is {want}",
            )
        if [q.slot for q in got] != free_before[: len(got)]:
            raise ProtocolError(
                "fifo",
                f"admit on replica {r} assigned slots "
                f"{[q.slot for q in got]}, deterministic order is "
                f"{free_before[: len(got)]}",
            )

    def _ev_token(self, r: int, slot: int) -> None:
        self._require(r not in self.lost, f"replica {r} lost")
        s = self._sched(r)
        self._require(slot < s.num_slots, "no such slot")
        tok = 1 if self.cfg.eos_id != 1 else 2
        s.record_token(slot, tok)

    def _ev_eos(self, r: int, slot: int) -> None:
        self._require(r not in self.lost, f"replica {r} lost")
        s = self._sched(r)
        self._require(slot < s.num_slots, "no such slot")
        s.record_token(slot, self.cfg.eos_id)

    def _ev_evict(self, k: int, r: int) -> None:
        self._require(k < self.n_submitted, "no such submission")
        req = self.submitted[k]
        self._require(
            req.rid in self._sched(r).requests,
            f"replica {r} does not know rid {req.rid}",
        )
        self._sched(r).evict(req.rid)

    def _ev_degrade(self, r: int) -> None:
        self._require(r not in self.lost, f"replica {r} lost")
        before = self._queue_snapshot()
        self.router.observe_step(r, self._next_step(), _STRAGGLE_DT)
        if self.router.health[r].healthy:
            raise ProtocolError(
                "hysteresis",
                f"straggler signal on warmed replica {r} did not degrade it",
            )
        self._check_no_reorder(before)

    def _ev_recover(self, r: int) -> None:
        self._require(r not in self.lost, f"replica {r} lost")
        h = self.router.health[r]
        pre_healthy, pre_clean = h.healthy, h._clean
        self.router.observe_step(r, self._next_step(), _CLEAN_DT)
        if not pre_healthy:
            want = pre_clean + 1 >= h.recovery
            if h.healthy != want:
                raise ProtocolError(
                    "hysteresis",
                    f"replica {r}: {pre_clean + 1} consecutive clean steps "
                    f"with recovery={h.recovery} -> healthy={h.healthy}, "
                    f"expected {want}",
                )

    def _ev_reroute(self, r: int) -> None:
        self._require(r not in self.lost, f"replica {r} lost")
        before = self._queue_snapshot()
        self.router.reroute(r)
        self._check_no_reorder(before)

    def _ev_loss(self, r: int) -> None:
        self._require(r not in self.lost, f"replica {r} already lost")
        self._require(len(self._alive()) >= 2, "cannot lose the last replica")
        before = self._queue_snapshot()
        self.lost.add(r)
        self.router.fail_replica(r)
        s = self._sched(r)
        if s.queue or any(q is not None for q in s.slots):
            raise ProtocolError(
                "liveness",
                f"failed replica {r} still holds requests after the "
                f"re-plan: queue={[q.rid for q in s.queue]}, "
                f"slots={[q.rid if q else None for q in s.slots]}",
            )
        self._check_no_reorder(before)

    # -- FIFO-order postconditions -----------------------------------------

    def _queue_snapshot(self) -> dict[int, list[int]]:
        return {
            r: [q.rid for q in self._sched(r).queue]
            for r in range(self.cfg.replicas)
        }

    def _check_no_reorder(self, before: dict[int, list[int]]) -> None:
        """No drain/reroute may reorder co-resident requests: any two
        rids that shared a queue before and share a queue after must
        keep their relative order, and survivors of a queue must form
        a contiguous prefix (movers are appended at the tail)."""
        after = self._queue_snapshot()
        for i, old in before.items():
            pos = {rid: p for p, rid in enumerate(old)}
            for j, new in after.items():
                shared = [rid for rid in new if rid in pos]
                order = [pos[rid] for rid in shared]
                if order != sorted(order):
                    raise ProtocolError(
                        "fifo",
                        f"queue {i}->{j} reordered rids {shared} "
                        f"(old positions {order})",
                    )
        for j, new in after.items():
            old_members = set(before[j])
            kept = [rid for rid in new if rid in old_members]
            if new[: len(kept)] != kept:
                raise ProtocolError(
                    "fifo",
                    f"queue {j}: rerouted requests were not appended at "
                    f"the tail (old {before[j]}, new {new})",
                )

    # -- canonical state ----------------------------------------------------

    def canonical(self) -> tuple:
        """Canonical hashable state: live rids renumbered in structural
        scan order (symmetry reduction), terminal requests collapsed to
        per-class counts, monotone telemetry dropped."""
        idx: dict[int, int] = {}

        def live(req):
            return (
                idx.setdefault(req.rid, len(idx)),
                req.remaining,
            )

        reps = []
        for i, rep in enumerate(self.router.replicas):
            s = rep.scheduler
            h = self.router.health[i]
            m = h.monitor
            reps.append((
                i in self.lost,
                h.healthy,
                h._clean,
                None if m.ewma is None else round(m.ewma, 9),
                min(m.count, m.warmup + 1),
                tuple(live(q) for q in s.queue),
                tuple(None if q is None else live(q) for q in s.slots),
                tuple(s._free),
            ))
        owners = []
        for k, req in enumerate(self.submitted):
            if req.done or req.rid not in idx:
                continue
            owned_by = tuple(
                r
                for r in range(self.cfg.replicas)
                if req.rid in self._sched(r).requests
            )
            owners.append((idx[req.rid], owned_by))
        term = Counter(req.state for req in self.submitted if req.done)
        limbo = tuple(
            (req.state, req.remaining)
            for req in self.submitted
            if not req.done and req.rid not in idx
        )
        return (
            tuple(reps),
            tuple(sorted(owners)),
            self.cfg.requests - self.n_submitted,
            term[_FINISHED],
            term[_EVICTED],
            term[_REJECTED],
            limbo,
        )

    def all_idle(self) -> bool:
        return all(
            not s.queue and not any(q is not None for q in s.slots)
            for s in (self._sched(r) for r in range(self.cfg.replicas))
        )


# ---------------------------------------------------------------------------
# safety rules (checked at every reachable state)
# ---------------------------------------------------------------------------


def _safety_violations(w: World) -> list[Violation]:
    out: list[Violation] = []

    def bad(rule, detail):
        out.append(Violation(rule, detail, w.trace, w.cfg))

    scheds = [w._sched(r) for r in range(w.cfg.replicas)]

    # structural slot accounting, per replica (the scheduler's own hook)
    for i, s in enumerate(scheds):
        try:
            s.check_invariants()
        except AssertionError as e:
            bad("slot-accounting", f"replica {i}: check_invariants: {e}")

    # conservation: each submitted rid in exactly the container its
    # state names, across ALL replicas
    holder: dict[int, list[tuple[int, str]]] = {}
    for i, s in enumerate(scheds):
        for pos, req in enumerate(s.queue):
            holder.setdefault(req.rid, []).append((i, f"queue[{pos}]"))
        for slot, req in enumerate(s.slots):
            if req is not None:
                holder.setdefault(req.rid, []).append((i, f"slot[{slot}]"))
    for k, req in enumerate(w.submitted):
        where = holder.pop(req.rid, [])
        if req.state == _QUEUED:
            if len(where) != 1 or "queue" not in where[0][1]:
                bad(
                    "conservation",
                    f"submission {k} (rid {req.rid}) is QUEUED but held "
                    f"by {where}",
                )
        elif req.state == _ACTIVE:
            if len(where) != 1 or "slot" not in where[0][1]:
                bad(
                    "conservation",
                    f"submission {k} (rid {req.rid}) is ACTIVE but held "
                    f"by {where}",
                )
        elif req.done:
            if where:
                bad(
                    "conservation",
                    f"submission {k} (rid {req.rid}) is terminal "
                    f"({req.state}) but still held by {where}",
                )
            frozen = w.frozen.setdefault(req.rid, len(req.generated))
            if (
                len(req.generated) != frozen
                or req.slot is not None
                or req.remaining != 0
            ):
                bad(
                    "silence",
                    f"terminal submission {k} (rid {req.rid}, "
                    f"{req.state}) changed after the end: "
                    f"generated {frozen}->{len(req.generated)}, "
                    f"slot={req.slot}, remaining={req.remaining}",
                )
        else:
            bad("conservation", f"rid {req.rid} in unknown state {req.state}")
        if req.rid in w.accepted and req.state == _REJECTED:
            bad(
                "acceptance",
                f"submission {k} (rid {req.rid}) was accepted (QUEUED) "
                f"but later REJECTED — backpressure must happen at "
                f"submit, not mid-flight",
            )
        if req.state in (_QUEUED, _ACTIVE):
            p = w.router.placement.get(req.rid)
            actual = where[0][0] if len(where) == 1 else None
            if p is None or (actual is not None and p != actual):
                bad(
                    "placement",
                    f"rid {req.rid} is {req.state} on replica {actual} "
                    f"but router.placement says {p}",
                )
    for rid, where in holder.items():
        bad("conservation", f"unsubmitted rid {rid} held by {where}")

    # ownership: a live rid is registered with exactly one replica —
    # a stale second registry entry lets evict race a reroute
    own = Counter()
    for i, s in enumerate(scheds):
        for rid, req in s.requests.items():
            if not req.done:
                own[rid] += 1
    for rid, n in own.items():
        if n > 1:
            bad(
                "ownership",
                f"live rid {rid} is registered with {n} replicas — "
                f"evicting through the stale owner corrupts or crashes",
            )
    return out


# ---------------------------------------------------------------------------
# quiescence-style liveness
# ---------------------------------------------------------------------------


def quiesce(world: World, *, limit: int | None = None) -> Violation | None:
    """From ``world``, stop admissions and drive drain events (recover,
    admit, decode tokens) on every surviving replica; the system must
    reach ``idle`` within a budget-derived bound.  Returns a liveness
    :class:`Violation` (with the *reaching* trace) if it does not."""
    cfg = world.cfg
    if limit is None:
        limit = (
            cfg.requests * max(cfg.budgets)
            + cfg.replicas * (cfg.recovery + 2)
            + cfg.requests
            + cfg.replicas * cfg.slots
            + 8
        )
    w = world.clone()
    for _ in range(limit):
        if w.all_idle():
            return None
        for r in range(cfg.replicas):
            if r in w.lost:
                continue
            h = w.router.health[r]
            try:
                if not h.healthy:
                    v = w.apply_checked(("recover", r))
                    if v is not None:
                        return _as_liveness(v, world)
                s = w._sched(r)
                if s.queue and s.free_slots:
                    v = w.apply_checked(("admit", r))
                    if v is not None:
                        return _as_liveness(v, world)
                for slot, req in enumerate(s.slots):
                    if req is not None:
                        v = w.apply_checked(("token", r, slot))
                        if v is not None:
                            return _as_liveness(v, world)
            except TraceNotApplicable:
                continue
    stuck = {
        r: {
            "queue": [q.rid for q in w._sched(r).queue],
            "slots": [
                q.rid if q is not None else None for q in w._sched(r).slots
            ],
            "lost": r in w.lost,
            "healthy": w.router.health[r].healthy,
        }
        for r in range(cfg.replicas)
        if w._sched(r).queue
        or any(q is not None for q in w._sched(r).slots)
    }
    return Violation(
        "liveness",
        f"state does not quiesce: after {limit} drain rounds requests "
        f"remain stranded: {stuck}",
        world.trace,
        cfg,
    )


def _as_liveness(v: Violation, world: World) -> Violation:
    return Violation(
        "liveness",
        f"drain from this state hits a violation: [{v.rule}] {v.detail}",
        world.trace,
        world.cfg,
    )


# ---------------------------------------------------------------------------
# exploration driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CheckReport:
    """Result of one exhaustive exploration."""

    config: CheckConfig
    states: int            #: distinct canonical states reached
    transitions: int       #: events applied (pre-dedup)
    depth: int             #: deepest fully-expanded BFS level
    complete: bool         #: frontier emptied (full closure) vs depth cap
    violations: list[Violation]
    occupancies: tuple[int, ...]  #: reachable per-replica active-slot counts
    seconds: float

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def dedup_ratio(self) -> float:
        return self.transitions / max(1, self.states)

    def to_row(self) -> dict:
        return {
            "config": dataclasses.asdict(self.config),
            "states": self.states,
            "transitions": self.transitions,
            "dedup_ratio": round(self.dedup_ratio, 3),
            "depth": self.depth,
            "complete": self.complete,
            "violations": [v.to_row() for v in self.violations],
            "occupancies": list(self.occupancies),
            "seconds": round(self.seconds, 3),
        }


def check_protocol(
    cfg: CheckConfig,
    *,
    scheduler_cls=None,
    router_cls=None,
    health_cls=None,
    max_violations: int = 1,
    shrink: bool = True,
) -> CheckReport:
    """Breadth-first exhaustive exploration of every event interleaving
    up to ``cfg.depth`` (or full closure), deduped by canonical state.
    Stops at ``max_violations`` counterexamples; each is shrunk to a
    locally-minimal replayable trace."""
    import logging

    t0 = time.perf_counter()
    classes = dict(
        scheduler_cls=scheduler_cls,
        router_cls=router_cls,
        health_cls=health_cls,
    )
    # thousands of deliberate straggler injections: mute the runtime's
    # per-event warning for the duration of the exploration
    runtime_log = logging.getLogger("repro_torch.runtime")
    prior_level = runtime_log.level
    runtime_log.setLevel(logging.ERROR)
    try:
        return _explore(cfg, classes, max_violations, shrink, t0)
    finally:
        runtime_log.setLevel(prior_level)


def _explore(cfg, classes, max_violations, shrink, t0) -> "CheckReport":
    root = World(cfg, **classes)
    violations: list[Violation] = []
    seen = {root.canonical()}
    occupancies: set[int] = set()

    def note_occupancy(w: World) -> None:
        for r in range(cfg.replicas):
            occupancies.add(sum(w._sched(r).active_mask()))

    note_occupancy(root)
    sv = _safety_violations(root)
    if not sv and cfg.liveness:
        lv = quiesce(root)
        if lv is not None:
            sv = [lv]
    violations.extend(sv)

    frontier = [root]
    depth = 0
    transitions = 0
    complete = True
    while frontier and len(violations) < max_violations:
        if cfg.depth is not None and depth >= cfg.depth:
            complete = False
            break
        nxt: list[World] = []
        for w in frontier:
            for ev in w.enabled_events():
                child = w.clone()
                transitions += 1
                v = child.apply_checked(ev)
                if v is None:
                    sv = _safety_violations(child)
                    v = sv[0] if sv else None
                if v is None:
                    # dedup before the liveness drain: quiescence is a
                    # function of the canonical state (queues, slots,
                    # health, losses fully determine drain behavior),
                    # so one check per distinct state is exhaustive
                    key = child.canonical()
                    if key in seen:
                        continue
                    seen.add(key)
                    if cfg.liveness:
                        v = quiesce(child)
                if v is not None:
                    violations.append(v)
                    if len(violations) >= max_violations:
                        break
                    continue
                note_occupancy(child)
                nxt.append(child)
            if len(violations) >= max_violations:
                break
        if len(violations) >= max_violations:
            complete = False
            break
        depth += 1
        frontier = nxt

    if shrink:
        violations = [
            dataclasses.replace(
                v, trace=shrink_trace(cfg, v.trace, v.rule, **classes)
            )
            for v in violations
        ]
    return CheckReport(
        config=cfg,
        states=len(seen),
        transitions=transitions,
        depth=depth,
        complete=complete,
        violations=violations,
        occupancies=tuple(sorted(occupancies)),
        seconds=time.perf_counter() - t0,
    )


# ---------------------------------------------------------------------------
# replay, shrinking, regression-test helpers
# ---------------------------------------------------------------------------


def run_trace(
    cfg: CheckConfig,
    trace,
    *,
    scheduler_cls=None,
    router_cls=None,
    health_cls=None,
) -> list[Violation]:
    """Replay an event trace on a fresh world; returns the violations
    it produces (stopping at the first).  Raises
    :class:`TraceNotApplicable` if an event is not enabled — traces are
    deterministic, so a recorded counterexample always replays."""
    import logging

    logging.getLogger("repro_torch.runtime").setLevel(logging.ERROR)
    w = World(
        cfg,
        scheduler_cls=scheduler_cls,
        router_cls=router_cls,
        health_cls=health_cls,
    )
    for ev in trace:
        v = w.apply_checked(tuple(ev))
        if v is None:
            sv = _safety_violations(w)
            v = sv[0] if sv else None
        if v is not None:
            return [v]
    if cfg.liveness:
        v = quiesce(w)
        if v is not None:
            return [v]
    return []


def shrink_trace(cfg: CheckConfig, trace, rule: str, **classes) -> tuple:
    """Greedy delta-debugging: drop events while the trace still
    violates ``rule``.  BFS already gives minimal *depth*; this removes
    incidental events, yielding a locally-minimal witness."""

    def violates(tr) -> bool:
        try:
            return any(v.rule == rule for v in run_trace(cfg, tr, **classes))
        except TraceNotApplicable:
            return False

    trace = tuple(tuple(e) for e in trace)
    if not violates(trace):  # e.g. liveness found mid-drain; keep as-is
        return trace
    changed = True
    while changed:
        changed = False
        for i in reversed(range(len(trace))):
            cand = trace[:i] + trace[i + 1:]
            if violates(cand):
                trace = cand
                changed = True
                break
    return trace


def assert_trace_violates(cfg: CheckConfig, trace, rule: str, **classes):
    """Regression-test hook: the trace must reproduce ``rule``."""
    vs = run_trace(cfg, trace, **classes)
    assert any(v.rule == rule for v in vs), (
        f"expected a {rule!r} violation, got "
        f"{[(v.rule, v.detail) for v in vs]}"
    )
    return vs


def assert_trace_clean(cfg: CheckConfig, trace, **classes) -> None:
    """Regression-test hook: the (formerly violating) trace must now
    replay without any violation."""
    vs = run_trace(cfg, trace, **classes)
    assert not vs, f"trace not clean: {[(v.rule, v.detail) for v in vs]}"


# ---------------------------------------------------------------------------
# layer-0 <-> decode geometry link
# ---------------------------------------------------------------------------


def verify_decode_geometry_link(num_slots: int, group: int) -> dict:
    """Prove the checker's admissible decode-step states are exactly
    the slot geometries the engine's decode slice runs at.

    A tiny occupancy closure drives a **real** :class:`Scheduler`
    through submit/admit/token/evict and collects every reachable
    active-slot count; the ragged per-chip split of ``num_slots`` over
    ``group`` chips (``Scheduler.shard_geometry`` ==
    ``napalg.ragged_splits``) must then be exactly the padded hull of
    those occupancies — ``b_max = max(geometry)`` rows per chip, the
    rows every rank of the engine holds.  Raises ``AssertionError`` if
    the link is broken."""
    from repro_torch.core import napalg
    from repro_torch.serve.scheduler import Scheduler

    probe = Scheduler(num_slots)
    geometry = probe.shard_geometry(group)
    assert geometry == napalg.ragged_splits(num_slots, group), (
        geometry, num_slots, group,
    )

    # occupancy closure: canonical = (submits left, queued, per-slot mask)
    def mk():
        return Scheduler(num_slots)

    max_requests = num_slots + 1
    reachable: set[int] = set()
    seen: set[tuple] = set()

    def canon(s, n_sub):
        return (
            max_requests - n_sub,
            len(s.queue),
            tuple(s.active_mask()),
        )

    frontier = [(mk(), 0)]
    seen.add(canon(*frontier[0]))
    while frontier:
        nxt = []
        for s, n_sub in frontier:
            reachable.add(sum(s.active_mask()))
            children = []
            if n_sub < max_requests:
                c = _clone_plain_scheduler(s)
                c.submit([1], 1)
                children.append((c, n_sub + 1))
            if s.queue and s.free_slots:
                c = _clone_plain_scheduler(s)
                c.admit()
                children.append((c, n_sub))
            for slot, req in enumerate(s.slots):
                if req is not None:
                    c = _clone_plain_scheduler(s)
                    c.record_token(slot, 1)  # budget 1: token == finish
                    children.append((c, n_sub))
                    c2 = _clone_plain_scheduler(s)
                    c2.evict(c2.slots[slot].rid)
                    children.append((c2, n_sub))
            for c, n in children:
                key = canon(c, n)
                if key not in seen:
                    seen.add(key)
                    nxt.append((c, n))
        frontier = nxt

    assert reachable == set(range(num_slots + 1)), reachable
    b_max = max(geometry)
    # padded hull: the deepest per-chip row any admissible occupancy
    # needs equals the b_max every rank of the engine holds
    need = 0
    for occ in reachable:
        rows, left = 0, occ
        for g in geometry:
            rows = max(rows, min(g, left))
            left -= min(g, left)
        need = max(need, rows)
    assert need == b_max, (need, b_max, geometry)
    return {
        "num_slots": num_slots,
        "group": group,
        "geometry": list(geometry),
        "admissible_occupancies": sorted(reachable),
        "b_max": b_max,
        "occupancy_states": len(seen),
        "ok": True,
    }


def _clone_plain_scheduler(s):
    from collections import deque

    memo: dict = {}
    c = type(s).__new__(type(s))
    c.num_slots, c.max_queue = s.num_slots, s.max_queue
    c.buckets, c.eos_id = s.buckets, s.eos_id
    c.queue = deque(_clone_request(r, memo) for r in s.queue)
    c.slots = [None if r is None else _clone_request(r, memo) for r in s.slots]
    c._free = list(s._free)
    c._ids = s._ids
    c.requests = {rid: _clone_request(r, memo) for rid, r in s.requests.items()}
    c.n_rejected = s.n_rejected
    return c


#: the small-scope grid ``(config, canonical states)``.  Exploration is
#: deterministic, so the counts are exact; they equal the reference's
#: floors (``repro/analysis/__main__.py::_protocol_grid``).
PROTOCOL_GRID = (
    # pure scheduler protocol, single replica, full closure
    (CheckConfig(replicas=1, slots=2, queue=2, requests=4, budgets=(2, 1),
                 faults=False, losses=False, depth=None), 230),
    # two replicas with the full fault alphabet, full closure
    (CheckConfig(replicas=2, slots=1, queue=1, requests=3, budgets=(2, 1),
                 recovery=2, depth=None), 3591),
    # three replicas: reroute fan-out + double loss, bounded depth
    (CheckConfig(replicas=3, slots=1, queue=1, requests=4, budgets=(1,),
                 recovery=2, depth=8), 9890),
    # 2 replicas x 3 slots x 5 requests to event depth 12, full fault
    # alphabet (about 100 s on a CPU core; not in the tier-1 tests)
    (CheckConfig(replicas=2, slots=3, queue=2, requests=5, budgets=(2, 1),
                 recovery=2, depth=12), 77796),
)
