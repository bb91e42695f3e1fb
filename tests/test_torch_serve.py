"""The port's serving spine against the JAX package's.

Host side (pure Python, no tensors): every test of the reference's
``tests/test_serve.py`` on the port's scheduler, buckets, router and
replica health — FIFO admission, admission control, EOS and budget
finishes, silence after the end, scheduler and router trace fuzz
(hypothesis when installed, the deterministic ``_hypothesis_compat``
sweep otherwise), straggler reroute, ``fail_replica``, evict after
reroute through the single owner.

Engine, at ``reduced(minicpm-2b)`` in float32 on the CPU with the
reference's parameters (``params_from_jax``):

* continuous batching bitwise equal to the fixed-batch ``serve_batch``
  (tokens), through a padded prompt bucket and mid-flight admission;
* the EOS early finish, and extras rejected;
* the engine's token streams equal to the reference ``ServeEngine``'s on
  the same submit and step order;
* a router over two engines, one of which dies mid-decode: every request
  finishes with the tokens of a serial run (a resumed request replays
  what it had generated);
* the tensor-parallel head on 2x2 and 2x3 gloo worlds
  (``tests/_torch_world.py serve``): continuous batching equal to serial,
  bitwise; the EOS exit agreed by the group (engine and ``serve_batch``);
  the dispatch report ``nap`` /
  ``mla_ag`` / ``psum``; the 2x2 tokens equal to the reference's meshed
  engine on a 4-device mesh (``jax_serve``) and every grid's equal to the
  single-device reference's.
"""

import os
import random
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.configs import get_config
from repro.configs import reduced as jreduced
from repro.launch.serve import serve_batch as j_serve_batch
from repro.models import build_model as j_build
from repro.serve import PromptBuckets as JBuckets
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import MINICPM_2B, reduced
from repro_torch.launch.serve import serve_batch
from repro_torch.models import build_model, params_from_jax
from repro_torch.serve import PromptBuckets, Router, ServeEngine
from repro_torch.serve.scheduler import (
    ACTIVE,
    EVICTED,
    FINISHED,
    QUEUED,
    REJECTED,
    Scheduler,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_world as tw  # noqa: E402

# ---------------------------------------------------------------------------
# PromptBuckets


def test_bucket_len_picks_smallest_holding_bucket():
    b = PromptBuckets([16, 4, 8, 8])  # dedup + sort
    assert b.lengths == (4, 8, 16)
    assert b.bucket_len(1) == 4
    assert b.bucket_len(4) == 4
    assert b.bucket_len(5) == 8
    assert b.bucket_len(16) == 16
    with pytest.raises(ValueError):
        b.bucket_len(17)


def test_bucket_validation():
    with pytest.raises(ValueError):
        PromptBuckets([])
    with pytest.raises(ValueError):
        PromptBuckets([0, 8])
    with pytest.raises(ValueError):
        PromptBuckets.geometric(64, factor=1)


def test_geometric_ladder_covers_max_len():
    b = PromptBuckets.geometric(100, start=8, factor=2)
    assert b.lengths == (8, 16, 32, 64, 100)
    assert b.max_len == 100
    for n in range(1, 101):
        assert b.bucket_len(n) >= n
    # trace count is logarithmic, not linear
    assert len(b.lengths) <= 8


# ---------------------------------------------------------------------------
# Scheduler: directed unit tests


def test_fifo_admission_under_saturation():
    s = Scheduler(2)
    reqs = [s.submit([1], 1) for _ in range(5)]
    admitted = s.admit()
    assert [r.rid for r in admitted] == [reqs[0].rid, reqs[1].rid]
    assert [r.slot for r in admitted] == [0, 1]
    # finishing one request admits exactly the queue head into its slot
    for nxt in (2, 3, 4):
        done = s.record_token(0, 7)
        assert done is not None and done.state == FINISHED
        newly = s.admit()
        assert [r.rid for r in newly] == [reqs[nxt].rid]
        assert newly[0].slot == 0
        s.check_invariants()


def test_admission_control_rejects_past_queue_bound():
    s = Scheduler(1, max_queue=2)
    ok = [s.submit([1], 1) for _ in range(2)]
    bad = s.submit([1], 1)
    assert all(r.state == QUEUED for r in ok)
    assert bad.state == REJECTED and bad.remaining == 0
    assert s.n_rejected == 1
    # rejected requests never enter the queue or a slot
    s.admit()
    assert bad.slot is None
    s.check_invariants()


def test_eos_and_budget_finish():
    s = Scheduler(1, eos_id=99)
    r1 = s.submit([1], 4)
    s.admit()
    assert s.record_token(0, 5) is None
    assert s.record_token(0, 99) is r1  # EOS beats remaining budget
    assert r1.generated == [5, 99] and r1.state == FINISHED
    r2 = s.submit([1], 2)
    s.admit()
    s.record_token(0, 1)
    assert s.record_token(0, 2) is r2  # budget exhaustion
    assert r2.generated == [1, 2]


def test_tokens_for_free_slots_are_dropped():
    s = Scheduler(2)
    s.submit([1], 3)
    s.admit()
    # slot 1 was never filled; the engine decodes it unconditionally
    assert s.record_token(1, 123) is None
    s.check_invariants()


def test_evicted_requests_never_emit_tokens():
    s = Scheduler(1)
    r1 = s.submit([1], 5)
    r2 = s.submit([2], 5)
    s.admit()
    s.record_token(0, 11)
    s.evict(r1.rid)
    assert r1.state == EVICTED and r1.slot is None
    n_before = len(r1.generated)
    # the token the engine already computed for the freed slot is dropped
    assert s.record_token(0, 12) is None
    assert len(r1.generated) == n_before
    # eviction of a queued request removes it before it ever runs
    s.evict(r2.rid)
    assert r2.state == EVICTED and r2.generated == []
    assert s.admit() == [] and s.idle
    # terminal evict is a no-op
    assert s.evict(r1.rid) is r1
    s.check_invariants()


def test_outstanding_tokens_counts_queue_and_slots():
    s = Scheduler(1)
    r1 = s.submit([1], 5)
    s.submit([2], 3)
    assert s.outstanding_tokens() == 8
    s.admit()
    s.record_token(0, 1)
    assert s.outstanding_tokens() == 7
    s.evict(r1.rid)
    assert s.outstanding_tokens() == 3


def test_shard_geometry_is_ragged_splits():
    from repro_torch.core import napalg

    s = Scheduler(10)
    for group in (1, 2, 3, 4, 8):
        geo = s.shard_geometry(group)
        assert geo == napalg.ragged_splits(10, group)
        assert sum(geo) == 10 and len(geo) == group


def test_request_validation():
    with pytest.raises(ValueError):
        Scheduler(0)
    s = Scheduler(1)
    with pytest.raises(ValueError):
        s.submit([], 1)
    with pytest.raises(ValueError):
        s.submit([1], 0)


# ---------------------------------------------------------------------------
# Scheduler: fuzz over arrival traces


@settings(max_examples=40, deadline=None)
@given(
    seed=st.integers(min_value=0, max_value=10**6),
    num_slots=st.integers(min_value=1, max_value=4),
    max_queue=st.one_of(st.none(), st.integers(min_value=0, max_value=3)),
)
def test_scheduler_trace_fuzz(seed, num_slots, max_queue):
    rng = random.Random(seed)
    eos = 99 if rng.random() < 0.5 else None
    s = Scheduler(num_slots, max_queue=max_queue, eos_id=eos)
    submitted = []          # arrival order
    admitted_order = []     # admission order
    frozen = {}             # rid -> generated length at terminal transition

    def note_terminals():
        for req in s.requests.values():
            if req.done:
                frozen.setdefault(req.rid, len(req.generated))
                # silence after the end: a terminal request's token list
                # must never grow again
                assert len(req.generated) == frozen[req.rid], req
                assert req.slot is None
                assert req.remaining == 0

    for _ in range(80):
        op = rng.random()
        if op < 0.35:
            req = s.submit(
                [rng.randrange(100) + 1 for _ in range(rng.randrange(1, 5))],
                rng.randrange(1, 4),
            )
            if req.state != REJECTED:
                submitted.append(req.rid)
        elif op < 0.55:
            # FIFO: admit() must take exactly the current queue head(s)
            expect = [r.rid for r in list(s.queue)[: len(s.free_slots)]]
            got = [r.rid for r in s.admit()]
            assert got == expect
            admitted_order.extend(got)
        elif op < 0.85:
            # one decode step: the engine records a token for EVERY slot
            for slot in range(num_slots):
                s.record_token(slot, rng.choice([99, rng.randrange(98)]))
        else:
            live = [
                r.rid for r in s.requests.values() if not r.done
            ]
            if live:
                s.evict(rng.choice(live))
        s.check_invariants()
        note_terminals()

    # FIFO fairness: admissions happen in arrival order (eviction from
    # the queue only removes entries; it never reorders survivors)
    pos = {rid: i for i, rid in enumerate(submitted)}
    order = [pos[rid] for rid in admitted_order]
    assert order == sorted(order)
    # no slot leak survives the whole trace
    assert len(s.free_slots) + len(s.active()) == num_slots
    # every admitted request was actually submitted (never rejected)
    assert set(admitted_order) <= set(submitted)


@settings(max_examples=20, deadline=None)
@given(
    seed=st.integers(min_value=0, max_value=10**6),
    num_slots=st.integers(min_value=1, max_value=3),
)
def test_scheduler_drains_to_idle(seed, num_slots):
    """Any backlog drains to idle under admit+decode steps alone."""
    rng = random.Random(seed)
    s = Scheduler(num_slots)
    reqs = [
        s.submit([1 + rng.randrange(9)], rng.randrange(1, 5))
        for _ in range(rng.randrange(1, 9))
    ]
    steps = 0
    while not s.idle:
        s.admit()
        for slot in range(num_slots):
            s.record_token(slot, rng.randrange(50))
        s.check_invariants()
        steps += 1
        assert steps < 1000, "scheduler failed to drain"
    for r in reqs:
        assert r.state == FINISHED
        assert len(r.generated) == r.max_new_tokens


# ---------------------------------------------------------------------------
# Router + replica health


class _FakeReplica:
    """Minimal replica surface the Router needs (no device state)."""

    def __init__(self, num_slots, **kw):
        self.scheduler = Scheduler(num_slots, **kw)

    def submit(self, prompt, max_new_tokens, **kw):
        return self.scheduler.submit(prompt, max_new_tokens, **kw)

    def outstanding_tokens(self):
        return self.scheduler.outstanding_tokens()

    @property
    def idle(self):
        return self.scheduler.idle


def test_router_spreads_by_outstanding_tokens():
    from repro_torch.serve import Router

    r = Router([_FakeReplica(2), _FakeReplica(2)])
    big = r.submit([1], 100)        # -> replica 0 (tie, lowest index)
    small = r.submit([1], 1)        # -> replica 1 (less loaded)
    nxt = r.submit([1], 1)          # -> replica 1 again (2 < 100)
    assert r.placement[big.rid] == 0
    assert r.placement[small.rid] == 1
    assert r.placement[nxt.rid] == 1
    assert r.loads() == [100, 2]


def test_router_rejected_requests_are_not_placed():
    from repro_torch.serve import Router

    r = Router([_FakeReplica(1, max_queue=0)])
    req = r.submit([1], 1)
    assert req.state == REJECTED
    assert req.rid not in r.placement


def test_replica_health_hysteresis():
    from repro_torch.runtime.fault import ReplicaHealth, StragglerMonitor

    h = ReplicaHealth(
        StragglerMonitor(threshold=2.0, warmup=3), recovery=3
    )
    for step in range(4):
        assert h.record(step, 1.0)
    assert not h.record(4, 10.0)        # straggler event -> degraded
    assert h.n_degraded == 1
    assert not h.record(5, 1.0)         # one clean step is not recovery
    assert not h.record(6, 1.0)
    assert h.record(7, 1.0)             # 3 consecutive clean -> healthy
    # a new event restarts the clean counter
    assert not h.record(8, 50.0)
    assert not h.record(9, 1.0)
    assert h.n_degraded == 2


def test_router_reroutes_queue_on_straggler():
    from repro_torch.serve import Router

    a, b = _FakeReplica(1), _FakeReplica(1)
    r = Router([a, b], straggler_threshold=2.0, recovery=2)
    # saturate replica 0 and build its queue (directly: the router
    # itself would spread this backlog to the emptier replica 1)
    first = r.submit([1], 50)
    a.scheduler.admit()
    queued = [a.submit([1], 50) for _ in range(3)]
    # straggler signal on replica 0 past monitor warmup
    for step in range(4):
        assert r.observe_step(0, step, 1.0)
    assert not r.observe_step(0, 4, 25.0)
    # queued requests moved to the healthy peer; the active one stayed
    assert not r.health[0].healthy
    assert a.scheduler.queue == type(a.scheduler.queue)()
    assert first.state == ACTIVE and r.placement[first.rid] == 0
    moved = [q for q in queued if q.state == QUEUED]
    assert moved and all(r.placement[q.rid] == 1 for q in moved)
    assert r.n_rerouted == len(moved)
    # while degraded, new submissions avoid replica 0
    assert r.placement[r.submit([1], 1).rid] == 1
    # recovery hysteresis readmits it
    r.observe_step(0, 5, 1.0)
    r.observe_step(0, 6, 1.0)
    assert r.health[0].healthy


def test_router_all_degraded_still_routes():
    from repro_torch.serve import Router
    from repro_torch.runtime.fault import ReplicaHealth, StragglerMonitor

    h = [
        ReplicaHealth(StragglerMonitor(warmup=1), recovery=2)
        for _ in range(2)
    ]
    r = Router([_FakeReplica(1), _FakeReplica(1)], health=h)
    for i in (0, 1):
        r.observe_step(i, 0, 1.0)
        r.observe_step(i, 1, 1.0)
        r.observe_step(i, 2, 100.0)
    assert not any(x.healthy for x in r.health)
    req = r.submit([1], 1)  # stalled beats dropped
    assert req.state == QUEUED and req.rid in r.placement


def test_evict_after_reroute_goes_through_single_owner():
    # layer-0 counterexample (submit, degrade, evict-via-stale-owner):
    # before single ownership, the drained rid stayed in the source
    # registry and evicting through it crashed in deque.remove
    from repro_torch.serve import Router

    a, b = _FakeReplica(1), _FakeReplica(1)
    r = Router([a, b], straggler_threshold=2.0, recovery=2)
    first = r.submit([1], 50)
    a.scheduler.admit()
    q = a.submit([1], 5)
    for step in range(4):
        assert r.observe_step(0, step, 1.0)
    assert not r.observe_step(0, 4, 25.0)  # degrade -> reroute
    # ownership moved with the request: exactly one registry owns it
    assert q.rid not in a.scheduler.requests
    assert q.rid in b.scheduler.requests
    with pytest.raises(KeyError):
        a.scheduler.evict(q.rid)
    # the router's placement stayed accurate, so evicting through it
    # reaches the real owner
    r.evict(q.rid)
    assert q.state == EVICTED
    assert first.state == ACTIVE  # the active request rode out the stall
    a.scheduler.check_invariants(peers=[b.scheduler])


def test_reroute_keeps_accepted_request_when_no_peer_has_room():
    # layer-0 counterexample (submit, submit, degrade): before the
    # capacity-aware reroute, draining into a full peer queue flipped
    # an accepted request to REJECTED mid-flight
    from repro_torch.runtime.fault import ReplicaHealth, StragglerMonitor
    from repro_torch.serve import Router

    a = _FakeReplica(1, max_queue=1)
    b = _FakeReplica(1, max_queue=1)
    h = [
        ReplicaHealth(
            StragglerMonitor(threshold=2.0, warmup=1), recovery=2
        )
        for _ in range(2)
    ]
    r = Router([a, b], health=h)
    for i in (0, 1):
        r.observe_step(i, 0, 1.0)
        r.observe_step(i, 1, 1.0)
    qa = r.submit([1], 5)     # -> replica 0 (tie, lowest index)
    qb = r.submit([1], 5)     # -> replica 1; both queues now full
    assert not r.observe_step(0, 2, 25.0)  # degrade 0 -> reroute
    # acceptance is binding: no room on the peer, so the request stays
    # queued (FIFO position intact) on the degraded replica
    assert qa.state == QUEUED and r.placement[qa.rid] == 0
    assert list(a.scheduler.queue) == [qa]
    assert qb.state == QUEUED and r.placement[qb.rid] == 1
    a.scheduler.check_invariants(peers=[b.scheduler])


def test_pick_prefers_replica_with_queue_capacity():
    from repro_torch.serve import Router

    a = _FakeReplica(1, max_queue=1)
    b = _FakeReplica(1)
    r = Router([a, b])
    big = b.scheduler.submit([1], 100)
    b.scheduler.admit()           # replica 1 heavily loaded but roomy
    a.scheduler.submit([1], 1)    # replica 0 light but queue full
    req = r.submit([1], 1)
    # least-loaded would pick the full replica 0 and reject; capacity
    # preference routes to the loaded-but-roomy replica 1 instead
    assert req.state == QUEUED
    assert r.placement[req.rid] == 1
    assert big.state == ACTIVE


def test_fail_replica_replans_queued_and_active():
    from repro_torch.serve import Router

    a = _FakeReplica(2, max_queue=1)
    b = _FakeReplica(1, max_queue=1)
    r = Router([a, b])
    act = r.submit([1], 10)       # -> replica 0 (tie, lowest index)
    a.scheduler.admit()
    q1 = a.submit([1], 5)         # queued on replica 0 (queue full)
    b_q = r.submit([1], 3)        # -> replica 1 (less loaded)
    moved = r.fail_replica(0)
    assert moved == 2 and 0 in r.failed
    # the dead replica is empty — its work drained into the re-plan
    assert a.scheduler.idle and not a.scheduler.requests
    # the active request lost its KV state: demoted to QUEUED, slot
    # released, generated tokens kept for the re-prefill
    assert act.state == QUEUED and act.slot is None
    # survivors keep FIFO order: b's own head, then the demoted
    # active (admitted first), then the queued mover — force-enqueued
    # past b's backpressure bound rather than dropped
    assert [x.rid for x in b.scheduler.queue] == [b_q.rid, act.rid, q1.rid]
    assert r.placement[act.rid] == 1 and r.placement[q1.rid] == 1
    # a dead replica never receives traffic again: with the survivor
    # over its bound the submit is REJECTED (honest backpressure),
    # never routed to the corpse
    rejected = r.submit([1], 1)
    assert rejected.state == REJECTED and rejected.rid not in r.placement
    while not b.scheduler.idle:  # drain the survivor
        b.scheduler.admit()
        b.scheduler.record_token(0, 1)
    assert r.placement[r.submit([1], 1).rid] == 1
    b.scheduler.check_invariants(peers=[a.scheduler])
    with pytest.raises(RuntimeError):
        r.fail_replica(1)  # no survivor to re-plan onto


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10**6))
def test_router_trace_fuzz_cross_replica_conservation(seed):
    """Random multi-replica traces (submit/admit/decode/health/evict/
    loss) hold the cross-replica conservation invariants at every step:
    global rid uniqueness and outstanding-token accounting."""
    from repro_torch.runtime.fault import ReplicaHealth, StragglerMonitor
    from repro_torch.serve import Router

    rng = random.Random(seed)
    n = rng.choice([2, 3])
    reps = [
        _FakeReplica(
            rng.randrange(1, 3),
            max_queue=rng.choice([None, 1, 2]),
            eos_id=99,
        )
        for _ in range(n)
    ]
    health = [
        ReplicaHealth(
            StragglerMonitor(threshold=2.0, warmup=1, alpha=0.5),
            recovery=2,
        )
        for _ in range(n)
    ]
    r = Router(reps, health=health)
    step = 0
    for i in range(n):
        for _ in range(2):
            r.observe_step(i, step, 1.0)
            step += 1
    for _ in range(120):
        op = rng.random()
        alive = [i for i in range(n) if i not in r.failed]
        if op < 0.30:
            r.submit([1 + rng.randrange(9)], rng.randrange(1, 4))
        elif op < 0.45:
            reps[rng.choice(alive)].scheduler.admit()
        elif op < 0.70:
            i = rng.choice(alive)
            for slot in range(reps[i].scheduler.num_slots):
                reps[i].scheduler.record_token(
                    slot, rng.choice([99, 1 + rng.randrange(9)])
                )
        elif op < 0.80:
            r.observe_step(
                rng.choice(alive), step, rng.choice([1.0, 25.0])
            )
            step += 1
        elif op < 0.92:
            live = [
                rid
                for i in alive
                for rid, req in reps[i].scheduler.requests.items()
                if not req.done
            ]
            if live:
                r.evict(rng.choice(live))
        elif len(alive) >= 2:
            r.fail_replica(rng.choice(alive))
        # cross-replica conservation after every operation
        for i, rep in enumerate(reps):
            rep.scheduler.check_invariants(
                peers=[x.scheduler for j, x in enumerate(reps) if j != i]
            )


# ---------------------------------------------------------------------------
# Engine (single process, CPU)


@pytest.fixture(scope="module")
def jax_pair():
    """The reference model and parameters, and the port's model built from
    the same parameters."""
    jmodel = j_build(jreduced(get_config("minicpm-2b")))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    cfg = reduced(MINICPM_2B)
    model = build_model(
        cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu"),
        device="cpu",
    )
    return jmodel, jparams, model


PROMPTS = np.array([[3, 1, 4], [1, 5, 9], [2, 6, 5]], np.int32)
GEN = 5


def test_engine_bitwise_matches_serial_serve_batch(jax_pair):
    _, _, model = jax_pair
    cfg = model.cfg
    ref = serve_batch(model, torch.from_numpy(PROMPTS), gen_len=GEN,
                      max_len=16, device="cpu").numpy()
    # 2 slots for 3 requests: the third joins a slot freed in flight; the
    # prompts' bucket is 8 (the reference pads to it, the port need not)
    engine = ServeEngine(model, num_slots=2, max_len=16,
                         buckets=PromptBuckets([8]), device="cpu")
    reqs = [engine.submit(list(p), b)
            for p, b in zip(PROMPTS, (GEN, GEN - 2, GEN))]
    assert all(r.bucket_len == 8 for r in reqs)
    out = engine.run()
    assert engine.idle
    for i, req in enumerate(reqs):
        want = ref[i, : req.max_new_tokens].tolist()
        assert out[req.rid] == want, (i, out[req.rid], want)
    rows = engine.fit_rows()
    want_bytes = engine.b_max * cfg.vocab_size * 4
    assert rows and all(
        n == want_bytes and t > 0 and k == 1 for (n, t, k) in rows
    )


def test_serve_batch_matches_reference(jax_pair):
    jmodel, jparams, model = jax_pair
    ref = np.asarray(j_serve_batch(jmodel, jparams,
                                   jax.numpy.asarray(PROMPTS),
                                   gen_len=GEN, max_len=16))
    got = serve_batch(model, torch.from_numpy(PROMPTS), gen_len=GEN,
                      max_len=16, device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref)


def test_serve_batch_eos_matches_reference(jax_pair):
    jmodel, jparams, model = jax_pair
    free = serve_batch(model, torch.from_numpy(PROMPTS), gen_len=GEN,
                       max_len=16, device="cpu").numpy()
    eos = int(free[0, 2])
    ref = np.asarray(j_serve_batch(jmodel, jparams,
                                   jax.numpy.asarray(PROMPTS), gen_len=GEN,
                                   max_len=16, eos_id=eos))
    got = serve_batch(model, torch.from_numpy(PROMPTS), gen_len=GEN,
                      max_len=16, eos_id=eos, device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref)


def test_engine_eos_early_finish(jax_pair):
    _, _, model = jax_pair
    probe = ServeEngine(model, num_slots=1, max_len=16,
                        buckets=PromptBuckets([4]), device="cpu")
    free_run = probe.submit([3, 1, 4], 5)
    toks = probe.run()[free_run.rid]
    eos = toks[2]
    engine = ServeEngine(model, num_slots=1, max_len=16,
                         buckets=PromptBuckets([4]), eos_id=eos,
                         device="cpu")
    req = engine.submit([3, 1, 4], 5)
    out = engine.run()
    assert out[req.rid] == toks[: toks.index(eos) + 1]
    assert req.state == FINISHED and engine.idle


def test_engine_extras_are_rejected(jax_pair):
    _, _, model = jax_pair
    engine = ServeEngine(model, num_slots=1, max_len=8, device="cpu")
    with pytest.raises(ValueError):
        engine.submit([1], 1, extras={"frames": None})


def test_engine_rejects_prompts_past_the_largest_bucket(jax_pair):
    _, _, model = jax_pair
    engine = ServeEngine(model, num_slots=1, max_len=16,
                         buckets=PromptBuckets([4]), device="cpu")
    with pytest.raises(ValueError):
        engine.submit([1, 2, 3, 4, 5], 2)


WORKLOAD = (([3, 1, 4], 5), ([1, 5, 9, 2, 6], 4), ([2, 7, 1, 8], 6),
            ([9, 9, 2], 3), ([4, 4, 4, 4, 4, 4, 4], 7))


def _streams(make):
    """Continuous batching with in-flight admission: two requests, one
    step, the rest."""
    eng = make()
    reqs = [eng.submit(p, b) for p, b in WORKLOAD[:2]]
    eng.step()
    reqs += [eng.submit(p, b) for p, b in WORKLOAD[2:]]
    out = eng.run()
    return [out[r.rid] for r in reqs]


@pytest.mark.parametrize("eos", [False, True])
def test_engine_streams_match_reference_engine(jax_pair, eos):
    jmodel, jparams, model = jax_pair
    eos_id = 425 if eos else None
    ref = _streams(lambda: JEngine(
        jmodel, jparams, num_slots=3, max_len=24,
        buckets=JBuckets([4, 8]), eos_id=eos_id))
    got = _streams(lambda: ServeEngine(
        model, num_slots=3, max_len=24, buckets=PromptBuckets([4, 8]),
        eos_id=eos_id, device="cpu"))
    assert got == ref
    if eos:
        assert any(425 in s for s in got)


def test_engine_continuous_equals_serial_with_slices(jax_pair):
    _, _, model = jax_pair

    def make():
        return ServeEngine(model, num_slots=3, max_len=24,
                           buckets=PromptBuckets([4, 8]), slice_len=3,
                           device="cpu")

    serial = tw.serve_serial(make(), WORKLOAD)
    assert _streams(make) == serial


def test_router_fail_replica_resumes_every_request(jax_pair):
    """One model, two engines; replica 0 dies after two steps.  Its
    requests are re-planned onto replica 1, which replays the tokens they
    had generated: every accepted request ends with its serial tokens."""
    _, _, model = jax_pair

    def make():
        return ServeEngine(model, num_slots=2, max_len=32,
                           buckets=PromptBuckets([8]), device="cpu")

    serial = tw.serve_serial(make(), WORKLOAD[:4])
    a, b = make(), make()
    router = Router([a, b])
    reqs = [router.submit(p, n) for p, n in WORKLOAD[:4]]
    assert {router.placement[r.rid] for r in reqs} == {0, 1}
    for _ in range(2):
        a.step()
        b.step()
    assert any(r.generated and router.placement[r.rid] == 0 for r in reqs)
    router.fail_replica(0)
    while not b.idle:
        b.step()
    for req, want in zip(reqs, serial):
        assert req.state == FINISHED
        assert req.generated == want, (req.rid, req.generated, want)
    b.scheduler.check_invariants(peers=[a.scheduler])


# ---------------------------------------------------------------------------
# the tensor-parallel head on gloo worlds


@pytest.fixture(scope="module")
def serve_worlds(tmp_path_factory, jax_pair):
    """The reference's meshed engine (2x2, 4 devices) and the port's
    2x2 and 2x3 worlds from the same parameters, run side by side."""
    jmodel, jparams, _ = jax_pair
    out = tmp_path_factory.mktemp("serve")
    params0 = {f"leaf{i}": np.asarray(p)
               for i, p in enumerate(jax.tree.leaves(jparams))}
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    jproc = subprocess.Popen(
        [sys.executable, str(tw.__file__), "jax_serve", str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        ranks = {}
        for world in (4, 6):
            d = out / f"w{world}"
            d.mkdir()
            np.savez(d / "params0.npz", **params0)
            ranks[world] = tw.spawn_world("serve", d, world=world)
        log = jproc.communicate(timeout=600)[0]
    finally:
        if jproc.poll() is None:
            jproc.kill()
            jproc.wait()
    assert jproc.returncode == 0, log[-3000:]
    with np.load(out / "jax.npz") as z:
        meshed = {k: z[k] for k in z.files}
    single = tw.serve_serial(JEngine(
        jmodel, jparams, num_slots=tw.SERVE_SLOTS, max_len=tw.SERVE_MAX_LEN,
        buckets=JBuckets(tw.SERVE_BUCKETS)))
    return ranks, meshed, single


@pytest.mark.parametrize("world", [4, 6])
def test_tp_engine_continuous_equals_serial(serve_worlds, world):
    ranks, _, single = serve_worlds
    rows = ranks[world]
    n = len(tw.SERVE_WORKLOAD)
    for r in rows:
        for i in range(n):
            np.testing.assert_array_equal(r[f"cont{i}"], r[f"serial{i}"])
            np.testing.assert_array_equal(r[f"cont{i}"], rows[0][f"cont{i}"])
            # the tensor-parallel head picks the single-device tokens
            assert r[f"serial{i}"].tolist() == single[i]
            budget = tw.SERVE_WORKLOAD[i][1]
            assert len(r[f"serial{i}"]) == budget


@pytest.mark.parametrize("world", [4, 6])
def test_tp_engine_eos_exit(serve_worlds, world):
    for r in serve_worlds[0][world]:
        eos = int(r["eos_id"])
        for i in range(len(tw.SERVE_WORKLOAD)):
            full = r[f"serial{i}"].tolist()
            want = full[: full.index(eos) + 1] if eos in full else full
            assert r[f"eos{i}"].tolist() == want


@pytest.mark.parametrize("world", [4, 6])
def test_tp_engine_dispatch(serve_worlds, world):
    r = serve_worlds[0][world][0]
    assert str(r["dispatch/logits_allreduce"]) == "nap"
    assert str(r["dispatch/hidden_allgather"]) == "mla_ag"
    assert str(r["dispatch/eos_min_reduce"]) == "psum"
    from repro_torch.core import napalg

    assert int(r["b_max"]) == max(napalg.ragged_splits(tw.SERVE_SLOTS, world))


@pytest.mark.parametrize("world", [4, 6])
def test_serve_batch_eos_exit_agreed_by_the_group(serve_worlds, world):
    """Each rank serves one row; the early exit waits for every rank's
    row, so each row equals its row of the whole batch in one process."""
    for rank, r in enumerate(serve_worlds[0][world]):
        np.testing.assert_array_equal(r["batch_row"][0],
                                      r["batch_ref"][rank])


def test_tp_engine_2x2_matches_reference_meshed_engine(serve_worlds):
    ranks, meshed, _ = serve_worlds
    for r in ranks[4]:
        for i in range(len(tw.SERVE_WORKLOAD)):
            np.testing.assert_array_equal(r[f"serial{i}"],
                                          meshed[f"serial{i}"])
            np.testing.assert_array_equal(r[f"cont{i}"], meshed[f"cont{i}"])
