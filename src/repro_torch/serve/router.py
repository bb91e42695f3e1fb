"""Multi-replica data-parallel request router for the serving spine.

The port of ``repro/serve/router.py``, unchanged in behaviour.

Spreads requests over independent serving replicas (each a
:class:`repro_torch.serve.engine.ServeEngine`, or anything exposing the same
``submit`` / ``outstanding_tokens`` / ``scheduler`` surface) by
**outstanding-token load** — the token budget still owed by a replica's
queue plus its active slots, the quantity that actually predicts its
drain time under continuous batching (queue *length* does not: one
queued 4k-token request outweighs ten 8-token ones).

Health is driven by :class:`repro_torch.runtime.fault.ReplicaHealth` straggler
signals: feed per-slice step times in with :meth:`observe_step`; when a
replica degrades (a straggler event), the router stops routing to it
and **reroutes its queued requests** to healthy replicas — queued only:
active requests keep their slots (their KV state lives on the degraded
replica; rerouting them would re-prefill, usually slower than riding
out the stall).  ``recovery`` consecutive clean steps readmit it.

A replica *death* is harsher than a stall: :meth:`fail_replica` re-plans
everything the dead replica held — queued requests move like a reroute,
active ones are demoted back to QUEUED (their KV state died with the
replica) and re-queued on survivors, bypassing the backpressure bound
(transiently overshooting ``max_queue`` beats dropping accepted work).

Every placement decision is **fully deterministic**: candidates are
scanned as ascending replica indices and ties break on the stable
index, never on dict/set iteration order — so an event trace recorded
by the layer-0 protocol checker (:mod:`repro_torch.analysis.protocol_check`)
replays bit-identically.  Two protocol invariants the checker pins:

* **acceptance is binding** — once a request is QUEUED somewhere it is
  never silently REJECTED by a reroute into a full peer queue; if no
  peer has capacity the request stays (still accepted) where it is;
* **single ownership** — a live rid is registered with exactly one
  scheduler, so an evict can never race a reroute through a stale
  registry entry.
"""

from __future__ import annotations

from ..runtime.fault import ReplicaHealth, StragglerMonitor
from .scheduler import REJECTED, Request

__all__ = ["Router"]


class Router:
    """Load-based router over serving replicas.

    Args:
      replicas: the serving engines (index order is the tiebreak order).
      health: optional per-replica :class:`ReplicaHealth`; by default
        each replica gets one with a fresh :class:`StragglerMonitor`.
    """

    def __init__(
        self,
        replicas,
        *,
        health: list[ReplicaHealth] | None = None,
        straggler_threshold: float = 2.0,
        recovery: int = 5,
    ):
        if not replicas:
            raise ValueError("need at least one replica")
        self.replicas = list(replicas)
        if health is None:
            health = [
                ReplicaHealth(
                    StragglerMonitor(threshold=straggler_threshold),
                    recovery=recovery,
                )
                for _ in self.replicas
            ]
        if len(health) != len(self.replicas):
            raise ValueError("one ReplicaHealth per replica")
        self.health = health
        self.placement: dict[int, int] = {}  # rid -> replica index
        self.failed: set[int] = set()        # dead replicas (fail_replica)
        self.n_rerouted = 0

    # -- routing -----------------------------------------------------------

    def _eligible(self) -> list[int]:
        alive = [
            i for i in range(len(self.replicas)) if i not in self.failed
        ]
        if not alive:
            raise RuntimeError("all replicas have failed")
        healthy = [i for i in alive if self.health[i].healthy]
        # all degraded: route anyway (stalled beats dropped)
        return healthy or alive

    def _place(self, candidates: list[int]) -> int:
        """Deterministic placement: least outstanding tokens, ties
        broken by the stable replica index.  ``candidates`` is always
        an ascending index list — never dict/set iteration order — so
        recorded traces replay bit-identically."""
        return min(
            candidates,
            key=lambda i: (self.replicas[i].outstanding_tokens(), i),
        )

    def _with_capacity(self, candidates: list[int]) -> list[int]:
        return [
            i
            for i in candidates
            if self.replicas[i].scheduler.queue_capacity != 0
        ]

    def pick(self) -> int:
        """Least-loaded eligible replica (lowest index breaks ties),
        preferring replicas with queue capacity: a submit is only
        rejected when *no* eligible replica can accept it, not because
        the least-loaded one happens to be full."""
        eligible = self._eligible()
        roomy = self._with_capacity(eligible)
        return self._place(roomy or eligible)

    def submit(self, prompt, max_new_tokens: int, **kw) -> Request:
        i = self.pick()
        req = self.replicas[i].submit(prompt, max_new_tokens, **kw)
        if req.state != REJECTED:
            self.placement[req.rid] = i
        return req

    def evict(self, rid: int) -> Request:
        """Cancel a request wherever it currently lives — placement is
        kept reroute-accurate, so callers need not track which replica
        owns a rid."""
        return self.replicas[self.placement[rid]].scheduler.evict(rid)

    # -- health signals ----------------------------------------------------

    def observe_step(self, replica: int, step: int, duration: float) -> bool:
        """Feed one decode-slice wall-clock for ``replica``; on a
        health transition to degraded, reroute its queued requests.
        Returns the replica's post-update health.

        On a serving group of more than one process (every rank runs this
        router and the replicas' tensor-parallel steps), feed a
        ``duration`` that every rank agrees on, e.g. each rank's step time
        maxed over the group (``ctx.allreduce(t, op="max",
        algorithm="psum")``).  Each rank's own host clock differs: the
        ranks would then disagree on a replica's health, reroute
        differently, run different engine steps, and the next collective
        would hang.  (The reference has one controller and never meets
        this.)"""
        was = self.health[replica].healthy
        ok = self.health[replica].record(step, duration)
        if was and not ok:
            self.reroute(replica)
        return ok

    def reroute(self, replica: int) -> int:
        """Move ``replica``'s queued (not yet active) requests to the
        healthiest least-loaded peers **with queue capacity**; a
        request no peer can hold stays (still accepted, FIFO position
        preserved) on the degraded replica — acceptance is binding, so
        a reroute never turns an accepted request REJECTED.  Returns
        how many moved."""
        src = self.replicas[replica].scheduler
        eligible = [i for i in self._eligible() if i != replica]
        if not eligible:
            return 0
        moved = 0
        for req in src.drain_queue():
            roomy = self._with_capacity(eligible)
            if roomy:
                dst = self._place(roomy)
                self.replicas[dst].scheduler.enqueue(req)
                self.placement[req.rid] = dst
                moved += 1
            else:
                src.enqueue(req, force=True)
        self.n_rerouted += moved
        return moved

    def fail_replica(self, replica: int) -> int:
        """Replica death: re-plan everything it held onto survivors.

        Queued requests move like a reroute; ACTIVE ones are demoted
        back to QUEUED (:meth:`Scheduler.drain_active` — their KV state
        died with the replica, survivors re-prefill) and re-queued
        behind them.  Placement is force-enqueued past the survivors'
        backpressure bound: transiently overshooting ``max_queue`` is
        recoverable, dropping accepted work is not.  The dead replica
        never receives traffic again.  Returns how many requests were
        re-planned; raises ``RuntimeError`` if no replica survives.
        """
        self.failed.add(replica)
        sched = self.replicas[replica].scheduler
        peers = self._eligible()  # excludes the newly failed replica
        moved = 0
        # actives first: they were admitted before anything queued, so
        # re-queuing them ahead preserves arrival-order fairness
        for req in sched.drain_active() + sched.drain_queue():
            dst = self._place(peers)
            self.replicas[dst].scheduler.enqueue(req, force=True)
            self.placement[req.rid] = dst
            moved += 1
        self.n_rerouted += moved
        return moved

    # -- views -------------------------------------------------------------

    def loads(self) -> list[int]:
        return [r.outstanding_tokens() for r in self.replicas]

    @property
    def idle(self) -> bool:
        return all(r.idle for r in self.replicas)
