"""Request lifecycle + continuous-batching scheduler (host-side).

The port of ``repro/serve/scheduler.py``, unchanged in behaviour.  The
serving spine's control plane: pure-Python state machines with no
torch dependency, so every invariant is cheaply fuzzable.  The device
side (:mod:`repro_torch.serve.engine`) only ever asks three questions at a
decode-step boundary — *who joined*, *who is active*, *who is done* —
and this module answers them under the invariants the tests enforce:

* **slot conservation** — every slot is free or holds exactly one
  active request; ``len(free) + len(active) == num_slots`` always;
* **FIFO fairness** — admission order equals arrival order: a request
  is never admitted while an earlier admissible one still queues;
* **silence after the end** — a finished / evicted / rejected request
  never records another token.

Request lifecycle::

    submit() ──> QUEUED ──admit()──> ACTIVE ──record_token()──> FINISHED
                   │                    │
                   └── (queue full: REJECTED)   └──evict()──> EVICTED

Membership changes happen only at decode-step boundaries: the engine
calls :meth:`Scheduler.admit` between decode slices, never inside one —
exactly the continuous-batching contract (in-flight insertion into free
slots, eviction of finished requests, the rest undisturbed).

Prompt shapes ride padded buckets (:class:`PromptBuckets`, the saxml
``servable_model`` pattern): a prompt is padded up to the smallest
registered bucket length, so the number of distinct prefill traces is
bounded by the bucket count, not by the number of distinct prompt
lengths ever seen.

Ragged batch geometry reuses :func:`repro_torch.core.napalg.ragged_splits`:
:meth:`Scheduler.shard_geometry` splits the slot range over the serving
group's chips with the same uneven-block rule the MLA stripe layout
uses, so a slot count that does not divide the chip count costs at most
one padded slot per chip in the executed lowering — never a resize.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Iterable, Sequence

__all__ = [
    "Request",
    "PromptBuckets",
    "Scheduler",
    "QUEUED",
    "ACTIVE",
    "FINISHED",
    "EVICTED",
    "REJECTED",
]

QUEUED = "queued"
ACTIVE = "active"
FINISHED = "finished"
EVICTED = "evicted"
REJECTED = "rejected"

#: states in which a request will never emit another token
TERMINAL = (FINISHED, EVICTED, REJECTED)

#: process-global request ids: a request rerouted between replicas keeps
#: its rid, so ids must be unique across schedulers, not within one
_GLOBAL_IDS = itertools.count()


@dataclasses.dataclass
class Request:
    """One serving request: prompt in, generated tokens out.

    The scheduler owns ``state``/``slot``; callers treat them as
    read-only.  Timestamps (``arrival``/``admitted_at``/``finished_at``
    and per-token ``token_times``) are whatever clock the driver passes
    in — wall seconds in the engine, simulated seconds in the load
    benchmark — and exist for the latency percentiles.
    """

    rid: int
    prompt: tuple[int, ...]
    max_new_tokens: int
    arrival: float = 0.0
    extras: dict | None = None   # e.g. encoder frames for enc-dec archs

    state: str = QUEUED
    slot: int | None = None
    bucket_len: int | None = None
    generated: list[int] = dataclasses.field(default_factory=list)
    admitted_at: float | None = None
    finished_at: float | None = None
    token_times: list[float] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.prompt = tuple(int(t) for t in self.prompt)
        if not self.prompt:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}"
            )

    @property
    def done(self) -> bool:
        return self.state in TERMINAL

    @property
    def remaining(self) -> int:
        """Token budget left (0 once terminal)."""
        if self.done:
            return 0
        return self.max_new_tokens - len(self.generated)


class PromptBuckets:
    """Padded-shape prompt buckets bounding the prefill trace count.

    ``lengths`` are the allowed padded prompt lengths (sorted,
    deduplicated).  :meth:`bucket_len` pads a prompt up to the smallest
    bucket that holds it, so the engine compiles at most
    ``len(lengths)`` prefill programs however many distinct prompt
    lengths arrive — the saxml padded-shape dispatch pattern.
    """

    def __init__(self, lengths: Iterable[int]):
        self.lengths: tuple[int, ...] = tuple(
            sorted({int(l) for l in lengths})
        )
        if not self.lengths:
            raise ValueError("need at least one bucket length")
        if self.lengths[0] < 1:
            raise ValueError(f"bucket lengths must be >= 1: {self.lengths}")

    @classmethod
    def geometric(
        cls, max_len: int, *, start: int = 8, factor: int = 2
    ) -> "PromptBuckets":
        """Geometric ladder ``start, start*factor, ... >= max_len`` —
        O(log(max_len)) traces with <= ``factor``x padding waste."""
        if factor < 2:
            raise ValueError(f"factor must be >= 2, got {factor}")
        edges = []
        l = max(1, int(start))
        while l < int(max_len):
            edges.append(l)
            l *= factor
        edges.append(int(max_len))
        return cls(edges)

    @property
    def max_len(self) -> int:
        return self.lengths[-1]

    def bucket_len(self, prompt_len: int) -> int:
        """Smallest bucket holding ``prompt_len`` (raises past the top)."""
        for l in self.lengths:
            if prompt_len <= l:
                return l
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest bucket "
            f"{self.lengths[-1]}"
        )


class Scheduler:
    """Continuous-batching slot scheduler for one serving replica.

    ``num_slots`` is the decode batch width (the device-side slot
    count); ``max_queue`` bounds the admission queue (``None`` =
    unbounded) — a submit past the bound is **rejected**, the
    backpressure signal the router spreads load on.
    """

    def __init__(
        self,
        num_slots: int,
        *,
        max_queue: int | None = None,
        buckets: PromptBuckets | None = None,
        eos_id: int | None = None,
    ):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if max_queue is not None and max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        self.num_slots = int(num_slots)
        self.max_queue = max_queue
        self.buckets = buckets
        self.eos_id = eos_id
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * self.num_slots
        # free slots kept sorted so slot assignment is deterministic
        self._free: list[int] = list(range(self.num_slots))
        self._ids = _GLOBAL_IDS
        self.requests: dict[int, Request] = {}
        self.n_rejected = 0

    # -- admission ---------------------------------------------------------

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        *,
        arrival: float = 0.0,
        extras: dict | None = None,
    ) -> Request:
        """Admission control: enqueue, or mark REJECTED when the queue
        is full.  Returns the request either way (check ``state``)."""
        req = Request(
            rid=next(self._ids),
            prompt=tuple(prompt),
            max_new_tokens=int(max_new_tokens),
            arrival=arrival,
            extras=extras,
        )
        if self.buckets is not None:
            # validate at admission time, not at prefill time
            req.bucket_len = self.buckets.bucket_len(len(req.prompt))
        self.requests[req.rid] = req
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            req.state = REJECTED
            self.n_rejected += 1
            return req
        self.queue.append(req)
        return req

    def enqueue(self, req: Request, *, force: bool = False) -> Request:
        """Re-queue an existing QUEUED request (router rerouting path).

        Acceptance is binding: a request that was admitted to some
        queue must never be silently dropped mid-flight, so a full
        queue **raises** here instead of rejecting — callers check
        :attr:`queue_capacity` first (or pass ``force=True``, the
        replica-loss re-plan path, where transiently overshooting the
        backpressure bound beats losing accepted work).
        """
        if req.state != QUEUED:
            raise ValueError(
                f"only QUEUED requests can be enqueued, got {req.state}"
            )
        if (
            not force
            and self.max_queue is not None
            and len(self.queue) >= self.max_queue
        ):
            raise ValueError(
                f"queue full ({len(self.queue)}/{self.max_queue}); "
                f"rejecting an already-accepted request would break "
                f"conservation — check queue_capacity before enqueue"
            )
        if self.buckets is not None:
            req.bucket_len = self.buckets.bucket_len(len(req.prompt))
        self.requests[req.rid] = req
        self.queue.append(req)
        return req

    def admit(self, *, now: float = 0.0) -> list[Request]:
        """Fill free slots from the queue head (FIFO) — called by the
        engine at a decode-step boundary, never inside a slice.

        Returns the newly admitted requests (they need a prefill +
        cache insertion before the next decode step).
        """
        admitted = []
        while self._free and self.queue:
            req = self.queue.popleft()
            slot = self._free.pop(0)
            req.slot = slot
            req.state = ACTIVE
            req.admitted_at = now
            self.slots[slot] = req
            admitted.append(req)
        return admitted

    # -- decode-step results ----------------------------------------------

    def record_token(
        self, slot: int, token: int, *, now: float = 0.0
    ) -> Request | None:
        """One generated token for ``slot``'s request.  Finishes the
        request on EOS or budget exhaustion and frees the slot; returns
        the request if it just finished, else None.

        A token for a free slot (evicted / never filled) is dropped —
        the engine decodes padded and garbage slots unconditionally and
        relies on this being a no-op.
        """
        req = self.slots[slot]
        if req is None:
            return None
        assert not req.done, "terminal request still held a slot"
        req.generated.append(int(token))
        req.token_times.append(now)
        if (
            (self.eos_id is not None and int(token) == self.eos_id)
            or len(req.generated) >= req.max_new_tokens
        ):
            self._release(req, FINISHED, now=now)
            return req
        return None

    def evict(self, rid: int, *, now: float = 0.0) -> Request:
        """Cancel a request.  ACTIVE: frees its slot (the engine masks
        it at the next boundary).  QUEUED: removed from the queue.
        Terminal: no-op.  Raises ``KeyError`` for a rid this replica
        does not own (e.g. one already rerouted away)."""
        if rid not in self.requests:
            raise KeyError(
                f"rid {rid} is not owned by this replica (rerouted away "
                f"or never submitted here)"
            )
        req = self.requests[rid]
        if req.done:
            return req
        if req.state == QUEUED:
            self.queue.remove(req)
            req.state = EVICTED
            req.finished_at = now
            return req
        self._release(req, EVICTED, now=now)
        return req

    def _release(self, req: Request, state: str, *, now: float) -> None:
        slot = req.slot
        assert slot is not None and self.slots[slot] is req
        self.slots[slot] = None
        self._free.append(slot)
        self._free.sort()
        req.slot = None
        req.state = state
        req.finished_at = now

    def drain_queue(self) -> list[Request]:
        """Remove and return every queued request (router rerouting on a
        degraded replica); they stay QUEUED for re-submission.

        Ownership transfers with the request: the drained rids leave
        this replica's registry, so exactly one scheduler ever answers
        for a live rid (a stale registry entry would let an evict race
        the reroute and corrupt the new owner's queue).
        """
        out = list(self.queue)
        self.queue.clear()
        for req in out:
            self.requests.pop(req.rid, None)
        return out

    def drain_active(self) -> list[Request]:
        """Demote every ACTIVE request back to QUEUED and free its slot
        (replica-loss re-planning: the KV state is gone, survivors
        re-prefill ``prompt + generated`` elsewhere).  Returns them in
        slot order with ownership removed, ready to ``enqueue`` on a
        surviving replica."""
        out = []
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            self.slots[slot] = None
            self._free.append(slot)
            req.slot = None
            req.state = QUEUED
            self.requests.pop(req.rid, None)
            out.append(req)
        self._free.sort()
        return out

    @property
    def queue_capacity(self) -> int | None:
        """Admission slots left in the queue (``None`` = unbounded) —
        the router's pre-reroute capacity check."""
        if self.max_queue is None:
            return None
        return max(0, self.max_queue - len(self.queue))

    # -- views -------------------------------------------------------------

    def active(self) -> list[Request]:
        return [r for r in self.slots if r is not None]

    @property
    def free_slots(self) -> tuple[int, ...]:
        return tuple(self._free)

    def active_mask(self) -> list[bool]:
        """Per-slot occupancy, index-aligned with the device batch."""
        return [r is not None for r in self.slots]

    @property
    def idle(self) -> bool:
        return not self.queue and not any(self.slots)

    def outstanding_tokens(self) -> int:
        """Token budget still owed (queued + active) — the router's
        load metric."""
        return sum(r.remaining for r in self.queue) + sum(
            r.remaining for r in self.slots if r is not None
        )

    def shard_geometry(self, group: int) -> tuple[int, ...]:
        """Per-chip slot counts over a ``group``-chip serving grid —
        the uneven-block split of :func:`repro_torch.core.napalg.ragged_splits`
        (the executed lowering pads every chip to ``max(geometry)``)."""
        from ..core import napalg

        return napalg.ragged_splits(self.num_slots, group)

    def check_invariants(self, peers: Sequence["Scheduler"] = ()) -> None:
        """Assert the scheduler's structural invariants (test hook).

        With ``peers`` (the other replicas behind the same router) this
        becomes the cross-replica conservation check: a live rid is
        held and registered by exactly one scheduler in the group, and
        every replica's outstanding-token figure is consistent with its
        per-request token counts.
        """
        occupied = [i for i, r in enumerate(self.slots) if r is not None]
        assert len(self._free) + len(occupied) == self.num_slots, (
            self._free, occupied,
        )
        assert not (set(self._free) & set(occupied))
        assert sorted(self._free) == list(self._free)
        for i in occupied:
            req = self.slots[i]
            assert req.slot == i and req.state == ACTIVE
        for req in self.queue:
            assert req.state == QUEUED and req.slot is None
        # outstanding-token accounting consistent with per-request
        # token counts (the router's load metric must never drift)
        live = list(self.queue) + self.active()
        for req in live:
            assert req.remaining == req.max_new_tokens - len(req.generated), (
                req.rid, req.remaining, req.max_new_tokens, req.generated,
            )
            assert req.remaining >= 1, (req.rid, req.state)
        assert self.outstanding_tokens() == sum(r.remaining for r in live)
        if not peers:
            return
        # global rid uniqueness across the replica group: each live rid
        # is registered with exactly one scheduler and held in exactly
        # one container
        group = (self, *peers)
        registered: dict[int, int] = {}
        held: dict[int, int] = {}
        for gi, s in enumerate(group):
            for rid, req in s.requests.items():
                if req.done:
                    continue
                assert rid not in registered, (
                    f"live rid {rid} registered with schedulers "
                    f"{registered[rid]} and {gi}"
                )
                registered[rid] = gi
            for req in list(s.queue) + s.active():
                assert req.rid not in held, (
                    f"live rid {req.rid} held by schedulers "
                    f"{held[req.rid]} and {gi}"
                )
                held[req.rid] = gi
                assert req.rid in s.requests, (
                    f"rid {req.rid} held by scheduler {gi} but not "
                    f"registered there"
                )
