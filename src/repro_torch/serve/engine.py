"""ServeEngine: continuous-batching serving replica over slot-stacked caches.

The port of ``repro/serve/engine.py``.  One engine owns one model
replica's decode state and drives it with the host-side
:class:`repro_torch.serve.scheduler.Scheduler`:

* **slot-stacked cache** — one decode cache whose batch rows are the
  slots, each row at its own index (the model's per-row decode), so
  membership changes are per-row copies and the decode batch never
  changes shape.  Every slot row routes its MoE token as its own group
  (``moe_per_row``), as the reference's engine does by vmapping a B=1
  decode: a row's tokens never depend on its neighbours;
* **prefill** — each admitted request prefills alone (B=1) by feeding its
  prompt through the cached decode step, and its B=1 cache is copied into
  its slot row.  The reference pads the prompt to its bucket and keeps
  the state after the real tokens with a ``where`` snapshot, only so
  that XLA compiles one program per bucket; run eagerly, feeding the real
  tokens alone computes exactly what that snapshot keeps, so the port
  does not pad.  The scheduler keeps the bucket semantics (admission,
  ``bucket_len``, rejecting prompts past the largest bucket);
* **sliced decode** — between membership boundaries the engine runs one
  :func:`repro_torch.serve.decode.make_decode_slice` (up to
  ``slice_len`` tokens with the group-agreed EOS early exit); with a
  multi-rank ``ctx`` each rank holds its block of slot rows and the head
  is tensor-parallel.

The slot count is ragged over the serving group
(:meth:`Scheduler.shard_geometry`); every rank holds ``max(geometry)``
rows and the scheduler never fills the pad rows.  Every rank runs the same
scheduler, prefills every admitted request and keeps the rows it owns.

An encoder-decoder engine (``extras_template``) takes each request's
encoder inputs as its ``extras`` (``{"frames": (1, S_enc, D)}``): the B=1
prefill builds its cache, the encoder output ``enc_out`` included, from
them, and the slot row takes that ``enc_out`` with the rest.  Free slot
rows hold the encoder output of zero frames of the template's shape.

A request that a dead replica's router re-planned here
(:meth:`repro_torch.serve.router.Router.fail_replica`) arrives QUEUED
with the tokens it had generated.  The engine prefills its prompt and
then feeds those tokens again (teacher-forced, not recorded) before it
records new ones, so the stream goes on from where it stopped.
"""

from __future__ import annotations

import collections
import time
from typing import Callable

import numpy as np
import torch

from .. import tree
from ..core import comm
from ..device import require_on
from . import decode as _decode
from .scheduler import PromptBuckets, Request, Scheduler

__all__ = ["ServeEngine"]


class ServeEngine:
    """Continuous-batching engine for one serving replica.

    Args:
      model: a :class:`repro_torch.models.Model` on ``device``.
      num_slots: logical decode batch width (the scheduler's slot count);
        with a multi-rank ``ctx`` padded up to a multiple of the group.
      max_len: KV cache length per slot.
      buckets: prompt-length buckets (default: geometric up to
        ``max_len``).
      eos_id: early-exit token (None disables EOS handling).
      slice_len: decode steps per slice; membership changes only at slice
        boundaries (default 1: per-token boundaries).
      ctx: serving group; with more than one rank the head is
        tensor-parallel.  ``torch.distributed`` must span the group.
      mesh: a :class:`~repro_torch.launch.mesh.Mesh` whose DP axes are the
        serving group, as the reference's: without a ``ctx`` the group is
        ``CommContext(Topology.from_mesh(mesh))`` (``model`` is then a
        ``mesh=None`` model on every rank of a world of the mesh's size).
      max_queue: admission-control bound (None = unbounded).
      extras_template: the shapes and dtypes (any tensors, ``meta`` ones
        will do) of the per-request extras of an encoder-decoder arch,
        e.g. ``{"frames": (1, S_enc, D)}``; requests must then carry
        matching ``extras``, and must not without a template.
      device: where the engine runs (``cuda`` unless asked otherwise).
    """

    def __init__(
        self,
        model,
        *,
        num_slots: int,
        max_len: int,
        buckets: PromptBuckets | None = None,
        eos_id: int | None = None,
        slice_len: int = 1,
        mesh=None,
        ctx: comm.CommContext | None = None,
        max_queue: int | None = None,
        extras_template: dict | None = None,
        clock: Callable[[], float] = time.monotonic,
        device=None,
    ):
        self.device = require_on(model, device)
        self.model = model
        self.extras_template = extras_template
        self.max_len = int(max_len)
        self.slice_len = int(slice_len)
        self.eos_id = eos_id
        self.clock = clock
        if buckets is None:
            buckets = PromptBuckets.geometric(self.max_len)
        self.scheduler = Scheduler(
            num_slots, max_queue=max_queue, buckets=buckets, eos_id=eos_id
        )
        if mesh is not None and ctx is None:
            ctx = comm.CommContext(comm.Topology.from_mesh(mesh))
        self.ctx = ctx
        self.group = ctx.topology.group if ctx is not None else 1
        geometry = self.scheduler.shard_geometry(self.group)
        self.b_max = max(geometry)
        self.padded_slots = self.b_max * self.group
        rank = (ctx.topology.require_groups().rank
                if self.group > 1 else 0)
        self._rows = range(rank * self.b_max, (rank + 1) * self.b_max)

        # -- device state --------------------------------------------------
        self._cache = self._init_slot_cache()
        self._tok = torch.zeros((self.padded_slots, 1), dtype=torch.long,
                                device=self.device)
        self._mask = np.zeros((self.padded_slots,), bool)
        self._active = torch.zeros((self.padded_slots,), dtype=torch.bool,
                                   device=self.device)
        # -- the decode path: one float32 head copy per engine --------------
        self._head = _decode.make_tp_head(model, ctx)
        self._prefill_head = (self._head if self.group == 1
                              else _decode.make_tp_head(model, None))
        self._slice = _decode.make_decode_slice(
            model, ctx, slice_len=self.slice_len, eos_id=eos_id,
            head=self._head,
        )
        # resumed requests: tokens still to feed / to leave unrecorded
        self._forced: dict[int, collections.deque] = {}
        self._skip: dict[int, int] = {}

        # -- accounting ----------------------------------------------------
        self.step_times: list[tuple[int, float, int]] = []  # fit-shaped rows
        self.n_slices = 0
        self.n_decode_steps = 0

    # -- extras ------------------------------------------------------------

    def _b1_extras(self):
        """Zero extras of the template's shapes and dtypes, or None without
        a template."""
        if self.extras_template is None:
            return None
        return {k: torch.zeros(t.shape, dtype=t.dtype, device=self.device)
                for k, t in self.extras_template.items()}

    def _init_slot_cache(self):
        """The decode cache of ``b_max`` slot rows: a B=1 cache (the
        encoder run once, on zero extras) broadcast over the rows, as the
        reference does.  Stack leaves are (n_super, rows, ...); ``index``
        and ``enc_out`` have the rows first."""
        b1 = self.model.init_decode(1, self.max_len, batch=self._b1_extras())

        def rows(x, axis):
            shape = list(x.shape)
            shape[axis] = self.b_max
            return x.expand(shape).clone()

        cache = {"index": rows(b1["index"], 0),
                 "stack": tree.tree_map(lambda x: rows(x, 1), b1["stack"])}
        if "enc_out" in b1:
            cache["enc_out"] = rows(b1["enc_out"], 0)
        return cache

    def _request_extras(self, req: Request):
        """``req``'s extras as tensors on this engine's device, or None."""
        if req.extras is None:
            return None
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in req.extras.items()}

    # -- prefill ---------------------------------------------------------

    @torch.no_grad()
    def _prefill(self, req: Request):
        """B=1 prefill of ``req``'s prompt: ``(cache, first token)``."""
        cache = self.model.init_decode(1, self.max_len,
                                       batch=self._request_extras(req))
        prompt = torch.tensor(req.prompt, dtype=torch.long,
                              device=self.device)
        hidden = None
        for t in range(len(req.prompt)):
            hidden, cache = self.model.decode_hidden(cache, prompt[None, t:t + 1])
        return cache, self._prefill_head(hidden)[0, 0]

    @torch.no_grad()
    def _insert(self, req: Request) -> None:
        """Prefill ``req`` and put it in its slot row."""
        cache_b1, tok0 = self._prefill(req)
        slot = req.slot
        self._forced.pop(slot, None)
        self._skip.pop(slot, None)
        if req.generated:  # resumed: replay what it had generated
            tok0 = torch.tensor(req.generated[0], device=self.device)
            self._forced[slot] = collections.deque(req.generated[1:])
            self._skip[slot] = len(req.generated)
        if slot in self._rows:
            row = slot - self._rows.start
            self._cache["index"][row] = cache_b1["index"][0]
            # every stack leaf is (n_super, rows, ...), whatever the mixer
            for full, one in zip(tree.leaves(self._cache["stack"]),
                                 tree.leaves(cache_b1["stack"])):
                full[:, row] = one[:, 0]
            # the encoder output has no n_super axis: (rows, S_enc, D)
            if "enc_out" in self._cache:
                self._cache["enc_out"][row] = cache_b1["enc_out"][0]
        self._tok[slot, 0] = tok0

    # -- request lifecycle ---------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *,
               arrival: float | None = None,
               extras: dict | None = None) -> Request:
        if (extras is None) != (self.extras_template is None):
            raise ValueError(
                "request extras must match the engine's extras_template"
            )
        return self.scheduler.submit(
            prompt, max_new_tokens,
            arrival=self.clock() if arrival is None else arrival,
            extras=extras,
        )

    def evict(self, rid: int) -> Request:
        req = self.scheduler.evict(rid, now=self.clock())
        self._sync_active()
        return req

    def outstanding_tokens(self) -> int:
        return self.scheduler.outstanding_tokens()

    @property
    def idle(self) -> bool:
        return self.scheduler.idle

    def _sync_active(self):
        """Slot occupancy to the device, when it changed (a copy from the
        host waits for the card)."""
        mask = np.zeros((self.padded_slots,), bool)
        mask[: self.scheduler.num_slots] = self.scheduler.active_mask()
        if not np.array_equal(mask, self._mask):
            self._mask = mask
            self._active.copy_(torch.from_numpy(mask))

    # -- the decode-step boundary -------------------------------------------

    def step(self, *, now: float | None = None) -> list[Request]:
        """One continuous-batching boundary: admit into free slots (B=1
        prefill, copied into slot rows), run one decode slice, record the
        emitted tokens.  Returns the requests that *finished* during this
        step.  No-op (returns ``[]``) when nothing is active."""
        now = self.clock() if now is None else now
        for req in self.scheduler.admit(now=now):
            self._insert(req)
        self._sync_active()
        if not any(self.scheduler.active_mask()):
            return []

        t0 = self.clock()
        with torch.no_grad():
            out, self._tok, steps_run = self._slice(
                self._cache, self._tok, self._active, self._forced
            )
        out = out.cpu().numpy()
        t1 = self.clock()

        finished: list[Request] = []
        for t in range(steps_run):
            for slot in range(self.scheduler.num_slots):
                if self._skip.get(slot):
                    self._skip[slot] -= 1
                    continue
                # record_token drops tokens of free slots, so pad rows and
                # post-EOS columns are no-ops
                done = self.scheduler.record_token(
                    slot, int(out[slot, t]), now=t1
                )
                if done is not None:
                    finished.append(done)
        for slot in [s for s, q in self._forced.items() if not q]:
            del self._forced[slot]
        self._sync_active()

        # MachineParams.fit-shaped row for the logits allreduce this slice
        # ran: (nbytes, seconds per step, senders)
        if steps_run:
            nbytes = self.group * self.b_max * self.model.cfg.vocab_size * 4
            self.step_times.append((int(nbytes), (t1 - t0) / steps_run, 1))
            self.n_slices += 1
            self.n_decode_steps += steps_run
        return finished

    def run(self, *, max_steps: int = 100_000) -> dict[int, list[int]]:
        """Drive :meth:`step` until idle; returns ``rid -> tokens`` for
        every request that reached a terminal state."""
        for _ in range(max_steps):
            if self.idle:
                break
            self.step()
        else:
            raise RuntimeError(f"not idle after {max_steps} engine steps")
        return {
            rid: list(req.generated)
            for rid, req in self.scheduler.requests.items()
            if req.done
        }

    # -- introspection -------------------------------------------------------

    def dispatch_report(self) -> dict[str, dict]:
        """The (engine, chunks) decision for each decode-step collective at
        this engine's payload sizes."""
        if self.ctx is None:
            return {}
        return decode_dispatch(self.ctx, self.model.cfg, self.group,
                               self.b_max)

    def fit_rows(self) -> list[tuple[int, float, int]]:
        """Per-decode-step wall clock as ``MachineParams.fit`` rows
        ``(size_bytes, seconds, senders)``."""
        return list(self.step_times)


def decode_dispatch(ctx: comm.CommContext, cfg, group: int,
                    b_max: int) -> dict[str, dict]:
    """The dispatch decisions of the three decode-step collectives of a
    ``group``-rank engine with ``b_max`` slot rows a rank (planning: the
    topology needs no process groups)."""
    topo = ctx.topology
    d_cols = -(-cfg.d_model // max(group, 1))
    rows = group * b_max
    payloads = {
        "logits_allreduce": (rows * cfg.vocab_size * 4, "sum", "allreduce",
                             None),
        "hidden_allgather": (rows * d_cols * group * 4, "sum", "allgather",
                             "mla_ag" if topo.has_slow_domain else None),
        "eos_min_reduce": (4, "min", "allreduce", "psum"),
    }
    report = {}
    for name, (nbytes, op, coll, pin) in payloads.items():
        d = ctx.dispatch(int(nbytes), op, collective=coll, algorithm=pin)
        report[name] = {
            "nbytes": int(nbytes),
            "op": op,
            "collective": coll,
            "engine": d.engine,
            "pipeline_chunks": d.chunks,
        }
    return report
