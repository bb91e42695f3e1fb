"""`CommContext`-routed tensor-parallel decode path for the serving spine.

The port of ``repro/serve/decode.py``: building blocks shared by
:class:`repro_torch.serve.engine.ServeEngine` and
:mod:`repro_torch.launch.serve`.  Three decode-time collectives, each
routed where the cost model says it belongs:

* **per-token logits allreduce** — the latency-regime workload the paper
  optimises: the partial head products are ``group * slots * V`` floats,
  auto-dispatched (NAP on multi-node grids below
  ``Topology.crossover_bytes()``);
* **hidden-state gather** — every rank's slot rows rebuilt on every rank
  through ``ctx.allgather`` pinned to ``mla_ag`` on multi-node grids,
  whose lane-major payload layout :func:`payload_block_index` mirrors;
* **EOS early-exit min-reduce** — pinned to the native ``psum`` engine:
  a value that decides whether the next step (and its collectives) runs
  must be the same on every rank.

The tensor-parallel head splits the ``D`` contraction, not the vocab:
every rank sees the full gathered hidden block, contracts its own
``D/group`` column slice against the same slice of the head matrix, and
the logits allreduce sums the slices.  The ``argmax`` stays local.

The head holds one float32 copy of its head-matrix slice, made once when
the head is built (a bf16 value is exact in float32, so the products are
the reference's bf16 x bf16 -> float32 ones; with TF32 off they are exact
float32 products).  Casting the head on every step instead would write and
read it again in float32 each token.  The copy does not follow later
changes to the model's weights.

The reference's ``lax.while_loop``s become host loops.  The EOS early exit
reads the group-agreed stop flag on the host (one sync) before each further
step of a slice.
"""

from __future__ import annotations

import torch

from ..core import comm
from ..models.layers import softcap

__all__ = [
    "payload_block_index",
    "group_all_min",
    "make_tp_head",
    "make_decode_slice",
    "make_decode_loop",
    "greedy_step",
]


def payload_block_index(topology: comm.Topology, rank: int) -> int:
    """Rank ``rank``'s block index in the striped allgather payload.

    ``mla_allgather`` rebuilds the flat payload lane-major: each lane's
    stripe is the inter-node gather of that lane's node shards, so rank
    ``node * ppn + lane`` owns block ``lane * n_nodes + node``.  On grids
    with one node or one lane this is the rank itself, the layout of the
    flat fallback engine."""
    node, lane = divmod(int(rank), topology.ppn)
    return lane * topology.n_nodes + node


def _rank(topology: comm.Topology) -> int:
    return topology.require_groups().rank if topology.group > 1 else 0


def group_all_min(ctx: comm.CommContext | None,
                  flag: torch.Tensor) -> torch.Tensor:
    """Group-agreed "everyone done" flag, pinned to the native ``psum``
    engine (a whole-group reduction every rank takes part in)."""
    if ctx is None or ctx.topology.group == 1:
        return flag
    return ctx.allreduce(flag, op="min", algorithm="psum")


def make_tp_head(model, ctx: comm.CommContext | None = None):
    """Build the greedy head: ``head(hidden (b, 1, D)) -> tokens (b, 1)``.

    With a multi-rank ``ctx`` the input is this rank's slot rows and the
    result the same rows' next tokens; ``head(hidden, all_rows=True)``
    gives every rank's rows instead, ``(group * b, 1)`` in rank order.
    Without one (or on a grid of one) it is the local head: float32
    products, softcap after, argmax.
    """
    cfg = model.cfg
    emb = model.head_weights().T  # (V, D), the tied embedding's layout
    if ctx is None or ctx.topology.group == 1:
        w32 = emb.detach().to(torch.float32)

        def local_head(hidden, *, all_rows=False):
            b = hidden.shape[0]
            logits = torch.matmul(hidden.reshape(b, -1).to(torch.float32),
                                  w32.T)
            logits = softcap(logits, cfg.final_logit_softcap)
            return torch.argmax(logits, dim=-1)[:, None]

        return local_head

    topo = ctx.topology
    group = topo.group
    D = cfg.d_model
    # pad the contraction so every rank owns an equal column slice; the
    # zero columns contribute nothing
    d_cols = -(-D // group)
    Dp = d_cols * group
    ag_algorithm = "mla_ag" if topo.has_slow_domain else None
    bi = payload_block_index(topo, _rank(topo))
    lo, hi = bi * d_cols, min((bi + 1) * d_cols, D)
    w32 = torch.zeros((emb.shape[0], d_cols), dtype=torch.float32,
                      device=emb.device)
    w32[:, : max(0, hi - lo)] = emb[:, lo:hi].detach()
    # block ``payload_block_index(rank)`` of the gathered rows belongs to
    # rank ``rank``: the permutation back to rank order
    blocks = torch.tensor([payload_block_index(topo, r) for r in range(group)],
                          device=emb.device)

    def tp_head(hidden, *, all_rows=False):
        b, s, _ = hidden.shape
        if s != 1:
            raise ValueError(f"the decode head takes one position, got {s}")
        h = hidden.reshape(b, D).to(torch.float32)
        if Dp != D:
            h = torch.nn.functional.pad(h, (0, Dp - D))
        full = ctx.allgather(
            h.reshape(-1), elems=group * b * Dp, algorithm=ag_algorithm
        ).reshape(group * b, Dp)
        partial = torch.matmul(full[:, bi * d_cols : (bi + 1) * d_cols],
                               w32.T)
        # the latency-regime allreduce: auto dispatch
        logits = ctx.allreduce(partial, op="sum")
        logits = softcap(logits, cfg.final_logit_softcap)
        tok = torch.argmax(logits, dim=-1).reshape(group, b)
        if all_rows:
            return tok[blocks].reshape(group * b, 1)
        return tok[bi][:, None]

    return tp_head


def greedy_step(model, ctx: comm.CommContext | None = None):
    """One-token cached greedy decode:
    ``step(cache, tokens (B, 1)) -> (next tokens (B, 1), cache)``.

    A model on a mesh (built under a policy with one) takes no ``ctx``: it
    runs its own head under the policy (:meth:`Model.decode_step`, the
    logits laid out as ``logits``), each rank takes the argmax of its rows
    over the whole vocabulary, and every rank returns all the rows' tokens
    as a plain tensor."""
    if getattr(model, "on_mesh", False):
        if ctx is not None:
            raise ValueError("a model on a mesh runs its own head; the "
                             "tensor-parallel head takes a mesh=None model")
        return _mesh_greedy_step(model)
    head = make_tp_head(model, ctx)

    def step(cache, tokens):
        hidden, cache = model.decode_hidden(cache, tokens)
        return head(hidden), cache

    return step


def _mesh_greedy_step(model):
    from ..models.sharding import from_block

    policy = model.policy

    def step(cache, tokens):
        logits, cache = model.decode_step(cache, tokens)
        with policy.scope():
            rows = policy.constrain(logits[:, -1], (policy.dp, None))
            tok = torch.argmax(rows.to_local(), dim=-1)[:, None]
            tok = from_block(tok, rows.device_mesh, rows.placements)
            return tok.full_tensor(), cache

    return step


# ---------------------------------------------------------------------------
# slot-stacked decode slice (the engine's inner loop)
# ---------------------------------------------------------------------------


def make_decode_slice(model, ctx: comm.CommContext | None, *,
                      slice_len: int, eos_id: int | None = None, head=None):
    """Build the decode slice
    ``slice_fn(cache, tok, active, forced=None) -> (out, tok', steps)``.

    ``cache`` holds this rank's ``b`` slot rows (each at its own index);
    ``tok`` is ``(group * b, 1)``, the next token of every slot row of the
    group, and ``active`` ``(group * b,)`` slot occupancy.  The slice
    records up to ``slice_len`` tokens per row into ``out (group * b,
    steps)`` (column ``t`` is the token fed at step ``t``) and returns the
    carry token for the next slice and ``steps``, the number of steps
    run: the EOS early exit is agreed by the group, so every rank runs the
    same number.  Inactive rows still compute (the scheduler drops their
    tokens) but count as done, so they never hold up the early exit.
    ``forced`` maps a row to tokens that replace its next tokens, one a
    step (a request resumed on another replica replays what it had
    generated).  The cache is updated in place.
    """
    head = head if head is not None else make_tp_head(model, ctx)
    group = 1 if ctx is None else ctx.topology.group

    def slice_fn(cache, tok, active, forced=None):
        rows = tok.shape[0]
        b = rows // group
        lo = (0 if group == 1 else _rank(ctx.topology)) * b
        own = slice(lo, lo + b)
        out = torch.zeros((rows, slice_len), dtype=tok.dtype,
                          device=tok.device)
        done = ~active[own]
        steps = 0
        while steps < slice_len:
            out[:, steps] = tok[:, 0]
            hidden, cache = model.decode_hidden(cache, tok[own],
                                                moe_per_row=True)
            nxt = head(hidden, all_rows=True)
            if forced:
                for row, queue in forced.items():
                    if queue:
                        nxt[row, 0] = queue.popleft()
            stop = None
            if eos_id is not None:
                done = done | (tok[own, 0] == eos_id)
                nxt[own] = torch.where(done[:, None], eos_id, nxt[own])
                stop = group_all_min(ctx, done.all().to(torch.float32))
            tok = nxt
            steps += 1
            if stop is not None and steps < slice_len and stop.item() >= 0.5:
                break
        return out[:, :steps], tok, steps

    return slice_fn


# ---------------------------------------------------------------------------
# whole-batch greedy decode loop (the launch/serve.py driver's core)
# ---------------------------------------------------------------------------


def make_decode_loop(model, ctx: comm.CommContext | None = None, *,
                     gen_len: int, eos_id: int | None = None):
    """Build the greedy decode loop ``decode(cache, tok) -> (B, gen_len)``
    tokens (the fixed-batch serve path).

    ``tok`` is the (B, 1) first generated token.  With ``eos_id`` the loop
    exits once every sequence has emitted it; with a multi-rank ``ctx``,
    once every sequence *of the group* has (the local all-done flag
    min-reduced through :func:`group_all_min`, read on the host each
    step).  Finished rows keep emitting ``eos_id``; columns after an early
    exit are 0.
    """

    def decode(cache, tok):
        B = tok.shape[0]
        out = torch.zeros((B, gen_len), dtype=torch.long, device=tok.device)
        done = torch.zeros((B,), dtype=torch.bool, device=tok.device)
        for t in range(gen_len):
            out[:, t] = tok[:, 0]
            logits, cache = model.decode_step(cache, tok)
            nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
            if eos_id is not None:
                done = done | (tok[:, 0] == eos_id)
                nxt = torch.where(done[:, None], eos_id, nxt)
                stop = group_all_min(ctx, done.all().to(torch.float32))
                if stop.item() >= 0.5:
                    break
            tok = nxt
        return out

    return decode
