"""Mixture-of-Experts FFN: top-k routing over capacity-bounded buckets.

The port of ``repro/models/moe.py``.  Tokens are bucketed per expert at
deterministic cumsum positions, in the reference's (token, k) order; an
item whose position reaches the expert's capacity is dropped (it lands on
an overflow row that the gather reads as zero).  The buckets run through a
batched (E, C, D) x (E, D, F) GLU and a gather restores token order.
DeepSeek-style shared experts ride the dense path; the Switch-style
load-balance loss is returned for the trainer.

``groups`` splits the tokens into equal groups routed independently, each
with its own buckets and capacity.  The serving engine routes every slot
row as its own group, as the reference's engine does by vmapping a B=1
decode: a row's routing then never depends on its batch neighbours, and a
group of one token is never dropped (capacity is at least 8 and top-k
experts are distinct).  A fixed batch routes as one group, capacity
reckoned over all its tokens, as the reference's ``decode_step`` does.

On a mesh (DTensor tokens under a policy with one) the routing runs on
each rank's blocks with explicit collectives, as the reference's
``shard_map`` (:func:`~repro_torch.models.sharding.local_block` /
:func:`~repro_torch.models.sharding.from_block` carry its gradient rule),
by the reference's own choice of route:

* :func:`_route_ep` where the experts divide over a model axis of more
  than one rank: inside each DP shard the tokens are bucketed by
  destination rank at that shard's capacity and exchanged with one
  :func:`~repro_torch.core.collectives.all_to_all` over the model axis,
  bucketed per local expert, run, and sent back.  In train mode the
  expert weights' FSDP dims are gathered first; in ``serve2d`` their F
  dim stays over the data axes and the down-projection's partial sums
  take one sum over them.
* the local route otherwise, every expert gathered on every rank, with
  the capacity and the bucket positions of the *global* tokens (as GSPMD
  keeps them): a rank's positions continue those of the ranks before it
  (one all-gather of E counts over the DP axes).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.collectives import all_to_all, psum
from .layers import _ACTS, dense, glu_mlp, init_dense, init_glu_mlp
from .sharding import (
    ShardingPolicy, block_index, from_block, is_dtensor, local_block,
)
from ..trace_regions import count_moe_route, span

__all__ = ["init_moe", "moe_apply"]


def init_moe(cfg, dtype, *, lead=(), generator, device):
    m = cfg.moe
    d = cfg.d_model
    mk = lambda shape, dt=dtype: init_dense(lead + shape, dt,
                                            generator=generator,
                                            device=device)
    params = {
        "w_router": mk((d, m.num_experts), torch.float32),
        "we_gate": mk((m.num_experts, d, m.d_expert)),
        "we_up": mk((m.num_experts, d, m.d_expert)),
        "we_down": mk((m.num_experts, m.d_expert, d)),
    }
    if m.num_shared_experts:
        params["shared"] = init_glu_mlp(
            d, m.num_shared_experts * m.d_expert, dtype, lead=lead,
            generator=generator, device=device,
        )
    return params


def _capacity(tokens: int, k: int, buckets: int, factor: float) -> int:
    cap = int(math.ceil(tokens * k / buckets * factor))
    return max(8, ((cap + 7) // 8) * 8)  # pad to 8 (the reference's tiles)


def _bucket_positions(dest: torch.Tensor, n_buckets: int, cap: int):
    """Deterministic position of each item inside its destination bucket.

    dest: (..., N) bucket ids, counted along the last axis.  Returns
    ``(pos, keep)``, both (..., N)."""
    onehot = F.one_hot(dest, n_buckets)
    pos = torch.cumsum(onehot, dim=-2) - 1  # (..., N, buckets)
    pos = torch.gather(pos, -1, dest[..., None])[..., 0]
    return pos, pos < cap


def _expert_ffn(we_gate, we_up, we_down, x, act: str):
    """Batched per-expert GLU: x (E, C, D) -> (E, C, D)."""
    h = _ACTS[act](torch.matmul(x, we_gate))
    h = h * torch.matmul(x, we_up)
    return torch.matmul(h, we_down)


def _route_local(x_flat, top_idx, top_gate, we_gate, we_up, we_down, *,
                 cap_factor, act, groups: int = 1, cap: int | None = None,
                 offset: torch.Tensor | None = None):
    """All experts resident locally: bucket per expert (per group), batched
    GLU, gather.  x_flat: (T, D); top_idx / top_gate: (T, K).  ``cap``
    overrides the capacity; ``offset`` (E,) adds to every item's position
    the items that earlier token blocks put in its expert (the global
    positions of a rank's tokens), for the keep test only."""
    T, D = x_flat.shape
    E = we_gate.shape[0]
    K = top_idx.shape[1]
    tg = T // groups
    if cap is None:
        cap = _capacity(tg, K, E, cap_factor)
    dest = top_idx.reshape(groups, tg * K)
    pos, keep = _bucket_positions(dest, E, cap)
    if offset is not None:
        keep = pos + offset[dest] < cap
    # an expert gets at most one item per token of a group (the top-k
    # experts are distinct), so rows past ``tg`` would stay empty: hold
    # min(cap, tg) rows; which items are dropped (pos >= cap) is unchanged
    rows = min(cap, tg)
    count_moe_route(T * K, groups * E * rows, keep)
    base = torch.arange(groups, device=x_flat.device)[:, None] * (E * rows)
    overflow = groups * E * rows
    slot = torch.where(keep, base + dest * rows + pos,
                       overflow).reshape(-1)
    src = torch.repeat_interleave(x_flat, K, dim=0)
    buf = torch.zeros((overflow + 1, D), dtype=x_flat.dtype,
                      device=x_flat.device).index_put((slot,), src)
    xe = buf[:-1].reshape(groups, E, rows, D).transpose(0, 1)
    with span("moe.experts"):
        out = _expert_ffn(we_gate, we_up, we_down,
                          xe.reshape(E, groups * rows, D), act)
    y = out.reshape(E, groups, rows, D).transpose(0, 1).reshape(overflow, D)
    y = torch.cat([y, y.new_zeros((1, D))])  # dropped -> 0
    gathered = y[slot] * top_gate.reshape(-1)[:, None].to(y.dtype)
    return gathered.reshape(T, K, D).sum(dim=1)


def _route_ep(x_flat, top_idx, top_gate, we_gate, we_up, we_down, *,
              group, cap_factor, act, partial=None):
    """Two-hop expert-parallel dispatch on this rank's blocks (the
    reference's ``_route_ep`` inside its ``shard_map``).  x_flat (T, D) and
    top_idx / top_gate (T, K): this DP shard's tokens; the expert weights
    are this rank's ``e_local`` experts, whole in D (and in F unless
    ``partial``); ``group`` the model axis's process group, whose rank
    ``j`` holds experts ``[j * e_local, (j + 1) * e_local)``.
    ``partial(t)``: the sum over the ranks that hold the other F slices
    (``serve2d``)."""
    ranks = torch.distributed.get_world_size(group)
    e_local = we_gate.shape[0]
    T, D = x_flat.shape
    K = top_idx.shape[1]

    # hop 1: bucket by destination rank
    dest_rank = (top_idx // e_local).reshape(-1)
    cap_s = _capacity(T, K, ranks, cap_factor)
    pos1, keep1 = _bucket_positions(dest_rank, ranks, cap_s)
    slot1 = torch.where(keep1, dest_rank * cap_s + pos1, ranks * cap_s)
    send = torch.zeros((ranks * cap_s + 1, D), dtype=x_flat.dtype,
                       device=x_flat.device).index_put(
        (slot1,), torch.repeat_interleave(x_flat, K, dim=0))
    send_eid = torch.full((ranks * cap_s + 1,), -1, dtype=torch.int32,
                          device=x_flat.device).index_put(
        (slot1,), (top_idx % e_local).reshape(-1).to(torch.int32))
    N = ranks * cap_s
    recv = all_to_all(send[:-1].reshape(ranks, cap_s, D), group)
    recv = recv.reshape(N, D)
    recv_eid = all_to_all(send_eid[:-1].reshape(ranks, cap_s), group)
    recv_eid = recv_eid.reshape(N)

    # hop 2: bucket the received tokens per local expert.  With one local
    # expert every received token lands on it, so no second capacity
    # factor applies.  Empty received rows count as expert 0's when the
    # positions are taken (the reference's positions), so an expert may
    # need all cap_e rows
    cap_e = _capacity(N, 1, e_local, cap_factor if e_local > 1 else 1.0)
    valid = recv_eid >= 0
    dest2 = torch.where(valid, recv_eid, 0).long()
    pos2, keep2 = _bucket_positions(dest2, e_local, cap_e)
    keep2 &= valid
    slot2 = torch.where(keep2, dest2 * cap_e + pos2, e_local * cap_e)
    buf = torch.zeros((e_local * cap_e + 1, D), dtype=recv.dtype,
                      device=recv.device).index_put((slot2,), recv)
    out = _expert_ffn(we_gate, we_up, we_down,
                      buf[:-1].reshape(e_local, cap_e, D), act)
    if partial is not None:  # serve2d: F was sharded -> partial sums
        out = partial(out)
    y = torch.cat([out.reshape(e_local * cap_e, D), out.new_zeros((1, D))])
    back = y[slot2]  # (N, D): dropped -> 0, in the received order

    # the reverse of hop 1
    ret = all_to_all(back.reshape(ranks, cap_s, D), group).reshape(N, D)
    ret = torch.cat([ret, ret.new_zeros((1, D))])
    gathered = ret[slot1] * top_gate.reshape(-1)[:, None].to(ret.dtype)
    return gathered.reshape(T, K, D).sum(dim=1)


class _FirstCopy(torch.autograd.Function):
    """Rank 0 of ``group``'s ``y`` on every rank of it; the gradient passes
    through unchanged (each rank's own share)."""

    @staticmethod
    def forward(ctx, y, group):
        y = y.contiguous().clone()
        torch.distributed.broadcast(
            y, src=torch.distributed.get_global_rank(group, 0), group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _router(w_router, x, m):
    """Top-k routing of ``x`` (b, s, D): ``(top_gate, top_idx)`` (b, s, K),
    renormalised over the selected experts, and the per-expert routed
    share and mean probability over these tokens (the load-balance loss's
    two factors)."""
    logits = dense(x.to(torch.float32), w_router.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    top_gate, top_idx = torch.topk(probs, m.top_k, dim=-1)
    top_gate = top_gate / torch.clamp_min(
        top_gate.sum(-1, keepdim=True), 1e-9
    )  # renormalise over selected
    density = F.one_hot(top_idx, m.num_experts).to(torch.float32).mean(
        dim=(0, 1, 2))
    return top_gate, top_idx, density, probs.mean(dim=(0, 1))


def _aux(m, density, mean_prob):
    """The Switch-style load-balance loss."""
    return m.router_aux_weight * m.num_experts * torch.sum(density
                                                           * mean_prob)


def use_ep(policy, num_experts: int, tokens: int) -> bool:
    """The reference's choice of the expert-parallel route: experts that
    divide over a model axis of more than one rank, and tokens that divide
    over the DP axes (decode with fewer rows takes the local route)."""
    return (policy.mesh is not None and policy.tp_axis is not None
            and policy.tp_size > 1 and num_experts % policy.tp_size == 0
            and tokens % max(policy.dp_size, 1) == 0)


def _psum(t, dm, dims):
    """``t`` summed over the mesh dimensions ``dims`` (process groups of
    more than one rank), differentiable: the gradient takes the same sum,
    as ``lax.psum`` inside the reference's ``shard_map``."""
    for i in dims:
        t = psum(t, dm.get_group(i))
    return t


def _moe_on_mesh(params, x, *, cfg, policy):
    """:func:`moe_apply` for DTensor tokens under a policy on a mesh."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    m = cfg.moe
    B, S, D = x.shape
    dm = policy.device_mesh
    names = list(dm.mesh_dim_names)
    rep = [Replicate()] * dm.ndim
    # the tokens' rows over the DP axes where they divide (the reference's
    # shard_map takes x_flat as P(dp, None)); replicated in serve2d
    x = policy.constrain(x, (policy.dp, None, None))
    xf = policy.constrain(x.reshape(B * S, D), (policy.dp, None))
    tok = list(xf.placements)
    blocks = [i for i, p in enumerate(tok) if p == Shard(0)]
    n_blk = math.prod(dm.size(i) for i in blocks)
    x_loc = local_block(xf, tok)
    T = x_loc.shape[0]
    x3 = x_loc.reshape(-1, S, D) if T % S == 0 else x_loc[None]
    top_gate, top_idx, density, mean_prob = _router(
        local_block(params["w_router"], rep), x3, m)
    top_idx = top_idx.reshape(T, m.top_k)
    top_gate = top_gate.reshape(T, m.top_k)
    if n_blk > 1:  # the means over the global tokens (equal blocks)
        density = _psum(density, dm, blocks) / n_blk
        mean_prob = _psum(mean_prob, dm, blocks) / n_blk
    aux = from_block(_aux(m, density, mean_prob), dm, rep)

    wnames = ("we_gate", "we_up", "we_down")
    if use_ep(policy, m.num_experts, B * S):
        tp = names.index(policy.tp_axis)
        partial = None
        if policy.mode == "serve2d":  # F stays over the data axes
            w = [local_block(params[n], list(params[n].placements))
                 for n in wnames]
            f_dims = [i for i, p in enumerate(params["we_down"].placements)
                      if p == Shard(1)]
            if f_dims:
                partial = lambda t: _psum(t, dm, f_dims)  # noqa: E731
        else:  # train: the FSDP dims gathered, the experts kept on tp
            w = [local_block(params[n], [Shard(0) if i == tp else Replicate()
                                         for i in range(dm.ndim)])
                 for n in wnames]
        group = dm.get_group(tp)
        y = _route_ep(x_loc, top_idx, top_gate, *w, group=group,
                      cap_factor=m.capacity_factor, act=cfg.act,
                      partial=partial)
        # the model ranks of a DP shard route copies of the same tokens,
        # and the copies a later rank sends drop first in hop 2: where
        # drops differ, the reference's replicated output is the first
        # rank's copy, and the gradient each copy's own
        y = _FirstCopy.apply(y, group)
    else:
        w = [local_block(params[n], rep) for n in wnames]
        E = m.num_experts
        cap = _capacity(B * S, m.top_k, E, m.capacity_factor)
        offset = None
        if n_blk > 1:  # this block's positions continue the earlier ones'
            counts = F.one_hot(top_idx.reshape(-1), E).sum(dim=0)
            every = DTensor.from_local(
                counts[None], dm,
                [Shard(0) if i in blocks else Replicate()
                 for i in range(dm.ndim)], run_check=False).full_tensor()
            offset = every[:block_index(dm, blocks)].sum(dim=0)
        y = _route_local(x_loc, top_idx, top_gate, *w,
                         cap_factor=m.capacity_factor, act=cfg.act, cap=cap,
                         offset=offset)
    y = from_block(y, dm, tok).reshape(B, S, D)
    if "shared" in params:
        y = y + glu_mlp(params["shared"], x, cfg.act)
    return y.to(x.dtype), aux


def moe_apply(params, x: torch.Tensor, *, cfg, groups: int = 1,
              policy: ShardingPolicy = ShardingPolicy()):
    """MoE FFN: x (B, S, D) -> (y (B, S, D), aux_loss scalar).

    ``groups`` (dividing B * S): independent routing groups of consecutive
    tokens (the engine passes B, one per slot row).  With DTensor tokens
    under a ``policy`` on a mesh, the reference's routes on the mesh
    (:func:`_moe_on_mesh`; one group)."""
    if policy.mesh is not None and is_dtensor(x):
        if groups != 1:
            raise ValueError("per-row MoE groups (the serving engine's "
                             "slots) run without a mesh")
        return _moe_on_mesh(params, x, cfg=cfg, policy=policy)
    m = cfg.moe
    B, S, D = x.shape
    # the router and the routes read one flat view of the tokens, as on a
    # mesh: their gradients add up there before the shared experts' do
    x_flat = x.reshape(B * S, D)
    with span("moe.route"):
        top_gate, top_idx, density, mean_prob = _router(
            params["w_router"], x_flat.reshape(B, S, D), m)
        routed = _route_local(
            x_flat,
            top_idx.reshape(B * S, m.top_k),
            top_gate.reshape(B * S, m.top_k),
            params["we_gate"], params["we_up"], params["we_down"],
            cap_factor=m.capacity_factor, act=cfg.act, groups=groups,
        )
    y = routed.reshape(B, S, D)
    if "shared" in params:
        y = y + glu_mlp(params["shared"], x, cfg.act)
    return y.to(x.dtype), _aux(m, density, mean_prob)
