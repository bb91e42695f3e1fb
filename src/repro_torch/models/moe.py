"""Mixture-of-Experts FFN: top-k routing over capacity-bounded buckets.

The port of the local route of ``repro/models/moe.py`` (all experts on
one device; the reference's expert-parallel ``all_to_all`` route is not
ported yet).  Tokens are bucketed per expert at deterministic cumsum
positions, in the reference's (token, k) order; an item whose position
reaches the expert's capacity is dropped (it lands on an overflow row that
the gather reads as zero).  The buckets run through a batched
(E, C, D) x (E, D, F) GLU and a gather restores token order.  DeepSeek-
style shared experts ride the dense path; the Switch-style load-balance
loss is returned for the trainer.

``groups`` splits the tokens into equal groups routed independently, each
with its own buckets and capacity.  The serving engine routes every slot
row as its own group, as the reference's engine does by vmapping a B=1
decode: a row's routing then never depends on its batch neighbours, and a
group of one token is never dropped (capacity is at least 8 and top-k
experts are distinct).  A fixed batch routes as one group, capacity
reckoned over all its tokens, as the reference's ``decode_step`` does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import _ACTS, dense, glu_mlp, init_dense, init_glu_mlp
from .sharding import is_dtensor

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
                 cap_factor, act, groups: int = 1):
    """All experts resident locally: bucket per expert (per group), batched
    GLU, gather.  x_flat: (T, D); top_idx / top_gate: (T, K)."""
    T, D = x_flat.shape
    E = we_gate.shape[0]
    K = top_idx.shape[1]
    tg = T // groups
    cap = _capacity(tg, K, E, cap_factor)
    dest = top_idx.reshape(groups, tg * K)
    pos, keep = _bucket_positions(dest, E, cap)
    # an expert gets at most one item per token of a group (the top-k
    # experts are distinct), so rows past ``tg`` would stay empty: hold
    # min(cap, tg) rows; which items are dropped (pos >= cap) is unchanged
    rows = min(cap, tg)
    base = torch.arange(groups, device=x_flat.device)[:, None] * (E * rows)
    overflow = groups * E * rows
    slot = torch.where(keep, base + dest * rows + pos,
                       overflow).reshape(-1)
    src = torch.repeat_interleave(x_flat, K, dim=0)
    buf = torch.zeros((overflow + 1, D), dtype=x_flat.dtype,
                      device=x_flat.device).index_put((slot,), src)
    xe = buf[:-1].reshape(groups, E, rows, D).transpose(0, 1)
    out = _expert_ffn(we_gate, we_up, we_down,
                      xe.reshape(E, groups * rows, D), act)
    y = out.reshape(E, groups, rows, D).transpose(0, 1).reshape(overflow, D)
    y = torch.cat([y, y.new_zeros((1, D))])  # dropped -> 0
    gathered = y[slot] * top_gate.reshape(-1)[:, None].to(y.dtype)
    return gathered.reshape(T, K, D).sum(dim=1)


def moe_apply(params, x: torch.Tensor, *, cfg, groups: int = 1):
    """MoE FFN: x (B, S, D) -> (y (B, S, D), aux_loss scalar).

    ``groups`` (dividing B * S): independent routing groups of consecutive
    tokens (the engine passes B, one per slot row).  Not on a mesh: the
    capacity buckets of DTensor tokens come out wrong, and the reference's
    expert-parallel route (``_route_ep``) is not ported, so a DTensor input
    raises ``NotImplementedError``."""
    if is_dtensor(x):
        raise NotImplementedError(
            "MoE on a mesh (the capacity buckets over sharded tokens and "
            "the reference's expert-parallel route) is not ported yet"
        )
    m = cfg.moe
    B, S, D = x.shape
    logits = dense(x.to(torch.float32), params["w_router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    top_gate, top_idx = torch.topk(probs, m.top_k, dim=-1)
    top_gate = top_gate / torch.clamp_min(
        top_gate.sum(-1, keepdim=True), 1e-9
    )  # renormalise over selected

    # Switch-style load-balance loss
    density = F.one_hot(top_idx, m.num_experts).to(torch.float32).mean(
        dim=(0, 1, 2))
    mean_prob = probs.mean(dim=(0, 1))
    aux = m.router_aux_weight * m.num_experts * torch.sum(density * mean_prob)

    routed = _route_local(
        x.reshape(B * S, D),
        top_idx.reshape(B * S, m.top_k),
        top_gate.reshape(B * S, m.top_k),
        params["we_gate"], params["we_up"], params["we_down"],
        cap_factor=m.capacity_factor, act=cfg.act, groups=groups,
    )
    y = routed.reshape(B, S, D)
    if "shared" in params:
        y = y + glu_mlp(params["shared"], x, cfg.act)
    return y.to(x.dtype), aux
