"""RWKV6 "Finch" mixer: linear attention with data-dependent decay.

The port of ``repro/models/rwkv.py``.  Time-mix recurrence per head
(state S in R^{hd x hd}):

    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)     [bonus u on the current]
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

with w_t = exp(-exp(decay_t)) produced by a low-rank "LoRA" from the
token-shifted input.  The full-sequence mixer loops over time (the
reference's ``lax.scan``); decode is O(1) on a cache of the previous
token and the float32 state, written in place.  Channel-mix is the
squared-relu FFN of the RWKV family, with its own token shift.  As in the
reference, this module is the oracle of the RWKV6 scan kernel
(``repro_torch.kernels.rwkv6_scan``) and does not call it.
"""

from __future__ import annotations

import torch

from ..trace_regions import kernel_region
from .layers import dense, init_dense
from .sharding import ShardingPolicy, assign, on_blocks, split_dim

__all__ = ["init_rwkv", "rwkv_full", "init_rwkv_cache", "rwkv_decode",
           "init_rwkv_cm", "rwkv_cm_full", "rwkv_cm_decode"]

LORA_DIM = 32


def _heads(cfg):
    hd = cfg.rwkv_head_size
    if cfg.d_model % hd:
        raise ValueError(f"d_model {cfg.d_model} is not a multiple of the "
                         f"head size {hd}")
    return cfg.d_model // hd, hd


def _full(lead, d, value, dtype, device):
    return torch.full(lead + (d,), value, dtype=dtype, device=device)


def init_rwkv(cfg, dtype, *, lead=(), generator, device):
    d = cfg.d_model
    H, hd = _heads(cfg)
    mk = lambda shape: init_dense(lead + shape, dtype, generator=generator,
                                  device=device)
    bonus = torch.randn(lead + (H, hd), generator=generator,
                        dtype=torch.float32, device=device) * 0.1
    return {
        # time-mix interpolation coefficients (token shift)
        **{f"mu_{n}": _full(lead, d, 0.5, dtype, device) for n in "rkvw"},
        "w_r": mk((d, d)),
        "w_k": mk((d, d)),
        "w_v": mk((d, d)),
        "w_o": mk((d, d)),
        # data-dependent decay LoRA: d -> LORA -> d
        "decay_a": mk((d, LORA_DIM)),
        "decay_b": mk((LORA_DIM, d)),
        "decay_bias": _full(lead, d, -6.0, torch.float32, device),
        "bonus": bonus,
        "ln_x_scale": _full(lead, d, 1.0, torch.float32, device),
    }


def _mix(x, prev, mu):
    """Token shift: lerp between the current and the previous token."""
    return x * mu + prev * (1.0 - mu)


def _shifted(x):
    """The previous token of every position (zero before the first)."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _rwkv_inputs(params, x, x_prev):
    r = dense(_mix(x, x_prev, params["mu_r"]), params["w_r"])
    k = dense(_mix(x, x_prev, params["mu_k"]), params["w_k"])
    v = dense(_mix(x, x_prev, params["mu_v"]), params["w_v"])
    wx = _mix(x, x_prev, params["mu_w"])
    decay = dense(
        torch.tanh(dense(wx, params["decay_a"])), params["decay_b"]
    ).to(torch.float32)
    w = torch.exp(-torch.exp(decay + params["decay_bias"]))  # in (0, 1)
    return r, k, v, w


def _group_norm(x, scale, H, hd, eps=1e-5):
    """Per-head layer norm of the time-mix output (RWKV's ln_x), rounded
    through bf16 as the reference rounds it."""
    shape = x.shape
    x = x.reshape(*shape[:-1], H, hd).to(torch.float32)
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x.reshape(shape) * scale).to(torch.bfloat16).to(torch.float32)


def _step(state, r, k, v, w, u):
    """One recurrence step: every argument (B, H, hd), state (B, H, hd,
    hd).  Returns (out (B, H, hd), new state)."""
    kv = k[..., :, None] * v[..., None, :]
    out = torch.einsum("bhi,bhij->bhj", r, state + u[None, :, :, None] * kv)
    return out, w[..., :, None] * state + kv


def _scan(r, k, v, w, u):
    """The recurrence over r / k / v / w (B, S, H, hd) float32 with the bonus
    u (H, hd): (B, S, H, hd) float32, one step at a time."""
    B, S, H, hd = r.shape
    # the op tracer's time-scan region: a scan kernel would read r / k /
    # v / w and write the output once (the reference's timescan_io)
    with kernel_region("rwkv6.scan", lambda: sum(
            t.numel() * t.element_size() for t in (r, k, v, w, y)),
            kind="timescan") as region:
        state = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                            device=r.device)
        outs = []
        for t in range(S):
            out, state = _step(state, r[:, t], k[:, t], v[:, t], w[:, t], u)
            outs.append(out)
        y = torch.stack(outs, dim=1)
        region.output(y)
    return y


def rwkv_full(params, x: torch.Tensor, *, cfg,
              policy: ShardingPolicy = ShardingPolicy()) -> torch.Tensor:
    """Full-sequence time-mix: x (B, S, D) -> (B, S, D).  On a mesh the
    recurrence runs on each rank's rows and heads
    (:func:`sharding.on_blocks`)."""
    B, S, D = x.shape
    H, hd = _heads(cfg)
    r, k, v, w = (split_dim(t, 2, (H, hd)).to(torch.float32)
                  for t in _rwkv_inputs(params, x, _shifted(x)))
    dp, tp = policy.dp, policy.tp_axis
    heads = (dp, None, tp, None)
    y = on_blocks(policy, _scan, [(r, heads), (k, heads), (v, heads),
                                  (w, heads), (params["bonus"], (tp, None))])
    y = y.reshape(B, S, D)
    y = _group_norm(y, params["ln_x_scale"], H, hd)
    return dense(y.to(x.dtype), params["w_o"])


def init_rwkv_cache(cfg, batch: int, dtype, *, device, lead=()):
    """``x_prev`` (*lead, B, D) in ``dtype``, ``state`` (*lead, B, H, hd,
    hd) float32 and the channel-mix's ``cm_x_prev`` (*lead, B, D), zero."""
    H, hd = _heads(cfg)
    z = lambda shape, dt: torch.zeros(lead + shape, dtype=dt, device=device)
    return {
        "x_prev": z((batch, cfg.d_model), dtype),
        "state": z((batch, H, hd, hd), torch.float32),
        "cm_x_prev": z((batch, cfg.d_model), dtype),
    }


def rwkv_decode(params, x: torch.Tensor, cache: dict, *, cfg,
                policy: ShardingPolicy = ShardingPolicy()):
    """One-token time-mix: x (B, 1, D) -> ((B, 1, D), cache); updates the
    cache's ``x_prev`` and ``state`` in place.  On a mesh the step runs on
    each rank's rows and heads of the state (:func:`sharding.on_blocks`,
    the state's layout ``policy.cache_spec``)."""
    B = x.shape[0]
    H, hd = _heads(cfg)
    xt = x[:, 0]
    r, k, v, w = (split_dim(t, 1, (H, hd)).to(torch.float32)
                  for t in _rwkv_inputs(params, xt, cache["x_prev"]))
    held = cache["state"]
    spec = (policy.cache_spec("state", (1,) + tuple(held.shape))[1:]
            if policy.mesh is not None else ())
    spec = tuple(spec) + (None,) * (4 - len(spec))
    heads = spec[:2] + (None,)
    out, state = on_blocks(
        policy, _step, [(held, spec), (r, heads), (k, heads), (v, heads),
                        (w, heads), (params["bonus"], spec[1:2] + (None,))],
        like=(1, 0))
    y = _group_norm(out.reshape(B, -1), params["ln_x_scale"], H, hd)
    y = dense(y.to(x.dtype), params["w_o"])[:, None]
    assign(cache["x_prev"], xt)
    assign(cache["state"], state)
    return y, cache


def init_rwkv_cm(cfg, dtype, *, lead=(), generator, device):
    """Channel-mix (the RWKV FFN): squared relu with a receptance gate."""
    d = cfg.d_model
    mk = lambda shape: init_dense(lead + shape, dtype, generator=generator,
                                  device=device)
    return {
        "mu_k": _full(lead, d, 0.5, dtype, device),
        "mu_r": _full(lead, d, 0.5, dtype, device),
        "w_up": mk((d, cfg.d_ff)),
        "w_down": mk((cfg.d_ff, d)),
        "w_r": mk((d, d)),
    }


def _cm(params, x, x_prev):
    k = dense(_mix(x, x_prev, params["mu_k"]), params["w_up"])
    kv = dense(torch.square(torch.relu(k)), params["w_down"])
    r = torch.sigmoid(dense(_mix(x, x_prev, params["mu_r"]), params["w_r"]))
    return r * kv


def rwkv_cm_full(params, x: torch.Tensor) -> torch.Tensor:
    return _cm(params, x, _shifted(x))


def rwkv_cm_decode(params, x: torch.Tensor, cache: dict):
    """x (B, 1, D); updates the cache's ``cm_x_prev`` in place."""
    xt = x[:, 0]
    out = _cm(params, xt, cache["cm_x_prev"])[:, None]
    assign(cache["cm_x_prev"], xt)
    return out
