"""Mamba (S6) selective state-space mixer -- the jamba hybrid's workhorse.

The port of ``repro/models/mamba.py``: the full-sequence mixer runs the
selective scan as a loop over time (the reference's ``lax.scan``; with
``cfg.mamba_bf16_io`` its ``dt`` / ``B`` / ``C`` are rounded to bf16 and the
state stays float32), and single-token decode is an O(1) update of a cache
of the last ``d_conv - 1`` conv inputs and the float32 SSM state, written
in place.
As in the reference, this module is the oracle of the Mamba scan kernel
(``repro_torch.kernels.mamba_scan``) and does not call it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..trace_regions import kernel_region
from .layers import dense, init_dense
from .sharding import ShardingPolicy, assign, on_blocks, settle

__all__ = ["init_mamba", "mamba_full", "init_mamba_cache", "mamba_decode"]


def _dims(cfg):
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    dt_rank = m.dt_rank or math.ceil(cfg.d_model / 16)
    return m, d_inner, dt_rank


def init_mamba(cfg, dtype, *, lead=(), generator, device):
    m, d_inner, dt_rank = _dims(cfg)
    d = cfg.d_model
    mk = lambda shape: init_dense(lead + shape, dtype, generator=generator,
                                  device=device)
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn(lead + (d_inner, m.d_conv), generator=generator,
                         **f32) / math.sqrt(m.d_conv)
    dt = torch.rand(lead + (d_inner,), generator=generator, **f32)
    dt = dt * (0.1 - 1e-3) + 1e-3
    # S4D-real initialisation of A
    A = torch.arange(1, m.d_state + 1, **f32).expand(lead + (d_inner,
                                                             m.d_state))
    return {
        "w_in": mk((d, 2 * d_inner)),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros(lead + (d_inner,), dtype=dtype, device=device),
        "x_proj": mk((d_inner, dt_rank + 2 * m.d_state)),
        "w_dt": mk((dt_rank, d_inner)),
        "dt_bias": torch.log(torch.exp(dt) - 1.0),
        "A_log": torch.log(A),
        "D": torch.ones(lead + (d_inner,), **f32),
        "w_out": mk((d_inner, d)),
    }


def _dt_B_C(params, x, cfg):
    m, _, dt_rank = _dims(cfg)
    # on a mesh the channel contraction is a partial sum: reduce it before
    # the split (its dt meets the sharded dt_bias)
    proj = settle(dense(x, params["x_proj"]))
    dt, B, C = torch.split(proj, [dt_rank, m.d_state, m.d_state], dim=-1)
    dt = F.softplus(
        dense(dt, params["w_dt"]).to(torch.float32) + params["dt_bias"]
    )
    return dt, B.to(torch.float32), C.to(torch.float32)


def _scan(dt, dBx_in, Bmat, Cmat, A):
    """The selective scan: dt, dBx_in (B, S, d_in), Bmat / Cmat (B, S, N),
    A (d_in, N) -> y (B, S, d_in) float32, one step at a time."""
    Bsz, S, d_inner = dt.shape
    # the op tracer's time-scan region: a scan kernel would read its inputs
    # and write y once (the reference's timescan_io accounting)
    with kernel_region("mamba.scan", lambda: sum(
            t.numel() * t.element_size()
            for t in (dt, dBx_in, Bmat, Cmat, A, y)), kind="timescan") as r:
        state = torch.zeros((Bsz, d_inner, A.shape[1]), dtype=torch.float32,
                            device=dt.device)
        ys = []
        for t in range(S):
            dA = torch.exp(dt[:, t, :, None] * A)            # (B,d_in,N)
            dBx = dBx_in[:, t, :, None] * Bmat[:, t, None, :]
            state = state * dA + dBx
            ys.append(torch.einsum("bdn,bn->bd", state, Cmat[:, t]))
        y = torch.stack(ys, dim=1)  # (B,S,d_in)
        r.output(y)
    return y


def mamba_full(params, u: torch.Tensor, *, cfg,
               policy: ShardingPolicy = ShardingPolicy()) -> torch.Tensor:
    """Full-sequence mamba: u (B, S, D) -> (B, S, D).  On a mesh the scan
    runs on each rank's rows and channels (:func:`sharding.on_blocks`)."""
    m, d_inner, _ = _dims(cfg)
    Bsz, S, _ = u.shape
    x, z = torch.chunk(dense(u, params["w_in"]), 2, dim=-1)

    # causal depthwise conv over time
    w = params["conv_w"].to(x.dtype)  # (d_inner, k)
    xp = torch.cat([x.new_zeros((Bsz, m.d_conv - 1, d_inner)), x], dim=1)
    acc = 0
    for i in range(m.d_conv):
        acc = acc + xp[:, i : i + S, :] * w[:, i]
    x = F.silu(acc + params["conv_b"].to(x.dtype))

    dt, Bmat, Cmat = _dt_B_C(params, x, cfg)  # (B,S,d_in),(B,S,N),(B,S,N)
    if cfg.mamba_bf16_io:
        # the scan's inputs rounded to bf16, its state math in float32
        dt, Bmat, Cmat = (t.to(torch.bfloat16).to(torch.float32)
                          for t in (dt, Bmat, Cmat))
    A = -torch.exp(params["A_log"])  # (d_in, N)
    dBx_in = dt * x.to(torch.float32)
    dp, tp = policy.dp, policy.tp_axis
    y = on_blocks(policy, _scan, [(dt, (dp, None, tp)),
                                  (dBx_in, (dp, None, tp)),
                                  (Bmat, (dp, None, None)),
                                  (Cmat, (dp, None, None)), (A, (tp, None))])
    y = y + x.to(torch.float32) * params["D"]
    y = y.to(u.dtype) * F.silu(z)
    return dense(y, params["w_out"])


def init_mamba_cache(cfg, batch: int, dtype, *, device, lead=()):
    """``conv`` (*lead, B, d_conv - 1, d_inner) in ``dtype`` and ``state``
    (*lead, B, d_inner, d_state) float32, zero."""
    m, d_inner, _ = _dims(cfg)
    return {
        "conv": torch.zeros(lead + (batch, m.d_conv - 1, d_inner),
                            dtype=dtype, device=device),
        "state": torch.zeros(lead + (batch, d_inner, m.d_state),
                             dtype=torch.float32, device=device),
    }


def mamba_decode(params, u: torch.Tensor, cache: dict, *, cfg):
    """One-token update: u (B, 1, D) -> ((B, 1, D), cache), the cache (no
    lead dims) updated in place."""
    x, z = torch.chunk(dense(u[:, 0], params["w_in"]), 2, dim=-1)
    hist = torch.cat([cache["conv"], x[:, None]], dim=1)  # (B, k, d)
    w = params["conv_w"].to(x.dtype)
    x = torch.einsum("bkd,dk->bd", hist, w) + params["conv_b"].to(x.dtype)
    x = F.silu(x)
    dt, Bt, Ct = _dt_B_C(params, x, cfg)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt[..., None] * A)
    dBx = (dt * x.to(torch.float32))[..., None] * Bt[:, None, :]
    state = cache["state"] * dA + dBx
    y = torch.einsum("bdn,bn->bd", state, Ct)
    y = y + x.to(torch.float32) * params["D"]
    y = y.to(u.dtype) * F.silu(z)
    out = dense(y, params["w_out"])[:, None]
    assign(cache["conv"], hist[:, 1:])
    assign(cache["state"], state)
    return out, cache
