"""Full-sequence causal GQA attention (the dense training path).

The port of ``repro/models/attention.py::attention_full`` for the dense
causal case, written as plain ``torch.matmul`` + softmax as the reference
leaves it to XLA (the flash-attention kernel is a separate kernel, ported
on its own later).  Queries are processed in chunks of ``q_chunk`` so the
score matrix is at most (chunk x S).
"""

from __future__ import annotations

import math

import torch

from .layers import apply_rope, dense, init_dense

__all__ = ["init_attention", "attention_full"]

NEG_INF = -2.0e38


def init_attention(cfg, dtype, *, lead=(), generator, device):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    q_dim, kv_dim = cfg.num_heads * hd, cfg.num_kv_heads * hd
    mk = lambda shape, **kw: init_dense(lead + shape, dtype,
                                        generator=generator, device=device,
                                        **kw)
    return {
        "w_q": mk((d, q_dim)),
        "w_k": mk((d, kv_dim)),
        "w_v": mk((d, kv_dim)),
        "w_o": mk((q_dim, d), scale=1.0 / math.sqrt(q_dim)),
    }


def _sdpa_chunk(q, k, v, cfg, q_pos, k_pos):
    """Scores of one query chunk against full K/V.

    q: (B, K, G, Q, h); k, v: (B, K, 1, S, h).  Scores and the weighted
    sum are float32 products of the inputs, as the reference's
    ``preferred_element_type=float32``."""
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    scores = torch.matmul(
        q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)
    ) * scale
    mask = (q_pos[:, None] - k_pos[None, :]) >= 0
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(
        probs.to(v.dtype).to(torch.float32), v.to(torch.float32)
    )
    return out.to(q.dtype)


def attention_full(params, x: torch.Tensor, *, cfg, positions: torch.Tensor,
                   q_chunk: int = 1024) -> torch.Tensor:
    """Causal self-attention over the full sequence. x: (B, S, D)."""
    B, S, _ = x.shape
    hd, K = cfg.resolved_head_dim, cfg.num_kv_heads
    G = cfg.num_heads // K
    q = dense(x, params["w_q"]).reshape(B, S, cfg.num_heads, hd)
    k = dense(x, params["w_k"]).reshape(B, S, K, hd)
    v = dense(x, params["w_v"]).reshape(B, S, K, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    # (B, S, K, G, h) -> (B, K, G, S, h); k/v -> (B, K, 1, S, h)
    q = q.reshape(B, S, K, G, hd).permute(0, 2, 3, 1, 4)
    k = k.permute(0, 2, 1, 3)[:, :, None]
    v = v.permute(0, 2, 1, 3)[:, :, None]
    pos = torch.arange(S, device=x.device)
    chunk = min(q_chunk, S)
    if S % chunk:
        chunk = S
    outs = [
        _sdpa_chunk(q[:, :, :, i : i + chunk], k, v, cfg,
                    pos[i : i + chunk], pos)
        for i in range(0, S, chunk)
    ]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=3)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, cfg.num_heads * hd)
    return dense(out, params["w_o"])
