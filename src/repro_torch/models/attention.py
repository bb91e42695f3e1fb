"""GQA attention: full-sequence (train / prefill), cached decode, cross.

The port of ``repro/models/attention.py``: grouped KV heads (GQA / MQA),
sliding-window masks (gemma2's local layers), attention-logit
soft-capping, QKV bias (qwen2), M-RoPE (qwen2-vl) and cross-attention
(whisper), written as plain ``torch.matmul`` + softmax as the reference
leaves it to XLA (neither package's models call the flash-attention
kernel).  :func:`attention_full` processes queries in chunks of
``q_chunk`` so the score matrix is at most (chunk x Sk).  Self-attention
is causal (the decoder) or not (the encoder); cross-attention
(``kv_src``) takes its keys and values from the encoder's output, is not
causal, has no QKV bias and applies no RoPE.

:func:`attention_decode` is one cached decode step over a ring-buffer
cache (:func:`init_cache`) with a **per-row** ``index`` of shape (B,):
each row writes its own ring slot ``index % size`` and masks against its
own index.  The reference decodes a fixed batch with one scalar index and
the serving engine's slots by vmapping a B=1 decode; this one function
serves both, with no ``vmap``.  The cache is updated in place.
Cross-attention in decode attends the whole encoder output and leaves
the cache as it was.
"""

from __future__ import annotations

import math

import torch

from .layers import apply_rope, dense, init_dense, softcap
from .sharding import ShardingPolicy

__all__ = ["init_attention", "attention_full", "init_cache",
           "attention_decode"]

NEG_INF = -2.0e38


def init_attention(cfg, dtype, *, lead=(), generator, device,
                   cross: bool = False):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    q_dim, kv_dim = cfg.num_heads * hd, cfg.num_kv_heads * hd
    mk = lambda shape, **kw: init_dense(lead + shape, dtype,
                                        generator=generator, device=device,
                                        **kw)
    params = {
        "w_q": mk((d, q_dim)),
        "w_k": mk((d, kv_dim)),
        "w_v": mk((d, kv_dim)),
        "w_o": mk((q_dim, d), scale=1.0 / math.sqrt(q_dim)),
    }
    if cfg.qkv_bias and not cross:
        for name, width in (("b_q", q_dim), ("b_k", kv_dim),
                            ("b_v", kv_dim)):
            params[name] = torch.zeros(lead + (width,), dtype=dtype,
                                       device=device)
    return params


def _project_qkv(params, x, kv_src, cfg, positions, kv_positions,
                 rope: bool = True):
    """q (B, S, H, hd) from ``x``, k, v (B, Sk, KV, hd) from ``kv_src``,
    bias applied, and RoPE unless ``rope`` is false."""
    B, S, _ = x.shape
    Sk = kv_src.shape[1]
    hd = cfg.resolved_head_dim
    q = dense(x, params["w_q"], params.get("b_q"))
    k = dense(kv_src, params["w_k"], params.get("b_k"))
    v = dense(kv_src, params["w_v"], params.get("b_v"))
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, Sk, cfg.num_kv_heads, hd)
    v = v.reshape(B, Sk, cfg.num_kv_heads, hd)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, kv_positions, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v


def _sdpa_chunk(q, k, v, cfg, q_pos, k_pos, window, causal=True):
    """Scores of one query chunk against full K/V.

    q: (B, K, G, Q, h); k, v: (B, K, 1, Sk, h).  Scores and the weighted
    sum are float32 products of the inputs, as the reference's
    ``preferred_element_type=float32``.  Not causal and with no window,
    every key is attended (the query and key positions are not read)."""
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    scores = torch.matmul(
        q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)
    ) * scale
    scores = softcap(scores, cfg.attn_logit_softcap)
    if causal or window is not None:
        rel = q_pos[:, None] - k_pos[None, :]
        mask = rel >= 0 if causal else torch.ones_like(rel, dtype=torch.bool)
        if window is not None:
            mask &= rel < window
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(
        probs.to(v.dtype).to(torch.float32), v.to(torch.float32)
    )
    return out.to(q.dtype)


def _attend_local(policy, attend, q, k, v):
    """``attend(q, k, v)`` on each rank's own batch rows and KV heads:
    q (B, K, G, S, h) and k / v (B, K, 1, Sk, h) laid out with the batch
    over the DP axes and the KV heads over the TP axis (replicated over it
    when they do not divide), through ``local_map``; the output (B, S,
    K * G * h) has its rows and heads where the inputs had them.  Attention
    is independent per row and head, and DTensor has no rule for the score
    product's batched matmul over a sharded head dim, nor for merging a
    sharded KV-head dim of size one into the heads."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    tp = policy.tp_axis if q.shape[1] % policy.tp_size == 0 else None
    q, k, v = (policy.constrain(t, (policy.dp, tp)) for t in (q, k, v))
    layout = list(q.placements)
    out_layout = [Shard(2) if p == Shard(1) else p for p in layout]
    # lists: one argument's (one output's) placements each
    return local_map(attend, out_placements=out_layout,
                     in_placements=(layout, layout, layout),
                     device_mesh=policy.device_mesh)(q, k, v)


def attention_full(params, x: torch.Tensor, *, cfg, positions: torch.Tensor,
                   window: int | None = None, causal: bool = True,
                   kv_src: torch.Tensor | None = None,
                   kv_positions: torch.Tensor | None = None,
                   q_chunk: int = 1024,
                   policy: ShardingPolicy = ShardingPolicy()) -> torch.Tensor:
    """Attention over the full sequence. x: (B, S, D); ``positions`` (B,
    S) (or (1, S)), or (3, B, S) with M-RoPE; ``window`` the sliding window
    of an ``attn_local`` sublayer; ``causal`` false for the encoder.  With
    ``kv_src`` (B, Sk, D) it is cross-attention: keys and values from
    ``kv_src``, no RoPE, every key attended.  ``policy`` (a
    :class:`~repro_torch.models.sharding.ShardingPolicy`) lays out q as
    ``heads`` and k / v as ``kv``."""
    B, S, _ = x.shape
    hd, K = cfg.resolved_head_dim, cfg.num_kv_heads
    G = cfg.num_heads // K
    cross = kv_src is not None
    src = kv_src if cross else x
    if kv_positions is None:
        kv_positions = positions
    q, k, v = _project_qkv(params, x, src, cfg, positions, kv_positions,
                           rope=not cross)
    q = policy.act(q, kind="heads")
    k = policy.act(k, kind="kv")
    v = policy.act(v, kind="kv")
    # (B, S, K, G, h) -> (B, K, G, S, h); k/v -> (B, K, 1, Sk, h)
    q = q.reshape(B, S, K, G, hd).permute(0, 2, 3, 1, 4)
    k = k.permute(0, 2, 1, 3)[:, :, None]
    v = v.permute(0, 2, 1, 3)[:, :, None]
    q_pos = torch.arange(S, device=x.device)
    k_pos = torch.arange(src.shape[1], device=x.device)
    chunk = min(q_chunk, S)
    if S % chunk:
        chunk = S

    def attend(q, k, v):
        outs = [
            _sdpa_chunk(q[:, :, :, i : i + chunk], k, v, cfg,
                        q_pos[i : i + chunk], k_pos, window, causal)
            for i in range(0, S, chunk)
        ]
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=3)
        # (B, K, G, S, h) -> (B, S, K * G * h), the heads KV-head-major
        return out.permute(0, 3, 1, 2, 4).reshape(out.shape[0], S, -1)

    if policy.mesh is not None:
        out = _attend_local(policy, attend, q, k, v)
    else:
        out = attend(q, k, v)
    return dense(out, params["w_o"])


# ---------------------------------------------------------------------------
# decode with a KV cache (ring buffer for sliding-window layers)
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_len: int, *, window: int | None, dtype,
               device, lead=()):
    """Cache of one attention sublayer: ``k`` / ``v`` (*lead, B, KV, size,
    hd) and ``pos`` (*lead, B, size) = -1 (empty), ``size = min(max_len,
    window)``.  ``pos`` is per row because each row has its own index."""
    size = min(max_len, window) if window else max_len
    hd = cfg.resolved_head_dim
    shape = lead + (batch, cfg.num_kv_heads, size, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full(lead + (batch, size), -1, dtype=torch.int32,
                          device=device),
    }


def attention_decode(params, x: torch.Tensor, cache: dict,
                     index: torch.Tensor, *, cfg,
                     window: int | None = None,
                     kv_src: torch.Tensor | None = None):
    """One-token decode. x: (B, 1, D); ``index`` (B,) the position each row
    writes; ``cache`` as from :func:`init_cache` (no lead dims), updated in
    place and returned.  With ``kv_src`` (B, Sk, D), cross-attention over
    all of it; the cache is returned untouched."""
    if kv_src is not None:
        return attention_full(params, x, cfg=cfg, positions=index[:, None],
                              causal=False, kv_src=kv_src), cache
    B = x.shape[0]
    hd, K = cfg.resolved_head_dim, cfg.num_kv_heads
    G = cfg.num_heads // K
    pos_in = index[:, None]
    q, k_new, v_new = _project_qkv(params, x, x, cfg, pos_in, pos_in)
    k, v, pos = cache["k"], cache["v"], cache["pos"]
    size = k.shape[2]
    rows = torch.arange(B, device=x.device)
    slot = torch.remainder(index, size).long()
    k[rows, :, slot] = k_new[:, 0]
    v[rows, :, slot] = v_new[:, 0]
    pos[rows, slot] = index.to(torch.int32)

    # q (B, K, G, h) against the row's cache k (B, K, size, h): float32
    # products of the inputs, as the reference's preferred_element_type
    q = q.reshape(B, K, G, hd)
    scores = torch.matmul(
        q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)
    ) * (1.0 / math.sqrt(hd))
    scores = softcap(scores, cfg.attn_logit_softcap)
    idx = index[:, None]
    valid = (pos >= 0) & (pos <= idx)
    if window is not None:
        valid &= pos > idx - window
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype).to(torch.float32),
                       v.to(torch.float32)).to(x.dtype)
    y = dense(out.reshape(B, 1, cfg.num_heads * hd), params["w_o"])
    return y, cache
