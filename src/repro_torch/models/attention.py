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

from ..trace_regions import kernel_region
from .layers import apply_rope, dense, init_dense, softcap
from .sharding import (ShardingPolicy, block_index, from_block, is_dtensor,
                       split_dim)

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
    hd = cfg.resolved_head_dim
    q = dense(x, params["w_q"], params.get("b_q"))
    k = dense(kv_src, params["w_k"], params.get("b_k"))
    v = dense(kv_src, params["w_v"], params.get("b_v"))
    q = split_dim(q, 2, (cfg.num_heads, hd))
    k = split_dim(k, 2, (cfg.num_kv_heads, hd))
    v = split_dim(v, 2, (cfg.num_kv_heads, hd))
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
    # the op tracer's attention region: a flash kernel would move q, k, v
    # and the output only (the reference's attn_io accounting)
    with kernel_region("attention.scores", lambda: 2 * _nbytes(q)
                       + _nbytes(k) + _nbytes(v), kind="attn") as region:
        scores = torch.matmul(
            q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)
        ) * scale
        scores = softcap(scores, cfg.attn_logit_softcap)
        if causal or window is not None:
            rel = q_pos[:, None] - k_pos[None, :]
            mask = rel >= 0 if causal else torch.ones_like(rel,
                                                           dtype=torch.bool)
            if window is not None:
                mask &= rel < window
            scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.matmul(
            probs.to(v.dtype).to(torch.float32), v.to(torch.float32)
        ).to(q.dtype)
        region.output(out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


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
    q = split_dim(q, 2, (K, G)).permute(0, 2, 3, 1, 4)
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


def _write_slot(k, v, pos, k_new, v_new, index, off: int, size: int):
    """Each row's new key / value into ring slot ``index % size`` of its
    cache block: ``k`` / ``v`` (B, KV, n, hd) hold positions ``[off, off +
    n)`` of the ring, ``pos`` (B, size) all of it.  A slot outside the
    block is not written (its row keeps the value it had)."""
    B, n = k.shape[0], k.shape[2]
    rows = torch.arange(B, device=k.device)
    slot = torch.remainder(index, size).long()
    pos[rows, slot] = index.to(torch.int32)
    if off == 0 and n == size:
        k[rows, :, slot] = k_new
        v[rows, :, slot] = v_new
        return
    local = slot - off
    own = ((local >= 0) & (local < n))[:, None, None]
    local = local.clamp(0, n - 1)
    k[rows, :, local] = torch.where(own, k_new, k[rows, :, local])
    v[rows, :, local] = torch.where(own, v_new, v[rows, :, local])


def _attend_cached(q, k, v, pos, index, cfg, window, merge=None):
    """q (B, K, G, h) against the cache block k / v (B, K, n, h) whose ring
    positions are ``pos`` (B, n): float32 products of the inputs, as the
    reference's preferred_element_type.  ``merge(t, op)`` (op "max" or
    "sum") reduces over the ranks that hold the other blocks of the same
    rows and heads: the softmax's max and sum and the weighted sum are
    merged across them.  Returns (B, K, G, h) float32."""
    with kernel_region("attention.cached", lambda: _nbytes(q) * 3
                       + _nbytes(k) + _nbytes(v) + _nbytes(pos),
                       kind="attn"):
        scores = torch.matmul(
            q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)
        ) * (1.0 / math.sqrt(cfg.resolved_head_dim))
        scores = softcap(scores, cfg.attn_logit_softcap)
        idx = index[:, None]
        valid = (pos >= 0) & (pos <= idx)
        if window is not None:
            valid &= pos > idx - window
        scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
        if merge is None:
            probs = torch.softmax(scores, dim=-1)
            return torch.matmul(probs.to(v.dtype).to(torch.float32),
                                v.to(torch.float32))
        m = merge(scores.amax(dim=-1, keepdim=True), "max")
        e = torch.exp(scores - m)
        probs = e / merge(e.sum(dim=-1, keepdim=True), "sum")
        return merge(torch.matmul(probs.to(v.dtype).to(torch.float32),
                                  v.to(torch.float32)), "sum")


def _decode_on_mesh(policy, q, k_new, v_new, cache, index, cfg, window):
    """The cached attention of :func:`attention_decode` on each rank's block
    of a cache laid out by ``policy.cache_spec`` (rows over the DP axes;
    KV heads, or the ring's positions, over the TP axis in train mode; the
    positions over the joint axes in ``serve2d``).  The query and the new
    key / value are laid out as the cache's rows and heads; the rank whose
    block holds a row's slot writes it; with the positions sharded, each
    rank scores its block and the softmax is merged over the ranks of the
    same rows (:func:`_attend_cached`).  Returns (B, 1, H * hd) with the
    rows and heads where the cache has them."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    k, v, pos = cache["k"], cache["v"], cache["pos"]
    dm = k.device_mesh
    lay = list(k.placements)  # on (B, KV, size, hd)
    rows = [Shard(0) if p == Shard(0) else Replicate() for p in lay]
    if list(pos.placements) != rows:
        raise ValueError(f"cache pos {pos.placements} does not follow the "
                         f"rows of k {k.placements}")
    heads = [Shard(2) if p == Shard(1) else r for p, r in zip(lay, rows)]
    seq_dims = [i for i, p in enumerate(lay)
                if p == Shard(2) and dm.size(i) > 1]
    ql, kl, vl = (t.redistribute(dm, heads).to_local()
                  for t in (q, k_new, v_new))
    if not is_dtensor(index):
        index = policy.constrain(index, ())
    idx = index.redistribute(dm, rows).to_local()
    kb, vb, pb = k.to_local(), v.to_local(), pos.to_local()
    size, n = k.shape[2], kb.shape[2]
    off = block_index(dm, seq_dims) * n
    _write_slot(kb, vb, pb, kl[:, 0], vl[:, 0], idx, off, size)

    merge = None
    if seq_dims:
        ops = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}

        def merge(t, op):
            t = t.contiguous()
            for i in seq_dims:
                dist.all_reduce(t, op=ops[op], group=dm.get_group(i))
            return t

    b, kh = ql.shape[0], kb.shape[1]
    out = _attend_cached(ql.reshape(b, kh, -1, ql.shape[-1]), kb, vb,
                         pb[:, off:off + n], idx, cfg, window, merge)
    out = out.to(ql.dtype).reshape(b, 1, -1)
    return from_block(out, dm, heads)


def attention_decode(params, x: torch.Tensor, cache: dict,
                     index: torch.Tensor, *, cfg,
                     window: int | None = None,
                     kv_src: torch.Tensor | None = None,
                     policy: ShardingPolicy = ShardingPolicy()):
    """One-token decode. x: (B, 1, D); ``index`` (B,) the position each row
    writes; ``cache`` as from :func:`init_cache` (no lead dims), updated in
    place and returned.  With ``kv_src`` (B, Sk, D), cross-attention over
    all of it; the cache is returned untouched.  On a mesh the cache is a
    tree of DTensors laid out by ``policy`` (:func:`_decode_on_mesh`) and
    the new keys and values are laid out as ``cache`` (the reference's
    ``act(kind="cache")``) before they are written."""
    if kv_src is not None:
        return attention_full(params, x, cfg=cfg, positions=index[:, None],
                              causal=False, kv_src=kv_src,
                              policy=policy), cache
    B = x.shape[0]
    hd, K = cfg.resolved_head_dim, cfg.num_kv_heads
    pos_in = index[:, None]
    q, k_new, v_new = _project_qkv(params, x, x, cfg, pos_in, pos_in)
    if policy.mesh is not None:
        out = _decode_on_mesh(policy, q, k_new, v_new, cache, index, cfg,
                              window)
        return dense(out, params["w_o"]), cache
    _write_slot(cache["k"], cache["v"], cache["pos"], k_new[:, 0],
                v_new[:, 0], index, 0, cache["k"].shape[2])
    out = _attend_cached(q.reshape(B, K, -1, hd), cache["k"], cache["v"],
                         cache["pos"], index, cfg, window).to(x.dtype)
    y = dense(out.reshape(B, 1, cfg.num_heads * hd), params["w_o"])
    return y, cache
