"""Layer stacks: stacked per-layer parameters applied by a layer loop.

The port of ``repro/models/transformer.py``.  A model is
``num_super_layers`` repetitions of the config's sublayer *pattern*;
every sublayer's parameters keep the reference's leading ``n_super``
dimension (``{"sub<i>": {...}}`` with leaves ``(n_super, ...)``), so the
gradient leaves have the reference's shapes; the reference's ``lax.scan``
over that dimension becomes a loop over the layer index.  An
encoder-decoder (whisper) has a second stack, the encoder
(``init_stack(n_layers=, pattern=)``, applied with ``causal=False``), and
its decoder sublayers a cross-attention block after self-attention
(``norm_cross``, ``cross``) over the encoder's output ``enc_out``.

Mixer kinds: "attn" (global), "attn_local" (sliding window), "mamba",
"rwkv6".  FFN kinds: "dense" GLU, "moe", and the implicit RWKV
channel-mix when the mixer is rwkv6.  ``sandwich_norm`` (gemma2) adds a
norm after the mixer and after the FFN.

The decode cache keeps the same leading ``n_super`` dimension
(:func:`init_stack_cache`), one entry per sublayer: ``{"k", "v", "pos"}``
for attention, ``{"conv", "state"}`` for Mamba, ``{"x_prev", "state",
"cm_x_prev"}`` for RWKV6; :func:`stack_decode` updates it in place, layer
by layer.
"""

from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as ckpt

from . import attention as attn_mod
from . import mamba as mamba_mod
from . import moe as moe_mod
from . import rwkv as rwkv_mod
from .layers import (
    glu_mlp, init_glu_mlp, mixed_bwd, mixed_bwd_enabled, rms_norm,
)
from .sharding import ShardingPolicy
from .. import tree as tree_util
from ..trace_regions import recompute_span

__all__ = ["init_stack", "stack_apply", "init_stack_cache", "stack_decode"]


def _window(cfg, sub):
    return cfg.sliding_window if sub.mixer == "attn_local" else None


def _init_sublayer(sub, cfg, dtype, *, lead, generator, device,
                   cross: bool = False):
    kw = dict(lead=lead, generator=generator, device=device)
    norm = lambda: torch.zeros(lead + (cfg.d_model,), dtype=torch.float32,
                               device=device)
    p = {"norm1": norm()}
    if sub.mixer in ("attn", "attn_local"):
        p["mixer"] = attn_mod.init_attention(cfg, dtype, **kw)
    elif sub.mixer == "mamba":
        p["mixer"] = mamba_mod.init_mamba(cfg, dtype, **kw)
    elif sub.mixer == "rwkv6":
        p["mixer"] = rwkv_mod.init_rwkv(cfg, dtype, **kw)
    if cross:
        p["norm_cross"] = norm()
        p["cross"] = attn_mod.init_attention(cfg, dtype, cross=True, **kw)
    if sub.mixer == "rwkv6":
        p["ffn"] = rwkv_mod.init_rwkv_cm(cfg, dtype, **kw)
    elif sub.ffn == "dense":
        p["ffn"] = init_glu_mlp(cfg.d_model, cfg.d_ff, dtype, **kw)
    elif sub.ffn == "moe":
        p["ffn"] = moe_mod.init_moe(cfg, dtype, **kw)
    if sub.ffn != "none" or sub.mixer == "rwkv6":
        p["norm2"] = norm()
    if cfg.sandwich_norm:
        p["norm1_post"] = norm()
        p["norm2_post"] = norm()
    return p


def init_stack(cfg, dtype, *, generator, device, n_layers: int | None = None,
               pattern=None, cross: bool = False):
    """Stacked params: {"sub<i>": tree with leading n_super dim}, for
    ``n_layers`` sublayers of ``pattern`` (the decoder's by default);
    ``cross`` adds each sublayer's cross-attention block."""
    pattern = pattern if pattern is not None else cfg.pattern
    lead = ((n_layers or cfg.num_layers) // len(pattern),)
    return {
        f"sub{i}": _init_sublayer(sub, cfg, dtype, lead=lead,
                                  generator=generator, device=device,
                                  cross=cross)
        for i, sub in enumerate(pattern)
    }


def _post(p, h, name, cfg):
    if cfg.sandwich_norm:
        return rms_norm(h, p[name], cfg.norm_eps)
    return h


def _cross(p, x, cfg, positions, enc_out, policy):
    """The cross-attention block: ``x`` plus attention over ``enc_out``."""
    h = rms_norm(x, p["norm_cross"], cfg.norm_eps)
    h = attn_mod.attention_full(p["cross"], h, cfg=cfg, positions=positions,
                                causal=False, kv_src=enc_out, policy=policy)
    return x + policy.act(h, kind="hidden")


def _sublayer_full(p, x, sub, *, cfg, positions, causal, enc_out, policy):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if sub.mixer in ("attn", "attn_local"):
        h = attn_mod.attention_full(p["mixer"], h, cfg=cfg,
                                    positions=positions,
                                    window=_window(cfg, sub), causal=causal,
                                    policy=policy)
    elif sub.mixer == "mamba":
        h = mamba_mod.mamba_full(p["mixer"], h, cfg=cfg, policy=policy)
    elif sub.mixer == "rwkv6":
        h = rwkv_mod.rwkv_full(p["mixer"], h, cfg=cfg, policy=policy)
    else:
        h = torch.zeros_like(h)
    # a branch's partial sums are reduced into the residual's layout here:
    # left partial, DTensor would reduce-scatter them over the rows and
    # then gather whole weights for the next projection
    x = x + _post(p, policy.act(h, kind="hidden"), "norm1_post", cfg)
    if "cross" in p:
        x = _cross(p, x, cfg, positions, enc_out, policy)

    aux = None
    if "ffn" in p:
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        if sub.mixer == "rwkv6":
            h = rwkv_mod.rwkv_cm_full(p["ffn"], h)
        elif sub.ffn == "moe":
            h, aux = moe_mod.moe_apply(p["ffn"], h, cfg=cfg, policy=policy)
        else:
            h = glu_mlp(p["ffn"], h, cfg.act)
        x = x + _post(p, policy.act(h, kind="hidden"), "norm2_post", cfg)
    return x, aux


# the outputs "dots" keeps: matrix products (``jax.checkpoint_policies.
# dots_saveable`` keeps every dot_general's); ``torch.matmul`` and
# ``einsum`` reach the dispatcher as these
_DOT_OPS = frozenset({
    torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
    torch.ops.aten.addmm.default,
})


def _dots_saveable(ctx, op, *args, **kwargs):
    if op in _DOT_OPS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _super_layer(layer_params, x, aux, *, cfg, positions, pattern, causal,
                 enc_out, policy):
    # the scope again: remat recomputes this body in the backward pass
    with policy.scope():
        x = policy.act(x, kind="hidden")
        for i, sub in enumerate(pattern):
            x, a = _sublayer_full(layer_params[f"sub{i}"], x, sub, cfg=cfg,
                                  positions=positions, causal=causal,
                                  enc_out=enc_out, policy=policy)
            if a is not None:
                aux = aux + a
    return x, aux


def _layer_views(stack_params) -> list:
    """Each layer's parameter tree, as views of the stacked leaves.  One
    ``unbind`` per leaf: its backward stacks the layers' gradients into one
    tensor, where indexing each layer would give every layer a zero-padded
    gradient of the whole stacked leaf to add up (bytes growing as the
    square of the depth)."""
    leaves, treedef = tree_util.flatten(stack_params)
    unbound = [t.unbind(0) for t in leaves]
    return [tree_util.unflatten(treedef, [u[i] for u in unbound])
            for i in range(len(unbound[0]))]


def _remat_wrap(body, remat: str):
    """``body(x, aux) -> (x, aux)`` under the remat policy.  The
    recomputation runs under the ``mixed_bwd`` setting of the forward pass,
    so it builds the same graph."""
    if remat == "none" or not torch.is_grad_enabled():
        return body
    mixed = mixed_bwd_enabled()

    def scoped(x, aux):
        with mixed_bwd(mixed), recompute_span():
            return body(x, aux)

    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_saveable
        )
    return lambda x, aux: ckpt.checkpoint(scoped, x, aux,
                                          use_reentrant=False, **kw)


def stack_apply(stack_params, x: torch.Tensor, *, cfg, positions,
                pattern=None, causal: bool = True,
                enc_out: torch.Tensor | None = None,
                policy: ShardingPolicy = ShardingPolicy()):
    """Run the stack (of ``pattern``, the decoder's by default), one
    super-layer at a time under ``cfg.remat``; ``causal`` false for the
    encoder, ``enc_out`` the encoder's output for the cross-attention
    blocks.  Returns ``(hidden, aux)``: the MoE load-balance losses summed
    over sublayers and layers (float32 zero without MoE), as the
    reference's scan carries them.  ``policy`` lays out the hidden state
    as ``hidden`` at the top of every super-layer, and the attention
    blocks' heads."""
    pattern = pattern if pattern is not None else cfg.pattern
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer_params in _layer_views(stack_params):
        body = _remat_wrap(
            functools.partial(_super_layer, layer_params, cfg=cfg,
                              positions=positions, pattern=pattern,
                              causal=causal, enc_out=enc_out, policy=policy),
            cfg.remat,
        )
        x, aux = body(x, aux)
    return x, aux


# ---------------------------------------------------------------------------
# decode (single token, cached)
# ---------------------------------------------------------------------------


def init_stack_cache(cfg, batch: int, max_len: int, dtype, *, device):
    """Cache tree mirroring the stack: ``{"sub<i>": {...}}`` with leaves
    ``(n_super, batch, ...)``."""
    kw = dict(dtype=dtype, device=device, lead=(cfg.num_super_layers,))

    def one(sub):
        if sub.mixer in ("attn", "attn_local"):
            return attn_mod.init_cache(cfg, batch, max_len,
                                       window=_window(cfg, sub), **kw)
        if sub.mixer == "mamba":
            return mamba_mod.init_mamba_cache(cfg, batch, **kw)
        if sub.mixer == "rwkv6":
            return rwkv_mod.init_rwkv_cache(cfg, batch, **kw)
        return {}

    return {f"sub{i}": one(sub) for i, sub in enumerate(cfg.pattern)}


def _sublayer_decode(p, x, cache, sub, *, cfg, index, moe_groups, enc_out,
                     policy):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if sub.mixer in ("attn", "attn_local"):
        h, _ = attn_mod.attention_decode(p["mixer"], h, cache, index,
                                         cfg=cfg, window=_window(cfg, sub),
                                         policy=policy)
    elif sub.mixer == "mamba":
        h, _ = mamba_mod.mamba_decode(p["mixer"], h, cache, cfg=cfg)
    elif sub.mixer == "rwkv6":
        h, _ = rwkv_mod.rwkv_decode(p["mixer"], h, cache, cfg=cfg,
                                    policy=policy)
    else:
        h = torch.zeros_like(h)
    x = x + _post(p, h, "norm1_post", cfg)
    if "cross" in p:
        h = rms_norm(x, p["norm_cross"], cfg.norm_eps)
        h, _ = attn_mod.attention_decode(p["cross"], h, {}, index, cfg=cfg,
                                         kv_src=enc_out, policy=policy)
        x = x + h

    if "ffn" in p:
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        if sub.mixer == "rwkv6":
            h = rwkv_mod.rwkv_cm_decode(p["ffn"], h, cache)
        elif sub.ffn == "moe":
            # decode drops the aux loss, as the reference does
            h, _ = moe_mod.moe_apply(p["ffn"], h, cfg=cfg, groups=moe_groups,
                                     policy=policy)
        else:
            h = glu_mlp(p["ffn"], h, cfg.act)
        x = x + _post(p, h, "norm2_post", cfg)
    return x


def stack_decode(stack_params, x: torch.Tensor, cache, index, *, cfg,
                 moe_per_row: bool = False,
                 enc_out: torch.Tensor | None = None,
                 policy: ShardingPolicy = ShardingPolicy()):
    """One-token decode through the stack; ``index`` (B,).  With
    ``moe_per_row`` every row routes its MoE tokens as its own group (the
    serving engine's slots); otherwise the batch is one group.  ``enc_out``
    (B, S_enc, D): the encoder output the cross-attention blocks attend.
    ``policy`` lays out the hidden state as ``hidden`` at the top of every
    super-layer and is passed to every mixer and MoE block; on a mesh the
    cache is a tree of DTensors laid out by it.  Updates ``cache`` in
    place and returns ``(x, cache)``."""
    moe_groups = x.shape[0] if moe_per_row else 1
    for layer in range(cfg.num_super_layers):
        x = policy.act(x, kind="hidden")
        for i, sub in enumerate(cfg.pattern):
            p = tree_util.tree_map(lambda t: t[layer], stack_params[f"sub{i}"])
            c = {k: t[layer] for k, t in cache[f"sub{i}"].items()}
            x = _sublayer_decode(p, x, c, sub, cfg=cfg, index=index,
                                 moe_groups=moe_groups, enc_out=enc_out,
                                 policy=policy)
    return x, cache
