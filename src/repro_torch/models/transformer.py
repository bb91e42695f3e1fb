"""Decoder stack: stacked per-layer parameters applied by a layer loop.

The port of the dense path of ``repro/models/transformer.py``.  Every
sublayer's parameters keep the reference's leading ``n_super`` dimension
(``{"sub0": {...}}`` with leaves ``(n_super, ...)``), so the gradient
leaves have the reference's shapes; the reference's ``lax.scan`` over that
dimension becomes a loop over the layer index.  The decode cache keeps the
same leading ``n_super`` dimension (:func:`init_stack_cache`), and
:func:`stack_decode` updates it in place, layer by layer.
"""

from __future__ import annotations

import torch

from . import attention as attn_mod
from .layers import glu_mlp, init_glu_mlp, rms_norm
from .. import tree as tree_util

__all__ = ["init_stack", "stack_apply", "init_stack_cache", "stack_decode"]


def init_stack(cfg, dtype, *, generator, device):
    """Stacked params: {"sub<i>": tree with leading n_super dim}."""
    n_super = cfg.num_super_layers
    lead = (n_super,)
    zeros = lambda: torch.zeros(lead + (cfg.d_model,), dtype=torch.float32,
                                device=device)
    out = {}
    for i, _ in enumerate(cfg.pattern):
        out[f"sub{i}"] = {
            "norm1": zeros(),
            "mixer": attn_mod.init_attention(
                cfg, dtype, lead=lead, generator=generator, device=device
            ),
            "ffn": init_glu_mlp(
                cfg.d_model, cfg.d_ff, dtype, lead=lead,
                generator=generator, device=device,
            ),
            "norm2": zeros(),
        }
    return out


def _sublayer_full(p, x, *, cfg, positions):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    h = attn_mod.attention_full(p["mixer"], h, cfg=cfg, positions=positions)
    x = x + h
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + glu_mlp(p["ffn"], h, cfg.act)


def stack_apply(stack_params, x: torch.Tensor, *, cfg, positions):
    """Run the stack, layer by layer."""
    for layer in range(cfg.num_super_layers):
        for i, _ in enumerate(cfg.pattern):
            p = tree_util.tree_map(lambda t: t[layer], stack_params[f"sub{i}"])
            x = _sublayer_full(p, x, cfg=cfg, positions=positions)
    return x


# ---------------------------------------------------------------------------
# decode (single token, cached)
# ---------------------------------------------------------------------------


def init_stack_cache(cfg, batch: int, max_len: int, dtype, *, device):
    """Cache tree mirroring the stack: ``{"sub<i>": {"k", "v", "pos"}}``
    with leaves ``(n_super, batch, ...)``."""
    lead = (cfg.num_super_layers,)
    return {
        f"sub{i}": attn_mod.init_cache(cfg, batch, max_len, window=None,
                                       dtype=dtype, device=device,
                                       lead=lead)
        for i, _ in enumerate(cfg.pattern)
    }


def _sublayer_decode(p, x, cache, *, cfg, index):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    h, _ = attn_mod.attention_decode(p["mixer"], h, cache, index, cfg=cfg)
    x = x + h
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + glu_mlp(p["ffn"], h, cfg.act)


def stack_decode(stack_params, x: torch.Tensor, cache, index, *, cfg):
    """One-token decode through the stack; ``index`` (B,).  Updates
    ``cache`` in place and returns ``(x, cache)``."""
    for layer in range(cfg.num_super_layers):
        for i, _ in enumerate(cfg.pattern):
            p = tree_util.tree_map(lambda t: t[layer], stack_params[f"sub{i}"])
            c = {k: t[layer] for k, t in cache[f"sub{i}"].items()}
            x = _sublayer_decode(p, x, c, cfg=cfg, index=index)
    return x, cache
