"""The architectures the port runs, copied from ``repro/configs/archs.py``.

``reduced(cfg)`` produces the same-family miniature the CPU tests train;
:data:`MINICPM_2B_4L` is the full-width configuration ``chip_smoke.py``
trains on the card.
"""

from __future__ import annotations

import dataclasses

from .base import ModelConfig, SubLayer

__all__ = ["ARCHS", "MINICPM_2B", "MINICPM_2B_4L", "get_config", "reduced"]


# minicpm-2b: llama-like dense, trained with WSD [arXiv:2404.06395; hf]
MINICPM_2B = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122_753,
    pattern=(SubLayer("attn"),),
    tie_embeddings=True,
)

# minicpm-2b at its published widths with the depth cut to fit the run time
# of chip_smoke.py (not the card's memory):
#   reduced: num_layers 40 -> 4.
# Every width, the vocabulary, the tied head and bf16 stay as published.
MINICPM_2B_4L = dataclasses.replace(
    MINICPM_2B, name="minicpm-2b-4l", num_layers=4
)

ARCHS: dict[str, ModelConfig] = {c.name: c for c in [MINICPM_2B]}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Same-family miniature for CPU tests: small width/depth, tiny vocab,
    float32 (the dense-family branch of the JAX package's ``reduced``)."""
    pattern_len = len(cfg.pattern)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=pattern_len * (2 if pattern_len <= 2 else 1),
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        dtype="float32",
    )
