"""Config dataclasses of the port: models and the optimizer.

A copy of what the data-parallel train step needs from
``repro/configs/base.py`` (the port imports nothing of the JAX package).
Only the dense decoder family is carried so far: a model is
``num_super_layers`` repetitions of its sublayer *pattern*, each sublayer an
attention mixer with a dense GLU FFN.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["SubLayer", "ModelConfig", "OptimizerConfig"]

Mixer = Literal["attn"]
FFN = Literal["dense"]


@dataclasses.dataclass(frozen=True)
class SubLayer:
    """One sublayer of the super-layer pattern: a mixer plus an FFN."""

    mixer: Mixer = "attn"
    ffn: FFN = "dense"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # "dense" (the only family ported so far)
    num_layers: int               # total sublayers
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None   # default d_model // num_heads
    pattern: tuple[SubLayer, ...] = (SubLayer(),)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    act: str = "silu"             # silu | gelu | relu
    dtype: str = "bfloat16"
    attn_logit_softcap: float | None = None   # cap * tanh(score / cap)
    final_logit_softcap: float | None = None  # the same on the logits

    def __post_init__(self):
        if self.num_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers {self.num_layers} not divisible "
                f"by pattern length {len(self.pattern)}"
            )
        if self.family != "dense" or any(
            s != SubLayer() for s in self.pattern
        ):
            raise NotImplementedError(
                f"{self.name}: the port carries the dense attention family "
                "only"
            )

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def num_super_layers(self) -> int:
        return self.num_layers // len(self.pattern)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + stack + norms)."""
        d, hd = self.d_model, self.resolved_head_dim
        q, kv = self.num_heads * hd, self.num_kv_heads * hd
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = d * (q + 2 * kv) + q * d + 3 * d * self.d_ff + 2 * d
        return total + per_layer * self.num_layers + d


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"      # cosine | wsd | constant
    warmup_steps: int = 100
    decay_steps: int = 10_000
    stable_steps: int = 0         # WSD plateau
    moment_dtype: str = "float32"
