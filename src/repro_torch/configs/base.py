"""Config dataclasses of the port: models, cell shapes, the optimizer and
the training run.

A copy of what the port needs from ``repro/configs/base.py`` (the port
imports nothing of the JAX package).  A model is ``num_super_layers``
repetitions of its sublayer *pattern*: each sublayer a mixer (global or
sliding-window attention, Mamba, RWKV6) with an FFN (dense GLU, MoE, or the
RWKV channel-mix that comes with an RWKV6 mixer).  Uniform decoders use a
1-sublayer pattern; gemma2 alternates (local, global); jamba uses a
1-attn : 7-mamba block with MoE on every other sublayer.  The
encoder-decoder family (whisper) adds an encoder stack of
``encoder_layers`` sublayers of its own ``encoder_pattern`` and a
cross-attention block in every decoder sublayer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

__all__ = ["MoEConfig", "MambaConfig", "SubLayer", "ModelConfig",
           "ShapeConfig", "SHAPES", "OptimizerConfig", "TrainConfig"]

Mixer = Literal["attn", "attn_local", "mamba", "rwkv6", "none"]
FFN = Literal["dense", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    num_shared_experts: int = 0   # deepseek-style always-on experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int | None = None    # default ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class SubLayer:
    """One sublayer of the super-layer pattern: a mixer plus an FFN."""

    mixer: Mixer = "attn"
    ffn: FFN = "dense"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int               # total sublayers
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None   # default d_model // num_heads
    pattern: tuple[SubLayer, ...] = (SubLayer(),)

    # attention features
    sliding_window: int | None = None   # width of "attn_local" sublayers
    attn_logit_softcap: float | None = None   # cap * tanh(score / cap)
    final_logit_softcap: float | None = None  # the same on the logits
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: tuple[int, int, int] | None = None  # qwen2-vl M-RoPE

    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    rwkv_head_size: int = 64

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_pattern: tuple[SubLayer, ...] = ()
    cross_attention: bool = False
    # "audio_frames" | "vision_patches" stubs: precomputed frame embeddings
    # (batch["frames"]) or token embeddings (batch["embeds"])
    frontend: str | None = None

    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    act: str = "silu"             # silu | gelu | relu
    sandwich_norm: bool = False   # gemma2 post-mixer / post-ffn norms
    scale_embeddings: bool = False  # gemma: embed * sqrt(d_model)
    dtype: str = "bfloat16"
    # checkpointing of the stack, one super-layer at a time: "full"
    # recomputes its forward in the backward pass, "dots" keeps the matrix
    # products' outputs and recomputes the rest, "none" keeps everything
    remat: str = "full"
    # The reference's XLA levers: they set how XLA slices and fuses, not
    # what is computed.  The port accepts them and computes the same values
    # with either setting.
    window_kv_slice: bool = False  # slice K/V to the window per q-chunk
    scan_unroll: int = 1           # SSM time-scan unroll (fusion width)
    # precision levers: cotangents cast to the weight dtype through the
    # projections (float32 accumulation); Mamba's dt / B / C rounded to
    # bf16 (the state stays float32)
    bf16_bwd: bool = False
    mamba_bf16_io: bool = False

    def __post_init__(self):
        if self.num_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers {self.num_layers} not divisible "
                f"by pattern length {len(self.pattern)}"
            )
        if self.remat not in ("full", "dots", "none"):
            raise ValueError(f"{self.name}: remat {self.remat!r} is not "
                             "one of full / dots / none")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def num_super_layers(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def is_decoder_only(self) -> bool:
        return self.encoder_layers == 0

    @property
    def max_attention_window(self) -> int | None:
        """None if any sublayer attends globally (unbounded KV)."""
        widths = []
        for sub in self.pattern:
            if sub.mixer == "attn":
                return None
            if sub.mixer == "attn_local":
                widths.append(self.sliding_window)
        return max(widths) if widths else 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic context growth: SSM / hybrid / windowed attention."""
        return all(sub.mixer != "attn" for sub in self.pattern) or any(
            sub.mixer in ("mamba", "rwkv6") for sub in self.pattern
        ) or self.name.startswith("gemma2")

    def param_count(self) -> int:
        """Analytic parameter count (embedding, head, stacks), as the
        reference reckons it (no final or encoder norm, no cross-attention
        norm; RWKV's decay LoRA approximated)."""
        d, hd = self.d_model, self.resolved_head_dim
        q = self.num_heads * hd
        kv = self.num_kv_heads * hd
        total = self.vocab_size * d  # embed (tied head)
        if not self.tie_embeddings:
            total += self.vocab_size * d

        def ffn_params(sub: SubLayer) -> int:
            if sub.ffn == "dense":
                return 3 * d * self.d_ff
            if sub.ffn == "moe":
                m = self.moe
                per = 3 * d * m.d_expert
                return ((m.num_experts + m.num_shared_experts) * per
                        + d * m.num_experts)
            return 0

        def mixer_params(sub: SubLayer) -> int:
            if sub.mixer in ("attn", "attn_local"):
                return d * (q + 2 * kv) + q * d
            if sub.mixer == "mamba":
                m = self.mamba or MambaConfig()
                d_in = m.expand * d
                dt_rank = m.dt_rank or math.ceil(d / 16)
                return (
                    d * 2 * d_in          # in_proj
                    + d_in * m.d_conv     # conv
                    + d_in * (dt_rank + 2 * m.d_state)  # x_proj
                    + dt_rank * d_in      # dt_proj
                    + d_in * m.d_state    # A
                    + d_in                # D
                    + d_in * d            # out_proj
                )
            if sub.mixer == "rwkv6":
                return 4 * d * d + 2 * d * 32  # r,k,v,o + lora decay approx
            return 0

        per_pattern = sum(
            ffn_params(s) + mixer_params(s) + 2 * d for s in self.pattern
        )
        total += per_pattern * self.num_super_layers
        if self.encoder_layers:
            enc_pattern = self.encoder_pattern or (SubLayer(),)
            enc = sum(ffn_params(s) + mixer_params(s) + 2 * d
                      for s in enc_pattern)
            total += enc * self.encoder_layers // len(enc_pattern)
            if self.cross_attention:
                total += (d * (q + 2 * kv) + q * d) * self.num_layers
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        per_expert = 3 * self.d_model * m.d_expert
        n_moe_layers = sum(
            1 for s in self.pattern if s.ffn == "moe"
        ) * self.num_super_layers
        inactive = (m.num_experts - m.top_k) * per_expert * n_moe_layers
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    seq_len: int = 512
    global_batch: int = 8
    microbatch: int | None = None     # gradient accumulation
    seed: int = 0
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    log_every: int = 10
    optimizer: OptimizerConfig = OptimizerConfig()
    # carried as the reference carries them: its build_training reads
    # neither, and neither does the port's
    grad_sync_algorithm: str = "auto"
    grad_sync_compress_bits: int | None = None
