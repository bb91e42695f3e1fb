"""The architectures the port runs, copied from ``repro/configs/archs.py``.

The reference's ten architectures, with their published values
(``[source; verified-tier]`` as there): nine decoder-only and whisper-tiny,
the encoder-decoder.  ``reduced(cfg)`` produces the
same-family miniature the CPU tests run.  The ``*_2L`` / ``*_1S`` / ``*_4L``
configurations are the full-width cuts ``chip_smoke.py`` runs on the card,
each with its cut listed beside it.
"""

from __future__ import annotations

import dataclasses

from .base import MambaConfig, ModelConfig, MoEConfig, SubLayer

__all__ = [
    "ARCHS", "MINICPM_2B", "MINICPM_2B_4L", "MINICPM_2B_8L", "CHIP_FAMILIES",
    "RWKV6_1_6B_4L", "WHISPER_TINY", "get_config", "reduced",
]


# --- dense -----------------------------------------------------------------

# gemma2-27b: local+global alternating attention, logit softcaps
# [arXiv:2408.00118; hf].  head_dim=128 per the public HF config.
GEMMA2_27B = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256_000,
    pattern=(SubLayer("attn_local"), SubLayer("attn")),
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    act="gelu",
    tie_embeddings=True,
    sandwich_norm=True,
    scale_embeddings=True,
)

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

# qwen2-72b: GQA with QKV bias [arXiv:2407.10671; hf]
QWEN2_72B = ModelConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152_064,
    pattern=(SubLayer("attn"),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

# granite-20b: llama-arch code model, MQA (kv=1) [arXiv:2405.04324; hf]
GRANITE_20B = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49_152,
    pattern=(SubLayer("attn"),),
    tie_embeddings=True,
)

# --- hybrid ----------------------------------------------------------------

# jamba-1.5-large-398b: mamba+attention 1:7, MoE 16e top-2 every other
# sublayer [arXiv:2403.19887; hf]
JAMBA_1_5_LARGE = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65_536,
    # 8-sublayer block: attention at position 4, mamba elsewhere (1:7);
    # MoE on odd sublayers (every other), dense FFN on the rest.
    pattern=tuple(
        SubLayer(
            mixer="attn" if i == 4 else "mamba",
            ffn="moe" if i % 2 == 1 else "dense",
        )
        for i in range(8)
    ),
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=24576),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    tie_embeddings=False,
)

# --- vlm -------------------------------------------------------------------

# qwen2-vl-2b: M-RoPE, dynamic resolution (vision frontend stubbed: the
# model takes precomputed embeddings) [arXiv:2409.12191; hf]
QWEN2_VL_2B = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151_936,
    pattern=(SubLayer("attn"),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    frontend="vision_patches",
    tie_embeddings=True,
)

# --- moe -------------------------------------------------------------------

# moonshot-v1-16b-a3b (moonlight): 64e top-6, 2 shared
# [hf:moonshotai/Moonlight-16B-A3B; hf]
MOONSHOT_16B = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163_840,
    pattern=(SubLayer("attn", ffn="moe"),),
    moe=MoEConfig(
        num_experts=64, top_k=6, d_expert=1408, num_shared_experts=2
    ),
    tie_embeddings=True,
)

# deepseek-moe-16b: fine-grained 64 routed top-6 + 2 shared
# [arXiv:2401.06066; hf]
DEEPSEEK_MOE_16B = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102_400,
    pattern=(SubLayer("attn", ffn="moe"),),
    moe=MoEConfig(
        num_experts=64, top_k=6, d_expert=1408, num_shared_experts=2
    ),
    tie_embeddings=True,
)

# --- ssm -------------------------------------------------------------------

# rwkv6-1.6b "Finch": attention-free, data-dependent decay
# [arXiv:2404.05892; unverified]
RWKV6_1_6B = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,          # d_model / rwkv_head_size
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65_536,
    pattern=(SubLayer("rwkv6"),),
    rwkv_head_size=64,
    tie_embeddings=False,
)

# --- audio -----------------------------------------------------------------

# whisper-tiny: enc-dec, conv frontend stubbed (batch["frames"] holds the
# frame embeddings) [arXiv:2212.04356; unverified]
WHISPER_TINY = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,          # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    pattern=(SubLayer("attn"),),
    encoder_layers=4,
    encoder_pattern=(SubLayer("attn"),),
    cross_attention=True,
    frontend="audio_frames",
    act="gelu",
    tie_embeddings=True,
)

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        GEMMA2_27B,
        MINICPM_2B,
        QWEN2_72B,
        GRANITE_20B,
        JAMBA_1_5_LARGE,
        QWEN2_VL_2B,
        MOONSHOT_16B,
        DEEPSEEK_MOE_16B,
        RWKV6_1_6B,
        WHISPER_TINY,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


# --- full-width cuts run on one card by chip_smoke.py ------------------------
#
# Every width, head count, vocabulary, expert width, top-k, window, state
# size and the dtype (bf16) stay as published; what is cut is listed.

# minicpm-2b, cut to fit the run time of chip_smoke.py (not the card's
# memory):  reduced: num_layers 40 -> 4 (train) / 40 -> 8 (serve).
MINICPM_2B_4L = dataclasses.replace(
    MINICPM_2B, name="minicpm-2b-4l", num_layers=4
)
MINICPM_2B_8L = dataclasses.replace(
    MINICPM_2B, name="minicpm-2b-8l", num_layers=8
)

# The other families (chip_smoke.py phase ``families``), cut in depth for
# the run time and, for jamba, in experts for the card's 80 GB:
#   gemma2-27b:       num_layers 46 -> 2 (one attn_local, one attn)
#   qwen2-72b:        num_layers 80 -> 2
#   granite-20b:      num_layers 52 -> 2
#   jamba-1.5-large:  num_layers 72 -> 8 (one whole super-layer: 7 mamba,
#                     1 attn, 4 MoE); experts 16 -> 4 (top-2 and d_expert
#                     24,576 kept; 16 experts are 90.5 GB in bf16)
#   deepseek-moe-16b: num_layers 28 -> 2
#   rwkv6-1.6b:       whole (24 layers); RWKV6_1_6B_4L: 24 -> 4 (train)
#   qwen2-vl-2b:      whole (28 layers), text tokens
CHIP_FAMILIES: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        dataclasses.replace(GEMMA2_27B, name="gemma2-27b-2l", num_layers=2),
        dataclasses.replace(QWEN2_72B, name="qwen2-72b-2l", num_layers=2),
        dataclasses.replace(GRANITE_20B, name="granite-20b-2l",
                            num_layers=2),
        dataclasses.replace(
            JAMBA_1_5_LARGE, name="jamba-1.5-large-1s-4e", num_layers=8,
            moe=dataclasses.replace(JAMBA_1_5_LARGE.moe, num_experts=4),
        ),
        dataclasses.replace(DEEPSEEK_MOE_16B, name="deepseek-moe-16b-2l",
                            num_layers=2),
        RWKV6_1_6B,
        QWEN2_VL_2B,
    ]
}
RWKV6_1_6B_4L = dataclasses.replace(
    RWKV6_1_6B, name="rwkv6-1.6b-4l", num_layers=4
)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Same-family miniature for CPU tests: small width/depth, tiny vocab,
    few experts, float32 -- structure (pattern, mixers, MoE, enc-dec)
    intact (the JAX package's ``reduced``)."""
    pattern_len = len(cfg.pattern)
    changes = dict(
        name=cfg.name + "-smoke",
        num_layers=pattern_len * (2 if pattern_len <= 2 else 1),
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        sliding_window=32 if cfg.sliding_window else None,
        dtype="float32",
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2, d_expert=64,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
        )
    if cfg.mamba is not None:
        changes["mamba"] = MambaConfig(d_state=4, d_conv=4, expand=2)
    if cfg.encoder_layers:
        changes["encoder_layers"] = 2
    if cfg.mrope_sections:
        changes["mrope_sections"] = (4, 2, 2)
    if cfg.pattern[0].mixer == "rwkv6":
        changes["num_heads"] = 4
        changes["head_dim"] = None
        changes["rwkv_head_size"] = 16
    return dataclasses.replace(cfg, **changes)
