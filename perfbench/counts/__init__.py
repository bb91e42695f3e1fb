"""The benchmark's own counts of the work a step needs, from shapes.

They count what the algorithm needs, not what an implementation does:
the routed top-k plus the shared experts of every token (no capacity
padding, no dropped items), causal attention over half the score matrix,
no recomputation; each input byte read once and each output byte
written once.
"""

from __future__ import annotations

from ..weights import leaf_specs, n_elements

__all__ = ["active_matmul_params", "step_flops", "transport_bytes"]


def active_matmul_params(config: dict) -> int:
    """Weights of the matrix products one token passes through: the head
    (tied to the embedding or not, V x D once: the embedding's lookup is
    no product), the attention projections, the FFN, or the router with
    the top-k routed and the shared experts."""
    L, D, V = config["num_layers"], config["d_model"], config["vocab_size"]
    H, K, hd = config["num_heads"], config["num_kv_heads"], \
        config["head_dim"]
    attn = D * (H + 2 * K) * hd + H * hd * D
    if config["ffn"] == "dense":
        ffn = 3 * D * config["d_ff"]
    else:
        m = config["moe"]
        ffn = ((m["top_k"] + m["num_shared_experts"]) * 3 * D * m["d_expert"]
               + D * m["num_experts"])
    return V * D + L * (attn + ffn)


def step_flops(config: dict, rows: int, seq: int) -> float:
    """FLOPs of one training step (forward and backward) over ``rows`` x
    ``seq`` tokens: 6 per active weight and token, plus the attention
    products' ``6 B H hd S^2`` a layer (``QK^T`` and ``PV`` over the causal
    half, forward once and backward twice)."""
    tokens = rows * seq
    attn = 6 * rows * config["num_heads"] * config["head_dim"] * seq ** 2
    return 6.0 * active_matmul_params(config) * tokens \
        + float(attn) * config["num_layers"]


def transport_bytes(config: dict, bits: int) -> float:
    """Bytes a one-rank compressed sync of every leaf moves through the two
    transport kernels: the float32 gradient read and the ``bits``-bit wire
    and one float32 scale a leaf written, then the wire and scales read and
    the float32 gradient written."""
    E = n_elements(config)
    leaves = len(leaf_specs(config))
    return 2.0 * (4 * E + E * bits / 8 + 4 * leaves)
