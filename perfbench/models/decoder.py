"""The decoder: its weight tree, its work a step, and its plain loss.

The model file of every configuration whose file says ``"model":
"decoder"``: ``num_layers`` identical pre-norm blocks (the port's pattern
of one sublayer) of causal multi-head attention with rotary positions and
a SiLU-gated FFN, a dense one or top-k routed experts with shared ones
beside them, between a token embedding and a final norm and head.  Plain
PyTorch that imports nothing of the port: the harness takes the tree
(:func:`leaf_specs`) and the counts (:func:`active_matmul_params`,
:func:`step_flops`) from it, and the reference (``reference/train.py``)
the loss (:func:`loss`).

**The tree** has the port's keys and shapes (``{"embedding",
"final_norm", ["lm_head",] "stack": {"sub0": ...}}``, every layer's leaf
stacked on a leading dim), each leaf with the scale it starts at: the
embedding 0.02, each projection (an untied head's too) ``1 / sqrt(fan-in)``
(the second-to-last dim), the router ``1 / sqrt(d_model)``, the norms 0 (a
scale of 1, as the RMS norm multiplies by ``1 + scale``).

**The counts** are what the algorithm needs, not what an implementation
does: the routed top-k plus the shared experts of every token (no capacity
padding, no dropped items), causal attention over half the score matrix,
no recomputation.

**The loss**, written from the configuration's file and the published
description of the layers: the masked mean cross-entropy of the next
token through the head (the embedding's transpose where the configuration
ties them, else ``lm_head`` (D, V)) plus, with experts, the Switch-style
load-balance term.  As the configuration runs them:

* RMS norm multiplies by ``1 + scale``;
* rotary positions rotate the two halves of each head
  (``[x1 cos - x2 sin, x2 cos + x1 sin]``, frequencies
  ``theta ** (-i / (hd / 2))``);
* the router is a float32 softmax over the experts, its top-k gates
  renormalised over the selected experts; each expert takes at most
  ``capacity = max(8, ceil8(ceil(T k / E * factor)))`` of the step's
  ``T`` tokens, items counted in token-major order, and drops the rest;
* the load-balance term is ``weight * E * sum(routed share * mean
  probability)`` per layer.

``mm`` is the matrix product every projection and attention product
goes through: ``torch.matmul`` for the reference, a lower-precision one
for the control (``reference.train.fp8_matmul``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["leaf_specs", "active_matmul_params", "step_flops", "loss"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaf_specs(config: dict) -> dict:
    """``{path: (shape, dtype, scale)}`` of the parameter tree, paths as
    tuples of keys, ``scale`` 0 for a leaf that starts at zero."""
    L, D, V = config["num_layers"], config["d_model"], config["vocab_size"]
    H, K, hd = config["num_heads"], config["num_kv_heads"], \
        config["head_dim"]
    wd = _DTYPES[config["dtype"]]
    f32 = torch.float32
    fan = lambda shape: 1.0 / math.sqrt(shape[-2])  # noqa: E731
    specs = {
        ("embedding",): ((V, D), wd, 0.02),
        ("final_norm",): ((D,), f32, 0.0),
        ("stack", "sub0", "norm1"): ((L, D), f32, 0.0),
        ("stack", "sub0", "norm2"): ((L, D), f32, 0.0),
    }
    if not config["tie_embeddings"]:
        specs[("lm_head",)] = ((D, V), wd, fan((D, V)))
    for name, shape in (("w_q", (L, D, H * hd)), ("w_k", (L, D, K * hd)),
                        ("w_v", (L, D, K * hd)), ("w_o", (L, H * hd, D))):
        specs["stack", "sub0", "mixer", name] = (shape, wd, fan(shape))

    def glu(prefix, F):
        for name, shape in (("w_gate", (L, D, F)), ("w_up", (L, D, F)),
                            ("w_down", (L, F, D))):
            specs[prefix + (name,)] = (shape, wd, fan(shape))

    ffn = ("stack", "sub0", "ffn")
    if config["ffn"] == "dense":
        glu(ffn, config["d_ff"])
    else:
        m = config["moe"]
        E, Fe = m["num_experts"], m["d_expert"]
        specs[ffn + ("w_router",)] = ((L, D, E), f32, 1.0 / math.sqrt(D))
        for name, shape in (("we_gate", (L, E, D, Fe)),
                            ("we_up", (L, E, D, Fe)),
                            ("we_down", (L, E, Fe, D))):
            specs[ffn + (name,)] = (shape, wd, fan(shape))
        if m["num_shared_experts"]:
            glu(ffn + ("shared",), m["num_shared_experts"] * Fe)
    return dict(sorted(specs.items()))


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


def _rms(x, scale, eps):
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + scale)


def _rope(x, theta):
    """x (B, S, H, hd), positions 0 .. S-1."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freq = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freq
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(p, x, l, c, mm):
    B, S, D = x.shape
    H, K, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    q = mm(x, p["w_q"][l]).view(B, S, H, hd)
    k = mm(x, p["w_k"][l]).view(B, S, K, hd)
    v = mm(x, p["w_v"][l]).view(B, S, K, hd)
    q, k = _rope(q, c["rope_theta"]), _rope(k, c["rope_theta"])
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))      # (B, ., S, hd)
    k = k.repeat_interleave(H // K, dim=1)
    v = v.repeat_interleave(H // K, dim=1)
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = mm(torch.softmax(scores, dim=-1), v)             # (B, H, S, hd)
    return mm(out.transpose(1, 2).reshape(B, S, H * hd), p["w_o"][l])


def _glu(x, w_gate, w_up, w_down, mm):
    return mm(F.silu(mm(x, w_gate)) * mm(x, w_up), w_down)


def _capacity(tokens, k, experts, factor):
    cap = int(math.ceil(tokens * k / experts * factor))
    return max(8, ((cap + 7) // 8) * 8)


def _moe(p, x, l, c, mm):
    """(routed + shared output (B, S, D), load-balance term)."""
    m = c["moe"]
    B, S, D = x.shape
    E, k = m["num_experts"], m["top_k"]
    xf = x.reshape(B * S, D)
    T = xf.shape[0]
    probs = torch.softmax(mm(xf, p["w_router"][l]), dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    share = F.one_hot(idx, E).to(torch.float32).mean(dim=(0, 1))
    aux = m["router_aux_weight"] * E * torch.sum(share * probs.mean(0))
    dest = idx.reshape(-1)                                  # (T k,)
    onehot = F.one_hot(dest, E)
    pos = (torch.cumsum(onehot, dim=0) - 1).gather(1, dest[:, None])[:, 0]
    keep = pos < _capacity(T, k, E, m["capacity_factor"])
    token = torch.arange(T, device=x.device).repeat_interleave(k)
    y = torch.zeros_like(xf)
    for e in range(E):
        sel = keep & (dest == e)
        tok = token[sel]
        if tok.numel() == 0:
            continue
        out = _glu(xf[tok], p["we_gate"][l, e], p["we_up"][l, e],
                   p["we_down"][l, e], mm)
        y = y.index_add(0, tok, out * gate.reshape(-1)[sel][:, None])
    y = y.view(B, S, D)
    if m["num_shared_experts"]:
        s = p["shared"]
        y = y + _glu(x, s["w_gate"][l], s["w_up"][l], s["w_down"][l], mm)
    return y, aux


def loss(params: dict, batch: dict, config: dict, mm=torch.matmul):
    """The training loss of ``batch`` (``tokens``, ``labels``,
    ``loss_mask``; (B, S)) under ``params`` (the port's tree, float32
    leaves): cross-entropy plus the load-balance terms."""
    c = config
    eps = c["norm_eps"]
    st = params["stack"]["sub0"]
    x = params["embedding"][batch["tokens"]]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l in range(c["num_layers"]):
        x = x + _attention(st["mixer"], _rms(x, st["norm1"][l], eps), l, c,
                           mm)
        h = _rms(x, st["norm2"][l], eps)
        if c["ffn"] == "moe":
            h, a = _moe(st["ffn"], h, l, c, mm)
            aux = aux + a
        else:
            f = st["ffn"]
            h = _glu(h, f["w_gate"][l], f["w_up"][l], f["w_down"][l], mm)
        x = x + h
    x = _rms(x, params["final_norm"], eps)
    head = params["embedding"].t() if c["tie_embeddings"] \
        else params["lm_head"]
    logits = mm(x, head)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, batch["labels"][..., None])[..., 0]
    mask = batch["loss_mask"]
    ce = ((logz - gold) * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return ce + aux
