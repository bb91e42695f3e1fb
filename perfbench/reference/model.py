"""The decoder's training loss, in plain float32 PyTorch.

Written from the configuration's file: a token embedding, ``num_layers``
pre-norm blocks of causal multi-head attention with rotary positions and
a SiLU-gated FFN (a dense one, or top-k routed experts with shared ones
beside them), a final norm and the head (the embedding's transpose where
the configuration ties them, else ``lm_head`` (D, V)); the loss
is the masked mean cross-entropy of the next token plus, with experts,
the Switch-style load-balance term.  As the configuration runs them:

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
for the control (``train.fp8_matmul``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["loss"]


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
