"""Public model API: ``build_model(cfg, ...) -> Model`` (an ``nn.Module``).

The port of ``repro/models/model.py``: dense, MoE, hybrid (Mamba +
attention), SSM (RWKV6), the VLM backbone (the vision frontend stubbed:
precomputed embeddings and (3, B, S) M-RoPE positions) and the
whisper-style encoder-decoder (the audio frontend stubbed: ``frames``
(B, S_enc, D) are already embeddings; a non-causal encoder stack and its
final norm give ``enc_out``, which every decoder sublayer's
cross-attention block attends).  The parameters are a tree with the
reference's keys and shapes, e.g. for a dense model::

    {"embedding": (V, D), "final_norm": (D,), ["lm_head": (D, V),]
     "stack": {"sub0": {"ffn": {"w_down", "w_gate", "w_up"},
                        "mixer": {"w_k", "w_o", "w_q", "w_v"},
                        "norm1", "norm2"}}}       # leaves (n_super, ...)

(an encoder-decoder adds ``"encoder"``, a stack of the same form, and
``"encoder_norm"`` (D,), and its decoder sublayers ``"norm_cross"`` and
``"cross"`` {"w_k", "w_o", "w_q", "w_v"}), held by :class:`Model` as
``nn.Parameter``s; :meth:`Model.leaves` lists
them in the order ``jax.tree.flatten`` lists the reference's (sorted keys).
The training loss is a sequence-chunked cross-entropy with float32
logits through the (tied or untied) head, plus the MoE load-balance loss;
it runs under :class:`~repro_torch.models.layers.mixed_bwd` when the
config sets ``bf16_bwd``, and the stack under the config's ``remat``.

Cached decode (:meth:`Model.init_decode` / :meth:`Model.decode_hidden` /
:meth:`Model.decode_step`) keeps one index per batch row, so a fixed batch
and the serving engine's slots (each at its own position) run the same
step.  The cache is a tree of tensors updated in place::

    {"index": (B,) int32,
     "stack": {"sub0": {"k", "v": (n_super, B, KV, size, hd),
                        "pos": (n_super, B, size) int32}}}

(a Mamba sublayer holds ``conv`` / ``state``, an RWKV6 one ``x_prev`` /
``state`` / ``cm_x_prev``, every leaf ``(n_super, B, ...)``; an
encoder-decoder's cache also holds ``"enc_out"`` (B, S_enc, D), computed
once from the request's frames when the cache is made).
:func:`cache_from_jax` / :func:`cache_to_jax` convert the reference's
decode caches (its fixed-batch form with a scalar index, or the engine's
slot-stacked form) to this one and back.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from . import transformer as tfm
from .layers import head_dot, mixed_bwd, rms_norm, softcap
from .sharding import ShardingPolicy, grad_in_layout, is_dtensor
from .. import tree as tree_util
from ..device import resolve_device

__all__ = [
    "Model",
    "build_model",
    "init_params",
    "params_from_jax",
    "params_to_numpy",
    "cache_from_jax",
    "cache_to_jax",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def init_params(cfg, *, generator: torch.Generator | None = None,
                device=None) -> dict:
    """Random parameters from ``generator`` (``device="meta"`` gives the
    shapes and dtypes only, with no memory)."""
    device = torch.device("meta") if str(device) == "meta" else (
        resolve_device(device)
    )
    if device.type == "meta":
        generator = None
    elif generator is None:
        raise ValueError("init_params needs an explicit torch.Generator")
    dtype = _dtype(cfg)
    emb = torch.randn((cfg.vocab_size, cfg.d_model), generator=generator,
                      device=device, dtype=torch.float32)
    params = {
        "embedding": (emb * 0.02).to(dtype),
        "stack": tfm.init_stack(cfg, dtype, generator=generator,
                                device=device, cross=cfg.cross_attention),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                  device=device),
    }
    if not cfg.tie_embeddings:
        head = torch.randn((cfg.d_model, cfg.vocab_size), generator=generator,
                           device=device, dtype=torch.float32)
        params["lm_head"] = (head * 0.02).to(dtype)
    if cfg.encoder_layers:
        params["encoder"] = tfm.init_stack(
            cfg, dtype, generator=generator, device=device,
            n_layers=cfg.encoder_layers, pattern=cfg.encoder_pattern,
        )
        params["encoder_norm"] = torch.zeros((cfg.d_model,),
                                             dtype=torch.float32,
                                             device=device)
    return params


class _Node(nn.Module):
    """One dict level of the parameter tree (children in sorted order)."""

    def __init__(self, tree: dict):
        super().__init__()
        for key in sorted(tree):
            v = tree[key]
            if isinstance(v, dict):
                self.add_module(key, _Node(v))
            else:
                self.register_parameter(key, nn.Parameter(v))

    def tree(self) -> dict:
        out = {k: p for k, p in self._parameters.items()}
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


class Model(nn.Module):
    """The decoder LM; ``forward(batch)`` returns ``(loss, metrics)``.

    ``batch`` holds ``tokens`` (B, S), or ``embeds`` (B, S, D) (the VLM
    stub frontend) with ``labels``; optional ``positions`` ((B, S), or
    (3, B, S) for M-RoPE) and ``loss_mask``; an encoder-decoder also
    ``frames`` (B, S_enc, D).

    With a :class:`~repro_torch.models.sharding.ShardingPolicy` on a mesh
    the parameters are DTensors laid out by the policy's ``param_specs``,
    the batch is placed by the caller (``SyntheticLM(mesh=)``), and the
    forward pass constrains its activations where the reference does
    (``hidden`` after the embedding and at the top of every super-layer,
    ``heads`` / ``kv`` in attention, ``logits`` in the loss); the tensors
    it makes itself (positions, masks) count as replicated."""

    def __init__(self, cfg, params: dict, policy: ShardingPolicy | None = None):
        super().__init__()
        self.cfg = cfg
        self.policy = policy or ShardingPolicy()
        self.root = _Node(params)

    def params(self) -> dict:
        """The parameter tree (the ``nn.Parameter``s themselves)."""
        return self.root.tree()

    def leaves(self) -> list[nn.Parameter]:
        """The parameters in ``jax.tree.flatten`` order of the reference."""
        return tree_util.leaves(self.params())

    def forward(self, batch: dict):
        # the config's bf16_bwd lever: the projections of this pass take
        # the bf16 backward (the reference's ``Model.loss``)
        with mixed_bwd(self.cfg.bf16_bwd), self.policy.scope():
            return self._loss(batch)

    def _loss(self, batch: dict):
        cfg = self.cfg
        p = self.params()
        hidden, aux = _final_hidden(p, batch, cfg, self.policy)
        labels = batch.get("labels")
        if labels is None:
            labels = torch.nn.functional.pad(batch["tokens"][:, 1:], (0, 1))
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32,
                              device=labels.device)
        ce = _chunked_loss(hidden, _head_weights(p, cfg), labels, mask,
                           cap=cfg.final_logit_softcap, policy=self.policy)
        total = ce + aux
        return total, {"loss": total, "ce": ce, "aux": aux}

    @property
    def device(self) -> torch.device:
        return self.root.final_norm.device

    def head_weights(self) -> torch.Tensor:
        """The (D, V) head matrix (the tied embedding's transpose, or the
        untied ``lm_head``)."""
        return _head_weights(self.params(), self.cfg)

    @torch.no_grad()
    def logits(self, batch: dict) -> torch.Tensor:
        """Full float32 logits (B, S, V) of ``batch`` (small use)."""
        p = self.params()
        with self.policy.scope():
            hidden, _ = _final_hidden(p, batch, self.cfg, self.policy)
            logits = softcap(head_dot(hidden, _head_weights(p, self.cfg)),
                             self.cfg.final_logit_softcap)
            return self.policy.act(logits, kind="logits")

    @torch.no_grad()
    def init_decode(self, batch_size: int, max_len: int,
                    batch: dict | None = None) -> dict:
        """An empty decode cache for ``batch_size`` rows of ``max_len``
        positions, every row at index 0.  An encoder-decoder needs
        ``batch["frames"]`` (batch_size, S_enc, D): the cache holds their
        encoder output ``enc_out``."""
        cfg = self.cfg
        cache = {
            "index": torch.zeros((batch_size,), dtype=torch.int32,
                                 device=self.device),
            "stack": tfm.init_stack_cache(cfg, batch_size, max_len,
                                          _dtype(cfg), device=self.device),
        }
        # a model on meta under a policy only describes a layout
        policy = self.policy if self.on_mesh else ShardingPolicy()
        cache = policy.shard_cache(cache)
        if cfg.encoder_layers:
            if batch is None or "frames" not in batch:
                raise ValueError(f"{cfg.name}: an encoder-decoder's decode "
                                 "cache needs the encoder frames "
                                 "(batch['frames'])")
            with policy.scope():
                enc = _encode(self.params(), batch["frames"], cfg, policy)
                cache["enc_out"] = policy.constrain(
                    enc, policy.cache_spec("enc_out", tuple(enc.shape)))
        return cache

    @property
    def on_mesh(self) -> bool:
        """Whether the parameters are DTensors laid out by the policy."""
        return self.policy.mesh is not None and is_dtensor(
            self.root.final_norm)

    @torch.no_grad()
    def decode_hidden(self, cache: dict, tokens: torch.Tensor, *,
                      moe_per_row: bool = False):
        """tokens (B, 1) (or (B, 1, D) embeds for the VLM stub): one cached
        decode step up to (and including) the final norm, without the
        head.  Row ``b`` writes position ``cache["index"][b]``; every index
        then advances by one.  ``moe_per_row``: route each row's MoE token
        as its own group (the serving engine's slots) instead of the batch
        as one.  The cache is updated in place; returns ``(hidden (B, 1,
        D), cache)``.  On a mesh the cache is laid out by the policy
        (:meth:`init_decode`), the tokens are the whole batch (or a
        DTensor), and the hidden state is laid out as ``hidden`` after the
        embedding and at every super-layer, as the reference's."""
        cfg, policy = self.cfg, self.policy
        p = self.params()
        index = cache["index"]
        with policy.scope():
            if tokens.dim() == 3:
                x = tokens.to(_dtype(cfg))
            else:
                x = _embed_tokens(p, policy.constrain(tokens, ()), cfg)
            x = policy.act(x, kind="hidden")
            x, _ = tfm.stack_decode(p["stack"], x, cache["stack"], index,
                                    cfg=cfg, moe_per_row=moe_per_row,
                                    enc_out=cache.get("enc_out"),
                                    policy=policy)
            x = rms_norm(x, p["final_norm"], cfg.norm_eps)
            index.add_(1)
        return x, cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """:meth:`decode_hidden` plus the head: ``(logits (B, 1, V) float32,
        cache)``, laid out as ``logits`` on a mesh."""
        x, cache = self.decode_hidden(cache, tokens)
        with self.policy.scope():
            logits = softcap(head_dot(x, self.head_weights()),
                             self.cfg.final_logit_softcap)
            return self.policy.act(logits, kind="logits"), cache


def _embed_tokens(params, tokens, cfg, policy=ShardingPolicy()):
    table = params["embedding"]
    if is_dtensor(table) and torch.is_grad_enabled():
        if any(p.is_shard(0) for p in table.placements):
            # a vocabulary over the model axis: the table is gathered over
            # its FSDP axes first, as FSDP gathers a weight before its use
            # (left sharded there, the lookup's backward asks DTensor for
            # Shard -> Partial, which the card's torch 2.11 lacks)
            x = policy.constrain(table, (policy.tp_axis, None))[tokens]
        else:
            x = _lookup_on_blocks(table, tokens)
    else:
        x = table[tokens]
    x = x.to(_dtype(cfg))
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _lookup_on_blocks(table, tokens):
    """``table[tokens]`` on each rank's block of a table whose vocabulary is
    not sharded (its columns over the data axes: a vocabulary the model
    axis does not divide), the ids replicated.  Every rank looks up all
    the rows of its columns, so its block's gradient is whole: the
    gradient keeps the table's own layout (no partial sums, which the
    card's torch 2.11 could not add to the tied head's)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dm = table.device_mesh
    ids = tokens.redistribute(dm, [Replicate()] * dm.ndim).to_local()
    rows = table.to_local()[ids]
    where = [Shard(ids.dim()) if p == Shard(1) else p
             for p in table.placements]
    return DTensor.from_local(rows, dm, where, run_check=False)


def _head_weights(params, cfg):
    if cfg.tie_embeddings:
        # the head's gradient comes back in the table's layout, as the
        # lookup's does: the card's torch 2.11 could not add the two in
        # the layouts DTensor gives them (Shard -> Partial)
        return grad_in_layout(params["embedding"]).T  # (D, V)
    return params["lm_head"]


def _encode(params, frames, cfg, policy=ShardingPolicy()):
    """The encoder's output ``enc_out`` (B, S_enc, D): ``frames`` (the stub
    frontend's output) through the non-causal encoder stack (RoPE over
    ``arange(S_enc)``) and its final norm."""
    frames = frames.to(_dtype(cfg))
    pos = torch.arange(frames.shape[1], device=frames.device)[None]
    enc, _ = tfm.stack_apply(params["encoder"], frames, cfg=cfg,
                             positions=pos, pattern=cfg.encoder_pattern,
                             causal=False, policy=policy)
    return rms_norm(enc, params["encoder_norm"], cfg.norm_eps)


def _final_hidden(params, batch, cfg, policy=ShardingPolicy()):
    """[frames -> encoder ->] embed (or take ``batch["embeds"]``) -> stack
    -> final norm.  Returns ``(hidden, aux)``."""
    enc_out = (_encode(params, batch["frames"], cfg, policy)
               if cfg.encoder_layers else None)
    if "embeds" in batch:  # VLM stub frontend: precomputed embeddings
        x = batch["embeds"].to(_dtype(cfg))
    else:
        # on a mesh the lookup takes replicated ids (DTensor's index_put
        # rule fails on batch-sharded ids in the backward); the hidden
        # state is laid out by batch right after
        x = _embed_tokens(params, policy.constrain(batch["tokens"], ()), cfg,
                          policy)
    B, S = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    x = policy.act(x, kind="hidden")
    x, aux = tfm.stack_apply(params["stack"], x, cfg=cfg,
                             positions=positions, enc_out=enc_out,
                             policy=policy)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def _chunked_loss(hidden, head_w, labels, mask, chunk=512, cap=None,
                  policy=ShardingPolicy()):
    """CE over sequence chunks; logits (B, chunk, V) only, never (B, S, V);
    ``policy`` lays the logits out as ``logits``."""
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    nll = cnt = None
    for i in range(0, S, chunk):
        h = hidden[:, i : i + chunk]
        y = labels[:, i : i + chunk]
        m = mask[:, i : i + chunk]
        logits = softcap(head_dot(h, head_w.to(h.dtype)), cap)
        logits = policy.act(logits, kind="logits")
        logz = torch.logsumexp(logits, dim=-1)
        # on a mesh, vocab-sharded logits gather to a masked partial sum:
        # reduce it while it still has the gather's shape
        gold = policy.constrain(torch.gather(logits, -1, y[..., None]),
                                (policy.dp, None, None))[..., 0]
        part, c = ((logz - gold) * m).sum(), m.sum()
        nll = part if nll is None else nll + part
        cnt = c if cnt is None else cnt + c
    return nll / torch.clamp_min(cnt, 1.0)


def build_model(cfg, params: dict | None = None, *,
                policy: ShardingPolicy | None = None,
                generator: torch.Generator | None = None,
                device=None) -> Model:
    """The model on ``device`` (``cuda`` unless asked otherwise): with a
    copy of ``params`` (e.g. from :func:`params_from_jax`) or freshly
    initialised from ``generator``.  With a ``policy`` on a mesh the
    whole parameters (the same on every rank) are laid out by
    :meth:`ShardingPolicy.shard_params`, each rank keeping its shards; the
    policy's device must be ``device``."""
    device = resolve_device(device)
    policy = policy or ShardingPolicy()
    if params is None:
        params = init_params(cfg, generator=generator, device=device)
    else:
        # a copy: the model updates its parameters in place
        params = tree_util.tree_map(
            lambda t: t.detach().to(device, copy=True), params
        )
    if policy.mesh is not None:
        if resolve_device(policy.device).type != device.type:
            raise ValueError(f"the policy places on {policy.device or 'cuda'}"
                             f", the model is on {device}")
        params = policy.shard_params(params)
        return Model(cfg, params, policy)
    return Model(cfg, params).to(device)


# ---------------------------------------------------------------------------
# weights carried across from the JAX package
# ---------------------------------------------------------------------------


def _tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A tensor that owns a copy of ``a`` (the model updates its
    parameters in place and must never write into the caller's arrays)."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree_of_numpy: dict, cfg, device=None) -> dict:
    """The port's parameter tree from the reference's ``model.init`` tree
    (as numpy arrays).  Keys, shapes and dtypes must match this config."""
    device = resolve_device(device)
    want_leaves, want_def = tree_util.flatten(init_params(cfg, device="meta"))
    got_leaves, got_def = tree_util.flatten(tree_of_numpy)
    if got_def != want_def:
        raise ValueError(
            "parameter tree structure differs from the port's for "
            f"{cfg.name}"
        )
    out = []
    for w, a in zip(want_leaves, got_leaves):
        t = _tensor_from_numpy(np.asarray(a))
        if tuple(t.shape) != tuple(w.shape) or t.dtype != w.dtype:
            raise ValueError(
                f"leaf {tuple(t.shape)} {t.dtype} != expected "
                f"{tuple(w.shape)} {w.dtype}"
            )
        out.append(t.to(device))
    return tree_util.unflatten(want_def, out)


def params_to_numpy(params) -> dict:
    """Numpy tree of a parameter tree or a :class:`Model` (bf16 leaves come
    back as float32, which holds them exactly)."""
    if isinstance(params, Model):
        params = params.params()

    def to_np(t):
        t = t.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy().copy()

    return tree_util.tree_map(to_np, params)


# ---------------------------------------------------------------------------
# decode caches carried across from the JAX package
# ---------------------------------------------------------------------------


def _batch_rows(stack: dict) -> int:
    """The batch size of a cache's stack (any leaf but ``pos``)."""
    for sub in stack.values():
        for name, leaf in sub.items():
            if name != "pos":
                return leaf.shape[1]
    raise ValueError("a decode cache with no batch leaf")


def cache_from_jax(tree_of_numpy: dict, device=None) -> dict:
    """The port's decode cache from a reference decode cache (as numpy).

    Takes the reference's fixed-batch cache (``model.init_decode``: scalar
    ``index``, leaves (n_super, B, ...), ``pos`` (n_super, size) shared by
    the rows, ``enc_out`` (B, S_enc, D)) or its engine's slot-stacked cache
    (a leading slot axis over B=1 caches: ``index`` (slots,), leaves
    (slots, n_super, 1, ...), ``pos`` (slots, n_super, size), ``enc_out``
    (slots, 1, S_enc, D))."""
    device = resolve_device(device)
    index = np.asarray(tree_of_numpy["index"])
    fixed = index.ndim == 0
    stack = {
        name: {n: np.asarray(a) for n, a in sub.items()}
        for name, sub in tree_of_numpy["stack"].items()
    }
    rows = _batch_rows(stack) if fixed else None
    out = {}
    for name, sub in stack.items():
        leaves = {}
        for n, a in sub.items():
            if fixed and n == "pos":
                a = np.broadcast_to(a[:, None], (a.shape[0], rows, a.shape[1]))
            elif not fixed:
                a = np.swapaxes(a if n == "pos" else a[:, :, 0], 0, 1)
            leaves[n] = _tensor_from_numpy(a).to(device)
        out[name] = leaves
    if fixed:
        index = np.full((rows,), index)
    cache = {"index": _tensor_from_numpy(index.astype(np.int32)).to(device),
             "stack": out}
    if "enc_out" in tree_of_numpy:
        enc = np.asarray(tree_of_numpy["enc_out"])
        cache["enc_out"] = _tensor_from_numpy(enc if fixed else enc[:, 0]
                                              ).to(device)
    return cache


def cache_to_jax(cache: dict, *, slot_stacked: bool = False) -> dict:
    """Inverse of :func:`cache_from_jax` (numpy leaves; bf16 as float32).
    The fixed-batch form needs every row at the same index."""
    to_np = lambda t: params_to_numpy({"t": t})["t"]
    index = to_np(cache["index"])
    if not slot_stacked and not (index == index[0]).all():
        raise ValueError("the fixed-batch form needs one index for every "
                         "row")
    stack = {}
    for name, sub in cache["stack"].items():
        leaves = {}
        for n, t in sub.items():
            a = to_np(t)
            if slot_stacked:
                a = np.swapaxes(a, 0, 1)
                if n != "pos":
                    a = a[:, :, None]
            elif n == "pos":
                a = a[:, 0]
            leaves[n] = a
        stack[name] = leaves
    if not slot_stacked:
        index = index[0]
    out = {"index": index, "stack": stack}
    if "enc_out" in cache:
        enc = to_np(cache["enc_out"])
        out["enc_out"] = enc[:, None] if slot_stacked else enc
    return out
