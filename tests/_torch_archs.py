"""Shared set-up of the model-family parity tests: a reduced architecture
built in the JAX package and in the port from the same parameters, and
seeded numpy batches.

The parameters are the port's seeded ``init_params`` as numpy, given to
both sides (the JAX package's ``model.init`` costs seconds to compile per
arch; that its tree carries across through ``params_from_jax`` is tested
once per arch, ``test_torch_archs.py``).

RWKV6's time-mix rounds its group-norm output through bf16 (reference
``rwkv.py:_group_norm``), even in float32: a float32 difference of one ulp
before it can move a value by a whole bf16 step (2^-8 of itself), which
then reaches every later value.  So the 1e-5 comparisons of rwkv6 run with
that round trip taken out of both packages (:func:`exact_group_norm`);
``test_torch_archs.py`` holds the two ``_group_norm``s to each other on
the same inputs and the unpatched forward at 2e-3.

Every leaf that the reference initialises to a constant (zero norms and
QKV biases, ``mu`` = 0.5, the decay bias, the Mamba ``D`` and ``conv_b``,
``ln_x_scale``; and ``A_log``, whose rows are equal) is perturbed with
seeded noise before either side sees it, so a missing bias or a wrong norm
offset cannot pass by multiplying a constant.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import build_model as j_build
from repro.models import rwkv as jrwkv
from repro_torch.configs import get_config, reduced
from repro_torch.models import (
    build_model, init_params, params_from_jax, params_to_numpy,
)
from repro_torch.models import rwkv as trwkv

NEW_ARCHS = (
    "gemma2-27b", "qwen2-72b", "granite-20b", "jamba-1.5-large-398b",
    "qwen2-vl-2b", "moonshot-v1-16b-a3b", "deepseek-moe-16b", "rwkv6-1.6b",
)


def _j_group_norm_exact(x, scale, H, hd, eps=1e-5):
    shape = x.shape
    x = x.reshape(*shape[:-1], H, hd).astype(jnp.float32)
    mu = x.mean(-1, keepdims=True)
    var = x.var(-1, keepdims=True)
    return ((x - mu) * jax.lax.rsqrt(var + eps)).reshape(shape) * scale


def _t_group_norm_exact(x, scale, H, hd, eps=1e-5):
    shape = x.shape
    x = x.reshape(*shape[:-1], H, hd).to(torch.float32)
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return ((x - mu) * torch.rsqrt(var + eps)).reshape(shape) * scale


def exact_group_norm(monkeypatch) -> None:
    """Both packages' RWKV ``_group_norm`` without the bf16 round trip."""
    monkeypatch.setattr(jrwkv, "_group_norm", _j_group_norm_exact)
    monkeypatch.setattr(trwkv, "_group_norm", _t_group_norm_exact)


def perturbed(params, seed: int = 0):
    """``params`` (numpy tree) with every constant leaf given noise."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree.flatten(params)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    out = []
    for path, a in zip(paths, leaves):
        a = np.asarray(a)
        if np.all(a == a.flat[0]) or "A_log" in path:
            a = (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        out.append(a)
    return jax.tree.unflatten(treedef, out)


@dataclasses.dataclass
class Pair:
    jcfg: object
    jmodel: object
    jparams: dict      # jnp arrays
    cfg: object
    model: object      # the port's Model on the CPU
    np_params: dict


def make_pair(name: str, seed: int = 0, **changes) -> Pair:
    """The reduced ``name`` (float32) on both sides, same parameters."""
    jcfg = dataclasses.replace(j_reduced(j_get_config(name)), **changes)
    cfg = dataclasses.replace(reduced(get_config(name)), **changes)
    jmodel = j_build(jcfg)
    np_params = perturbed(params_to_numpy(init_params(
        cfg, generator=torch.Generator().manual_seed(seed), device="cpu")),
        seed)
    model = build_model(cfg, params_from_jax(np_params, cfg, "cpu"),
                        device="cpu")
    return Pair(jcfg, jmodel, jax.tree.map(jnp.asarray, np_params), cfg,
                model, np_params)


def make_batch(cfg, B: int, S: int, seed: int = 1, *,
               mrope_streams: bool = True, frames: int = 12) -> dict:
    """A numpy batch: ``tokens``, or for the VLM stub ``embeds``, ``labels``
    and (3, B, S) positions (three distinct streams unless
    ``mrope_streams`` is false: then text positions); an encoder-decoder
    also gets ``frames`` (B, frames, D)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend != "vision_patches":
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)}
        if cfg.encoder_layers:
            batch["frames"] = (rng.standard_normal(
                (B, frames, cfg.d_model)) * 0.5).astype(np.float32)
        return batch
    t = np.arange(S)
    streams = (t, t // 2, t % 5) if mrope_streams else (t, t, t)
    return {
        "embeds": (rng.standard_normal((B, S, cfg.d_model)) * 0.5).astype(
            np.float32),
        "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "positions": np.broadcast_to(
            np.stack(streams)[:, None], (3, B, S)).astype(np.int32).copy(),
    }


def torch_batch(batch: dict) -> dict:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.long() if v.dtype == np.int32 and k != "positions" else t
    return out


def rank_rows(batch: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s rows of a global batch: rows ``[rank * b, (rank + 1)
    * b)`` of every leaf, ``b = B / world`` -- the rows the reference's
    ``P(topo.axes, None)`` batch spec gives chip ``node * ppn + lane``
    (``frames`` too), which a rank's ``make_dp_train_step`` step takes."""
    out = {}
    for k, x in batch.items():
        if x.shape[0] % world:
            raise ValueError(f"batch leaf {k!r} of {x.shape[0]} rows does "
                             f"not split over {world} ranks")
        b = x.shape[0] // world
        out[k] = x[rank * b : (rank + 1) * b]
    return out


def decode_input(batch: dict, t: int):
    """The step-``t`` decode input: (B, 1) tokens or (B, 1, D) embeds."""
    if "embeds" in batch:
        return batch["embeds"][:, t : t + 1]
    return batch["tokens"][:, t : t + 1]
