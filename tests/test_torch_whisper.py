"""The encoder-decoder family (whisper-tiny) in the port against the JAX
package, at ``reduced()`` in float32 on the CPU (2 encoder + 2 decoder
layers, frames of 12, B 2, S 16), with the same (perturbed,
``tests/_torch_archs.py``) parameters on both sides and seeded numpy
inputs:

* the config, ``param_count`` (its encoder and cross-attention terms as
  the reference reckons them) and ``reduced`` equal to the reference's;
  the reference's ``model.init`` tree through ``params_from_jax``;
* forward hidden states and the loss at rtol 1e-5, gradients at rtol
  1e-5 (atol 1e-5 x max|g|);
* cross-attention (``attention_full(kv_src=)``, keys longer and shorter
  than the queries, chunked queries) and the encoder's non-causal
  self-attention at 1e-5; ``attention_decode(kv_src=)`` leaves its cache
  untouched;
* step-by-step decode (logits and every cache leaf, ``enc_out`` included,
  through ``cache_to_jax`` / ``cache_from_jax``) at 1e-5, and decode
  against the port's own full forward at 2e-3;
* remat none / full / dots: loss and gradients bitwise equal (the
  encoder under remat too);
* ``make_train_step`` at ``n_micro`` 2 and two int4+EF
  ``make_dp_train_step`` steps at 1x1 against the reference's, on batches
  that carry frames (the tolerances of ``test_torch_train_driver.py`` and
  ``test_torch_archs_train.py``); ``rank_rows`` and the microbatches
  split frames by rows; the prefill step takes frames;
* ``build_training`` cannot train an encoder-decoder: the reference fails
  with ``KeyError: 'frames'`` at its first step, the port refuses it up
  front.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.configs.base import OptimizerConfig as JOpt
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import comm as jcomm
from repro.launch.mesh import make_mesh
from repro.launch.steps import make_dp_train_step as j_make_dp_step
from repro.launch.steps import make_prefill_step as j_make_prefill_step
from repro.launch.steps import make_train_step as j_make_train_step
from repro.launch.train import build_training as j_build_training
from repro.models import ShardingPolicy as JPolicy
from repro.models import attention as jattn
from repro.models import build_model as j_build
from repro.optim import adamw_init as j_adamw_init
from repro.optim import ef_init as j_ef_init
from repro_torch import tree
from repro_torch.configs import (
    ARCHS, OptimizerConfig, TrainConfig, WHISPER_TINY, get_config, reduced,
)
from repro_torch.core import CommPolicy
from repro_torch.data import SyntheticLM
from repro_torch.launch import (
    build_training, init_train_state, make_dp_train_step, make_prefill_step,
    make_train_step, mesh_topology,
)
from repro_torch.launch.steps import _microbatches
from repro_torch.models import (
    build_model, cache_from_jax, cache_to_jax, params_from_jax,
    params_to_numpy,
)
from repro_torch.models import attention as tattn
from repro_torch.models.model import _final_hidden
from repro_torch.optim import adamw_init

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_archs import (  # noqa: E402
    make_batch, make_pair, rank_rows, torch_batch,
)

NAME = "whisper-tiny"
TOL = dict(rtol=1e-5, atol=1e-5)
B, S, FRAMES = 2, 16, 12
SEQ, BATCH = 16, 4
OPT = dict(lr=1e-3, schedule="constant", warmup_steps=1)


@pytest.fixture(scope="module")
def pair():
    return make_pair(NAME)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _train_batch(cfg, step: int) -> dict:
    """SyntheticLM's batch ``step`` (tokens, labels, loss mask) plus
    seeded frames, as numpy."""
    batch = SyntheticLM(cfg.vocab_size, SEQ, BATCH,
                        seed=0).global_batch_numpy(step)
    batch["frames"] = (np.random.default_rng(100 + step).standard_normal(
        (BATCH, FRAMES, cfg.d_model)) * 0.5).astype(np.float32)
    return batch


def _to_torch(batch: dict) -> dict:
    return SyntheticLM.to_device(batch, "cpu")


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


def test_config_param_count_and_reduced_match_reference():
    jcfg = j_get_config(NAME)
    cfg = get_config(NAME)
    assert cfg is WHISPER_TINY and NAME in ARCHS
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert not cfg.is_decoder_only and jcfg.is_decoder_only is False
    assert cfg.param_count() == jcfg.param_count() == 41_155_968
    assert cfg.active_param_count() == jcfg.active_param_count()
    small, jsmall = reduced(cfg), j_reduced(jcfg)
    assert dataclasses.asdict(small) == dataclasses.asdict(jsmall)
    assert (small.encoder_layers, small.num_layers) == (2, 2)
    assert small.param_count() == jsmall.param_count()


def test_param_count_leaves_out_the_norms_as_the_reference_does(pair):
    """The reckoning counts no final, encoder or cross-attention norm,
    as the reference's; the leaves have them."""
    cfg = pair.cfg
    leaves = sum(p.numel() for p in pair.model.leaves())
    norms = cfg.d_model * (2 + cfg.num_layers)  # final, encoder, cross
    assert leaves == cfg.param_count() + norms


def test_reference_init_carries_across(pair):
    """The JAX package's ``model.init`` tree (encoder, ``encoder_norm``,
    ``norm_cross``, ``cross``) goes through ``params_from_jax``: every key,
    shape and dtype, bit for bit both ways."""
    rng = np.random.default_rng(0)
    np_tree = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype),
        jax.eval_shape(pair.jmodel.init, jax.random.PRNGKey(0)))
    assert {"encoder", "encoder_norm"} <= set(np_tree)
    assert {"norm_cross", "cross"} <= set(np_tree["stack"]["sub0"])
    assert "b_q" not in np_tree["stack"]["sub0"]["cross"]
    back = params_to_numpy(params_from_jax(np_tree, pair.cfg, "cpu"))
    assert tree.flatten(back)[1] == tree.flatten(
        jax.tree.map(np.asarray, np_tree))[1]
    for a, b in zip(tree.leaves(back), jax.tree.leaves(np_tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# forward, loss, gradients
# ---------------------------------------------------------------------------


def test_forward_and_loss(pair):
    batch = make_batch(pair.cfg, B, S, frames=FRAMES)
    jh, _ = jax.jit(pair.jmodel.apply)(pair.jparams, batch)
    jloss, jm = jax.jit(pair.jmodel.loss)(pair.jparams, batch)
    with torch.no_grad():
        th, _ = _final_hidden(pair.model.params(), torch_batch(batch),
                              pair.cfg)
        tloss, tm = pair.model(torch_batch(batch))
    _close(th, jh)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=1e-5)
    # the frames matter: other frames, other hidden states
    other = dict(batch, frames=batch["frames"][::-1].copy())
    with torch.no_grad():
        th2, _ = _final_hidden(pair.model.params(), torch_batch(other),
                               pair.cfg)
    assert not torch.allclose(th, th2)


def test_gradients(pair):
    batch = make_batch(pair.cfg, B, S, seed=2, frames=FRAMES)
    jgrads = jax.jit(jax.grad(lambda p: pair.jmodel.loss(p, batch)[0]))(
        pair.jparams)
    loss, _ = pair.model(torch_batch(batch))
    leaves = pair.model.leaves()
    grads = torch.autograd.grad(loss, leaves)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(leaves)
    for g, jg in zip(grads, jleaves):
        jg = np.asarray(jg)
        assert tuple(g.shape) == jg.shape
        assert float(np.abs(jg).max()) > 0
        np.testing.assert_allclose(
            g.numpy(), jg, rtol=1e-5,
            atol=1e-5 * max(float(np.abs(jg).max()), 1e-30))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _attn_params(cfg, jcfg, *, cross):
    jp = jattn.init_attention(jax.random.PRNGKey(3), jcfg, jnp.float32,
                              cross=cross)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


@pytest.mark.parametrize("sk,q_chunk", [(12, 1024), (40, 4), (5, 8),
                                        (12, 5)])
def test_cross_attention_full_matches_reference(pair, sk, q_chunk):
    """Keys longer and shorter than the queries, no RoPE, none masked;
    queries chunked (4, 8) or whole (5 does not divide 16)."""
    cfg, jcfg = pair.cfg, pair.jcfg
    jp, tp = _attn_params(cfg, jcfg, cross=True)
    assert "b_q" not in jp
    rng = np.random.default_rng(sk)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((B, sk, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    want = jattn.attention_full(jp, jnp.asarray(x), cfg=jcfg,
                                policy=JPolicy(), positions=jnp.asarray(pos),
                                causal=False, kv_src=jnp.asarray(src),
                                q_chunk=q_chunk)
    got = tattn.attention_full(tp, torch.from_numpy(x), cfg=cfg,
                               positions=torch.from_numpy(pos),
                               causal=False, kv_src=torch.from_numpy(src),
                               q_chunk=q_chunk)
    _close(got, want)
    # no RoPE: the query positions do not matter
    moved = tattn.attention_full(tp, torch.from_numpy(x), cfg=cfg,
                                 positions=torch.from_numpy(pos) + 7,
                                 causal=False, kv_src=torch.from_numpy(src),
                                 q_chunk=q_chunk)
    assert torch.equal(moved, got)


def test_cross_attention_bias_only_on_self_attention():
    cfg = dataclasses.replace(reduced(WHISPER_TINY), qkv_bias=True)
    gen = torch.Generator().manual_seed(0)
    own = tattn.init_attention(cfg, torch.float32, generator=gen,
                               device="cpu")
    cross = tattn.init_attention(cfg, torch.float32, generator=gen,
                                 device="cpu", cross=True)
    assert "b_q" in own and not {"b_q", "b_k", "b_v"} & set(cross)


def test_encoder_self_attention_is_not_causal_and_uses_rope(pair):
    cfg, jcfg = pair.cfg, pair.jcfg
    jp, tp = _attn_params(cfg, jcfg, cross=False)
    x = np.random.default_rng(4).standard_normal(
        (B, FRAMES, cfg.d_model)).astype(np.float32)
    pos = np.arange(FRAMES)[None].astype(np.int32)
    want = jattn.attention_full(jp, jnp.asarray(x), cfg=jcfg,
                                policy=JPolicy(), positions=jnp.asarray(pos),
                                causal=False, q_chunk=4)
    got = tattn.attention_full(tp, torch.from_numpy(x), cfg=cfg,
                               positions=torch.from_numpy(pos),
                               causal=False, q_chunk=4)
    _close(got, want)
    causal = tattn.attention_full(tp, torch.from_numpy(x), cfg=cfg,
                                  positions=torch.from_numpy(pos))
    # the first query sees every frame, not the first one only
    assert not torch.allclose(causal[:, 0], got[:, 0])
    assert torch.allclose(causal[:, -1], got[:, -1], atol=1e-6)


def test_cross_attention_decode_leaves_the_cache(pair):
    cfg, jcfg = pair.cfg, pair.jcfg
    jp, tp = _attn_params(cfg, jcfg, cross=True)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((B, FRAMES, cfg.d_model)).astype(np.float32)
    index = 3
    want, jc = jattn.attention_decode(
        jp, jnp.asarray(x), {}, jnp.asarray(index, jnp.int32), cfg=jcfg,
        policy=JPolicy(), kv_src=jnp.asarray(src))
    assert jc == {}
    cache = tattn.init_cache(cfg, B, 8, window=None, dtype=torch.float32,
                             device="cpu")
    before = {k: v.clone() for k, v in cache.items()}
    got, back = tattn.attention_decode(
        tp, torch.from_numpy(x), cache, torch.full((B,), index,
                                                   dtype=torch.int32),
        cfg=cfg, kv_src=torch.from_numpy(src))
    _close(got, want)
    assert back is cache
    assert all(torch.equal(cache[k], before[k]) for k in cache)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _assert_cache_close(port_cache, ref_cache):
    got = cache_to_jax(port_cache)
    want = jax.tree.map(np.asarray, ref_cache)
    g_leaves, g_def = tree.flatten(got)
    w_leaves, w_def = tree.flatten(want)
    assert g_def == w_def
    for g, w in zip(g_leaves, w_leaves):
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            _close(g, w)


def test_decode_matches_reference_step_by_step(pair):
    batch = make_batch(pair.cfg, B, S, seed=3, frames=FRAMES)
    jstep = jax.jit(pair.jmodel.decode_step)
    jcache = pair.jmodel.init_decode(pair.jparams, B, S,
                                     batch={"frames": batch["frames"]})
    tb = torch_batch(batch)
    cache = pair.model.init_decode(B, S, batch={"frames": tb["frames"]})
    assert cache["enc_out"].shape == (B, FRAMES, pair.cfg.d_model)
    _assert_cache_close(cache, jcache)
    for t in range(S):
        jl, jcache = jstep(pair.jparams, jcache, batch["tokens"][:, t:t + 1])
        tl, cache = pair.model.decode_step(cache, tb["tokens"][:, t:t + 1])
        _close(tl, jl)
        _assert_cache_close(cache, jcache)
    # the reference's cache carried across goes on decoding alike
    carried = cache_from_jax(jax.tree.map(np.asarray, jcache), "cpu")
    _close(carried["enc_out"], cache["enc_out"])
    tok = torch.ones((B, 1), dtype=torch.long)
    a, _ = pair.model.decode_step(carried, tok)
    b, _ = pair.model.decode_step(cache, tok)
    _close(a, b)


def test_slot_stacked_cache_carries_enc_out(pair):
    """The reference engine's slot-stacked form: ``enc_out`` (slots, 1,
    S_enc, D) becomes the port's (slots, S_enc, D), and back."""
    frames = np.random.default_rng(6).standard_normal(
        (1, FRAMES, pair.cfg.d_model)).astype(np.float32)
    b1 = pair.jmodel.init_decode(pair.jparams, 1, 8,
                                 batch={"frames": jnp.asarray(frames)})
    slots = jax.tree.map(lambda x: np.stack([np.asarray(x)] * 3), b1)
    cache = cache_from_jax(slots, "cpu")
    assert cache["enc_out"].shape == (3, FRAMES, pair.cfg.d_model)
    _close(cache["enc_out"][1], np.asarray(b1["enc_out"])[0])
    back = cache_to_jax(cache, slot_stacked=True)
    assert back["enc_out"].shape == slots["enc_out"].shape
    np.testing.assert_array_equal(back["enc_out"], slots["enc_out"])


def test_decode_matches_full_forward(pair):
    batch = make_batch(pair.cfg, B, S, seed=4, frames=FRAMES)
    tb = torch_batch(batch)
    full = pair.model.logits(tb)
    cache = pair.model.init_decode(B, S, batch=tb)
    outs = []
    for t in range(S):
        logits, cache = pair.model.decode_step(cache, tb["tokens"][:, t:t + 1])
        outs.append(logits[:, 0])
    _close(torch.stack(outs, dim=1), full, rtol=2e-3, atol=2e-3)


def test_init_decode_needs_frames(pair):
    with pytest.raises(AssertionError, match="frames"):
        pair.jmodel.init_decode(pair.jparams, B, S)
    with pytest.raises(ValueError, match="frames"):
        pair.model.init_decode(B, S)
    with pytest.raises(ValueError, match="frames"):
        pair.model.init_decode(B, S, batch={"tokens": torch.zeros(B, S)})


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_changes_no_value(pair, remat):
    batch = torch_batch(make_batch(pair.cfg, B, S, seed=7, frames=FRAMES))
    runs = {}
    for mode in ("none", remat):
        cfg = dataclasses.replace(pair.cfg, remat=mode)
        model = build_model(cfg, params_from_jax(pair.np_params, cfg, "cpu"),
                            device="cpu")
        loss, _ = model(batch)
        runs[mode] = (loss, torch.autograd.grad(loss, model.leaves()))
    (l0, g0), (l1, g1) = runs["none"], runs[remat]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_make_train_step_n_micro_2_matches_reference(pair):
    jopt = JOpt(**OPT)
    jstep = jax.jit(j_make_train_step(pair.jmodel, jopt, n_micro=2))
    jstate = {"params": pair.jparams, "opt": j_adamw_init(pair.jparams)}
    model = build_model(pair.cfg, params_from_jax(pair.np_params, pair.cfg,
                                                  "cpu"), device="cpu")
    step = make_train_step(model, OptimizerConfig(**OPT), n_micro=2,
                           device="cpu")
    state = {"model": model, "opt": adamw_init(model.params())}
    jlosses, losses = [], []
    for s in range(2):
        batch = _train_batch(pair.cfg, s)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, _to_torch(batch))
        jlosses.append(float(jm["loss"]))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    got = tree.leaves(params_to_numpy(state["model"]))
    for p, jp in zip(got, jax.tree.leaves(jstate["params"])):
        np.testing.assert_allclose(p, np.asarray(jp), rtol=1e-4, atol=1e-5)


def test_dp_train_step_int4_ef_matches_reference(pair):
    """Two int4+EF steps at 1x1, the encoder's and the cross-attention's
    leaves in the bucket plan; losses and parameters as in
    ``test_torch_archs_train.py``."""
    jopt = JOpt(**OPT)
    jpol = jcomm.CommPolicy(algorithm="nap", mean=True, compress_bits=4,
                            error_feedback=True)
    mesh = make_mesh((1, 1), ("pod", "data"))
    jstep = jax.jit(j_make_dp_step(pair.jcfg, jopt, mesh, jpol))
    jstate = jax.device_put(
        {"params": pair.jparams, "opt": j_adamw_init(pair.jparams),
         "ef": j_ef_init(pair.jparams, group=1)}, NamedSharding(mesh, P()))
    opt = OptimizerConfig(**OPT)
    pol = CommPolicy(algorithm="nap", mean=True, compress_bits=4,
                     error_feedback=True)
    topo = mesh_topology(1, 1)
    step = make_dp_train_step(pair.cfg, opt, topo, pol, device="cpu")
    n_leaves = len(pair.model.leaves())
    assert sum(len(b.leaves) for b in step.plan.buckets) == n_leaves
    state = init_train_state(pair.cfg, opt, pol, device="cpu",
                             params=params_from_jax(pair.np_params, pair.cfg,
                                                    "cpu"))
    jlosses, losses = [], []
    for s in range(2):
        batch = _train_batch(pair.cfg, s)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, rank_rows(_to_torch(batch), 0, 1))
        jlosses.append(float(jm["loss"]))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-5)
    got = tree.leaves(params_to_numpy(state["model"]))
    ef = [e.numpy() for e in tree.leaves(state["ef"])]
    for a, ja, e, je in zip(got, jax.tree.leaves(jstate["params"]), ef,
                            jax.tree.leaves(jstate["ef"])):
        ja, je = np.asarray(ja), np.asarray(je)[0]
        bad = ~np.isclose(a, ja, rtol=1e-4, atol=1e-5)
        flipped = ~np.isclose(e, je, rtol=1e-4, atol=1e-5 * max(
            1.0, float(np.abs(je).max())))
        # an element on an int4 rounding boundary may go over the wire one
        # quantization step apart on the two sides (its residual shows
        # it); only there may the parameter differ, by Adam's step at most
        assert not (bad & ~flipped).any()
        assert flipped.sum() <= max(1, flipped.size // 1000)
        assert np.abs(a - ja).max() <= 2 * 2 * opt.lr


def test_frames_split_by_rows():
    """``rank_rows`` and the microbatches take each row's frames with its
    tokens (the reference's ``P(topo.axes, None)`` / ``reshape((n_micro,
    -1) + shape[1:])``)."""
    cfg = reduced(WHISPER_TINY)
    batch = _to_torch(_train_batch(cfg, 0))
    for rank in range(4):
        part = rank_rows(batch, rank, 4)
        assert torch.equal(part["frames"], batch["frames"][rank:rank + 1])
        assert torch.equal(part["tokens"], batch["tokens"][rank:rank + 1])
    mbs = _microbatches(batch, 2)
    assert torch.equal(mbs[1]["frames"], batch["frames"][2:4])
    assert torch.equal(mbs[1]["tokens"], batch["tokens"][2:4])
    with pytest.raises(ValueError, match="ranks"):
        rank_rows(batch, 0, 3)


def test_prefill_step_takes_frames(pair):
    batch = make_batch(pair.cfg, B, S, seed=8, frames=FRAMES)
    want = jax.jit(j_make_prefill_step(pair.jmodel, tail=4))(pair.jparams,
                                                              batch)
    got = make_prefill_step(pair.model, tail=4, device="cpu")(
        torch_batch(batch))
    _close(got, want)


def _tiny_train_cfg():
    return dict(steps=1, seq_len=16, global_batch=2, checkpoint_every=0)


def test_reference_build_training_cannot_train_whisper(tmp_path):
    """The reference's ``SyntheticLM`` yields no frames and its loss reads
    ``batch["frames"]``: its first step fails (a reference property)."""
    jcfg = j_reduced(j_get_config(NAME))
    loop = j_build_training(jcfg, JTrainConfig(**_tiny_train_cfg()),
                            ckpt_dir=tmp_path)
    with pytest.raises(KeyError, match="frames"):
        loop.run(1)


def test_port_build_training_refuses_whisper(tmp_path):
    cfg = reduced(WHISPER_TINY)
    with pytest.raises(ValueError, match="frames"):
        build_training(cfg, TrainConfig(**_tiny_train_cfg()),
                       ckpt_dir=tmp_path, device="cpu")
