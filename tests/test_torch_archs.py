"""Every decoder-only model family of the JAX package in the port, at
``reduced()`` in float32 on the CPU, against the reference with the same
(perturbed, ``tests/_torch_archs.py``) parameters and seeded numpy inputs:

* forward hidden states and the MoE aux loss, the loss with its ce and
  aux parts: rtol 1e-5 (XLA and torch add in other orders);
* gradients: rtol 1e-5, atol 1e-5 x max|g| (as the minicpm train test);
* the reference's ``model.init`` tree through ``params_from_jax``;
* gemma2's sliding window, M-RoPE with three distinct position streams
  (qwen2-vl's embeds input), ``param_count`` of all nine archs at full
  size, the tanh-form gelu, RWKV's group norm with its bf16 round trip.

Cached decode is in ``test_torch_archs_decode.py``, the train step in
``test_torch_archs_train.py``.
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

from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduced as j_reduced
from repro.models import build_model as j_build
from repro.models import layers as jlayers
from repro.models import rwkv as jrwkv
from repro_torch import tree
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import params_from_jax, params_to_numpy
from repro_torch.models import layers
from repro_torch.models import rwkv as trwkv
from repro_torch.models.model import _final_hidden

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_archs import (  # noqa: E402
    NEW_ARCHS, exact_group_norm, make_batch, make_pair, torch_batch,
)

TOL = dict(rtol=1e-5, atol=1e-5)
# the packages' own _group_norm (bf16 round trip included)
J_GROUP_NORM, T_GROUP_NORM = jrwkv._group_norm, trwkv._group_norm
B, S = 2, 40          # S past the reduced gemma2 window (32)


@pytest.fixture(scope="module", params=NEW_ARCHS)
def pair(request):
    mp = pytest.MonkeyPatch()
    if request.param.startswith("rwkv6"):
        exact_group_norm(mp)
    yield make_pair(request.param)
    mp.undo()


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def test_forward_hidden_aux_and_loss(pair):
    batch = make_batch(pair.cfg, B, S)
    jh, jaux = jax.jit(pair.jmodel.apply)(pair.jparams, batch)
    jloss, jm = jax.jit(pair.jmodel.loss)(pair.jparams, batch)
    with torch.no_grad():
        th, taux = _final_hidden(pair.model.params(), torch_batch(batch),
                                 pair.cfg)
        tloss, tm = pair.model(torch_batch(batch))
    _close(th, jh)
    if pair.cfg.moe is not None:
        assert float(jaux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-12)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def test_gradients(pair):
    batch = make_batch(pair.cfg, B, S, seed=2)
    jgrads = jax.jit(jax.grad(lambda p: pair.jmodel.loss(p, batch)[0]))(
        pair.jparams)
    loss, _ = pair.model(torch_batch(batch))
    leaves = pair.model.leaves()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(leaves)
    for p, g, jg in zip(leaves, grads, jleaves):
        jg = np.asarray(jg)
        g = torch.zeros_like(p) if g is None else g
        assert tuple(g.shape) == jg.shape
        np.testing.assert_allclose(
            g.numpy(), jg, rtol=1e-5,
            atol=1e-5 * max(float(np.abs(jg).max()), 1e-30),
        )


# ---------------------------------------------------------------------------
# single features
# ---------------------------------------------------------------------------


def test_gemma2_window_masks_differ():
    """The local sublayer attends differently from the global one at long
    range (the reference's test_gemma2_window_masks_differ on the port),
    and the hidden states equal the reference's with the window biting."""
    p = make_pair("gemma2-27b", sliding_window=4)
    tok = np.random.default_rng(1).integers(0, p.cfg.vocab_size, (1, 12))
    tok2 = tok.copy()
    tok2[:, :4] = 0
    hs = []
    for t in (tok, tok2):
        with torch.no_grad():
            h, _ = _final_hidden(p.model.params(),
                                 {"tokens": torch.from_numpy(t)}, p.cfg)
        jh, _ = p.jmodel.apply(p.jparams, {"tokens": jnp.asarray(t)})
        _close(h, jh)
        hs.append(h)
    assert not torch.allclose(hs[0][:, -1], hs[1][:, -1])


def test_mrope_three_streams_differ_from_text_positions():
    """qwen2-vl's M-RoPE: distinct (t, h, w) streams change the output
    (and the forward agrees with the reference for both, above)."""
    p = make_pair("qwen2-vl-2b")
    outs = []
    for streams in (True, False):
        batch = make_batch(p.cfg, B, 16, mrope_streams=streams)
        with torch.no_grad():
            h, _ = _final_hidden(p.model.params(), torch_batch(batch), p.cfg)
        jh, _ = p.jmodel.apply(p.jparams, batch)
        _close(h, jh)
        outs.append(h)
    assert not torch.allclose(outs[0], outs[1])


@pytest.mark.parametrize("positions_2d", [False, True])
def test_apply_rope_mrope_matches(positions_2d):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 50, (2, 7) if positions_2d else (3, 2, 7))
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4,
                              (4, 2, 2))
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4,
                            (4, 2, 2))
    _close(got, want)


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_reference_init_carries_across(name):
    """The JAX package's ``model.init`` tree goes through
    ``params_from_jax``: every key, shape and dtype, bit for bit both
    ways."""
    cfg = reduced(ARCHS[name])
    jmodel = j_build(j_reduced(J_ARCHS[name]))
    rng = np.random.default_rng(0)
    np_tree = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype),
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))
    back = params_to_numpy(params_from_jax(np_tree, cfg, "cpu"))
    for a, b in zip(tree.leaves(back), jax.tree.leaves(np_tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(J_ARCHS))
def test_param_count_matches_reference(name):
    jcfg = J_ARCHS[name]
    cfg = ARCHS[name]
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.max_attention_window == jcfg.max_attention_window
    assert cfg.supports_long_context == jcfg.supports_long_context
    assert cfg.is_decoder_only == jcfg.is_decoder_only


def test_port_registers_the_nine_decoder_only_archs():
    """The nine decoder-only archs, and whisper-tiny beside them: every
    arch of the reference."""
    assert sorted(n for n, c in ARCHS.items() if c.is_decoder_only) == sorted(
        n for n, c in J_ARCHS.items() if not c.encoder_layers)
    assert sorted(ARCHS) == sorted(J_ARCHS)


def test_gelu_is_the_tanh_form():
    """The reference's ``jax.nn.gelu`` is the tanh form; the port's
    ``glu_mlp(act="gelu")`` agrees at rtol 1e-6 (atol 1e-7).  Identity
    projections make the GLU ``gelu(x) * x`` with no sum to order, so only
    the activation is compared; inputs in quarters over [-2, 3] (further
    left the tanh form's ``1 + tanh`` cancels, and the two libraries'
    formulas part by 2.5e-5 of the value at -3)."""
    rng = np.random.default_rng(6)
    x = (rng.integers(-8, 13, (3, 5, 16)) / 4).astype(np.float32)
    w = {name: np.eye(16, dtype=np.float32)
         for name in ("w_gate", "w_up", "w_down")}
    want = jlayers.glu_mlp({k: jnp.asarray(v) for k, v in w.items()},
                           jnp.asarray(x), act="gelu")
    got = layers.glu_mlp({k: torch.from_numpy(v) for k, v in w.items()},
                         torch.from_numpy(x), act="gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    # the exact (erf) form misses by up to 4e-4 of a value
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    assert not np.allclose(exact.numpy(), np.asarray(jax.nn.gelu(
        jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    xs = np.linspace(-2, 3, 11).astype(np.float32)
    np.testing.assert_allclose(
        layers._ACTS["gelu"](torch.from_numpy(xs)).numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(xs))), rtol=1e-6, atol=1e-7)


def test_rwkv_group_norm_matches():
    """The two ``_group_norm``s, bf16 round trip included, on the same
    float32 inputs: equal, or (where the float32 values straddle a bf16
    rounding boundary) one bf16 step apart, on a few elements at most."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 9, 64)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    want = np.asarray(J_GROUP_NORM(jnp.asarray(x), jnp.asarray(scale),
                                   4, 16))
    got = T_GROUP_NORM(torch.from_numpy(x), torch.from_numpy(scale),
                       4, 16).numpy()
    diff = got != want
    assert diff.sum() <= 3
    np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=0)


def test_rwkv_forward_with_bf16_rounding(monkeypatch):
    monkeypatch.setattr(jrwkv, "_group_norm", J_GROUP_NORM)
    monkeypatch.setattr(trwkv, "_group_norm", T_GROUP_NORM)
    p = make_pair("rwkv6-1.6b")
    batch = make_batch(p.cfg, B, S)
    jh, _ = jax.jit(p.jmodel.apply)(p.jparams, batch)
    with torch.no_grad():
        th, _ = _final_hidden(p.model.params(), torch_batch(batch), p.cfg)
    _close(th, jh, rtol=2e-3, atol=2e-3)


