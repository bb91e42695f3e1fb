"""The port's cached decode against the JAX package's, at
``reduced(minicpm-2b)`` in float32 with the reference's parameters
(``params_from_jax``) and its caches converted by ``cache_from_jax`` /
``cache_to_jax``.

* B = 1 prefill of three prompts of different lengths, then 8 decode
  steps of the three rows together, each row at its own index (the
  reference vmaps its B=1 step over a slot-stacked cache, as its engine
  does): logits within rtol / atol 1e-5 at every step, every cache leaf
  within 1e-5 (positions and indices exactly); ``decode_hidden`` too; with
  and without logit softcaps;
* one attention sublayer's ring buffer past its size with a window;
* ``Model.logits`` and ``make_prefill_step`` within 1e-5;
* the engine's B = 1 prefill bitwise equal to a plain prefill of the same
  prompt (the reference pads to the bucket; the port does not need to),
  and within 1e-5 of the reference's padded prefill.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs import reduced as jreduced
from repro.launch.steps import make_prefill_step as j_make_prefill_step
from repro.models import ShardingPolicy
from repro.models import attention as jattn
from repro.models import build_model as j_build
from repro.serve import PromptBuckets as JBuckets
from repro.serve import ServeEngine as JEngine
from repro_torch import tree
from repro_torch.configs import MINICPM_2B, reduced
from repro_torch.launch import make_prefill_step
from repro_torch.models import (
    build_model, cache_from_jax, cache_to_jax, params_from_jax,
)
from repro_torch.models import attention as attn
from repro_torch.serve import PromptBuckets, ServeEngine

TOL = dict(rtol=1e-5, atol=1e-5)
SOFTCAPS = {"plain": (None, None), "softcap": (8.0, 2.0)}


def _pair(attn_cap=None, final_cap=None):
    jcfg = dataclasses.replace(jreduced(get_config("minicpm-2b")),
                               attn_logit_softcap=attn_cap,
                               final_logit_softcap=final_cap)
    jmodel = j_build(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(reduced(MINICPM_2B),
                              attn_logit_softcap=attn_cap,
                              final_logit_softcap=final_cap)
    model = build_model(
        cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu"),
        device="cpu",
    )
    return jmodel, jparams, model


@pytest.fixture(scope="module", params=sorted(SOFTCAPS))
def pair(request):
    return _pair(*SOFTCAPS[request.param])


def _assert_caches_close(port_cache, ref_cache, *, slot_stacked):
    got = cache_to_jax(port_cache, slot_stacked=slot_stacked)
    want = jax.tree.map(np.asarray, ref_cache)
    g_leaves, g_def = tree.flatten(got)
    w_leaves, w_def = tree.flatten(want)
    assert g_def == w_def
    for g, w in zip(g_leaves, w_leaves):
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, **TOL)


def test_decode_rows_at_unequal_indices_match(pair):
    jmodel, jparams, model = pair
    V, L = model.cfg.vocab_size, 24
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, V, n).astype(np.int32) for n in (2, 5, 3)]
    jstep = jax.jit(jmodel.decode_step)

    # B = 1 prefill on both sides
    j_rows, t_rows, j_last = [], [], []
    for p in prompts:
        jc, tc = jmodel.init_decode(jparams, 1, L), model.init_decode(1, L)
        for tok in p:
            jl, jc = jstep(jparams, jc, jnp.asarray([[tok]]))
            tl, tc = model.decode_step(tc, torch.tensor([[int(tok)]]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_caches_close(tc, jc, slot_stacked=False)
        j_rows.append(jc)
        t_rows.append(tc)
        j_last.append(np.asarray(jl))

    # stack the rows: the reference's slot-stacked cache, the port's B = 3
    jcache = jax.tree.map(lambda *xs: jnp.stack(xs), *j_rows)
    cache = cache_from_jax(jax.tree.map(np.asarray, jcache), device="cpu")
    assert cache["index"].tolist() == [2, 5, 3]
    own = {"index": torch.cat([c["index"] for c in t_rows]),
           "stack": tree.tree_map(lambda *ts: torch.cat(ts, dim=1),
                                  *[c["stack"] for c in t_rows])}
    _assert_caches_close(own, jcache, slot_stacked=True)

    vstep = jax.jit(jax.vmap(
        lambda c, t: jmodel.decode_step(jparams, c, t[None]),
        in_axes=(0, 0)))
    vhidden = jax.jit(jax.vmap(
        lambda c, t: jmodel.decode_hidden(jparams, c, t[None]),
        in_axes=(0, 0)))
    tok = np.stack([np.argmax(l[0, -1]) for l in j_last])[:, None]
    for step in range(8):
        jt = jnp.asarray(tok.astype(np.int32))
        if step == 0:
            jh, _ = vhidden(jcache, jt)
            th, _ = model.decode_hidden(tree.tree_map(torch.clone, cache),
                                        torch.from_numpy(tok))
            np.testing.assert_allclose(th.numpy(), np.asarray(jh)[:, 0],
                                       **TOL)
        jl, jcache = vstep(jcache, jt)
        tl, cache = model.decode_step(cache, torch.from_numpy(tok))
        jl = np.asarray(jl)[:, 0]  # (3, 1, V)
        np.testing.assert_allclose(tl.numpy(), jl, **TOL)
        tok = np.argmax(jl[:, -1], axis=-1)[:, None]
    assert cache["index"].tolist() == [10, 13, 11]
    _assert_caches_close(cache, jcache, slot_stacked=True)


def test_ring_buffer_past_its_size_with_a_window():
    jmodel, jparams, model = _pair()
    cfg, jcfg = model.cfg, jmodel.cfg
    p = tree.tree_map(lambda t: t[0],
                      model.params()["stack"]["sub0"]["mixer"])
    jp = jax.tree.map(lambda t: t[0], jparams["stack"]["sub0"]["mixer"])
    B, window, max_len = 2, 4, 16
    jcache = jattn.init_cache(jcfg, B, max_len, window=window,
                              dtype=jnp.float32)
    cache = attn.init_cache(cfg, B, max_len, window=window,
                            dtype=torch.float32, device="cpu")
    assert cache["k"].shape == (B, cfg.num_kv_heads, window, 16)
    policy = ShardingPolicy()
    jdec = jax.jit(lambda c, x, i: jattn.attention_decode(
        jp, x, c, i, cfg=jcfg, policy=policy, window=window))
    rng = np.random.default_rng(3)
    for i in range(11):  # wraps the 4-slot ring twice
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        jy, jcache = jdec(jcache, jnp.asarray(x), jnp.asarray(i, jnp.int32))
        with torch.no_grad():
            y, cache = attn.attention_decode(
                p, torch.from_numpy(x), cache,
                torch.full((B,), i, dtype=torch.int32), cfg=cfg,
                window=window)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               **TOL)
    np.testing.assert_allclose(cache["v"].numpy(), np.asarray(jcache["v"]),
                               **TOL)
    for row in cache["pos"].numpy():
        np.testing.assert_array_equal(row, np.asarray(jcache["pos"]))
    assert sorted(cache["pos"][0].tolist()) == [7, 8, 9, 10]


def test_logits_and_prefill_step_match(pair):
    jmodel, jparams, model = pair
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, model.cfg.vocab_size, (2, 12)).astype(np.int32)
    want = np.asarray(jmodel.logits(jparams, {"tokens": jnp.asarray(tokens)}))
    got = model.logits({"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    want = np.asarray(j_make_prefill_step(jmodel, tail=5)(
        jparams, {"tokens": jnp.asarray(tokens)}))
    got = make_prefill_step(model, tail=5, device="cpu")(
        {"tokens": torch.from_numpy(tokens).long()})
    assert got.shape == (2, 5, model.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_engine_prefill_equals_unpadded_and_reference_padded():
    jmodel, jparams, model = _pair()
    prompt = [3, 1, 4, 1, 5]
    eng = ServeEngine(model, num_slots=2, max_len=16,
                      buckets=PromptBuckets([8]), device="cpu")
    req = eng.submit(prompt, 3)
    assert req.bucket_len == 8
    cache, tok0 = eng._prefill(req)
    plain = model.init_decode(1, 16)
    for t in prompt:
        logits, plain = model.decode_step(plain, torch.tensor([[t]]))
    assert int(tok0) == int(torch.argmax(logits[0, -1]))
    for a, b in zip(tree.leaves(cache), tree.leaves(plain)):
        assert torch.equal(a, b)
    # the reference's prefill pads the prompt to its bucket
    jeng = JEngine(jmodel, jparams, num_slots=2, max_len=16,
                   buckets=JBuckets([8]))
    jcache, jtok = jeng._prefill(jeng.submit(prompt, 3))
    assert int(jtok[0]) == int(tok0)
    _assert_caches_close(cache, jcache, slot_stacked=False)
