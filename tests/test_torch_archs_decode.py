"""Cached decode of every decoder-only model family of the JAX package in
the port, at ``reduced()`` in float32 on the CPU, with the same (perturbed,
``tests/_torch_archs.py``) parameters and seeded numpy inputs:

* step by step against the reference's ``decode_step`` (B = 2, 36 steps:
  the reduced gemma2's local ring buffer of 32 wraps): logits within
  1e-5 and every cache leaf (``cache_to_jax``) within 1e-5; rwkv6's cache
  within 1e-4.  Reason: its first steps group-normalise heads whose
  variance is ~1e-4 (the state is still empty), which magnifies float32
  rounding about a hundredfold: the port against itself with one
  einsum's summation order changed differs by 8.8e-6 there;
* against the port's own full forward at 2e-3 (the reference's own
  ``test_decode_matches_full_forward`` tolerance).
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.models import cache_to_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_archs import (  # noqa: E402
    NEW_ARCHS, decode_input, exact_group_norm, make_batch, make_pair,
    torch_batch,
)

TOL = dict(rtol=1e-5, atol=1e-5)
B = 2
DEC_S = 36            # decode steps: the local ring buffer wraps at 32


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


def _assert_cache_close(port_cache, ref_cache, tol):
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
            _close(g, w, **tol)


def test_decode_matches_reference_step_by_step(pair):
    batch = make_batch(pair.cfg, B, DEC_S, seed=3)
    jstep = jax.jit(pair.jmodel.decode_step)
    jcache = pair.jmodel.init_decode(pair.jparams, B, DEC_S)
    cache = pair.model.init_decode(B, DEC_S)
    tb = torch_batch(batch)
    cache_tol = (dict(rtol=1e-4, atol=1e-4) if pair.cfg.name.startswith(
        "rwkv6") else TOL)
    for t in range(DEC_S):
        jl, jcache = jstep(pair.jparams, jcache, decode_input(batch, t))
        tl, cache = pair.model.decode_step(cache, decode_input(tb, t))
        _close(tl, jl)
        _assert_cache_close(cache, jcache, cache_tol)


def test_decode_matches_full_forward(pair):
    # MoE: the full forward routes the B x S tokens as one group with a
    # capacity of 16 at 2 x 8 (the reference's test size), so it drops
    # nothing, as the B = 2 decode steps never do; at 2 x 36 it may drop
    steps = 8 if pair.cfg.moe is not None else DEC_S
    batch = make_batch(pair.cfg, B, steps, seed=4, mrope_streams=False)
    tb = torch_batch(batch)
    full = pair.model.logits(tb)
    cache = pair.model.init_decode(B, steps)
    outs = []
    for t in range(steps):
        logits, cache = pair.model.decode_step(cache, decode_input(tb, t))
        outs.append(logits[:, 0])
    _close(torch.stack(outs, dim=1), full, rtol=2e-3, atol=2e-3)
