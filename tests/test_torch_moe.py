"""The port's MoE routing and the serving engine on the new families,
against the JAX package, at reduced sizes in float32 on the CPU.

* ``_capacity`` / ``_bucket_positions`` exactly as the reference's;
  ``_route_local`` and ``moe_apply`` on routes that overflow capacity: the
  same items dropped, outputs and aux within 1e-5;
* per-row routing groups (the engine's) equal the reference's vmapped B=1
  ``moe_apply``;
* the engine routes every slot row as its own group: a reduced
  deepseek-moe ``ServeEngine`` of 12 slots gives the reference's
  single-device ``ServeEngine``'s tokens, while the fixed-batch decode at
  B = 12 keeps the batch-wide capacity and equals the reference's
  ``decode_step``, drops included (logits within 1e-5);
* continuous batching equal to serial decoding for reduced jamba and rwkv6
  (bitwise, the port against itself);
* a router over two rwkv6 engines losing one: the resumed requests replay
  their tokens through the recurrent state and end with their serial
  tokens.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.serve import PromptBuckets as JBuckets
from repro.serve import ServeEngine as JEngine
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import head_dot
from repro_torch.serve import PromptBuckets, Router, ServeEngine
from repro_torch.serve.scheduler import FINISHED

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_world as tw  # noqa: E402
from _torch_archs import make_pair  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


class _NoMesh:
    mesh = None


@pytest.fixture(scope="module")
def deepseek():
    return make_pair("deepseek-moe-16b")


# ---------------------------------------------------------------------------
# routing primitives


def test_capacity_matches_reference():
    for tokens in (1, 7, 8, 12, 64, 1000, 4096):
        for k in (1, 2, 6):
            for buckets in (1, 4, 16, 64):
                for factor in (1.0, 1.25, 2.0):
                    assert tmoe._capacity(tokens, k, buckets, factor) == \
                        jmoe._capacity(tokens, k, buckets, factor)


def test_bucket_positions_match_reference():
    rng = np.random.default_rng(0)
    dest = rng.integers(0, 4, 50)
    dest[:20] = 1  # one bucket past its capacity
    jpos, jkeep = jmoe._bucket_positions(jnp.asarray(dest), 4, 8)
    pos, keep = tmoe._bucket_positions(torch.from_numpy(dest), 4, 8)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert not keep.all()


def _skewed_route(rng, T, E, K):
    """(T, K) distinct expert ids, most tokens on expert 0, and gates."""
    idx = np.stack([rng.permutation(E)[:K] for _ in range(T)])
    hot = rng.random(T) < 0.8
    for t in np.flatnonzero(hot):
        if 0 not in idx[t]:
            idx[t, 0] = 0
    gates = rng.random((T, K)).astype(np.float32)
    return idx, gates / gates.sum(-1, keepdims=True)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_route_local_drops_as_reference(act):
    rng = np.random.default_rng(1)
    T, K, E, D, F = 48, 2, 4, 16, 8
    x = rng.standard_normal((T, D)).astype(np.float32)
    idx, gates = _skewed_route(rng, T, E, K)
    w = [rng.standard_normal(s).astype(np.float32) * 0.3
         for s in ((E, D, F), (E, D, F), (E, F, D))]
    want = jmoe._route_local(jnp.asarray(x), jnp.asarray(idx),
                             jnp.asarray(gates), *map(jnp.asarray, w),
                             cap_factor=1.25, act=act)
    got = tmoe._route_local(torch.from_numpy(x), torch.from_numpy(idx),
                            torch.from_numpy(gates), *map(torch.from_numpy, w),
                            cap_factor=1.25, act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # expert 0 overflows its capacity: the late tokens' items are dropped
    cap = tmoe._capacity(T, K, E, 1.25)
    assert (idx == 0).sum() > cap
    _, keep = tmoe._bucket_positions(torch.from_numpy(idx.reshape(-1)), E,
                                     cap)
    assert not keep.all()


def test_moe_apply_matches_reference_with_drops(deepseek):
    """A shared offset in every token skews the router, so capacity binds;
    ``y`` and the aux loss agree and items are dropped on both sides."""
    cfg, jcfg = deepseek.cfg, deepseek.jcfg
    p = deepseek.np_params["stack"]["sub0"]["ffn"]
    p = jax.tree.map(lambda a: a[0], p)
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 32, cfg.d_model))
         + 3 * rng.standard_normal(cfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              cfg=jcfg, policy=_NoMesh())
    ty, taux = tmoe.moe_apply(jax.tree.map(torch.from_numpy, p),
                              torch.from_numpy(x), cfg=cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    # the route overflowed: some expert got more items than its capacity
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(
        p["w_router"]), -1)
    top = torch.topk(probs, cfg.moe.top_k, -1).indices.reshape(-1)
    cap = tmoe._capacity(64, cfg.moe.top_k, cfg.moe.num_experts,
                         cfg.moe.capacity_factor)
    assert torch.bincount(top).max() > cap


def test_moe_row_groups_match_reference_vmapped_rows(deepseek):
    """``groups=B`` routes each row alone, as the reference's engine does
    by vmapping a B=1 decode over its slots."""
    cfg, jcfg = deepseek.cfg, deepseek.jcfg
    p = jax.tree.map(lambda a: a[0], deepseek.np_params["stack"]["sub0"]
                     ["ffn"])
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((12, 1, cfg.d_model))
         + 3 * rng.standard_normal(cfg.d_model)).astype(np.float32)
    jy = jax.vmap(lambda r: jmoe.moe_apply(
        jax.tree.map(jnp.asarray, p), r[None], cfg=jcfg,
        policy=_NoMesh())[0][0])(jnp.asarray(x))
    ty, _ = tmoe.moe_apply(jax.tree.map(torch.from_numpy, p),
                           torch.from_numpy(x), cfg=cfg, groups=12)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    # one group of 12 drops (capacity 8 < 12 tokens on the hot expert)
    one, _ = tmoe.moe_apply(jax.tree.map(torch.from_numpy, p),
                            torch.from_numpy(x), cfg=cfg)
    assert not torch.allclose(one, ty, **TOL)


# ---------------------------------------------------------------------------
# the engine's per-row routing against the reference engine


def _workload(vocab, n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(3, 9))).tolist(),
             int(rng.integers(4, 8))) for _ in range(n)]


def test_engine_routes_rows_alone_like_the_reference_engine(deepseek):
    work = _workload(deepseek.cfg.vocab_size, 12, 4)

    def run(eng):
        reqs = [eng.submit(p, n) for p, n in work]
        out = eng.run()
        return [out[r.rid] for r in reqs]

    ref = run(JEngine(deepseek.jmodel, deepseek.jparams, num_slots=12,
                      max_len=24, buckets=JBuckets([8])))
    got = run(ServeEngine(deepseek.model, num_slots=12, max_len=24,
                          buckets=PromptBuckets([8]), device="cpu"))
    assert got == ref


def test_fixed_batch_decode_keeps_the_batch_capacity(deepseek):
    """``decode_step`` at B = 12 routes the 12 tokens as one group
    (capacity 8), as the reference's does: logits within 1e-5 at every
    step, and different from the per-row routing at some step."""
    B, L = 12, 6
    rng = np.random.default_rng(5)
    toks = rng.integers(0, deepseek.cfg.vocab_size, (B, L)).astype(np.int32)
    jstep = jax.jit(deepseek.jmodel.decode_step)
    jcache = deepseek.jmodel.init_decode(deepseek.jparams, B, L)
    cache = deepseek.model.init_decode(B, L)
    rows = deepseek.model.init_decode(B, L)
    differs = False
    for t in range(L):
        jl, jcache = jstep(deepseek.jparams, jcache, toks[:, t : t + 1])
        tok = torch.from_numpy(toks[:, t : t + 1]).long()
        tl, cache = deepseek.model.decode_step(cache, tok)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        hr, rows = deepseek.model.decode_hidden(rows, tok, moe_per_row=True)
        per_row = head_dot(hr, deepseek.model.head_weights())
        differs |= not torch.allclose(per_row, tl, **TOL)
    assert differs


# ---------------------------------------------------------------------------
# continuous batching and the router on the recurrent families


@pytest.mark.parametrize("name", ["jamba-1.5-large-398b", "rwkv6-1.6b"])
def test_continuous_equals_serial(name):
    p = make_pair(name)
    work = _workload(p.cfg.vocab_size, 5, 6)

    def make():
        return ServeEngine(p.model, num_slots=3, max_len=24,
                           buckets=PromptBuckets([4, 8]), device="cpu")

    serial = tw.serve_serial(make(), work)
    eng = make()
    reqs = [eng.submit(q, n) for q, n in work[:2]]
    eng.step()
    reqs += [eng.submit(q, n) for q, n in work[2:]]
    out = eng.run()
    assert [out[r.rid] for r in reqs] == serial


def test_router_fail_replica_resumes_rwkv6():
    """Replica 0 dies after two steps; its requests are re-planned onto
    replica 1, which rebuilds their recurrent state by replaying prompt
    and generated tokens: every request ends with its serial tokens."""
    p = make_pair("rwkv6-1.6b")
    work = _workload(p.cfg.vocab_size, 4, 7)

    def make():
        return ServeEngine(p.model, num_slots=2, max_len=32,
                           buckets=PromptBuckets([8]), device="cpu")

    serial = tw.serve_serial(make(), work)
    a, b = make(), make()
    router = Router([a, b])
    reqs = [router.submit(q, n) for q, n in work]
    for _ in range(2):
        a.step()
        b.step()
    assert any(r.generated and router.placement[r.rid] == 0 for r in reqs)
    router.fail_replica(0)
    while not b.idle:
        b.step()
    for req, want in zip(reqs, serial):
        assert req.state == FINISHED
        assert req.generated == want, (req.rid, req.generated, want)
