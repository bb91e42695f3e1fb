"""The config levers of the port (``remat``, ``bf16_bwd``, ``mamba_bf16_io``,
``window_kv_slice``, ``scan_unroll``) against the JAX package, at
``reduced()`` sizes on the CPU with the same (perturbed,
``tests/_torch_archs.py``) parameters on both sides:

* ``remat`` ``none`` / ``full`` / ``dots``: loss, MoE aux and gradients
  bitwise equal (minicpm; jamba with its MoE aux); ``full`` recomputes the
  matrix products in the backward pass and ``dots`` does not; also under
  ``bf16_bwd``, whose recomputation keeps the bf16 backward; the stack's
  backward stacks each leaf's layer gradients once, at any depth;
* ``bf16_bwd``: the bf16 backward of one projection bitwise equal to its
  products written out; gradients of a bf16 ``reduced()`` minicpm against
  the reference's with the lever on at rtol 2e-2 (atol 2e-2 x max|g|:
  bf16 outputs rounded after sums in other orders);
* ``mamba_bf16_io``: jamba's Mamba mixer against the reference's with the
  lever on at 1e-5, which the port without the lever misses;
* ``window_kv_slice`` (gemma2, S 2048 so the reference slices K/V) and
  ``scan_unroll`` 4 (jamba, rwkv6): the reference with the lever on
  against the port at 1e-5 (the port computes the same values with either
  setting).
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
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import build_model as j_build
from repro.models import mamba as jmamba
from repro.models.sharding import ShardingPolicy as JPolicy
from repro_torch import tree
from repro_torch.configs import ARCHS, MINICPM_2B, ModelConfig, reduced
from repro_torch.models import (
    build_model, init_params, params_from_jax, params_to_numpy,
)
from repro_torch.models import layers
from repro_torch.models import mamba as tmamba

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_archs import (  # noqa: E402
    exact_group_norm, make_batch, make_pair, perturbed, torch_batch,
)

JAMBA = "jamba-1.5-large-398b"


def _model(arch, **changes):
    cfg = dataclasses.replace(reduced(ARCHS[arch]), **changes)
    return build_model(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")


def _tokens(cfg, B=2, S=24, seed=1):
    return {"tokens": torch.randint(
        0, cfg.vocab_size, (B, S),
        generator=torch.Generator().manual_seed(seed))}


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


def _loss_grads(model, batch):
    loss, metrics = model(batch)
    counter = _CountMM()
    with counter:
        grads = torch.autograd.grad(loss, model.leaves())
    return loss, metrics["aux"], grads, counter.mm


@pytest.mark.parametrize("arch", ["minicpm-2b", JAMBA])
def test_remat_changes_no_value(arch):
    runs = {}
    for remat in ("none", "full", "dots"):
        model = _model(arch, remat=remat)
        runs[remat] = _loss_grads(model, _tokens(model.cfg))
    loss, aux, grads, mm_none = runs["none"]
    if arch == JAMBA:
        assert float(aux.detach()) > 0
    for remat in ("full", "dots"):
        l, a, g, _ = runs[remat]
        assert torch.equal(l, loss) and torch.equal(a, aux)
        assert all(torch.equal(x, y) for x, y in zip(g, grads))
    # "full" recomputes every product of the stack in the backward pass;
    # "dots" keeps their outputs and recomputes only the rest
    assert runs["full"][3] > mm_none
    assert runs["dots"][3] == mm_none


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] = self.ops.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_stack_backward_does_not_grow_with_depth_squared(remat):
    """Each stacked leaf's layer gradients are stacked once (an unbind's
    backward), not added up as one zero-padded copy of the whole leaf per
    layer (a select's): the backward's select / zero-fill count does not
    grow with depth, and there is one stack per stacked leaf."""
    counts = {}
    for layers_ in (2, 6):
        model = _model("minicpm-2b", num_layers=layers_, remat=remat)
        loss, _ = model(_tokens(model.cfg))
        counter = _CountOps()
        with counter:
            torch.autograd.grad(loss, model.leaves())
        counts[layers_] = counter.ops
    n_stacked = len(tree.leaves(model.params()["stack"]))
    for ops in counts.values():
        assert ops.get(torch.ops.aten.stack.default, 0) == n_stacked
    for op in (torch.ops.aten.select_backward.default,
               torch.ops.aten.new_zeros.default):
        assert counts[2].get(op, 0) == counts[6].get(op, 0)


def test_remat_recomputes_under_the_forward_bf16_setting():
    """The bf16 backward survives recomputation: ``full`` and ``dots``
    give the gradients of ``none`` under ``bf16_bwd``."""
    want = None
    for remat in ("none", "full", "dots"):
        model = _model("minicpm-2b", remat=remat, dtype="bfloat16",
                       bf16_bwd=True)
        _, _, grads, _ = _loss_grads(model, _tokens(model.cfg))
        if want is None:
            want = grads
        assert all(torch.equal(x, y) for x, y in zip(grads, want))


def test_remat_is_skipped_without_grad(monkeypatch):
    model = _model("minicpm-2b", remat="full")
    calls = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        model(_tokens(model.cfg))
    assert not calls
    model(_tokens(model.cfg))
    assert len(calls) == model.cfg.num_super_layers


def test_config_takes_the_levers():
    cfg = dataclasses.replace(MINICPM_2B, remat="dots", window_kv_slice=True,
                              scan_unroll=4, bf16_bwd=True,
                              mamba_bf16_io=True)
    assert (cfg.remat, cfg.scan_unroll) == ("dots", 4)
    assert MINICPM_2B.remat == "full" and not MINICPM_2B.bf16_bwd
    with pytest.raises(ValueError, match="remat"):
        dataclasses.replace(MINICPM_2B, remat="some")
    assert isinstance(cfg, ModelConfig)


# ---------------------------------------------------------------------------
# bf16 backward
# ---------------------------------------------------------------------------


def test_mixed_projection_backward_is_the_products_written_out():
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 5, 16), generator=g).to(torch.bfloat16)
    w = torch.randn((16, 24), generator=g).to(torch.bfloat16)
    ct = torch.randn((2, 5, 24), generator=g)  # float32, as from the head
    for fn, out_dtype in ((layers.dense, torch.bfloat16),
                          (layers.head_dot, torch.float32)):
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        with layers.mixed_bwd(True):
            y = fn(xs, ws)
        assert y.dtype == out_dtype
        plain = fn(x, w)
        assert torch.equal(y.detach(), plain)
        dx, dw = torch.autograd.grad(y, (xs, ws), ct.to(out_dtype))
        c16 = ct.to(out_dtype).to(torch.bfloat16)
        assert torch.equal(dx, torch.matmul(c16, w.T).to(torch.bfloat16))
        assert torch.equal(dw, torch.matmul(x.reshape(-1, 16).T,
                                            c16.reshape(-1, 24)))
    assert not layers.mixed_bwd_enabled()


def _bf16_pair(**changes):
    """The reduced minicpm in bf16 on both sides: the port's seeded
    parameters, perturbed (``_torch_archs.perturbed``), as bf16 numpy."""
    jcfg = dataclasses.replace(j_reduced(j_get_config("minicpm-2b")),
                               **changes)
    cfg = dataclasses.replace(reduced(ARCHS["minicpm-2b"]), **changes)
    init = init_params(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    leaves, treedef = tree.flatten(init)
    noisy = tree.leaves(perturbed(params_to_numpy(init)))
    np_params = tree.unflatten(treedef, [
        np.asarray(jnp.asarray(a, jnp.bfloat16))
        if t.dtype == torch.bfloat16 else a
        for a, t in zip(noisy, leaves)])
    model = build_model(cfg, params_from_jax(np_params, cfg, "cpu"),
                        device="cpu")
    return jcfg, j_build(jcfg), model, jax.tree.map(jnp.asarray, np_params)


def test_bf16_bwd_matches_jax():
    jcfg, jmodel, model, jparams = _bf16_pair(dtype="bfloat16",
                                              bf16_bwd=True)
    assert jcfg.bf16_bwd and jcfg.dtype == "bfloat16"
    batch = make_batch(model.cfg, 2, 24, seed=2)
    jgrads = jax.jit(jax.grad(lambda p: jmodel.loss(p, batch)[0]))(jparams)
    loss, _ = model(torch_batch(batch))
    grads = torch.autograd.grad(loss, model.leaves())
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, jg in zip(grads, jleaves):
        assert str(g.dtype) == f"torch.{jg.dtype}"
        jg = np.asarray(jg.astype(jnp.float32))
        np.testing.assert_allclose(
            g.float().numpy(), jg, rtol=2e-2,
            atol=2e-2 * max(float(np.abs(jg).max()), 1e-30))
    # the lever is taken: the same model without it gives other gradients
    off = build_model(dataclasses.replace(model.cfg, bf16_bwd=False),
                      model.params(), device="cpu")
    loss_off, _ = off(torch_batch(batch))
    assert torch.equal(loss_off, loss)
    grads_off = torch.autograd.grad(loss_off, off.leaves())
    assert any(not torch.equal(a, b) for a, b in zip(grads, grads_off))


# ---------------------------------------------------------------------------
# Mamba's bf16 scan inputs
# ---------------------------------------------------------------------------


def test_mamba_bf16_io_matches_jax():
    pair = make_pair(JAMBA, mamba_bf16_io=True)
    i = next(i for i, s in enumerate(pair.cfg.pattern) if s.mixer == "mamba")
    np_mixer = jax.tree.map(lambda a: np.asarray(a)[0],
                            pair.np_params["stack"][f"sub{i}"]["mixer"])
    u = np.random.default_rng(4).standard_normal(
        (2, 16, pair.cfg.d_model)).astype(np.float32) * 0.5
    want = jmamba.mamba_full(jax.tree.map(jnp.asarray, np_mixer),
                             jnp.asarray(u), cfg=pair.jcfg, policy=JPolicy())
    tparams = jax.tree.map(torch.from_numpy, np_mixer)
    got = tmamba.mamba_full(tparams, torch.from_numpy(u), cfg=pair.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    off = tmamba.mamba_full(tparams, torch.from_numpy(u),
                            cfg=dataclasses.replace(pair.cfg,
                                                    mamba_bf16_io=False))
    # the lever is taken: without it the output misses the tolerance
    assert not np.allclose(off.numpy(), np.asarray(want), rtol=1e-5,
                           atol=1e-5)


# ---------------------------------------------------------------------------
# the reference's XLA-only levers
# ---------------------------------------------------------------------------


def _loss_matches(pair, B, S):
    batch = make_batch(pair.cfg, B, S, seed=5)
    jloss, jm = jax.jit(pair.jmodel.loss)(pair.jparams, batch)
    with torch.no_grad():
        loss, m = pair.model(torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), rtol=1e-5,
                               atol=1e-12)


def test_window_kv_slice_matches_jax():
    """S 2048: two query chunks of 1024, window 32 + chunk < S, so the
    reference scores each chunk against a (window + chunk) K/V slice."""
    pair = make_pair("gemma2-27b", window_kv_slice=True)
    assert pair.jcfg.window_kv_slice and pair.cfg.window_kv_slice
    _loss_matches(pair, 1, 2048)


@pytest.mark.parametrize("arch", [JAMBA, "rwkv6-1.6b"])
def test_scan_unroll_matches_jax(arch, monkeypatch):
    if arch.startswith("rwkv6"):
        exact_group_norm(monkeypatch)
    pair = make_pair(arch, scan_unroll=4)
    _loss_matches(pair, 2, 24)
