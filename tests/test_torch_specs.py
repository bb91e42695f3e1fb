"""The abstract batch and state of a cell (``launch.steps.input_specs`` /
``state_specs``, ``mesh=None``) against the JAX package's, for every
arch x ``SHAPES`` entry: ``meta`` tensors with the reference's shapes and
dtypes, no memory.

* the three assertions of the reference's ``tests/test_launch.py``
  (qwen2-72b's train batch, whisper's decode batch with ``frames``,
  qwen2-vl's ``embeds`` and (3, B, S) ``positions``; the 72B state built
  without memory);
* every leaf of the batch, the parameters, the AdamW moments (bf16 above
  1e11 parameters) and the decode cache -- whisper's with ``enc_out`` --
  equal in shape and dtype to the reference's ``ShapeDtypeStruct``s.  The
  port's cache keeps one index a row: its ``index`` is (B,) where the
  reference's is a scalar, and its ring ``pos`` (n_super, B, size) where
  the reference's is (n_super, size);
* with a mesh, both give the same leaves, each carrying its spec
  (``tests/test_torch_mesh_specs.py`` holds the specs against the
  reference's on the production meshes).
"""

from __future__ import annotations

import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.launch import steps as jsteps
from repro_torch import tree
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import input_specs, make_mesh, state_specs
from repro_torch.models import Model

CELLS = [(a, s) for a in sorted(ARCHS) for s in SHAPES]


def _dtype(x) -> str:
    return str(x.dtype).split(".")[-1]


def _same(got: torch.Tensor, want) -> None:
    assert got.is_meta
    assert tuple(got.shape) == tuple(want.shape)
    assert _dtype(got) == _dtype(want)


def test_port_has_every_reference_arch():
    assert sorted(ARCHS) == sorted(J_ARCHS)


def test_input_specs_abstract_no_allocation():
    """The reference's test_input_specs_abstract_no_allocation."""
    batch = input_specs("qwen2-72b", "train_4k", None)
    assert set(batch) == {"tokens", "labels", "loss_mask"}
    assert all(v.is_meta for v in batch.values())
    assert batch["tokens"].shape == (256, 4096)
    dec = input_specs("whisper-tiny", "decode_32k", None)
    assert "frames" in dec and dec["tokens"].shape == (128, 1)
    vlm = input_specs("qwen2-vl-2b", "prefill_32k", None)
    assert vlm["embeds"].shape == (32, 32768, 1536)
    assert vlm["positions"].shape == (3, 32, 32768)


def test_state_specs_abstract_for_72b():
    """The reference's test_state_specs_abstract_for_72b, in a few
    seconds."""
    t0 = time.perf_counter()
    model, policy, state, opt_cfg = state_specs("qwen2-72b", "train_4k",
                                                None)
    seconds = time.perf_counter() - t0
    total = sum(p.numel() for p in tree.leaves(state["params"]))
    assert total > 70e9  # it really is the 72B config
    leaves = tree.leaves(state["params"]) + state["opt"].mu + state["opt"].nu
    assert all(t.is_meta for t in leaves)
    assert isinstance(model, Model) and model.device.type == "meta"
    assert policy.mesh is None
    assert seconds < 20, seconds


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_specs_match_reference(arch, shape):
    want_batch = jsteps.input_specs(arch, shape, None)
    got_batch = input_specs(arch, shape, None)
    assert set(got_batch) == set(want_batch)
    for k in want_batch:
        _same(got_batch[k], want_batch[k])

    _, _, want, jopt_cfg = jsteps.state_specs(arch, shape, None)
    _, _, got, opt_cfg = state_specs(arch, shape, None)
    assert set(got) == set(want)
    assert opt_cfg.moment_dtype == jopt_cfg.moment_dtype
    g_leaves, g_def = tree.flatten(got["params"])
    w_leaves = jax.tree.leaves(want["params"])
    assert g_def == tree.flatten(jax.tree.map(lambda _: 0,
                                              want["params"]))[1]
    for g, w in zip(g_leaves, w_leaves, strict=True):
        _same(g, w)
    if "opt" in want:
        for moments, jmoments in ((got["opt"].mu, want["opt"].mu),
                                  (got["opt"].nu, want["opt"].nu)):
            for g, w in zip(moments, jax.tree.leaves(jmoments), strict=True):
                _same(g, w)
    if "cache" in want:
        _same_cache(got["cache"], want["cache"], SHAPES[shape].global_batch)


def _same_cache(got: dict, want: dict, B: int) -> None:
    assert set(got) == set(want)
    assert tuple(want["index"].shape) == () and got["index"].shape == (B,)
    assert _dtype(got["index"]) == _dtype(want["index"])
    if "enc_out" in want:
        _same(got["enc_out"], want["enc_out"])
    assert set(got["stack"]) == set(want["stack"])
    for sub, leaves in want["stack"].items():
        assert set(got["stack"][sub]) == set(leaves)
        for name, w in leaves.items():
            g = got["stack"][sub][name]
            if name == "pos":  # one ring position row per batch row
                assert g.is_meta and _dtype(g) == _dtype(w)
                n, size = w.shape
                assert tuple(g.shape) == (n, B, size)
            else:
                _same(g, w)


def test_whisper_decode_cache_holds_the_encoder_output():
    _, _, state, _ = state_specs("whisper-tiny", "decode_32k", None)
    enc = state["cache"]["enc_out"]
    assert enc.is_meta and tuple(enc.shape) == (128, 32768, 384)
    assert enc.dtype == torch.bfloat16


def test_moments_are_bf16_above_1e11_parameters():
    _, _, state, opt_cfg = state_specs("jamba-1.5-large-398b", "train_4k",
                                       None)
    assert opt_cfg.moment_dtype == "bfloat16"
    assert state["opt"].mu[0].dtype == torch.bfloat16
    _, _, _, opt_cfg = state_specs("qwen2-72b", "train_4k", None)
    assert opt_cfg.moment_dtype == "float32"


def test_overrides_apply():
    _, _, state, _ = state_specs("minicpm-2b", "prefill_32k", None,
                                 cfg_overrides={"num_layers": 2})
    assert set(state) == {"params"}
    assert state["params"]["stack"]["sub0"]["mixer"]["w_q"].shape[0] == 2


def test_a_mesh_is_the_mesh_slice():
    mesh = make_mesh((2, 4), ("data", "model"))
    batch = input_specs("minicpm-2b", "train_4k", mesh)
    plain = input_specs("minicpm-2b", "train_4k", None)
    for k, t in batch.items():
        assert t.is_meta and tuple(t.shape) == tuple(plain[k].shape)
        assert t.spec == ("data", None)
    _, policy, state, _ = state_specs("minicpm-2b", "train_4k", mesh)
    assert policy.mesh is mesh
    w_q = state["params"]["stack"]["sub0"]["mixer"]["w_q"]
    assert w_q.is_meta and w_q.spec == (None, "data", "model")
    assert not hasattr(plain["tokens"], "spec")
