"""The port's sharding policy (spec logic only) against the JAX package's:
``ShardingPolicy.param_specs`` of all nine ported archs at full width, in
modes ``train`` and ``serve2d``, on several grids, equal to the
reference's spec for spec (a reference ``PartitionSpec`` as a tuple).
Shapes come from ``jax.eval_shape`` on the reference's side and ``meta``
tensors on the port's; both policies are made by their package's
``make_policy`` from the same mesh description (the reference reads only
``axis_names`` and ``devices.shape`` of a mesh).  Also ``dp`` /
``tp_size`` / ``dp_size``, and that nothing runs sharded yet: with a mesh
the placement methods raise, without one they are the identity.
"""

from __future__ import annotations

import functools

import jax
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.launch.steps import make_policy as j_make_policy
from repro.models import build_model as j_build
from repro_torch.configs import ARCHS
from repro_torch.launch import make_mesh, make_policy
from repro_torch.models import ShardingPolicy, init_params

GRIDS = (
    ((8,), ("data",)),
    ((16, 16), ("data", "model")),
    ((2, 4, 4), ("pod", "data", "model")),
    ((2, 16, 16), ("pod", "data", "model")),
)
MODES = ("train", "serve2d")


def _canon(entry):
    # jax writes a one-axis tuple as the axis name
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def _spec_tree(node):
    if isinstance(node, dict):
        return {k: _spec_tree(v) for k, v in node.items()}
    return tuple(_canon(e) for e in node)


@functools.lru_cache(maxsize=None)
def _j_shapes(arch):
    return jax.eval_shape(j_build(J_ARCHS[arch]).init, jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_jax(arch):
    params = init_params(ARCHS[arch], device="meta")
    jshapes = _j_shapes(arch)
    for shape, axes in GRIDS:
        mesh = make_mesh(shape, axes)
        for mode in MODES:
            ours = make_policy(ARCHS[arch], mesh, mode=mode)
            theirs = j_make_policy(J_ARCHS[arch], mesh, mode=mode)
            got = ours.param_specs(params)
            want = _spec_tree(theirs.param_specs(jshapes))
            assert got == want, (arch, shape, mode)
            assert (ours.dp, ours.tp_size, ours.dp_size) == (
                theirs.dp, theirs.tp_size, theirs.dp_size)


def test_some_specs_are_sharded():
    """The comparison above is not between two all-replicated trees."""
    mesh = make_mesh((2, 4, 4), ("pod", "data", "model"))
    specs = make_policy(ARCHS["minicpm-2b"], mesh).param_specs(
        init_params(ARCHS["minicpm-2b"], device="meta"))
    # 122,753 rows do not split over 4: the vocab axis is dropped
    assert specs["embedding"] == (None, ("pod", "data"))
    assert specs["stack"]["sub0"]["mixer"]["w_q"] == (
        None, ("pod", "data"), "model")
    assert specs["final_norm"] == ()


def test_no_mesh_is_replicated_identity():
    pol = make_policy(ARCHS["minicpm-2b"], None)
    assert pol == ShardingPolicy()
    x = torch.ones(2, 3)
    assert pol.act(x, kind="hidden") is x
    assert pol.constrain(x, (None, None)) is x
    params = {"w": x}
    assert pol.shard_params(params) is params
    assert pol.spec_for("stack/sub0/mixer/w_q", (4, 8)) == ()
    assert (pol.dp, pol.tp_size, pol.dp_size) == (None, 1, 1)


def test_a_mesh_is_not_executed_yet():
    pol = make_policy(ARCHS["minicpm-2b"], make_mesh((4, 2),
                                                     ("data", "model")))
    x = torch.ones(2, 3)
    for call in (lambda: pol.act(x, kind="hidden"),
                 lambda: pol.constrain(x, (None, None)),
                 lambda: pol.shard_params({"w": x})):
        with pytest.raises(NotImplementedError, match="later slice"):
            call()


def test_mesh_description():
    mesh = make_mesh((2, 3), ("pod", "data"))
    assert mesh.devices.shape == (2, 3)
    assert mesh.devices.tolist() == [[0, 1, 2], [3, 4, 5]]
    with pytest.raises(ValueError):
        make_mesh((2, 3), ("data",))
