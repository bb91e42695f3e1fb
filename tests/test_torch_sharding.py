"""The port's sharding policy (spec logic only) against the JAX package's:
``ShardingPolicy.param_specs`` of all nine ported archs at full width, in
modes ``train`` and ``serve2d``, on several grids, equal to the
reference's spec for spec (a reference ``PartitionSpec`` as a tuple).
Shapes come from ``jax.eval_shape`` on the reference's side and ``meta``
tensors on the port's; both policies are made by their package's
``make_policy`` from the same mesh description (the reference reads only
``axis_names`` and ``devices.shape`` of a mesh).  Also ``dp`` /
``tp_size`` / ``dp_size``; without a mesh the placement methods are the
identity, and with one they place: a spec becomes DTensor placements
(``placements``), ``shard_params`` / ``act`` / ``constrain`` give DTensors
laid out by the fitted spec (here on a one-rank gloo world and a (1, 1)
mesh; the 2x2 layouts run in ``tests/test_torch_mesh.py``).
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


@pytest.fixture
def one_rank_world(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_a_mesh_places(one_rank_world):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = make_mesh((1, 1), ("data", "model"))
    pol = make_policy(ARCHS["minicpm-2b"], mesh, device="cpu")
    assert pol.device == "cpu"
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    h = pol.act(x, kind="hidden")
    assert isinstance(h, DTensor)
    assert tuple(h.placements) == (Shard(0), Replicate())
    assert torch.equal(h.full_tensor(), x)
    c = pol.constrain(h, (None, None, "model"))
    assert tuple(c.placements) == (Replicate(), Shard(2))
    params = {"embedding": torch.ones(8, 4), "final_norm": torch.zeros(4)}
    placed = pol.shard_params(params)
    assert tuple(placed["embedding"].placements) == (Shard(1), Shard(0))
    assert tuple(placed["final_norm"].placements) == (Replicate(),
                                                      Replicate())
    with pytest.raises(ValueError):
        pol.act(x, kind="nonsense")


def test_spec_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.sharding import placements, spec_leaves

    mesh = make_mesh((2, 4, 4), ("pod", "data", "model"))
    # two axes on one dim shard it major to minor, in mesh order
    assert placements(mesh, (None, ("pod", "data"), "model")) == [
        Shard(1), Shard(1), Shard(2)]
    assert placements(mesh, ()) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        placements(mesh, (("data", "pod"),))
    with pytest.raises(ValueError, match="two"):
        placements(mesh, ("model", "model"))
    assert spec_leaves({"b": (None,), "a": {"y": (), "x": ("data",)}}) == [
        ("data",), (), (None,)]


def test_mesh_description():
    mesh = make_mesh((2, 3), ("pod", "data"))
    assert mesh.devices.shape == (2, 3)
    assert mesh.devices.tolist() == [[0, 1, 2], [3, 4, 5]]
    with pytest.raises(ValueError):
        make_mesh((2, 3), ("data",))


@pytest.mark.parametrize("levers", [
    {}, {"bf16_bwd": True, "dtype": "bfloat16"}, {"remat": "dots"},
    {"remat": "none"},
], ids=["default", "bf16_bwd", "remat_dots", "remat_none"])
def test_levers_on_a_one_rank_mesh_are_bitwise(one_rank_world, levers):
    """At world size 1 every shard is the whole tensor: two
    ``make_train_step`` steps on a (1, 1) mesh equal those with
    ``mesh=None`` bit for bit, under each lever (the card's phase ``mesh``
    holds the same at minicpm-2b's widths)."""
    import dataclasses

    from repro_torch.configs import MINICPM_2B, OptimizerConfig, reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init

    cfg = dataclasses.replace(reduced(MINICPM_2B), **levers)
    opt = OptimizerConfig(lr=1e-3, schedule="constant", warmup_steps=1)
    mesh = make_mesh((1, 1), ("data", "model"))
    runs = []
    for m in (None, mesh):
        pol = make_policy(cfg, m, device="cpu")
        model = build_model(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu", policy=pol)
        data = SyntheticLM(cfg.vocab_size, 32, 4, seed=1, mesh=m,
                           batch_axes=("data",) if m else ())
        state = {"model": model, "opt": adamw_init(model.params())}
        step = make_train_step(
            model, opt, n_micro=2, device="cpu",
            grad_shardings=pol.param_specs(model.params()) if m else None)
        losses = []
        for s in range(2):
            state, metrics = step(state, data.batch(s, "cpu"))
            losses.append(float(metrics["loss"]))
        params = [p.to_local() if hasattr(p, "to_local") else p
                  for p in model.leaves()]
        runs.append((losses, [p.detach().clone() for p in params]))
    (l0, p0), (l1, p1) = runs
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
