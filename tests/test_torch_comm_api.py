"""The host-side API the port gained beside the mesh layout, against the
JAX package's (``tests/test_comm_api.py``'s cases on both packages):

* ``Topology.from_mesh`` / ``from_axes`` / ``require_axes`` and
  ``dispatched_cost``; ``launch.mesh.hierarchy_axes``;
* ``MachineParams.fit`` (the fitted constants equal the reference's);
* ``grad_sync.compressed_transport_dtype`` (equal up to int32; beyond it
  the port returns int64, which torch honours, where the reference raises
  because jax without x64 would degrade it);
* the deprecated shims: ``collectives.ALGORITHMS`` (a read-only view of
  the registry), ``auto_crossover_bytes``, ``select_algorithm``,
  ``hierarchical_allreduce`` and ``grad_sync.GradSyncConfig``, each
  warning once;
* ``error_feedback.ef_residual`` and ``layers.layer_norm`` on seeded
  inputs.
"""

from __future__ import annotations

import dataclasses
import math
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import collectives as jcoll
from repro.core import comm as jcomm
from repro.core import grad_sync as jgs
from repro.core import perf_model as jpm
from repro.launch import mesh as jmesh
from repro.models import layers as jlayers
from repro.optim import error_feedback as jef
from repro_torch.core import collectives, comm, grad_sync
from repro_torch.core import perf_model as pm
from repro_torch.launch import make_mesh
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers
from repro_torch.optim import ef_residual

GRIDS = [(1, 16), (2, 16), (4, 4), (5, 3), (6, 1), (8, 16), (16, 16)]
SIZES = [4, 512, 2048, 1 << 16, 1 << 20, 16 << 20, 64 << 20]


def _duck_mesh(shape, names):
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _same_topology(t, j):
    assert (t.n_nodes, t.ppn, t.inter_axes, t.intra_axes, t.axes) == (
        j.n_nodes, j.ppn, j.inter_axes, j.intra_axes, j.axes)


@pytest.mark.parametrize("kw", [
    {}, {"inter_axes": "pod", "intra_axes": ("data", "model")},
    {"intra_axes": ("data", "model")}, {"inter_axes": ()},
])
def test_topology_from_mesh_matches_reference(kw):
    mesh = _duck_mesh((2, 4, 2), ("pod", "data", "model"))
    _same_topology(comm.Topology.from_mesh(mesh, **kw),
                   jcomm.Topology.from_mesh(mesh, **kw))
    # a planning-only topology: no world of 16 ranks here
    assert comm.Topology.from_mesh(mesh, **kw).groups is None


def test_topology_from_mesh_refusals():
    mesh = _duck_mesh((2, 4, 2), ("pod", "data", "model"))
    for kw in ({"inter_axes": "nonexistent", "intra_axes": "data"},
               {"inter_axes": "data"}):
        with pytest.raises(ValueError):
            jcomm.Topology.from_mesh(mesh, **kw)
        with pytest.raises(ValueError):
            comm.Topology.from_mesh(mesh, **kw)
    with pytest.raises(ValueError, match="both"):
        comm.Topology.from_mesh(mesh, inter_axes="data")


def test_from_axes_and_hierarchy_axes():
    for shape, names in (((4, 4), ("pod", "data")), ((16, 16),
                                                     ("data", "model")),
                         ((2, 16, 16), ("pod", "data", "model")),
                         ((8,), ("data",))):
        mesh = make_mesh(shape, names)
        assert tmesh.hierarchy_axes(mesh) == jmesh.hierarchy_axes(mesh)
        t = comm.Topology.from_axes(*tmesh.hierarchy_axes(mesh), mesh=mesh)
        _same_topology(t, jcomm.Topology.from_mesh(mesh))


def test_require_axes():
    for mod in (comm, jcomm):
        with pytest.raises(ValueError, match="planning-only"):
            mod.Topology.of(2, 4).require_axes()
        t = mod.Topology.of(1, 1)
        assert t.require_axes() is t
    mesh = _duck_mesh((2, 4), ("pod", "data"))
    t = comm.Topology.from_mesh(mesh)
    assert t.require_axes() is t and t.axes == ("pod", "data")


@pytest.mark.parametrize("n,ppn", GRIDS)
def test_dispatched_cost_matches_reference(n, ppn):
    for s in SIZES:
        assert comm.Topology.of(n, ppn).dispatched_cost(s) == (
            jcomm.Topology.of(n, ppn).dispatched_cost(s))


def _fit_rows(P):
    rows = []
    for s in [256, 1024, 4096, 16384, 65536, 1 << 20]:
        rows.append((s, jpm.maxrate_message_cost(float(s), P, 1), 1))
        rows.append((s, jpm.maxrate_message_cost(float(s), P, 16), 16))
    return rows


def _params(p):
    return (p.alpha_l, p.beta_l, p.alpha, p.R_b, p.R_N, p.gamma, p.name)


def test_machine_params_fit_recovers_constants():
    P = pm.TPU_V5E_POD
    f = pm.MachineParams.fit(_fit_rows(jpm.TPU_V5E_POD), base=P,
                             name="roundtrip")
    assert f.alpha == pytest.approx(P.alpha, rel=1e-6)
    assert f.R_b == pytest.approx(P.R_b, rel=1e-6)
    assert f.R_N == pytest.approx(P.R_N, rel=1e-6)
    assert f.alpha_l == P.alpha_l and f.gamma == P.gamma
    j = jpm.MachineParams.fit(_fit_rows(jpm.TPU_V5E_POD),
                              base=jpm.TPU_V5E_POD, name="roundtrip")
    assert _params(f) == _params(j)
    assert pm.crossover_bytes(8, 16, f, large="mla") == pytest.approx(
        pm.crossover_bytes(8, 16, P, large="mla"), rel=1e-3)


def test_machine_params_fit_without_injection_rows_keeps_base():
    rows = [(s, jpm.maxrate_message_cost(float(s), jpm.BLUE_WATERS, 1))
            for s in [512, 4096, 65536]]
    f = pm.MachineParams.fit(rows, base=pm.BLUE_WATERS)
    assert f.R_N == pm.BLUE_WATERS.R_N
    assert _params(f) == _params(
        jpm.MachineParams.fit(rows, base=jpm.BLUE_WATERS))


def test_machine_params_fit_underdetermined_raises():
    with pytest.raises(ValueError, match="single-sender"):
        pm.MachineParams.fit([(1024, 1e-5)])
    with pytest.raises(ValueError, match="grow"):
        pm.MachineParams.fit([(1024, 2e-5), (4096, 1e-5)])


def test_compressed_transport_dtype_matches_reference():
    for group in (1, 2, 16, 257, 258, 300, 65_536, 16_000_000):
        for bits in (2, 4, 8):
            want = jgs.compressed_transport_dtype(group, bits)
            got = grad_sync.compressed_transport_dtype(group, bits)
            assert str(got).split(".")[-1] == jnp.dtype(want).name
    with pytest.raises(OverflowError, match="int32"):
        jgs.compressed_transport_dtype(20_000_000, 8)
    assert grad_sync.compressed_transport_dtype(20_000_000, 8) == (
        torch.int64)


def test_algorithms_view_is_read_only_and_derived_from_the_registry():
    table = collectives.ALGORITHMS
    assert collectives.ALGORITHMS is table
    assert set(table) == set(jcoll.ALGORITHMS)
    assert table["nap"] is collectives.nap_allreduce
    assert table["mla"] is collectives.mla_allreduce
    for name, fn in table.items():
        assert comm.get_engine(name).execute is fn
    with pytest.raises(TypeError):
        table["custom"] = lambda x: x


@pytest.mark.parametrize("n,ppn", GRIDS)
def test_legacy_dispatch_matches_reference(n, ppn):
    got = collectives.auto_crossover_bytes(n, ppn)
    want = jcoll.auto_crossover_bytes(n, ppn)
    assert got == want or (math.isinf(got) and math.isinf(want))
    for s in SIZES:
        for op in ("sum", "max"):
            for small in (None, 64):
                assert collectives.select_algorithm(
                    s, n, ppn, op=op, small_threshold_bytes=small
                ) == jcoll.select_algorithm(
                    s, n, ppn, op=op, small_threshold_bytes=small)


def _warnings_of(fn, times=2):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = [fn() for _ in range(times)]
    return [x for x in w if issubclass(x.category, DeprecationWarning)], out


def test_gradsyncconfig_shim_warns_exactly_once():
    comm._DEPRECATION_WARNED.discard("grad_sync.GradSyncConfig")
    dep, (cfg, _) = _warnings_of(
        lambda: grad_sync.GradSyncConfig(algorithm="nap"))
    assert len(dep) == 1 and "GradSyncConfig" in str(dep[0].message)
    assert isinstance(cfg, comm.CommPolicy)
    assert cfg.algorithm == "nap" and cfg.mean and cfg.bucket_bytes is None
    assert dataclasses.astuple(cfg) == dataclasses.astuple(
        comm.CommPolicy(algorithm="nap"))


def test_hierarchical_allreduce_shim_warns_once():
    comm._DEPRECATION_WARNED.discard("collectives.hierarchical_allreduce")
    mesh = make_mesh((1, 1), ("pod", "data"))
    x = torch.arange(6, dtype=torch.float32)
    dep, outs = _warnings_of(lambda: collectives.hierarchical_allreduce(
        x, inter_axes="pod", intra_axes="data", mesh=mesh))
    assert len(dep) == 1 and "hierarchical_allreduce" in str(dep[0].message)
    for y in outs:  # a grid of one rank: the allreduce is the identity
        assert torch.equal(y, x)


def test_ef_residual_matches_reference():
    rng = np.random.default_rng(7)
    c = (rng.standard_normal((4, 37)) * 3).astype(np.float32)
    for bits in (4, 8):
        qmax = 2 ** (bits - 1) - 1
        scale = np.float32(np.abs(c).max() / qmax)
        want = np.asarray(jef.ef_residual(jnp.asarray(c), scale, qmax))
        got = ef_residual(torch.from_numpy(c), float(scale), qmax).numpy()
        np.testing.assert_array_equal(got, want)
        assert np.abs(got).max() <= scale / 2 * (1 + 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32) * 2 + 0.5
    scale = rng.standard_normal(48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jlayers.layer_norm(jx, jnp.asarray(scale),
                                         jnp.asarray(bias)).astype(
                                             jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = layers.layer_norm(tx, torch.from_numpy(scale),
                            torch.from_numpy(bias))
    assert got.dtype == tx.dtype
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                               rtol=tol, atol=tol)


def test_mesh_entry_points_default_to_cuda():
    """No CPU mesh when CUDA is absent: the DeviceMesh, make_grad_sync and
    build_training(mesh=) run on cuda unless asked for the CPU."""
    from repro_torch.configs import MINICPM_2B, TrainConfig, reduced
    from repro_torch.launch import build_training

    if torch.cuda.is_available():
        pytest.skip("the refusal needs a host without CUDA")
    mesh = make_mesh((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.device_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        grad_sync.make_grad_sync(comm.CommPolicy(), mesh,
                                 data_axes=("data",), grad_specs={})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_training(reduced(MINICPM_2B), TrainConfig(), mesh=mesh,
                       ckpt_dir="unused")
