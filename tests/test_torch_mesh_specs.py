"""``input_specs`` / ``state_specs`` with a mesh against the JAX package's,
for every cell of the reference's dry run (``repro.launch.dryrun.cells``)
on both production meshes (16 x 16 ``("data", "model")`` and 2 x 16 x 16
``("pod", "data", "model")``), at full width.

Every prefill and decode cell is compared again in the serving layout
(``input_specs`` / ``state_specs`` with ``serve2d=True``): the batch is
replicated, the weights and experts go over ``model x data`` jointly and
the cache's positions over the joint axes; the port's per-row ``index`` /
``pos`` are replicated there, as the batch is.

The reference needs a mesh of 512 devices: it runs in one subprocess with
512 virtual CPU devices (``tests/_torch_world.py`` mode ``jax_specs``) and
writes each leaf's shape, dtype and ``NamedSharding.spec``.  The port's
leaves are ``meta`` tensors (no bytes drawn) carrying their spec as
``.spec``; a spec is compared as a tuple, a one-axis tuple written as the
axis name.  The port's decode cache keeps one ``index`` and one ring
``pos`` row a batch row: those two leaves have the reference's
shapes plus the batch dim, and put it over the DP axes as the other
batch-row leaves do; the reference's ``index`` / ``pos`` are replicated.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.launch.dryrun import cells
from repro_torch import tree
from repro_torch.configs import SHAPES
from repro_torch.launch import input_specs, state_specs
from repro_torch.launch.mesh import dp_axes, make_production_mesh

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_world as tw  # noqa: E402

CELLS = list(cells())
SERVE_CELLS = [(a, s) for a, s in CELLS if SHAPES[s].kind != "train"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("specs")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(tw.__file__), "jax_specs", str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-3000:]
    return json.loads((out / "jax_specs.json").read_text())


def _leaf(t) -> dict:
    assert t.is_meta
    return _norm({"shape": list(t.shape),
                  "dtype": str(t.dtype).split(".")[-1],
                  "spec": [tw.spec_entry(e) for e in t.spec]})


def _norm(want: dict) -> dict:
    """A leaf with its spec padded with None to the leaf's rank (a spec
    may be shorter than the rank: ``P()`` replicates every dim)."""
    spec = list(want["spec"]) + [None] * (len(want["shape"])
                                          - len(want["spec"]))
    return dict(want, spec=spec)


def test_cells_are_the_reference_dry_run():
    assert len(CELLS) == 33


def test_production_meshes():
    mesh = make_production_mesh()
    assert (mesh.shape, mesh.axis_names) == ((16, 16), ("data", "model"))
    pod = make_production_mesh(multi_pod=True)
    assert (pod.shape, pod.axis_names) == ((2, 16, 16),
                                           ("pod", "data", "model"))
    assert dp_axes(pod) == ("pod", "data")


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_sharded_specs_match_reference(reference, arch, shape):
    for multi_pod in (False, True):
        want = reference[f"{arch}/{shape}/{int(multi_pod)}"]
        mesh = make_production_mesh(multi_pod=multi_pod)
        dp = list(dp_axes(mesh)) if multi_pod else "data"

        batch = input_specs(arch, shape, mesh)
        assert set(batch) == set(want["batch"])
        for k, t in batch.items():
            assert _leaf(t) == _norm(want["batch"][k]), (k, multi_pod)

        _, policy, state, _ = state_specs(arch, shape, mesh)
        assert policy.mesh is mesh
        got = [_leaf(t) for t in tree.leaves(state["params"])]
        assert got == [_norm(w) for w in want["params"]], multi_pod
        for m in ("mu", "nu"):
            if m in want:
                got = [_leaf(t) for t in getattr(state["opt"], m)]
                assert got == [_norm(w) for w in want[m]], (m, multi_pod)
        if "cache" not in want:
            assert "cache" not in state
            continue
        cache = state["cache"]
        wc = want["cache"]
        g_index = _leaf(cache["index"])
        assert wc["index"]["shape"] == [] and g_index["dtype"] == "int32"
        B = g_index["shape"][0]
        assert g_index["spec"][0] in (dp, None)
        if "enc_out" in wc:
            assert _leaf(cache["enc_out"]) == _norm(wc["enc_out"])
        for sub, leaves in cache["stack"].items():
            for name, t in leaves.items():
                w = _norm(wc[f"stack/{sub}/{name}"])
                g = _leaf(t)
                if name == "pos":  # one ring position row per batch row
                    n, size = w["shape"]
                    assert g["shape"] == [n, B, size] and w["spec"] == [
                        None, None]
                    assert g["spec"] in ([None, dp, None],
                                         [None, None, None])
                else:
                    assert g == w, (sub, name, multi_pod)


def test_spec_leaves_have_no_storage():
    _, _, state, _ = state_specs("qwen2-72b", "train_4k",
                                 make_production_mesh(multi_pod=True))
    leaves = tree.leaves(state["params"]) + state["opt"].mu
    assert all(t.is_meta and hasattr(t, "spec") for t in leaves)
    assert state["opt"].step == 0


@pytest.mark.parametrize("arch,shape", SERVE_CELLS,
                         ids=[f"{a}-{s}" for a, s in SERVE_CELLS])
def test_serve2d_specs_match_reference(reference, arch, shape):
    for multi_pod in (False, True):
        want = reference[f"{arch}/{shape}/{int(multi_pod)}/serve2d"]
        mesh = make_production_mesh(multi_pod=multi_pod)

        batch = input_specs(arch, shape, mesh, serve2d=True)
        assert set(batch) == set(want["batch"])
        for k, t in batch.items():
            assert _leaf(t) == _norm(want["batch"][k]), (k, multi_pod)
            assert all(e is None for e in t.spec)

        _, policy, state, _ = state_specs(arch, shape, mesh, serve2d=True)
        assert policy.mode == "serve2d" and policy.dp_axes == ()
        got = [_leaf(t) for t in tree.leaves(state["params"])]
        assert got == [_norm(w) for w in want["params"]], multi_pod
        if "cache" not in want:
            assert "cache" not in state
            continue
        cache = state["cache"]
        wc = want["cache"]
        g_index = _leaf(cache["index"])
        assert wc["index"]["shape"] == [] and g_index["spec"] == [None]
        B = g_index["shape"][0]
        if "enc_out" in wc:
            assert _leaf(cache["enc_out"]) == _norm(wc["enc_out"])
        joint = 0
        for sub, leaves in cache["stack"].items():
            for name, t in leaves.items():
                w = _norm(wc[f"stack/{sub}/{name}"])
                g = _leaf(t)
                if name == "pos":  # one ring position row per batch row
                    n, size = w["shape"]
                    assert g == {"shape": [n, B, size], "dtype": "int32",
                                 "spec": [None, None, None]}
                else:
                    assert g == w, (sub, name, multi_pod)
                    joint += any(isinstance(e, list) and e[0] == "model"
                                 for e in g["spec"])
        if any("k" in leaves for leaves in cache["stack"].values()):
            assert joint, (arch, shape)  # KV positions over the joint axes
