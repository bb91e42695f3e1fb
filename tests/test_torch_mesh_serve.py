"""Serving and MoE on a mesh (DTensor on a 4-rank gloo world) against the
JAX package's, and the port's mesh runs against its own unmeshed ones.

One world (``tests/_torch_world.py`` mode ``mesh_serve``) and one
reference process (mode ``jax_mesh_serve``, 4 virtual CPU devices) run side
by side:

* reduced minicpm-2b (float32, the reference's initial parameters) on a
  2x2 ``("data", "model")`` mesh under the train layout and under
  ``serve2d``: ``make_prefill_step`` logits, the teacher-forced
  ``decode_step`` logits of 6 prompt positions and 6 greedy tokens through
  ``make_serve_step``, against the reference's jitted steps under the same
  policy (logits at rtol / atol 1e-5, tokens equal); the final cache's
  values at 1e-5, and each cache leaf's local shard shape equal to the
  reference's ``NamedSharding`` shard (laid out by its
  ``_attach_cache_shardings``) on the device of the same index;
* gemma2 (window ring buffer, softcaps), granite (MQA: the positions go
  on ``model``), jamba (Mamba states and MoE, at a capacity factor with no
  drops), rwkv6 (its norm's bf16 round trip taken out) and whisper
  (``enc_out``, cross-attention) decoded on the mesh in both layouts
  against ``mesh=None`` in the same world, at 1e-5;
* ``moe_apply`` of reduced deepseek-moe (E = 4, 8 x 16 tokens) on 2x2
  (the expert-parallel route) and 4x1 (DP only: the local route with the
  global tokens' capacity), at capacity factor 1.0 (tokens drop) and 4.0:
  loss, ``y``, the gradients of ``x`` and of every parameter against the
  reference's under the same policy; at 4.0 the 2x2 run also equals the
  port's ``mesh=None``; ``serve2d`` 2x2: the forward and a decode step's
  ``y`` only (an inference layout: its gradients are not held);
  ``build_training(mesh=)`` on deepseek, 2 steps, against ``mesh=None``;
* ``repro_torch.core.collectives.all_to_all`` and its gradient against
  ``lax.all_to_all(..., tiled=False)`` on the same per-rank inputs;
* ``ServeEngine(mesh=)`` and ``serve_batch(mesh=)`` on a 2x2 ``("pod",
  "data")`` mesh against the reference's meshed engine and
  ``serve_batch``: the same token streams.

The world takes about 50 s alone on 8 CPUs, the reference about 30 s.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs.archs import MINICPM_2B as J_MINICPM
from repro.configs.archs import reduced as jreduced
from repro.models import build_model as j_build
from repro_torch.core import Topology
from repro_torch.launch import make_mesh, make_policy, mesh_topology

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_world as tw  # noqa: E402

MOE_HELD = [(n, cf) for n, _, mode in tw.MOE_MESHES if mode == "train"
            for cf in tw.MOE_FACTORS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_serve")
    params = jax.jit(j_build(jreduced(J_MINICPM)).init)(
        jax.random.PRNGKey(0))
    leaves = jax.tree.leaves(params)
    np.savez(out / "params0.npz", **{
        f"leaf{i}": np.asarray(p) for i, p in enumerate(leaves)})
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    jproc = subprocess.Popen(
        [sys.executable, str(tw.__file__), "jax_mesh_serve", str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        ranks = tw.spawn_world("mesh_serve", out, timeout=600)
        log = jproc.communicate(timeout=600)[0]
    finally:
        if jproc.poll() is None:
            jproc.kill()
            jproc.wait()
    assert jproc.returncode == 0, log[-3000:]
    with np.load(out / "jax.npz") as z:
        ref = {k: z[k] for k in z.files}
    for i, p in enumerate(leaves):
        np.testing.assert_array_equal(ref[f"init{i}"], np.asarray(p))
    return ranks, ref


def _close(got, want, what, rel_atol=False):
    atol = 1e-5 * float(np.abs(want).max()) if rel_atol else 1e-5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("mode", tw.MS_MODES)
def test_decode_matches_reference(runs, mode):
    ranks, ref = runs
    key = f"minicpm/{mode}"
    for r in ranks:
        for part in ("prefill", "logits"):
            _close(r[f"{key}/{part}"], ref[f"{key}/{part}"], part)
        np.testing.assert_array_equal(r[f"{key}/tokens"],
                                      ref[f"{key}/tokens"])
    assert ref[f"{key}/tokens"].shape == (tw.MS_B, tw.MS_STEPS + 1)


@pytest.mark.parametrize("mode", tw.MS_MODES)
def test_cache_matches_reference(runs, mode):
    ranks, ref = runs
    key = f"minicpm/{mode}"
    names = sorted(k.split("/cache/")[1] for k in ref
                   if k.startswith(f"{key}/cache/"))
    assert "stack/sub0/k" in names
    for r in ranks:
        for name in names:
            got, want = r[f"{key}/cache/{name}"], ref[f"{key}/cache/{name}"]
            if name == "index":  # one index a row, all at the same one
                np.testing.assert_array_equal(got, np.full(tw.MS_B, want))
            elif name.endswith("/pos"):  # one ring position row a row
                for b in range(tw.MS_B):
                    np.testing.assert_array_equal(got[:, b], want)
            else:
                _close(got, want, name)


@pytest.mark.parametrize("mode", tw.MS_MODES)
def test_cache_shards_match_named_sharding(runs, mode):
    """Rank ``r`` holds the shard of each cache leaf that the reference's
    ``NamedSharding`` gives device ``r``: in ``serve2d`` the positions go
    over ``("model", "data")``, model-major; the port's per-row ``index`` /
    ``pos`` follow the batch rows (over ``data`` in train mode, replicated
    in ``serve2d``)."""
    ranks, ref = runs
    key = f"minicpm/{mode}"
    rows = tw.MS_B // 2 if mode == "train" else tw.MS_B
    for name in sorted(k.split("/cshape/")[1] for k in ref
                       if k.startswith(f"{key}/cshape/")):
        want = ref[f"{key}/cshape/{name}"]  # (devices, ndim)
        for rank, r in enumerate(ranks):
            got = r[f"{key}/cshape/{name}"]
            if name == "index":
                np.testing.assert_array_equal(got, [rows])
            elif name.endswith("/pos"):
                n, size = want[rank]
                np.testing.assert_array_equal(got, [n, rows, size])
            else:
                np.testing.assert_array_equal(got, want[rank], err_msg=name)
    k = ref[f"{key}/cshape/stack/sub0/k"][0]
    full = ref[f"{key}/cache/stack/sub0/k"].shape
    if mode == "serve2d":  # (n, B, KV, S, hd): S over all four ranks
        assert tuple(k) == full[:3] + (full[3] // 4, full[4])
    else:  # KV heads over model, rows over data
        assert tuple(k) == (full[0], full[1] // 2, full[2] // 2) + full[3:]


@pytest.mark.parametrize("mode", tw.MS_MODES)
@pytest.mark.parametrize("arch", tw.MS_FAMILIES)
def test_family_decode_equals_unmeshed(runs, arch, mode):
    ranks, _ = runs
    plain, mesh = f"family/{arch}/plain", f"family/{arch}/{mode}"
    for r in ranks:
        for part in ("prefill", "logits"):
            _close(r[f"{mesh}/{part}"], r[f"{plain}/{part}"], part)
        np.testing.assert_array_equal(r[f"{mesh}/tokens"],
                                      r[f"{plain}/tokens"])
        leaves = [k.split("/cache/")[1] for k in r
                  if k.startswith(f"{plain}/cache/")]
        for name in leaves:
            _close(r[f"{mesh}/cache/{name}"], r[f"{plain}/cache/{name}"],
                   name, rel_atol=True)


@pytest.mark.parametrize("name,cf", MOE_HELD,
                         ids=[f"{n}-cf{cf}" for n, cf in MOE_HELD])
def test_moe_matches_reference(runs, name, cf):
    """Loss, output and gradients of ``moe_apply`` on the mesh against the
    reference's under the same policy: on 2x2 the expert-parallel route
    (capacities per DP shard, as the reference's ``shard_map``), on 4x1
    the local route with the capacity of the global tokens."""
    ranks, ref = runs
    key = f"moe/{cf}/{name}"
    n = sum(1 for k in ref if k.startswith(f"{key}/grad/")) - 1
    assert n == 7  # router, 3 expert weights, 3 shared-expert weights
    for r in ranks:
        np.testing.assert_allclose(r[f"{key}/loss"], ref[f"{key}/loss"],
                                   rtol=1e-5)
        _close(r[f"{key}/x/y"], ref[f"{key}/x/y"], "y")
        _close(r[f"{key}/grad/x"], ref[f"{key}/grad/x"], "x", rel_atol=True)
        for i in range(n):
            _close(r[f"{key}/grad/{i}"], ref[f"{key}/grad/{i}"], str(i),
                   rel_atol=True)


@pytest.mark.parametrize("cf", tw.MOE_FACTORS)
def test_moe_serve2d_forward_matches_reference(runs, cf):
    ranks, ref = runs
    key = f"moe/{cf}/2x2_serve2d"
    for r in ranks:
        np.testing.assert_allclose(r[f"{key}/loss"], ref[f"{key}/loss"],
                                   rtol=1e-5)
        _close(r[f"{key}/x/y"], ref[f"{key}/x/y"], "y")
        _close(r[f"{key}/x_dec/y"], ref[f"{key}/x_dec/y"], "decode")
        assert not any(k.startswith(f"{key}/grad/") for k in r)


def test_moe_drops_tokens_at_capacity_one(runs):
    """At capacity factor 1.0 tokens drop (the outputs differ from the
    factor 4.0 ones, where nothing drops), on every route."""
    ranks, _ = runs
    r = ranks[0]
    for name in ("plain",) + tuple(n for n, _, _ in tw.MOE_MESHES):
        y1, y4 = r[f"moe/1.0/{name}/x/y"], r[f"moe/4.0/{name}/x/y"]
        rows = np.abs(y1 - y4).max(axis=-1) > 1e-3
        assert rows.any(), name


def test_moe_without_drops_equals_unmeshed(runs):
    ranks, _ = runs
    plain = "moe/4.0/plain"
    for r in ranks:
        for name, _, mode in tw.MOE_MESHES:
            key = f"moe/4.0/{name}"
            np.testing.assert_allclose(r[f"{key}/loss"], r[f"{plain}/loss"],
                                       rtol=1e-5)
            _close(r[f"{key}/x/y"], r[f"{plain}/x/y"], name)
            if mode != "train":
                continue
            for k in (k for k in r if k.startswith(f"{plain}/grad/")):
                g = k.split("/grad/")[1]
                _close(r[f"{key}/grad/{g}"], r[k], f"{name} {g}",
                       rel_atol=True)


def test_build_training_moe_on_the_mesh(runs):
    ranks, _ = runs
    for r in ranks:
        assert r["moe_train/mesh"].shape == (2,)
        np.testing.assert_allclose(r["moe_train/mesh"], r["moe_train/plain"],
                                   rtol=1e-5)
        np.testing.assert_array_equal(r["moe_train/mesh"],
                                      ranks[0]["moe_train/mesh"])


def test_all_to_all_matches_lax(runs):
    ranks, ref = runs
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r["a2a/y"], ref["a2a/y"][rank])
        np.testing.assert_array_equal(r["a2a/grad"], ref["a2a/grad"][rank])
    # row t of rank r's result is rank t's row r
    xa, _ = tw.a2a_inputs(4)
    np.testing.assert_array_equal(ranks[1]["a2a/y"][2], xa[2][1])


def test_meshed_engine_matches_reference(runs):
    ranks, ref = runs
    for i in range(len(tw.SERVE_WORKLOAD)):
        for r in ranks:
            np.testing.assert_array_equal(r[f"engine/serial{i}"],
                                          ref[f"engine/serial{i}"])
            np.testing.assert_array_equal(r[f"engine/cont{i}"],
                                          ref[f"engine/cont{i}"])


def test_serve_batch_on_the_mesh_matches_reference(runs):
    ranks, ref = runs
    assert ref["serve_batch"].shape == (tw.MS_B, 6)
    for r in ranks:
        np.testing.assert_array_equal(r["serve_batch"], ref["serve_batch"])


def test_mesh_topology_takes_a_mesh_or_a_grid():
    mesh = make_mesh((2, 2), ("pod", "data"))
    topo = mesh_topology(mesh)
    assert topo == Topology.from_mesh(mesh)
    assert (topo.n_nodes, topo.ppn, topo.axes) == (2, 2, ("pod", "data"))
    model = make_mesh((2, 4), ("data", "model"))
    assert mesh_topology(model) == Topology.from_mesh(model)
    assert (mesh_topology(model).n_nodes, mesh_topology(model).ppn) == (1, 2)
    # the (n_nodes, ppn) form: the world's grid (one rank needs no world)
    grid = mesh_topology(1, 1)
    assert (grid.n_nodes, grid.ppn) == (1, 1)
    assert grid.require_groups() is not None


def test_serve2d_places_model_major():
    """``serve2d``'s joint axis names the model axis first: its policy's
    ``DeviceMesh`` takes that order, so ``(("model", "data"),)`` shards one
    dimension major to minor there; train mode keeps the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.configs import MINICPM_2B, reduced

    cfg = reduced(MINICPM_2B)
    for shape, names, order in (
            ((2, 2), ("data", "model"), ("model", "data")),
            ((2, 2, 2), ("pod", "data", "model"),
             ("model", "pod", "data"))):
        mesh = make_mesh(shape, names)
        pol = make_policy(cfg, mesh, mode="serve2d", device="cpu")
        assert pol.axis_order == order
        joint = ("model",) + tuple(a for a in names if a != "model")
        assert pol.placements((None, joint)) == [Shard(1)] * len(names)
        assert make_policy(cfg, mesh, device="cpu").axis_order == names
        spec = pol.cache_spec("k", (2, 4, 2, 64, 16))
        assert spec == (None, None, None, joint, None)
        assert pol.placements(spec) == [Shard(3)] * len(names)
        assert pol.cache_spec("pos", (2, 4, 64)) == (None, None, None)
    train = make_policy(cfg, make_mesh((2, 2), ("data", "model")),
                        device="cpu")
    assert train.placements(train.cache_spec("k", (2, 4, 2, 64, 16))) == [
        Shard(1), Shard(2)]
    assert train.placements(train.cache_spec("k", (2, 4, 1, 64, 16))) == [
        Shard(1), Shard(3)]
    assert train.placements(train.cache_spec("index", (3,))) == [
        Replicate(), Replicate()]


# ---------------------------------------------------------------------------
# world size 1: every shard is the whole tensor (the card's phase
# mesh_serve holds the same at published widths)
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank_world(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_ep_at_one_rank_is_the_local_route(one_rank_world, dtype):
    """On a one-rank model group the two hops reduce to the local route at
    the expert-parallel route's own capacity: bitwise equal, drops
    included."""
    import torch

    from repro_torch.models import moe as tmoe

    dt = getattr(torch, dtype)
    T, D, F, E, K, cf = 32, 16, 8, 4, 2, 1.0
    g = torch.Generator().manual_seed(0)
    x = torch.randn(T, D, generator=g).to(dt)
    probs = torch.softmax(torch.randn(T, E, generator=g), -1)
    gate, idx = torch.topk(probs, K, -1)
    w = [torch.randn(shape, generator=g).to(dt) * 0.3 for shape in
         ((E, D, F), (E, D, F), (E, F, D))]
    mesh = make_mesh((1, 1), ("data", "model"))
    group = mesh.device_mesh("cpu").get_group("model")
    ep = tmoe._route_ep(x, idx, gate, *w, group=group, cap_factor=cf,
                        act="silu")
    cap_s = tmoe._capacity(T, K, 1, cf)
    cap_e = tmoe._capacity(cap_s, 1, E, cf)
    assert cap_e <= T  # the two buffers hold the same rows
    local = tmoe._route_local(x, idx, gate, *w, cap_factor=cf, act="silu",
                              cap=cap_e)
    assert torch.equal(ep, local)
    roomy = tmoe._route_local(x, idx, gate, *w, cap_factor=cf, act="silu",
                              cap=T)
    assert not torch.equal(local, roomy)  # tokens dropped at cap_e


@pytest.mark.parametrize("arch", ["minicpm-2b", "deepseek-moe-16b"])
def test_decode_on_a_one_rank_mesh_is_bitwise(one_rank_world, arch):
    """Prefill logits, decode logits and greedy tokens on a (1, 1) mesh,
    under the train layout and ``serve2d``, equal ``mesh=None``'s bit for
    bit."""
    import torch

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.launch import make_prefill_step, make_serve_step
    from repro_torch.models import build_model

    cfg = reduced(ARCHS[arch])
    mesh = make_mesh((1, 1), ("data", "model"))
    prompts = torch.from_numpy(tw.ms_prompts(cfg.vocab_size))
    runs = []
    for m, mode in ((None, "train"), (mesh, "train"), (mesh, "serve2d")):
        model = build_model(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu",
                            policy=make_policy(cfg, m, mode=mode,
                                               device="cpu"))
        pre = make_prefill_step(model, device="cpu")({"tokens": prompts})
        cache = model.init_decode(tw.MS_B, tw.MS_LEN)
        for t in range(tw.MS_P):
            logits, cache = model.decode_step(cache, prompts[:, t:t + 1])
        step = make_serve_step(model, device="cpu")
        tok = torch.argmax(tw._full_tensor(logits)[:, -1], -1)[:, None]
        toks = [tok]
        for _ in range(tw.MS_STEPS):
            tok, cache = step(cache, tok)
            toks.append(tok)
        runs.append((tw._full_tensor(pre), tw._full_tensor(logits),
                     torch.cat(toks, 1)))
    for got in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(got, runs[0]))


def test_moe_training_on_a_one_rank_mesh_is_bitwise(one_rank_world,
                                                    tmp_path):
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.launch import build_training

    cfg = reduced(ARCHS["deepseek-moe-16b"])
    losses, params = [], []
    for name, m in (("plain", None),
                    ("mesh", make_mesh((1, 1), ("data", "model")))):
        loop = build_training(cfg, tw._train_cfg(2), mesh=m,
                              ckpt_dir=tmp_path / name, device="cpu")
        loop.run(2)
        losses.append([x["loss"] for x in loop.metrics_log])
        params.append([tw._full_tensor(p).detach()
                       for p in loop.state["model"].leaves()])
    assert len(losses[0]) == 2 and losses[0] == losses[1]
    assert all(a.equal(b) for a, b in zip(*params))
