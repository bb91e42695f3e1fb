"""The FSDP x TP layout executed on a mesh (DTensor on a 4-rank gloo world)
against the JAX package's, and the port's mesh runs against its own
unmeshed ones.

One world (``tests/_torch_world.py`` mode ``sharded``) and one reference
process (mode ``jax_sharded``, 4 virtual CPU devices) run side by side from
the reference's initial parameters of ``reduced(minicpm-2b)`` (float32,
vocab 512, d 64, 4 heads, 2 kv heads: every axis divides, so the
vocab-parallel embedding and head are exercised):

* mesh ``("data", "model")`` 2x2, batch 8 x 32: the forward loss and the
  gradients (rtol 1e-5, atol 1e-5 x max|g|: XLA and torch add in other
  orders), each parameter's local shard shape equal to the reference's
  ``NamedSharding`` shard on the device of the same index (rank ``r`` is
  device ``r`` of the row-major mesh), and 2 ``make_train_step`` steps at
  n_micro 2 with ``grad_shardings``: losses and every parameter at rtol
  1e-4, atol 1e-5;
* ``build_training(mesh=)`` against ``build_training(mesh=None)`` on every
  rank, 4 steps: losses at rtol 1e-5; a run resumed from a checkpoint
  written on the mesh is bitwise equal to a straight run on the mesh; a
  restore across layouts, both ways, gives the written parameters bitwise;
* ``make_grad_sync`` on ``("pod", "data")`` 2x2, ``nap`` mean: uncompressed
  against the reference's ``sync_grads_local`` in a shard_map at
  ``check_grad_sync``'s tolerance (``np.allclose``), int8 and int4 within
  one quantization step of the leaf's scale (the f32 pre-combine and fold
  sum in other orders on the two sides) and within the reference check's
  bound of the exact mean; every rank holds the same result;
* ``Topology.from_mesh`` on a mesh with a ``model`` axis: one DP grid per
  model index, through ``psum`` and the point-to-point ``rd``; two mesh
  axes on one dimension shard it major to minor;
* the other families' mixers on the 2x2 mesh against ``mesh=None`` in the
  same world (gemma2's window and softcaps, granite's MQA, qwen2's QKV
  bias, RWKV6 with its norm's bf16 round trip taken out, jamba's Mamba +
  attention with dense FFNs and with its experts, deepseek-moe; the MoE
  ones at a capacity factor with no drops): loss and gradients at rtol
  1e-5, atol 1e-5 x max|g|.
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

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_world as tw  # noqa: E402


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's 4-device process and the port's 4-rank world, run
    side by side from the reference's initial parameters."""
    out = tmp_path_factory.mktemp("sharded")
    params = jax.jit(j_build(jreduced(J_MINICPM)).init)(
        jax.random.PRNGKey(0))
    leaves = jax.tree.leaves(params)
    np.savez(out / "params0.npz", **{
        f"leaf{i}": np.asarray(p) for i, p in enumerate(leaves)})
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    jproc = subprocess.Popen(
        [sys.executable, str(tw.__file__), "jax_sharded", str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        ranks = tw.spawn_world("sharded", out)
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
    return ranks, ref, len(leaves)


def test_forward_loss_and_grads_match(runs):
    ranks, ref, n = runs
    for r in ranks:
        np.testing.assert_allclose(r["loss0"], ref["loss0"], rtol=1e-5)
        for i in range(n):
            jg = ref[f"grad{i}"]
            np.testing.assert_allclose(
                r[f"grad{i}"], jg, rtol=1e-5,
                atol=1e-5 * float(np.abs(jg).max()), err_msg=str(i))


def test_local_shards_match_named_sharding(runs):
    ranks, ref, n = runs
    sharded = 0
    for i in range(n):
        want = ref[f"shapes{i}"]  # (devices, ndim), row-major device order
        for rank, r in enumerate(ranks):
            np.testing.assert_array_equal(r[f"shape{i}"], want[rank])
        sharded += int(np.any(want[0] != ref[f"init{i}"].shape))
    # the embedding (vocab on model, d on data) and the 7 projections;
    # the 3 norms are replicated
    assert sharded == 8


def test_two_axes_on_one_dim_shard_major_to_minor(runs):
    """``(("pod", "data"),)`` on a (2, 2) mesh: rank ``pod * 2 + data``
    holds the rows ``PartitionSpec(("pod", "data"))`` gives its device,
    not an interleaving."""
    ranks, _, _ = runs
    rows = np.arange(16, dtype=np.float32).reshape(8, 2)
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r["fsdp2"],
                                      rows[2 * rank:2 * rank + 2])


def test_train_steps_match(runs):
    ranks, ref, n = runs
    for r in ranks:
        assert np.all(np.isfinite(r["losses"]))
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-4)
        for i in range(n):
            np.testing.assert_allclose(r[f"param{i}"], ref[f"param{i}"],
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=str(i))


def test_mesh_run_equals_unmeshed_run(runs):
    ranks, _, _ = runs
    for r in ranks:
        assert r["mesh_losses"].shape == (4,)
        np.testing.assert_allclose(r["mesh_losses"], r["plain_losses"],
                                   rtol=1e-5)
        np.testing.assert_array_equal(r["mesh_losses"],
                                      ranks[0]["mesh_losses"])


def test_resume_on_the_mesh_is_bitwise(runs):
    ranks, _, _ = runs
    for r in ranks:
        np.testing.assert_array_equal(r["resumed_losses"],
                                      r["mesh_losses"][2:])
        np.testing.assert_array_equal(r["resumed_params"], r["mesh_params"])


def test_restore_across_layouts(runs):
    ranks, _, _ = runs
    for r in ranks:
        # written on the 2x2 mesh, restored with mesh=None
        np.testing.assert_array_equal(r["into_plain_params"],
                                      r["ckpt_params"])
        np.testing.assert_allclose(r["into_plain_losses"],
                                   r["mesh_losses"][2:], rtol=1e-5)
        # written with mesh=None (rank 0), restored on the mesh
        np.testing.assert_array_equal(r["into_mesh_params"],
                                      ranks[0]["plain_params"])


@pytest.mark.parametrize("name,bits", [("plain", None), ("int8", 8),
                                       ("int4", 4)])
def test_make_grad_sync_matches_reference(runs, name, bits):
    ranks, ref, _ = runs
    grads = tw.sync_grads_numpy(4)
    for k, g in grads.items():
        want = g.mean(axis=0)
        jg = ref[f"sync/{name}/{k}"]  # (4, ...): every chip's copy
        for c in range(1, 4):
            np.testing.assert_array_equal(jg[c], jg[0])
        for r in ranks:
            got = r[f"sync/{name}/{k}"]
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, ranks[0][f"sync/{name}/{k}"])
            if bits is None:
                assert np.allclose(got, jg[0]) and np.allclose(got, want), k
                continue
            qmax = 2 ** (bits - 1) - 1
            step = np.abs(jg[0].astype(np.float64)).max() / qmax
            assert np.abs(got - jg[0]).max() <= step * (1 + 1e-5) + 1e-12, k
            # the reference check's bound, in the units of the mean
            bound = np.abs(g).max() * 4 * (2.0 / 127) / 4
            assert np.abs(got - want).max() < bound * (127 / qmax), k
    assert ranks[0][f"sync/{name}/buckets"] >= 1


def test_topology_from_mesh_with_a_model_axis(runs):
    ranks, _, _ = runs
    # rank r holds r + 1; mesh (2, 2) row-major: the DP grid of model
    # index m is ranks {m, m + 2}
    for key in ("topo/data/psum", "topo/data/rd", "topo/pod/psum",
                "topo/pod/rd"):
        for rank, r in enumerate(ranks):
            m = rank % 2
            np.testing.assert_array_equal(r[key], np.full(5, 2 * m + 4.0))


@pytest.mark.parametrize("name", sorted(tw.mesh_family_configs()))
def test_family_on_the_mesh_equals_unmeshed(runs, name):
    ranks, _, _ = runs
    for r in ranks:
        key = f"family/{name}"
        np.testing.assert_allclose(r[f"{key}/mesh/loss"],
                                   r[f"{key}/plain/loss"], rtol=1e-5)
        n = sum(1 for k in r if k.startswith(f"{key}/plain/grad"))
        assert n > 0
        for i in range(n):
            want = r[f"{key}/plain/grad{i}"]
            np.testing.assert_allclose(
                r[f"{key}/mesh/grad{i}"], want, rtol=1e-5,
                atol=1e-5 * float(np.abs(want).max()), err_msg=f"{name} {i}")

