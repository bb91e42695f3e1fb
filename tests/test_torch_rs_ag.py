"""The port's reduce-scatter / allgather engines and its sharded gradient
sync on a 4-rank gloo world, against the JAX package's.

One world per module (``tests/_torch_world.py rs_ag``, a ``file://`` store
under ``tmp_path``) runs ``mla_rs`` / ``psum_scatter`` / ``mla_ag`` /
``all_gather`` and the dispatched choice on the 2x2, 4x1 and 1x4 grids,
every op, float32 / bf16 / int32, sizes 1 / 7 / 23 / 1000, AG after RS,
and ``sync_grads_sharded`` + ``unshard_grads`` (plain, int8, int4, mean on
and off; float32, bf16 and int32 leaves).  One process of the JAX package
(``jax_rs_ag``, 4 virtual CPU devices) runs the reference's
``CommContext.reduce_scatter`` / ``allgather`` and its
``sync_grads_sharded`` / ``unshard_grads`` in a ``shard_map`` with
``check_vma=False``, its transport on the jnp reference
(``impl="xla"``), recording every quantize-pack's wire bytes.

Tolerances: integer and integer-valued payloads, allgathers and wire bytes
bitwise; random float32 at rtol 1e-6 (sums in another order); a bf16
leaf at one bf16 step (a single-node bf16 reduce-scatter sums in bf16, as
the reference's does, in another order).  On 4x1 the reference's fused
NAP-max raises (NAP needs two lanes), so its side agrees the same maxima
with one ``pmax`` there.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_world as tw  # noqa: E402

WORLD = tw.WORLD
HERE = Path(__file__).resolve().parent


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return tw.spawn_world("rs_ag", tmp_path_factory.mktemp("gloo"))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax")
    env = {"JAX_PLATFORMS": "cpu", "PYTHONPATH": str(tw.SRC)}
    import os

    proc = subprocess.run(
        [sys.executable, str(HERE / "_torch_world.py"), "jax_rs_ag",
         str(out)],
        env=dict(os.environ, **env), capture_output=True, text=True,
        timeout=600,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with np.load(out / "jax.npz") as z:
        return {k: z[k] for k in z.files}


def _ranks(world, key):
    return np.stack([world[r][key] for r in range(WORLD)])


def _same(got, want, kind):
    assert got.shape == want.shape and got.dtype == want.dtype
    if kind == "exact":
        np.testing.assert_array_equal(got, want)
        return
    rtol = 2.0 ** -8 if kind == "bfloat16" else 1e-6
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


RS_CASES = [
    (n, ppn, eng, dtype, op, size)
    for n, ppn in tw.RSAG_GRIDS
    for eng in tw.rs_engines(n)
    for dtype in tw.DTYPES
    for op in tw.OPS
    for size in tw.SIZES
]


@pytest.mark.parametrize("n,ppn,eng,dtype,op,size", RS_CASES)
def test_reduce_scatter_matches_jax(world, ref, n, ppn, eng, dtype, op,
                                    size):
    key = f"{n}x{ppn}/rs/{eng}/{dtype}/{op}/{size}"
    got = _ranks(world, key)
    # rank (node j, lane r) owns ceil(ceil(e/ppn)/n) elements
    assert got.shape == (WORLD, tw.shard_len(size, WORLD))
    exact = dtype != "float32" or op != "sum"
    _same(got, ref[key], "exact" if exact else "float32")


AG_CASES = [
    (n, ppn, eng, dtype, size)
    for n, ppn in tw.RSAG_GRIDS
    for eng in tw.ag_engines(n)
    for dtype in tw.DTYPES
    for size in tw.SIZES
]


@pytest.mark.parametrize("n,ppn,eng,dtype,size", AG_CASES)
def test_allgather_matches_jax(world, ref, n, ppn, eng, dtype, size):
    key = f"{n}x{ppn}/ag/{eng}/{dtype}/{size}"
    got = _ranks(world, key)
    assert got.shape == (WORLD, size)
    _same(got, ref[key], "exact")


@pytest.mark.parametrize("n,ppn", tw.RSAG_GRIDS)
@pytest.mark.parametrize("dtype", tw.DTYPES)
def test_allgather_after_reduce_scatter_is_the_sum(world, n, ppn, dtype):
    for size in tw.SIZES:
        vals = tw.rsag_inputs(WORLD, size, size, dtype, "sum")
        exact = vals.astype(np.float64).sum(axis=0)
        for rs in ("mla_rs", "psum_scatter"):
            if n < 2 and rs == "mla_rs":
                continue
            got = _ranks(world, f"{n}x{ppn}/agrs/{rs}/{dtype}/{size}")
            want = np.broadcast_to(exact, got.shape).astype(got.dtype)
            _same(got, want, "float32" if dtype == "float32" else "exact")


def test_dispatch_takes_the_striped_engines_across_nodes(world, ref):
    """``auto`` picks ``mla_rs`` / ``mla_ag`` with a slow domain and the
    flat fallbacks without one: equal outputs show the same choice."""
    for n, ppn in tw.RSAG_GRIDS:
        striped = n >= 2
        for size in tw.SIZES:
            auto = _ranks(world, f"{n}x{ppn}/rs/auto/int32/max/{size}")
            eng = "mla_rs" if striped else "psum_scatter"
            np.testing.assert_array_equal(
                auto, _ranks(world, f"{n}x{ppn}/rs/{eng}/int32/max/{size}"))


SHARDED = [
    (n, ppn, name)
    for n, ppn in tw.RSAG_GRIDS
    for name, _ in tw.SHARDED_POLICIES
]


@pytest.mark.parametrize("n,ppn,name", SHARDED)
def test_sync_grads_sharded_matches_jax(world, ref, n, ppn, name):
    vals, dtypes = tw.sharded_leaves(WORLD)
    key = f"{n}x{ppn}/sharded/{name}"
    for i, (v, dtype) in enumerate(zip(vals, dtypes)):
        shard = _ranks(world, f"{key}/shard{i}")
        full = _ranks(world, f"{key}/full{i}")
        assert shard.shape == (WORLD, tw.shard_len(v.shape[1], WORLD))
        assert full.shape == v.shape
        kind = {"int32": "exact"}.get(dtype, dtype)
        _same(shard, ref[f"{key}/shard{i}"], kind)
        _same(full, ref[f"{key}/full{i}"], kind)
        # every rank holds the same full leaf, and the shards tile it
        for r in range(1, WORLD):
            np.testing.assert_array_equal(full[r], full[0])
    wires = sorted(k for k in world[0] if k.startswith(f"{key}/wire"))
    assert wires == sorted(k for k in ref if k.startswith(f"{key}/wire"))
    # the RS half quantizes once per float leaf, and only across nodes
    compressed = "int" in name and n > 1
    assert len(wires) == (4 if compressed else 0)
    for k in wires:
        np.testing.assert_array_equal(_ranks(world, k), ref[k])


@pytest.mark.parametrize("n,ppn", tw.RSAG_GRIDS)
def test_sharded_integer_leaf_is_exact(world, n, ppn):
    """The int32 leaf: its sum is exact, its mean ``round(sum / 4)`` with
    ties to even, through every policy."""
    vals, _ = tw.sharded_leaves(WORLD)
    total = vals[-1].astype(np.int64).sum(axis=0)
    for name, kw in tw.SHARDED_POLICIES:
        full = _ranks(world, f"{n}x{ppn}/sharded/{name}/full4")[0]
        want = (np.round(total.astype(np.float32) / np.float32(WORLD))
                if kw["mean"] else total)
        np.testing.assert_array_equal(full, want.astype(np.int32))


@pytest.mark.parametrize("bits", [4, 8])
def test_sharded_compressed_error_is_within_the_wire_bound(world, bits):
    """The int-b shard sums stay within the quantizer's step of the exact
    sum: each of the n copies of a block rounds by at most half a step of
    ``ppn`` times the leaf's absmax over qmax."""
    vals, _ = tw.sharded_leaves(WORLD)
    qmax = 2 ** (bits - 1) - 1
    for n, ppn in tw.RSAG_GRIDS:
        name = f"int{bits}_mean"
        for i in range(3):
            exact = vals[i].astype(np.float64).mean(axis=0)
            got = _ranks(world, f"{n}x{ppn}/sharded/{name}/full{i}")[0]
            step = ppn * np.abs(vals[i]).max() / qmax
            # plus float32 rounding of the sums (all of it with one node)
            bound = (n * step / 2 if n > 1 else 0.0) / WORLD + (
                1e-6 * np.abs(exact).max())
            assert np.abs(got - exact).max() <= bound
