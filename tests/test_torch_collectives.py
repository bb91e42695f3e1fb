"""The port's allreduce engines on a 4-rank gloo world.

One world per module (``tests/_torch_world.py collectives``, a ``file://``
store under ``tmp_path``) runs the ``nap``, ``mla``, ``mla_pipelined`` and
``psum`` engines on the 2x2 and 4x1 grids for every op and ragged sizes,
and a compressed bucket sync with error feedback.  Each rank's result is
held against the JAX package's NumPy interpreters
(``napalg.simulate_allreduce`` / ``simulate_mla_allreduce``) and the numpy
reduction.  float32 sums are compared at rtol 1e-6 (the engines add in
another order than the float64 oracles); max/min exactly.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import napalg as jn

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_world as tw  # noqa: E402

WORLD = tw.WORLD


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return tw.spawn_world("collectives", tmp_path_factory.mktemp("gloo"))


CASES = [
    (n, ppn, engine, op, size)
    for n, ppn in tw.GRIDS
    for engine in tw.engines_for(n, ppn)
    for op in tw.OPS
    for size in tw.SIZES
]


@pytest.mark.parametrize("n,ppn,engine,op,size", CASES)
def test_engine_matches_oracle(world, n, ppn, engine, op, size):
    vals = tw.inputs(WORLD, size, size).astype(np.float64)
    if engine == "nap":
        want = jn.simulate_allreduce(jn.build_nap_schedule(n, ppn), vals, op)
    elif engine in ("mla", "mla_pipelined"):
        chunks = 3 if engine == "mla_pipelined" else 1
        want = jn.simulate_mla_allreduce(n, ppn, vals, op, chunks)
    else:
        red = {"sum": np.sum, "max": np.max, "min": np.min}[op]
        want = np.broadcast_to(red(vals, axis=0), vals.shape)
    for rank in range(WORLD):
        got = world[rank][f"{n}x{ppn}/{engine}/{op}/{size}"]
        assert got.shape == (size,) and got.dtype == np.float32
        if op == "sum":
            np.testing.assert_allclose(got, want[rank], rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want[rank].astype(np.float32))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n,ppn", tw.GRIDS)
def test_compressed_sync_and_error_feedback(world, n, ppn, bits):
    """Every rank gets the same mean; it is within the transport's error
    bound of the exact mean; and the residuals summed over the group are
    the whole quantisation error (exact distributed error feedback)."""
    qmax = 2 ** (bits - 1) - 1
    for i, vals in enumerate(tw.sync_leaves(WORLD)):
        outs = [world[r][f"{n}x{ppn}/sync{bits}/out{i}"] for r in range(WORLD)]
        errs = [world[r][f"{n}x{ppn}/sync{bits}/err{i}"] for r in range(WORLD)]
        for o in outs[1:]:
            np.testing.assert_array_equal(o, outs[0])
        exact = vals.astype(np.float64).sum(axis=0)
        got_sum = outs[0].astype(np.float64) * WORLD
        a = np.abs(vals).max()
        bound = WORLD * a / qmax * 2
        assert np.abs(got_sum - exact).max() <= bound
        err_sum = np.sum(errs, axis=0, dtype=np.float64)
        np.testing.assert_allclose(
            err_sum, exact - got_sum, rtol=0, atol=1e-5 * max(a, 1.0) * WORLD
        )
