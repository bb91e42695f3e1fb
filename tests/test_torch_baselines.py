"""The port's baseline allreduce engines (``rd``, ``smp``, ``ring``,
``rabenseifner``), the NAP extensions and the striped engines' inter-node
bytes, on gloo worlds of 4 and 6 ranks.

``tests/_torch_world.py baselines`` runs on a 4-rank world (grids 2x2,
4x1, 1x4) and on a 6-rank world (3x2, 2x3, 6x1: not powers of two, prime
node counts), each with its own ``file://`` store under ``tmp_path``, one
after the other.  Each rank's result is held against the numpy reduction
(float32 sums at rtol 1e-6, max / min and integer-valued bf16 sums
bitwise).  The inter-node elements each rank sends in the ``mla``,
``mla_rs`` and ``mla_ag`` engines, counted at the group primitives, are
held against ``napalg``'s lower bounds and against the ported simulator's
replay of the engines' schedules.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import napalg as jn
from repro_torch.core import comm as tc
from repro_torch.core import simulator as tsim

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_world as tw  # noqa: E402

WORLDS = (4, 6)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {w: tw.spawn_world("baselines", tmp_path_factory.mktemp(f"g{w}"),
                              world=w)
            for w in WORLDS}


def _ranks(res, key):
    return np.stack([r[key] for r in res])


GRIDS = [(w, n, ppn) for w in WORLDS for n, ppn in tw.BASELINE_GRIDS[w]]
RED = {"sum": np.sum, "max": np.max, "min": np.min}


@pytest.mark.parametrize("op", tw.OPS)
@pytest.mark.parametrize("eng", tw.BASELINES)
@pytest.mark.parametrize("w,n,ppn", GRIDS)
def test_baseline_matches_oracle(worlds, w, n, ppn, eng, op):
    for size in tw.SIZES:
        vals = tw.inputs(w, size, size)
        want = np.broadcast_to(
            RED[op](vals.astype(np.float64), axis=0), vals.shape)
        got = _ranks(worlds[w], f"{n}x{ppn}/{eng}/{op}/{size}")
        assert got.shape == vals.shape and got.dtype == np.float32
        if op == "sum":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want.astype(np.float32))


@pytest.mark.parametrize("eng", tw.BASELINES)
@pytest.mark.parametrize("w,n,ppn", GRIDS)
def test_baseline_bf16_sum_is_exact(worlds, w, n, ppn, eng):
    """Integer-valued bf16 payloads: every partial sum is exact in bf16,
    so every rank returns the sum bit for bit."""
    for size in tw.SIZES:
        vals = tw.rsag_inputs(w, size, size, "bfloat16", "sum")
        got = _ranks(worlds[w], f"{n}x{ppn}/{eng}/bf16/{size}")
        np.testing.assert_array_equal(
            got, np.broadcast_to(vals.sum(axis=0), vals.shape))


@pytest.mark.parametrize("w,n,ppn", GRIDS)
def test_extensions_match_oracle(worlds, w, n, ppn):
    res = worlds[w]
    ok = bool(res[0][f"{n}x{ppn}/ext/supported"])
    assert ok == ((n == 1) or (ppn >= 2 and any(
        ppn ** k == n for k in range(1, 8))))
    if not ok:
        # the worker checked that all three raise ValueError here
        assert not any(k.startswith(f"{n}x{ppn}/ext/all") for k in res[0])
        return
    for size in tw.SIZES:
        vals = tw.inputs(w, size, size)
        for r in range(w):
            np.testing.assert_array_equal(
                res[r][f"{n}x{ppn}/ext/allgather/{size}"], vals)
        rows = tw.inputs(w, w * size, size + 2).reshape(w, w, size)
        for r in range(w):
            got = res[r][f"{n}x{ppn}/ext/reduce_scatter/{size}"]
            assert got.shape == (1, size)
            np.testing.assert_allclose(
                got[0], rows[:, r].astype(np.float64).sum(axis=0),
                rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(
                res[r][f"{n}x{ppn}/ext/allreduce_large/{size}"],
                vals.astype(np.float64).sum(axis=0), rtol=1e-6, atol=1e-6)


BOUNDS = {
    "mla": ("allreduce", jn.mla_internode_lower_bound),
    "mla_rs": ("reduce_scatter", jn.rs_internode_lower_bound),
    "mla_ag": ("allgather", jn.ag_internode_lower_bound),
}


@pytest.mark.parametrize("eng", sorted(BOUNDS))
@pytest.mark.parametrize("w,n,ppn", [g for g in GRIDS if g[1] >= 2])
def test_internode_elements_equal_the_lower_bound(worlds, w, n, ppn, eng):
    """Each rank's executed inter-node elements against the uneven-block
    lower bound: equal where the payload divides over the grid (the
    executed engines pad every block to one size), never below it; and
    the bound equals the ported simulator's replay of the schedule."""
    collective, bound = BOUNDS[eng]
    topo = tc.Topology.of(n, ppn)
    for size in tw.COUNT_SIZES:
        lb = bound(n, ppn, size)
        assert topo.internode_lower_bound(size, collective) == lb
        sched = topo.schedule(eng, elems=size)
        replay = tsim.replay_internode_bytes(sched, 4.0 * size)
        assert replay.max() == pytest.approx(4.0 * lb, rel=1e-12)
        counts = np.array([int(r[f"{n}x{ppn}/count/{eng}/{size}"])
                           for r in worlds[w]])
        if size % (n * ppn) == 0:
            np.testing.assert_array_equal(counts, lb)
            np.testing.assert_allclose(replay, 4.0 * counts, rtol=1e-12)
        else:
            assert (counts >= lb).all()
