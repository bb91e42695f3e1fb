"""The port's schedules, cost model, planner and dispatch against the JAX
package's, over n in {1,2,3,4,5,7,8,13,16} x ppn in 1..4.

Pure host-side code on both sides: equal inputs must give equal outputs
(schedules field for field, costs and crossovers exactly, dispatch
decisions and bucket plans exactly).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.core import bucketing as jb
from repro.core import comm as jc
from repro.core import napalg as jn
from repro.core import perf_model as jp
from repro_torch.core import bucketing as tb
from repro_torch.core import comm as tc
from repro_torch.core import napalg as tn
from repro_torch.core import perf_model as tp

NS = (1, 2, 3, 4, 5, 7, 8, 13, 16)
GRIDS = [(n, ppn) for n in NS for ppn in range(1, 5)]
SIZES = (8, 100, 4096, 65_536, 1 << 20, 1 << 24, 3 * (1 << 26))


def _same_params(params):
    return tp.MachineParams(**dataclasses.asdict(params))


@pytest.mark.parametrize("n,ppn", GRIDS)
def test_schedules_equal(n, ppn):
    if n == 1 or ppn >= 2:
        assert dataclasses.asdict(tn.build_nap_schedule(n, ppn)) == (
            dataclasses.asdict(jn.build_nap_schedule(n, ppn))
        )
        assert tn.nap_num_steps(n, ppn) == jn.nap_num_steps(n, ppn)
        for a, b in zip(tn.step_mask_tables(n, ppn),
                        jn.step_mask_tables(n, ppn)):
            assert all(np.array_equal(x, y) for x, y in zip(a[0], b[0]))
            assert np.array_equal(a[1], b[1])
    for elems in (None, 19, 1000):
        assert dataclasses.asdict(tn.build_mla_schedule(n, ppn, elems)) == (
            dataclasses.asdict(jn.build_mla_schedule(n, ppn, elems))
        )
        for chunks in (1, 2, 3):
            assert dataclasses.asdict(
                tn.build_mla_pipelined_schedule(n, ppn, chunks, elems)
            ) == dataclasses.asdict(
                jn.build_mla_pipelined_schedule(n, ppn, chunks, elems)
            )
    for elems in (0, 1, 19, 1000, 12345):
        assert tn.mla_stripe_geometry(n, ppn, elems) == (
            jn.mla_stripe_geometry(n, ppn, elems)
        )
        for name in ("mla_internode_lower_bound", "rs_internode_lower_bound",
                     "ag_internode_lower_bound"):
            assert getattr(tn, name)(n, ppn, elems) == (
                getattr(jn, name)(n, ppn, elems)
            )


@pytest.mark.parametrize("n,ppn", GRIDS)
def test_costs_crossover_and_bucket_size_equal(n, ppn):
    for params in (jp.TPU_V5E_POD, jp.BLUE_WATERS):
        tparams = _same_params(params)
        jt_ = jc.Topology.of(n, ppn, params=params)
        tt_ = tc.Topology.of(n, ppn, params=tparams)
        assert tt_.crossover_bytes() == jt_.crossover_bytes()
        for s in SIZES:
            for name in ("cost_nap", "cost_mla", "cost_psum", "cost_rd"):
                assert getattr(tp, name)(s, n, ppn, tparams) == (
                    getattr(jp, name)(s, n, ppn, params)
                )
            assert tp.cost_mla_pipelined(s, n, ppn, tparams) == (
                jp.cost_mla_pipelined(s, n, ppn, params)
            )
            assert tt_.optimal_pipeline_chunks(s) == (
                jt_.optimal_pipeline_chunks(s)
            )
            assert tt_.optimal_bucket_bytes(s) == jt_.optimal_bucket_bytes(s)
            assert tp.dispatched_allreduce_cost(s, n, ppn, tparams) == (
                jp.dispatched_allreduce_cost(s, n, ppn, params)
            )


@pytest.mark.parametrize("n,ppn", GRIDS)
def test_select_engine_equal(n, ppn):
    jt_, tt_ = jc.Topology.of(n, ppn), tc.Topology.of(n, ppn)
    for s in SIZES:
        for op in ("sum", "max", "min"):
            for thr in (None, 0, 4096, 1 << 30):
                for pin in (None, 1, 3):
                    kw = dict(small_threshold_bytes=thr, pipeline_chunks=pin)
                    assert tuple(tc.select_engine(tt_, s, op, **kw)) == tuple(
                        jc.select_engine(jt_, s, op, **kw)
                    ), (s, op, thr, pin)


@pytest.mark.parametrize("total", [0, 1, 7, 19, 256, 1000, 12345])
def test_ragged_splits_equal(total):
    for k in range(1, 9):
        assert tn.ragged_splits(total, k) == jn.ragged_splits(total, k)
        assert tn.chunk_offsets(total, k) == jn.chunk_offsets(total, k)
        assert tn.chunk_alignment([total, 3, 5], k) == (
            jn.chunk_alignment([total, 3, 5], k)
        )


@pytest.mark.parametrize("n,ppn", [(1, 1), (2, 2), (4, 1), (3, 4), (8, 2)])
@pytest.mark.parametrize("bits", [None, 4, 8])
def test_bucket_plans_equal(n, ppn, bits):
    """Plans of the minicpm-2b parameter tree (4 layers, bf16 and f32
    leaves) and of its reduced f32 twin must be identical."""
    import jax

    from repro.configs.archs import MINICPM_2B, reduced as jreduced
    from repro.core import grad_sync as jg
    from repro.models import build_model as jbuild
    from repro_torch.configs import MINICPM_2B_4L, reduced as treduced
    from repro_torch.core import grad_sync as tg
    from repro_torch.models import init_params

    pairs = [
        (dataclasses.replace(MINICPM_2B, num_layers=4), MINICPM_2B_4L),
        (jreduced(MINICPM_2B), treduced(MINICPM_2B_4L)),
    ]
    for jcfg, tcfg in pairs:
        sds = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
        for algo in ("auto", "nap", "mla"):
            jplan = jg.plan_for_tree(
                sds, cfg=jc.CommPolicy(algorithm=algo, compress_bits=bits),
                topology=jc.Topology.of(n, ppn),
            )
            tplan = tg.plan_for_tree(
                init_params(tcfg, device="meta"),
                cfg=tc.CommPolicy(algorithm=algo, compress_bits=bits),
                topology=tc.Topology.of(n, ppn),
            )
            assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan)


def test_minicpm_plan_at_one_rank_has_nine_buckets():
    """The main path's plan: bf16 leaves never fuse (the reference's
    numpy-based fusibility rule), so 8 single-leaf buckets plus one bucket
    of the three f32 norms."""
    from repro_torch.configs import MINICPM_2B_4L
    from repro_torch.core import grad_sync as tg
    from repro_torch.models import init_params

    plan = tg.plan_for_tree(
        init_params(MINICPM_2B_4L, device="meta"),
        cfg=tc.CommPolicy(algorithm="nap", compress_bits=4),
        topology=tc.Topology.of(1, 1),
    )
    assert plan.num_buckets == 9
    assert sorted(len(b.leaves) for b in plan.buckets) == [1] * 8 + [3]
    assert max(b.elems for b in plan.buckets) == 122_753 * 2304


def test_leaf_specs_equal_for_mixed_dtypes():
    import jax.numpy as jnp

    shapes = [((3, 5), "float32"), ((7,), "bfloat16"), ((2, 2), "int32"),
              ((), "float16")]
    jl = [jnp.zeros(s, d) for s, d in shapes]
    tl = [torch.zeros(s, dtype=getattr(torch, d)) for s, d in shapes]
    fn = lambda dt, fusible: 0.5 if fusible else None
    assert [dataclasses.asdict(s) for s in tb.leaf_specs_for(
        tl, transport_itemsize_fn=fn)] == [
        dataclasses.asdict(s)
        for s in jb.leaf_specs_for(jl, transport_itemsize_fn=fn)
    ]


def test_simulators_equal():
    rng = np.random.default_rng(0)
    for n, ppn in [(2, 2), (5, 3), (4, 1), (7, 2)]:
        v = rng.standard_normal((n * ppn, 23))
        if ppn >= 2 or n == 1:
            for op in ("sum", "max", "min"):
                np.testing.assert_array_equal(
                    tn.simulate_allreduce(tn.build_nap_schedule(n, ppn), v, op),
                    jn.simulate_allreduce(jn.build_nap_schedule(n, ppn), v, op),
                )
        for chunks in (1, 3):
            np.testing.assert_array_equal(
                tn.simulate_mla_allreduce(n, ppn, v, "sum", chunks),
                jn.simulate_mla_allreduce(n, ppn, v, "sum", chunks),
            )
    assert math.isinf(tc.Topology.of(1, 4).crossover_bytes())
