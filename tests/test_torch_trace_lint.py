"""The trace lint (``repro_torch.analysis.trace_lint``), rule by rule, as
``tests/test_hlo_lint.py`` holds the reference's HLO lint: each rule stays
quiet on a clean trace and fires on a seeded fault, so it is never
vacuous.  The real program: the traced int4 / int8 DP train step over the
plain transport at one rank here (two transport launches a bucket: the
quantize round trip), and on the 2x2 gloo grid in
``tests/test_torch_uneven.py`` (four a bucket).
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.analysis import trace_lint as tl
from repro_torch.configs import MINICPM_2B, OptimizerConfig, reduced
from repro_torch.core import CommPolicy
from repro_torch.data import SyntheticLM
from repro_torch.kernels import transport
from repro_torch.launch import (init_train_state, make_dp_train_step,
                                mesh_topology)
from repro_torch.launch.trace_analysis import (CollectiveOp, Trace,
                                               analyze_trace, trace_call)

PPN = 4  # ranks 0-3 one node, 4-7 the other


def _op(index, kind, dtype, elems, group, groups, op="c10d.allreduce_"):
    return CollectiveOp(
        kind=kind, op=op, index=index, dtypes=(dtype,), shapes=((elems,),),
        elems=elems, bytes=float(elems * {"float32": 4, "int32": 4,
                                          "int8": 1, "uint8": 1}[dtype]),
        group_size=len(group), group=tuple(group),
        replica_groups=tuple(tuple(g) for g in groups), region="")


INTER = ((0, 4), (1, 5), (2, 6), (3, 7))
INTRA = ((0, 1, 2, 3), (4, 5, 6, 7))


def _trace(wire_dtype="int8", wire_groups=INTER, ops=None, rank=0):
    """A rank-0 trace of 8 ranks: the compressed inter-node wire and the
    legitimate intra-node float32 all-gather (the fast domain, ppn 4)."""
    cols = [
        _op(0, "all-reduce", wire_dtype, 288,
            next(g for g in wire_groups if rank in g), wire_groups),
        _op(1, "all-gather", "float32", 288, INTRA[0], INTRA,
            op="_c10d_functional.all_gather_into_tensor"),
    ]
    tr = Trace(rank=rank, world=8, collectives=cols)
    for key, n in (ops or {}).items():
        tr.ops[key] = n
    return tr


CLEAN = _trace()


def test_collective_ops_lists_kind_dtype_groups():
    cols = tl.collective_ops(CLEAN)
    assert [(c.kind, c.dtypes, c.elems) for c in cols] == [
        ("all-reduce", ("int8",), 288), ("all-gather", ("float32",), 288)]
    assert cols[0].replica_groups == INTER
    assert cols[1].group == (0, 1, 2, 3)


def test_expected_wire_dtype_bounds():
    assert tl.expected_wire_dtype(8) == "int8"
    assert tl.expected_wire_dtype(5) == "int8"
    assert tl.expected_wire_dtype(4) == "uint8"
    assert tl.expected_wire_dtype(2) == "uint8"
    with pytest.raises(ValueError):
        tl.expected_wire_dtype(9)


# -- wire dtypes -------------------------------------------------------------

def test_compressed_wire_clean_trace_passes():
    assert tl.lint_compressed_wire(CLEAN, bits=8, payload_elems=288,
                                   ppn=PPN) == []


def test_compressed_wire_missing_dtype_fires():
    # a 4-bit config must ship packed uint8: an int8 wire is the wrong width
    vs = tl.lint_compressed_wire(CLEAN, bits=4, payload_elems=288, ppn=PPN)
    assert any("uint8" in v.message for v in vs)
    assert all(v.rule == "wire-dtype" for v in vs)


def test_compressed_wire_wide_int_fires():
    tr = _trace("int32", ops={("aten.add", (((288,), "int32"),),
                               (((288,), "int32"),), ""): 1})
    vs = tl.lint_compressed_wire(tr, bits=8, payload_elems=288, ppn=PPN)
    assert any("wide-integer" in v.message for v in vs)
    # the payload-sized int32 screen fires too
    assert any("int32 tensor of 288" in v.message for v in vs)


def test_compressed_wire_int16_screen_fires():
    tr = _trace(ops={("aten._to_copy", (((288,), "int8"),),
                      (((288,), "int16"),), ""): 1})
    vs = tl.lint_compressed_wire(tr, bits=8, payload_elems=288, ppn=PPN)
    assert any("int16" in v.message for v in vs)


def test_compressed_wire_intra_node_float32_exempt_only_with_ppn():
    assert tl.lint_compressed_wire(CLEAN, bits=8, payload_elems=288,
                                   ppn=PPN) == []
    strict = tl.lint_compressed_wire(CLEAN, bits=8, payload_elems=288)
    assert any("payload-sized float32" in v.message for v in strict)


def test_compressed_wire_inter_node_float32_payload_fires():
    tr = _trace("float32")
    vs = tl.lint_compressed_wire(tr, bits=8, payload_elems=288, ppn=PPN)
    assert {v.rule for v in vs} == {"wire-dtype"}
    assert any("uncompressed wire" in v.message for v in vs)
    # sub-payload floats (scale exchange etc.) stay allowed
    small = _trace()
    small.collectives.append(_op(2, "all-reduce", "float32", 3, (0, 4),
                                 INTER))
    assert tl.lint_compressed_wire(small, bits=8, payload_elems=288,
                                   ppn=PPN) == []


# -- count budgets -----------------------------------------------------------

def test_collective_counts_on_kinds():
    assert tl.lint_collective_counts(
        CLEAN, {"all-reduce": 1, "all-gather": (0, 1)}) == []
    vs = tl.lint_collective_counts(CLEAN, {"all-reduce": 2})
    assert vs and vs[0].rule == "collective-count"
    assert "1 x 'all-reduce'" in vs[0].message


def test_collective_counts_on_kernel_launches():
    tr = Trace(events=[
        {"name": "transport.quantize_pack", "kind": "kernel"},
        {"name": "transport.unpack_dequantize", "kind": "kernel"},
        {"name": "attention.scores", "kind": "attn"},
    ])
    assert tl.lint_collective_counts(tr, {"transport": 2}) == []
    assert tl.lint_collective_counts(tr, {"transport.quantize_pack": 1}) == []
    vs = tl.lint_collective_counts(tr, {"transport": 4})
    assert vs and "budget 4" in vs[0].message


def test_assert_clean_raises_with_listing():
    vs = tl.lint_collective_counts(Trace(), {"transport": 1})
    with pytest.raises(AssertionError, match="transport"):
        tl.assert_clean(vs, "ctx")
    tl.assert_clean([], "ctx")  # no-op when clean


# -- replica groups ----------------------------------------------------------

def test_replica_groups_clean_partition_passes():
    assert tl.lint_replica_groups(CLEAN, num_devices=8) == []


def test_replica_groups_overlap_fires():
    tr = _trace(wire_groups=((0, 1), (1, 2), (3, 4), (5, 6, 7)))
    vs = tl.lint_replica_groups(tr, num_devices=8)
    assert any("overlap" in v.message and "[1]" in v.message for v in vs)
    assert all(v.rule == "replica-groups" for v in vs)


def test_replica_groups_gap_fires():
    tr = Trace(world=4, collectives=[_op(0, "all-reduce", "float32", 16,
                                         (0, 1), ((0, 1),))])
    vs = tl.lint_replica_groups(tr, num_devices=4)
    assert any("gap" in v.message and "[2, 3]" in v.message for v in vs)


def test_replica_groups_out_of_range_fires():
    tr = Trace(world=4, collectives=[_op(0, "all-reduce", "float32", 16,
                                         (0, 1), ((0, 1), (2, 9)))])
    vs = tl.lint_replica_groups(tr, num_devices=4)
    assert any("outside" in v.message and "[9]" in v.message for v in vs)
    assert any("gap" in v.message and "[3]" in v.message for v in vs)


def test_replica_groups_own_group_only():
    ok = Trace(rank=1, world=4, collectives=[_op(0, "all-reduce", "float32",
                                                 16, (0, 1), ())])
    assert tl.lint_replica_groups(ok, num_devices=4) == []
    not_mine = Trace(rank=2, world=4, collectives=ok.collectives)
    assert tl.lint_replica_groups(not_mine, num_devices=4)


# -- stable trace ------------------------------------------------------------

def test_stable_trace_clean_on_a_pure_function():
    assert tl.lint_stable_trace(lambda x: x * 2.0 + 1.0,
                                torch.zeros(4)) == []


def test_stable_trace_fires_on_host_state():
    """A step whose program depends on a host counter traces differently
    every time."""
    state = {"n": 0}

    def unstable(x):
        state["n"] += 1
        for _ in range(state["n"]):
            x = x + 1.0
        return x

    vs = tl.lint_stable_trace(unstable, torch.zeros(4))
    assert vs and vs[0].rule == "stable-trace"
    assert "host state" in vs[0].message


# -- the real program at one rank -------------------------------------------

OPT = OptimizerConfig(lr=1e-3, schedule="constant", warmup_steps=1)


def _dp_step(bits, extra_launch=False):
    cfg = reduced(MINICPM_2B)
    pol = CommPolicy(algorithm="nap", mean=True, compress_bits=bits,
                     error_feedback=True, transport_impl="plain")
    step = make_dp_train_step(cfg, OPT, mesh_topology(1, 1), pol,
                              device="cpu")
    state = init_train_state(cfg, OPT, pol,
                             generator=torch.Generator().manual_seed(0),
                             device="cpu")
    data = SyntheticLM(cfg.vocab_size, 16, 4, seed=0)

    def run(state, batch):
        out = step(state, batch)
        if extra_launch:  # a fifth launch a bucket's budget does not allow
            transport.quantize_pack(torch.ones(1, 256), torch.ones(1),
                                    offsets=(0,), bits=bits, impl="plain")
        return out

    _, trace = trace_call(run, state, data.batch(0, "cpu"))
    return step, state, data, trace


@pytest.mark.parametrize("bits", [4, 8])
def test_dp_step_at_one_rank_is_clean(bits):
    step, state, data, trace = _dp_step(bits)
    buckets = step.plan.num_buckets
    tl.assert_clean(tl.lint_compressed_wire(trace, bits=bits), "wire")
    tl.assert_clean(tl.lint_replica_groups(trace, num_devices=1), "groups")
    tl.assert_clean(tl.lint_collective_counts(
        trace, {"transport.quantize_pack": buckets,
                "transport.unpack_dequantize": buckets}), "counts")
    tl.assert_clean(tl.lint_stable_trace(step, state, data.batch(1, "cpu")),
                    "stable")
    # the plain route's ops inside the regions add nothing: the transport's
    # bytes are its declared ones, and so are AdamW's two kernels'
    st = analyze_trace(trace)
    assert st.kernel_launches == {"transport.quantize_pack": buckets,
                                  "transport.unpack_dequantize": buckets,
                                  "adamw.sq_norm": 1, "adamw.apply": 1}
    assert not any(key[0].startswith("aten.bitwise") for key in trace.ops)


def test_dp_step_extra_transport_launch_fires():
    step, _, _, trace = _dp_step(4, extra_launch=True)
    vs = tl.lint_collective_counts(
        trace, {"transport": 2 * step.plan.num_buckets})
    assert vs and vs[0].rule == "collective-count"
