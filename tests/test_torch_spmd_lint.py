"""The port's SPMD lint (``repro_torch.analysis.spmd_lint``) against the
reference's (``repro.analysis.spmd_lint``), as ``tests/test_spmd_lint.py``
holds the reference's:

* **parity** — every registered engine's program, traced as every rank of
  each grid of the ``--spmd`` sweep in float32 and bfloat16, lints clean,
  and its inter-node bytes per chip and declared bound equal the
  reference's ``lint_lowering`` report on the same cell; the compressed
  grad sync's bytes equal the reference's jaxpr lint of it;
* **mutation** — one port counterpart to each rule test of the
  reference: each rule fires on a seeded fault and stays quiet on its
  clean twin.  The reference's rank-dependent ``cond`` becomes a host
  read of an un-reduced value or a branch on the rank in plain Python;
  its ``shard_map`` shadowing becomes ``dist.new_group`` inside the
  traced call;
* **the gates** — verify- and lint-on-register reject and roll back, and
  leave a live default process group as it was.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.analysis import spmd_lint
from repro_torch.core import collectives, comm, grad_sync, napalg
from repro_torch.core.collectives import _all_reduce, _ppermute
from repro_torch.kernels import transport

GRIDS = ((2, 2), (3, 2), (2, 4))  # the --spmd sweep's
DTYPES = ("float32", "bfloat16")
# rank 0 (node 0) <-> rank 2 (node 1), rank 1 <-> rank 3, on 2 x 2
ACROSS = [(0, 2), (2, 0), (1, 3), (3, 1)]


def _lint(fn, *args, n=2, p=2, **kw):
    return spmd_lint.lint_traced(fn, *args, n_nodes=n, ppn=p, **kw)


def _rules(report):
    return {v.rule for v in report.violations}


def _cells():
    for key in sorted(comm.registered_engines()):
        spec = comm.registered_engines()[key]
        for (n, p), dt in itertools.product(GRIDS, DTYPES):
            if n >= spec.min_nodes and p >= spec.min_ppn:
                yield key, n, p, dt


# ---------------------------------------------------------------------------
# parity: every engine's program lints clean, bytes equal the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_comm():
    from repro.core import comm as ref

    return ref


@pytest.mark.parametrize("key,n,p,dt", list(_cells()),
                         ids=lambda v: str(v))
def test_engine_program_lints_clean_with_reference_bytes(ref_comm, key, n,
                                                         p, dt):
    name = key.split(":", 1)[1]
    port = comm.lint_lowering(name, n_nodes=n, ppn=p, dtype=dt,
                              raise_on_violation=False)
    spmd_lint.assert_spmd_clean(port)
    assert port.collectives > 0
    ref = ref_comm.lint_lowering(name, n_nodes=n, ppn=p, dtype=dt,
                                 raise_on_violation=False)
    assert ref.ok
    # exactly equal where both are numbers, both None where the
    # reference's is None
    assert port.internode_bytes_per_chip == ref.internode_bytes_per_chip
    assert port.declared_bytes == ref.declared_bytes
    # the collectives a rank issues: the reference's jaxpr holds the
    # ring's p - 1 shifts of each half in one loop, the port's host loop
    # issues each (ROADMAP Queue 3, kept on purpose)
    want = 2 * (n * p - 1) if name == "ring" else ref.collectives
    assert port.collectives == want


@pytest.mark.parametrize("bits", [8, 4])
def test_grad_sync_bytes_match_reference(bits):
    """The compressed fused-bucket sync on 2 x 4 (the --spmd sweep's cell):
    the port's per-rank traces and the reference's shard-level jaxpr give
    the same inter-node bytes per chip."""
    import jax
    import jax.numpy as jnp

    from repro.analysis import spmd_lint as ref_lint
    from repro.core import comm as rc, grad_sync as rg

    sizes = (64, 96, 128)
    topo = rc.Topology(2, 4, inter_axes=("pod",), intra_axes=("data",))
    pol = rc.CommPolicy(algorithm="nap", mean=True, compress_bits=bits)
    ctx = rc.CommContext(topo, pol)
    sds = [jax.ShapeDtypeStruct((s,), jnp.float32) for s in sizes]
    plan = rg.plan_for_tree(sds, cfg=pol, topology=topo)
    closed = jax.make_jaxpr(
        lambda *ls: jnp.concatenate(
            rg.sync_with_context(list(ls), ctx, plan=plan)),
        axis_env=[("pod", 2), ("data", 4)])(*sds)
    ref = ref_lint.lint_jaxpr(closed, axis_sizes={"pod": 2, "data": 4},
                              inter_axes=("pod",), intra_axes=("data",))

    policy = comm.CommPolicy(algorithm="nap", mean=True, compress_bits=bits)

    def sync(topo, *leaves):
        ctx = comm.CommContext(topo, policy)
        plan = grad_sync.plan_for_tree(list(leaves), cfg=policy,
                                       topology=topo)
        return grad_sync.sync_with_context(list(leaves), ctx, plan=plan)

    port = _lint(sync, *[torch.zeros(s) for s in sizes], n=2, p=4)
    spmd_lint.assert_spmd_clean(port)
    assert ref.ok
    assert port.internode_bytes_per_chip == ref.internode_bytes_per_chip


def test_every_rank_is_traced_and_differs():
    """NAP on 2 x 2: ranks 1 and 2 exchange across the nodes, ranks 0 and
    3 do not: the programs differ from rank to rank, and the lint holds
    them all."""
    x = torch.zeros(16)
    traces = spmd_lint.trace_ranks(
        lambda topo, v: collectives.nap_allreduce(v, topology=topo), x,
        n_nodes=2, ppn=2)
    sent = [sum(1 for r in tr.rounds for e in r if e[0] == "send")
            for tr in traces]
    assert sent == [0, 1, 1, 0]
    assert spmd_lint.lint_ranks(traces).ok


# ---------------------------------------------------------------------------
# mutation: collective-uniformity (the static hang detector)
# ---------------------------------------------------------------------------


def test_collective_after_rank_varying_read_fires():
    def bad(topo, x):
        g = topo.require_groups()
        if x.sum().item() > 0:  # this rank's own data steers the branch
            return _all_reduce(x, g.world, "sum")
        return _all_reduce(x, g.world, "sum") * 0.0

    report = _lint(bad, torch.zeros(8))
    assert "collective-uniformity" in _rules(report)


def test_collective_in_a_loop_whose_trip_count_varies_fires():
    def bad(topo, x):
        g = topo.require_groups()
        while x.sum().item() < 1.0:
            x = _all_reduce(x, g.inter, "sum") + 1.0
        return x

    report = _lint(bad, torch.zeros(8))
    assert "collective-uniformity" in _rules(report)


def test_collective_after_uniform_read_is_clean():
    def good(topo, x):
        g = topo.require_groups()
        agreed = _all_reduce(x, g.world, "sum")  # the whole group's sum
        if agreed.sum().item() > 0.0:
            return _all_reduce(agreed, g.inter, "sum") + 1.0
        return _all_reduce(agreed, g.inter, "sum") - 1.0

    report = _lint(good, torch.zeros(8))
    assert report.ok, report.violations


# ---------------------------------------------------------------------------
# mutation: axis discipline
# ---------------------------------------------------------------------------


def test_asymmetric_branches_fire():
    def bad(topo, x):
        g = topo.require_groups()
        y = _all_reduce(x, g.world, "sum")
        if g.intra.index == 0:  # lane 0 of each node: one more all-reduce
            y = _all_reduce(y, g.intra, "sum")
        return y

    report = _lint(bad, torch.zeros(8))
    assert {"axis-discipline", "collective-uniformity"} <= _rules(report)


def test_unbound_group_fires():
    """A collective on a process group the topology does not own."""

    def bad(topo, x):
        g = topo.require_groups()
        other = spmd_lint.fake_group(g.rank % 2, 2, "model")
        y = x.clone()
        dist.all_reduce(y, group=other)
        return y

    report = _lint(bad, torch.zeros(8))
    assert "axis-discipline" in _rules(report)


def test_new_group_inside_the_call_fires():
    """The counterpart of the reference's shard_map shadowing: a group
    made inside the traced call rebinds a communicator the caller's
    topology does not own.  The same collective on the topology's own
    group is clean."""

    def bad(topo, x):
        pg = dist.new_group([0, 1, 2, 3])
        y = x.clone()
        dist.all_reduce(y, group=pg)
        return y

    def good(topo, x):
        y = x.clone()
        dist.all_reduce(y, group=topo.require_groups().world.handle)
        return y

    report = _lint(bad, torch.zeros(8))
    assert "axis-discipline" in _rules(report)
    assert any("new_group" in v.message for v in report.violations)
    clean = _lint(good, torch.zeros(8))
    assert clean.ok, clean.violations


def test_unmatched_send_fires():
    def bad(topo, x):
        g = topo.require_groups()
        # rank 1 sends to rank 2, but rank 2's round expects rank 3
        pairs = [(1, 2)] if g.rank == 1 else [(3, 2)]
        out = _ppermute(x, pairs, g)
        return x if out is None else out

    report = _lint(bad, torch.zeros(8))
    assert "axis-discipline" in _rules(report)


# ---------------------------------------------------------------------------
# mutation: numerics flow
# ---------------------------------------------------------------------------


def test_bf16_sum_over_inter_fires():
    def bad(topo, x):
        return _all_reduce(x, topo.require_groups().inter, "sum")

    report = _lint(bad, torch.zeros(8, dtype=torch.bfloat16))
    assert "numerics-flow" in _rules(report)


def test_bf16_sum_upcast_is_clean():
    def good(topo, x):
        g = topo.require_groups()
        return _all_reduce(x.float(), g.inter, "sum").to(torch.bfloat16)

    report = _lint(good, torch.zeros(8, dtype=torch.bfloat16))
    assert report.ok, report.violations


def test_bf16_fold_of_received_value_fires():
    def bad(topo, x):
        recv = _ppermute(x, ACROSS, topo.require_groups())
        return x + recv  # bf16 accumulation of a value from another node

    report = _lint(bad, torch.zeros(8, dtype=torch.bfloat16))
    assert "numerics-flow" in _rules(report)


def test_f32_fold_of_received_value_is_clean():
    def good(topo, x):
        recv = _ppermute(x, ACROSS, topo.require_groups())
        return (x.float() + recv.float()).to(torch.bfloat16)

    report = _lint(good, torch.zeros(8, dtype=torch.bfloat16))
    assert report.ok, report.violations


def _scales(x):
    return (x.abs().amax() / 127.0).reshape(1)


def test_widened_wire_words_fire():
    """Packed wire words cast up to int32 before the exchange: the wire
    moves 4x the declared width."""

    def bad(topo, x):
        wire = transport.quantize_pack(x, _scales(x), offsets=(0,), bits=8)
        return _ppermute(wire.to(torch.int32), ACROSS,
                         topo.require_groups())

    report = _lint(bad, torch.zeros(1, 256))
    assert "numerics-flow" in _rules(report)


def test_packed_wire_words_are_clean():
    def good(topo, x):
        wire = transport.quantize_pack(x, _scales(x), offsets=(0,), bits=8)
        return _ppermute(wire, ACROSS, topo.require_groups())

    report = _lint(good, torch.zeros(1, 256))
    assert report.ok, report.violations


def test_wire_dtype_rules_at_two_and_three_bits():
    """Both transports put int8 on the wire at 2 and 3 bits, while both
    wire lints expect uint8 at every width up to 4 (ROADMAP Queue 3, kept
    on purpose); the SPMD lint holds the transport's own dtype."""
    from repro.analysis import hlo_lint
    from repro.kernels import transport as ref_transport

    from repro_torch.analysis import trace_lint

    for bits in (2, 3):
        assert transport.wire_dtype(bits) == torch.int8
        assert str(ref_transport.wire_dtype(bits)) == "int8"
        assert trace_lint.expected_wire_dtype(bits) == "uint8"
        assert hlo_lint.expected_wire_dtype(bits) == "u8"

        def good(topo, x, bits=bits):
            scales = (x.abs().amax() / (2 ** (bits - 1) - 1)).reshape(1)
            return transport.quantize_pack(x, scales, offsets=(0,),
                                           bits=bits)

        report = _lint(good, torch.zeros(1, 256))
        assert report.ok, report.violations


def test_undominated_scale_fires():
    def bad(topo, x):
        scales = x[0, :1] + 1.0  # no max-abs ancestry
        return transport.quantize_pack(x, scales, offsets=(0,), bits=8)

    report = _lint(bad, torch.zeros(1, 256))
    assert "numerics-flow" in _rules(report)


# ---------------------------------------------------------------------------
# mutation: byte accounting
# ---------------------------------------------------------------------------


def _sum_over_inter(topo, x):
    return _all_reduce(x, topo.require_groups().inter, "sum")


def test_byte_accounting_equality_holds():
    # 8 float32 over the lane group (2 nodes, 2 ranks a node): every rank
    # exchanges 2 x (32 bytes / group of 2) with its 1 peer on the other
    # node
    report = _lint(_sum_over_inter, torch.zeros(8),
                   declared_internode_bytes=32.0)
    assert report.ok, report.violations
    assert report.internode_bytes_per_chip == 32.0


def test_inflated_declared_bound_fires():
    report = _lint(_sum_over_inter, torch.zeros(8),
                   declared_internode_bytes=1.0)
    assert "byte-accounting" in _rules(report)


# ---------------------------------------------------------------------------
# mutation: alias-donation
# ---------------------------------------------------------------------------


def test_donated_buffer_reuse_fires():
    def bad(topo, x):
        wire = transport.quantize_pack(x, _scales(x), offsets=(0,), bits=8,
                                       donate_input=True)
        # the donated payload is read again after the call
        return wire.to(torch.float32).sum() + x.sum()

    report = _lint(bad, torch.zeros(1, 256))
    assert "alias-donation" in _rules(report)


def test_donated_buffer_returned_fires():
    def bad(topo, x):
        wire = transport.quantize_pack(x, _scales(x), offsets=(0,), bits=8,
                                       donate_input=True)
        return wire, x  # the donated payload escapes as a result

    report = _lint(bad, torch.zeros(1, 256))
    assert "alias-donation" in _rules(report)


def test_donation_of_dead_buffer_is_clean():
    def good(topo, x):
        return transport.quantize_pack(x, _scales(x), offsets=(0,), bits=8,
                                       donate_input=True)

    report = _lint(good, torch.zeros(1, 256))
    assert report.ok, report.violations


def test_donation_changes_no_value():
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((2, 300)).astype(np.float32))
    s = _scales(x)
    for bits in (8, 4):
        w = transport.quantize_pack(x, s, offsets=(0,), bits=bits)
        wd = transport.quantize_pack(x, s, offsets=(0,), bits=bits,
                                     donate_input=True)
        assert torch.equal(w, wd)
        y = transport.unpack_dequantize(w, s, offsets=(0,), bits=bits,
                                        cols=300)
        yd = transport.unpack_dequantize(w, s, offsets=(0,), bits=bits,
                                         cols=300, donate_input=True)
        assert torch.equal(y, yd)


# ---------------------------------------------------------------------------
# parametrised uniform programs never false-positive
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("wrap", ["plain", "branch", "loop"])
@pytest.mark.parametrize("level", ["inter", "world"])
def test_uniform_programs_lint_clean(depth, op, wrap, level):
    def prog(topo, x):
        g = topo.require_groups()
        group = getattr(g, level)
        y = _all_reduce(x, g.world, "sum")  # uniform once, up front
        for _ in range(depth):
            if wrap == "branch":
                if y.sum().item() > 0.0:
                    y = _all_reduce(y, group, op) + 1.0
                else:
                    y = _all_reduce(y, group, op) - 1.0
            elif wrap == "loop":
                for _ in range(2):
                    y = _all_reduce(y, group, op)
            else:
                y = _all_reduce(y, group, op)
        return y

    report = _lint(prog, torch.zeros(8))
    assert report.ok, (depth, op, wrap, level, report.violations)


# ---------------------------------------------------------------------------
# the registration gates
# ---------------------------------------------------------------------------


def _dup_message_builder(n, ppn):
    s = napalg.build_rd_schedule(n, ppn)
    st0 = s.steps[0]
    return dataclasses.replace(
        s,
        steps=(dataclasses.replace(st0, pairs=st0.pairs + st0.pairs[:1]),)
        + s.steps[1:],
    )


def test_register_gate_rejects_unlintable_engine(monkeypatch):
    """An engine whose program lets a rank's own data decide whether it
    reaches a collective is rejected at registration even with
    ``verify=False`` (no schedule to verify, but a program to prove), and
    the registry is rolled back."""
    monkeypatch.setenv("REPRO_VERIFY_ON_REGISTER", "1")
    name = "bad_spmd_lint_engine"

    def bad_execute(x, *, topology, op="sum", pipeline_chunks=1):
        g = topology.require_groups()
        if x.sum().item() >= 0.0:
            return _all_reduce(x, g.world, op)
        return _all_reduce(x, g.world, op) * 0.0

    with pytest.raises(ValueError, match="collective-uniformity"):
        comm.register_engine(name, execute=bad_execute, verify=False,
                             override=True)
    assert name not in comm.registered_engines("allreduce")


def test_register_gate_rejects_unverifiable_schedule(monkeypatch):
    monkeypatch.setenv("REPRO_VERIFY_ON_REGISTER", "1")
    with pytest.raises(ValueError, match="failed static verification"):
        comm.register_engine("broken_rd", execute=lambda x, **k: x,
                             build_schedule=_dup_message_builder)
    assert "broken_rd" not in comm.registered_engines("allreduce")


def test_register_gate_verify_opt_out(monkeypatch):
    """``verify=False`` skips the schedule checks only: a native program
    registers as long as it lints, and a broken builder is still caught
    by the lint's byte link to its declared bound."""
    monkeypatch.setenv("REPRO_VERIFY_ON_REGISTER", "1")
    try:
        comm.register_engine("native_optout", ops={"sum", "max", "min"},
                             execute=collectives.psum_allreduce,
                             verify=False)
        assert "native_optout" in comm.registered_engines("allreduce")
    finally:
        comm._REGISTRY["allreduce"].pop("native_optout", None)
    with pytest.raises(ValueError, match="spmd lint"):
        comm.register_engine("broken_rd_optout", execute=lambda x, **k: x,
                             build_schedule=_dup_message_builder,
                             verify=False)
    assert "broken_rd_optout" not in comm.registered_engines("allreduce")


def test_register_gate_off_without_the_flag(monkeypatch):
    monkeypatch.delenv("REPRO_VERIFY_ON_REGISTER", raising=False)
    try:
        comm.register_engine("broken_rd_noenv", execute=lambda x, **k: x,
                             build_schedule=_dup_message_builder)
        assert "broken_rd_noenv" in comm.registered_engines("allreduce")
    finally:
        comm._REGISTRY["allreduce"].pop("broken_rd_noenv", None)


def test_register_engine_as_a_decorator(monkeypatch):
    monkeypatch.setenv("REPRO_VERIFY_ON_REGISTER", "1")
    try:
        @comm.register_engine("psum_decorated", ops={"sum"}, verify=False)
        def _execute(x, *, topology, op="sum", pipeline_chunks=1):
            return collectives.psum_allreduce(x, topology=topology, op=op)

        spec = comm.registered_engines("allreduce")["psum_decorated"]
        assert spec.execute is _execute
    finally:
        comm._REGISTRY["allreduce"].pop("psum_decorated", None)


def test_failed_override_restores_the_engine(monkeypatch):
    monkeypatch.setenv("REPRO_VERIFY_ON_REGISTER", "1")
    before = comm.get_engine("psum")
    with pytest.raises(ValueError, match="spmd lint"):
        comm.register_engine(
            "psum", override=True, verify=False,
            execute=lambda x, *, topology, **k: _all_reduce(
                x, topology.require_groups().inter, "sum"),
            build_schedule=_dup_message_builder)
    assert comm.get_engine("psum") is before


def test_gate_leaves_the_default_group_alone(monkeypatch, tmp_path):
    """The gate beside a live default group of another size (a one-rank
    gloo world here, or the fake world an earlier test left in this
    process): same backend, same size, same group, and a collective
    still runs on it."""
    monkeypatch.setenv("REPRO_VERIFY_ON_REGISTER", "1")
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                                rank=0, world_size=1)
    try:
        before = (dist.get_backend(), dist.get_world_size(),
                  dist.group.WORLD)
        try:
            comm.register_engine("nap_again", ops=collectives.ALL_OPS,
                                 regime="baseline", min_nodes=2, min_ppn=2,
                                 build_schedule=napalg.build_nap_schedule,
                                 execute=collectives.nap_allreduce)
        finally:
            comm._REGISTRY["allreduce"].pop("nap_again", None)
        assert (dist.get_backend(), dist.get_world_size(),
                dist.group.WORLD) == before
        t = torch.ones(3)
        dist.all_reduce(t)
        if before[0] == "gloo":
            assert torch.equal(t, torch.ones(3))
    finally:
        if made:
            dist.destroy_process_group()
