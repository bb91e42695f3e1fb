"""Static analysis of the collective engines and the programs that run them.

The port of ``repro/analysis``.  Four layers prove the serving and
training stack correct before it races, a proof chain from the host
protocol down to the program each rank runs:

0. **Protocol model check** (:mod:`repro_torch.analysis.protocol_check`):
   explicit-state exhaustive exploration of the serving control plane
   (the real ``Scheduler`` / ``Router`` / ``ReplicaHealth`` objects)
   through every interleaving of its events at small scope.  This
   proves the *protocol* that fires the collectives.
1. **Schedule verifier** (:mod:`repro_torch.analysis.schedule_verifier`):
   for any schedule a registered engine builds, match-completeness,
   deadlock-freedom, exactly-once reduction and byte accounting against
   the engine's declared inter-node bound (NumPy only).  This proves the
   *plan*.
2. **SPMD lint** (:mod:`repro_torch.analysis.spmd_lint`): the program
   each rank actually runs, traced as every rank of an ``n x ppn`` grid
   in a fake world of its own: no collective after a host read of a
   rank-varying value, the same collective sequence on every member of a
   group, collectives on the topology's groups and matched sends, sub-f32
   sums accumulated in f32 across nodes, measured quantize scales and
   narrow wire words, inter-node bytes equal to the schedule's bound,
   donated transport buffers dead after the call.  This proves that the
   *executed program matches the plan*.
3. **Trace lint** (:mod:`repro_torch.analysis.trace_lint`, the
   reference's HLO wire-lint): rules over one rank's op trace: compressed
   wire dtypes, groups that partition the ranks, launch budgets, a
   stable trace.  This proves what the rank *issued*.

Layer 0 is tied to layer 2 by the decode-geometry link
(:func:`~repro_torch.analysis.protocol_check.verify_decode_geometry_link`):
the slot occupancies the protocol reaches are the ragged slot geometry
the decode slice is linted at.

Layers 1 and 2 run at engine registration
(:func:`repro_torch.core.comm.register_engine`) when
``REPRO_VERIFY_ON_REGISTER`` is set: the schedule verifier for
``verify=True`` engines, the lint for every engine.  The lint makes its
own fake process groups and registers none, so the gate runs the same
inside a live ``torch.distributed`` world (a gloo test world, NCCL on the
card) and leaves its default group as it was.

Quickstart::

    from repro_torch.core import comm
    from repro_torch.analysis import spmd_lint, verify_schedule
    from repro_torch.analysis import protocol_check as pc

    # layer 0
    report = pc.check_protocol(pc.CheckConfig(replicas=2, slots=2,
                                              queue=1, requests=4))
    # layer 1
    sched = comm.engine_schedule("mla", n_nodes=5, ppn=4, elems=193)
    assert verify_schedule(sched, engine="mla", elems=193).ok
    # layer 2: one registered engine, or any fn(topology, *args)
    comm.lint_lowering("nap", n_nodes=3, ppn=2)
    rep = spmd_lint.lint_traced(my_program, example_arg, n_nodes=2, ppn=4)
    spmd_lint.assert_spmd_clean(rep)

    # or every sweep, with the tables written under reports/:
    #   PYTHONPATH=src python -m repro_torch.analysis
    #   PYTHONPATH=src python -m repro_torch.analysis --spmd
    #   PYTHONPATH=src python -m repro_torch.analysis --protocol

The trace lint's names are imported on first use: it reads the op tracer
of :mod:`repro_torch.launch`, which imports the engine registry that
imports this package.
"""

from .schedule_verifier import (  # noqa: F401
    GRID_MATRIX,
    PAYLOAD_ELEMS,
    REGISTER_GRIDS,
    RULES,
    VerificationReport,
    Violation,
    build_spec_schedule,
    verify_schedule,
    verify_spec,
    verify_spec_grid,
)
from .spmd_lint import (  # noqa: F401
    SPMD_RULES,
    SpmdLintReport,
    SpmdViolation,
    assert_spmd_clean,
    lint_ranks,
    lint_traced,
    trace_ranks,
)
from .protocol_check import (  # noqa: F401
    CheckConfig,
    CheckReport,
    assert_trace_clean,
    assert_trace_violates,
    check_protocol,
    run_trace,
    verify_decode_geometry_link,
)

_TRACE_LINT = (
    "LintViolation",
    "collective_ops",
    "lint_collective_counts",
    "lint_compressed_wire",
    "lint_replica_groups",
    "lint_stable_trace",
)

__all__ = [
    "CheckConfig",
    "CheckReport",
    "assert_trace_clean",
    "assert_trace_violates",
    "check_protocol",
    "run_trace",
    "verify_decode_geometry_link",
    "GRID_MATRIX",
    "PAYLOAD_ELEMS",
    "REGISTER_GRIDS",
    "RULES",
    "VerificationReport",
    "Violation",
    "build_spec_schedule",
    "verify_schedule",
    "verify_spec",
    "verify_spec_grid",
    *_TRACE_LINT,
    "SPMD_RULES",
    "SpmdLintReport",
    "SpmdViolation",
    "assert_spmd_clean",
    "lint_ranks",
    "lint_traced",
    "trace_ranks",
]


def __getattr__(name):
    if name in _TRACE_LINT:
        from . import trace_lint

        return getattr(trace_lint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
