"""Static analysis of the collective engines.

The port of the schedule-verifier layer of ``repro/analysis``:
:mod:`repro_torch.analysis.schedule_verifier` proves, for any schedule a
registered engine builds, match-completeness, deadlock-freedom,
exactly-once reduction and byte accounting against the engine's declared
inter-node bound (NumPy only).  ``comm.verify_engine`` runs it on one
engine.  The reference's other layers (the protocol model check and the
lints of the JAX lowering and of compiled HLO) have no port yet.

Quickstart::

    from repro_torch.core import comm
    from repro_torch.analysis import verify_schedule

    sched = comm.engine_schedule("mla", n_nodes=5, ppn=4, elems=193)
    report = verify_schedule(sched, engine="mla", elems=193)
    assert report.ok, report.violations
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

__all__ = [
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
]
