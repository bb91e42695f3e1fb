"""Shared test-session configuration.

Verify-on-register: with ``REPRO_VERIFY_ON_REGISTER`` set, every engine
registration (including the built-ins at ``repro.core.comm`` import
time) runs the static schedule verifier (:mod:`repro.analysis`) over
the registration grid matrix before the engine becomes visible.  A
broken schedule builder therefore fails loudly at registration — at the
first ``comm`` import of the session — instead of in whichever
example-based test happens to cover that grid.  Set *before* any test
module imports ``repro.core.comm``.
"""

import os

os.environ.setdefault("REPRO_VERIFY_ON_REGISTER", "1")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card; skips with a reason where there is none",
    )
