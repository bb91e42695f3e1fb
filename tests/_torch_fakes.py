"""A recording stand-in for the port's kernel libraries (not a test).

:func:`fake_kernel_route` routes CPU tensors through a wrapper's kernel path
with the ``ctypes`` library replaced by a :class:`Recorder`, so the tests
can check what a wrapper passes to its C entry point on a box with no card.
"""

from __future__ import annotations


class Recorder:
    """Stands in for a kernel library: records each C call, returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def fake_kernel_route(monkeypatch, build, *modules) -> Recorder:
    """Make ``build.use_kernel`` choose the kernel for any tensor, the
    stream ``(0, 0)``, and each module's ``_lib()`` one shared recorder."""
    rec = Recorder()
    monkeypatch.setattr(build, "use_kernel", lambda impl, *tensors: True)
    monkeypatch.setattr(build, "stream_args", lambda t: (0, 0))
    for mod in modules:
        monkeypatch.setattr(mod, "_lib", lambda: rec)
    return rec
