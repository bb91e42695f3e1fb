"""``recompute_ms``: device ms a step of the kernels launched under the
program's span ``repro_torch.recompute`` (a remat checkpoint's forward
run again inside the backward), the spans under it included; rank 0's.
Nothing where no recompute ran (``remat`` "none")."""

from perfbench.spans import span_ms


def read(run):
    return span_ms(run, "repro_torch.recompute")
