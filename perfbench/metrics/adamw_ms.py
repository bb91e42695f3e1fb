"""``adamw_ms``: device ms a step of the kernels launched under the
program's span ``repro_torch.adamw`` (``optim.adamw_update``: the global
norm, the clip and every leaf's update); rank 0's."""

from perfbench.spans import span_ms


def read(run):
    return span_ms(run, "repro_torch.adamw")
