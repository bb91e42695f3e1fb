"""``moe_dispatch_ms``: device ms a step of the kernels launched directly
under the program's span ``repro_torch.moe.route`` (the router, the
bucket positions, the scatter into the experts' buffer and the gather
back), ``repro_torch.moe.experts`` left out; forward and recompute
alike; rank 0's."""

from perfbench.spans import span_ms


def read(run):
    return span_ms(run, "repro_torch.moe.route", self_only=True)
