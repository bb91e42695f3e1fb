"""``sync_ms``: device ms a step of the kernels launched under the
program's span ``repro_torch.grad_sync`` (``core/grad_sync``'s every
bucket: float32 casts, error feedback's residual, the transport kernels,
the engines' collectives); rank 0's."""

from perfbench.spans import span_ms


def read(run):
    return span_ms(run, "repro_torch.grad_sync")
