"""``forward_ms``: device ms a step of the kernels launched under the
program's span ``repro_torch.forward`` (the DP step's ``model(batch)``:
embedding, stack, head and loss), the spans under it included (rank 0's;
``spans.span_ms``)."""

from perfbench.spans import span_ms


def read(run):
    return span_ms(run, "repro_torch.forward")
