"""``backward_ms``: device ms a step of the kernels launched under the
program's span ``repro_torch.backward`` (``torch.autograd.grad``; the
autograd thread's launches are charged to it across threads), the remat
recompute under it left out (``recompute_ms``); rank 0's."""

from perfbench.spans import span_ms


def read(run):
    return span_ms(run, "repro_torch.backward",
                   leave_out=("repro_torch.recompute",))
