"""``transport_launches``: launches of the two transport kernels a step,
from the program's counter ``repro_torch.kernels.transport.LAUNCHES``
(rank 0's growth over the traced window)."""


def read(run):
    n = run.ranks[0].counters.get("transport_launches")
    return None if not n else run.per_step(n)
