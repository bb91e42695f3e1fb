"""``transport_roofline``: the transport kernels' share of their roofline,
%.  The least time is the benchmark's bytes of a step's compressed sync
(``counts.transport_bytes``) over the card's 3.35 TB/s; the time is the
device time of ``quantize_pack_kernel`` and ``unpack_dequantize_kernel``
a step (rank 0's).  Nothing to read where no transport kernel ran."""


def read(run):
    dev = run.class_seconds(0, "transport")
    if dev <= 0 or "transport_bytes" not in run.counts:
        return None
    least = run.counts["transport_bytes"] / run.peaks["bytes_per_s"]
    return 100.0 * least / run.per_step(dev)
