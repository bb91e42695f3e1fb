"""``gemm_ms``: device ms a step in matrix-product kernels (cuBLAS,
CUTLASS, ``nvjet``: ``trace.kernel_class``), the mean over the ranks."""


def read(run):
    s = sum(run.class_seconds(i, "matmul") for i in range(len(run.ranks)))
    if s <= 0:
        return None
    return 1e3 * run.per_step(s / len(run.ranks))
