"""``idle_share``: the share of the traced window (several steps) in
which no kernel ran on the device, %, the mean over the ranks."""

from perfbench.trace import busy_seconds


def read(run):
    shares = [1.0 - busy_seconds(r.kernels) / r.window_s
              for r in run.ranks if r.window_s > 0 and r.kernels]
    if not shares:
        return None
    return 100.0 * sum(shares) / len(shares)
