"""``moe_drop_share``: the share of routed items that the experts'
capacity drops, %: the program's MoE counter over the traced window,
``(moe_routed - moe_kept) / moe_routed``, from rank 0's counters
(``spans.moe_counter``)."""

from perfbench.spans import moe_counter


def read(run):
    c = moe_counter(run)
    if c is None:
        return None
    return 100.0 * (c["moe_routed"] - c["moe_kept"]) / c["moe_routed"]
