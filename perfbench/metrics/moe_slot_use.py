"""``moe_slot_use``: the share of the experts' padded rows that hold a
routed item, %: the program's MoE counter over the traced window,
``moe_kept / moe_slots``, from rank 0's counters (``spans.moe_counter``)."""

from perfbench.spans import moe_counter


def read(run):
    c = moe_counter(run)
    return None if c is None else 100.0 * c["moe_kept"] / c["moe_slots"]
