"""``step_mfu``: the whole step's share of the chips' bf16 peak, %.

The benchmark's FLOPs of one step (the model file's ``step_flops``, as
``counts.of_cell`` takes it: for the decoder 6 per active weight and
token, plus attention) over the traced window's time per step
(the slowest rank's window), over 989 TFLOP/s times the chips.
"""


def read(run):
    window = max(r.window_s for r in run.ranks)
    if window <= 0:
        return None
    rate = run.counts["flops"] / run.per_step(window)
    return 100.0 * rate / (run.peaks["bf16_flops"] * run.chips)
