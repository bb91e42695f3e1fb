"""The numbers that decide ``correct``, each held to its limit.

Each is a relative gap of the program's reading from the reference's
(``train.Readings``):

* ``loss``: the larger of the first two steps' ``|L_prog - L_ref| /
  |L_ref|``.  Both are taken before an update has moved the weights (the
  warm-up's rate is 0 at step 0), so they read the forward pass's
  precision twice on other rows;
* ``loss3``: the third step's, the first loss after an update has moved
  the weights;
* ``grad``: the worst leaf's ``| ||g_prog|| - ||g_ref|| |`` over the larger
  of its ``||g_ref||`` and the median leaf's, ``g`` the first gradient as
  AdamW's state holds it after one step;
* ``grad_elem``: the median leaf's ``||g_prog - g_ref|| / ||g_ref||`` of
  rank 0's first raw gradient (before the sync) at 65,536 elements a leaf
  drawn from the seed, ``||g_ref||`` no smaller than the median leaf's.
  A loss is a signed mean and a norm moves only to second order under
  rounding that is not aligned with the gradient, so they cancel a lower
  precision's unbiased rounding; the difference does not;
* ``change``: as ``grad``, of each leaf's change after the steps, over the
  leaves whose first reference gradient is at least a thousandth of the
  median leaf's (a leaf whose gradient is nought to rounding moves under
  AdamW by round-off alone);
* ``ef`` (under error feedback): as ``grad``, of each leaf's residual after
  the first and after the second step, the larger of the two; the second
  carries the first step's residual through ``c = g + r``.

For ``change`` and ``ef`` a gap of norms, not the norm of a difference:
AdamW's first steps move an element by about the rate whatever the size
of its gradient, so an element whose gradient is within rounding of zero
may step either way; and the int4 wire rounds an element of ``c`` to the
other level where a bf16 gradient lies the other side of a half step.
"""

from __future__ import annotations

import math
import statistics

import torch

__all__ = ["NUMBERS", "gaps", "judge"]

NUMBERS = ("loss", "loss3", "grad", "grad_elem", "change", "ef")


def _worst(prog, ref, keep=None):
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    med = statistics.median(ref[i] for i in idx)
    worst, at = 0.0, None
    for i in idx:
        gap = abs(prog[i] - ref[i]) / max(ref[i], med, 1e-30)
        if not math.isfinite(gap) or gap > worst:
            worst, at = (gap if math.isfinite(gap) else math.inf), i
            if not math.isfinite(gap):
                break
    return worst, at


def _elementwise(prog, ref):
    """The median leaf's relative norm of the difference, and ``[the worst
    leaf, its value]``; a side with no sample reads 1."""
    norms = [float(torch.linalg.vector_norm(r)) for r in ref]
    med = statistics.median(norms)
    rel = []
    for i, r in enumerate(ref):
        p = prog[i] if prog is not None else torch.zeros_like(r)
        d = float(torch.linalg.vector_norm(p.to(r.device) - r))
        rel.append(d / max(norms[i], med, 1e-30) if math.isfinite(d)
                   else math.inf)
    worst = max(range(len(rel)), key=rel.__getitem__)
    return statistics.median(rel), [worst, rel[worst]]


def gaps(prog, ref) -> tuple[dict, dict]:
    """``({number: gap}, {number: the step or leaf it came from})`` for
    every number the readings hold (``ef`` only under error feedback)."""
    loss = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
            for a, b in zip(prog.losses, ref.losses)]
    first = max(range(2), key=loss.__getitem__)
    grad, grad_at = _worst(prog.grad_norms, ref.grad_norms)
    raw = ref.raw_grad_norms
    floor = 1e-3 * statistics.median(raw)
    change, change_at = _worst(prog.change_norms, ref.change_norms,
                               keep=[r >= floor for r in raw])
    elem, elem_at = _elementwise(prog.grad_sample, ref.grad_sample)
    values = {"loss": loss[first], "loss3": loss[2], "grad": grad,
              "grad_elem": elem, "change": change}
    where = {"loss": first, "grad": grad_at, "grad_elem": elem_at,
             "change": change_at}
    if ref.ef_norms is not None:
        ef = [_worst(p, r) for p, r in zip(prog.ef_norms, ref.ef_norms)]
        s = max(range(len(ef)), key=lambda i: ef[i][0])
        values["ef"], where["ef"] = ef[s][0], [s, ef[s][1]]
    return values, where


def judge(values: dict, limits: dict) -> tuple[bool, list]:
    """``(correct, [[name, value, limit], ...])`` over the numbers in
    ``values``: every one with a limit at or under it (a number whose limit
    is ``None`` or absent is reported and not compared)."""
    rows, ok = [], True
    for name in NUMBERS:
        if name not in values:
            continue
        v, lim = values[name], limits.get(name)
        rows.append([name, v, lim])
        if lim is not None and not (math.isfinite(v) and v <= lim):
            ok = False
    return ok, rows
