"""Three steps of the cell's data-parallel training, in plain float32.

From the weights made again from the seed and the same global batches:
each rank's rows give a loss and float32 gradients (the loss of the
configuration's model file, ``models/<model>.py``, in float32); the
sync averages them over the ranks (``mean``), or at one rank with
compression sends ``c = g + r`` through the wire's round trip and keeps
``r = c - Q(c)`` (``quant``); the synced gradient takes the leaf's stored
type, as the configuration states; AdamW (global-norm clipping, bias
correction, decoupled weight decay on leaves of two or more dims) at the
schedule's rate updates float32 copies, stored back in the leaf's type.

It reads what the comparison needs (:class:`Readings`): each step's loss,
each leaf's norm of the first gradient as AdamW's state holds it after
one step (``mu / (1 - beta1)``), each leaf's norm of its change after the
three steps, each leaf's norm of the first raw gradient (to leave out of
the change the leaves whose gradient is nought to rounding), rank 0's
first raw gradient at 65,536 elements a leaf drawn from the seed and,
under error feedback, each leaf's norm of the residual after the first
and the second step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import traffic as traffic_gen
from .. import weights
from . import quant

__all__ = ["Readings", "run", "fp8_matmul", "lr_at", "batch_tensors",
           "EF_STEPS", "sample_index", "take_sample"]

EF_STEPS = 2    # the residuals read: after the first and the second step
SAMPLE = 2 ** 16    # elements a leaf at which the first gradient is read


@dataclasses.dataclass
class Readings:
    """What one side of the comparison reads from its first steps."""

    losses: list            # each step's loss
    grad_norms: list        # per leaf: ||mu_1|| / (1 - beta1)
    change_norms: list      # per leaf: ||W_steps - W_0||
    raw_grad_norms: list | None = None   # per leaf, the first gradient
    ef_norms: list | None = None  # per step 0, 1: per leaf, ||r||
    grad_sample: list | None = None  # per leaf: rank 0's first raw
    # gradient at the elements of ``sample_index``, float32


def sample_index(specs: dict, seed: int, device) -> list:
    """Per leaf of ``specs``, the flat indices of the elements the first
    gradient is compared at: ``SAMPLE`` drawn from the seed (every element
    of a smaller leaf)."""
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) + 0x5EED) % 2 ** 63)
    out = []
    for shape, _, _ in specs.values():
        n = int(np.prod(shape))
        out.append(torch.arange(n, device=device) if n <= SAMPLE else
                   torch.randint(0, n, (SAMPLE,), generator=gen,
                                 device=device))
    return out


def take_sample(grads, idx) -> list:
    """The float32 values of each leaf's gradient at its indices, on the
    host."""
    return [g.detach().reshape(-1)[i].to("cpu", torch.float32)
            for g, i in zip(grads, idx)]


def lr_at(opt: dict, step: int) -> float:
    """The schedule's rate at 0-based ``step``, in float32 (constant after
    a linear warm-up, or cosine to a tenth over ``decay_steps``)."""
    f = np.float32
    warm = opt["warmup_steps"]
    frac = min(f(step) / f(max(warm, 1)), f(1.0))
    if opt["schedule"] == "constant":
        return float(f(opt["lr"]) * frac)
    if opt["schedule"] == "cosine":
        t = np.clip(f(step - warm) / f(max(opt["decay_steps"], 1)),
                    f(0.0), f(1.0))
        cos = f(0.5) * (f(1.0) + np.cos(f(np.pi) * t))
        return float(f(opt["lr"]) * frac * (f(0.1) + f(0.9) * cos))
    raise ValueError(f"schedule {opt['schedule']!r}")


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through float8 e4m3 at a per-tensor scale (its absmax
    onto 448), the gradient passed straight through."""
    scale = torch.clamp_min(x.detach().abs().amax(), 1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A matrix product of float8 e4m3 operands (the control's)."""
    return torch.matmul(_fp8(a), _fp8(b))


def batch_tensors(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(
        device, torch.int64 if k in ("tokens", "labels") else torch.float32)
        for k, v in batch.items()}


def run(cell, seed: int, device, *, steps: int = 3, mm=torch.matmul
        ) -> Readings:
    """The reference's readings of ``cell``'s first ``steps`` steps from
    ``seed`` (``mm``: the control's product, or the plain one)."""
    config, spec = cell.config, cell.spec
    sync, opt = spec["sync"], spec["optimizer"]
    world = cell.chips
    bits = sync.get("compress_bits")
    if bits and world != 1:
        raise ValueError("the reference's compressed sync is one rank's")
    b1, b2 = opt["betas"]
    specs, model = cell.specs, cell.model
    leaves = weights.tree_leaves(weights.make_params(specs, seed, device))
    names = [p for p, _ in leaves]
    stored = [t.dtype for _, t in leaves]
    w0 = [t.detach().clone() for _, t in leaves]
    p32 = [t.detach().to(torch.float32) for _, t in leaves]
    del leaves
    mu = [torch.zeros_like(p) for p in p32]
    nu = [torch.zeros_like(p) for p in p32]
    ef = [torch.zeros_like(p) for p in p32] if sync.get(
        "error_feedback") else None
    out = Readings(losses=[], grad_norms=[], change_norms=[],
                   ef_norms=[] if ef is not None else None)
    idx = sample_index(specs, seed, device)
    for step in range(steps):
        full = traffic_gen.global_batch(cell.traffic, config["vocab_size"],
                                        seed, step)
        leaves = [p.clone().requires_grad_(True) for p in p32]
        tree = _unflat(names, leaves)
        grads = [torch.zeros_like(p) for p in p32]
        loss_sum = 0.0
        for r in range(world):
            rows = batch_tensors(traffic_gen.rank_rows(full, r, world),
                                 device)
            loss = model.loss(tree, rows, config, mm=mm)
            g = torch.autograd.grad(loss, leaves)
            if step == 0 and r == 0:
                out.grad_sample = take_sample(g, idx)
            for acc, gg in zip(grads, g):
                acc.add_(gg)
            loss_sum += float(loss.detach())
            del loss, g
        del tree, leaves
        out.losses.append(loss_sum / world)
        grads = [g / world for g in grads]
        if step == 0:
            out.raw_grad_norms = [float(torch.linalg.vector_norm(g))
                                  for g in grads]
        if bits:
            sent = []
            for i, g in enumerate(grads):
                c = g + ef[i] if ef is not None else g
                qc = quant.round_trip(c, bits)
                if ef is not None:
                    ef[i] = c - qc
                sent.append(qc)
            grads = sent
            if ef is not None and step < EF_STEPS:
                out.ef_norms.append([float(torch.linalg.vector_norm(r))
                                     for r in ef])
        grads = [g.to(dt).to(torch.float32) for g, dt in zip(grads, stored)]
        _adamw(grads, mu, nu, p32, step, opt, stored)
        if step == 0:
            out.grad_norms = [float(torch.linalg.vector_norm(m)) / (1 - b1)
                              for m in mu]
        del grads
    out.change_norms = [float(torch.linalg.vector_norm(
        p - w.to(torch.float32))) for p, w in zip(p32, w0)]
    return out


def _unflat(names, leaves) -> dict:
    tree: dict = {}
    for path, t in zip(names, leaves):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return tree


def _adamw(grads, mu, nu, p32, step, opt, stored) -> None:
    """One AdamW step in place: clip by the global norm, bias-corrected
    moments, weight decay on leaves of two or more dims, each parameter
    stored back in its type."""
    b1, b2 = opt["betas"]
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    scale = torch.clamp(opt["grad_clip"] / torch.clamp_min(gnorm, 1e-12),
                        max=1.0)
    t = step + 1
    c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    lr = lr_at(opt, step)
    for g, m, v, p, dt in zip(grads, mu, nu, p32, stored):
        g = g * scale
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(torch.square(g) * (1 - b2))
        upd = (m / c1) / (torch.sqrt(v / c2) + opt["eps"])
        if p.dim() >= 2:
            upd = upd + opt["weight_decay"] * p
        p.copy_((p - lr * upd).to(dt).to(torch.float32))
