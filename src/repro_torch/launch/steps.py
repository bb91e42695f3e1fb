"""The data-parallel train step with the paper's collectives, and the serving
steps.

The port of ``repro/launch/steps.py::make_dp_train_step``,
``make_prefill_step`` and ``make_serve_step``.  Train: parameters are
replicated, every rank computes gradients on its rows of the batch, and
the gradient buckets and the loss scalar are synchronised through a
:class:`~repro_torch.core.comm.CommContext` — node-aware sync, compressed
transport on the CUDA transport kernels, and error feedback, end to end.
"""

from __future__ import annotations

import torch

from .. import tree as tree_util
from ..core import comm, grad_sync
from ..core.collectives import _all_reduce
from ..device import require_on, resolve_device
from ..models import build_model, init_params
from ..models.layers import head_dot
from ..models.model import _final_hidden
from ..optim import adamw_init, adamw_update, ef_init, make_schedule

__all__ = ["make_dp_train_step", "init_train_state", "make_prefill_step",
           "make_serve_step"]


def init_train_state(cfg, opt_cfg, sync_cfg, *, params=None,
                     generator: torch.Generator | None = None, device=None):
    """``{"model", "opt"[, "ef"]}``: the model on ``device`` (from ``params``
    or ``generator``), zero AdamW moments and, with error feedback, this
    rank's zero residuals."""
    model = build_model(cfg, params, generator=generator, device=device)
    state = {
        "model": model,
        "opt": adamw_init(model.params(), moment_dtype=opt_cfg.moment_dtype),
    }
    if sync_cfg.error_feedback:
        state["ef"] = ef_init(model.params())
    return state


def make_dp_train_step(cfg, opt_cfg, topology: comm.Topology,
                       sync_cfg: comm.CommPolicy, *, device=None):
    """``step(state, batch) -> (state, metrics)`` for one rank.

    The bucket plan is made once, from the parameter shapes (no memory:
    ``meta`` tensors), and every step runs exactly that plan
    (``step.plan``).  Per step: loss and gradients, ``ctx.sync_grads`` (with
    this rank's residuals under error feedback), the loss scalar through
    ``nap`` (or the pinned algorithm) when there is a slow domain and a
    plain mean otherwise, then AdamW at the schedule's rate.  The model,
    moments and residuals are updated in place.
    """
    resolve_device(device)
    topo = topology
    groups = topo.require_groups()
    ctx = comm.CommContext(topo, sync_cfg)
    group = topo.group
    sched = make_schedule(opt_cfg)
    bucket_plan = grad_sync.plan_for_tree(
        init_params(cfg, device="meta"), cfg=sync_cfg, topology=topo
    )
    use_ef = bool(sync_cfg.error_feedback)

    def step(state, batch):
        model, opt = state["model"], state["opt"]
        params = model.params()
        leaves, treedef = tree_util.flatten(params)
        loss, _ = model(batch)
        grads = torch.autograd.grad(loss, leaves)
        grads = tree_util.unflatten(treedef, list(grads))
        with torch.no_grad():
            new_ef = None
            if use_ef:
                grads, new_ef = ctx.sync_grads(
                    grads, plan=bucket_plan, ef_state=state["ef"]
                )
            else:
                grads = ctx.sync_grads(grads, plan=bucket_plan)
            loss = loss.detach()
            if topo.n_nodes > 1:
                algo = sync_cfg.algorithm
                loss = ctx.allreduce(
                    loss, algorithm=algo if algo != "auto" else "nap"
                )
            else:
                loss = _all_reduce(loss, groups.intra, "sum")
            loss = loss / torch.full((), float(group), device=loss.device)
            lr = sched(opt.step)
            new_opt, om = adamw_update(
                grads, opt, params,
                lr=lr, betas=opt_cfg.betas, eps=opt_cfg.eps,
                weight_decay=opt_cfg.weight_decay,
                grad_clip=opt_cfg.grad_clip,
            )
        new_state = {"model": model, "opt": new_opt}
        if use_ef:
            new_state["ef"] = new_ef
        return new_state, {"loss": loss, "lr": lr, **om}

    step.plan = bucket_plan
    step.context = ctx
    return step


def make_prefill_step(model, *, tail: int = 128, device=None):
    """``prefill_step(batch) -> logits`` (B, min(tail, S), V) float32: the
    prompt's forward pass (``tokens``, or ``embeds`` with ``positions``),
    logits for its last ``tail`` positions."""
    require_on(model, device)

    @torch.no_grad()
    def prefill_step(batch):
        hidden, _ = _final_hidden(model.params(), batch, model.cfg)
        return head_dot(hidden[:, -tail:], model.head_weights())

    return prefill_step


def make_serve_step(model, ctx: comm.CommContext | None = None, *,
                    device=None):
    """One-token cached greedy decode, ``step(cache, tokens) -> (next
    tokens, cache)`` (:func:`repro_torch.serve.decode.greedy_step`): with a
    multi-rank ``ctx`` the head is tensor-parallel, without it the local
    head (the same contraction)."""
    from ..serve.decode import greedy_step

    require_on(model, device)
    return greedy_step(model, ctx)
