"""Step builders: the train steps and the serving steps.

The port of ``repro/launch/steps.py``:

* :func:`make_train_step` — microbatched gradient accumulation in
  float32, then AdamW (the trainer that :mod:`repro_torch.launch.train`
  drives), on one device or, for a model built under a
  :class:`~repro_torch.models.sharding.ShardingPolicy` on a mesh, over the
  FSDP x TP layout on DTensor: with ``grad_shardings`` the gradients and
  the accumulator stay in the parameters' layout (a reduce-scatter per
  microbatch, not an all-reduce), as the reference's XLA-propagated FSDP
  path does; the paper's engines are not on this path;
* :func:`make_dp_train_step` — data parallel with the paper's
  collectives: parameters are replicated, every rank computes gradients on
  its rows of the batch, and the gradient buckets and the loss scalar are
  synchronised through a :class:`~repro_torch.core.comm.CommContext` —
  node-aware sync, compressed transport on the CUDA transport kernels, and
  error feedback, end to end;
* :func:`make_prefill_step` / :func:`make_serve_step`;
* :func:`make_policy` and :func:`microbatch_split`, which size a cell on a
  :class:`~repro_torch.launch.mesh.Mesh`;
* :func:`input_specs` / :func:`state_specs`: a cell's batch, parameters,
  AdamW moments and decode cache as tensors on the ``meta`` device
  (shapes and dtypes, no memory); with a mesh every leaf carries its
  fitted spec as ``leaf.spec`` (the reference's ``NamedSharding.spec``).

A batch may carry an encoder-decoder's ``frames`` (B, S_enc, D): they are
split into microbatches and ranks by rows, as every other leaf.

A train step's state is ``{"model", "opt"[, "ef"]}``: the model holds the
parameters, which the step updates in place with the AdamW moments.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import tree as tree_util
from ..core import comm, grad_sync
from ..core.collectives import _all_reduce
from ..configs import SHAPES, get_config
from ..configs.base import OptimizerConfig
from ..device import require_on, resolve_device
from ..kernels import build_train_kernels
from ..models import Model, build_model, init_params
from ..models.layers import head_dot
from ..models.model import _dtype, _final_hidden
from ..models.sharding import ShardingPolicy, is_dtensor, spec_leaves
from ..optim import adamw_init, adamw_update, ef_init, make_schedule
from ..trace_regions import span
from .mesh import dp_axes as mesh_dp_axes

__all__ = ["make_policy", "microbatch_split", "make_train_step",
           "make_dp_train_step", "init_train_state", "make_prefill_step",
           "make_serve_step", "input_specs", "state_specs"]


def make_policy(cfg, mesh, *, seq_parallel: bool = False,
                mode: str = "train", device=None) -> ShardingPolicy:
    """The policy of ``cfg`` on ``mesh``; its placements live on
    ``device`` (``cuda`` unless asked otherwise)."""
    if mesh is None:
        return ShardingPolicy()
    dp = mesh_dp_axes(mesh)
    return ShardingPolicy(
        mesh=mesh,
        dp_axes=dp if mode != "serve2d" else (),
        tp_axis="model" if "model" in mesh.axis_names else None,
        fsdp_axes=dp,
        seq_parallel=seq_parallel,
        mode=mode,
        device=None if device is None else str(torch.device(device)),
    )


def microbatch_split(cfg, shape, mesh) -> int:
    """Number of grad-accumulation microbatches for a train cell.

    Sized so the layer stack's residual carry (num_super x B_m x S x D
    bf16 per chip) stays ~<= 6 GB; must divide the per-chip batch.
    """
    if shape.kind != "train":
        return 1
    dp = 1
    if mesh is not None:
        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        dp = math.prod(sizes[a] for a in mesh_dp_axes(mesh))
    b_local = max(1, shape.global_batch // dp)
    carry_per_sample = cfg.num_super_layers * shape.seq_len * cfg.d_model * 2
    b_m = max(1, int(6e9 // max(carry_per_sample, 1)))
    b_m = min(b_m, b_local)
    while b_local % b_m:
        b_m -= 1
    return b_local // b_m


def _microbatches(batch: dict, n_micro: int) -> list[dict]:
    """Microbatch ``i`` is rows ``[i * B_m, (i + 1) * B_m)`` of every
    leaf, as the reference's ``reshape((n_micro, -1) + shape[1:])``.  A
    DTensor leaf has its rows gathered once, and each microbatch is laid
    out as the leaf was (its rows over the same mesh dimensions where
    they divide ``B_m``, else replicated over them): the view would not
    split rows sharded over more ranks than ``n_micro``."""
    for k, x in batch.items():
        if x.shape[0] % n_micro:
            raise ValueError(f"batch leaf {k!r} of {x.shape[0]} rows does "
                             f"not split into {n_micro} microbatches")
    split = {k: _split_rows(x, n_micro) if is_dtensor(x)
             else x.reshape((n_micro, -1) + tuple(x.shape[1:]))
             for k, x in batch.items()}
    return [{k: x[i] for k, x in split.items()} for i in range(n_micro)]


def _split_rows(x, n_micro: int) -> list:
    """The ``n_micro`` row blocks of DTensor ``x``, each laid out as ``x``."""
    from torch.distributed.tensor import Replicate

    dm, lay = x.device_mesh, list(x.placements)
    rows = x.redistribute(dm, [Replicate() if p.is_shard(0) else p
                               for p in lay])
    b_m = x.shape[0] // n_micro
    ranks = math.prod(dm.size(i) for i, p in enumerate(lay) if p.is_shard(0))
    want = lay if b_m % ranks == 0 else list(rows.placements)
    return [rows[i * b_m:(i + 1) * b_m].redistribute(dm, want)
            for i in range(n_micro)]


def make_train_step(model, opt_cfg, *, n_micro: int = 1,
                    grad_shardings=None, device=None):
    """``step(state, batch) -> (state, metrics)`` for ``model``'s state
    ``{"model", "opt"}`` (:func:`init_train_state`).

    With ``n_micro > 1`` the batch is split into ``n_micro`` microbatches
    of consecutive rows; each one's loss is its own masked mean and its
    gradients, in the parameters' dtype, are added into a float32
    accumulator.  The step's gradients are that sum over ``n_micro`` and
    its loss the mean of the microbatch losses.  With ``n_micro == 1`` the
    gradients go to AdamW in the parameters' dtype.  Then AdamW at the
    schedule's rate; the metrics are ``loss``, ``lr`` and AdamW's.

    On a mesh (a model built under a policy with one) the batch is a tree
    of DTensors (``SyntheticLM(mesh=)``) and ``grad_shardings`` a spec
    tree like the parameters (``policy.param_specs``): every gradient, and
    the accumulator after each microbatch, is laid out by it.  The
    metrics are plain tensors of the full values.  On a card, the
    transport and AdamW kernels are built here (:func:`build_train_kernels`)."""
    if require_on(model, device).type == "cuda":
        build_train_kernels()
    sched = make_schedule(opt_cfg)
    policy = model.policy
    specs = None
    if grad_shardings is not None:
        if policy.mesh is None:
            raise ValueError("grad_shardings need a model on a mesh")
        specs = spec_leaves(grad_shardings)

    def constrain(tree):
        if specs is None:
            return tree
        return [policy.constrain(t, sp) for t, sp in zip(tree, specs)]

    def train_step(state, batch):
        model, opt = state["model"], state["opt"]
        params = model.params()
        leaves, treedef = tree_util.flatten(params)
        with policy.scope():
            if n_micro == 1:
                with span("forward"):
                    loss, _ = model(batch)
                with span("backward"):
                    grads = constrain(list(torch.autograd.grad(loss,
                                                               leaves)))
                loss = loss.detach()
            else:
                acc = constrain([
                    torch.zeros_like(p.detach(), dtype=torch.float32,
                                     memory_format=torch.contiguous_format)
                    for p in leaves
                ])
                lsum = torch.zeros((), dtype=torch.float32,
                                   device=model.device)
                for mb in _microbatches(batch, n_micro):
                    with span("forward"):
                        l, _ = model(mb)
                    with span("backward"):
                        g = constrain(list(torch.autograd.grad(l, leaves)))
                    with torch.no_grad():
                        for a, gg in zip(acc, g):
                            a.add_(gg.to(torch.float32))
                        lsum = lsum + l.detach()
                    del g, l
                grads = [a.div_(n_micro) for a in acc]
                loss = lsum / n_micro
        if is_dtensor(loss):
            loss = loss.full_tensor()
        grads = tree_util.unflatten(treedef, grads)
        lr = sched(opt.step)
        new_opt, om = adamw_update(
            grads, opt, params,
            lr=lr, betas=opt_cfg.betas, eps=opt_cfg.eps,
            weight_decay=opt_cfg.weight_decay, grad_clip=opt_cfg.grad_clip,
        )
        return {"model": model, "opt": new_opt}, {"loss": loss, "lr": lr,
                                                  **om}

    return train_step


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
    """``step(state, batch) -> (state, metrics)`` for one rank; ``batch``
    is this rank's rows of the global batch, as ``SyntheticLM(rank=,
    world=)`` gives them (``frames`` too, where the batch carries them).

    The bucket plan is made once, from the parameter shapes (no memory:
    ``meta`` tensors), and every step runs exactly that plan
    (``step.plan``).  Per step: loss and gradients, ``ctx.sync_grads`` (with
    this rank's residuals under error feedback), the loss scalar through
    ``nap`` (or the pinned algorithm) when there is a slow domain and a
    plain mean otherwise, then AdamW at the schedule's rate.  The model,
    moments and residuals are updated in place.  On a card, the transport
    and AdamW kernels are built here (:func:`build_train_kernels`).
    """
    if resolve_device(device).type == "cuda":
        build_train_kernels()
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
        with span("forward"):
            loss, _ = model(batch)
        with span("backward"):
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
    prompt's forward pass (``tokens``, or ``embeds`` with ``positions``;
    an encoder-decoder's ``frames`` with them), logits for its last
    ``tail`` positions.  A model on a mesh runs it under its policy (the
    logits are then a DTensor)."""
    require_on(model, device)
    policy = model.policy

    @torch.no_grad()
    def prefill_step(batch):
        with policy.scope():
            hidden, _ = _final_hidden(model.params(), batch, model.cfg,
                                      policy)
            return head_dot(hidden[:, -tail:], model.head_weights())

    return prefill_step


def make_serve_step(model, ctx: comm.CommContext | None = None, *,
                    device=None):
    """One-token cached greedy decode, ``step(cache, tokens) -> (next
    tokens, cache)`` (:func:`repro_torch.serve.decode.greedy_step`): with a
    multi-rank ``ctx`` the head is tensor-parallel, without it the local
    head (the same contraction); a model on a mesh runs its own head under
    its policy and takes no ``ctx``."""
    from ..serve.decode import greedy_step

    require_on(model, device)
    return greedy_step(model, ctx)


# ---------------------------------------------------------------------------
# abstract inputs and state of a cell (meta tensors: shapes, no memory)
# ---------------------------------------------------------------------------

def _fit_spec(shape, spec, mesh) -> tuple:
    """``spec`` fitted to ``shape`` on ``mesh`` (axes that do not divide
    their dim dropped, one entry per dim), as ``ShardingPolicy._fit``."""
    return ShardingPolicy(mesh=mesh)._fit(tuple(shape), tuple(spec))


def _meta(shape, dtype, mesh=None, spec=()) -> torch.Tensor:
    """A ``meta`` tensor; with a mesh it carries its fitted spec as
    ``.spec`` (the reference's ``ShapeDtypeStruct`` with a sharding)."""
    t = torch.empty(shape, dtype=dtype, device="meta")
    if mesh is not None:
        t.spec = _fit_spec(shape, spec, mesh)
    return t


def input_specs(arch: str, shape_name: str, mesh=None, *,
                serve2d: bool = False) -> dict[str, torch.Tensor]:
    """The abstract batch of one (arch x shape) cell, as ``meta`` tensors
    with the reference's shapes and dtypes: ``tokens`` int32 (B, S) (B, 1
    for decode), or ``embeds`` (and (3, B, S) ``positions``) for the VLM
    stub; ``frames`` (B, S, D) for an encoder-decoder; ``labels`` and
    ``loss_mask`` for a train shape.  With a ``mesh`` each leaf's
    ``.spec`` puts its batch rows over the mesh's DP axes; ``serve2d``
    (the serving layout) leaves the batch replicated."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    act = _dtype(cfg)
    dp = mesh_dp_axes(mesh) if mesh is not None and not serve2d else None
    rows = lambda shp, dtype: _meta(shp, dtype, mesh, (dp,))  # noqa: E731
    batch: dict[str, torch.Tensor] = {}
    if shape.kind == "decode":
        if cfg.frontend == "vision_patches":
            batch["embeds"] = rows((B, 1, cfg.d_model), act)
        else:
            batch["tokens"] = rows((B, 1), torch.int32)
        if cfg.encoder_layers:  # enc-dec: encoder context at cache init
            batch["frames"] = rows((B, S, cfg.d_model), act)
        return batch
    if cfg.frontend == "vision_patches":
        batch["embeds"] = rows((B, S, cfg.d_model), act)
        batch["positions"] = _meta((3, B, S), torch.int32, mesh, (None, dp))
    else:
        batch["tokens"] = rows((B, S), torch.int32)
    if cfg.encoder_layers:
        batch["frames"] = rows((B, S, cfg.d_model), act)
    if shape.kind == "train":
        batch["labels"] = rows((B, S), torch.int32)
        batch["loss_mask"] = rows((B, S), torch.float32)
    return batch


def state_specs(arch: str, shape_name: str, mesh=None, *,
                opt_cfg: OptimizerConfig | None = None,
                seq_parallel: bool = False,
                cfg_overrides: dict | None = None,
                serve2d: bool = False):
    """The abstract state of one cell: ``(model, policy, tree, opt_cfg)``
    with ``tree`` = ``{"params", "opt"}`` for a train shape, ``{"params"}``
    for prefill and ``{"params", "cache"}`` for decode (an
    encoder-decoder's cache with ``enc_out``), every tensor on the
    ``meta`` device and ``model`` a :class:`Model` over the meta
    parameters.  The moments are bf16 above 1e11 parameters unless
    ``opt_cfg`` says otherwise.  With a ``mesh`` every parameter and
    moment carries its ``param_specs`` entry as ``.spec`` and every cache
    leaf its layout (:meth:`ShardingPolicy.cache_spec`, the reference's
    ``_cache_spec``); the AdamW step is an int and carries none.
    ``serve2d`` builds the policy in the serving layout."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    policy = make_policy(cfg, mesh, seq_parallel=seq_parallel,
                         mode="serve2d" if serve2d else "train")
    opt_cfg = opt_cfg or OptimizerConfig(
        moment_dtype="bfloat16" if cfg.param_count() > 1e11 else "float32"
    )
    model = Model(cfg, init_params(cfg, device="meta"), policy)
    out: dict = {"params": model.params()}
    if shape.kind == "train":
        out["opt"] = adamw_init(out["params"],
                                moment_dtype=opt_cfg.moment_dtype)
    if shape.kind == "decode":
        batch = input_specs(arch, shape_name, None)
        out["cache"] = model.init_decode(
            shape.global_batch, shape.seq_len,
            batch=batch if cfg.encoder_layers else None,
        )
    if mesh is not None:
        specs = spec_leaves(policy.param_specs(out["params"]))
        for t, spec in zip(tree_util.leaves(out["params"]), specs):
            t.spec = spec
        if "opt" in out:
            for t, spec in zip(out["opt"].mu + out["opt"].nu, specs * 2):
                t.spec = spec
        if "cache" in out:
            _attach_cache_specs(out["cache"], policy)
    return model, policy, out, opt_cfg


def _attach_cache_specs(cache: dict, policy: ShardingPolicy) -> None:
    specs = policy.cache_specs(cache)

    def walk(node, spec):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, spec[k])
            return
        node.spec = spec

    walk(cache, specs)
