"""One rank's run of a cell: set-up, the window, and the check.

The program under test is ``repro_torch``'s data-parallel step
(``launch.make_dp_train_step`` on the state of ``launch.init_train_state``)
over ``launch.mesh_topology(n, ppn)`` of a ``torch.distributed`` world
(``cpu:gloo,cuda:nccl`` on the cards, so the port takes the card's
machine constants), under the cell's ``CommPolicy``.  Set-up:

1. the weights from the seed on the device (``weights``), handed to the
   program, which keeps its own copy;
2. the program's first three steps from them, through the window's own
   step on each step's own rows: their losses, the first gradient as
   the sync is handed it (at elements drawn from the seed) and as
   AdamW's state holds it after one step, under error feedback the
   residuals after the first two, and each leaf's change after the three
   are read (rank 0); they also warm up every shape;
3. two more steps timed on the host give the window's step count, the
   largest over the ranks, so that the window lasts about ``seconds``.

The window runs that many steps back to back on batches staged during
set-up, with a CUDA event on the stream at every step boundary and one
synchronise at its end; with ``trace`` a few steps run under the profiler
instead.  Then the peak memory is read (the larger of the allocator's
peak over the checked steps and its peak from the timed steps on: the
weights made again between, for the change, are the check's and not
counted), the program's state freed, and rank 0 runs the plain reference
over the same three steps and compares.
"""

from __future__ import annotations

import dataclasses
import datetime
import gc
import math
import sys
import time
import typing

import torch

from . import traffic as traffic_gen
from . import trace as tr
from . import weights
from .manifest import HERE
from .reference import compare, train as ref_train

__all__ = ["FAULTS", "RankResult", "init_world", "close_world", "run_rank",
           "port_config", "forbidden_modules"]

# the timed path broken on purpose (``perfbench/test_perfbench_faults.py``
# and ``calibrate.py``): each must make ``correct`` false
FAULTS = ("frozen", "half_batch", "no_exchange", "token_altered",
          "ef_dropped")
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
CHECK_STEPS = 3
TIMING_STEPS = 2


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is the JAX package's or JAX's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class RankResult:
    """What one rank hands rank 0 (and rank 0 the caller)."""

    rank: int
    window_start: float          # wall clock at the window's start
    step_ms: list | None         # each window step, CUDA events
    window_ms: float | None
    steps: int
    peak_bytes: int
    trace: tr.RankTrace | None
    forbidden: list
    final_loss: float
    check_losses: list
    kind: str = ""               # torch.cuda.get_device_name of the card
    plan: list | None = None
    check: dict | None = None    # rank 0: the comparison


def init_world(rank: int, size: int, device: torch.device, port: int,
               timeout_s: float = 900.0) -> None:
    import torch.distributed as dist

    extra = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        backend, extra["device_id"] = "cpu:gloo,cuda:nccl", device
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=size, timeout=datetime.timedelta(seconds=timeout_s),
        **extra)
    # one collective on the world group before any engine's rounds
    dist.all_reduce(torch.zeros(1, device=device))


def close_world() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def port_config(config: dict):
    """The port's ``ModelConfig`` as the configuration's file states it:
    the arch's config (``get_config(config["arch"])``) with every key of
    the file that names one of its fields put in.  A nested configuration
    (``moe``, ``mamba``, ...) is put in field by field over the arch's own
    value, and a pattern may be given as a list of ``{mixer, ffn}``; keys
    that name no field (``source``, ``published``, ``model``, ...) are the
    harness's or the reader's.  ``_check_tree`` holds the result against
    the model file's tree."""
    from repro_torch.configs import ModelConfig, get_config

    base = get_config(config["arch"])
    hints = typing.get_type_hints(ModelConfig)
    over = {f.name: _field_value(hints[f.name], config[f.name],
                                 getattr(base, f.name))
            for f in dataclasses.fields(ModelConfig) if f.name in config}
    over.setdefault("name", f"{config['arch']}-bench")
    return dataclasses.replace(base, **over)


def _field_value(hint, value, current):
    """``value`` from a JSON file as a field of type ``hint`` holds it: a
    dict over the nested dataclass ``current`` (or a new one), a list as a
    tuple (of dataclasses where ``hint`` says so)."""
    args = typing.get_args(hint)
    kinds = [a for a in (args or (hint,)) if dataclasses.is_dataclass(a)]
    if isinstance(value, dict) and kinds:
        if dataclasses.is_dataclass(current):
            return dataclasses.replace(current, **value)
        return kinds[0](**value)
    if isinstance(value, list):
        inner = [a for a in args if dataclasses.is_dataclass(a)]
        return tuple(inner[0](**v) if inner and isinstance(v, dict) else v
                     for v in value)
    return value


def _check_tree(mine: dict, cfg) -> None:
    """The weights' tree has the program's keys, shapes and types."""
    from repro_torch.models import init_params

    want = [(p, tuple(t.shape), t.dtype) for p, t in
            weights.tree_leaves(init_params(cfg, device="meta"))]
    got = [(p, tuple(t.shape), t.dtype) for p, t in weights.tree_leaves(mine)]
    if want != got:
        raise ValueError("the weights' tree differs from the program's: "
                         f"{sorted(set(want) ^ set(got))[:4]}")


def _program_batch(full: dict, rank: int, world: int, device,
                   fault: str | None, vocab: int) -> dict:
    rows = traffic_gen.rank_rows(full, rank, world)
    if fault == "half_batch":
        # the second half of every row's tokens left out of the mean
        mask = rows["loss_mask"].copy()
        mask[:, mask.shape[1] // 2:] = 0.0
        rows = dict(rows, loss_mask=mask)
    batch = ref_train.batch_tensors(rows, device)
    if fault == "token_altered":
        t = batch["tokens"]
        t[0, 0] = (t[0, 0] + 1) % vocab
    return batch


def _break(step, fault: str | None):
    """``step`` with the fault planted (the identity without one)."""
    if fault == "frozen":
        def frozen(state, batch):
            with torch.no_grad():
                loss, _ = state["model"](batch)
            return state, {"loss": loss.detach()}
        return frozen
    if fault == "ef_dropped":
        def dropped(state, batch):
            for _, r in weights.tree_leaves(state["ef"]):
                r.zero_()
            return step(state, batch)
        return dropped
    if fault == "no_exchange":
        def local(grads, plan=None, ef_state=None):
            return grads if ef_state is None else (grads, ef_state)
        object.__setattr__(step.context, "sync_grads", local)
    return step


def _tap_first_grads(ctx, idx):
    """``(sample, untap)``: the gradients the sync is first handed, at the
    elements ``idx`` (``None``: none kept), fill ``sample``; ``untap()``
    puts the sync back as it was."""
    sample: list = []
    inner = ctx.sync_grads
    had = "sync_grads" in vars(ctx)

    def tap(grads, *args, **kwargs):
        if idx is not None and not sample:
            sample.extend(ref_train.take_sample(
                [g for _, g in weights.tree_leaves(grads)], idx))
        return inner(grads, *args, **kwargs)

    def untap():
        if had:
            object.__setattr__(ctx, "sync_grads", inner)
        else:
            object.__delattr__(ctx, "sync_grads")

    object.__setattr__(ctx, "sync_grads", tap)
    return sample, untap


def _leaf_norms(tensors) -> list[float]:
    return [float(torch.linalg.vector_norm(t.detach().to(torch.float32)))
            for t in tensors]


def _peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counters() -> dict:
    """The program's counters, read before and after a traced window:
    the transport kernels' launches and every counter the port publishes
    (``trace_regions.counters()``, or its MoE counter where the port has
    no such function)."""
    from repro_torch import trace_regions
    from repro_torch.kernels import transport

    published = getattr(trace_regions, "counters", trace_regions.moe_counts)
    return {"transport_launches": sum(transport.LAUNCHES.values()),
            **published()}


def _gather(obj, world: int) -> list:
    import torch.distributed as dist

    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


def run_rank(cell, seed: int, *, rank: int, world: int, device,
             seconds: float, trace: bool,
             fault: str | None = None, window: bool = True,
             log=None) -> RankResult | None:
    """This rank's run; rank 0 returns the gathered result (``check``
    holds the comparison), the others ``None``.  ``window=False`` stops
    after the checked steps (the calibration's readings)."""
    import torch.distributed as dist

    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.core import CommPolicy
    from repro_torch.launch import (init_train_state, make_dp_train_step,
                                    mesh_topology)

    device = torch.device(device)
    spec = cell.spec
    log = log or (lambda *a: None)
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    cfg = port_config(cell.config)
    opt = dict(spec["optimizer"])
    opt_cfg = OptimizerConfig(**{**opt, "betas": tuple(opt["betas"])})
    policy = CommPolicy(**spec["sync"])
    step = make_dp_train_step(cfg, opt_cfg, mesh_topology(*cell.grid),
                              policy, device=device.type)
    plan = [[len(b.leaves), b.nbytes, b.dtype, b.algorithm, b.chunks]
            for b in step.plan.buckets] if rank == 0 else None
    ctx = step.context
    step = _break(step, fault)

    params = weights.make_params(cell.specs, seed, device)
    _check_tree(params, cfg)
    state = init_train_state(cfg, opt_cfg, policy, params=params,
                             device=device.type)
    del params
    vocab = cell.config["vocab_size"]

    def batch(s):
        full = traffic_gen.global_batch(cell.traffic, vocab, seed, s)
        return _program_batch(full, rank, world, device, fault, vocab)

    # set-up: the checked steps, then the timed ones
    losses, grad_norms = [], None
    ef_norms = [] if "ef" in state else None
    sample, untap = _tap_first_grads(
        ctx, ref_train.sample_index(cell.specs, seed, device)
        if rank == 0 else None)
    for s in range(CHECK_STEPS):
        state, m = step(state, batch(s))
        losses.append(float(m["loss"]))
        if s == 0 and rank == 0:
            b1 = opt_cfg.betas[0]
            grad_norms = [n / (1 - b1) for n in _leaf_norms(state["opt"].mu)]
        if ef_norms is not None and s < ref_train.EF_STEPS:
            ef_norms.append(_leaf_norms(
                r for _, r in weights.tree_leaves(state["ef"])))
    untap()
    # the peak so far is the program's; the weights made again below for
    # the change are the check's, and are left out of it
    peak = _peak(device)
    change_norms = None
    if rank == 0:
        w0 = weights.tree_leaves(weights.make_params(cell.specs, seed,
                                                     device))
        change_norms = _leaf_norms(
            p.detach().to(torch.float32) - w.to(torch.float32)
            for p, (_, w) in zip(state["model"].leaves(), w0))
        del w0
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    if not window:
        steps = 0
    else:
        times = []
        for s in range(CHECK_STEPS, CHECK_STEPS + TIMING_STEPS):
            b = batch(s)
            _sync(device)
            t0 = time.perf_counter()
            state, _ = step(state, b)
            _sync(device)
            times.append(time.perf_counter() - t0)
        per = sum(times) / len(times)
        want = spec["trace_steps"] if trace else max(
            1, math.ceil(seconds / per))
        steps = int(max(_gather(want, world)))
    first = CHECK_STEPS + TIMING_STEPS
    staged = [batch(first + i) for i in range(steps)]
    log(f"rank {rank}: set-up done, {steps} window steps")

    dist.barrier()
    _sync(device)
    window_start = time.time()
    step_ms = window_ms = rtrace = None
    final = losses[-1]
    if steps and trace:
        out: list = []

        def run():
            nonlocal state
            for b in staged:
                state, m = step(state, b)
            out.append(m["loss"])

        rtrace = tr.profile_steps(
            run, HERE / "out" / cell.name / f"trace_rank{rank}.json",
            _counters)
        final = float(out[0])
    elif steps:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
        ev[0].record()
        for i, b in enumerate(staged):
            state, m = step(state, b)
            ev[i + 1].record()
        ev[-1].synchronize()
        step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
        window_ms = ev[0].elapsed_time(ev[-1])
        final = float(m["loss"])
    peak = max(peak, _peak(device))
    del state, step, staged
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    mine = RankResult(rank=rank, window_start=window_start, step_ms=step_ms,
                      window_ms=window_ms, steps=steps, peak_bytes=peak,
                      trace=rtrace, forbidden=forbidden_modules(),
                      final_loss=final, check_losses=losses, plan=plan,
                      kind=torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")
    every = _gather(mine, world)
    if rank != 0:
        return None
    log("rank 0: the reference's three steps")
    prog = ref_train.Readings(losses=losses, grad_norms=grad_norms,
                              change_norms=change_norms, ef_norms=ef_norms,
                              grad_sample=sample or None)
    ref = ref_train.run(cell, seed, device, steps=CHECK_STEPS)
    values, where = compare.gaps(prog, ref)
    correct, rows = compare.judge(values, spec["limits"])
    mine.check = {"correct": correct, "rows": rows, "where": where,
                  "ranks": every, "reference": ref, "program": prog}
    return mine
