#!/usr/bin/env python3
"""The tensor-parallel serving spine across four NVIDIA GPUs (NCCL, one
rank a card): ``ServeEngine`` and ``serve_batch`` over a serving group,
against the same world on gloo over the CPU and against ``ctx=None`` on a
rank's own card.

Run from the root of a checkout on a machine with four cards::

    python3 tools/serve_tp_4gpu.py                 # four ranks on the cards
    python3 tools/serve_tp_4gpu.py --device cpu    # a rehearsal on gloo

The ranks start through ``repro_torch.examples._world.launch`` (one
``cpu:gloo,cuda:nccl`` process group, NCCL made eagerly with
``device_id=``, a world collective first), as ``tools/mesh_train_4gpu.py``
does; the helpers are that tool's.  Rank 0 prints one JSON line per check,
the card's name and power limit, and last ``{"ok": ...}``; the command
fails if a check fails.  ``--sections`` runs some of the sections (all
by default).  The rehearsal runs every section at reduced sizes
(``CPU_SIZES``), where the "card" is the CPU and its gloo comparison is the
same run.  One ``CommContext`` is built per grid (the launcher's 2x2
topology, ``Topology.from_world`` for 4x1 and 1x4) and passed to every
engine but the ``check`` section's ``mesh=`` one; the tool counts the
process groups it creates (``groups_created``).

All four cards sit in one host: ``pod`` and ``data`` are both NVLink, and
the slow inter-node domain the engines are built for is absent.  Every
time printed carries that caveat (``LINKS``).

* ``check`` — the JAX package's ``check_serve_continuous_batching`` on the
  cards: reduced minicpm-2b (float32, parameters drawn on the CPU from
  ``SEED``), 10 slots, ``max_len`` 24, buckets (4, 8), ``SERVE_WORKLOAD``
  with the third request submitted after one step.  On 2x2 through
  ``ServeEngine(mesh=make_mesh((2, 2), ("pod", "data")))``, on 4x1 and 1x4
  through ``ctx=``: continuous batching bitwise equal to serial decoding on
  every rank, the dispatch (2x2: ``nap`` / ``mla_ag`` / ``psum``; 4x1:
  ``mla`` / ``mla_ag``; 1x4: ``psum`` / ``all_gather``), ``b_max`` of the
  ragged split, and the tokens equal to the same engines on gloo.  Then
  ``serve_batch(ctx=)`` on each grid, each rank serving its row with the
  EOS exit agreed by the group: each row equal to its row of the whole
  batch served with ``ctx=None`` on the rank's own card.
* ``full_width`` — minicpm-2b-8l (published widths, bf16) on 2x2, 4x1 and
  1x4, the logits allreduce on ``auto`` and pinned to each engine the grid
  admits (``CommPolicy(algorithm=)``; a pin equal to auto's engine is
  auto's run): chip_smoke's ``SERVE`` traffic, all 12 requests, 8 at the
  start, so that the 8 slots are full.  Held: the 2 requests of the
  fewest tokens served alone, then continuous batching of all 12 through
  the same engine, their streams bitwise equal; ``dispatch_report()``
  equal to ``decode_dispatch``'s plan, its logits engine the pin or
  ``auto``'s planned one (``sizes["plan"]``), both under the topology's
  constants (the card's on NCCL); the greedy tokens of the
  requests served alone against a ``ctx=None`` engine on rank 0's card
  with a rank's row count (2), so that only the head differs, by the
  near-tie criterion (:func:`near_tie`).  Recorded: decode ms a step (the
  engine's host clock around each slice, which ends in the tokens' copy
  to the host; median of the continuous steps after the first, the
  profiled one left out), decode tokens/s, launches, NCCL kernels and
  device busy time of one profiled slice on rank 0, peak memory a card,
  the five kernels' launches (none on this path), and beside them the
  ``ctx=None`` engine of all 8 slots on rank 0's card on the same
  traffic.
* ``families`` — gemma2-27b-2l, rwkv6-1.6b, jamba-1.5-large-1s-4e and
  whisper-tiny (``extras_template``: 1500 seeded frames a request) on 2x2:
  4 requests of 16 new tokens, each also served alone, held as
  ``full_width``.
* ``router`` — a ``Router`` over two tensor-parallel engines that both span
  the 2x2 group (reduced minicpm-2b): every rank drives the same calls;
  ``observe_step`` is fed each engine step's duration maxed over the group
  (``ctx.allreduce(op="max", algorithm="psum")``); rank 1 stalls once
  inside a step of replica 1, and replica 0 dies later
  (``fail_replica``).  Held: the stall degrades replica 1 on every rank,
  the ranks' placements and health events are equal, every request
  finishes with its uninterrupted (serial) stream.  Beside it, monitors
  fed each rank's own clock show where the ranks would have disagreed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import math
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))
from mesh_train_4gpu import (  # noqa: E402
    GRIDS, LINKS, SEED, WORLD_GRID, Report, conclude, config, cuda_sync,
    gather, peak_bytes, reset_peak, run_sections,
)

#: the reference's check (tests/_torch_world.py's SERVE_WORKLOAD):
#: (prompt, max_new_tokens), two prompt buckets, three budgets
SERVE_WORKLOAD = (([3, 1, 4], 5), ([1, 5, 9, 2, 6], 4), ([2, 7, 1, 8], 6))
CHECK = dict(num_slots=10, max_len=24, buckets=(4, 8))
#: what the check's dispatch must be on each grid: (logits allreduce,
#: hidden allgather, EOS min-reduce); the same under the card's constants
#: (NCCL) and the reference's (gloo)
CHECK_DISPATCH = {"2x2": ("nap", "mla_ag", "psum"),
                  "4x1": ("mla", "mla_ag", "psum"),
                  "1x4": ("psum", "all_gather", "psum")}
#: the logits allreduce pinned to each engine a grid admits, after auto;
#: a pin equal to auto's engine on that grid is auto's run, not run again
PINS = {"2x2": ("auto", "psum", "nap", "mla", "mla_pipelined"),
        "4x1": ("auto", "psum", "mla"),
        "1x4": ("auto", "psum")}
#: the largest logit error, over the largest logit, that counts as the
#: head's rounding (four float32 partial products against one; the
#: reference engine has a rank's rows, so the trunks are the same)
NEAR_TIE_REL = 2.0 ** -10
#: serve_batch: one row of BATCH_PROMPT tokens a rank, BATCH_GEN tokens
BATCH_PROMPT, BATCH_GEN = 4, 6

# full_width's traffic is chip_smoke.py's SERVE, drawn the same way from
# SEED (8 slots of 512 positions, 12 requests: prompts of 16..256 tokens,
# 32..128 new tokens, 8 submitted at the start, the rest after two engine
# steps), so that the 8 slots are full.  ``serial`` requests, those of the
# fewest prompt + new tokens, are also served alone through each engine:
# their streams in the continuous run must equal those.
CARD_SIZES = {
    "full_width": {
        "config": "minicpm-2b-8l", "num_slots": 8, "max_len": 512,
        "buckets": (32, 64, 128, 256), "requests": 12, "prompt": (16, 256),
        "new": (32, 128), "first": 8, "after": 2, "serial": 2,
        # auto's logits engine at 8 slots (3.93 MB) under the topology's
        # constants: on NCCL the card's (perf_model.H100_NVLINK_HOST)
        "plan": {"2x2": "nap", "4x1": "mla", "1x4": "psum"}},
    "families": {
        "configs": ["gemma2-27b-2l", "rwkv6-1.6b", "jamba-1.5-large-1s-4e",
                    "whisper-tiny"],
        "num_slots": 8, "max_len": 256, "buckets": None, "requests": 4,
        "prompt": (8, 48), "new": (16, 16), "first": 3, "after": 2,
        "serial": 4, "frames": 1500,
        # under the card's constants, as full_width's
        "plan": {"gemma2-27b-2l": "nap", "rwkv6-1.6b": "nap",
                 "jamba-1.5-large-1s-4e": "nap", "whisper-tiny": "nap"}},
    "router": {"num_slots": 4, "max_len": 32, "buckets": (4, 8, 16),
               "requests": 10, "prompt": (3, 8), "new": (8, 12),
               "straggle_step": 6, "fail_step": 9},
    "timeout": 900,
}
CPU_SIZES = {
    "full_width": {
        "config": "minicpm-2b", "reduced": True, "num_slots": 8,
        "max_len": 48, "buckets": (8, 16, 32), "requests": 10,
        "prompt": (4, 24), "new": (4, 10), "first": 8, "after": 2,
        "serial": 2,
        "plan": {"2x2": "nap", "4x1": "mla", "1x4": "psum"}},
    "families": {
        "configs": ["gemma2-27b-2l", "rwkv6-1.6b", "jamba-1.5-large-1s-4e",
                    "whisper-tiny"], "reduced": True,
        "num_slots": 8, "max_len": 32, "buckets": None, "requests": 4,
        "prompt": (4, 12), "new": (6, 6), "first": 3, "after": 2,
        "serial": 4, "frames": 12,
        "plan": {name: "nap" for name in (
            "gemma2-27b-2l-smoke", "rwkv6-1.6b-smoke",
            "jamba-1.5-large-1s-4e-smoke", "whisper-tiny-smoke")}},
    "router": CARD_SIZES["router"],
    "timeout": 600,
}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _same_on_every_rank(value) -> bool:
    got = gather(value)
    return all(v == got[0] for v in got)


def _on_every_rank(flag: bool) -> bool:
    return all(gather(bool(flag)))


def kernel_launches(reset: bool = False) -> dict:
    """The five kernels' launch counts (transport and ``ops``); with
    ``reset``, zeroed first."""
    from repro_torch.kernels import ops, transport

    if reset:
        transport.reset_launch_counts()
        ops.reset_launch_counts()
    return {**dict(transport.LAUNCHES), **ops.launch_counts()}


def _used_bytes(device):
    """The card's memory in use (NCCL's buffers included); ``None`` on the
    CPU."""
    if device.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info()
    return total - free


@contextlib.contextmanager
def counting_groups():
    """Count the ``torch.distributed`` groups made inside the block (the
    comm layer makes its groups through ``dist.new_group``)."""
    import torch.distributed as dist

    made = []
    new_group = dist.new_group

    def counted(*args, **kwargs):
        pg = new_group(*args, **kwargs)
        made.append(pg)
        return pg

    dist.new_group = counted
    try:
        yield made
    finally:
        dist.new_group = new_group


class LogitTap:
    """Keeps row 0 of every logits block the decode heads of
    ``repro_torch.serve.decode`` take their argmax of (the output of their
    softcap), while :meth:`on` is entered and the tap is ``active``.  A
    request served alone sits in slot 0, whose row is 0 in both heads'
    layouts (rank 0 owns payload block 0)."""

    def __init__(self, active: bool):
        self.active = active
        self.rows: list[torch.Tensor] = []

    @contextlib.contextmanager
    def on(self):
        from repro_torch.serve import decode

        softcap = decode.softcap

        def tapped(x, cap):
            y = softcap(x, cap)
            if self.active:
                self.rows.append(y[0].detach().clone())
            return y

        decode.softcap = tapped
        try:
            yield self
        finally:
            decode.softcap = softcap


def make_engine(model, spec, device, *, ctx=None, mesh=None, extras=None):
    from repro_torch.serve import PromptBuckets, ServeEngine

    buckets = spec.get("buckets")
    template = None
    if extras is not None:  # an encoder-decoder: the frames' shape
        template = {k: torch.empty(np.shape(v), device="meta")
                    for k, v in extras[0].items()}
    return ServeEngine(model, num_slots=spec["num_slots"],
                       max_len=spec["max_len"],
                       buckets=PromptBuckets(buckets) if buckets else None,
                       ctx=ctx, mesh=mesh, extras_template=template,
                       device=device)


def _extras_kw(extras, i) -> dict:
    return {} if extras is None else {"extras": extras[i]}


def serve_serial(engine, traffic, extras=None, tap: LogitTap | None = None):
    """Each request alone through ``engine``, one after another (on an
    idle engine a request takes slot 0, the lowest free one): the
    streams, and with a ``tap`` each request's logits rows (row ``k``
    chose token ``k``)."""
    streams, logits = [], []
    for i, (prompt, new) in enumerate(traffic):
        start = len(tap.rows) if tap else 0
        with tap.on() if tap else contextlib.nullcontext():
            req = engine.submit(prompt, new, **_extras_kw(extras, i))
            streams.append(engine.run()[req.rid])
        if tap and tap.active:
            logits.append(tap.rows[start:])
    return streams, logits


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profiled_step(engine, device) -> dict:
    """One engine step under ``torch.profiler``: wall ms, launches, NCCL
    kernels, host syncs and device busy ms (``None`` on the CPU)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    cuda_sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.step()
        cuda_sync(device)
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    count = lambda *names: sum(e.count for e in events  # noqa: E731
                               if e.key in names)
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    busy = sum(_device_us(e) for e in kernels) / 1e3
    return {
        "wall_ms": wall,
        "launches": count("cudaLaunchKernel", "cuLaunchKernel",
                          "cudaLaunchKernelExC", "cuLaunchKernelEx"),
        "nccl_kernels": sum(e.count for e in kernels
                            if "nccl" in e.key.lower()),
        "host_syncs": count("cudaStreamSynchronize", "cudaDeviceSynchronize",
                            "cudaEventSynchronize"),
        "device_busy_ms": busy if device.type == "cuda" else None,
        "nccl_busy_ms": (sum(_device_us(e) for e in kernels
                             if "nccl" in e.key.lower()) / 1e3
                         if device.type == "cuda" else None)}


def serve_continuous(engine, traffic, first: int, after: int, extras=None,
                     profile_device=None) -> tuple[list, dict | None, list]:
    """Continuous batching: ``first`` requests at the start, the rest
    after ``after`` engine steps.  With ``profile_device`` the second step
    after the last admission runs under the profiler.  Returns the
    streams, that step's profile and the decode ms of the other steps."""
    reqs = [engine.submit(p, n, **_extras_kw(extras, i))
            for i, (p, n) in enumerate(traffic[:first])]
    n0 = len(engine.step_times)
    prof, prof_at = None, None
    for _ in range(after):
        engine.step()
    reqs += [engine.submit(p, n, **_extras_kw(extras, first + i))
             for i, (p, n) in enumerate(traffic[first:])]
    engine.step()  # the late requests' admission
    if profile_device is not None and not engine.idle:
        prof_at = len(engine.step_times)
        prof = profiled_step(engine, profile_device)
    else:
        engine.step()
    out = engine.run()
    ms = [sec * 1e3 for j, (_, sec, _) in enumerate(engine.step_times)
          if j >= n0 and j != prof_at]
    return [out[r.rid] for r in reqs], prof, ms


def _rates(streams, ms, prof: dict | None) -> dict:
    """Decode ms a step (median after the first step) and decode tokens/s
    over the run: every token over the decode slices' time, the profiled
    step's at its measured wall time (under the profiler)."""
    steady = ms[1:] or ms
    seconds = (sum(ms) + (prof["wall_ms"] if prof else 0.0)) / 1e3
    return {"decode_steps_timed": len(steady),
            "ms_per_step_median": statistics.median(steady),
            "ms_per_step_min": min(steady),
            "tokens_per_s": sum(map(len, streams)) / seconds}


def near_tie(tp_tokens, one_tokens, tp_logits, one_logits) -> dict:
    """The tensor-parallel stream against the one-card one: equal, or at
    the first token where they differ (1) each recorded logits row gives
    its own stream's token, (2) the one-card top-2 logit gap is no more
    than the spread of the TP logits' error over the vocabulary
    (``max(tp - one) - min(tp - one)``, the most that error can move the
    difference of two logits; with (1) a flip implies it), and (3) that
    error is of rounding's scale, at most ``NEAR_TIE_REL`` of the largest
    one-card logit: a wrong row or sum is of the logits' own scale."""
    if tp_tokens == one_tokens:
        return {"equal": True, "ok": True}
    k = next((j for j, (a, b) in enumerate(zip(tp_tokens, one_tokens))
              if a != b), None)
    if k is None:  # one is a prefix of the other: lengths differ
        return {"equal": False, "ok": False, "lengths": [len(tp_tokens),
                                                          len(one_tokens)]}
    one = one_logits[k].to("cpu", torch.float64)
    tp = tp_logits[k].to("cpu", torch.float64)
    top = torch.topk(one, 2).values
    gap = float(top[0] - top[1])
    d = tp - one
    spread = float(d.max() - d.min())
    rel = float(d.abs().max() / one.abs().max())
    replays = (int(one.argmax()) == one_tokens[k]
               and int(tp.argmax()) == tp_tokens[k])
    return {"equal": False, "first_diff": k, "of": len(one_tokens),
            "top2_gap": gap, "logit_err_spread": spread,
            "logit_err_max_abs": float(d.abs().max()),
            "logit_err_rel": rel, "rows_replay_tokens": replays,
            "ok": replays and gap <= spread and rel <= NEAR_TIE_REL}


def card_model(cfg, device):
    """``cfg``'s model from ``SEED``: drawn on the CPU for a reduced
    config; at published widths on the card (a CPU draw of jamba's ten
    billion values would take minutes), where every rank's card gives the
    same values (held by :func:`_params_checksum`)."""
    from repro_torch.models import build_model

    gen_dev = "cpu" if cfg.name.endswith("-smoke") else device.type
    gen = torch.Generator(device=gen_dev).manual_seed(SEED)
    if gen_dev == device.type:
        return build_model(cfg, generator=gen, device=device)
    cpu = build_model(cfg, generator=gen, device="cpu")
    return build_model(cfg, cpu.params(), device=device)


def _params_checksum(model) -> float:
    from repro_torch import tree

    return sum(float(torch.sum(t.detach(), dtype=torch.float64))
               for t in tree.leaves(model.params()))


def traffic_of(vocab: int, spec: dict, seed: int = SEED) -> list:
    """``spec["requests"]`` requests ``(prompt, new tokens)`` drawn as
    chip_smoke.py draws ``SERVE``: prompt length, new tokens, prompt
    tokens."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(spec["requests"]):
        n = int(rng.integers(spec["prompt"][0], spec["prompt"][1] + 1))
        new = int(rng.integers(spec["new"][0], spec["new"][1] + 1))
        out.append((rng.integers(0, vocab, n).tolist(), new))
    return out


def serial_pick(traffic, n: int) -> list[int]:
    """The ``n`` requests of the fewest prompt + new tokens, in order."""
    return sorted(sorted(range(len(traffic)),
                         key=lambda i: len(traffic[i][0]) + traffic[i][1])[:n])


def _sub(items, pick):
    return None if items is None else [items[i] for i in pick]


def frames_of(cfg, spec: dict, n: int) -> list | None:
    """Each request's seeded encoder frames (1, frames, D), float32 numpy,
    for an encoder-decoder; ``None`` otherwise."""
    if not cfg.encoder_layers:
        return None
    return [{"frames": (np.random.default_rng([SEED, 1000 + i])
                        .standard_normal((1, spec["frames"], cfg.d_model))
                        * 0.5).astype(np.float32)} for i in range(n)]


def _dispatch(report: dict) -> tuple:
    return tuple(report[k]["engine"] for k in (
        "logits_allreduce", "hidden_allgather", "eos_min_reduce"))


# ---------------------------------------------------------------------------
# check: the reference's serve_continuous_batching on the cards
# ---------------------------------------------------------------------------


def section_check(rank, device, sizes, rep: Report, ctxs) -> None:
    from repro_torch.configs import MINICPM_2B, reduced
    from repro_torch.core import napalg
    from repro_torch.launch import make_mesh
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import build_model

    cfg = reduced(MINICPM_2B)
    on_card = device.type == "cuda"
    cpu_model = build_model(cfg, generator=torch.Generator().manual_seed(
        SEED), device="cpu")
    model = (build_model(cfg, cpu_model.params(), device=device)
             if on_card else cpu_model)
    mesh = make_mesh(WORLD_GRID, ("pod", "data"))
    cpu = torch.device("cpu")
    group = math.prod(WORLD_GRID)
    b_max = max(napalg.ragged_splits(CHECK["num_slots"], group))

    for grid in GRIDS:
        def engine(m, dev):
            kw = {"mesh": mesh} if grid == "2x2" else {"ctx": ctxs[grid]}
            return make_engine(m, CHECK, dev, **kw)

        def streams(m, dev):
            serial, _ = serve_serial(engine(m, dev), SERVE_WORKLOAD)
            cont_engine = engine(m, dev)
            cont, _, _ = serve_continuous(cont_engine, SERVE_WORKLOAD, 2, 1)
            return serial, cont, cont_engine

        serial, cont, eng = streams(model, device)
        g_serial, g_cont, _ = (streams(cpu_model, cpu) if on_card
                               else (serial, cont, eng))
        tag = f"check {grid}"
        got = _dispatch(eng.dispatch_report())
        row = {"check": "check", "grid": grid,
               "engine_built_with": "mesh" if grid == "2x2" else "ctx",
               "tokens": cont,
               "continuous_equals_serial": rep.hold(
                   cont == serial, f"{tag}: continuous {cont} != serial "
                                   f"{serial}"),
               "gloo_continuous_equals_serial": rep.hold(
                   g_cont == g_serial, f"{tag}: gloo continuous != serial"),
               "equal_to_gloo": rep.hold(
                   cont == g_cont, f"{tag}: cards {cont} != gloo {g_cont}"),
               "same_on_every_rank": rep.hold(
                   _same_on_every_rank(cont), f"{tag}: ranks differ"),
               "dispatch": got,
               "dispatch_held": rep.hold(
                   got == CHECK_DISPATCH[grid],
                   f"{tag}: dispatch {got}, want {CHECK_DISPATCH[grid]}"),
               "b_max": eng.b_max,
               "b_max_held": rep.hold(eng.b_max == b_max,
                                      f"{tag}: b_max {eng.b_max} != {b_max}"),
               "budgets_met": rep.hold(
                   [len(s) for s in cont] == [b for _, b in SERVE_WORKLOAD],
                   f"{tag}: budgets {[len(s) for s in cont]}")}
        rep.emit(row)

    # the fixed-batch path: each rank serves its row; the EOS exit is
    # agreed by the group; the whole batch with ctx=None on this card is
    # the reference
    prompts = torch.from_numpy(np.random.default_rng([SEED, 9]).integers(
        0, cfg.vocab_size, (group, BATCH_PROMPT)))
    free = serve_batch(model, prompts, gen_len=BATCH_GEN, device=device)
    eos = int(free[0, 1])
    whole = serve_batch(model, prompts, gen_len=BATCH_GEN, eos_id=eos,
                        device=device).cpu()
    for grid in GRIDS:
        mine = serve_batch(model, prompts[rank:rank + 1], gen_len=BATCH_GEN,
                           eos_id=eos, ctx=ctxs[grid], device=device).cpu()
        ok = _on_every_rank(torch.equal(mine[0], whole[rank]))
        rep.emit({"check": "serve_batch", "grid": grid, "eos_id": eos,
                  "whole_batch": whole.tolist(),
                  "rows_equal_whole_batch": rep.hold(
                      ok, f"serve_batch {grid}: rank {rank}'s row "
                          f"{mine[0].tolist()} != {whole[rank].tolist()}")})


# ---------------------------------------------------------------------------
# full_width and families: one model over the grids and pins
# ---------------------------------------------------------------------------


def one_card_reference(model, spec, traffic, pick, extras, device,
                       rows: int) -> dict:
    """The ``ctx=None`` engines on this card.  ``spec``'s slot count: a
    timed continuous run of the whole traffic (the one-card baseline).
    ``rows`` slots, a tensor-parallel rank's row count: the ``pick``
    requests alone, with their logits rows; every trunk op has a rank's
    shapes, so its streams differ from the tensor-parallel ones only by
    the head."""
    engine = make_engine(model, spec, device, extras=extras)
    cont, _, ms = serve_continuous(engine, traffic, spec["first"],
                                   spec["after"], extras)
    del engine
    same = make_engine(model, {**spec, "num_slots": rows}, device,
                       extras=extras)
    rows_serial, rows_logits = serve_serial(
        same, _sub(traffic, pick), _sub(extras, pick), LogitTap(True))
    return {"rows": {"tokens": rows_serial, "logits": rows_logits},
            **_rates(cont, ms, None)}


def serve_grid(model, ctx, spec, traffic, pick, extras, one, rank, device,
               rep: Report, tag: str) -> dict:
    """One engine over ``ctx``: the ``pick`` requests alone (logits tapped
    on rank 0), then continuous batching of the whole traffic with one
    profiled step; the checks of ``full_width``."""
    from repro_torch.core import CommContext, Topology
    from repro_torch.serve.engine import decode_dispatch

    gc.collect()  # an earlier model's cycles, before the peak is reset
    reset_peak(device)
    kernel_launches(reset=True)
    engine = make_engine(model, spec, device, ctx=ctx, extras=extras)
    tap = LogitTap(rank == 0)
    serial, logits = serve_serial(engine, _sub(traffic, pick),
                                  _sub(extras, pick), tap)
    cont, prof, ms = serve_continuous(
        engine, traffic, spec["first"], spec["after"], extras,
        profile_device=device if rank == 0 else None)
    launches = kernel_launches()
    peaks = gather(peak_bytes(device))
    used = gather(_used_bytes(device))
    topo = ctx.topology
    plan = decode_dispatch(
        CommContext(Topology.of(topo.n_nodes, topo.ppn, params=topo.params),
                    ctx.policy), model.cfg, topo.group, engine.b_max)
    report = engine.dispatch_report()
    row = {"requests": len(cont), "served_alone": pick,
           "tokens_generated": sum(map(len, cont)),
           "continuous_equals_serial": rep.hold(
               _sub(cont, pick) == serial, f"{tag}: continuous != serial"),
           "same_on_every_rank": rep.hold(_same_on_every_rank(cont),
                                          f"{tag}: ranks' tokens differ"),
           "dispatch": {k: [v["engine"], v["pipeline_chunks"], v["nbytes"]]
                        for k, v in report.items()},
           "dispatch_is_plan": rep.hold(report == plan,
                                        f"{tag}: dispatch {report} != plan"),
           "constants": topo.params.name,
           "b_max": engine.b_max,
           # the serving path runs none of the five kernels
           "kernel_launches": launches,
           "no_kernel_launched": rep.hold(
               not any(launches.values()),
               f"{tag}: a kernel launched: {launches}"),
           **_rates(cont, ms, prof),  # rank 0's, printed
           "profiled_step": prof,
           "peak_memory_bytes_per_card": peaks,
           "device_memory_used_bytes_per_card": used,
           "links": LINKS}
    if rank == 0:
        ref = one["rows"]
        row["vs_one_card"] = [near_tie(t, o, lt, lo) for t, o, lt, lo in zip(
            serial, ref["tokens"], logits, ref["logits"])]
        # against the engine of a rank's row count: the one-card engine of
        # the whole slot count has other trunk shapes (tools/
        # serve_slots_witness.py)
        rep.hold(all(p["ok"] for p in row["vs_one_card"]),
                 f"{tag}: tokens off the one-card engine's beyond a near "
                 f"tie: {row['vs_one_card']}")
    del engine, tap, logits
    return row


def _pinned(ctx, pin: str):
    from repro_torch.core import CommPolicy

    return ctx if pin == "auto" else dataclasses.replace(
        ctx, policy=CommPolicy(algorithm=pin))


def _reference(model, spec, traffic, pick, extras, rank, device, rep, tag):
    """Rank 0's one-card reference (the other ranks wait); every rank holds
    that its parameters are rank 0's."""
    import torch.distributed as dist

    from repro_torch.core import napalg

    rep.hold(_same_on_every_rank(_params_checksum(model)),
             f"{tag}: the ranks' parameters differ")
    one = None
    if rank == 0:
        rows = max(napalg.ragged_splits(spec["num_slots"],
                                        math.prod(WORLD_GRID)))
        one = one_card_reference(model, spec, traffic, pick, extras, device,
                                 rows)
    dist.barrier()
    return one


def section_full_width(rank, device, sizes, rep: Report, ctxs) -> None:
    spec = sizes["full_width"]
    cfg = config(spec)
    model = card_model(cfg, device)
    traffic = traffic_of(cfg.vocab_size, spec)
    pick = serial_pick(traffic, spec["serial"])
    one = _reference(model, spec, traffic, pick, None, rank, device, rep,
                     "full_width")
    if rank == 0:
        rep.emit({"check": "full_width_one_card", "config": cfg.name,
                  "dtype": cfg.dtype,
                  "requests": [[len(p), n] for p, n in traffic],
                  **{k: one[k] for k in ("ms_per_step_median",
                                         "ms_per_step_min", "tokens_per_s")},
                  "links": "one card"})
    for grid, pins in PINS.items():
        auto = None  # auto's logits engine on this grid
        for pin in pins:
            tag = f"full_width {grid} {pin}"
            head = {"check": "full_width", "config": cfg.name,
                    "dtype": cfg.dtype, "grid": grid, "pin": pin}
            if pin == auto:
                rep.emit({**head, "ran_as": "auto"})
                continue
            row = serve_grid(model, _pinned(ctxs[grid], pin), spec, traffic,
                             pick, None, one, rank, device, rep, tag)
            logits = row["dispatch"]["logits_allreduce"][0]
            want = spec["plan"][grid] if pin == "auto" else pin
            row["logits_engine_held"] = rep.hold(
                logits == want, f"{tag}: logits on {logits}, want {want}")
            auto = logits if pin == "auto" else auto
            rep.emit({**head, **row})


def section_families(rank, device, sizes, rep: Report, ctxs) -> None:
    spec = sizes["families"]
    for name in spec["configs"]:
        cfg = config({"config": name, "reduced": spec.get("reduced")})
        model = card_model(cfg, device)
        traffic = traffic_of(cfg.vocab_size, spec)
        pick = serial_pick(traffic, spec["serial"])
        extras = frames_of(cfg, spec, len(traffic))
        tag = f"families {cfg.name}"
        one = _reference(model, spec, traffic, pick, extras, rank, device,
                         rep, tag)
        row = serve_grid(model, ctxs["2x2"], spec, traffic, pick, extras, one,
                         rank, device, rep, tag)
        logits = row["dispatch"]["logits_allreduce"][0]
        want = spec["plan"][cfg.name]
        row["logits_engine_held"] = rep.hold(
            logits == want, f"{tag}: logits on {logits}, want {want}")
        if rank == 0:
            row["one_card_ms_per_step_median"] = one["ms_per_step_median"]
        rep.emit({"check": "families", "config": cfg.name, "dtype": cfg.dtype,
                  "grid": "2x2", "pin": "auto", **row})
        del model, one


# ---------------------------------------------------------------------------
# router: two engines over one serving group
# ---------------------------------------------------------------------------


def section_router(rank, device, sizes, rep: Report, ctxs) -> None:
    from repro_torch.configs import MINICPM_2B, reduced
    from repro_torch.runtime.fault import ReplicaHealth
    from repro_torch.serve import Router

    spec = sizes["router"]
    cfg = reduced(MINICPM_2B)
    model = card_model(cfg, device)
    ctx = ctxs["2x2"]
    rng = np.random.default_rng([SEED, 2])
    traffic = [(rng.integers(0, cfg.vocab_size, int(rng.integers(
        spec["prompt"][0], spec["prompt"][1] + 1))).tolist(),
        int(rng.integers(spec["new"][0], spec["new"][1] + 1)))
        for _ in range(spec["requests"])]
    serial, _ = serve_serial(make_engine(model, spec, device, ctx=ctx),
                             traffic)

    replicas = [make_engine(model, spec, device, ctx=ctx) for _ in range(2)]
    router = Router(replicas)
    own_clock = [ReplicaHealth() for _ in replicas]  # this rank's clock
    own_events, stalled = [], None
    reqs = [router.submit(p, n) for p, n in traffic]
    step = 0
    while not router.idle:
        for i, eng in enumerate(replicas):
            if i in router.failed or eng.idle:
                continue
            cuda_sync(device)
            t0 = time.perf_counter()
            eng.step()
            if i == 1 and step == spec["straggle_step"] and rank == 1:
                # a stall inside this rank's step, after its collectives:
                # well above twice the agreed moving average
                stalled = 4 * router.health[1].monitor.ewma + 0.05
                time.sleep(stalled)
            cuda_sync(device)
            dt = time.perf_counter() - t0
            agreed = float(ctx.allreduce(
                torch.tensor([dt], dtype=torch.float32, device=device),
                op="max", algorithm="psum")[0])
            router.observe_step(i, step, agreed)
            if own_clock[i].monitor.record(step, dt) is not None:
                own_events.append((i, step))
        step += 1
        if step == spec["fail_step"]:
            router.fail_replica(0)
    streams = [r.generated for r in reqs]
    events = [[(e.step, round(e.ratio, 6)) for e in h.monitor.events]
              for h in router.health]
    flagged = any(e.step == spec["straggle_step"]
                  for e in router.health[1].monitor.events)
    own = gather(own_events)
    rep.emit({
        "check": "router", "grid": "2x2", "requests": len(reqs),
        "engine_steps": step, "rerouted": router.n_rerouted,
        "placements": [router.placement[r.rid] for r in reqs],
        "stall_s_rank1": gather(stalled)[1],
        "every_request_finished": rep.hold(
            all(r.state == "finished" for r in reqs),
            f"router: states {[r.state for r in reqs]}"),
        "streams_equal_uninterrupted": rep.hold(
            streams == serial, "router: a stream differs from its serial "
                               "one"),
        "stall_degraded_replica_1": rep.hold(
            flagged, f"router: the stall was not flagged: {events}"),
        "placements_equal_on_every_rank": rep.hold(
            # by request: ids come from a counter of the process
            _same_on_every_rank([router.placement[r.rid] for r in reqs]),
            "router: the ranks' placements differ"),
        "health_events_equal_on_every_rank": rep.hold(
            _same_on_every_rank(events), "router: health events differ"),
        "health_events": events,
        # (replica, step) a monitor fed this rank's own clock flagged
        "own_clock_events_by_rank": own,
        "own_clocks_agree": all(o == own[0] for o in own),
        "links": LINKS})


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------


SECTIONS = ("check", "full_width", "families", "router")


def rank_main(rank, topology, device, *, sizes,
              sections=SECTIONS) -> dict:
    """One rank: the grids' contexts, then each of ``sections`` in turn."""
    from repro_torch.core import CommContext, Topology

    rep = Report(rank)
    dev = torch.device(device.type)  # the rank's card is the current one
    with counting_groups() as made:
        ctxs = {grid: CommContext(topology if shape == WORLD_GRID
                                  else Topology.from_world(*shape))
                for grid, shape in GRIDS.items()}
        fns = {"check": section_check, "full_width": section_full_width,
               "families": section_families, "router": section_router}
        out = run_sections(rep, dev, {
            name: functools.partial(fns[name], rank, dev, sizes, rep, ctxs)
            for name in sections})
    # besides the launcher's 2x2 topology (its two intra- and two
    # inter-node groups), made before this rank ran
    rep.emit({"check": "groups", "groups_created": len(made)})
    return out


def run(device=None, sections=SECTIONS) -> list:
    """The tool on four ranks (the cards unless ``device="cpu"``); every
    rank's :func:`rank_main` value."""
    from repro_torch.device import resolve_device
    from repro_torch.examples import _world

    dev = resolve_device(device)
    sizes = CPU_SIZES if dev.type == "cpu" else CARD_SIZES
    return _world.launch(rank_main, device=dev.type, grid=WORLD_GRID,
                         cpu_grid=WORLD_GRID, timeout=sizes["timeout"],
                         sizes=sizes, sections=tuple(sections))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default: four cards, NCCL) or cpu (a "
                         "rehearsal on four gloo processes)")
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help="the sections to run, comma-separated, in the "
                         "tool's order (default: all)")
    args = ap.parse_args(argv)
    sections = tuple(n for n in SECTIONS if n in args.sections.split(","))
    if set(args.sections.split(",")) - set(SECTIONS):
        ap.error(f"--sections: each of {', '.join(SECTIONS)}")
    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    try:
        ranks = run(dev.type, sections)
    except (RuntimeError, TimeoutError) as e:
        print(json.dumps({"ok": False, "error": str(e)}), flush=True)
        raise SystemExit(1)
    conclude(ranks, dev, sections, t0)


if __name__ == "__main__":
    main()
