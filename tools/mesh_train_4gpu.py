#!/usr/bin/env python3
"""Sharded training, the gradient syncs and the bandwidth engines across
four NVIDIA GPUs (NCCL, one rank a card), against the same grids on gloo
over the CPU and against ``mesh=None`` or a numpy oracle on each rank's own
card: the port's counterpart of the JAX package's multi-device battery.

Run from the root of a checkout on a machine with four cards::

    python3 tools/mesh_train_4gpu.py                # four ranks on the cards
    python3 tools/mesh_train_4gpu.py --device cpu   # a rehearsal on gloo

The ranks start through ``repro_torch.examples._world.launch``: one
``cpu:gloo,cuda:nccl`` process group over ``tcp://localhost``, so a rank
holds every CUDA result against the same call on CPU tensors over gloo.
Rank 0 prints one JSON line per check, the card's name and power limit,
and last ``{"ok": ...}``; the command fails if a check fails.  The
rehearsal runs every section at reduced sizes (``CPU_SIZES``), where the
"card" is the CPU and its gloo comparison is the same run.

All four cards sit in one host: ``pod`` and ``data`` are both NVLink, and
the slow inter-node domain the engines are built for is absent.  Every
time printed carries that caveat (``LINKS``).

* ``engines`` — the 12 registered engines and the 3 NAP extensions on the
  2x2, 4x1 and 1x4 grids their ``min_nodes`` / ``min_ppn`` admit, in
  float32, bfloat16 and int32, each engine's ops, at 1, 1,000 and
  2^20 + 7 elements (``mla_pipelined`` at 4 ragged chunks), and the RS ->
  AG round trips, against a numpy oracle of every rank's seeded input and
  against gloo: int32, max / min and gathers exact; a float32 sum within
  1e-6 x log2(world), a bfloat16 one within (world - 1) x 2^-8, of each
  element's sum of absolute values.  ``algorithm="auto"``'s pick at each
  payload and grid under the topology's constants (the card's on NCCL,
  ``perf_model.H100_NVLINK_HOST``; the reference's on gloo), and each
  engine's host ms a call (synchronised, median of ``reps``).
* ``sync`` — minicpm-2b-4l's gradient tree (published widths, bf16) plus
  an int32 leaf through ``sync_with_context`` (none / int8 / int4 /
  int4+EF) and ``sync_grads_sharded`` + ``unshard_grads`` (none / int8 /
  int4) on 2x2 and 4x1, over the transport kernels and the plain route:
  the kernel route bitwise equal to the plain one; the int leaf exact and
  the float leaves within the wire bound of the exact mean, on the cards
  and on gloo; the error-feedback residuals' sum equal to the rounding
  error sent; the kernel regions of the op trace and the cards' launches
  at 2 + 2 a compressed bucket (1 + 1 a float leaf on the RS route).
  At int4+EF, the sync timed against the route before F3's repair (error
  feedback's two decodes on the kernel: ``pre_f3_decodes``), bitwise
  equal to it.
* ``grad_sync_mesh`` — ``make_grad_sync`` on a 2x2 ``("pod", "data")``
  mesh over reduced minicpm's DTensor gradients at none / int8 / int4+EF:
  bitwise equal to ``sync_with_context`` on the local tensors, within
  1e-4 of the same mesh on gloo, launches 2 + 2 a compressed bucket.
* ``train_mesh`` — reduced minicpm and reduced deepseek-moe (capacity
  factor 4.0) on a 2x2 ``("data", "model")`` mesh: ``make_train_step(
  grad_shardings=)`` 3 steps from the CPU-seeded parameters against
  ``mesh=None`` on the card and against the mesh on gloo (1e-4);
  ``build_training(mesh=)`` 3 steps against ``mesh=None`` (1e-4), and a
  sharded checkpoint after step 2 resumed by a fresh loop to step 3,
  bitwise equal to the straight run (deterministic algorithms on).
* ``full_width`` — ``make_dp_train_step`` on minicpm-2b-4l (published
  widths) across 2x2, 2 x 512 tokens a rank, 4 steps: psum and nap in
  float32 (held within 1e-6 of each other) and in bf16 (within the
  reference's rtol 1e-4 / atol 1e-5: the two round bf16 sums
  differently), int8 and int4+EF in bf16 on the kernel and plain routes
  (bitwise equal, launches 4 x buckets x steps): ms a step (median after
  the first), tokens/s, peak memory per card.  psum in both types is held
  against the same step at world size 1 on rank 0's card over the whole
  8 x 512 global batch (``WORLD_ONE_TOL``).  Then
  ``build_training(mesh=)`` on minicpm-2b-8l on 2x2 ``("data",
  "model")`` at 8 x 512 in microbatches of 2, 3 steps: ms a step, peak
  memory per card, and the loss against ``mesh=None`` on rank 0's card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))
# the mesh checks' error at rtol / atol 1e-4 (``_err``) and helpers,
# shared with the serving battery
from mesh_serve_4gpu import _err, _np, with_capacity  # noqa: E402
# cuBLAS's deterministic workspace, for train_mesh's bitwise resume; set
# before any rank touches its card
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

WORLD_GRID = (2, 2)
GRIDS = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}
SYNC_GRIDS = ("2x2", "4x1")
DTYPES = ("float32", "bfloat16", "int32")
LINKS = ("one host: pod and data are both NVLink; no slow inter-node "
         "domain")
SEED = 0

CARD_SIZES = {
    "payloads": [1, 1000, 2 ** 20 + 7], "reps": 20, "chunks": 4,
    # gloo on the CPU takes 10-20 s a sync at this width: the cards are
    # held against gloo on 2x2, and against the exact mean on both grids
    "sync": {"config": "minicpm-2b-4l", "rows": 1, "seq": 128,
             "gloo_grids": ["2x2"]},
    "mesh": {"config": "minicpm-2b", "reduced": True, "rows": 2, "seq": 32},
    "train": {"configs": ["minicpm-2b", "deepseek-moe-16b"], "batch": 8,
              "seq": 32, "microbatch": 4, "steps": 3},
    "dp": {"config": "minicpm-2b-4l", "rows": 2, "seq": 512, "steps": 4},
    "trainer": {"config": "minicpm-2b-8l", "batch": 8, "seq": 512,
                "microbatch": 2, "steps": 3},
    "timeout": 560,
}
CPU_SIZES = {
    "payloads": [1, 1000, 4099], "reps": 2, "chunks": 4,
    "sync": {"config": "minicpm-2b", "reduced": True, "rows": 1, "seq": 16,
             "gloo_grids": list(SYNC_GRIDS)},
    "mesh": {"config": "minicpm-2b", "reduced": True, "rows": 2, "seq": 16},
    "train": {"configs": ["minicpm-2b", "deepseek-moe-16b"], "batch": 2,
              "seq": 8, "microbatch": 2, "steps": 3},
    "dp": {"config": "minicpm-2b", "reduced": True, "rows": 1, "seq": 16,
           "steps": 3},
    "trainer": {"config": "minicpm-2b", "reduced": True, "batch": 4,
                "seq": 16, "microbatch": 2, "steps": 3},
    "timeout": 300,
}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


class Report:
    """Rank 0 prints and keeps each row; every rank keeps its failed
    checks."""

    def __init__(self, rank: int):
        self.rank = rank
        self.rows: list[dict] = []
        self.bad: list[str] = []

    def emit(self, row: dict) -> None:
        if self.rank == 0:
            self.rows.append(row)
            print(json.dumps(row), flush=True)

    def hold(self, ok: bool, what: str) -> bool:
        if not ok:
            self.bad.append(what)
        return ok


def config(spec: dict):
    """``spec["config"]`` by name (an arch, a depth cut of minicpm-2b or a
    configuration of ``CHIP_FAMILIES``), ``reduced()`` if asked."""
    from repro_torch.configs import ARCHS, CHIP_FAMILIES, MINICPM_2B_4L
    from repro_torch.configs import MINICPM_2B_8L, reduced

    named = {c.name: c for c in (MINICPM_2B_4L, MINICPM_2B_8L,
                                 *CHIP_FAMILIES.values())}
    cfg = named.get(spec["config"]) or ARCHS[spec["config"]]
    return reduced(cfg) if spec.get("reduced") else cfg


def cuda_sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def peak_bytes(device):
    return torch.cuda.max_memory_allocated() if device.type == "cuda" \
        else None


def reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def gather(obj) -> list:
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _launches() -> dict:
    from repro_torch.kernels import transport

    return dict(transport.LAUNCHES)


def _reset_launches() -> None:
    from repro_torch.kernels import transport

    transport.reset_launch_counts()


def _regions(trace) -> dict:
    """Each transport kernel's regions in an op trace (the kernel route
    and the plain route alike)."""
    from repro_torch.launch.trace_analysis import analyze_trace

    got = analyze_trace(trace).kernel_launches
    return {k: got.get(f"transport.{k}", 0)
            for k in ("quantize_pack", "unpack_dequantize")}


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


def engine_inputs(world: int, size: int, dtype: str, seed: int):
    """(world, size) seeded values as each rank holds them: normals for
    the float types (rounded to bfloat16 for it), |x| < 1000 for int32."""
    rng = np.random.default_rng([seed, size, DTYPES.index(dtype)])
    if dtype == "int32":
        return torch.from_numpy(rng.integers(-999, 1000, (world, size),
                                             dtype=np.int32))
    x = torch.from_numpy(rng.standard_normal((world, size),
                                             dtype=np.float32))
    return x.to(getattr(torch, dtype))


def _oracle(x: torch.Tensor, op: str) -> np.ndarray:
    v = x.to(torch.float64).numpy()
    return {"sum": v.sum(0), "max": v.max(0), "min": v.min(0)}[op]


def excess(got, want, absum, dtype: str, op: str, world: int) -> float:
    """The error over its allowance (<= 1 passes): exact for int32, for
    max / min and for a gather; a float sum within ``tol`` of each
    element's sum of absolute values (``absum``): 1e-6 x log2(world) in
    float32, (world - 1) x 2^-8 in bfloat16, the bound of a sum rounded
    to bfloat16 once a hop (NCCL's ring does so within a node)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if dtype == "int32" or op != "sum":
        return 0.0 if np.array_equal(got, want) else math.inf
    if got.size == 0:
        return 0.0
    tol = (1e-6 * math.log2(world) if dtype == "float32"
           else (world - 1) * 2.0 ** -8)
    return float((np.abs(got - want) / (tol * absum + 1e-30)).max())


def held(got, gl, want, absum, dtype: str, op: str, world: int):
    """``(excess of the card against the oracle, excess of the card
    against gloo)``: two results each within the allowance of the exact
    value differ by at most twice it (an exact kind stays exact)."""
    return (excess(got, want, absum, dtype, op, world),
            excess(got, gl, absum, dtype, op, world) / 2)


def block_index(engine: str, size: int, n: int, ppn: int, rank: int):
    """Global indices of ``rank``'s reduce-scatter block and the mask of
    those that hold data.  The MLA engines use the stripe-block layout
    (rank (node j, lane r) holds block j of stripe r; stripes of
    ceil(size/ppn), blocks of ceil(stripe/n)); the flat fallbacks hold
    blocks of ceil(size/p) in rank order, as the reference's do."""
    node, lane = divmod(rank, ppn)
    S = -(-size // ppn)
    B = -(-S // n)
    k = np.arange(B)
    if engine.startswith("mla"):
        idx = lane * S + node * B + k
        return idx, (node * B + k < S) & (idx < size)
    idx = rank * B + k
    return idx, idx < size


def _time_ms(fn, reps: int, device) -> float:
    for _ in range(2):
        fn()
    ts = []
    for _ in range(reps):
        cuda_sync(device)
        t0 = time.perf_counter()
        fn()
        cuda_sync(device)
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def section_engines(rank, device, sizes, rep: Report) -> None:
    from repro_torch.core import CommContext, Topology, comm
    from repro_torch.core import extensions

    world = math.prod(WORLD_GRID)
    on_card = device.type == "cuda"
    payloads = sizes["payloads"]
    inputs = {(s, d): engine_inputs(world, s, d, SEED)
              for s in payloads for d in DTYPES}
    specs = sorted(comm.registered_engines().values(),
                   key=lambda s: (s.collective, s.name))

    for grid, (n, ppn) in GRIDS.items():
        topo = Topology.from_world(n, ppn)
        ctx = CommContext(topo)

        def run_both(call, x):
            """The call on the card and on gloo (the same run in a
            rehearsal); both as float64 numpy."""
            y = call(x.to(device))
            yc = call(x) if on_card else y
            return (y.to("cpu", torch.float64).numpy(),
                    yc.to(torch.float64).numpy())

        for spec in specs:
            if n < spec.min_nodes or ppn < spec.min_ppn:
                continue
            ops = sorted(spec.ops) if spec.ops is not None else ["sum"]
            worst, worst_gloo, same, cases = 0.0, 0.0, True, 0
            for dtype in DTYPES:
                for op in ops:
                    for size in payloads:
                        xs = inputs[(size, dtype)]
                        if spec.collective == "allgather":
                            full = xs[0]
                            idx, valid = block_index(spec.name, size, n,
                                                     ppn, rank)
                            blk = torch.zeros(idx.size, dtype=full.dtype)
                            blk[torch.from_numpy(valid)] = full[
                                torch.from_numpy(idx[valid])]
                            got, gl = run_both(
                                lambda x: ctx.allgather(
                                    x, elems=size, algorithm=spec.name),
                                blk)
                            want = full.to(torch.float64).numpy()
                            absum = np.abs(want)
                            got, gl = got[:size], gl[:size]
                        else:
                            want_full = _oracle(xs, op)
                            absum_full = xs.to(torch.float64).abs().sum(
                                0).numpy()
                            if spec.collective == "allreduce":
                                chunks = (sizes["chunks"]
                                          if spec.name == "mla_pipelined"
                                          else None)
                                got, gl = run_both(
                                    lambda x: ctx.allreduce(
                                        x, op, algorithm=spec.name,
                                        pipeline_chunks=chunks),
                                    xs[rank])
                                want, absum = want_full, absum_full
                            else:
                                idx, valid = block_index(spec.name, size, n,
                                                         ppn, rank)
                                got, gl = run_both(
                                    lambda x: ctx.reduce_scatter(
                                        x, op, algorithm=spec.name),
                                    xs[rank])
                                got, gl = got[valid], gl[valid]
                                want = want_full[idx[valid]]
                                absum = absum_full[idx[valid]]
                        # an allgather moves data: exact in every type
                        kind = ("gather" if spec.collective == "allgather"
                                else op)
                        e, eg = held(got, gl, want, absum, dtype, kind,
                                     world)
                        worst, worst_gloo = max(worst, e), max(worst_gloo,
                                                               eg)
                        same = same and bool(np.array_equal(got, gl))
                        cases += 1
                        rep.hold(e <= 1 and eg <= 1,
                                 f"engines {grid} {spec.name} {dtype} {op} "
                                 f"{size}: {e:.3g} / gloo {eg:.3g}")
            ms = {}
            for size in payloads:
                x = inputs[(size, "float32")][rank].to(device)
                if spec.collective == "allreduce":
                    chunks = (sizes["chunks"] if spec.name == "mla_pipelined"
                              else None)
                    call = lambda x=x, c=chunks: ctx.allreduce(  # noqa
                        x, algorithm=spec.name, pipeline_chunks=c)
                elif spec.collective == "reduce_scatter":
                    call = lambda x=x: ctx.reduce_scatter(  # noqa
                        x, algorithm=spec.name)
                else:
                    blk = x[: -(-size // world)]
                    call = lambda b=blk, s=size: ctx.allgather(  # noqa
                        b, elems=s, algorithm=spec.name)
                ms[str(size)] = _time_ms(call, sizes["reps"], device)
            rep.emit({"check": "engines", "grid": grid,
                      "engine": spec.name, "collective": spec.collective,
                      "cases": cases, "max_excess_vs_oracle": worst,
                      "max_excess_vs_gloo": worst_gloo,
                      "bitwise_equal_gloo": same, "ms_per_call": ms,
                      "links": LINKS})

        # RS -> AG round trips give back the sum
        pairs = [("psum_scatter", "all_gather")]
        if n >= 2:
            pairs.insert(0, ("mla_rs", "mla_ag"))
        for rs, ag in pairs:
            worst = 0.0
            for dtype in DTYPES:
                for size in payloads:
                    xs = inputs[(size, dtype)]
                    got, gl = run_both(
                        lambda x: ctx.allgather(
                            ctx.reduce_scatter(x, algorithm=rs),
                            elems=size, algorithm=ag), xs[rank])
                    absum = xs.to(torch.float64).abs().sum(0).numpy()
                    e = max(held(got, gl, _oracle(xs, "sum"), absum,
                                 dtype, "sum", world))
                    worst = max(worst, e)
                    rep.hold(e <= 1, f"roundtrip {grid} {rs}->{ag} "
                             f"{dtype} {size}: {e:.3g}")
            rep.emit({"check": "engines_roundtrip", "grid": grid,
                      "rs": rs, "ag": ag, "max_excess": worst})

        # the NAP extensions where they run (one node, or n a power of
        # ppn >= 2); elsewhere they refuse
        ext_ok = extensions.supported(n, ppn)
        worst, ms = 0.0, {}
        for size in payloads:
            for dtype in DTYPES:
                xs = inputs[(size, dtype)]
                rows = engine_inputs(world, world * size, dtype, SEED + 1)
                rows = rows.reshape(world, world, size)
                calls = {
                    "nap_allgather": (
                        lambda x: extensions.nap_allgather(x, topology=topo),
                        xs[rank], xs.to(torch.float64).numpy(),
                        np.abs(xs.to(torch.float64).numpy()), "gather"),
                    "nap_reduce_scatter": (
                        lambda x: extensions.nap_reduce_scatter(
                            x, topology=topo)[0],
                        rows[rank], _oracle(rows[:, rank], "sum"),
                        rows[:, rank].to(torch.float64).abs().sum(0)
                        .numpy(), "sum"),
                    "nap_allreduce_large": (
                        lambda x: extensions.nap_allreduce_large(
                            x, topology=topo),
                        xs[rank], _oracle(xs, "sum"),
                        xs.to(torch.float64).abs().sum(0).numpy(), "sum"),
                }
                for name, (call, x, want, absum, op) in calls.items():
                    if not ext_ok:
                        try:
                            call(x.to(device))
                        except ValueError:
                            continue
                        rep.hold(False, f"{name} ran on {grid}")
                        continue
                    got, gl = run_both(call, x)
                    e = max(held(got, gl, want, absum, dtype, op, world))
                    worst = max(worst, e)
                    rep.hold(e <= 1, f"{name} {grid} {dtype} {size}: "
                             f"{e:.3g}")
            if ext_ok:
                x = inputs[(size, "float32")][rank].to(device)
                ms[str(size)] = _time_ms(
                    lambda x=x: extensions.nap_allreduce_large(
                        x, topology=topo), sizes["reps"], device)
        rep.emit({"check": "engines_extensions", "grid": grid,
                  "supported": ext_ok, "max_excess": worst,
                  "nap_allreduce_large_ms_per_call": ms, "links": LINKS})

        # what "auto" picks (the topology's constants), and its run
        picks, worst = {}, 0.0
        for size in payloads:
            for coll in ("allreduce", "reduce_scatter", "allgather"):
                picks[f"{coll}/{size}"] = ctx.dispatch(
                    4 * size, collective=coll).engine
            xs = inputs[(size, "float32")]
            got, gl = run_both(lambda x: ctx.allreduce(x), xs[rank])
            absum = xs.to(torch.float64).abs().sum(0).numpy()
            e = max(held(got, gl, _oracle(xs, "sum"), absum, "float32",
                         "sum", world))
            worst = max(worst, e)
            rep.hold(e <= 1, f"auto {grid} {size}: {e:.3g}")
        rep.emit({"check": "engines_auto", "grid": grid,
                  "float32_bytes_to_engine": picks, "max_excess": worst,
                  "constants": topo.params.name})


# ---------------------------------------------------------------------------
# sync
# ---------------------------------------------------------------------------


def gradient_tree(cfg, rows: int, seq: int, rank: int, device):
    """One step's gradients of ``cfg`` on this rank's rows (seeded
    parameters, the same on every rank), plus an int32 leaf."""
    from repro_torch import tree
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model

    world = math.prod(WORLD_GRID)
    gen = torch.Generator(device=device).manual_seed(SEED)
    model = build_model(cfg, generator=gen, device=device)
    data = SyntheticLM(cfg.vocab_size, seq, rows * world, seed=SEED,
                       rank=rank, world=world)
    leaves, td = tree.flatten(model.params())
    loss, _ = model(data.batch(0, device))
    grads = torch.autograd.grad(loss, leaves)
    out = tree.unflatten(td, [g.detach() for g in grads])
    del model, leaves, loss, grads
    rng = np.random.default_rng([SEED, rank])
    out["count"] = torch.from_numpy(
        rng.integers(-1000, 1000, 4099, dtype=np.int32)).to(device)
    return out


def run_sync(ctx, route_kind: str, use_ef: bool, leaves, ef):
    """``(synced leaves, new residuals or the shards)`` of one sync."""
    from repro_torch.core import grad_sync

    if route_kind == "sharded":
        shards = ctx.sync_grads_sharded(leaves)
        return grad_sync.unshard_grads(shards, leaves, ctx=ctx), shards
    if use_ef:
        return ctx.sync_grads(leaves, ef_state=ef)
    return ctx.sync_grads(leaves), None


SYNC_POLICIES = (("none", {}), ("int8", dict(compress_bits=8)),
                 ("int4", dict(compress_bits=4)),
                 ("int4+ef", dict(compress_bits=4, error_feedback=True)))


@dataclasses.dataclass
class SyncOracle:
    """What a sync is held to: every rank's leaves (``g``) and their sum
    with the residuals (``c = g + r``) summed exactly and their largest
    magnitudes over the ranks."""

    leaves: list
    floats: list
    ints: list
    exact: list
    c_exact: list
    absmax: list
    c_absmax: list

    @classmethod
    def of(cls, leaves, ef, device):
        floats = [i for i, g in enumerate(leaves)
                  if g.dtype.is_floating_point]
        c = [g.float() + r for g, r in zip(leaves, ef)]
        return cls(leaves, floats,
                   [i for i in range(len(leaves)) if i not in floats],
                   _f64_sum(leaves, device), _f64_sum(c, device),
                   _f64_max(leaves, device), _f64_max(c, device))


def _f64_sum(leaves, device):
    """Every rank's leaves summed exactly (float64 allreduce on the
    card, or gloo in a rehearsal)."""
    import torch.distributed as dist

    out = []
    for t in leaves:
        s = t.to(device, torch.float64)
        dist.all_reduce(s)
        out.append(s)
    return out


def _f64_max(leaves, device):
    import torch.distributed as dist

    m = torch.stack([t.to(device, torch.float64).abs().max() for t in
                     leaves])
    dist.all_reduce(m, op=dist.ReduceOp.MAX)
    return m.tolist()


def _hold_equal(a, b) -> bool:
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def section_sync(rank, device, sizes, rep: Report) -> None:
    from repro_torch import tree
    from repro_torch.core import CommContext, CommPolicy, Topology
    from repro_torch.core import grad_sync
    from repro_torch.launch.trace_analysis import trace_call

    on_card = device.type == "cuda"
    if on_card:  # the gloo syncs share the host's cores four ways
        torch.set_num_threads(max(1, (os.cpu_count() or 4) // 4))
    spec = sizes["sync"]
    cfg = config(spec)
    leaves = tree.leaves(gradient_tree(cfg, spec["rows"], spec["seq"], rank,
                                       device))
    gen = torch.Generator(device=device).manual_seed(SEED + 1 + rank)
    ef = [torch.randn(g.shape, generator=gen, device=device) * 1e-3
          for g in leaves]
    oracle = SyncOracle.of(leaves, ef, device)
    cpu_leaves = [g.cpu() for g in leaves]
    cpu_ef = [r.cpu() for r in ef]

    for grid in SYNC_GRIDS:
        n, ppn = GRIDS[grid]
        topo = Topology.from_world(n, ppn)
        for route_kind in ("allreduce", "sharded"):
            for label, kw in SYNC_POLICIES:
                if route_kind == "sharded" and kw.get("error_feedback"):
                    continue  # the sharded route has no error feedback
                use_ef = bool(kw.get("error_feedback"))
                bits = kw.get("compress_bits")
                runs, ctxs = {}, {}
                for route in ("auto", "plain"):
                    if not bits and route == "plain":
                        continue
                    ctx = ctxs[route] = CommContext(topo, CommPolicy(
                        algorithm="auto", mean=True, transport_impl=route,
                        **kw))

                    # under the op tracer first, for its kernel regions
                    # (and a warm-up of the grid's groups), then timed
                    _, trace = trace_call(run_sync, ctx, route_kind, use_ef,
                                          leaves, ef)
                    regions = _regions(trace)
                    del trace, _
                    _reset_launches()
                    cuda_sync(device)
                    t0 = time.perf_counter()
                    out, extra = run_sync(ctx, route_kind, use_ef, leaves,
                                          ef)
                    cuda_sync(device)
                    ms = (time.perf_counter() - t0) * 1e3
                    runs[route] = dict(out=out, extra=extra, ms=ms,
                                       launches=_launches(),
                                       regions=regions)
                plan = grad_sync.plan_for_tree(leaves, cfg=ctx.policy,
                                               topology=topo)
                if not on_card:  # the rehearsal's card is gloo
                    g_out = runs["auto"]["out"]
                elif grid in spec["gloo_grids"]:
                    ctx_cpu = CommContext(topo, CommPolicy(
                        algorithm="auto", mean=True, **kw))
                    g_out, _ = run_sync(ctx_cpu, route_kind, use_ef,
                                        cpu_leaves, cpu_ef)
                else:
                    g_out = None
                tag = f"sync {grid} {route_kind} {label}"
                row = _sync_row(tag, route_kind, bits, use_ef, runs, g_out,
                                plan, oracle, n, ppn, on_card, rep)
                if use_ef:
                    row["ef_decodes"] = ef_decode_routes(
                        ctxs["auto"], leaves, ef, row["expected_regions"],
                        sizes["reps"], device, rep, tag)
                rep.emit(row | {"grid": grid, "route": route_kind,
                                "policy": label})


@contextlib.contextmanager
def pre_f3_decodes():
    """Error feedback's two decodes on the transport kernel, as
    ``_compressed_fused_allreduce`` ran them before F3's repair (two more
    unpack launches a bucket): the old route, timed beside the new one."""
    from repro_torch.core import grad_sync
    from repro_torch.kernels import transport

    def decode(wire, scales, *, offsets, bits, base, row_stride):
        cols = wire.shape[1] * (2 if bits == 4 else 1)  # the padded width
        return transport.unpack_dequantize(
            wire, scales, offsets=offsets, bits=bits, cols=cols, base=base,
            row_stride=row_stride)

    saved = grad_sync.ref
    grad_sync.ref = types.SimpleNamespace(unpack_dequantize_ref=decode)
    try:
        yield
    finally:
        grad_sync.ref = saved


def ef_decode_routes(ctx, leaves, ef, want, reps, device, rep, tag) -> dict:
    """F3's cost on the main EF path: the int4+EF sync with error
    feedback's decodes on the plain version (now) and on the kernel
    (before the repair), one call of each in turn, ``reps`` times after
    two warm-ups (median ms, host clock between synchronisations).  Both
    give the same outputs and residuals bitwise; the old route launches
    two more unpacks a bucket on the cards."""

    def once(old: bool):
        with pre_f3_decodes() if old else contextlib.nullcontext():
            cuda_sync(device)
            t0 = time.perf_counter()
            out = run_sync(ctx, "allreduce", True, leaves, ef)
            cuda_sync(device)
        return (time.perf_counter() - t0) * 1e3, out

    for _ in range(2):
        once(False)
        once(True)
    new, old = zip(*[(once(False)[0], once(True)[0]) for _ in range(reps)])
    _, a = once(False)
    _reset_launches()
    _, b = once(True)
    launches = _launches()
    same = _hold_equal(a[0], b[0]) and _hold_equal(a[1], b[1])
    rep.hold(same, f"{tag}: the EF decodes' two routes differ")
    old_want = ({"quantize_pack": want["quantize_pack"],
                 "unpack_dequantize": 2 * want["unpack_dequantize"]}
                if device.type == "cuda" else
                {"quantize_pack": 0, "unpack_dequantize": 0})
    rep.hold(launches == old_want,
             f"{tag}: the kernel decodes launched {launches}, want {old_want}")
    return {"plain_decodes_ms": statistics.median(new),
            "kernel_decodes_ms": statistics.median(old), "reps": reps,
            "kernel_decodes_launches": launches, "bitwise_equal": same}


def _sync_row(tag, route_kind, bits, use_ef, runs, g_out, plan,
              o: SyncOracle, n, ppn, on_card, rep) -> dict:
    """Hold one sync run (module docstring) and return its JSON row."""
    import torch.distributed as dist

    world = n * ppn
    leaves, floats, ints = o.leaves, o.floats, o.ints
    k = runs["auto"]
    row = {"check": "sync", "ms": k["ms"], "links": LINKS}
    if "plain" in runs:
        p = runs["plain"]
        row["plain_ms"] = p["ms"]
        same = _hold_equal(k["out"], p["out"])
        if use_ef:
            same = same and _hold_equal(k["extra"], p["extra"])
        row["kernel_bitwise_equal_plain"] = rep.hold(
            same, f"{tag}: kernel route != plain route")
    # int leaves exact; float leaves within the wire bound of the mean
    want_int = [torch.round(o.exact[i] / world) for i in ints]
    outs = [k["out"]] + ([g_out] if g_out is not None else [])
    ints_ok = all(
        torch.equal(out[i].to("cpu", torch.float64), w.cpu())
        for out in outs for i, w in zip(ints, want_int))
    row["int_leaves_exact"] = rep.hold(ints_ok, f"{tag}: int leaf")
    ref, amax = (o.c_exact, o.c_absmax) if use_ef else (o.exact, o.absmax)
    worst = 0.0
    for i in floats:
        mean = ref[i] / world
        top = float(mean.abs().max())
        # the leaf type's unit roundoff: the cast of the result (of the
        # exact mean plus the error below, hence |mean| + bound)
        cast = 2.0 ** -8 if leaves[i].dtype == torch.bfloat16 else 2.0 ** -24
        if not bits:
            # every partial sum is below world x absmax: world - 1 roundings
            # of the leaf's type, over world
            bound = (world - 1) * cast * amax[i]
        else:
            qmax = 2 ** (bits - 1) - 1
            if route_kind == "sharded":
                step = ppn * amax[i] / qmax
                bound = (n * step / 2 if n > 1 else 0.0) / world
            else:
                bound = 1.01 * amax[i] / qmax
            # float32 arithmetic on values up to world x absmax
            bound += 1e-6 * world * amax[i]
        for out in outs:
            got = out[i].to(mean.device, torch.float64)
            err = (got - mean).abs() - cast * (mean.abs() + bound)
            worst = max(worst, float(err.max()) / (bound + 1e-30))
        if g_out is not None:
            card_gloo = (k["out"][i].to("cpu", torch.float64)
                         - g_out[i].to(torch.float64)).abs().max()
            worst = max(worst, float(card_gloo) / (
                2 * bound + 2 * cast * top + 1e-30))
    row["max_error_over_bound"] = worst
    rep.hold(worst <= 1, f"{tag}: float leaves off the bound ({worst:.3g})")
    row["bitwise_equal_gloo"] = (None if g_out is None
                                 else _hold_equal(k["out"], g_out))
    if use_ef:
        # the residuals' sum is the rounding error sent: sum(c) - group *
        # the synced mean (float32 before the cast to the leaf's type)
        new_ef = list(k["extra"])
        worst = 0.0
        for i in floats:
            s = new_ef[i].to(torch.float64)
            dist.all_reduce(s)
            sent = o.c_exact[i] - world * k["out"][i].to(torch.float64)
            cast = 2.0 ** -8 if leaves[i].dtype == torch.bfloat16 else \
                2.0 ** -24
            slack = (world * cast * k["out"][i].to(torch.float64).abs()
                     + 1e-6 * float(o.c_exact[i].abs().max()))
            worst = max(worst, float(((s - sent).abs() / slack).max()))
        row["ef_residual_sum_vs_error_sent_over_slack"] = worst
        rep.hold(worst <= 1, f"{tag}: EF residuals != the error sent")
    # launches: 2 + 2 a compressed bucket (1 + 1 a float leaf on the RS
    # route with nodes to cross), on the cards' kernel route; the op
    # trace's kernel regions count both routes alike
    if bits:
        if route_kind == "sharded":
            per = len(floats) if n > 1 else 0
        else:
            per = 2 * sum(1 for b in plan.buckets
                          if leaves[b.leaves[0]].dtype.is_floating_point)
        want = {"quantize_pack": per, "unpack_dequantize": per}
    else:
        want = {"quantize_pack": 0, "unpack_dequantize": 0}
    row["buckets"] = len(plan.buckets)
    row["regions"] = k["regions"]
    row["launches"] = k["launches"]
    row["expected_regions"] = want
    ok = k["regions"] == want
    ok = ok and k["launches"] == (want if on_card else {
        "quantize_pack": 0, "unpack_dequantize": 0})
    if "plain" in runs:
        ok = ok and runs["plain"]["regions"] == want and not any(
            runs["plain"]["launches"].values())
    rep.hold(ok, f"{tag}: launches {k['launches']} regions {k['regions']} "
             f"want {want}")
    return row


# ---------------------------------------------------------------------------
# grad_sync_mesh
# ---------------------------------------------------------------------------


MESH_POLICIES = (("none", {}), ("int8", dict(compress_bits=8)),
                 ("int4+ef", dict(compress_bits=4, error_feedback=True)))


def section_grad_sync_mesh(rank, device, sizes, rep: Report) -> None:
    """``make_grad_sync`` on 2x2 ``("pod", "data")``: each rank's local
    gradients as DTensors (replicated placements, the values this rank's
    own), as the trainer hands them over.  ``make_grad_sync`` takes no
    residuals: int4+EF's policy runs its sync without them."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch import tree
    from repro_torch.core import CommPolicy, grad_sync
    from repro_torch.launch import make_mesh
    from repro_torch.launch.trace_analysis import trace_call

    spec = sizes["mesh"]
    grads = gradient_tree(config(spec), spec["rows"], spec["seq"], rank,
                          device)
    grads.pop("count")
    leaves, td = tree.flatten(grads)
    mesh = make_mesh((2, 2), ("pod", "data"))
    specs = tree.unflatten(td, [()] * len(leaves))

    def dtensors(ls, dev):
        dm = mesh.device_mesh(dev)
        return tree.unflatten(td, [
            DTensor.from_local(g, dm, [Replicate(), Replicate()],
                               run_check=False) for g in ls])

    def make(kw, route, dev):
        return grad_sync.make_grad_sync(
            CommPolicy(algorithm="nap", mean=True, transport_impl=route,
                       **kw),
            mesh, data_axes=("pod", "data"), grad_specs=specs,
            device=dev)

    for label, kw in MESH_POLICIES:
        runs = {}
        for route in ("auto", "plain") if kw else ("auto",):
            fn = make(kw, route, device.type)
            # traced first (and a warm-up), then timed
            _, trace = trace_call(fn, dtensors(leaves, device.type))
            regions = _regions(trace)
            _reset_launches()
            cuda_sync(device)
            t0 = time.perf_counter()
            res = tree.leaves(fn(dtensors(leaves, device.type)))
            cuda_sync(device)
            ms = (time.perf_counter() - t0) * 1e3
            runs[route] = dict(out=res, ms=ms, launches=_launches(),
                               regions=regions, plan=fn.plan,
                               context=fn.context)
        k = runs["auto"]
        tag = f"grad_sync_mesh {label}"
        direct = tree.leaves(grad_sync.sync_with_context(
            tree.unflatten(td, leaves), k["context"]))
        row = {"check": "grad_sync_mesh", "mesh": [[2, 2], ["pod", "data"]],
               "policy": label, "ms": k["ms"], "links": LINKS,
               "dtensor_out": rep.hold(
                   all(isinstance(t, DTensor) for t in k["out"]),
                   f"{tag}: not DTensors"),
               "bitwise_equal_sync_with_context": rep.hold(
                   _hold_equal([_local(t) for t in k["out"]], direct),
                   f"{tag}: != sync_with_context")}
        if "plain" in runs:
            row["kernel_bitwise_equal_plain"] = rep.hold(
                _hold_equal([_local(t) for t in k["out"]],
                            [_local(t) for t in runs["plain"]["out"]]),
                f"{tag}: kernel route != plain route")
        if device.type == "cuda":
            gl = tree.leaves(make(kw, "auto", "cpu")(
                dtensors([g.cpu() for g in leaves], "cpu")))
            err = max(_err(_local(a).double().cpu().numpy(),
                               _local(b).double().numpy())
                      for a, b in zip(k["out"], gl))
        else:
            err = 0.0  # the rehearsal's card is gloo
        row["err_vs_gloo"] = err
        rep.hold(err <= 1, f"{tag}: {err:.3g} off gloo")
        compressed = sum(1 for b in k["plan"].buckets
                         if leaves[b.leaves[0]].dtype.is_floating_point)
        per = 2 * compressed if kw else 0
        want = {"quantize_pack": per, "unpack_dequantize": per}
        none = {"quantize_pack": 0, "unpack_dequantize": 0}
        row.update(buckets=len(k["plan"].buckets), regions=k["regions"],
                   launches=k["launches"], expected_regions=want)
        ok = k["regions"] == want and k["launches"] == (
            want if device.type == "cuda" else none)
        if "plain" in runs:
            ok = ok and runs["plain"]["regions"] == want \
                and runs["plain"]["launches"] == none
        rep.hold(ok, f"{tag}: launches {k['launches']} regions "
                 f"{k['regions']} want {want}")
        rep.emit(row)


# ---------------------------------------------------------------------------
# train_mesh
# ---------------------------------------------------------------------------


def _opt():
    from repro_torch.configs import OptimizerConfig

    return OptimizerConfig(lr=1e-3, schedule="constant", warmup_steps=1)


def _train_cfg(spec, steps, every=0):
    from repro_torch.configs import TrainConfig

    return TrainConfig(steps=steps, seq_len=spec["seq"],
                       global_batch=spec["batch"],
                       microbatch=spec["microbatch"], seed=SEED,
                       checkpoint_every=every, optimizer=_opt())


def mesh_steps(cfg, params, mesh, dev, spec) -> dict:
    """``make_train_step(grad_shardings=)`` on ``mesh`` (or ``mesh=None``)
    from ``params``: the losses and every parameter's full value."""
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import make_policy, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init

    policy = make_policy(cfg, mesh, device=dev)
    model = build_model(cfg, params, policy=policy, device=dev)
    state = {"model": model, "opt": adamw_init(model.params())}
    step = make_train_step(
        model, _opt(), n_micro=spec["batch"] // spec["microbatch"],
        grad_shardings=(policy.param_specs(model.params())
                        if mesh is not None else None), device=dev)
    data = SyntheticLM(cfg.vocab_size, spec["seq"], spec["batch"],
                       seed=SEED, mesh=mesh,
                       batch_axes=("data",) if mesh is not None else ())
    losses = []
    for s in range(spec["steps"]):
        state, m = step(state, data.batch(s, dev))
        losses.append(float(m["loss"]))
    return {"losses": np.asarray(losses),
            "params": [_np(p) for p in model.leaves()]}


def _steps_err(a: dict, b: dict) -> float:
    return max([_err(a["losses"], b["losses"])]
               + [_err(x, y) for x, y in zip(a["params"], b["params"])])


def section_train_mesh(rank, device, sizes, rep: Report, tmp: Path) -> None:
    import torch.distributed as dist

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.launch import build_training, make_mesh
    from repro_torch.models import init_params

    spec = sizes["train"]
    steps = spec["steps"]
    dev = device.type
    mesh = make_mesh((2, 2), ("data", "model"))
    for name in spec["configs"]:
        cfg = with_capacity(reduced(ARCHS[name]), 4.0)
        tag = f"train_mesh {cfg.name}"
        params = init_params(cfg, generator=torch.Generator().manual_seed(
            SEED), device="cpu")
        card = mesh_steps(cfg, params, mesh, dev, spec)
        plain = mesh_steps(cfg, params, None, dev, spec)
        gloo = (mesh_steps(cfg, params, mesh, "cpu", spec)
                if dev == "cuda" else card)
        row = {"check": "train_mesh", "config": cfg.name,
               "mesh": [[2, 2], ["data", "model"]], "steps": steps,
               "make_train_step": {
                   "losses": card["losses"].tolist(),
                   "err_vs_mesh_none": _steps_err(card, plain),
                   "err_vs_gloo": _steps_err(card, gloo)}}
        mts = row["make_train_step"]
        rep.hold(mts["err_vs_mesh_none"] <= 1 and mts["err_vs_gloo"] <= 1
                 and np.isfinite(card["losses"]).all(),
                 f"{tag}: make_train_step {mts}")
        # build_training: straight, mesh=None, and a resume after step 2,
        # under deterministic algorithms (CUBLAS_WORKSPACE_CONFIG above)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            def loop(ckpt, m=mesh, every=0):
                return build_training(cfg, _train_cfg(spec, steps, every),
                                      mesh=m, ckpt_dir=tmp / ckpt,
                                      device=dev)

            def full(lp):
                return [_np(p) for p in lp.state["model"].leaves()]

            straight = loop(f"{name}_straight{rank}")
            straight.run(steps)
            none = loop(f"{name}_none{rank}", m=None)
            none.run(steps)
            first = loop(f"{name}_resume", every=2)
            first.run(2)
            dist.barrier()
            resumed = loop(f"{name}_resume", every=2)
            start = resumed.start_step
            resumed.run(steps)
            s_losses = [m["loss"] for m in straight.metrics_log]
            r_losses = ([m["loss"] for m in first.metrics_log][:start]
                        + [m["loss"] for m in resumed.metrics_log])
            sp, rp = full(straight), full(resumed)
            bt = {"losses": np.asarray(s_losses), "params": sp}
            nb = {"losses": np.asarray([m["loss"]
                                        for m in none.metrics_log]),
                  "params": full(none)}
            row["build_training"] = {
                "losses": s_losses,
                "err_vs_mesh_none": _steps_err(bt, nb),
                "resume_start_step": start,
                "resumed_losses": r_losses,
                "resume_bitwise_equal": bool(
                    start == 2 and r_losses == s_losses
                    and all(np.array_equal(a, b) for a, b in zip(sp, rp)))}
            del straight, none, first, resumed
        finally:
            torch.use_deterministic_algorithms(False)
        bt_row = row["build_training"]
        rep.hold(bt_row["err_vs_mesh_none"] <= 1,
                 f"{tag}: build_training {bt_row['err_vs_mesh_none']:.3g} "
                 "off mesh=None")
        rep.hold(bt_row["resume_bitwise_equal"], f"{tag}: resume differs")
        rep.emit(row)
        dist.barrier()


# ---------------------------------------------------------------------------
# full_width
# ---------------------------------------------------------------------------


# (label, dtype (None: the config's), policy, transport routes).  psum
# and nap in float32 too: in bfloat16 they round differently by design
# (NAP sums a node's two lanes in bfloat16, then folds in float32; psum
# sums across nodes in float32 once), in both packages
DP_POLICIES = (
    ("psum", "float32", dict(algorithm="psum"), ("auto",)),
    ("nap", "float32", dict(algorithm="nap"), ("auto",)),
    ("psum", None, dict(algorithm="psum"), ("auto",)),
    ("nap", None, dict(algorithm="nap"), ("auto",)),
    ("int8", None, dict(algorithm="nap", compress_bits=8),
     ("auto", "plain")),
    ("int4+ef", None, dict(algorithm="nap", compress_bits=4,
                           error_feedback=True), ("auto", "plain")),
)


# the 2x2 psum step against world size 1: (each step's loss relative to
# world size 1's, ||params - world 1's|| / ||world 1's - init||).  Both
# sum the same gradients in other orders; AdamW's first steps move each
# element by about lr whatever its gradient's size, so an element whose
# gradient is within rounding of 0 may step either way (PERF.md §6)
WORLD_ONE_TOL = {"float32": (1e-4, 1e-2), "bfloat16": (2.0 ** -5, 0.25)}


def dp_world_one(cfg, spec, dev, policy, world) -> dict:
    """The DP step at world size 1 on this rank's card: every rank's rows
    of each step's global batch at once, from the same seeded
    parameters.  Its losses, final parameters and initial ones."""
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import (init_train_state, make_dp_train_step,
                                    mesh_topology)

    step = make_dp_train_step(cfg, _opt(), mesh_topology(1, 1), policy,
                              device=dev)
    state = init_train_state(
        cfg, _opt(), policy, device=dev,
        generator=torch.Generator(device=dev).manual_seed(SEED))
    init = [p.detach().clone() for p in state["model"].leaves()]
    data = SyntheticLM(cfg.vocab_size, spec["seq"], spec["rows"] * world,
                       seed=SEED)
    losses = []
    for s in range(spec["steps"]):
        state, m = step(state, data.batch(s, dev))
        losses.append(float(m["loss"]))
    return {"losses": losses, "init": init,
            "params": [p.detach() for p in state["model"].leaves()]}


def world_one_err(losses, params, one: dict) -> dict:
    """The four ranks' losses and parameters (``params``, on the CPU)
    against world size 1's (:func:`dp_world_one`)."""
    d2 = u2 = 0.0
    for a, b, c in zip(params, one["params"], one["init"]):
        b = b.double()
        d2 += float((a.to(b.device).double() - b).square().sum())
        u2 += float((b - c.double()).square().sum())
    return {"losses": one["losses"],
            "loss_rel_diff": max(abs(a - b) / abs(b)
                                 for a, b in zip(losses, one["losses"])),
            "param_diff_over_change": math.sqrt(d2 / u2)}


def section_full_width(rank, device, sizes, rep: Report, tmp: Path) -> None:
    import torch.distributed as dist

    from repro_torch.core import CommPolicy
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import (build_training, init_train_state,
                                    make_dp_train_step, make_mesh,
                                    mesh_topology)

    dev = device.type
    world = math.prod(WORLD_GRID)
    spec = sizes["dp"]
    base = config(spec)
    topo = mesh_topology(*WORLD_GRID)
    data = SyntheticLM(base.vocab_size, spec["seq"], spec["rows"] * world,
                       seed=SEED, rank=rank, world=world)
    steps = spec["steps"]
    losses_of, kernel_params = {}, None
    for label, dtype, kw, routes in DP_POLICIES:
        cfg = dataclasses.replace(base, dtype=dtype or base.dtype)
        for route in routes:
            tag = f"full_width dp {label} {cfg.dtype} {route}"
            policy = CommPolicy(mean=True, transport_impl=route, **kw)
            reset_peak(device)  # and frees the last run's cached blocks
            _reset_launches()
            step = make_dp_train_step(cfg, _opt(), topo, policy, device=dev)
            state = init_train_state(
                cfg, _opt(), policy, device=dev,
                generator=torch.Generator(device=dev).manual_seed(SEED))
            losses, times = [], []
            for s in range(steps):
                batch = data.batch(s, dev)
                cuda_sync(device)
                t0 = time.perf_counter()
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
                times.append((time.perf_counter() - t0) * 1e3)
            launches = _launches()
            ms = statistics.median(times[1:])
            buckets = sum(1 for b in step.plan.buckets
                          if b.dtype.startswith(("float", "bfloat")))
            n_buckets = step.plan.num_buckets
            per = 2 * buckets * steps if kw.get("compress_bits") else 0
            want = per if dev == "cuda" and route == "auto" else 0
            params = [p.detach().cpu() for p in state["model"].leaves()]
            del state, step
            row = {"check": "full_width_dp", "config": cfg.name,
                   "dtype": cfg.dtype, "grid": "2x2", "policy": label,
                   "route": route, "tokens_a_rank": [spec["rows"],
                                                     spec["seq"]],
                   "steps": steps, "losses": losses,
                   "ms_per_step_median_after_first": ms,
                   "tokens_per_s": world * spec["rows"] * spec["seq"]
                   / (ms / 1e3),
                   "peak_memory_bytes_per_card": gather(peak_bytes(device)),
                   "buckets": n_buckets, "compressed_buckets": buckets,
                   "launches": launches, "links": LINKS}
            rep.hold(all(math.isfinite(v) for v in losses),
                     f"{tag}: loss not finite {losses}")
            rep.hold(all(v == want for v in launches.values()),
                     f"{tag}: launches {launches}, want {want} each")
            if route == "auto":
                losses_of[label, cfg.dtype] = losses
                kernel_params = params
            else:
                row["bitwise_equal_kernel_route"] = rep.hold(
                    losses == losses_of[label, cfg.dtype] and all(
                        torch.equal(a, b) for a, b in
                        zip(params, kernel_params)),
                    f"{tag}: differs from the kernel route")
            if label == "psum" and rank == 0:
                one = row["vs_world_1"] = world_one_err(
                    losses, params, dp_world_one(cfg, spec, dev, policy,
                                                 world))
                tol = WORLD_ONE_TOL[cfg.dtype]
                rep.hold(one["loss_rel_diff"] <= tol[0]
                         and one["param_diff_over_change"] <= tol[1],
                         f"{tag}: off world size 1 {one}, want within {tol}")
            if label == "nap":
                psum = losses_of["psum", cfg.dtype]
                rel = max(abs(a - b) / abs(b) for a, b in zip(losses, psum))
                row["loss_rel_diff_vs_psum"] = rel
                # float32: 1e-6; bfloat16: the reference's own check of
                # NAP against psum (rtol 1e-4, atol 1e-5)
                ok = (rel <= 1e-6 if cfg.dtype == "float32" else
                      bool(np.allclose(losses, psum, rtol=1e-4, atol=1e-5)))
                rep.hold(ok, f"{tag}: {rel:.3g} off psum")
            del params
            rep.emit(row)
    kernel_params = None

    # the mesh trainer at published widths
    spec = sizes["trainer"]
    cfg = config(spec)
    steps = spec["steps"]
    mesh = make_mesh((2, 2), ("data", "model"))
    reset_peak(device)
    lp = build_training(cfg, _train_cfg(spec, steps), mesh=mesh,
                        ckpt_dir=tmp / f"trainer_mesh{rank}", device=dev)
    lp.run(steps)
    mesh_losses = [m["loss"] for m in lp.metrics_log]
    mesh_ms = statistics.median(m["time_s"] for m in lp.metrics_log[1:]) \
        * 1e3
    peaks = gather(peak_bytes(device))
    del lp
    reset_peak(device)
    row = {"check": "full_width_mesh_trainer", "config": cfg.name,
           "dtype": cfg.dtype, "mesh": [[2, 2], ["data", "model"]],
           "batch": [spec["batch"], spec["seq"]],
           "microbatch": spec["microbatch"], "steps": steps,
           "losses": mesh_losses, "ms_per_step_median_after_first": mesh_ms,
           "tokens_per_s": spec["batch"] * spec["seq"] / (mesh_ms / 1e3),
           "peak_memory_bytes_per_card": peaks, "links": LINKS}
    if rank == 0:
        none = build_training(cfg, _train_cfg(spec, steps), mesh=None,
                              ckpt_dir=tmp / "trainer_none", device=dev)
        none.run(steps)
        none_losses = [m["loss"] for m in none.metrics_log]
        row["mesh_none"] = {
            "losses": none_losses,
            "ms_per_step_median_after_first": statistics.median(
                m["time_s"] for m in none.metrics_log[1:]) * 1e3,
            "peak_memory_bytes": peak_bytes(device)}
        rel = max(abs(a - b) for a, b in zip(mesh_losses, none_losses)) \
            / max(abs(b) for b in none_losses)
        row["loss_max_diff_over_max"] = rel
        # bf16 sums in other orders: a report, held at bf16's step
        rep.hold(rel <= 2.0 ** -7 and all(map(math.isfinite, mesh_losses)),
                 f"full_width mesh trainer: loss {rel:.3g} off mesh=None")
        del none
    dist.barrier()
    rep.emit(row)


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------


SECTIONS = ("engines", "sync", "grad_sync_mesh", "train_mesh", "full_width")


def run_sections(rep: Report, dev, calls: dict) -> dict:
    """Run each section of ``calls`` (name -> a call of no arguments) in
    turn on this rank; an exception is recorded as a failed check (a
    missing rule raises on every rank alike) and the next section runs.
    Returns this rank's failed checks and, on rank 0, the rows it
    printed."""
    import gc

    import torch.distributed as dist

    for name, call in calls.items():
        t0 = time.perf_counter()
        try:
            call()
        except Exception as e:
            rep.hold(False, f"{name}: {type(e).__name__}: {e}"[:600])
            rep.emit({"section": name, "error": traceback.format_exc()[
                -3000:]})
        dist.barrier()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        rep.emit({"section": name, "s": time.perf_counter() - t0,
                  "failed_so_far": len(rep.bad), "links": LINKS})
    return {"bad": rep.bad, "rows": rep.rows}


def rank_main(rank, topology, device, *, sizes, tmp) -> dict:
    """One rank: every section in turn (:func:`run_sections`)."""
    rep = Report(rank)
    dev = torch.device(device.type)  # the rank's card is the current one
    tmp = Path(tmp)
    fns = {"engines": section_engines, "sync": section_sync,
           "grad_sync_mesh": section_grad_sync_mesh,
           "train_mesh": section_train_mesh,
           "full_width": section_full_width}
    return run_sections(rep, dev, {
        name: functools.partial(
            fns[name], rank, dev, sizes, rep,
            *((tmp,) if name in ("train_mesh", "full_width") else ()))
        for name in SECTIONS})


def run(device=None) -> list:
    """The battery on four ranks (the cards unless ``device="cpu"``);
    every rank's :func:`rank_main` value."""
    from repro_torch.device import resolve_device
    from repro_torch.examples import _world

    dev = resolve_device(device)
    sizes = CPU_SIZES if dev.type == "cpu" else CARD_SIZES
    tmp = tempfile.mkdtemp(prefix="mesh_train_4gpu_")
    try:
        return _world.launch(rank_main, device=dev.type, grid=WORLD_GRID,
                             cpu_grid=WORLD_GRID, timeout=sizes["timeout"],
                             sizes=sizes, tmp=tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def conclude(ranks: list, dev, sections, t0: float, **summary) -> None:
    """Rank 0's last lines: on the cards their name and power limit, then
    ``{"ok": ...}`` over every rank's failed checks (with ``summary``'s
    fields); exits 1 if any failed."""
    bad = [b for r in ranks for b in r["bad"]]
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip(),
            flush=True)
    print(json.dumps({"ok": not bad, "failed": bad,
                      "sections": list(sections),
                      "world": math.prod(WORLD_GRID), "device": dev.type,
                      "s": time.perf_counter() - t0, **summary}),
          flush=True)
    if bad:
        raise SystemExit(1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default: four cards, NCCL) or cpu (a "
                         "rehearsal on four gloo processes)")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    try:
        ranks = run(dev.type)
    except (RuntimeError, TimeoutError) as e:
        print(json.dumps({"ok": False, "error": str(e)}), flush=True)
        raise SystemExit(1)
    conclude(ranks, dev, SECTIONS, t0)


if __name__ == "__main__":
    main()
