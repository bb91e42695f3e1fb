"""Multi-pod dry run on the ``meta`` device: trace every (arch x shape x
mesh) cell of the production meshes.

The port of ``repro/launch/dryrun.py``.  For each cell this module:

  1. starts a fake default process group of 256 (16 x 16) or 512 (2 x 16 x
     16) ranks at rank 0, before any ``DeviceMesh`` (the counterpart of the
     reference's ``XLA_FLAGS`` device count, which must come first);
     collectives on it move nothing;
  2. builds the production mesh (``make_production_mesh()`` through
     ``Mesh.device_mesh("cpu")``) and the abstract state and batch
     (``state_specs`` / ``input_specs``: every leaf a ``meta`` tensor with
     its ``.spec``), made into DTensors on ``meta`` by their specs: no
     memory is allocated;
  3. runs the cell's step once under the op tracer
     (:mod:`repro_torch.launch.trace_analysis`): ``make_train_step`` (with
     ``microbatch_split``'s microbatches), ``make_prefill_step`` or
     ``make_serve_step`` (the cache updated in place: donated) — proving
     the layout coherent at 256 / 512 ranks (every op has a sharding rule,
     every collective a group);
  4. records rank 0's memory (arguments, outputs, aliased outputs, and the
     peak bytes of the tensors the step made, in place of XLA's temp
     bytes), the trace's totals and the three roofline terms with the
     H100's constants (:mod:`repro_torch.launch.roofline`) into
     ``reports/dryrun_torch/<cell>.json``, and the trace into
     ``<cell>.trace.json.gz`` (``repro_torch.launch.reanalyze`` re-derives
     the roofline from it).

The dry run is abstract by design, as the reference's is: it runs on
``meta`` and needs no card, and claims nothing about a device's time.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-27b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod-only|--single-pod-only]
  python -m repro_torch.launch.dryrun --list
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from .. import tree as tree_util
from ..configs import ARCHS, SHAPES
from . import roofline as rl
from .mesh import make_production_mesh
from .trace_analysis import Tracer, analyze_trace

__all__ = ["REPORTS", "LONG_OK", "cells", "cell_name", "fake_world",
           "build_cell", "run_cell", "main"]

REPORTS = Path(__file__).resolve().parents[3] / "reports" / "dryrun_torch"

# Applicability rules: long_500k only for sub-quadratic context growth
# (SSM / hybrid / windowed+alternating attention), as the reference's.
LONG_OK = {"gemma2-27b", "jamba-1.5-large-398b", "rwkv6-1.6b"}


def cells():
    for arch in sorted(ARCHS):
        for shape in SHAPES:
            if shape == "long_500k" and arch not in LONG_OK:
                continue
            yield arch, shape


def cell_name(arch: str, shape: str, multi_pod: bool) -> str:
    mesh = "pod2x16x16" if multi_pod else "pod16x16"
    return f"{arch}__{shape}__{mesh}"


def fake_world(n_ranks: int) -> None:
    """This process as rank 0 of a fake default group of ``n_ranks``
    (``torch.distributed``'s ``fake`` backend: every collective returns at
    once and moves nothing); a default group of another size is destroyed
    first."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == n_ranks and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)


def _overrides(opts: dict) -> dict:
    out = {}
    if "remat" in opts:
        out["remat"] = opts["remat"]
    if "scan_unroll" in opts:
        out["scan_unroll"] = int(opts["scan_unroll"])
    for key in ("window_kv_slice", "bf16_bwd", "mamba_bf16_io"):
        if key in opts:
            out[key] = bool(int(opts[key]))
    return out


def _local_leaves(x, out: list) -> list:
    """This rank's tensors of a step's argument or result: a model's
    parameters, AdamW's moments, trees of (D)Tensors."""
    from torch.distributed.tensor import DTensor

    from ..models import Model
    from ..optim.adamw import AdamWState

    if isinstance(x, Model):
        return _local_leaves(x.params(), out)
    if isinstance(x, AdamWState):
        return _local_leaves([x.mu, x.nu], out)
    if isinstance(x, DTensor):
        out.append(x.to_local())
    elif isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, dict):
        for v in x.values():
            _local_leaves(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _local_leaves(v, out)
    return out


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def build_cell(arch: str, shape_name: str, multi_pod: bool, *,
               seq_parallel: bool = False, opts: dict | None = None,
               cfg_overrides: dict | None = None, n_micro: int | None = None):
    """``(step, args, info)`` of one cell on the fake world: the step and
    its arguments as DTensors on ``meta``; ``info`` holds ``cfg``,
    ``shape``, ``mesh``, ``n_chips`` and, for a train cell, ``n_micro``
    (``microbatch_split``'s unless given).  ``cfg_overrides`` change the
    config beyond the levers of ``opts`` (a test's cut depth)."""
    from torch.distributed.tensor import distribute_tensor

    from ..models import Model
    from ..optim.adamw import AdamWState
    from .steps import (input_specs, make_policy, make_prefill_step,
                        make_serve_step, make_train_step, microbatch_split,
                        state_specs)

    opts = opts or {}
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = int(mesh.devices.size)
    fake_world(n_chips)
    serve2d = bool(int(opts.get("serve2d", 0)))
    model, _, state, opt_cfg = state_specs(
        arch, shape_name, mesh, seq_parallel=seq_parallel,
        cfg_overrides={**_overrides(opts), **(cfg_overrides or {})},
        serve2d=serve2d)
    cfg = model.cfg
    policy = make_policy(cfg, mesh, seq_parallel=seq_parallel,
                         mode="serve2d" if serve2d else "train", device="cpu")
    dm = policy.device_mesh

    def place(t):
        return distribute_tensor(t, dm, policy.placements(t.spec),
                                 src_data_rank=None)

    model = Model(cfg, tree_util.tree_map(place, state["params"]), policy)
    batch = {k: place(v) for k, v in input_specs(
        arch, shape_name, mesh, serve2d=serve2d).items()}
    info = {"cfg": cfg, "shape": shape, "mesh": mesh, "n_chips": n_chips}
    if shape.kind == "train":
        opt = state["opt"]
        opt = AdamWState(opt.step, [place(t) for t in opt.mu],
                         [place(t) for t in opt.nu])
        n_micro = info["n_micro"] = n_micro or microbatch_split(cfg, shape,
                                                                 mesh)
        grads = (policy.param_specs(model.params())
                 if bool(int(opts.get("grad_fix", 0))) else None)
        step = make_train_step(model, opt_cfg, n_micro=n_micro,
                               grad_shardings=grads, device="meta")
        args = ({"model": model, "opt": opt}, batch)
    elif shape.kind == "prefill":
        step = make_prefill_step(model, device="meta")
        args = (batch,)
    else:  # decode: the cache is the step's donated state
        cache = model.init_decode(
            shape.global_batch, shape.seq_len,
            batch=batch if cfg.encoder_layers else None)
        step = make_serve_step(model, device="meta")
        args = (cache, batch.get("tokens", batch.get("embeds")))
    return step, args, info


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    *,
    seq_parallel: bool = False,
    opts: dict | None = None,
    tag: str = "",
    force: bool = False,
    reports: Path | None = None,
) -> dict:
    """Trace one cell and write its record (module docstring); an existing
    record is returned unless ``force``.  ``opts`` (levers; absent = the
    baseline): ``grad_fix=1`` lays the gradients and the accumulator out
    as the parameters; ``remat=dots|none``; ``scan_unroll=N``;
    ``window_kv_slice=1``; ``bf16_bwd=1``; ``mamba_bf16_io=1``;
    ``serve2d=1`` (the serving layout: weights / cache over (model x
    data), batch replicated)."""
    opts = opts or {}
    reports = Path(reports) if reports is not None else REPORTS
    name = cell_name(arch, shape_name, multi_pod) + (f"__{tag}" if tag else "")
    out_path = reports / f"{name}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    t0 = time.time()
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "tag": tag,
        "opts": opts,
        "n_chips": 512 if multi_pod else 256,
        "ok": False,
    }
    try:
        step, args, info = build_cell(arch, shape_name, multi_pod,
                                      seq_parallel=seq_parallel, opts=opts)
        if "n_micro" in info:
            record["n_micro"] = info["n_micro"]
        arg_leaves = _local_leaves(args, [])
        tracer = Tracer()
        with tracer:
            out = step(*args)
        trace = tracer.trace
        arg_storages = {t.untyped_storage()._cdata for t in arg_leaves}
        out_leaves = _local_leaves(out, [])
        record["memory"] = {
            "argument_bytes": _nbytes(arg_leaves),
            "output_bytes": _nbytes(out_leaves),
            "alias_bytes": _nbytes(
                t for t in out_leaves
                if t.untyped_storage()._cdata in arg_storages),
            "peak_bytes": trace.peak_bytes,
        }
        stats = analyze_trace(trace)
        record["cost"] = {
            "flops": stats.flops,
            "bytes accessed": stats.memory_bytes,
            "conv_flops": stats.conv_flops,
            "collective_bytes": stats.collective_bytes,
            "dots": stats.dots,
            "flops_by_dtype": stats.flops_by_dtype,
        }
        roof = rl.analyze(stats, info["n_chips"],
                          rl.model_flops(info["cfg"], info["shape"]))
        record["roofline"] = roof.to_dict()
        record["trace_ops"] = sum(trace.ops.values())
        reports.mkdir(parents=True, exist_ok=True)
        trace.save(reports / f"{name}.trace.json.gz")
        record["ok"] = True
    except Exception as e:  # record failures: they are faults to fix
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    record["trace_s"] = round(time.time() - t0, 2)

    reports.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(record, indent=2, default=str))
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument(
        "--opts", default="",
        help="comma list key=val (grad_fix=1,remat=dots,scan_unroll=2,"
        "window_kv_slice=1,bf16_bwd=1,mamba_bf16_io=1,serve2d=1)",
    )
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)
    opts = dict(
        kv.split("=", 1) for kv in args.opts.split(",") if "=" in kv
    )

    if args.list:
        for a, s in cells():
            print(f"{a} {s}")
        return

    if args.all:
        meshes = []
        if not args.multi_pod_only:
            meshes.append(False)
        if not args.single_pod_only:
            meshes.append(True)
        n_fail = 0
        for mp in meshes:
            for arch, shape in cells():
                rec = run_cell(
                    arch, shape, mp,
                    seq_parallel=args.seq_parallel,
                    opts=opts, tag=args.tag, force=args.force,
                )
                status = "OK " if rec["ok"] else "FAIL"
                n_fail += 0 if rec["ok"] else 1
                dom = rec.get("roofline", {}).get("dominant", "-")
                print(
                    f"{status} {cell_name(arch, shape, mp):56s} "
                    f"trace={rec.get('trace_s', 0):7.1f}s dominant={dom}",
                    flush=True,
                )
        print(f"failures: {n_fail}")
        raise SystemExit(1 if n_fail else 0)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all / --list)")
    rec = run_cell(
        args.arch, args.shape, args.multi_pod,
        seq_parallel=args.seq_parallel, opts=opts, tag=args.tag,
        force=args.force,
    )
    print(json.dumps(rec, indent=2, default=str))
    raise SystemExit(0 if rec["ok"] else 1)


if __name__ == "__main__":
    main()
