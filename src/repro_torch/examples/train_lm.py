"""End-to-end driver: train a 12-layer LM for a few hundred steps.

The port of ``examples/train_lm.py``.  The main mode trains
:data:`LM_100M` (a llama-style decoder at d 512, 66.7M parameters, of
which 16.4M are the tied embedding) through
:func:`~repro_torch.launch.train.build_training` on one device (the card
unless ``--device cpu``): synthetic data, AdamW with a cosine schedule,
async atomic checkpoints with auto-resume, straggler monitoring.  A
process "crash" at 60% of the steps drops the loop; a fresh loop on the
same directory must resume from the newest checkpoint (``start_step >
0``) and finish, and the loss must drop by more than 0.5.  A checkpoint
is published by renaming its finished directory and ``loop.run`` waits
for the last write, so the resumed loop never reads half a checkpoint.
The checkpoint directory defaults to a fresh temporary one.

``--compressed-smoke`` instead trains ``reduced(LM_100M)`` a few steps on
a world of one process per rank (:mod:`repro_torch.examples._world`: one
rank a card over NCCL, or with ``--device cpu`` gloo on the reference's
2 x 4 grid) through ``make_dp_train_step`` over each compressed
transport: int8, then packed int4 with error feedback.  The losses must be
finite; the first step of each is traced and held to the trace lint's
transport budget; on the card each bucket of each step must launch the
transport kernels as that budget says (``quantize_pack`` once and
``unpack_dequantize`` once at one rank; on more ranks twice each, and two
more unpacks with error feedback).  ``--transport plain`` routes the
transport to its plain version (checks only: it launches nothing).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200]
      PYTHONPATH=src python -m repro_torch.examples.train_lm \\
          --compressed-smoke [--device cpu] [--grid 2x4]
"""

from __future__ import annotations

import argparse
import shutil
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..configs.archs import reduced
from ..configs.base import ModelConfig, OptimizerConfig, SubLayer, TrainConfig
from ..device import resolve_device
from . import _world

LM_100M = ModelConfig(
    name="repro-lm-100m",
    family="dense",
    num_layers=12,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=32_000,
    pattern=(SubLayer("attn"),),
    dtype="float32",
    remat="none",
)

#: the compressed smoke's grid on the CPU (the reference's virtual mesh)
SMOKE_GRID = (2, 4)
SMOKE_SEQ, SMOKE_BATCH, SMOKE_SEED = 64, 8, 0


def train_config(steps: int, batch: int, seq: int,
                 checkpoint_every: int = 50) -> TrainConfig:
    """The main mode's run: cosine schedule over ``steps`` with 20 warm-up
    steps at peak lr 6e-4."""
    return TrainConfig(
        steps=steps, seq_len=seq, global_batch=batch,
        checkpoint_every=checkpoint_every,
        optimizer=OptimizerConfig(lr=6e-4, schedule="cosine",
                                  warmup_steps=20, decay_steps=steps),
    )


def train_with_crash(cfg, train_cfg: TrainConfig, ckpt_dir, *, device=None):
    """Train to 60% of ``train_cfg.steps``, drop the loop (the "crash"),
    then resume a fresh loop on ``ckpt_dir`` to the end.  Returns
    ``(loop, report)``: the resumed loop and the run's numbers (first and
    last loss, resume step, ms a step as the median after each loop's
    first, tokens/s, peak device memory on the card)."""
    from ..launch.train import build_training

    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    steps = train_cfg.steps
    crash_at = int(steps * 0.6)
    t0 = time.perf_counter()
    loop = build_training(cfg, train_cfg, ckpt_dir=ckpt_dir, device=device)
    loop.run(crash_at)
    first = loop.metrics_log[0]["loss"]
    times = [m["time_s"] for m in loop.metrics_log[1:]]
    print(f"[phase 1] step {crash_at}: loss "
          f"{loop.metrics_log[-1]['loss']:.3f}", flush=True)
    del loop  # "crash": the process state is gone; checkpoints survive

    loop = build_training(cfg, train_cfg, ckpt_dir=ckpt_dir, device=device)
    if loop.start_step <= 0:
        raise AssertionError("the loop must resume from a checkpoint, not "
                             "from scratch")
    resumed = loop.start_step
    print(f"[phase 2] auto-resumed at step {resumed}", flush=True)
    loop.run(steps)
    last = loop.metrics_log[-1]["loss"]
    times += [m["time_s"] for m in loop.metrics_log[1:]]
    ms = statistics.median(times) * 1e3 if times else float("nan")
    report = {
        "steps": steps, "crash_at": crash_at, "resumed_at": resumed,
        "first_loss": first, "last_loss": last,
        "ms_per_step": ms,
        "tokens_per_s": train_cfg.global_batch * train_cfg.seq_len / ms * 1e3,
        "wall_s": time.perf_counter() - t0,
        "stragglers": len(loop.monitor.events),
        "checkpoint_writes": len(loop.ckpt.writes),
        "peak_bytes": (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else None),
    }
    print(f"[done] steps={steps} loss {first:.3f} -> {last:.3f} "
          f"({report['wall_s']:.0f}s, stragglers={report['stragglers']})",
          flush=True)
    return loop, report


def main_mode(*, steps: int = 200, batch: int = 8, seq: int = 256,
              ckpt_dir=None, device=None) -> dict:
    """The reference's main mode (module docstring); raises unless the
    loss dropped by more than 0.5."""
    device = resolve_device(device)
    print(f"params ~= {LM_100M.param_count() / 1e6:.1f}M", flush=True)
    train_cfg = train_config(steps, batch, seq)
    with tempfile.TemporaryDirectory(prefix="repro_example_lm_") as tmp:
        if ckpt_dir is None:
            ckpt_dir = tmp
        else:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        _, report = train_with_crash(LM_100M, train_cfg, Path(ckpt_dir),
                                     device=device)
    if not report["last_loss"] < report["first_loss"] - 0.5:
        raise AssertionError(
            f"the loss must drop materially: {report['first_loss']:.4f} -> "
            f"{report['last_loss']:.4f}")
    return report


# ---------------------------------------------------------------------------
# --compressed-smoke
# ---------------------------------------------------------------------------

def smoke_policies(transport: str = "auto") -> list:
    from ..core import comm

    return [
        ("int8", comm.CommPolicy(algorithm="nap", mean=True, compress_bits=8,
                                 transport_impl=transport)),
        ("int4+ef", comm.CommPolicy(algorithm="nap", mean=True,
                                    compress_bits=4, error_feedback=True,
                                    transport_impl=transport)),
    ]


def launches_per_bucket(world: int) -> dict:
    """Each compressed bucket's transport launches in one sync
    (``grad_sync._compressed_fused_allreduce``), with error feedback or
    without: its decodes run the plain version."""
    if world == 1:
        return {"quantize_pack": 1, "unpack_dequantize": 1}
    return {"quantize_pack": 2, "unpack_dequantize": 2}


def compressed_rank(rank: int, topology, device, *, steps: int = 8,
                    transport: str = "auto") -> dict:
    """The reduced LM ``steps`` steps over each compressed transport from
    seed 0's parameters (drawn on the CPU): losses, ms a step,
    buckets, leaves, the transport's and AdamW's launches of the run, and
    the trace lint's violations of the first step (transport budget, wire
    dtypes)."""
    from ..analysis import trace_lint as tl
    from ..data import SyntheticLM
    from ..kernels import adamw as ka
    from ..kernels import transport as tk
    from ..launch.steps import init_train_state, make_dp_train_step
    from ..launch.trace_analysis import trace_call
    from ..models import init_params

    cfg = reduced(LM_100M)
    opt_cfg = OptimizerConfig(lr=1e-3, schedule="constant", warmup_steps=1)
    params = init_params(
        cfg, generator=torch.Generator().manual_seed(SMOKE_SEED),
        device="cpu")
    data = SyntheticLM(cfg.vocab_size, SMOKE_SEQ, SMOKE_BATCH,
                       seed=SMOKE_SEED, rank=rank, world=topology.group)
    out = {}
    for label, policy in smoke_policies(transport):
        step = make_dp_train_step(cfg, opt_cfg, topology, policy,
                                  device=device)
        state = init_train_state(cfg, opt_cfg, policy, params=params,
                                 device=device)
        buckets = step.plan.num_buckets
        per = launches_per_bucket(topology.group)
        losses, ms = [], []
        tk.reset_launch_counts()
        ka.reset_launch_counts()
        for s in range(steps):
            batch = data.batch(s, device)
            t0 = time.perf_counter()
            if s == 0:
                (state, m), trace = trace_call(step, state, batch)
            else:
                state, m = step(state, batch)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            if s == 0:
                violations = tl.lint_collective_counts(
                    trace, {"transport": sum(per.values()) * buckets})
                if topology.group > 1:
                    violations += tl.lint_compressed_wire(
                        trace, bits=policy.compress_bits,
                        payload_elems=min(b.elems for b in step.plan.buckets),
                        ppn=topology.ppn)
        out[label] = {
            "losses": losses, "ms": ms, "buckets": buckets,
            "launches": dict(tk.LAUNCHES),
            "adamw_launches": dict(ka.LAUNCHES),
            "leaves": len(step.plan.signature),
            "expected_launches": {
                k: (v * buckets * steps
                    if device.type == "cuda" and transport == "auto" else 0)
                for k, v in per.items()},
            "lint": [v.message for v in violations],
        }
        if rank == 0:
            print(f"[compressed-smoke] {label}: loss {losses[0]:.3f} -> "
                  f"{losses[-1]:.3f} ({len(losses)} steps, {buckets} "
                  f"buckets, launches {out[label]['launches']})", flush=True)
    return out


def compressed_smoke(*, steps: int = 8, device=None, grid=None,
                     transport: str = "auto") -> dict:
    """The smoke on a world; rank 0's numbers.  Raises on a loss that is
    not finite, a trace-lint violation, or launches off the budget."""
    ranks = _world.launch(compressed_rank, device=device, grid=grid,
                          cpu_grid=SMOKE_GRID, steps=min(steps, 8),
                          transport=transport)
    bad = []
    for r, out in enumerate(ranks):
        for label, row in out.items():
            if not all(np.isfinite(v) and abs(v) < 1e6
                       for v in row["losses"]):
                bad.append(f"rank {r} {label}: losses {row['losses']}")
            if row["lint"]:
                bad.append(f"rank {r} {label}: {row['lint']}")
            if row["launches"] != row["expected_launches"]:
                bad.append(f"rank {r} {label}: launches {row['launches']}, "
                           f"expected {row['expected_launches']}")
    if bad:
        raise AssertionError("compressed smoke: " + "; ".join(bad))
    print("[compressed-smoke] ok", flush=True)
    return ranks[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _world.add_arguments(ap)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary "
                         "one, removed at the end)")
    ap.add_argument("--compressed-smoke", action="store_true")
    ap.add_argument("--transport", default="auto", choices=("auto", "plain"),
                    help="compressed smoke: the transport kernels (auto) "
                         "or their plain versions")
    args = ap.parse_args(argv)
    if args.grid is not None and not args.compressed_smoke:
        ap.error("--grid applies to --compressed-smoke (the main mode runs "
                 "on one device)")
    if args.compressed_smoke:
        dev, grid = _world.world_grid(args.device, args.grid,
                                      cpu_grid=SMOKE_GRID)
        out = compressed_smoke(steps=args.steps, device=args.device,
                               grid=args.grid, transport=args.transport)
        report = {"example": "train_lm --compressed-smoke",
                  "device": dev.type, "grid": list(grid),
                  "transport": args.transport, "rank0": out}
    else:
        report = {"example": "train_lm", **main_mode(
            steps=args.steps, batch=args.batch, seq=args.seq,
            ckpt_dir=args.ckpt_dir, device=args.device)}
    _world.write_report(args.report, report)
    return report


if __name__ == "__main__":
    main()
