"""End-to-end training driver, on one device or on a mesh.

The port of ``repro/launch/train.py``: :func:`build_training` drives
:func:`~repro_torch.launch.steps.make_train_step` (microbatched gradient
accumulation in float32, AdamW at the schedule's rate) over the synthetic
LM data, with async atomic checkpoints, auto-resume and straggler
monitoring (:class:`~repro_torch.runtime.ResumableLoop`).  It runs on the
card unless asked for the CPU.  With a ``mesh`` (every rank of a
``torch.distributed`` world of the mesh's size calls it) the model takes
the reference's FSDP x TP layout on DTensor: the parameters are drawn
whole from the seed and then sharded (so a mesh run starts from the
numbers of a ``mesh=None`` run), the batch rows are placed over the DP
axes, and the gradients stay in the parameters' layout.  A sharded state
is checkpointed as full tensors, written once.

An encoder-decoder arch (whisper) cannot train here: ``SyntheticLM``
yields no encoder ``frames``, which its loss needs (the reference's
``build_training`` fails with ``KeyError: 'frames'`` at its first step);
:func:`build_training` refuses it up front.  Train it through
:func:`~repro_torch.launch.steps.make_train_step` on batches that carry
frames.

The train state ``{"model", "opt"}`` is what the checkpoint holds: the
model's parameters by name and the AdamW step and moments.  A restore
fills the live tensors in place, so a resumed run continues in the same
model.

Usage (on the card unless ``--device cpu``)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
      --reduced --device cpu --steps 3 --batch 8 --seq 128
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile
import time
from pathlib import Path

import torch

from ..checkpoint import CheckpointManager
from ..configs import ARCHS, get_config, reduced
from ..configs.base import OptimizerConfig, TrainConfig
from ..data import SyntheticLM
from ..device import resolve_device
from ..models import build_model
from ..optim import adamw_init
from ..runtime import ResumableLoop, StragglerMonitor
from .mesh import dp_axes as mesh_dp_axes
from .steps import make_policy, make_train_step

__all__ = ["build_training", "main"]

log = logging.getLogger("repro_torch.train")


def build_training(cfg, train_cfg: TrainConfig, *, mesh=None,
                   ckpt_dir: str | Path, device=None) -> ResumableLoop:
    """The resumable training loop of ``cfg`` under ``train_cfg`` on
    ``device`` (``cuda`` unless asked otherwise), on ``mesh`` (a
    :class:`~repro_torch.launch.mesh.Mesh`) or on one device.  The
    parameters are drawn from ``train_cfg.seed``; a checkpoint in
    ``ckpt_dir`` is restored into them (into their shards on a mesh,
    whatever layout wrote it).  ``loop.run(n)`` trains up to step ``n``;
    ``loop.metrics_log`` holds each step's scalar metrics.  Raises
    ``ValueError`` for an encoder-decoder arch (its data source yields no
    frames)."""
    if cfg.encoder_layers:
        raise ValueError(
            f"{cfg.name}: build_training's SyntheticLM yields no encoder "
            "frames; train an encoder-decoder through make_train_step on "
            "batches that carry 'frames'"
        )
    device = resolve_device(device)
    policy = make_policy(cfg, mesh, device=device)
    data = SyntheticLM(
        vocab_size=cfg.vocab_size,
        seq_len=train_cfg.seq_len,
        global_batch=train_cfg.global_batch,
        seed=train_cfg.seed,
        mesh=mesh,
        batch_axes=mesh_dp_axes(mesh) if mesh is not None else (),
    )
    n_micro = 1
    if train_cfg.microbatch:
        n_micro = train_cfg.global_batch // train_cfg.microbatch
    gen = torch.Generator(device=device).manual_seed(train_cfg.seed)
    model = build_model(cfg, generator=gen, device=device, policy=policy)
    train_step = make_train_step(
        model, train_cfg.optimizer, n_micro=n_micro, device=device,
        grad_shardings=(policy.param_specs(model.params())
                        if mesh is not None else None),
    )

    def make_state():
        opt = adamw_init(model.params(),
                         moment_dtype=train_cfg.optimizer.moment_dtype)
        return {"model": model, "opt": opt}

    def step_fn(state, step):
        state, metrics = train_step(state, data.batch(step, device))
        return state, {k: float(v) for k, v in metrics.items()
                       if not isinstance(v, torch.Tensor) or v.dim() == 0}

    ckpt = CheckpointManager(ckpt_dir, keep=train_cfg.keep_checkpoints,
                             async_save=True)
    return ResumableLoop(
        step_fn=step_fn,
        make_state=make_state,
        ckpt=ckpt,
        checkpoint_every=train_cfg.checkpoint_every,
        monitor=StragglerMonitor(),
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="same-family miniature config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    train_cfg = TrainConfig(
        steps=args.steps,
        seq_len=args.seq,
        global_batch=args.batch,
        microbatch=args.microbatch,
        checkpoint_every=args.ckpt_every,
        log_every=args.log_every,
        optimizer=OptimizerConfig(
            lr=args.lr,
            schedule=args.schedule,
            warmup_steps=max(5, args.steps // 10),
            decay_steps=args.steps,
        ),
    )
    loop = build_training(cfg, train_cfg, ckpt_dir=args.ckpt_dir,
                          device=device)
    t0 = time.time()
    loop.run(args.steps)
    losses = [m["loss"] for m in loop.metrics_log]
    if losses:
        print(
            f"steps={len(losses)} first_loss={losses[0]:.4f} "
            f"last_loss={losses[-1]:.4f} wall_s={time.time()-t0:.1f} "
            f"stragglers={len(loop.monitor.events)}"
        )


if __name__ == "__main__":
    main()
