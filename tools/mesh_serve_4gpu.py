#!/usr/bin/env python3
"""Serving and MoE on a mesh across four NVIDIA GPUs (NCCL, one rank a card),
against ``mesh=None`` on each rank's own card and against the same mesh on
gloo over the CPU.

Run from the root of a checkout on a machine with four cards::

    python3 tools/mesh_serve_4gpu.py                # four ranks on the cards
    python3 tools/mesh_serve_4gpu.py --device cpu   # a rehearsal on gloo

The four ranks join one process group with NCCL for CUDA tensors and gloo
for CPU tensors (``cpu:gloo,cuda:nccl``), over ``tcp://localhost``.
Rank 0 prints one JSON line per check, the card's name and power limit,
and last ``{"ok": ...}``; the command fails if a check fails.

* ``decode`` — reduced float32 minicpm-2b, gemma2-27b, granite-20b,
  jamba-1.5-large and deepseek-moe-16b (the MoE ones at capacity factor
  4.0: nothing drops) on a 2x2 ``("data", "model")`` mesh under the train
  layout and ``serve2d``: prefill logits, the decode logits of 6 prompt
  positions and 6 greedy tokens against ``mesh=None`` on the same card
  (rtol / atol 1e-4, tokens equal).  These are the paths that
  ``tests/test_torch_mesh_serve.py`` holds against the JAX package on
  gloo.
* ``moe`` — ``moe_apply`` of reduced deepseek-moe on 2x2 (the
  expert-parallel ``all_to_all`` route) and 4x1 (the local route with the
  global tokens' capacity) in train mode, and on 2x2 ``serve2d``, at
  capacity factors 1.0 (tokens drop) and 4.0: loss, output and gradients
  on the cards against the same mesh on gloo (rtol 1e-4, atol 1e-4 x
  max), and at 4.0 against ``mesh=None``.
* ``full_width`` — minicpm-2b-8l (published widths, 8 of 40 layers, bf16)
  and deepseek-moe-16b-2l (published widths, 2 layers, bf16; the
  expert-parallel route over the 2 model ranks) on the 2x2 mesh in both
  modes (their reduced configs in a rehearsal on the CPU): 8 rows of 128
  seeded prompt tokens, 32 greedy steps; the median
  decode ms a step (host clock between synchronisations), each layout's
  peak memory on rank 0's card, and against ``mesh=None`` on the same
  card the prefill and decode logits' largest difference over their
  largest value, the share of tokens equal and each row's equal tokens
  before the first that differs (bf16 sums in other orders may flip a
  close argmax, and greedy decode follows its own tokens after).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

WORLD = 4
MESHES = {"2x2": (2, 2), "4x1": (4, 1)}
AXES = ("data", "model")
TOL = 1e-4
B, P, STEPS = 4, 6, 6
FULL = dict(rows=8, prompt=128, steps=32)
DECODE_ARCHS = ("minicpm-2b", "gemma2-27b", "granite-20b",
                "jamba-1.5-large-398b", "deepseek-moe-16b")


def emit(rank: int, obj) -> None:
    if rank == 0:
        print(json.dumps(obj), flush=True)


def _whole(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _np(t) -> np.ndarray:
    return _whole(t).detach().to("cpu", torch.float32).numpy()


def _err(got: np.ndarray, want: np.ndarray) -> float:
    """The largest difference over the tolerance's allowance (<= 1
    passes): ``|got - want| / (TOL + TOL * |want|)``."""
    return float((np.abs(got - want) / (TOL + TOL * np.abs(want))).max())


def with_capacity(cfg, factor: float):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))


def decode(model, prompts, steps):
    """Prefill logits, the teacher-forced decode logits of every prompt
    position, and ``steps`` greedy tokens with each step's host time
    between synchronisations."""
    from repro_torch.launch import make_prefill_step, make_serve_step

    dev = prompts.device
    out = {"prefill": _np(make_prefill_step(model, tail=1, device=dev)(
        {"tokens": prompts}))}
    n, p = prompts.shape
    cache = model.init_decode(n, p + steps + 1)
    logits = []
    for t in range(p):
        lg, cache = model.decode_step(cache, prompts[:, t:t + 1])
        logits.append(_np(lg))
    out["logits"] = np.stack(logits)
    tok = torch.from_numpy(np.argmax(logits[-1][:, -1], -1)[:, None]).to(dev)
    step = make_serve_step(model, device=dev)
    toks, ms = [tok], []
    for _ in range(steps):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, cache = step(cache, tok)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        toks.append(tok)
    out["tokens"] = torch.cat(toks, 1).cpu().numpy()
    out["ms"] = ms
    return out


def check_decode(rank, device) -> list:
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.launch import make_mesh, make_policy
    from repro_torch.models import build_model, init_params

    mesh = make_mesh(MESHES["2x2"], AXES)
    bad = []
    for arch in DECODE_ARCHS:
        cfg = reduced(ARCHS[arch])
        if cfg.moe is not None:
            cfg = with_capacity(cfg, 4.0)
        params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
        prompts = torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab_size, (B, P))).to(device)
        runs, row = {}, {"check": "decode", "arch": arch}
        for name, m, mode in (("plain", None, "train"),
                              ("train", mesh, "train"),
                              ("serve2d", mesh, "serve2d")):
            model = build_model(cfg, params, device=device,
                                policy=make_policy(cfg, m, mode=mode,
                                                   device=device))
            try:
                runs[name] = decode(model, prompts, STEPS)
            except RuntimeError as e:  # a DTensor rule this torch lacks
                row[name] = {"error": str(e)[:300]}
                bad.append(f"decode {arch} {name}: {e}")
        for name in ("train", "serve2d"):
            if name not in runs:
                continue
            got, want = runs[name], runs["plain"]
            row[name] = {
                "prefill_err": _err(got["prefill"], want["prefill"]),
                "logits_err": _err(got["logits"], want["logits"]),
                "tokens_equal": bool((got["tokens"]
                                      == want["tokens"]).all())}
            if not (row[name]["prefill_err"] <= 1
                    and row[name]["logits_err"] <= 1
                    and row[name]["tokens_equal"]):
                bad.append(f"decode {arch} {name}")
        emit(rank, row)
    return bad


def moe_run(cfg, mesh, mode, inputs, device, grads: bool) -> dict:
    """``moe_apply`` under the policy of ``mesh`` / ``mode`` on ``device``:
    the loss ``sum(y * proj) + aux``, ``y`` and (``grads``) the gradients
    of ``x`` and of every parameter."""
    from repro_torch import tree
    from repro_torch.launch import make_policy
    from repro_torch.models import moe as tmoe

    policy = make_policy(cfg, mesh, mode=mode, device=device)
    params = tree.tree_map(lambda a: torch.from_numpy(a).to(device),
                           inputs["params"])
    params = policy.shard_params(params)
    leaves = [p.requires_grad_() for p in tree.leaves(params)]
    x = torch.from_numpy(inputs["x"]).to(device)
    if mesh is not None:
        x = policy.constrain(x, (policy.dp, None, None)).detach()
    x.requires_grad_(grads)
    with policy.scope():
        y, aux = tmoe.moe_apply(params, x, cfg=cfg, policy=policy)
        loss = (y * torch.from_numpy(inputs["proj"]).to(device)).sum() + aux
        out = {"loss": _np(loss), "y": _np(y)}
        if grads:
            g = torch.autograd.grad(loss, [x] + leaves)
            out.update({f"grad{i}": _np(t) for i, t in enumerate(g)})
    return out


def moe_inputs(cfg) -> dict:
    m, D = cfg.moe, cfg.d_model
    E, F, Fs = m.num_experts, m.d_expert, m.num_shared_experts * m.d_expert
    rng = np.random.default_rng(21)
    n = lambda *shape, s=1.0: (rng.standard_normal(shape) * s).astype(  # noqa
        np.float32)
    return {
        "params": {
            "w_router": n(D, E, s=D ** -0.5),
            "we_gate": n(E, D, F, s=D ** -0.5),
            "we_up": n(E, D, F, s=D ** -0.5),
            "we_down": n(E, F, D, s=F ** -0.5),
            "shared": {"w_gate": n(D, Fs, s=D ** -0.5),
                       "w_up": n(D, Fs, s=D ** -0.5),
                       "w_down": n(Fs, D, s=Fs ** -0.5)},
        },
        "x": n(8, 16, D), "proj": n(8, 16, D),
    }


def check_moe(rank, device) -> list:
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.launch import make_mesh

    base = reduced(ARCHS["deepseek-moe-16b"])
    inputs = moe_inputs(base)
    bad = []
    for cf in (1.0, 4.0):
        cfg = with_capacity(base, cf)
        plain = moe_run(cfg, None, "train", inputs, device, grads=True)
        for name, shape, mode in (("2x2", MESHES["2x2"], "train"),
                                  ("4x1", MESHES["4x1"], "train"),
                                  ("2x2_serve2d", MESHES["2x2"], "serve2d")):
            mesh = make_mesh(shape, AXES)
            grads = mode == "train"
            card = moe_run(cfg, mesh, mode, inputs, device, grads)
            gloo = moe_run(cfg, mesh, mode, inputs, "cpu", grads)
            row = {"check": "moe", "mesh": name, "capacity_factor": cf,
                   "loss": float(card["loss"]),
                   "err_vs_gloo": max(_err(card[k], gloo[k])
                                      for k in card)}
            ok = row["err_vs_gloo"] <= 1
            if cf == 4.0:  # nothing drops: every route is mesh=None's
                row["err_vs_plain"] = max(_err(card[k], plain[k])
                                          for k in card)
                ok = ok and row["err_vs_plain"] <= 1
            if not ok:
                bad.append(f"moe {name} cf {cf}")
            emit(rank, row)
    return bad


def check_full_width(rank, device) -> list:
    from repro_torch.configs import (
        ARCHS, CHIP_FAMILIES, MINICPM_2B_8L, reduced,
    )
    from repro_torch.launch import make_mesh, make_policy
    from repro_torch.models import build_model, init_params

    mesh = make_mesh(MESHES["2x2"], AXES)
    cfgs = (MINICPM_2B_8L, CHIP_FAMILIES["deepseek-moe-16b-2l"])
    if device.type == "cpu":  # the rehearsal: the same path, reduced
        cfgs = (reduced(ARCHS["minicpm-2b"]),
                reduced(ARCHS["deepseek-moe-16b"]))
    bad = []
    for cfg in cfgs:
        params = init_params(cfg, generator=torch.Generator(
            device=device).manual_seed(0), device=device)
        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (FULL["rows"], FULL["prompt"]))).to(device)
        row = {"check": "full_width", "config": cfg.name,
               "dtype": cfg.dtype, "rows": FULL["rows"],
               "prompt": FULL["prompt"], "steps": FULL["steps"]}
        runs = {}
        for name, m, mode in (("plain", None, "train"),
                              ("train", mesh, "train"),
                              ("serve2d", mesh, "serve2d")):
            if device.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            model = build_model(cfg, params, device=device,
                                policy=make_policy(cfg, m, mode=mode,
                                                   device=device))
            run = decode(model, prompts, FULL["steps"])
            del model
            runs[name] = run
            row[name] = {
                "decode_ms_per_step_median": statistics.median(run["ms"]),
                "peak_device_memory_bytes": (
                    torch.cuda.max_memory_allocated()
                    if device.type == "cuda" else None),
                "finite": bool(np.isfinite(run["logits"]).all())}
            if not row[name]["finite"]:
                bad.append(f"full_width {cfg.name} {name} not finite")
        want = runs["plain"]
        for name in ("train", "serve2d"):
            got = runs[name]
            same = got["tokens"] == want["tokens"]
            row[name].update({
                "tokens_equal_share": float(same.mean()),
                # per row, the tokens equal to mesh=None's before the first
                # that differs (greedy decode follows its own tokens after)
                "leading_equal_tokens": [
                    int(np.argmin(r)) if not r.all() else len(r)
                    for r in same],
                "prefill_rel_err": float(
                    np.abs(got["prefill"] - want["prefill"]).max()
                    / np.abs(want["prefill"]).max()),
                "logits_rel_err": float(
                    np.abs(got["logits"] - want["logits"]).max()
                    / np.abs(want["logits"]).max())})
        del params
        emit(rank, row)
    return bad


def rank_main(rank: int, port: int, device_type: str) -> None:
    import torch.distributed as dist

    if device_type == "cuda":
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    backend = "cpu:gloo,cuda:nccl" if device_type == "cuda" else "gloo"
    # a collective that some rank never joins ends the run in minutes
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(minutes=3))
    device = torch.device(device_type)
    bad = []
    try:
        for check in (check_decode, check_moe, check_full_width):
            t0 = time.perf_counter()
            bad += check(rank, device)
            emit(rank, {"check": check.__name__, "s":
                        time.perf_counter() - t0})
        flags = torch.tensor([len(bad)], dtype=torch.int64)
        dist.all_reduce(flags)
    finally:
        dist.destroy_process_group()
    if rank == 0 and device_type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip(),
            flush=True)
    emit(rank, {"ok": int(flags) == 0, "failed": bad,
                "world": WORLD, "device": device_type})
    if int(flags):
        raise SystemExit(1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args.rank, args.port, args.device)
        return
    if args.device == "cuda" and torch.cuda.device_count() < WORLD:
        raise SystemExit(f"needs {WORLD} CUDA cards, found "
                         f"{torch.cuda.device_count()}")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--device", args.device, "--rank",
         str(r), "--port", str(port)], env=env) for r in range(WORLD)]
    try:
        codes = [p.wait() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        raise SystemExit(f"rank exit codes {codes}")


if __name__ == "__main__":
    main()
