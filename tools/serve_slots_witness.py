#!/usr/bin/env python3
"""Why the one-card serving engine's greedy streams depend on its slot
count: the same requests, each served alone, through ``ctx=None`` engines
of 8 and of 2 slots on one card, in bf16 and in float32.

Run from the root of a checkout::

    python3 tools/serve_slots_witness.py                # on one card
    python3 tools/serve_slots_witness.py --device cpu   # reduced sizes

A request served alone sits in slot 0 of either engine and prefills at
B=1 in both, so only the decode step's batch (8 rows or 2) differs, and
with it the shapes of the trunk's GEMMs.  For rwkv6-1.6b and
jamba-1.5-large-1s-4e (``tools/serve_tp_4gpu.py``'s ``families`` cuts and
traffic: 4 requests of 16 new tokens) one JSON line per model and dtype
gives, per request: the tokens of both engines, :func:`near_tie` of the
8-slot stream against the 2-slot one, the largest logit difference over
the largest logit at each step before they part, and, for an MoE model,
the first router call (row 0) whose top-k experts differ, with its step,
the margin between the k-th and the (k+1)-th expert probability there and
the largest probability difference at that call and before it.  Held: in
float32 the streams are equal or part at a near tie.  Matmuls in float32
are full float32 (no TF32).  On the card the last lines are its name and
power limit and ``{"ok": ...}``; the command fails if a check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))
from mesh_train_4gpu import config  # noqa: E402
from serve_tp_4gpu import (  # noqa: E402
    CARD_SIZES, CPU_SIZES, card_model, make_engine, near_tie, serve_serial,
    traffic_of,
)

CONFIGS = ("rwkv6-1.6b", "jamba-1.5-large-1s-4e")
DTYPES = ("bfloat16", "float32")
SLOTS = (8, 2)


class Tap:
    """Row 0 of every logits block the decode heads take their argmax of,
    and row 0 (the last position) of every MoE router call: its top-k
    experts, probabilities and the step whose token it feeds (the logits
    rows recorded before it)."""

    def __init__(self):
        self.logits: list[torch.Tensor] = []
        self.router: list[tuple[int, list[int], torch.Tensor]] = []

    @contextlib.contextmanager
    def on(self):
        from repro_torch.models import moe
        from repro_torch.serve import decode

        softcap, router = decode.softcap, moe._router

        def tapped_softcap(x, cap):
            y = softcap(x, cap)
            self.logits.append(y[0].detach().to("cpu", torch.float64))
            return y

        def tapped_router(w_router, x, m):
            out = router(w_router, x, m)
            # the router's own op on the whole batch, then row 0
            probs = torch.softmax(moe.dense(x.to(torch.float32),
                                            w_router.to(torch.float32)), -1)
            self.router.append((len(self.logits),
                                sorted(out[1][0, -1].tolist()),
                                probs[0, -1].to("cpu", torch.float64)))
            return out

        decode.softcap, moe._router = tapped_softcap, tapped_router
        try:
            yield self
        finally:
            decode.softcap, moe._router = softcap, router


def serve_tapped(model, spec, traffic, device, slots: int) -> list[dict]:
    """Each request alone through a ``ctx=None`` engine of ``slots``
    slots: its stream and its taps."""
    engine = make_engine(model, {**spec, "num_slots": slots}, device)
    out = []
    for req in traffic:
        tap = Tap()
        with tap.on():
            [stream], _ = serve_serial(engine, [req])
        out.append({"tokens": stream, "tap": tap})
    del engine
    return out


def compare(many: dict, two: dict) -> dict:
    """The 8-slot request against the 2-slot one."""
    t8, t2 = many["tokens"], two["tokens"]
    l8, l2 = many["tap"].logits, two["tap"].logits
    tie = near_tie(t8, t2, l8, l2)
    upto = tie.get("first_diff", min(len(t8), len(t2)))
    rel = [float((a - b).abs().max() / b.abs().max())
           for a, b in zip(l8[:upto], l2[:upto])]
    row = {"tokens_8": t8, "tokens_2": t2, "near_tie": tie,
           "logit_err_rel_by_step": rel}
    r8, r2 = many["tap"].router, two["tap"].router
    if r2:
        diffs = [float((a[2] - b[2]).abs().max()) for a, b in zip(r8, r2)]
        c = next((i for i, (a, b) in enumerate(zip(r8, r2))
                  if a[1] != b[1]), None)
        row["router_calls"] = len(r2)
        row["router_prob_diff_max"] = max(diffs)
        if c is not None:
            k = len(r2[c][1])
            p = torch.sort(r2[c][2], descending=True).values
            row["router_first_diff"] = {
                "call": c, "step": r2[c][0], "experts_8": r8[c][1],
                "experts_2": r2[c][1],
                "margin_kth_vs_next": float(p[k - 1] - p[k]),
                "prob_diff_there": diffs[c],
                "prob_diff_max_before": max(diffs[:c], default=0.0)}
    return row


def witness(name: str, dtype: str, device, sizes) -> dict:
    spec = sizes["families"]
    cfg = dataclasses.replace(
        config({"config": name, "reduced": spec.get("reduced")}),
        dtype=dtype)
    model = card_model(cfg, device)
    traffic = traffic_of(cfg.vocab_size, spec)
    t0 = time.perf_counter()
    runs = {n: serve_tapped(model, spec, traffic, device, n) for n in SLOTS}
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reqs = [compare(a, b) for a, b in zip(runs[8], runs[2])]
    return {"config": cfg.name, "dtype": dtype,
            "requests": [[len(p), n] for p, n in traffic],
            "equal": [r["near_tie"]["equal"] for r in reqs],
            "near_tie_ok": all(r["near_tie"]["ok"] for r in reqs),
            "by_request": reqs, "s": time.perf_counter() - t0}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default: one card) or cpu (reduced sizes)")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device

    device = resolve_device(args.device)
    sizes = CPU_SIZES if device.type == "cpu" else CARD_SIZES
    torch.backends.cuda.matmul.allow_tf32 = False
    bad = []
    for name in CONFIGS:
        for dtype in DTYPES:
            try:
                row = witness(name, dtype, device, sizes)
            except Exception as e:  # the next model still runs; fails
                bad.append(f"{name} {dtype}: {type(e).__name__}: {e}"[:600])
                print(json.dumps({"config": name, "dtype": dtype,
                                  "error": bad[-1]}), flush=True)
                continue
            if dtype == "float32" and not row["near_tie_ok"]:
                bad.append(f"{row['config']} float32: the 8- and 2-slot "
                           f"streams part beyond a near tie")
            print(json.dumps(row), flush=True)
    if device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip(),
            flush=True)
    print(json.dumps({"ok": not bad, "failed": bad,
                      "device": device.type}), flush=True)
    if bad:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
