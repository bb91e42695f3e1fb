"""Continuous-batching serving example on the ``repro_torch.serve`` engine.

The port of ``examples/serve_decode.py``.  Serves four very different
cached architectures at their reduced widths (a dense GQA model with a KV
cache, the RWKV6 SSM with its constant-size state, whisper's
encoder-decoder whose per-request encoder frames ride the request's
``extras`` into the slot cache at prefill, and gemma2 with its local and
global layers) through the same
:class:`~repro_torch.serve.ServeEngine`, on one device (the card unless
``--device cpu``).  Requests of different prompt lengths and token budgets
join the batch in flight: two padded prompt buckets serve three prompt
lengths, and the third request, submitted after one engine step, takes the
slot the first wave frees.  Every request must finish with its budget of
tokens and the engine must end idle.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
          [--device cpu] [--report out.json]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCHS, reduced
from ..device import resolve_device
from ..models import build_model
from ..serve import PromptBuckets, ServeEngine
from . import _world

ARCH_NAMES = ("qwen2-72b", "rwkv6-1.6b", "whisper-tiny", "gemma2-27b")


def demo(arch: str, gen: int = 8, *, params=None, device=None) -> dict:
    """Serve ``arch``'s reduced config (``params``, or seed 0) with the
    reference's submissions; returns every request's tokens in submit
    order and the seconds the run took.  Raises unless every request
    finished with its budget and the engine is idle."""
    device = resolve_device(device)
    cfg = reduced(ARCHS[arch])
    if params is None:
        model = build_model(
            cfg, generator=torch.Generator(device=device).manual_seed(0),
            device=device)
    else:
        model = build_model(cfg, params, device=device)
    dtype = getattr(torch, cfg.dtype)
    extras_template = None
    if cfg.encoder_layers:
        extras_template = {"frames": torch.empty(
            (1, 16, cfg.d_model), dtype=dtype, device="meta")}
    engine = ServeEngine(
        model,
        num_slots=2,                      # smaller than the request count:
        max_len=32,                       # the 3rd request joins in flight
        buckets=PromptBuckets([8, 16]),
        extras_template=extras_template,
        device=device,
    )

    rng = np.random.default_rng(1)

    def make_extras():
        if extras_template is None:
            return None
        return {"frames": torch.from_numpy(
            rng.standard_normal((1, 16, cfg.d_model))).to(device, dtype)}

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    # staggered arrivals with heterogeneous prompt lengths and budgets
    reqs = [
        engine.submit(
            rng.integers(0, cfg.vocab_size, size=n).tolist(),
            max_new_tokens=g, extras=make_extras(),
        )
        for n, g in [(12, gen), (5, gen + 2)]
    ]
    engine.step()  # both admitted; the third arrives mid-decode
    reqs.append(
        engine.submit(
            rng.integers(0, cfg.vocab_size, size=9).tolist(),
            max_new_tokens=gen - 2, extras=make_extras(),
        )
    )
    out = engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0

    kind = "state" if cfg.family == "ssm" else "kv"
    toks = sum(len(v) for v in out.values())
    print(f"{arch:24s} cache={kind:5s} {len(out)} reqs, {toks} toks "
          f"in {dt:5.2f}s -> {out[reqs[0].rid][:6]}", flush=True)
    for req in reqs:
        if not (req.state == "finished"
                and len(req.generated) == req.max_new_tokens):
            raise AssertionError(f"{arch}: request {req.rid} ended "
                                 f"{req.state} with {len(req.generated)} of "
                                 f"{req.max_new_tokens} tokens")
    if not engine.idle:
        raise AssertionError(f"{arch}: the engine is not idle")
    return {"tokens": [list(out[r.rid]) for r in reqs], "seconds": dt,
            "generated": toks}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _world.add_arguments(ap, world=False)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rows = {arch: demo(arch, device=device) for arch in ARCH_NAMES}
    print("\nall families served through one continuous-batching engine")
    _world.write_report(args.report, {"example": "serve_decode",
                                      "device": device.type, "archs": rows})
    return rows


if __name__ == "__main__":
    main()
