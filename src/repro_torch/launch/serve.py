"""Batched serving driver: prefill + cached greedy decode.

The port of ``repro/launch/serve.py``.  Requests are batched, the prompt
is fed token by token through the cached decode step (filling the KV
cache), then decoded greedily by
:func:`repro_torch.serve.decode.make_decode_loop`.  Every request enters
and leaves together: the right tool for offline sweeps, and the serial
reference that the continuous-batching :class:`repro_torch.serve.ServeEngine`
is held against.

With a multi-rank ``CommContext`` each rank serves its own rows of the
batch (:func:`make_serve_shard`) and the early exit ("every sequence hit
EOS") is agreed across the group each step, so every rank runs the same
number of steps.  An encoder-decoder arch takes its encoder frames as
``batch_extras`` (single device only, as in the reference).

Usage (on the card unless ``--device cpu``; ``--arch`` is any of the
ten architectures of ``repro_torch.configs.ARCHS``)::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-1.5-large-398b \\
      --reduced --device cpu --batch 4 --prompt-len 32 --gen 16
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCHS, get_config, reduced
from ..core import comm
from ..device import require_on, resolve_device
from ..models import build_model
from ..serve.decode import make_decode_loop

__all__ = ["make_serve_shard", "serve_batch", "main"]


def make_serve_shard(model, ctx: comm.CommContext | None, *, gen_len: int,
                     max_len: int, eos_id: int | None = None):
    """The per-rank serve program ``shard_fn(prompts (b, P), extras=None)
    -> (b, gen_len)`` tokens: prefill, then the decode loop (``extras``:
    an encoder-decoder's ``{"frames": (b, S_enc, D)}``)."""
    decode = make_decode_loop(model, ctx, gen_len=gen_len, eos_id=eos_id)

    @torch.no_grad()
    def shard_fn(prompts, extras=None):
        b, p = prompts.shape
        cache = model.init_decode(b, max_len, batch=extras)
        for t in range(p - 1):  # teacher forcing; only the last logits count
            _, cache = model.decode_hidden(cache, prompts[:, t : t + 1])
        logits, cache = model.decode_step(cache, prompts[:, p - 1 :])
        tok = torch.argmax(logits[:, -1:], dim=-1)
        return decode(cache, tok)

    return shard_fn


def serve_batch(model, prompts: torch.Tensor, *, gen_len: int,
                max_len: int | None = None,
                batch_extras: dict | None = None, mesh=None,
                ctx: comm.CommContext | None = None,
                eos_id: int | None = None, device=None) -> torch.Tensor:
    """prompts: (B, P) token ids.  Returns (B, gen_len) generated tokens.

    ``batch_extras``: an encoder-decoder's ``{"frames": (B, S_enc, D)}``,
    given to ``init_decode``.  With a multi-rank ``ctx``, ``prompts`` are
    this rank's rows and the early exit is agreed by the group; that path
    takes no extras.

    With a ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh`; every rank
    of a world of its size calls this with the whole batch), as the
    reference's: ``ctx`` is built from the mesh if not given
    (``Topology.from_mesh``: one group over its DP axes), each rank serves
    its block of the rows over those axes (``B`` must divide), the early
    exit is agreed by the group, and every rank returns the whole (B,
    gen_len).  That path takes no extras either."""
    device = require_on(model, device)
    B, P_len = prompts.shape
    if mesh is not None:
        if batch_extras is not None:
            raise NotImplementedError(
                "batch_extras (encoder frames) are not supported on the "
                "meshed serve path yet"
            )
        if ctx is None:
            ctx = comm.CommContext(comm.Topology.from_mesh(mesh))
        topo = ctx.topology
        shards = topo.group
        if B % shards:
            raise ValueError(f"batch {B} does not shard over {shards} "
                             f"ranks ({topo.axes})")
        b = B // shards
        rank = topo.require_groups().rank if shards > 1 else 0
        rows = serve_batch(model, prompts[rank * b:(rank + 1) * b],
                           gen_len=gen_len, max_len=max_len or (
                               P_len + gen_len),
                           ctx=ctx, eos_id=eos_id, device=device)
        if shards == 1:
            return rows
        return ctx.allgather(rows.reshape(-1), elems=rows.numel() * shards,
                             algorithm="all_gather").reshape(B, gen_len)
    if batch_extras is not None:
        if ctx is not None and ctx.topology.group > 1:
            raise NotImplementedError(
                "batch_extras (encoder frames) are not supported on the "
                "multi-rank serve path yet"
            )
        batch_extras = {k: torch.as_tensor(v).to(device)
                        for k, v in batch_extras.items()}
    shard_fn = make_serve_shard(
        model, ctx, gen_len=gen_len, max_len=max_len or (P_len + gen_len),
        eos_id=eos_id,
    )
    return shard_fn(prompts.to(device=device, dtype=torch.long),
                    batch_extras)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = build_model(cfg, generator=gen, device=device)
    prompts = torch.from_numpy(
        np.random.default_rng(args.seed + 1).integers(
            0, cfg.vocab_size, (args.batch, args.prompt_len))
    )
    extras = None
    if cfg.encoder_layers:  # 16 seeded encoder frames a request
        frames = np.random.default_rng(args.seed + 2).standard_normal(
            (args.batch, 16, cfg.d_model)).astype(np.float32)
        extras = {"frames": torch.from_numpy(frames)}
    t0 = time.perf_counter()
    out = serve_batch(model, prompts, gen_len=args.gen, batch_extras=extras,
                      eos_id=args.eos_id, device=device)
    out = out.cpu()
    dt = time.perf_counter() - t0
    toks = args.batch * (args.prompt_len + args.gen)
    print(f"{cfg.name} on {device}: generated {tuple(out.shape)} tokens; "
          f"{toks / dt:.1f} tok/s total ({dt:.2f}s wall)")
    print(out[:2].numpy())


if __name__ == "__main__":
    main()
