"""repro_torch.serve — the serving spine (the port of ``repro.serve``).

Continuous batching over topology-aware decode collectives: the
request-level system around the paper's latency-regime result.  Decode
collectives are small (a few KB to MB per token) and fire on every token,
so the node-aware small-message allreduce is paid per token.

* :mod:`repro_torch.serve.scheduler` — host-side request lifecycle:
  admission control, FIFO slot assignment, in-flight insertion and
  eviction at decode-step boundaries, prompt-length buckets;
* :mod:`repro_torch.serve.decode` — the decode path: slot-stacked cached
  decode with a ``CommContext``-routed tensor-parallel logits head
  (``mla_ag`` hidden gather, auto-dispatched logits allreduce — NAP on
  multi-node grids — and the ``psum`` min-reduce of the EOS flag);
* :mod:`repro_torch.serve.engine` — :class:`ServeEngine`, one replica;
* :mod:`repro_torch.serve.router` — multi-replica routing by outstanding
  tokens, reroute on :class:`repro_torch.runtime.fault.ReplicaHealth`
  straggler signals, re-planning on replica loss.

With a multi-rank ``ctx`` every rank of the serving group runs the same
scheduler and router and must make the same calls in the same order.
Feed :meth:`Router.observe_step` a duration the ranks agree on (each
rank's step time maxed over the group): a rank's own host clock can
degrade a replica on one rank and not on another, and the ranks' engine
steps, and so their collectives, then part ways.

One replica, continuous batching (``device="cpu"`` to run without a card)::

    from repro_torch.configs import MINICPM_2B, reduced
    from repro_torch.models import build_model
    from repro_torch.serve import PromptBuckets, ServeEngine

    cfg = reduced(MINICPM_2B)
    gen = torch.Generator().manual_seed(0)
    model = build_model(cfg, generator=gen, device="cpu")
    eng = ServeEngine(model, num_slots=4, max_len=64,
                      buckets=PromptBuckets([8, 16, 32]), eos_id=7,
                      device="cpu")
    r0 = eng.submit([1, 2, 3], max_new_tokens=16)
    r1 = eng.submit(list(range(20)), max_new_tokens=8)
    tokens = eng.run()          # {rid: [tok, ...]}

An encoder-decoder (whisper) engine takes ``extras_template`` (e.g.
``{"frames": torch.empty((1, S_enc, D), device="meta")}``) and every
request its own ``extras`` (``{"frames": (1, S_enc, D)}``).

The layer-0 protocol check
(:mod:`repro_torch.analysis.protocol_check`) explores this package's
scheduler / router / health protocol exhaustively at small scope.
"""

from .decode import (
    greedy_step,
    make_decode_loop,
    make_decode_slice,
    make_tp_head,
)
from .engine import ServeEngine
from .router import Router
from .scheduler import PromptBuckets, Request, Scheduler

__all__ = [
    "ServeEngine",
    "Router",
    "Scheduler",
    "PromptBuckets",
    "Request",
    "greedy_step",
    "make_decode_loop",
    "make_decode_slice",
    "make_tp_head",
]
