"""The paper's technique inside training: NAP gradient synchronisation.

The port of ``examples/nap_gradient_sync.py``.  Trains the same small LM
twice on a world of one process per rank (:mod:`repro_torch.examples._world`:
one rank a card over NCCL, or with ``--device cpu`` a gloo world of the
reference's 4 nodes x 4 ranks), once with the ``psum`` gradient sync
(one native allreduce) and once with the explicit NAP schedule (paper
§III), and shows:

  1. the losses match step for step (the schedule is numerically
     equivalent; the command fails otherwise);
  2. the NAP step's inter-node traffic runs in ``log_ppn(n)`` permutation
     rounds a bucket: the rounds and all-reduces one step issued, counted
     from the program that ran (the rounds at the engines' point-to-point
     primitive, the all-reduces in the step's op trace);
  3. the simulated cost of the scalar sync on the paper's machine model
     (Blue Waters, 2048 nodes x 16 ranks): a model, not a measurement.

Run:  PYTHONPATH=src python -m repro_torch.examples.nap_gradient_sync \\
          [--device cpu] [--grid 4x4] [--report out.json]
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from ..configs.base import ModelConfig, OptimizerConfig, SubLayer
from ..core import collectives, perf_model as pm, simulator as sim
from ..core.grad_sync import GradSyncConfig
from ..data import SyntheticLM
from ..launch.steps import init_train_state, make_dp_train_step
from ..launch.trace_analysis import trace_call
from ..models import init_params
from . import _world
from .quickstart import schedule_rounds

CFG = ModelConfig(
    name="nap-demo-lm",
    family="dense",
    num_layers=4,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=512,
    vocab_size=1024,
    pattern=(SubLayer("attn"),),
    dtype="float32",
    remat="none",
)
SEQ, GLOBAL_BATCH, SEED, STEPS = 64, 16, 0, 5
ALGORITHMS = ("psum", "nap")


def seeded_params() -> dict:
    """The port's parameters of :data:`CFG` from seed 0, drawn on the CPU
    (the same numbers on every rank and device)."""
    return init_params(CFG, generator=torch.Generator().manual_seed(SEED),
                       device="cpu")


def train_rank(rank: int, topology, device, *, params=None) -> dict:
    """:data:`STEPS` DP steps of each sync from ``params`` (default
    :func:`seeded_params`): the losses, each step's ms (host clock ending
    in a device sync), and the first NAP step's rounds and all-reduces."""
    opt_cfg = OptimizerConfig(lr=1e-3, schedule="constant", warmup_steps=1)
    params = seeded_params() if params is None else params
    data = SyntheticLM(CFG.vocab_size, SEQ, GLOBAL_BATCH, seed=SEED,
                       rank=rank, world=topology.group)
    out = {}
    for algo in ALGORITHMS:
        policy = GradSyncConfig(algorithm=algo)
        step = make_dp_train_step(CFG, opt_cfg, topology, policy,
                                  device=device)
        state = init_train_state(CFG, opt_cfg, policy, params=params,
                                 device=device)
        losses, ms = [], []
        for s in range(STEPS):
            batch = data.batch(s, device)
            t0 = time.perf_counter()
            if s == 0 and algo == "nap":
                collectives.reset_round_count()
                (state, m), trace = trace_call(step, state, batch)
                out["nap_rounds"] = collectives.ROUNDS["ppermute"]
                out["nap_all_reduces"] = sum(
                    1 for c in trace.collectives if c.kind == "all-reduce")
                out["buckets"] = step.plan.num_buckets
            else:
                state, m = step(state, batch)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        out[algo] = {"losses": losses, "ms": ms}
    return out


def simulated_costs() -> dict:
    """The scalar sync's simulated seconds per engine on 2048 nodes x 16
    ranks at 8 bytes under the paper's Blue Waters constants."""
    return {algo: sim.simulate_algorithm(algo, 2048, 16, 8.0, pm.BLUE_WATERS)
            for algo in ("rd", "smp", "nap")}


def expected_rounds(buckets: int, n_nodes: int, ppn: int) -> int:
    """A NAP step's rounds by the schedule: each bucket and, with a slow
    domain, the loss scalar take one NAP allreduce."""
    return (buckets + (n_nodes > 1)) * schedule_rounds("nap", n_nodes, ppn)


def run(*, device=None, grid=None, params=None) -> dict:
    """The example on a world; prints and checks as the reference does
    and returns rank 0's numbers with the simulated costs.  Raises if the
    ranks' losses differ, psum and nap disagree (rtol 1e-4, atol 1e-5),
    a loss is not finite, or the NAP step's rounds are not the
    schedule's."""
    dev, (n, ppn) = _world.world_grid(device, grid)
    ranks = _world.launch(train_rank, device=device, grid=grid,
                          params=params)
    r0 = ranks[0]
    print(f"NAP train step: {r0['nap_rounds']} permutation rounds, "
          f"{r0['nap_all_reduces']} all-reduces "
          f"({r0['buckets']} buckets)")
    psum, nap = r0["psum"]["losses"], r0["nap"]["losses"]
    print("psum losses:", [f"{v:.4f}" for v in psum])
    print("nap  losses:", [f"{v:.4f}" for v in nap])
    bad = [f"rank {r}'s losses differ from rank 0's"
           for r, out in enumerate(ranks)
           if any(out[a]["losses"] != r0[a]["losses"] for a in ALGORITHMS)]
    if not (np.all(np.isfinite(psum)) and np.all(np.isfinite(nap))):
        bad.append("a loss is not finite")
    if not np.allclose(psum, nap, rtol=1e-4, atol=1e-5):
        bad.append("psum and nap losses differ")
    want = expected_rounds(r0["buckets"], n, ppn)
    if r0["nap_rounds"] != want:
        bad.append(f"{r0['nap_rounds']} NAP rounds, the schedule has {want}")
    if bad:
        raise AssertionError("nap_gradient_sync: " + "; ".join(bad))
    print("=> numerically identical gradient sync\n")
    costs = simulated_costs()
    print("simulated scalar-sync cost on a 2048-node x 16-ppn fabric "
          "(the paper's Blue Waters model, not a measurement):")
    for algo, t in costs.items():
        print(f"  {algo:4s}: {t * 1e6:7.2f} us")
    return {"device": dev.type, "grid": [n, ppn], "rank0": r0,
            "ms_per_step": {a: statistics.median(r0[a]["ms"][1:])
                            for a in ALGORITHMS},
            "simulated_s": costs}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _world.add_arguments(ap)
    args = ap.parse_args(argv)
    report = run(device=args.device, grid=args.grid)
    _world.write_report(args.report, {"example": "nap_gradient_sync",
                                      **report})
    return report


if __name__ == "__main__":
    main()
