"""Quickstart: the paper's NAP allreduce beside recursive doubling and SMP.

The port of ``examples/quickstart.py``.  One process per rank
(:mod:`repro_torch.examples._world`): one rank a card over NCCL, or with
``--device cpu`` a gloo world of the reference's 4 nodes x 4 ranks.  Each
rank holds one value, ``x = rank``; each engine of the registry reduces
it, and rank 0 prints the result beside the expected sum and the
permutation rounds the program issued, the counterpart of the reference's
``collective-permute`` count in its compiled HLO.  That is the quantity
the paper minimises: ``log_ppn(n)`` against ``log2(n * ppn)``.  The
command fails unless every rank holds the sum and each engine issued the
rounds of its ``napalg`` schedule.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart \\
          [--device cpu] [--grid 4x4] [--report out.json]
"""

from __future__ import annotations

import argparse

import torch

from ..core import collectives, comm, napalg
from . import _world

ALGORITHMS = ("rd", "smp", "nap")


def schedule_rounds(algo: str, n_nodes: int, ppn: int) -> int:
    """The permutation rounds of ``algo``'s ``napalg`` schedule on an
    ``n_nodes x ppn`` grid."""
    if algo == "nap":
        return sum(len(step.rounds)
                   for step in napalg.build_nap_schedule(n_nodes, ppn).steps)
    build = {"rd": napalg.build_rd_schedule,
             "smp": napalg.build_smp_schedule}[algo]
    return len(build(n_nodes, ppn).steps)


def allreduce_rank(rank: int, topology, device) -> dict:
    """This rank's result of each engine, and the rounds it issued."""
    x = torch.full((1,), float(rank), dtype=torch.float32, device=device)
    expected = float(sum(range(topology.group)))
    rows = {}
    for algo in ALGORITHMS:
        collectives.reset_round_count()
        y = comm.get_engine(algo).execute(x, topology=topology)
        rows[algo] = {
            "result": float(y.item()), "expected": expected,
            "rounds": collectives.ROUNDS["ppermute"],
            "schedule_rounds": schedule_rounds(algo, topology.n_nodes,
                                               topology.ppn),
        }
        if rank == 0:
            print(f"{algo:4s} allreduce -> [{rows[algo]['result']}] "
                  f"(expected {expected}), inter-chip permute rounds = "
                  f"{rows[algo]['rounds']}", flush=True)
    return rows


def run(*, device=None, grid=None) -> dict:
    """The quickstart on a world; rank 0's rows.  Raises unless every rank
    holds the sum and issued its schedule's rounds."""
    ranks = _world.launch(allreduce_rank, device=device, grid=grid)
    bad = [f"rank {r} {algo}: {row}" for r, rows in enumerate(ranks)
           for algo, row in rows.items()
           if row["result"] != row["expected"]
           or row["rounds"] != row["schedule_rounds"]]
    if bad:
        raise AssertionError("quickstart: " + "; ".join(bad))
    return ranks[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _world.add_arguments(ap)
    args = ap.parse_args(argv)
    dev, (n, ppn) = _world.world_grid(args.device, args.grid)
    rows = run(device=args.device, grid=args.grid)
    print(f"\nNAP: {rows['nap']['rounds']} round(s) on {n} nodes x {ppn} "
          f"ranks (log_ppn(n)); RD: {rows['rd']['rounds']} (log2 of "
          f"{n * ppn} ranks).")
    _world.write_report(args.report, {"example": "quickstart",
                                      "device": dev.type, "grid": [n, ppn],
                                      "rows": rows})
    return rows


if __name__ == "__main__":
    main()
