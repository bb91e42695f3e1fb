"""The verification driver: ``python -m repro_torch.analysis``.

The port of ``repro/analysis/__main__.py``: four sweeps over the proof
chain of :mod:`repro_torch.analysis`, each writing its table:

1. **Schedule sweep** (default) — every registered engine x the grid
   matrix (degenerate ``n = 1`` / ``ppn = 1`` grids, prime node counts,
   ragged payloads, chunk depths) through the schedule verifier's four
   passes; engines with no schedule builder are ``native`` rows.
2. **Trace wire lint** (default, after the schedule sweep; the
   reference's HLO lint, its JSON key kept) — the compressed fused-bucket
   gradient sync (leaves of 64 / 96 / 128 floats, bits 8 and 4) traced as
   every rank of a 2 x 4 world of torch's ``fake`` backend, and the trace
   rules of :mod:`repro_torch.analysis.trace_lint` over each rank: the
   transport launch budget (4 a bucket), compressed wire dtypes, groups
   that partition the ranks, and a stable trace.  It makes and destroys
   a default process group per rank, so it needs a process that has none.
3. **SPMD lint** (``--spmd``) — every registered engine's program on
   every rank of :data:`_SPMD_GRIDS` in float32 and bfloat16
   (:func:`repro_torch.core.comm.lint_lowering`), then the compressed
   grad sync, the data-parallel train step on ``reduced(minicpm-2b)``,
   the serve decode loop and the engine's decode slice at the slot
   geometry of the layer-0 link, all on 2 x 4.
4. **Protocol model check** (``--protocol``) — the serving control
   plane over :data:`~repro_torch.analysis.protocol_check.PROTOCOL_GRID`,
   failing on any violation or on fewer states than the recorded floor,
   and the layer-0 <-> layer-2 link.

The tables go to ``reports/analysis_torch/{schedules,spmd,protocol}.json``
(``--json PATH`` writes elsewhere).  The exit code is non-zero on any
violation::

    PYTHONPATH=src python -m repro_torch.analysis
    PYTHONPATH=src python -m repro_torch.analysis --spmd
    PYTHONPATH=src python -m repro_torch.analysis --protocol

``--skip-hlo`` runs only the schedule sweep; ``--skip-schedules`` only
the trace wire lint.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

REPORTS = os.path.join("reports", "analysis_torch")


def run_schedule_sweep() -> dict:
    from ..core import comm
    from . import schedule_verifier as sv

    per_engine: dict[str, dict] = {}
    rows = []
    for key in sorted(comm.registered_engines()):
        collective, name = key.split(":", 1)
        spec = comm.get_engine(name, collective)
        reports = sv.verify_spec_grid(spec)
        n_bad = sum(1 for r in reports if not r.ok)
        n_native = sum(
            1 for r in reports if any(n.startswith("native") for n in r.notes)
        )
        n_skipped = sum(
            1 for r in reports if any(n.startswith("skipped") for n in r.notes)
        )
        per_engine[key] = {
            "cells": len(reports),
            "verified": len(reports) - n_bad - n_native - n_skipped,
            "native": n_native,
            "skipped_below_min_grid": n_skipped,
            "violations": n_bad,
        }
        rows.extend(r.to_row() for r in reports)
        print(
            f"  {key:28s} {per_engine[key]['verified']:4d} verified "
            f"{n_native:4d} native {n_skipped:4d} skipped "
            f"{n_bad:3d} violations  {'FAIL' if n_bad else 'ok'}"
        )
    return {
        "grid_matrix": [list(g) for g in sv.GRID_MATRIX],
        "payload_elems": list(sv.PAYLOAD_ELEMS),
        "engines": per_engine,
        "cells": len(rows),
        "violations": sum(e["violations"] for e in per_engine.values()),
        "rows": rows,
    }


#: the compressed fused bucket both lint passes trace: three leaves
_LEAVES = (64, 96, 128)


def _compressed_sync(policy, topo, leaves):
    from ..core import comm, grad_sync

    ctx = comm.CommContext(topo, policy)
    plan = grad_sync.plan_for_tree(leaves, cfg=policy, topology=topo)
    return grad_sync.sync_with_context(list(leaves), ctx, plan=plan), plan


def run_trace_lint(n_nodes: int = 2, ppn: int = 4) -> dict:
    """Trace the compressed fused-bucket sync as every rank of a fake
    ``n_nodes x ppn`` default world and run the trace rules on each."""
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from ..core import comm
    from ..launch.trace_analysis import trace_call
    from . import trace_lint as tl

    if dist.is_initialized():
        raise RuntimeError("the trace wire lint makes its own fake default "
                           "group: run it in a process that has none")
    world = n_nodes * ppn
    leaves = [torch.zeros(e) for e in _LEAVES]
    rows = []

    def record(context: str, violations) -> None:
        for v in violations:
            rows.append({"context": context, **v.to_row()})
        print(f"  {context:46s} {len(violations):2d} violations  "
              f"{'FAIL' if violations else 'ok'}")

    for bits in (8, 4):
        policy = comm.CommPolicy(algorithm="nap", mean=True,
                                 compress_bits=bits)
        found = {"budget": [], "wire": [], "groups": [], "stable": []}
        for rank in range(world):
            dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                    world_size=world)
            try:
                topo = comm.Topology.from_world(n_nodes, ppn)
                (_, plan), trace = trace_call(_compressed_sync, policy, topo,
                                              leaves)
                budget = 4 * len(plan.buckets)
                found["budget"] += tl.lint_collective_counts(
                    trace, {"transport": budget})
                found["wire"] += tl.lint_compressed_wire(
                    trace, bits=bits, payload_elems=sum(_LEAVES), ppn=ppn)
                found["groups"] += tl.lint_replica_groups(
                    trace, num_devices=world)
                found["stable"] += tl.lint_stable_trace(
                    _compressed_sync, policy, topo, leaves)
            finally:
                dist.destroy_process_group()
        record(f"trace[bits={bits}] transport budget (4 a bucket)",
               found["budget"])
        record(f"trace[bits={bits}] compressed wire", found["wire"])
        record(f"trace[bits={bits}] group partition", found["groups"])
        record(f"trace[bits={bits}] stable trace", found["stable"])
    return {"world": [n_nodes, ppn], "leaves": list(_LEAVES), "rows": rows,
            "violations": len(rows)}


#: engine-cell matrix of the --spmd sweep: grids past the engines'
#: minimums plus one asymmetric shape, at full and half wire precision
_SPMD_GRIDS = ((2, 2), (3, 2), (2, 4))
_SPMD_DTYPES = ("float32", "bfloat16")


def run_spmd_sweep() -> dict:
    """Lint every engine's program and the workloads that run them."""
    import torch

    from ..configs import ARCHS, OptimizerConfig, reduced
    from ..core import comm
    from ..launch import serve as serve_mod
    from ..launch.steps import init_train_state, make_dp_train_step
    from ..models import build_model
    from ..serve import decode as serve_decode
    from . import spmd_lint
    from .protocol_check import verify_decode_geometry_link

    rows = []
    n_violations = 0

    def record(rep) -> None:
        nonlocal n_violations
        rows.append(rep.to_row())
        n_violations += len(rep.violations)
        byte_col = (
            "bytes=?"
            if rep.internode_bytes_per_chip is None
            else f"bytes={rep.internode_bytes_per_chip:g}"
            + ("" if rep.declared_bytes is None else "=declared")
        )
        print(
            f"  {rep.label:40s} {rep.collectives:3d} collectives "
            f"{byte_col:18s} {len(rep.violations):2d} violations  "
            f"{'FAIL' if rep.violations else 'ok'}"
        )
        for v in rep.violations:
            print(f"    !! [{v.rule}] {v.message}")

    # -- 1. every registered engine's program ------------------------------
    per_engine: dict[str, dict] = {}
    byte_verified = 0
    for key in sorted(comm.registered_engines()):
        collective, name = key.split(":", 1)
        spec = comm.get_engine(name, collective)
        cells = skipped = bounded = bad = 0
        for n, p in _SPMD_GRIDS:
            if n < spec.min_nodes or p < spec.min_ppn:
                skipped += len(_SPMD_DTYPES)
                continue
            for dt in _SPMD_DTYPES:
                rep = comm.lint_lowering(name, n_nodes=n, ppn=p, dtype=dt,
                                         raise_on_violation=False)
                record(rep)
                cells += 1
                if rep.declared_bytes is not None:
                    bounded += 1
                    byte_verified += 1
                if not rep.ok:
                    bad += 1
        per_engine[key] = {
            "cells": cells,
            "byte_verified": bounded,
            "skipped_below_min_grid": skipped,
            "violations": bad,
        }

    # -- 2. the compressed grad sync on 2 x 4 ------------------------------
    n, p = 2, 4
    leaves = [torch.zeros(e) for e in _LEAVES]
    for bits in (8, 4):
        policy = comm.CommPolicy(algorithm="nap", mean=True,
                                 compress_bits=bits)
        record(spmd_lint.lint_traced(
            lambda topo, *ls: _compressed_sync(policy, topo, ls)[0], *leaves,
            n_nodes=n, ppn=p, label=f"grad_sync[bits={bits}]"))

    # -- 3. the data-parallel train step (launch/steps) ----------------------
    cfg = dataclasses.replace(reduced(ARCHS["minicpm-2b"]), dtype="float32")
    opt_cfg = OptimizerConfig(lr=1e-2, schedule="constant", warmup_steps=1)
    sync_cfg = comm.CommPolicy(algorithm="nap", mean=True)
    gen = torch.Generator().manual_seed(0)
    state = init_train_state(cfg, opt_cfg, sync_cfg, generator=gen,
                             device="cpu")
    rows_per_rank = 16 // (n * p)  # the global batch is (16, 32)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (rows_per_rank, 32),
        generator=torch.Generator().manual_seed(1))}

    def train_step(topo, state, batch):
        step = make_dp_train_step(cfg, opt_cfg, topo, sync_cfg, device="cpu")
        return step(state, batch)

    # the state is replicated: uniform on every rank; the batch rows are
    # this rank's
    record(spmd_lint.lint_traced(train_step, state, batch, n_nodes=n, ppn=p,
                                 uniform=(0,), label="train_step[nap]"))

    # -- 4. the serve decode loop (launch/serve) -----------------------------
    model = build_model(cfg, generator=torch.Generator().manual_seed(2),
                        device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (1, 6),
                            generator=torch.Generator().manual_seed(3))

    def serve_shard(topo, prompts):
        return serve_mod.make_serve_shard(
            model, comm.CommContext(topo), gen_len=4, max_len=10, eos_id=1,
        )(prompts)

    record(spmd_lint.lint_traced(serve_shard, prompts, n_nodes=n, ppn=p,
                                 label="serve_decode[eos early-exit]"))

    # -- 5. the engine's decode slice at the layer-0 geometry ----------------
    # the slot rows every rank holds come from the protocol checker's
    # admissible-occupancy closure over a real Scheduler
    link = verify_decode_geometry_link(8, n * p)
    b_max = link["b_max"]
    cache = model.init_decode(b_max, 10)
    tok = torch.ones((n * p * b_max, 1), dtype=torch.long)
    active = torch.ones((n * p * b_max,), dtype=torch.bool)

    @torch.no_grad()
    def decode_slice(topo, cache, tok, active):
        return serve_decode.make_decode_slice(
            model, comm.CommContext(topo), slice_len=4, eos_id=1,
        )(cache, tok, active)

    # the next tokens and the slot mask are the whole group's, on every
    # rank; the cache holds this rank's slot rows
    record(spmd_lint.lint_traced(decode_slice, cache, tok, active,
                                 n_nodes=n, ppn=p, uniform=(1, 2),
                                 label="serve_engine[continuous batching]"))

    return {
        "grids": [list(g) for g in _SPMD_GRIDS],
        "dtypes": list(_SPMD_DTYPES),
        "engines": per_engine,
        "byte_verified_cells": byte_verified,
        "cells": len(rows),
        "violations": n_violations,
        "rows": rows,
    }


def run_protocol_sweep(grid=None) -> dict:
    """Exhaustive layer-0 sweep over ``grid`` (default the whole
    :data:`~repro_torch.analysis.protocol_check.PROTOCOL_GRID`): each
    scope's states must reach its recorded floor."""
    from ..core import comm
    from . import protocol_check as pc

    rows = []
    n_violations = coverage_failures = 0
    for cfg, floor in (pc.PROTOCOL_GRID if grid is None else grid):
        t0 = time.perf_counter()
        rep = pc.check_protocol(cfg)
        row = rep.to_row()
        row["min_states"] = floor
        row["coverage_ok"] = rep.states >= floor
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        n_violations += len(rep.violations)
        coverage_failures += not row["coverage_ok"]
        scope = (f"r{cfg.replicas} s{cfg.slots} q{cfg.queue} "
                 f"n{cfg.requests} d{cfg.depth or 'closure'}")
        print(
            f"  {scope:28s} {rep.states:7d} states (floor {floor:7d}) "
            f"{rep.transitions:8d} transitions dedup {rep.dedup_ratio:5.2f}x "
            f"depth {rep.depth:2d} {len(rep.violations):2d} violations  "
            f"{'FAIL' if rep.violations or not row['coverage_ok'] else 'ok'}"
        )
        for v in rep.violations:
            print(f"    !! [{v.rule}] {v.detail}")
            print(f"       trace: {list(v.trace)}")
    # layer-0 <-> layer-2 link: the occupancies the protocol admits are
    # the ragged slot geometry the --spmd sweep lints the decode slice at
    topo = comm.Topology.of(2, 4)
    link = pc.verify_decode_geometry_link(8, topo.group)
    print(f"  layer-2 link: occupancies 0..{max(link['admissible_occupancies'])}"
          f" on geometry {link['geometry']} -> b_max={link['b_max']}  ok")
    return {
        "rows": rows,
        "layer2_link": link,
        "coverage_failures": coverage_failures,
        "states_total": sum(r["states"] for r in rows),
        "transitions_total": sum(r["transitions"] for r in rows),
        # protocol violations and coverage regressions both fail the run
        "violations": n_violations + coverage_failures,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__)
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the table here (default: reports/"
                         "analysis_torch/{schedules,spmd,protocol}.json)")
    ap.add_argument("--spmd", action="store_true",
                    help="run the SPMD lint sweep instead")
    ap.add_argument("--protocol", action="store_true",
                    help="run the layer-0 protocol model check over the "
                         "small-scope grid instead")
    ap.add_argument("--skip-hlo", action="store_true",
                    help="schedule sweep only (no trace wire lint)")
    ap.add_argument("--skip-schedules", action="store_true",
                    help="trace wire lint only")
    args = ap.parse_args(argv)

    def run(key, title, sweep):
        print(title)
        t0 = time.perf_counter()
        report[key] = sweep()
        report[key]["seconds"] = time.perf_counter() - t0

    if args.protocol:
        table, report = "protocol", {"bench": "BENCH_10", "ok": True}
        run("protocol", "protocol model check (layer 0):",
            run_protocol_sweep)
    elif args.spmd:
        table, report = "spmd", {"bench": "BENCH_8", "ok": True}
        run("spmd_lint", "SPMD lint sweep (layer 2):", run_spmd_sweep)
    else:
        table, report = "schedules", {"bench": "BENCH_7", "ok": True}
        if not args.skip_schedules:
            run("schedule_verification",
                "schedule verification sweep (layer 1):", run_schedule_sweep)
        if not args.skip_hlo:
            run("hlo_lint", "trace wire lint (layer 3):", run_trace_lint)

    n_violations = sum(
        report.get(k, {}).get("violations", 0)
        for k in ("schedule_verification", "hlo_lint", "spmd_lint",
                  "protocol")
    )
    report["ok"] = n_violations == 0
    path = args.json or os.path.join(REPORTS, f"{table}.json")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {path}")
    if not report["ok"]:
        print(f"FAILED: {n_violations} violation(s)")
        return 1
    print("all checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
