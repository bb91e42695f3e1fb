"""The readings that the limits of ``correct`` are set from (not a run of
the benchmark; ``PERF.md`` gives what it read).

For each seed the program's first three steps against the reference's
(``rank.run_rank`` without a window); on some seeds the control, the
reference at float8 in the program's place (``reference.train.
fp8_matmul``); and on some seeds each fault planted in the timed path
(``rank.FAULTS``).  One JSON line a reading, on standard output and in
``--out``.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 --faults half_batch --fault-seeds 1,2,3 \\
        --out perfbench/out/calibrate.jsonl
"""

import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
for _p in (str(_ROOT / "src"), str(_ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def _ints(text: str) -> list[int]:
    return [int(v) for v in text.split(",") if v]


def _jobs(rank, device, cell, seeds, control_seeds, faults, fault_seeds,
          out):
    import gc
    import json

    import torch

    from perfbench.rank import run_rank
    from perfbench.reference import compare, train as ref_train

    rows = []

    def emit(row):
        if rank == 0:
            rows.append(row)
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                with open(out, "a") as f:
                    f.write(line + "\n")

    plan = [(None, s) for s in seeds] + [(f, s) for f in faults
                                         for s in fault_seeds]
    for fault, seed in plan:
        t0 = time.time()
        res = run_rank(cell, seed, rank=rank, world=cell.chips,
                       device=device, seconds=0.0, trace=False, fault=fault,
                       window=False)
        if rank == 0:
            values, where = compare.gaps(res.check["program"],
                                         res.check["reference"])
            emit({"cell": cell.name, "kind": fault or "program",
                  "seed": seed, "gaps": values, "where": where,
                  "losses": res.check["program"].losses,
                  "ref_losses": res.check["reference"].losses,
                  "seconds": time.time() - t0})
            if fault is None and seed in control_seeds:
                t0 = time.time()
                ctl = ref_train.run(cell, seed, device,
                                    mm=ref_train.fp8_matmul)
                values, where = compare.gaps(ctl, res.check["reference"])
                emit({"cell": cell.name, "kind": "control_fp8",
                      "seed": seed, "gaps": values, "where": where,
                      "losses": ctl.losses, "seconds": time.time() - t0})
        del res
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    import argparse

    from perfbench import manifest as mf
    from perfbench.harness import launch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = mf.load_cell(args.workload)
    faults = [f for f in args.faults.split(",") if f]
    launch(_jobs, cell.chips, cell, args.seeds, args.control_seeds, faults,
           args.fault_seeds, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
