#!/usr/bin/env python3
"""Time ``import repro_torch.core.comm`` with the registration gates on
(``REPRO_VERIFY_ON_REGISTER=1``: the schedule verifier and the SPMD lint
run for each of the twelve engines registered at import) and off.

Each sample is a fresh Python process that imports torch first and then
times the import of ``repro_torch.core.comm`` alone (host clock), so
torch's own import cost is left out; the two settings alternate, on, off,
off, on, ...  Prints one JSON line: each setting's samples and median in
seconds, and the median difference.  Host work only: no card is used.

Run from the root of a checkout:  ``python3 tools/gate_import_cost.py
[--samples N]``
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROBE = ("import time, torch\n"
         "t = time.perf_counter()\n"
         "import repro_torch.core.comm\n"
         "print(time.perf_counter() - t)\n")


def sample(flag: str) -> float:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_VERIFY_ON_REGISTER=flag, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, check=True)
    return float(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=5)
    args = ap.parse_args(argv)
    runs = {"1": [], "0": []}
    for i in range(args.samples):
        order = ("1", "0") if i % 2 == 0 else ("0", "1")
        for flag in order:
            runs[flag].append(sample(flag))
    on, off = statistics.median(runs["1"]), statistics.median(runs["0"])
    print(json.dumps({"gate_on_s": runs["1"], "gate_off_s": runs["0"],
                      "median_on_s": on, "median_off_s": off,
                      "gate_cost_s": on - off}))


if __name__ == "__main__":
    main()
