"""Run one cell of the port's benchmark once (see README.md).

    python3 perfbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>
"""

import time

T_START = time.time()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parent.parent
for _p in (str(_ROOT / "src"), str(_ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

if __name__ == "__main__":
    from perfbench.harness import main

    sys.exit(main(t_start=T_START))
