"""Re-derive roofline terms from saved dry-run traces (no tracing again).

The port of ``repro/launch/reanalyze.py``.  The dry run saves each cell's
op trace as ``reports/dryrun_torch/<cell>.trace.json.gz``; analyzer
changes (:mod:`repro_torch.launch.trace_analysis`, the constants of
:mod:`repro_torch.launch.roofline`) can be re-applied to every cell in
seconds:

    PYTHONPATH=src python -m repro_torch.launch.reanalyze
"""

from __future__ import annotations

import json
from pathlib import Path

from ..configs import SHAPES, get_config
from . import roofline as rl
from .dryrun import REPORTS
from .trace_analysis import Trace, analyze_trace

__all__ = ["reanalyze", "main"]


def reanalyze(reports: Path = REPORTS) -> int:
    """Rewrite the ``roofline`` of every ``ok`` record in ``reports`` that
    has its trace; returns how many."""
    n = 0
    for jf in sorted(Path(reports).glob("*.json")):
        tf = jf.parent / (jf.stem + ".trace.json.gz")
        if not tf.exists():
            continue
        rec = json.loads(jf.read_text())
        if not rec.get("ok"):
            continue
        cfg = get_config(rec["arch"])
        roof = rl.analyze(analyze_trace(Trace.load(tf)), rec["n_chips"],
                          rl.model_flops(cfg, SHAPES[rec["shape"]]))
        rec["roofline"] = roof.to_dict()
        jf.write_text(json.dumps(rec, indent=2, default=str))
        n += 1
    return n


def main() -> None:
    print(f"reanalyzed {reanalyze()} cells")


if __name__ == "__main__":
    main()
