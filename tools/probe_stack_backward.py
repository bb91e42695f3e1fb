#!/usr/bin/env python3
"""Time the trainer's step with the stack's layers taken as one select per
layer (``t[layer]`` of every stacked leaf) against one ``unbind`` per
stacked leaf (``models.transformer._layer_views``), on one NVIDIA GPU.

A select's backward is a zero-filled gradient of the whole stacked leaf,
and autograd adds the layers' copies, so the select form moves bytes
that grow as the square of the depth; an unbind's backward stacks the
layers' gradients once.  Both forms give the same gradients.

minicpm-2b at its published widths and all 40 layers through
``launch.train.build_training`` (bf16, remat full, global batch 8 x 512 in
microbatches of 2), 4 steps each, in the order select, unbind, unbind,
select; one JSON line per run (each step's host time ending in the
loss's copy to the host, the median after the first step, peak memory,
losses) and a last line saying whether all runs' losses are equal.

Run from the root of a checkout:  ``python3 tools/probe_stack_backward.py``
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402  (exits without a CUDA card)
import torch  # noqa: E402

from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

STEPS = 4


def select_views(stack_params) -> list:
    """The layers' parameter trees as one select per layer and leaf."""
    n_layers = tree_util.leaves(stack_params)[0].shape[0]
    return [tree_util.tree_map(lambda t: t[i], stack_params)
            for i in range(n_layers)]


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    unbind_views = tfm._layer_views
    runs = []
    try:
        for form in ("select", "unbind", "unbind", "select"):
            tfm._layer_views = (select_views if form == "select"
                                else unbind_views)
            with tempfile.TemporaryDirectory() as d:
                run = cs._trainer_run(cs.MINICPM_2B, STEPS, d)
            runs.append({"stack": form, "step_ms": run["step_ms"],
                         "ms_per_step": run["ms_per_step"],
                         "peak_device_memory_bytes":
                             run["peak_device_memory_bytes"],
                         "losses": run["losses"], "nvidia_smi": smi})
            print(json.dumps(runs[-1]), flush=True)
            del run
            cs._free()
    finally:
        tfm._layer_views = unbind_views
    print(json.dumps({"probe": "stack_backward", "nvidia_smi": smi,
                      "losses_equal": all(r["losses"] == runs[0]["losses"]
                                          for r in runs)}))


if __name__ == "__main__":
    main()
