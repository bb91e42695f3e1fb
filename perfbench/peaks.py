"""The card's published peaks, and its power limit.

A copy of NVIDIA's data-sheet rates for the H100 SXM (dense, no
sparsity), as ``chip_smoke.py::card_rates`` and
``repro_torch/launch/roofline.py`` hold them.  They assume the card's
full 700 W; ``nvidia-smi`` says what limit the card runs under, and every
result carries it beside the rates.
"""

from __future__ import annotations

import subprocess

__all__ = ["PEAKS", "card_peaks", "smi"]

PEAKS = {
    "H100": {"bf16_flops": 989e12, "bytes_per_s": 3.35e12},
}


def card_peaks(name: str) -> dict:
    for key, rates in PEAKS.items():
        if key in name:
            return rates
    raise RuntimeError(f"no peak rates on file for card {name!r}")


def smi() -> list[str]:
    """``name, power.limit`` of each card, as ``nvidia-smi`` reads them
    (empty where it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]
