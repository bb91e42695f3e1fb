"""Deterministic synthetic LM data.

The port of ``repro/data/pipeline.py::SyntheticLM`` without the JAX
sharding.  Batch ``step`` is a pure function of ``(seed, step)`` drawn with
numpy, so both packages draw the same global batch.  A rank takes its rows
in the order the reference's ``P(("pod", "data"))`` batch spec assigns them:
rank ``node * ppn + lane`` holds rows ``[rank * b, (rank + 1) * b)`` with
``b = global_batch / world``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["SyntheticLM"]


@dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    rank: int = 0
    world: int = 1

    def __post_init__(self):
        if self.global_batch % self.world:
            raise ValueError(
                f"global batch {self.global_batch} does not split over "
                f"{self.world} ranks"
            )

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step])
        )

    def global_batch_numpy(self, step: int) -> dict[str, np.ndarray]:
        """The whole batch ``step`` as numpy arrays (every rank's rows)."""
        rng = self._rng(step)
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        # zipfian unigrams
        ranks = rng.zipf(1.3, size=(B, S)).astype(np.int64)
        tokens = np.minimum(ranks, V - 1).astype(np.int32)
        # motif injection: repeat a short pattern somewhere in each row
        motif_len = min(16, S // 2)
        motif = rng.integers(0, V, size=(B, motif_len), dtype=np.int32)
        start = rng.integers(0, max(1, S - 2 * motif_len), size=B)
        for b in range(B):
            s0 = start[b]
            tokens[b, s0 : s0 + motif_len] = motif[b]
            tokens[b, s0 + motif_len : s0 + 2 * motif_len] = motif[b]
        labels = np.concatenate(
            [tokens[:, 1:], np.zeros((B, 1), np.int32)], axis=1
        )
        mask = np.ones((B, S), np.float32)
        mask[:, -1] = 0.0
        return {"tokens": tokens, "labels": labels, "loss_mask": mask}

    def batch(self, step: int, device) -> dict[str, torch.Tensor]:
        """This rank's rows of batch ``step``, as tensors on ``device``."""
        full = self.global_batch_numpy(step)
        b = self.global_batch // self.world
        rows = slice(self.rank * b, (self.rank + 1) * b)
        return {
            "tokens": torch.from_numpy(full["tokens"][rows]).to(
                device, torch.int64
            ),
            "labels": torch.from_numpy(full["labels"][rows]).to(
                device, torch.int64
            ),
            "loss_mask": torch.from_numpy(full["loss_mask"][rows]).to(device),
        }
