"""Deterministic synthetic LM data, and a background prefetcher.

The port of ``repro/data/pipeline.py``.  Batch ``step`` is a pure function
of ``(seed, step)`` drawn with numpy, so both packages draw the same global
batch.  Two ways to split it over ranks:

* ``rank`` / ``world`` (data parallel with the paper's engines): a rank
  takes its rows in the order the reference's ``P(("pod", "data"))``
  batch spec assigns them: rank ``node * ppn + lane`` holds rows
  ``[rank * b, (rank + 1) * b)`` with ``b = global_batch / world``;
* ``mesh`` / ``batch_axes`` (a sharded model): :meth:`SyntheticLM.batch`
  gives DTensors with the rows ``Shard``-ed over ``batch_axes``, the
  reference's ``_place`` (``P(batch_axes, None)``), on the mesh's
  ``DeviceMesh`` on the batch's device.

:class:`Prefetcher` draws the next ``depth`` batches as numpy on a worker
thread; they move to the device on the caller's thread, so the worker
makes no CUDA call.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["SyntheticLM", "Prefetcher"]


@dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    rank: int = 0
    world: int = 1
    mesh: object | None = None
    batch_axes: tuple[str, ...] = ()

    def __post_init__(self):
        if self.mesh is not None and self.world != 1:
            raise ValueError("a batch is split by rank / world or placed on "
                             "a mesh, not both")
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

    def batch_numpy(self, step: int) -> dict[str, np.ndarray]:
        """This rank's rows of batch ``step``, as numpy arrays."""
        full = self.global_batch_numpy(step)
        b = self.global_batch // self.world
        rows = slice(self.rank * b, (self.rank + 1) * b)
        return {k: v[rows] for k, v in full.items()}

    @staticmethod
    def to_device(batch: dict[str, np.ndarray], device) -> dict:
        """Tensors on ``device`` of a numpy batch (token ids as int64)."""
        return {
            k: torch.from_numpy(v).to(
                device, torch.int64 if k in ("tokens", "labels") else None
            )
            for k, v in batch.items()
        }

    def batch(self, step: int, device) -> dict[str, torch.Tensor]:
        """This rank's rows of batch ``step``, as tensors on ``device``;
        with a mesh, the global batch as DTensors placed over it."""
        return self._place(self.to_device(self.batch_numpy(step), device))

    def _place(self, batch: dict) -> dict:
        if self.mesh is None:
            return batch
        from torch.distributed.tensor import distribute_tensor

        from ..models.sharding import placements

        spec = (tuple(self.batch_axes) or None, None)
        out = {}
        for k, t in batch.items():
            dm = self.mesh.device_mesh(t.device)
            out[k] = distribute_tensor(t, dm, placements(self.mesh, spec),
                                       src_data_rank=None)
        return out


class Prefetcher:
    """Background prefetch of ``depth`` batches (thread + queue), from
    ``start_step`` on.  ``next()`` returns ``(step, batch)`` with the batch
    on ``device`` (``cuda`` unless asked otherwise); ``close()`` stops the
    worker."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 depth: int = 2, *, device=None):
        self._source = source
        self._device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._source.batch_numpy(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> tuple[int, dict]:
        step, batch = self._q.get()
        src = self._source
        return step, src._place(src.to_device(batch, self._device))

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
