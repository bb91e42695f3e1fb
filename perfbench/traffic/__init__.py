"""The one traffic generator: a training job's global batches.

After ``repro_torch.data.pipeline.SyntheticLM``'s token generator
(zipfian unigrams with one motif repeated in each row), kept here so that
the yardstick does not move when the program's data pipeline changes;
its zipf is bounded by the vocabulary, so that the exponent may be 1 (Zipf's
law), where ``numpy``'s unbounded ``zipf`` needs more than 1.  A traffic
mix is a data file beside this one (``<traffic>.json``) that sets the
generator's parameters: ``global_batch`` rows of ``seq_len`` tokens, the
zipf exponent and the motif length.  Batch ``step`` is a pure
function of ``(seed, step)``: every step's rows differ, and every rank
draws the same global batch and takes its own rows.
"""

from __future__ import annotations

import numpy as np

__all__ = ["global_batch", "rank_rows", "zipf_ids"]


def global_batch(traffic: dict, vocab_size: int, seed: int,
                 step: int) -> dict[str, np.ndarray]:
    """The whole batch ``step``: ``tokens`` / ``labels`` int32 (B, S) and
    ``loss_mask`` float32 (B, S), the last position of every row masked."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(seed) % 2 ** 64, int(step)]))
    B, S, V = int(traffic["global_batch"]), int(traffic["seq_len"]), \
        int(vocab_size)
    tokens = zipf_ids(rng, float(traffic["zipf_a"]), V, (B, S))
    motif_len = min(int(traffic["motif_len"]), S // 2)
    motif = rng.integers(0, V, size=(B, motif_len), dtype=np.int32)
    start = rng.integers(0, max(1, S - 2 * motif_len), size=B)
    for b in range(B):
        s0 = start[b]
        tokens[b, s0:s0 + motif_len] = motif[b]
        tokens[b, s0 + motif_len:s0 + 2 * motif_len] = motif[b]
    labels = np.concatenate([tokens[:, 1:], np.zeros((B, 1), np.int32)],
                            axis=1)
    mask = np.ones((B, S), np.float32)
    mask[:, -1] = 0.0
    return {"tokens": tokens, "labels": labels, "loss_mask": mask}


def zipf_ids(rng, a: float, vocab: int, shape) -> np.ndarray:
    """int32 ids of ``shape`` with ``P(id = k)`` proportional to ``(k +
    1) ** -a`` over ``0 .. vocab - 1`` (inverse of the cumulative share)."""
    cdf = np.cumsum(np.arange(1, vocab + 1, dtype=np.float64) ** -a)
    ids = np.searchsorted(cdf / cdf[-1], rng.random(shape), side="right")
    return np.minimum(ids, vocab - 1).astype(np.int32)


def rank_rows(batch: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s rows ``[rank * b, (rank + 1) * b)`` of a global
    batch, ``b = B / world`` (the rows of the DP grid's rank ``node * ppn
    + lane``)."""
    B = next(iter(batch.values())).shape[0]
    if B % world:
        raise ValueError(f"{B} rows do not split over {world} ranks")
    b = B // world
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
