"""Checkpointing: atomic, async, keep-k, restore onto any device.

The port of ``repro/checkpoint/manager.py`` for trees of tensors (dicts,
lists and tuples of ``torch.Tensor``).  Layout: ``<dir>/step_<N>/state.npz``
(flat path-keyed numpy arrays; a bf16 leaf is stored as its 16-bit
pattern) + ``meta.json``.  Writes go to ``step_<N>.tmp`` and are renamed
only when complete, so a crashed save can never shadow a good checkpoint
(the restart path of :mod:`repro_torch.runtime.fault` relies on this).

Restore takes a *template* tree (the live state's structure, shapes,
dtypes and devices): each array is loaded on the host, checked against its
template leaf and copied to that leaf's device.  Async mode copies every
leaf to the host at ``save`` (the snapshot) and writes on a worker thread.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .. import tree as tree_util

__all__ = ["CheckpointManager"]

_SEP = "//"


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        key = f"{prefix}{_SEP}{k}" if prefix else str(k)
        out.update(_flatten(v, key))
    return out


def _to_host(leaf: torch.Tensor) -> np.ndarray:
    """A numpy snapshot of a leaf (bf16 as its 16-bit pattern)."""
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy().copy()


def _from_host(arr: np.ndarray, tmpl: torch.Tensor, key: str):
    if tmpl.dtype == torch.bfloat16:
        t = torch.from_numpy(np.array(arr, order="C")).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, order="C")).to(tmpl.dtype)
    if tuple(t.shape) != tuple(tmpl.shape):
        raise ValueError(
            f"checkpoint leaf {key}: shape {tuple(t.shape)} != "
            f"{tuple(tmpl.shape)}"
        )
    return t.to(tmpl.device)


def _unflatten_into(template, flat: dict):
    """Rebuild the leaves in the structure, dtypes and devices of
    ``template``."""
    leaves, treedef = tree_util.flatten(template)
    keys = list(_flatten(tree_util.unflatten(treedef, list(range(len(leaves))))))
    new = [_from_host(flat[k], leaves[i], k) for i, k in enumerate(keys)]
    return tree_util.unflatten(treedef, new)


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._worker: threading.Thread | None = None
        self._error: Exception | None = None

    # ---- save ---------------------------------------------------------

    def save(self, step: int, state, *, meta: dict | None = None,
             block: bool = False):
        flat = {k: _to_host(v) for k, v in _flatten(state).items()}
        if self.async_save and not block:
            self.wait()
            self._worker = threading.Thread(
                target=self._write, args=(step, flat, meta or {}), daemon=True
            )
            self._worker.start()
        else:
            self._write(step, flat, meta or {})

    def _write(self, step: int, flat: dict, meta: dict):
        try:
            tmp = self.dir / f"step_{step:08d}.tmp"
            final = self.dir / f"step_{step:08d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "state.npz", **flat)
            (tmp / "meta.json").write_text(
                json.dumps({"step": step, "time": time.time(), **meta})
            )
            os.replace(tmp, final)  # atomic publish
            self._gc()
        except Exception as e:  # surfaced on the next wait()
            self._error = e

    def wait(self):
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ---- restore ------------------------------------------------------

    def all_steps(self) -> list[int]:
        return sorted(
            int(p.name.split("_")[1])
            for p in self.dir.glob("step_*")
            if p.is_dir() and not p.name.endswith(".tmp")
        )

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template):
        """Load ``step`` into the structure, dtypes and devices of
        ``template``."""
        path = self.dir / f"step_{step:08d}"
        with np.load(path / "state.npz") as z:
            flat = {k: z[k] for k in z.files}
        return _unflatten_into(template, flat)

    def restore_latest(self, template):
        step = self.latest_step()
        if step is None:
            return None, None
        meta = json.loads(
            (self.dir / f"step_{step:08d}" / "meta.json").read_text()
        )
        return self.restore(step, template), meta
