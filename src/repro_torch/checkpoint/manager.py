"""Checkpointing: atomic, async, keep-k, restore onto any device.

The port of ``repro/checkpoint/manager.py`` for trees of tensors: dicts,
lists, tuples and named tuples whose leaves are ``torch.Tensor``s, Python
ints (an optimizer's step count) or ``nn.Module``s (their parameters, by
name).  Layout: ``<dir>/step_<N>/state.npz`` (flat path-keyed numpy
arrays; a bf16 leaf is stored as its 16-bit pattern) + ``meta.json``.
Writes go to ``step_<N>.tmp`` and are renamed only when complete, so a
crashed save can never shadow a good checkpoint (the restart path of
:mod:`repro_torch.runtime.fault` relies on this).

Restore takes a *template* tree (the live state's structure, shapes,
dtypes and devices): each array is loaded on the host, checked against its
template leaf and copied into that leaf in place, so a restored state is
the template's own tensors (and a module keeps its parameters); only an
int leaf is replaced.  Async mode copies every leaf to the host at
``save`` (the snapshot) and writes on a worker thread.  ``writes`` records
each finished write: its step, bytes on disk and seconds.

A sharded state (DTensor leaves, a model on a mesh) is saved as full
tensors: every rank gathers each leaf (the ranks call ``save`` together)
and rank 0 alone writes, so the files do not depend on the layout.  A
restore fills each template leaf with its own shard of the full array, so
a checkpoint written on one mesh restores on another, or with no mesh, and
the other way round; with a sharded template every rank waits for the
others before it lists the checkpoints.
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
from torch import nn

__all__ = ["CheckpointManager"]

_SEP = "//"


def _key(prefix: str, k) -> str:
    return f"{prefix}{_SEP}{k}" if prefix else str(k)


def _items(node):
    """The children of a container node as ``(name, child)``, or None for a
    leaf."""
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    if isinstance(node, nn.Module):
        return list(node.named_parameters())
    return None


def _flatten(tree, prefix=""):
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, _key(prefix, k)))
    return out


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _sharded(tree) -> bool:
    return any(_is_dtensor(v) for v in _flatten(tree).values())


def _writer() -> bool:
    """This rank writes a sharded state's files (rank 0)."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _to_host(leaf) -> np.ndarray:
    """A numpy snapshot of a leaf (bf16 as its 16-bit pattern; a DTensor's
    full value)."""
    if isinstance(leaf, int):
        return np.asarray(leaf, dtype=np.int64)
    t = leaf.detach()
    if _is_dtensor(t):
        t = t.full_tensor()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy().copy()


@torch.no_grad()
def _fill(arr: np.ndarray, tmpl: torch.Tensor) -> torch.Tensor:
    """Copy ``arr`` into the template leaf ``tmpl`` (shape checked by
    :func:`_check`) and return it."""
    t = torch.from_numpy(np.array(arr, order="C"))
    if tmpl.dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    if _is_dtensor(tmpl):
        from torch.distributed.tensor import distribute_tensor

        # this rank's shard of the full array, in the template's layout
        shard = distribute_tensor(t.to(tmpl.device), tmpl.device_mesh,
                                  tmpl.placements, src_data_rank=None)
        tmpl.to_local().copy_(shard.to_local())
        return tmpl
    tmpl.copy_(t)
    return tmpl


def _check(template, flat: dict, prefix=""):
    """Every template leaf has an array of its shape (before any copy)."""
    items = _items(template)
    if items is None:
        if prefix not in flat:
            raise KeyError(f"checkpoint has no leaf {prefix}")
        if not isinstance(template, int) and (
                tuple(flat[prefix].shape) != tuple(template.shape)):
            raise ValueError(
                f"checkpoint leaf {prefix}: shape {flat[prefix].shape} != "
                f"{tuple(template.shape)}"
            )
        return
    for k, v in items:
        _check(v, flat, _key(prefix, k))


def _restore_into(template, flat: dict, prefix=""):
    """The template with every leaf filled from ``flat``: tensors in place,
    int leaves replaced, containers rebuilt with their types."""
    if isinstance(template, nn.Module):
        for k, p in template.named_parameters():
            _fill(flat[_key(prefix, k)], p)
        return template
    items = _items(template)
    if items is None:
        if isinstance(template, int):
            return int(flat[prefix])
        return _fill(flat[prefix], template)
    values = [_restore_into(v, flat, _key(prefix, k)) for k, v in items]
    if isinstance(template, dict):
        return dict(zip(template.keys(), values))
    if isinstance(template, list):
        return values
    if hasattr(template, "_fields"):  # a named tuple
        return type(template)(*values)
    return tuple(values)


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._worker: threading.Thread | None = None
        self._error: Exception | None = None
        self.writes: list[dict] = []

    # ---- save ---------------------------------------------------------

    def save(self, step: int, state, *, meta: dict | None = None,
             block: bool = False):
        flat = {k: _to_host(v) for k, v in _flatten(state).items()}
        if _sharded(state) and not _writer():
            return
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
            t0 = time.perf_counter()
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
            self.writes.append({
                "step": step,
                "bytes": sum(f.stat().st_size for f in final.iterdir()),
                "seconds": time.perf_counter() - t0,
            })
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
        """Load ``step`` into ``template``: its tensors are filled in place
        (dtypes and devices kept), after every shape was checked."""
        path = self.dir / f"step_{step:08d}"
        with np.load(path / "state.npz") as z:
            flat = {k: z[k] for k in z.files}
        _check(template, flat)
        return _restore_into(template, flat)

    def restore_latest(self, template):
        if _sharded(template):
            import torch.distributed as dist

            # rank 0's last write is complete before any rank looks
            self.wait()
            dist.barrier()
        step = self.latest_step()
        if step is None:
            return None, None
        meta = json.loads(
            (self.dir / f"step_{step:08d}" / "meta.json").read_text()
        )
        return self.restore(step, template), meta
