"""One process per rank: the examples' ``torch.distributed`` worlds.

The reference's examples build a grid of XLA's virtual CPU devices inside
one process.  The port's run one process per rank of an ``n_nodes x ppn``
grid (rank ``node * ppn + lane``): :func:`launch` starts them, each calls
``fn(rank, topology, device, **kwargs)`` and its return value comes back
to the caller.

* On ``cuda`` (the default) one rank runs on each visible card.  Before
  any CUDA tensor exists a rank binds its card (``torch.cuda.set_device``)
  and turns TF32 off, so float32 results compare across backends.  The
  world joins ``cpu:gloo,cuda:nccl`` over ``tcp://localhost`` and passes
  ``device_id=``, so NCCL makes its communicator at once.  Then every
  rank runs one collective on the world group: after that, NCCL's batched
  point-to-point rounds may leave a rank out (the paper's engines have
  such rounds).  The transport kernels are built once, here, before the
  ranks start; each rank only loads them.
* On ``cpu`` the ranks are gloo processes of one thread each.

The grid defaults to ``cpu_grid`` on the CPU (the reference's).  On the
cards it is ``n_nodes x ppn = cards`` with ``ppn`` the smallest factor of
the card count above 1 (4 -> 2x2, 2 -> 1x2, 1 -> 1x1).  An explicit grid
must have one rank per card.  A rank that fails, or a world that outlives
``timeout``, makes :func:`launch` raise after it has ended every rank.

``python -m repro_torch.examples._world <spec> <rank>`` is one rank (the
launcher's own command line).
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch

from ..device import resolve_device

__all__ = ["launch", "world_grid", "default_grid", "parse_grid",
           "add_arguments", "write_report", "CPU_GRID"]

#: the reference's virtual mesh: 4 nodes ("pod") x 4 ranks ("data")
CPU_GRID = (4, 4)

_SRC = Path(__file__).resolve().parents[2]
_MODULE = "repro_torch.examples._world"


def parse_grid(text: str) -> tuple[int, int]:
    """``"NxP"`` -> ``(n_nodes, ppn)``."""
    try:
        n, ppn = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"a grid is NODESxPPN, e.g. 2x2; got {text!r}") \
            from None
    if n < 1 or ppn < 1:
        raise ValueError(f"a grid needs at least one node and one rank a "
                         f"node; got {text!r}")
    return n, ppn


def default_grid(cards: int) -> tuple[int, int]:
    """``cards`` ranks as ``n_nodes x ppn``: ``ppn`` the smallest factor
    above 1, so that a node has two ranks where the count allows."""
    ppn = next((p for p in range(2, cards + 1) if cards % p == 0), 1)
    return cards // ppn, ppn


def world_grid(device=None, grid=None, *, cpu_grid=CPU_GRID
               ) -> tuple[torch.device, tuple[int, int]]:
    """The device and the grid a world runs on (module docstring).  Raises
    without a card unless the CPU is asked for, and for a grid that does
    not have one rank per card."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev, tuple(grid) if grid is not None else tuple(cpu_grid)
    cards = torch.cuda.device_count()
    if grid is None:
        return dev, default_grid(cards)
    n, ppn = grid
    if n * ppn != cards:
        raise ValueError(
            f"a {n}x{ppn} grid is {n * ppn} ranks, one a card, but "
            f"{cards} card(s) are visible (set CUDA_VISIBLE_DEVICES to "
            "run on fewer)")
    return dev, (int(n), int(ppn))


def _target(fn) -> tuple[str, str | None]:
    """``(module:qualname, directory)`` of a module-level function, for a
    new process to import.  ``__main__`` goes by the name it was run
    under (``python -m``) or, for a script run by its path, by its file's
    stem.  ``directory`` is where a top-level module lies (a script under
    ``tools/``, a test module), for the rank to put on its path; ``None``
    for a module of a package."""
    mod = fn.__module__
    module = sys.modules[mod]
    if mod == "__main__":
        spec = getattr(module, "__spec__", None)
        if spec is None and not getattr(module, "__file__", None):
            raise ValueError("launch a function of an importable module or "
                             "script")
        mod = spec.name if spec is not None else Path(module.__file__).stem
    if "<locals>" in fn.__qualname__:
        raise ValueError(f"{fn.__qualname__} is not a module-level function")
    where = None
    if "." not in mod and getattr(module, "__file__", None):
        where = str(Path(module.__file__).resolve().parent)
    return f"{mod}:{fn.__qualname__}", where


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _wait(procs, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        if any(c not in (None, 0) for c in codes):
            raise RuntimeError(f"a rank failed: exit codes by rank {codes}")
        if all(c == 0 for c in codes):
            return
        if time.monotonic() > deadline:
            raise TimeoutError(f"the world did not finish in {timeout:g} s "
                               f"(exit codes by rank {codes})")
        time.sleep(0.05)


def launch(fn, *, device=None, grid=None, cpu_grid=CPU_GRID,
           timeout: float = 900.0, **kwargs) -> list:
    """Run ``fn(rank, topology, device, **kwargs)`` in one process per rank
    and return each rank's value, in rank order.  ``fn`` is a module-level
    function (of a package, or of a script or module that its directory
    makes importable); ``kwargs`` and the values are pickled (tensors
    too).  Rank 0 prints; the other ranks' standard output is dropped,
    their errors are not."""
    dev, (n, ppn) = world_grid(device, grid, cpu_grid=cpu_grid)
    if dev.type == "cuda":
        from ..kernels import build_train_kernels

        build_train_kernels()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_SRC), env.get("PYTHONPATH")) if p)
    if dev.type == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as tmp:
        spec = Path(tmp) / "spec.pt"
        target, where = _target(fn)
        torch.save({"target": target, "path": where, "grid": (n, ppn),
                    "device": dev.type, "port": _free_port(),
                    "timeout": timeout, "kwargs": kwargs}, spec)
        sys.stdout.flush()
        procs = [subprocess.Popen(
            [sys.executable, "-m", _MODULE, str(spec), str(r)], env=env,
            stdout=None if r == 0 else subprocess.DEVNULL)
            for r in range(n * ppn)]
        try:
            _wait(procs, timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(n * ppn)]


def _rank_main(spec_path: str, rank: int) -> None:
    import torch.distributed as dist

    from ..launch.mesh import mesh_topology

    spec = torch.load(spec_path, weights_only=False)
    n, ppn = spec["grid"]
    extra = {}
    if spec["device"] == "cuda":
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        device = torch.device("cuda", rank)
        backend, extra["device_id"] = "cpu:gloo,cuda:nccl", device
    else:
        torch.set_num_threads(1)
        device = torch.device("cpu")
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{spec['port']}", rank=rank,
        world_size=n * ppn,
        timeout=datetime.timedelta(seconds=spec["timeout"]), **extra)
    dist.all_reduce(torch.zeros(1, device=device))
    mod, name = spec["target"].split(":")
    if spec["path"] is not None:
        sys.path.insert(0, spec["path"])
    fn = importlib.import_module(mod)
    for part in name.split("."):
        fn = getattr(fn, part)
    out = fn(rank, mesh_topology(n, ppn), device, **spec["kwargs"])
    dist.barrier()
    dist.destroy_process_group()
    torch.save(out, Path(spec_path).parent / f"rank{rank}.pt")


def add_arguments(ap: argparse.ArgumentParser, *, world: bool = True
                  ) -> None:
    """The examples' shared flags: ``--device``, ``--report`` and, for a
    multi-rank example, ``--grid``."""
    ap.add_argument("--device", default=None,
                    help="cuda (default: one rank a card, NCCL) or cpu "
                         "(gloo processes)")
    if world:
        ap.add_argument("--grid", type=parse_grid, default=None,
                        help="NODESxPPN (default: the reference's on the "
                             "CPU, the visible cards on the GPU)")
    ap.add_argument("--report", default=None,
                    help="write the run's numbers to this JSON file")


def write_report(path, report: dict) -> None:
    if path:
        Path(path).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    try:
        _rank_main(sys.argv[1], int(sys.argv[2]))
    except BaseException:
        # a process group torn down while its peers still wait may block
        # the interpreter's exit: leave at once, the launcher ends the rest
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
