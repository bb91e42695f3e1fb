"""One rank of a gloo world for the port's multi-rank tests (not a test).

    python tests/_torch_world.py <mode> <rank> <world> <store> <out_dir>

Every rank joins the world through the ``file://`` store, runs the checks
of ``mode`` and writes its results to ``<out_dir>/rank<rank>.npz``:

* ``collectives`` — the ``nap``, ``mla``, ``mla_pipelined`` and ``psum``
  engines on the 2x2 and 4x1 grids of a 4-rank world, every op, ragged
  sizes; plus a compressed bucket sync with error feedback;
* ``train`` — the reduced minicpm-2b train step on a 2x2 grid from the
  parameters in ``<out_dir>/params0.npz``: the synced gradients of step 1
  and the losses of 2 int4+EF steps.

``jax_train`` (one process, 4 virtual CPU devices) runs the JAX package's
side of ``train`` and writes ``<out_dir>/jax.npz``.  The tests start a
world with :func:`spawn_world`.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "src"
sys.path.insert(0, str(SRC))

WORLD = 4
GRIDS = ((2, 2), (4, 1))
SIZES = (1, 7, 23, 1000)
OPS = ("sum", "max", "min")
TRAIN_SEQ, TRAIN_BATCH, TRAIN_SEED, TRAIN_STEPS = 32, 8, 3, 2


def engines_for(n, ppn):
    return ("nap", "mla", "mla_pipelined", "psum") if ppn >= 2 else (
        "mla", "mla_pipelined", "psum"
    )


def inputs(world, size, seed):
    return np.random.default_rng(seed).standard_normal(
        (world, size)
    ).astype(np.float32)


def sync_leaves(world):
    rng = np.random.default_rng(11)
    sizes = (300, 5, 1029)
    scale = (1.0, 1e-3, 20.0)  # per-leaf magnitudes far apart
    return [
        (rng.standard_normal((world, s)) * m).astype(np.float32)
        for s, m in zip(sizes, scale)
    ]


def run_collectives(rank, world):
    import torch

    from repro_torch.core import CommContext, CommPolicy, Topology, grad_sync

    out = {}
    for n, ppn in GRIDS:
        topo = Topology.from_world(n, ppn)
        for engine in engines_for(n, ppn):
            ctx = CommContext(topo, CommPolicy(algorithm=engine))
            for op in OPS:
                for size in SIZES:
                    x = torch.from_numpy(inputs(world, size, size)[rank])
                    chunks = 3 if engine == "mla_pipelined" else None
                    y = ctx.allreduce(x, op, pipeline_chunks=chunks)
                    out[f"{n}x{ppn}/{engine}/{op}/{size}"] = y.numpy()
        for bits in (4, 8):
            ctx = CommContext(
                topo, CommPolicy(algorithm="nap", compress_bits=bits,
                                 error_feedback=True),
            )
            leaves = [torch.from_numpy(v[rank]) for v in sync_leaves(world)]
            ef = [torch.zeros_like(g) for g in leaves]
            synced, new_ef = ctx.sync_grads(leaves, ef_state=ef)
            for i, (s, e) in enumerate(zip(synced, new_ef)):
                out[f"{n}x{ppn}/sync{bits}/out{i}"] = s.numpy()
                out[f"{n}x{ppn}/sync{bits}/err{i}"] = e.numpy()
    return out


def train_setup():
    from repro_torch.configs import MINICPM_2B, OptimizerConfig, reduced
    from repro_torch.core import CommPolicy

    cfg = reduced(MINICPM_2B)
    opt = OptimizerConfig(lr=1e-3, schedule="constant", warmup_steps=1)
    policy = CommPolicy(algorithm="nap", mean=True, compress_bits=4,
                        error_feedback=True)
    return cfg, opt, policy


def run_train(rank, world, out_dir):
    import torch

    from repro_torch import tree
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import (
        init_train_state, make_dp_train_step, mesh_topology,
    )
    from repro_torch.models import params_from_jax, params_to_numpy

    cfg, opt, policy = train_setup()
    with np.load(Path(out_dir) / "params0.npz") as z:
        flat0 = [z[f"leaf{i}"] for i in range(len(z.files))]
    topo = mesh_topology(2, 2)
    step = make_dp_train_step(cfg, opt, topo, policy, device="cpu")
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                       seed=TRAIN_SEED, rank=rank, world=world)

    def fresh_state():
        from repro_torch.models import init_params

        _, td = tree.flatten(init_params(cfg, device="meta"))
        params = params_from_jax(tree.unflatten(td, flat0), cfg, "cpu")
        return init_train_state(cfg, opt, policy, params=params, device="cpu")

    out = {}
    # the synced gradients of step 1 (zero residuals)
    state = fresh_state()
    model = state["model"]
    leaves, td = tree.flatten(model.params())
    loss, _ = model(data.batch(0, "cpu"))
    grads = tree.unflatten(td, list(torch.autograd.grad(loss, leaves)))
    with torch.no_grad():
        synced, _ = step.context.sync_grads(
            grads, plan=step.plan, ef_state=state["ef"]
        )
    for i, g in enumerate(tree.leaves(synced)):
        out[f"grad{i}"] = g.numpy()
    # the train steps
    state = fresh_state()
    losses = []
    for s in range(TRAIN_STEPS):
        state, m = step(state, data.batch(s, "cpu"))
        losses.append(float(m["loss"]))
    out["losses"] = np.asarray(losses)
    for i, p in enumerate(tree.leaves(params_to_numpy(state["model"]))):
        out[f"param{i}"] = p
    return out


def run_jax_train(out_dir):
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=4 "
        + os.environ.get("XLA_FLAGS", "")
    )
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro import compat
    from repro.configs.archs import MINICPM_2B, reduced
    from repro.configs.base import OptimizerConfig
    from repro.core import comm
    from repro.data import SyntheticLM
    from repro.launch.mesh import make_mesh, mesh_topology
    from repro.launch.steps import make_dp_train_step
    from repro.models import ShardingPolicy, build_model
    from repro.optim import adamw_init, ef_init

    cfg = dataclasses.replace(reduced(MINICPM_2B), dtype="float32")
    opt = OptimizerConfig(lr=1e-3, schedule="constant", warmup_steps=1)
    policy = comm.CommPolicy(algorithm="nap", mean=True, compress_bits=4,
                             error_feedback=True)
    mesh = make_mesh((2, 2), ("pod", "data"))
    topo = mesh_topology(mesh)
    model = build_model(cfg, ShardingPolicy())
    params0 = jax.jit(model.init)(jax.random.PRNGKey(0))
    data = SyntheticLM(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=TRAIN_SEED, mesh=mesh,
        batch_axes=("pod", "data"),
    )
    out = {}
    for i, p in enumerate(jax.tree.leaves(params0)):
        out[f"init{i}"] = np.array(p, copy=True)

    # the synced gradients of step 1, per chip
    ctx = comm.CommContext(topo, policy)
    sds = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    from repro.core import grad_sync

    plan = grad_sync.plan_for_tree(sds, cfg=policy, topology=topo)

    def local(params, batch):
        (_, _), grads = jax.value_and_grad(model.loss, has_aux=True)(
            params, batch
        )
        ef = jax.tree.map(lambda g: jnp.zeros(g.shape, jnp.float32), grads)
        synced, _ = ctx.sync_grads(grads, plan=plan, ef_state=ef)
        return jax.tree.map(lambda g: g[None], synced)

    sync_fn = jax.jit(compat.shard_map(
        local, mesh=mesh, in_specs=(P(), P(topo.axes, None)),
        out_specs=P(topo.axes), check_vma=False,
    ))
    synced = sync_fn(params0, data.batch(0))
    for i, g in enumerate(jax.tree.leaves(synced)):
        out[f"grad{i}"] = np.array(g, copy=True)

    step = jax.jit(make_dp_train_step(cfg, opt, mesh, policy))
    state = {"params": params0, "opt": adamw_init(params0),
             "ef": ef_init(params0, group=topo.group)}
    losses = []
    for s in range(TRAIN_STEPS):
        state, m = step(state, data.batch(s))
        losses.append(float(m["loss"]))
    out["losses"] = np.asarray(losses)
    for i, p in enumerate(jax.tree.leaves(state["params"])):
        out[f"param{i}"] = np.asarray(p)
    np.savez(Path(out_dir) / "jax.npz", **out)


def spawn_world(mode: str, out_dir: Path, timeout: float = 300.0):
    """Run ``mode`` on a 4-rank gloo world; returns each rank's results."""
    store = out_dir / "store"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), mode, str(r),
             str(WORLD), str(store), str(out_dir)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for r in range(WORLD)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, f"ranks {bad} failed:\n" + "\n".join(
        logs[r][-3000:] for r in bad
    )
    out = []
    for r in range(WORLD):
        with np.load(out_dir / f"rank{r}.npz") as z:
            out.append({k: z[k] for k in z.files})
    return out


def main():
    mode = sys.argv[1]
    if mode == "jax_train":
        run_jax_train(sys.argv[2])
        return
    rank, world, store, out_dir = (
        int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
    )
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world
    )
    try:
        if mode == "collectives":
            out = run_collectives(rank, world)
        elif mode == "train":
            out = run_train(rank, world, out_dir)
        else:
            raise SystemExit(f"unknown mode {mode!r}")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)


if __name__ == "__main__":
    main()
