"""One rank of a gloo world for the port's multi-rank tests (not a test).

    python tests/_torch_world.py <mode> <rank> <world> <store> <out_dir>

Every rank joins the world through the ``file://`` store, runs the checks
of ``mode`` and writes its results to ``<out_dir>/rank<rank>.npz``:

* ``collectives`` — the ``nap``, ``mla``, ``mla_pipelined`` and ``psum``
  engines on the 2x2 and 4x1 grids of a 4-rank world, every op, ragged
  sizes; plus a compressed bucket sync with error feedback;
* ``train`` — the reduced minicpm-2b train step on a 2x2 grid from the
  parameters in ``<out_dir>/params0.npz``: the synced gradients of step 1
  and the losses of 2 int4+EF steps;
* ``rs_ag`` — the reduce-scatter / allgather engines (``mla_rs``,
  ``psum_scatter``, ``mla_ag``, ``all_gather`` and the dispatched choice)
  on the 2x2, 4x1 and 1x4 grids, every op, float32 / bf16 / int32, ragged
  sizes; AG after RS; and the sharded gradient sync (plain, int8, int4,
  mean on and off) with ``unshard_grads``, recording the wire bytes each
  quantize-pack writes;
* ``baselines`` — the ``rd``, ``smp``, ``ring`` and ``rabenseifner``
  engines and the NAP extensions on the grids of the world's size (4:
  2x2, 4x1, 1x4; 6: 3x2, 2x3, 6x1), and each rank's inter-node elements
  in the ``mla``, ``mla_rs`` and ``mla_ag`` engines, counted at the
  group primitives.

* ``serve`` — the serving engine with the tensor-parallel head on a 2x2
  (4 ranks) or 2x3 (6 ranks) grid from the parameters in
  ``<out_dir>/params0.npz``: a three-request workload one request at a
  time and with continuous batching (10 logical slots, the third request
  joining in flight), the same with an EOS token, the engine's dispatch
  report, and ``serve_batch`` on each rank's row of a batch with the EOS
  exit agreed by the group.

* ``serve_whisper`` — the same engine serving reduced whisper-tiny (an
  encoder-decoder: each request carries its encoder frames,
  ``extras_template``) on a 2x2 grid from the parameters in
  ``<out_dir>/params0.npz``: :data:`WHISPER_WORKLOAD` one request at a
  time and with continuous batching.

* ``dp_checks`` — the reference's two DP-training acceptance checks
  (``_multidevice_checks.py::check_dp_training_ef_convergence`` and
  ``check_dp_training_nap_equals_psum``) on a 4x4 grid of 16 ranks from
  the parameters in ``<out_dir>/params0.npz``: 120 steps each of
  uncompressed, int4 + EF and raw int4 ``nap`` sync at lr 1e-2, and 4
  steps each of ``psum`` and ``nap`` at lr 1e-3; the losses of every run.

* ``sharded`` — the FSDP x TP layout on DTensor over a 2x2 ``("data",
  "model")`` mesh, reduced minicpm-2b from ``<out_dir>/params0.npz``: the
  forward loss and the gradients in the parameters' layout, each
  parameter's local shard shape, and 2 ``make_train_step`` steps at
  n_micro 2 (``grad_shardings``); ``build_training`` on the mesh against
  ``mesh=None`` (2 steps), a resume on the mesh against a straight run,
  and checkpoints restored across layouts both ways; ``make_grad_sync``
  on a 2x2 ``("pod", "data")`` mesh (``nap`` mean: plain, int8, int4);
  ``Topology.from_mesh`` with a ``model`` axis (one DP grid per
  model index, ``psum`` and the point-to-point ``rd``); and the other
  families' mixers (MoE too) on the 2x2 mesh against ``mesh=None``
  (:func:`mesh_families`).

* ``mesh_serve`` — serving and MoE on a mesh: reduced minicpm-2b from
  ``<out_dir>/params0.npz`` decoded on a 2x2 ``("data", "model")`` mesh
  under the train layout and ``serve2d`` (prefill, decode logits, greedy
  tokens, the cache's values and local shard shapes); the other families
  decoded on the mesh and with ``mesh=None``; ``moe_apply`` of reduced
  deepseek-moe on 2x2 / 4x1 (train) and 2x2 (``serve2d``) at capacity
  factors 1.0 and 4.0 with ``mesh=None`` beside them, and
  ``build_training(mesh=)`` on it; ``all_to_all`` with its gradient; and
  ``ServeEngine(mesh=)`` / ``serve_batch(mesh=)`` on 2x2 ``("pod",
  "data")``.

* ``uneven`` — the layouts that do not divide (4 ranks): reduced
  minicpm-2b's ``make_train_step`` at n_micro 2 on a 4x1 ``("data",
  "model")`` mesh, whose 4-row microbatches the 8-row batch's view split
  unevenly over the data axis, beside ``mesh=None``; a 3-head, 3-KV-head
  reduced minicpm on 2x2 (heads that do not divide the model axis): the
  loss, its gradients and cached decode (train layout and ``serve2d``)
  beside ``mesh=None``; and the traced int4 / int8 ``make_dp_train_step``
  on the 2x2 grid over the plain transport, with the trace lint's rules
  (:mod:`repro_torch.analysis.trace_lint`) and its transport launches.

``jax_train`` / ``jax_rs_ag`` / ``jax_serve`` / ``jax_sharded`` (one
process, 4 virtual CPU devices) run the JAX package's side of ``train`` /
``rs_ag`` / ``serve`` (2x2) / ``sharded`` (and ``jax_mesh_serve`` the
reference's side of ``mesh_serve``) and write
``<out_dir>/jax.npz``.  ``jax_specs`` (512 virtual CPU devices) writes
the reference's ``input_specs`` / ``state_specs`` of every dry-run cell on
both production meshes (and, for every prefill and decode cell, with
``serve2d=True``) to ``<out_dir>/jax_specs.json``: each leaf's shape,
dtype and spec.  The tests start a world with :func:`spawn_world`.
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


RSAG_GRIDS = ((2, 2), (4, 1), (1, 4))
DTYPES = ("float32", "bfloat16", "int32")
BASELINE_GRIDS = {4: ((2, 2), (4, 1), (1, 4)), 6: ((3, 2), (2, 3), (6, 1))}
BASELINES = ("rd", "smp", "ring", "rabenseifner")
#: payload sizes for the inter-node byte count: divisible by every grid
#: (the executed engines pad blocks to one size, so they meet the ragged
#: bound exactly only there) and ragged
COUNT_SIZES = (120, 23)
SHARDED_POLICIES = (
    ("plain_mean", dict(mean=True)),
    ("plain_sum", dict(mean=False)),
    ("int8_mean", dict(mean=True, compress_bits=8)),
    ("int4_mean", dict(mean=True, compress_bits=4)),
    ("int4_sum", dict(mean=False, compress_bits=4)),
)


SERVE_GRIDS = {4: (2, 2), 6: (2, 3)}
#: (prompt, max_new_tokens): two prompt buckets, three budgets
SERVE_WORKLOAD = (([3, 1, 4], 5), ([1, 5, 9, 2, 6], 4), ([2, 7, 1, 8], 6))
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_BUCKETS = 10, 24, (4, 8)


def serve_streams(engine, workload=SERVE_WORKLOAD):
    """Token streams of ``workload`` through ``engine``: continuous
    batching, the third request submitted after the first step."""
    reqs = [engine.submit(p, b) for p, b in workload[:2]]
    engine.step()
    reqs.append(engine.submit(*workload[2]))
    out = engine.run()
    assert engine.idle
    return [out[r.rid] for r in reqs]


#: reduced whisper-tiny's requests: (prompt, max_new_tokens, frames seed)
WHISPER_WORKLOAD = (([3, 1, 4], 5, 0), ([1, 5, 9, 2, 6], 4, 1),
                    ([2, 7, 1, 8], 6, 2))
WHISPER_FRAMES = 12


def whisper_extras(cfg, seed: int) -> dict:
    """One request's seeded encoder frames, (1, WHISPER_FRAMES, D)
    float32 numpy."""
    rng = np.random.default_rng(1000 + seed)
    return {"frames": (rng.standard_normal((1, WHISPER_FRAMES, cfg.d_model))
                       * 0.5).astype(np.float32)}


def whisper_streams(engine, cfg, workload=WHISPER_WORKLOAD):
    """:func:`serve_streams` of requests that carry their frames."""
    reqs = [engine.submit(p, b, extras=whisper_extras(cfg, f))
            for p, b, f in workload[:2]]
    engine.step()
    reqs += [engine.submit(p, b, extras=whisper_extras(cfg, f))
             for p, b, f in workload[2:]]
    out = engine.run()
    assert engine.idle
    return [out[r.rid] for r in reqs]


def whisper_serial(engine, cfg, workload=WHISPER_WORKLOAD):
    """The same requests one at a time through ``engine``."""
    out = []
    for p, b, f in workload:
        req = engine.submit(p, b, extras=whisper_extras(cfg, f))
        out.append(engine.run()[req.rid])
    return out


def serve_serial(engine, workload=SERVE_WORKLOAD):
    """The same requests one at a time through ``engine``."""
    streams = []
    for prompt, budget in workload:
        req = engine.submit(prompt, budget)
        streams.append(engine.run()[req.rid])
    return streams


def rs_engines(n):
    return ("mla_rs", "psum_scatter", "auto") if n >= 2 else (
        "psum_scatter", "auto")


def ag_engines(n):
    return ("mla_ag", "all_gather", "auto") if n >= 2 else (
        "all_gather", "auto")


def rsag_inputs(world, size, seed, dtype, op):
    """(world, size) float32 values: random normals for float32, small
    integers otherwise: |x| < 40, so that every partial sum of up to 6
    ranks is an integer below 256, exact in bf16."""
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        return rng.standard_normal((world, size)).astype(np.float32)
    return rng.integers(-39, 40, (world, size)).astype(np.float32)


def shard_len(size, world):
    """Per-rank shard of a reduce-scatter: ceil(ceil(e/ppn)/n) =
    ceil(e/p) elements."""
    return -(-size // world)


def sharded_leaves(world):
    """Per-rank gradient leaves: float32 leaves of ragged sizes and far
    apart magnitudes, a bf16 leaf and an int32 leaf."""
    rng = np.random.default_rng(12)
    out = [(rng.standard_normal((world, s)) * m).astype(np.float32)
           for s, m in ((300, 1.0), (5, 1e-3), (1029, 20.0), (77, 0.5))]
    out.append(rng.integers(-1000, 1000, (world, 41)).astype(np.int32))
    return out, ("float32", "float32", "float32", "bfloat16", "int32")


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


def _torch_dtype(name):
    import torch

    return getattr(torch, name)


def _stored(t):
    """A tensor as stored in the results: bf16 widened to float32."""
    import torch

    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def run_rs_ag(rank, world):
    import torch

    from repro_torch.core import CommContext, CommPolicy, Topology, grad_sync

    out = {}
    for n, ppn in RSAG_GRIDS:
        ctx = CommContext(Topology.from_world(n, ppn))
        for dtype in DTYPES:
            tdt = _torch_dtype(dtype)
            for op in OPS:
                for size in SIZES:
                    x = torch.from_numpy(
                        rsag_inputs(world, size, size, dtype, op)[rank]
                    ).to(tdt)
                    for eng in rs_engines(n):
                        algo = None if eng == "auto" else eng
                        y = ctx.reduce_scatter(x, op, algorithm=algo)
                        assert y.dtype == tdt
                        out[f"{n}x{ppn}/rs/{eng}/{dtype}/{op}/{size}"] = (
                            _stored(y))
            for size in SIZES:
                L = shard_len(size, world)
                x = torch.from_numpy(
                    rsag_inputs(world, L, size + 1, dtype, "sum")[rank]
                ).to(tdt)
                for eng in ag_engines(n):
                    algo = None if eng == "auto" else eng
                    y = ctx.allgather(x, elems=size, algorithm=algo)
                    out[f"{n}x{ppn}/ag/{eng}/{dtype}/{size}"] = _stored(y)
                # AG after RS gives back the sum
                x = torch.from_numpy(
                    rsag_inputs(world, size, size, dtype, "sum")[rank]
                ).to(tdt)
                for rs, ag in (("mla_rs", "mla_ag"),
                               ("psum_scatter", "all_gather")):
                    if n < 2 and rs == "mla_rs":
                        continue
                    full = ctx.allgather(
                        ctx.reduce_scatter(x, algorithm=rs), elems=size,
                        algorithm=ag)
                    out[f"{n}x{ppn}/agrs/{rs}/{dtype}/{size}"] = _stored(full)
        vals, dtypes = sharded_leaves(world)
        leaves = [torch.from_numpy(v[rank]).to(_torch_dtype(d))
                  for v, d in zip(vals, dtypes)]
        wires = []
        quantize = grad_sync.transport.quantize_pack

        def recording(*args, **kw):
            w = quantize(*args, **kw)
            wires.append(w.clone())
            return w

        grad_sync.transport.quantize_pack = recording
        try:
            for name, kw in SHARDED_POLICIES:
                ctx = CommContext(Topology.from_world(n, ppn), CommPolicy(**kw))
                wires.clear()
                shards = ctx.sync_grads_sharded(leaves)
                full = grad_sync.unshard_grads(shards, leaves, ctx=ctx)
                key = f"{n}x{ppn}/sharded/{name}"
                for i, (s_, f_) in enumerate(zip(shards, full)):
                    assert s_.dtype == f_.dtype == leaves[i].dtype
                    out[f"{key}/shard{i}"] = _stored(s_)
                    out[f"{key}/full{i}"] = _stored(f_)
                for k, w in enumerate(wires):
                    out[f"{key}/wire{k}"] = w.view(torch.uint8).numpy()
        finally:
            grad_sync.transport.quantize_pack = quantize
    return out


def _count_internode(topo, counts):
    """Wrap the group primitives so that each call over this rank's
    inter-node group adds the elements this rank sends to ``counts``."""
    from repro_torch.core import collectives as C

    inter = topo.require_groups().inter
    saved = {k: getattr(C, k) for k in
             ("_reduce_scatter", "_all_to_all", "_all_gather")}

    def rows_out(tiles, group):
        if group is inter and group.size > 1:
            counts[0] += (group.size - 1) * tiles[0].numel()

    def reduce_scatter(tiles, group):
        rows_out(tiles, group)
        return saved["_reduce_scatter"](tiles, group)

    def all_to_all(tiles, group):
        rows_out(tiles, group)
        return saved["_all_to_all"](tiles, group)

    def all_gather(x, group):
        rows_out(x[None], group)
        return saved["_all_gather"](x, group)

    C._reduce_scatter, C._all_to_all, C._all_gather = (
        reduce_scatter, all_to_all, all_gather)
    return saved


def run_baselines(rank, world):
    import torch

    from repro_torch.core import CommContext, CommPolicy, Topology
    from repro_torch.core import collectives as C
    from repro_torch.core import extensions

    out = {}
    for n, ppn in BASELINE_GRIDS[world]:
        topo = Topology.from_world(n, ppn)
        for eng in BASELINES:
            ctx = CommContext(topo, CommPolicy(algorithm=eng))
            for op in OPS:
                for size in SIZES:
                    x = torch.from_numpy(inputs(world, size, size)[rank])
                    out[f"{n}x{ppn}/{eng}/{op}/{size}"] = ctx.allreduce(
                        x, op).numpy()
            for size in SIZES:
                x = torch.from_numpy(rsag_inputs(
                    world, size, size, "bfloat16", "sum")[rank]).to(
                    torch.bfloat16)
                y = ctx.allreduce(x)
                assert y.dtype == torch.bfloat16
                out[f"{n}x{ppn}/{eng}/bf16/{size}"] = _stored(y)
        ok = extensions.supported(n, ppn)
        out[f"{n}x{ppn}/ext/supported"] = np.asarray(ok)
        for size in SIZES:
            x = torch.from_numpy(inputs(world, size, size)[rank])
            rows = torch.from_numpy(inputs(world, world * size, size + 2)[
                rank].reshape(world, size))
            calls = (
                ("allgather", lambda: extensions.nap_allgather(
                    x, topology=topo)),
                ("reduce_scatter", lambda: extensions.nap_reduce_scatter(
                    rows, topology=topo)),
                ("allreduce_large", lambda: extensions.nap_allreduce_large(
                    x, topology=topo)),
            )
            for name, call in calls:
                if ok:
                    out[f"{n}x{ppn}/ext/{name}/{size}"] = call().numpy()
                else:
                    try:
                        call()
                    except ValueError:
                        continue
                    raise AssertionError(f"{name} ran on {n}x{ppn}")
        # each rank's inter-node elements in the striped engines
        for size in COUNT_SIZES:
            x = torch.from_numpy(inputs(world, size, size)[rank])
            for eng, collective in (("mla", "allreduce"),
                                    ("mla_rs", "reduce_scatter"),
                                    ("mla_ag", "allgather")):
                if n < 2:
                    continue
                counts = [0]
                saved = _count_internode(topo, counts)
                try:
                    ctx = CommContext(topo)
                    if collective == "allreduce":
                        ctx.allreduce(x, algorithm=eng)
                    elif collective == "reduce_scatter":
                        ctx.reduce_scatter(x, algorithm=eng)
                    else:
                        ctx.allgather(x[: shard_len(size, world)],
                                      elems=size, algorithm=eng)
                finally:
                    for k, f in saved.items():
                        setattr(C, k, f)
                out[f"{n}x{ppn}/count/{eng}/{size}"] = np.asarray(counts[0])
    return out


def run_jax_rs_ag(out_dir):
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=4 "
        + os.environ.get("XLA_FLAGS", "")
    )
    import functools

    import jax
    import jax.numpy as jnp
    import ml_dtypes
    from jax import lax
    from jax.sharding import PartitionSpec as P

    import repro.kernels.transport as jt
    from repro import compat
    from repro.core import comm, grad_sync
    from repro.launch.mesh import make_mesh, mesh_topology

    world = 4
    np_dt = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
             "int32": np.int32}
    out = {}
    wires = []
    quantize, unpack = jt.quantize_pack, jt.unpack_dequantize
    agreed_absmax = grad_sync._agreed_absmax

    def stored(a):
        a = np.asarray(a)
        return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a

    for n, ppn in RSAG_GRIDS:
        mesh = make_mesh((n, ppn), ("pod", "data"))
        topo = mesh_topology(mesh)
        ctx = comm.CommContext(topo)
        spec = P(topo.axes)

        def smap(fn, n_in):
            return jax.jit(compat.shard_map(
                fn, mesh=mesh, in_specs=(spec,) * n_in, out_specs=spec,
                check_vma=False))

        for dtype in DTYPES:
            for op in OPS:
                for eng in rs_engines(n):
                    algo = None if eng == "auto" else eng
                    fn = smap(lambda *xs: tuple(
                        ctx.reduce_scatter(x.reshape(-1), op,
                                           algorithm=algo)[None]
                        for x in xs), len(SIZES))
                    ys = fn(*(jnp.asarray(rsag_inputs(
                        world, size, size, dtype, op).astype(np_dt[dtype]))
                        for size in SIZES))
                    for size, y in zip(SIZES, ys):
                        out[f"{n}x{ppn}/rs/{eng}/{dtype}/{op}/{size}"] = (
                            stored(y))
            for eng in ag_engines(n):
                algo = None if eng == "auto" else eng
                fn = smap(lambda *xs: tuple(
                    ctx.allgather(x.reshape(-1), elems=size,
                                  algorithm=algo)[None]
                    for x, size in zip(xs, SIZES)), len(SIZES))
                ys = fn(*(jnp.asarray(rsag_inputs(
                    world, shard_len(size, world), size + 1, dtype,
                    "sum").astype(np_dt[dtype])) for size in SIZES))
                for size, y in zip(SIZES, ys):
                    out[f"{n}x{ppn}/ag/{eng}/{dtype}/{size}"] = stored(y)

        # the sharded sync, its transport in the jnp reference (impl="xla"),
        # each quantize-pack's wire bytes recorded per chip
        def recording(x, scales, *, _calls=[0], **kw):
            w = quantize(x, scales, impl="xla", **kw)
            k = _calls[0]
            _calls[0] += 1
            chip = lax.axis_index("pod") * ppn + lax.axis_index("data")
            jax.debug.callback(
                lambda c, w_, k=k: wires.append((k, int(c), np.asarray(w_))),
                chip, w)
            return w

        jt.quantize_pack = recording
        jt.unpack_dequantize = functools.partial(unpack, impl="xla")
        if n > 1 and ppn < 2:
            # the reference's fused NAP-max raises on single-lane grids
            # (NAP needs two lanes); agree the same maxima with one pmax
            grad_sync._agreed_absmax = lambda parts, ctx: lax.pmax(
                jnp.stack([jnp.max(jnp.abs(p)).astype(jnp.float32)
                           for p in parts]), ctx.topology.axes)
        vals, dtypes = sharded_leaves(world)
        args = [jnp.asarray(v.astype(np_dt[d])) for v, d in zip(vals, dtypes)]
        try:
            for name, kw in SHARDED_POLICIES:
                sctx = comm.CommContext(topo, comm.CommPolicy(**kw))

                def local(*leaves, sctx=sctx):
                    leaves = [g.reshape(g.shape[1:]) for g in leaves]
                    shards = grad_sync.sync_grads_sharded(leaves, ctx=sctx)
                    full = grad_sync.unshard_grads(shards, leaves, ctx=sctx)
                    return tuple(t[None] for t in (*shards, *full))

                del wires[:]
                recording.__kwdefaults__["_calls"][0] = 0
                res = smap(local, len(args))(*args)
                jax.block_until_ready(res)
                key = f"{n}x{ppn}/sharded/{name}"
                L = len(args)
                for i in range(L):
                    out[f"{key}/shard{i}"] = stored(res[i])
                    out[f"{key}/full{i}"] = stored(res[L + i])
                for k in sorted({k for k, _, _ in wires}):
                    rows = dict((c, w) for kk, c, w in wires if kk == k)
                    out[f"{key}/wire{k}"] = np.stack(
                        [rows[c].view(np.uint8) for c in range(world)])
        finally:
            jt.quantize_pack, jt.unpack_dequantize = quantize, unpack
            grad_sync._agreed_absmax = agreed_absmax
    np.savez(Path(out_dir) / "jax.npz", **out)


def run_serve(rank, world, out_dir):
    from repro_torch import tree
    from repro_torch.configs import MINICPM_2B, reduced
    from repro_torch.core import CommContext, Topology
    import torch

    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import build_model, init_params, params_from_jax
    from repro_torch.serve import PromptBuckets, ServeEngine

    cfg = reduced(MINICPM_2B)
    with np.load(Path(out_dir) / "params0.npz") as z:
        flat0 = [z[f"leaf{i}"] for i in range(len(z.files))]
    _, td = tree.flatten(init_params(cfg, device="meta"))
    model = build_model(cfg, params_from_jax(tree.unflatten(td, flat0), cfg,
                                             "cpu"), device="cpu")
    ctx = CommContext(Topology.from_world(*SERVE_GRIDS[world]))

    def engine(eos_id=None):
        return ServeEngine(model, num_slots=SERVE_SLOTS,
                           max_len=SERVE_MAX_LEN,
                           buckets=PromptBuckets(SERVE_BUCKETS),
                           eos_id=eos_id, ctx=ctx, device="cpu")

    out = {}
    serial = serve_serial(engine())
    cont_engine = engine()
    cont = serve_streams(cont_engine)
    eos = serial[0][2]
    with_eos = serve_streams(engine(eos_id=eos))
    for i in range(len(SERVE_WORKLOAD)):
        out[f"serial{i}"] = np.asarray(serial[i])
        out[f"cont{i}"] = np.asarray(cont[i])
        out[f"eos{i}"] = np.asarray(with_eos[i])
    out["eos_id"] = np.asarray(eos)
    out["b_max"] = np.asarray(cont_engine.b_max)
    # the fixed-batch driver: each rank serves its row, the EOS exit agreed
    # by the group; the whole batch in one process is the reference
    prompts = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (world, 4)))
    free = serve_batch(model, prompts, gen_len=6, device="cpu")
    eos = int(free[0, 1])
    out["batch_ref"] = serve_batch(model, prompts, gen_len=6, eos_id=eos,
                                   device="cpu").numpy()
    out["batch_row"] = serve_batch(model, prompts[rank:rank + 1], gen_len=6,
                                   eos_id=eos, ctx=ctx, device="cpu").numpy()
    for name, row in cont_engine.dispatch_report().items():
        out[f"dispatch/{name}"] = np.asarray(row["engine"])
    return out


def run_serve_whisper(rank, world, out_dir):
    import torch

    from repro_torch import tree
    from repro_torch.configs import WHISPER_TINY, reduced
    from repro_torch.core import CommContext, Topology
    from repro_torch.models import build_model, init_params, params_from_jax
    from repro_torch.serve import PromptBuckets, ServeEngine

    cfg = reduced(WHISPER_TINY)
    with np.load(Path(out_dir) / "params0.npz") as z:
        flat0 = [z[f"leaf{i}"] for i in range(len(z.files))]
    _, td = tree.flatten(init_params(cfg, device="meta"))
    model = build_model(cfg, params_from_jax(tree.unflatten(td, flat0), cfg,
                                             "cpu"), device="cpu")
    ctx = CommContext(Topology.from_world(*SERVE_GRIDS[world]))
    template = {"frames": torch.empty((1, WHISPER_FRAMES, cfg.d_model),
                                      device="meta")}

    def engine():
        return ServeEngine(model, num_slots=SERVE_SLOTS,
                           max_len=SERVE_MAX_LEN,
                           buckets=PromptBuckets(SERVE_BUCKETS), ctx=ctx,
                           extras_template=template, device="cpu")

    out = {}
    for i, (s, c) in enumerate(zip(whisper_serial(engine(), cfg),
                                   whisper_streams(engine(), cfg))):
        out[f"serial{i}"] = np.asarray(s)
        out[f"cont{i}"] = np.asarray(c)
    return out


def run_jax_serve(out_dir):
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=4 "
        + os.environ.get("XLA_FLAGS", "")
    )
    import jax

    from repro.configs.archs import MINICPM_2B, reduced
    from repro.launch.mesh import make_mesh
    from repro.models import build_model
    from repro.serve import PromptBuckets, ServeEngine

    model = build_model(reduced(MINICPM_2B))
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    mesh = make_mesh(SERVE_GRIDS[4], ("pod", "data"))

    def engine():
        return ServeEngine(model, params, num_slots=SERVE_SLOTS,
                           max_len=SERVE_MAX_LEN,
                           buckets=PromptBuckets(SERVE_BUCKETS), mesh=mesh)

    out = {}
    for i, (s, c) in enumerate(zip(serve_serial(engine()),
                                   serve_streams(engine()))):
        out[f"serial{i}"] = np.asarray(s)
        out[f"cont{i}"] = np.asarray(c)
    np.savez(Path(out_dir) / "jax.npz", **out)


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


DP_GRID, DP_SEQ, DP_BATCH, DP_SEED = (4, 4), 32, 16, 3
DP_EF_STEPS, DP_PSUM_STEPS = 120, 4
#: the three transports of the convergence check
DP_EF_RUNS = (
    ("base", dict(algorithm="nap", mean=True)),
    ("ef4", dict(algorithm="nap", mean=True, compress_bits=4,
                 error_feedback=True)),
    ("raw4", dict(algorithm="nap", mean=True, compress_bits=4)),
)


def dp_losses(cfg, params, topo, policy, opt, data, steps, device="cpu"):
    """The losses of ``steps`` DP train steps from ``params``."""
    from repro_torch.launch import init_train_state, make_dp_train_step

    step = make_dp_train_step(cfg, opt, topo, policy, device=device)
    state = init_train_state(cfg, opt, policy, params=params, device=device)
    losses = []
    for s in range(steps):
        state, m = step(state, data.batch(s, device))
        losses.append(float(m["loss"]))
    return np.asarray(losses)


def ef_criteria(base, ef4, raw4):
    """The reference's five criteria of the convergence check, with the
    numbers they compare."""
    tail = lambda ls: float(np.mean(ls[-10:]))  # noqa: E731
    out = {
        "base_tail": tail(base), "ef4_tail": tail(ef4),
        "raw4_tail": tail(raw4),
        "gap_ef": abs(tail(ef4) - tail(base)),
        "gap_raw": abs(tail(raw4) - tail(base)),
        "dev_ef": float(np.mean(np.abs(np.asarray(ef4) - base))),
        "dev_raw": float(np.mean(np.abs(np.asarray(raw4) - base))),
    }
    out["criteria"] = {
        "finite": bool(np.all(np.isfinite(ef4))),
        "learned": out["base_tail"] < base[0] - 0.5,
        "gap_ef": out["gap_ef"] < 0.15 * out["base_tail"],
        "gap_raw": out["gap_raw"] > out["gap_ef"],
        "dev_raw": out["dev_raw"] > 1.4 * out["dev_ef"],
    }
    return out


def run_dp_checks(rank, world, out_dir):
    import time

    from repro_torch import tree
    from repro_torch.configs import MINICPM_2B, OptimizerConfig, reduced
    from repro_torch.core import CommPolicy
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import mesh_topology
    from repro_torch.models import init_params, params_from_jax

    cfg = reduced(MINICPM_2B)
    with np.load(Path(out_dir) / "params0.npz") as z:
        flat0 = [z[f"leaf{i}"] for i in range(len(z.files))]
    _, td = tree.flatten(init_params(cfg, device="meta"))
    params = params_from_jax(tree.unflatten(td, flat0), cfg, "cpu")
    topo = mesh_topology(*DP_GRID)
    data = SyntheticLM(cfg.vocab_size, DP_SEQ, DP_BATCH, seed=DP_SEED,
                       rank=rank, world=world)
    t0 = time.perf_counter()
    out = {}
    opt = OptimizerConfig(lr=1e-2, schedule="constant", warmup_steps=1)
    for name, kw in DP_EF_RUNS:
        out[name] = dp_losses(cfg, params, topo, CommPolicy(**kw), opt, data,
                              DP_EF_STEPS)
    opt = OptimizerConfig(lr=1e-3, schedule="constant", warmup_steps=1)
    for algo in ("psum", "nap"):
        out[algo] = dp_losses(cfg, params, topo,
                              CommPolicy(algorithm=algo, mean=True), opt,
                              data, DP_PSUM_STEPS)
    out["seconds"] = np.asarray(time.perf_counter() - t0)
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


SHARD_MESH = ((2, 2), ("data", "model"))
SYNC_MESH = ((2, 2), ("pod", "data"))
SHARD_SEQ, SHARD_BATCH, SHARD_MICRO, SHARD_SEED = 32, 8, 2, 3
SHARD_STEPS = 2
#: make_grad_sync's policies: (name, CommPolicy keywords)
SYNC_POLICIES = (
    ("plain", dict(algorithm="nap", mean=True)),
    ("int8", dict(algorithm="nap", mean=True, compress_bits=8)),
    ("int4", dict(algorithm="nap", mean=True, compress_bits=4)),
)


def sync_grads_numpy(world):
    """Per-rank gradients for the sync: leaf (world, ...) float32, row
    ``r`` rank ``r``'s (the reference check's "w" / "b", plus a longer
    leaf)."""
    rng = np.random.default_rng(3)
    return {
        "b": rng.normal(size=(world, 2)).astype(np.float32),
        "e": rng.normal(size=(world, 300)).astype(np.float32),
        "w": rng.normal(size=(world, 4, 2)).astype(np.float32),
    }


def shard_opt():
    from repro_torch.configs import OptimizerConfig

    return OptimizerConfig(lr=1e-3, schedule="constant", warmup_steps=1)


def _full_tensor(t):
    """The whole value of a DTensor (a plain tensor as it is)."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _full(t):
    import torch

    return _full_tensor(t).detach().to(torch.float32).numpy().copy()


def _train_cfg(steps, every=0):
    from repro_torch.configs import TrainConfig

    return TrainConfig(steps=steps, seq_len=SHARD_SEQ,
                       global_batch=SHARD_BATCH,
                       microbatch=SHARD_BATCH // SHARD_MICRO,
                       seed=SHARD_SEED, checkpoint_every=every,
                       optimizer=shard_opt())


def run_sharded(rank, world, out_dir):
    import torch
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.configs import MINICPM_2B, reduced
    from repro_torch.core import CommPolicy, comm, grad_sync
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import build_training, make_mesh, make_policy
    from repro_torch.launch import make_train_step
    from repro_torch.models import build_model, init_params, params_from_jax
    from repro_torch.models.sharding import spec_leaves
    from repro_torch.optim import adamw_init

    out_dir = Path(out_dir)
    cfg = reduced(MINICPM_2B)
    with np.load(out_dir / "params0.npz") as z:
        flat0 = [z[f"leaf{i}"] for i in range(len(z.files))]
    _, td = tree.flatten(init_params(cfg, device="meta"))
    params = params_from_jax(tree.unflatten(td, flat0), cfg, "cpu")
    mesh = make_mesh(*SHARD_MESH)
    policy = make_policy(cfg, mesh, device="cpu")
    data = SyntheticLM(cfg.vocab_size, SHARD_SEQ, SHARD_BATCH,
                       seed=SHARD_SEED, mesh=mesh, batch_axes=("data",))
    out = {}

    # forward loss and gradients, in the parameters' layout
    model = build_model(cfg, params, policy=policy, device="cpu")
    specs = spec_leaves(policy.param_specs(model.params()))
    with policy.scope():
        loss, _ = model(data.batch(0, "cpu"))
        grads = torch.autograd.grad(loss, model.leaves())
    out["loss0"] = np.asarray(float(loss.full_tensor()))
    for i, (g, p, sp) in enumerate(zip(grads, model.leaves(), specs)):
        g = policy.constrain(g, sp)
        assert tuple(g.placements) == tuple(p.placements), i
        out[f"grad{i}"] = _full(g)
        out[f"shape{i}"] = np.asarray(p.to_local().shape)

    # make_train_step over the mesh
    model = build_model(cfg, params, policy=policy, device="cpu")
    state = {"model": model, "opt": adamw_init(model.params())}
    step = make_train_step(model, shard_opt(), n_micro=SHARD_MICRO,
                           grad_shardings=policy.param_specs(model.params()),
                           device="cpu")
    losses = []
    for s in range(SHARD_STEPS):
        state, m = step(state, data.batch(s, "cpu"))
        losses.append(float(m["loss"]))
    out["losses"] = np.asarray(losses)
    for i, p in enumerate(model.leaves()):
        out[f"param{i}"] = _full(p)
    for i, (mu, p) in enumerate(zip(state["opt"].mu, model.leaves())):
        assert tuple(mu.placements) == tuple(p.placements), i

    # build_training on the mesh against mesh=None; resume; restores
    def loop(steps, ckpt, m=mesh, every=0):
        return build_training(cfg, _train_cfg(steps, every), mesh=m,
                              ckpt_dir=ckpt, device="cpu")

    def run(lp, until):
        lp.run(until)
        return np.asarray([x["loss"] for x in lp.metrics_log])

    def params_of(lp):
        return [_full(p) for p in lp.state["model"].leaves()]

    straight = loop(4, out_dir / f"straight{rank}")
    out["mesh_losses"] = run(straight, 4)
    out["mesh_params"] = np.concatenate(
        [p.reshape(-1) for p in params_of(straight)])
    plain = loop(4, out_dir / f"plain{rank}", m=None, every=2)
    out["plain_losses"] = run(plain, 4)
    # resume on the mesh: 2 steps with a checkpoint after step 1 (rank 0
    # writes it), then a fresh loop up to step 4
    first = loop(4, out_dir / "resume", every=2)
    run(first, 2)
    out["ckpt_params"] = np.concatenate(
        [p.reshape(-1) for p in params_of(first)])
    resumed = loop(4, out_dir / "resume")
    assert resumed.start_step == 2
    out["resumed_losses"] = run(resumed, 4)
    out["resumed_params"] = np.concatenate(
        [p.reshape(-1) for p in params_of(resumed)])
    # the mesh's checkpoint into mesh=None (every rank reads rank 0's
    # files), and rank 0's mesh=None checkpoint (after step 3) into the mesh
    dist.barrier()
    across = loop(4, out_dir / "resume", m=None)
    assert across.start_step == 2
    out["into_plain_params"] = np.concatenate(
        [p.reshape(-1) for p in params_of(across)])
    out["into_plain_losses"] = run(across, 4)
    back = loop(4, out_dir / "plain0")
    assert back.start_step == 4
    out["into_mesh_params"] = np.concatenate(
        [p.reshape(-1) for p in params_of(back)])
    out["plain_params"] = np.concatenate(
        [p.reshape(-1) for p in params_of(plain)])

    # make_grad_sync on ("pod", "data")
    smesh = make_mesh(*SYNC_MESH)
    gnp = sync_grads_numpy(world)
    gspecs = {k: (("pod", "data"),) for k in gnp}
    dm = smesh.device_mesh("cpu")
    from torch.distributed.tensor import DTensor

    from repro_torch.models.sharding import placements

    for name, kw in SYNC_POLICIES:
        sync = grad_sync.make_grad_sync(
            CommPolicy(**kw), smesh, data_axes=("pod", "data"),
            grad_specs=gspecs, device="cpu")
        g = {k: DTensor.from_local(torch.from_numpy(v[rank:rank + 1].copy()),
                                   dm, placements(smesh, gspecs[k]),
                                   run_check=False)
             for k, v in gnp.items()}
        res = sync(g)
        assert sync.context.topology.axes == ("pod", "data")
        for k, t in res.items():
            assert tuple(t.placements) == tuple(g[k].placements)
            out[f"sync/{name}/{k}"] = t.to_local().numpy()[0].copy()
        out[f"sync/{name}/buckets"] = np.asarray(len(sync.plan.buckets))

    # the other families' mixers on the 2x2 mesh against mesh=None
    out.update(mesh_families(mesh))

    # two mesh axes on one dim: PartitionSpec(("pod", "data"))'s order
    from torch.distributed.tensor import distribute_tensor

    rows = torch.arange(16, dtype=torch.float32).reshape(8, 2)
    out["fsdp2"] = distribute_tensor(
        rows, dm, placements(smesh, (("pod", "data"), None)),
        src_data_rank=None).to_local().numpy()

    # Topology.from_mesh with a model axis: one DP grid per model index
    x = torch.full((5,), float(rank + 1))
    for names in (("data", "model"), ("pod", "model")):
        tmesh = make_mesh((2, 2), names)
        topo = comm.Topology.from_mesh(tmesh)
        ctx = comm.CommContext(topo)
        for algo in ("psum", "rd"):
            out[f"topo/{names[0]}/{algo}"] = ctx.allreduce(
                x, algorithm=algo).numpy()
    return out


def _rwkv_group_norm_exact(x, scale, H, hd, eps=1e-5):
    """RWKV's per-head norm without its bf16 round trip (a rounding
    boundary moves with the summation order)."""
    import torch

    shape = x.shape
    x = x.reshape(*shape[:-1], H, hd).to(torch.float32)
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return ((x - mu) * torch.rsqrt(var + eps)).reshape(shape) * scale


def mesh_family_configs():
    """Reduced configs whose mixers the mesh runs: GQA with a window and
    softcaps (gemma2), MQA (granite), QKV bias (qwen2), RWKV6, jamba's
    Mamba + attention super-layer with dense FFNs and with its experts,
    and deepseek-moe; the MoE ones at a capacity factor where nothing
    drops (the expert-parallel route's capacities are per DP shard)."""
    import dataclasses

    from repro_torch.configs import ARCHS, reduced

    cfgs = {a: reduced(ARCHS[a]) for a in ("gemma2-27b", "granite-20b",
                                          "qwen2-72b", "rwkv6-1.6b")}
    jamba = reduced(ARCHS["jamba-1.5-large-398b"])
    cfgs["jamba-dense-ffn"] = dataclasses.replace(
        jamba, moe=None, pattern=tuple(
            dataclasses.replace(s, ffn="dense") if s.ffn == "moe" else s
            for s in jamba.pattern))
    cfgs["jamba-moe"] = with_capacity(jamba, 4.0)
    cfgs["deepseek-moe-16b"] = with_capacity(
        reduced(ARCHS["deepseek-moe-16b"]), 4.0)
    return cfgs


def mesh_families(mesh):
    """Loss and full gradients of each :func:`mesh_family_configs` entry on
    ``mesh`` and with ``mesh=None`` (same seeded parameters and batch)."""
    import torch

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import make_policy
    from repro_torch.models import build_model
    from repro_torch.models import rwkv as trwkv

    out = {}
    norm = trwkv._group_norm
    trwkv._group_norm = _rwkv_group_norm_exact
    try:
        for name, cfg in mesh_family_configs().items():
            for tag, m in (("plain", None), ("mesh", mesh)):
                policy = make_policy(cfg, m, device="cpu")
                model = build_model(cfg, generator=torch.Generator()
                                    .manual_seed(0), device="cpu",
                                    policy=policy)
                data = SyntheticLM(cfg.vocab_size, SHARD_SEQ, SHARD_BATCH,
                                   seed=SHARD_SEED, mesh=m,
                                   batch_axes=("data",) if m else ())
                with policy.scope():
                    loss, _ = model(data.batch(0, "cpu"))
                    grads = torch.autograd.grad(loss, model.leaves())
                out[f"family/{name}/{tag}/loss"] = _full(loss)
                for i, g in enumerate(grads):
                    out[f"family/{name}/{tag}/grad{i}"] = _full(g)
    finally:
        trwkv._group_norm = norm
    return out



UNEVEN_SEQ, UNEVEN_BATCH, UNEVEN_MICRO, UNEVEN_SEED = 16, 8, 2, 5
UNEVEN_STEPS, UNEVEN_DECODE = 2, 4
#: the trace lint's DP steps: (bits, error feedback)
UNEVEN_LINT = ((4, False), (8, False), (4, True))


def uneven_heads_cfg():
    """Reduced minicpm-2b with 3 heads, 3 KV heads and a vocabulary of 511:
    none divides a model axis of 2 (the embedding table's columns go over
    the data axis alone, and its lookup runs on each rank's block)."""
    import dataclasses

    from repro_torch.configs import MINICPM_2B, reduced

    return dataclasses.replace(reduced(MINICPM_2B), num_heads=3,
                               num_kv_heads=3, vocab_size=511)


def uneven_params(cfg):
    import torch

    from repro_torch.models import init_params

    return init_params(cfg, generator=torch.Generator().manual_seed(
        UNEVEN_SEED), device="cpu")


def _uneven_train(cfg, mesh, steps):
    """``make_train_step`` at n_micro 2 on ``mesh`` (or ``mesh=None``):
    the losses and the parameters after ``steps`` steps."""
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import make_policy, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init

    policy = make_policy(cfg, mesh, device="cpu")
    model = build_model(cfg, uneven_params(cfg), policy=policy, device="cpu")
    data = SyntheticLM(cfg.vocab_size, UNEVEN_SEQ, UNEVEN_BATCH,
                       seed=UNEVEN_SEED, mesh=mesh,
                       batch_axes=("data",) if mesh is not None else None)
    grads = policy.param_specs(model.params()) if mesh is not None else None
    step = make_train_step(model, shard_opt(), n_micro=UNEVEN_MICRO,
                           grad_shardings=grads, device="cpu")
    state = {"model": model, "opt": adamw_init(model.params())}
    losses = []
    for s in range(steps):
        state, m = step(state, data.batch(s, "cpu"))
        losses.append(float(m["loss"]))
    return np.asarray(losses), [_full(p) for p in model.leaves()]


def _uneven_heads(cfg, mesh, mode):
    """Loss, gradients and ``UNEVEN_DECODE`` cached decode steps' logits of
    ``cfg`` on ``mesh`` in ``mode`` (or ``mesh=None``)."""
    import torch

    from repro_torch.data import SyntheticLM
    from repro_torch.launch import make_policy
    from repro_torch.models import build_model

    policy = make_policy(cfg, mesh, mode=mode, device="cpu")
    model = build_model(cfg, uneven_params(cfg), policy=policy, device="cpu")
    batch = SyntheticLM(cfg.vocab_size, UNEVEN_SEQ, UNEVEN_BATCH,
                        seed=UNEVEN_SEED).batch(0, "cpu")
    out = {}
    if mode == "train":
        with policy.scope():
            loss, _ = model(batch)
            grads = torch.autograd.grad(loss, model.leaves())
        out["loss"] = np.asarray(float(_full(loss)))
        for i, g in enumerate(grads):
            out[f"grad{i}"] = _full(g)
    cache = model.init_decode(UNEVEN_BATCH, 2 * UNEVEN_DECODE)
    tok = batch["tokens"][:, :1]
    for t in range(UNEVEN_DECODE):
        logits, cache = model.decode_step(cache, tok)
        out[f"logits{t}"] = _full(logits)
        tok = batch["tokens"][:, t + 1:t + 2]
    return out


def _uneven_lint(bits, ef):
    """One traced int4 / int8 DP step on the 2x2 grid over the plain
    transport: the trace lint's violations and the transport launches."""
    import torch

    from repro_torch.analysis import trace_lint as tl
    from repro_torch.configs import MINICPM_2B, reduced
    from repro_torch.core import CommPolicy
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import (init_train_state, make_dp_train_step,
                                    mesh_topology)
    from repro_torch.launch.trace_analysis import analyze_trace, trace_call

    cfg = reduced(MINICPM_2B)
    rank, world = torch.distributed.get_rank(), 4
    policy = CommPolicy(algorithm="nap", mean=True, compress_bits=bits,
                        error_feedback=ef, transport_impl="plain")
    step = make_dp_train_step(cfg, shard_opt(), mesh_topology(2, 2), policy,
                              device="cpu")
    state = init_train_state(cfg, shard_opt(), policy,
                             params=uneven_params(cfg), device="cpu")
    data = SyntheticLM(cfg.vocab_size, UNEVEN_SEQ, UNEVEN_BATCH,
                       seed=UNEVEN_SEED, rank=rank, world=world)
    (state, _), trace = trace_call(step, state, data.batch(0, "cpu"))
    smallest = min(b.elems for b in step.plan.buckets)
    rules = {
        "wire": tl.lint_compressed_wire(trace, bits=bits,
                                        payload_elems=smallest, ppn=2),
        "groups": tl.lint_replica_groups(trace, num_devices=world),
        "counts": tl.lint_collective_counts(trace, {
            "transport": 4 * step.plan.num_buckets}),
        "stable": tl.lint_stable_trace(step, state, data.batch(1, "cpu")),
    }
    launches = analyze_trace(trace).kernel_launches
    tag = f"lint_int{bits}{'_ef' if ef else ''}"
    out = {f"{tag}_{k}": np.asarray([v.message for v in vs], dtype=str)
           for k, vs in rules.items()}
    out[f"{tag}_buckets"] = np.asarray(step.plan.num_buckets)
    out[f"{tag}_launches"] = np.asarray(sum(launches.values()))
    out[f"{tag}_wire_dtypes"] = np.asarray(sorted(
        {d for c in trace.collectives for d in c.dtypes}), dtype=str)
    return out


def run_uneven(rank, world, out_dir):
    from repro_torch.configs import MINICPM_2B, reduced
    from repro_torch.launch import make_mesh

    out = {}
    cfg = reduced(MINICPM_2B)
    losses, params = _uneven_train(cfg, make_mesh((4, 1), ("data", "model")),
                                   UNEVEN_STEPS)
    out["f1_losses"] = losses
    for i, p in enumerate(params):
        out[f"f1_param{i}"] = p
    if rank == 0:
        losses, params = _uneven_train(cfg, None, UNEVEN_STEPS)
        out["f1_losses_none"] = losses
        for i, p in enumerate(params):
            out[f"f1_param_none{i}"] = p
    cfg3 = uneven_heads_cfg()
    mesh = make_mesh((2, 2), ("data", "model"))
    for mode in ("train", "serve2d"):
        for k, v in _uneven_heads(cfg3, mesh, mode).items():
            out[f"f2_{mode}_{k}"] = v
        if rank == 0:
            for k, v in _uneven_heads(cfg3, None, mode).items():
                out[f"f2_{mode}_none_{k}"] = v
    for bits, ef in UNEVEN_LINT:
        out.update(_uneven_lint(bits, ef))
    return out


def run_jax_sharded(out_dir):
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=4 "
        + os.environ.get("XLA_FLAGS", "")
    )
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import repro.kernels.transport as jt
    from repro import compat
    from repro.configs.archs import MINICPM_2B, reduced
    from repro.configs.base import OptimizerConfig
    from repro.core import comm, grad_sync
    from repro.data import SyntheticLM
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import make_policy, make_train_step
    from repro.models import build_model
    from repro.optim import adamw_init

    cfg = reduced(MINICPM_2B)
    mesh = make_mesh(*SHARD_MESH)
    policy = make_policy(cfg, mesh)
    model = build_model(cfg, policy)
    params0 = jax.jit(model.init)(jax.random.PRNGKey(0))
    out = {}
    for i, p in enumerate(jax.tree.leaves(params0)):
        out[f"init{i}"] = np.array(p, copy=True)
    params = policy.shard_params(params0)
    data = SyntheticLM(cfg.vocab_size, SHARD_SEQ, SHARD_BATCH,
                       seed=SHARD_SEED, mesh=mesh, batch_axes=("data",))
    (loss, _), grads = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(
        params, data.batch(0))
    out["loss0"] = np.asarray(loss)
    devs = list(mesh.devices.flat)
    for i, (p, g) in enumerate(zip(jax.tree.leaves(params),
                                   jax.tree.leaves(grads))):
        out[f"grad{i}"] = np.asarray(g)
        by_dev = {s.device: s.data.shape for s in p.addressable_shards}
        out[f"shapes{i}"] = np.asarray([by_dev[d] for d in devs])
    opt = OptimizerConfig(lr=1e-3, schedule="constant", warmup_steps=1)
    shardings = jax.tree.map(lambda s: NamedSharding(mesh, s),
                             policy.param_specs(params0),
                             is_leaf=lambda s: isinstance(s, P))
    step = jax.jit(make_train_step(model, opt, n_micro=SHARD_MICRO,
                                   grad_shardings=shardings))
    state = {"params": params, "opt": adamw_init(params)}
    losses = []
    for s in range(SHARD_STEPS):
        state, m = step(state, data.batch(s))
        losses.append(float(m["loss"]))
    out["losses"] = np.asarray(losses)
    for i, p in enumerate(jax.tree.leaves(state["params"])):
        out[f"param{i}"] = np.asarray(p)

    # sync_grads_local in the test's own shard_map, transport in the jnp
    # reference (the reference's make_grad_sync cannot run a compressed
    # sync on this jax: quantize_pack's pallas_call inside its shard_map)
    smesh = make_mesh(*SYNC_MESH)
    quantize, unpack = jt.quantize_pack, jt.unpack_dequantize
    jt.quantize_pack = functools.partial(quantize, impl="xla")
    jt.unpack_dequantize = functools.partial(unpack, impl="xla")
    gnp = sync_grads_numpy(4)
    try:
        for name, kw in SYNC_POLICIES:
            cfg_s = comm.CommPolicy(**kw)

            def local(g, cfg_s=cfg_s):
                return grad_sync.sync_grads_local(
                    g, cfg=cfg_s, inter_axes=("pod",), intra_axes=("data",))

            spec = {k: P(("pod", "data")) for k in gnp}
            fn = jax.jit(compat.shard_map(local, mesh=smesh, in_specs=(spec,),
                                          out_specs=spec, check_vma=False))
            res = fn({k: jnp.asarray(v) for k, v in gnp.items()})
            for k, v in res.items():
                out[f"sync/{name}/{k}"] = np.asarray(v)
    finally:
        jt.quantize_pack, jt.unpack_dequantize = quantize, unpack
    np.savez(Path(out_dir) / "jax.npz", **out)


# ---------------------------------------------------------------------------
# serving and MoE on a mesh (modes mesh_serve / jax_mesh_serve)
# ---------------------------------------------------------------------------

MS_MESH = ((2, 2), ("data", "model"))
MS_MODES = ("train", "serve2d")
MS_B, MS_P, MS_STEPS, MS_LEN, MS_FRAMES = 4, 6, 6, 16, 12
#: the families decoded on the mesh against mesh=None (jamba's MoE at a
#: capacity factor with no drops, so its prefill matches too)
MS_FAMILIES = ("gemma2-27b", "granite-20b", "jamba-1.5-large-398b",
               "rwkv6-1.6b", "whisper-tiny")
#: MoE cases: (name, mesh shape on ("data", "model"), policy mode)
MOE_MESHES = (("2x2", (2, 2), "train"), ("4x1", (4, 1), "train"),
              ("2x2_serve2d", (2, 2), "serve2d"))
MOE_FACTORS = (1.0, 4.0)
MOE_B, MOE_S = 8, 16
A2A_ROWS = 3


def ms_prompts(vocab: int) -> np.ndarray:
    return np.random.default_rng(5).integers(0, vocab, (MS_B, MS_P))


def ms_frames(d_model: int) -> np.ndarray:
    return np.random.default_rng(6).standard_normal(
        (MS_B, MS_FRAMES, d_model)).astype(np.float32)


def with_capacity(cfg, factor: float):
    import dataclasses

    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))


def moe_inputs(cfg) -> dict:
    """Seeded MoE parameters (the reference's ``init_moe`` tree) and
    inputs for reduced deepseek-moe: ``x`` (B, S, D) and ``proj`` (the
    loss is ``sum(y * proj) + aux``), and a decode step's ``x_dec`` (B, 1,
    D)."""
    m, D = cfg.moe, cfg.d_model
    E, F, Fs = m.num_experts, m.d_expert, m.num_shared_experts * m.d_expert
    rng = np.random.default_rng(21)
    n = lambda *shape, s=1.0: (rng.standard_normal(shape) * s).astype(  # noqa
        np.float32)
    return {
        "params": {
            "w_router": n(D, E, s=D ** -0.5),
            "we_gate": n(E, D, F, s=D ** -0.5),
            "we_up": n(E, D, F, s=D ** -0.5),
            "we_down": n(E, F, D, s=F ** -0.5),
            "shared": {"w_gate": n(D, Fs, s=D ** -0.5),
                       "w_up": n(D, Fs, s=D ** -0.5),
                       "w_down": n(Fs, D, s=Fs ** -0.5)},
        },
        "x": n(MOE_B, MOE_S, D), "proj": n(MOE_B, MOE_S, D),
        "x_dec": n(MOE_B, 1, D),
    }


def a2a_inputs(world: int):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((world, world, A2A_ROWS)).astype(np.float32)
    w = rng.standard_normal((world, world, A2A_ROWS)).astype(np.float32)
    return x, w


def _leaf_paths(tree, prefix=""):
    """``{path: leaf}`` of a nested dict, keys sorted."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_leaf_paths(v, path))
        else:
            out[path] = v
    return out


def _ms_decode(model, prompts, frames=None):
    """Prefill logits, the teacher-forced decode logits of every prompt
    position, then MS_STEPS greedy tokens through ``make_serve_step``; the
    final cache's leaves (whole) and this rank's shard shape of each."""
    import torch

    from repro_torch.launch import make_prefill_step, make_serve_step

    batch = {"tokens": torch.from_numpy(prompts)}
    if frames is not None:
        batch["frames"] = torch.from_numpy(frames)
    out = {"prefill": _full(make_prefill_step(model, device="cpu")(batch))}
    cache = model.init_decode(MS_B, MS_LEN,
                              batch=batch if frames is not None else None)
    logits = []
    for t in range(MS_P):
        lg, cache = model.decode_step(cache, batch["tokens"][:, t:t + 1])
        logits.append(_full(lg))
    out["logits"] = np.stack(logits)
    tok = torch.from_numpy(np.argmax(logits[-1][:, -1], axis=-1)[:, None])
    step = make_serve_step(model, device="cpu")
    toks = [tok]
    for _ in range(MS_STEPS):
        tok, cache = step(cache, tok)
        toks.append(tok)
    out["tokens"] = np.concatenate([t.numpy() for t in toks], axis=1)
    for path, t in _leaf_paths(cache).items():
        out[f"cache/{path}"] = _full(t)
        local = t.to_local() if hasattr(t, "to_local") else t
        out[f"cshape/{path}"] = np.asarray(local.shape)
    return out


def _ms_moe(policy, cfg, inp, *, grads: bool):
    """``moe_apply`` under ``policy`` on the seeded inputs: the loss, ``y``
    and (with ``grads``) the gradients of ``x`` and of every parameter,
    each parameter's gradient laid out as the parameter; without, the
    forward and one decode step's ``y``."""
    import torch

    from repro_torch import tree
    from repro_torch.models import moe as tmoe

    params = tree.tree_map(torch.from_numpy, inp["params"])
    params = policy.shard_params(params)
    leaves = [p.requires_grad_() for p in tree.leaves(params)]
    out = {}
    for name in ("x", "x_dec") if not grads else ("x",):
        x = torch.from_numpy(inp[name])
        if policy.mesh is not None:
            x = policy.constrain(x, (policy.dp, None, None)).detach()
        x.requires_grad_(grads)
        with policy.scope():
            y, aux = tmoe.moe_apply(params, x, cfg=cfg, policy=policy)
            out[f"{name}/y"] = _full(y)
            if name == "x_dec":
                continue
            loss = (y * torch.from_numpy(inp["proj"])).sum() + aux
            out["loss"] = _full(loss)
            if not grads:
                continue
            g = torch.autograd.grad(loss, [x] + leaves)
        out["grad/x"] = _full(g[0])
        for i, (gi, p) in enumerate(zip(g[1:], leaves)):
            if policy.mesh is not None:
                assert tuple(gi.placements) == tuple(p.placements) or (
                    tuple(policy.constrain(gi, ()).placements)), i
            out[f"grad/{i}"] = _full(gi)
    return out


def run_mesh_serve(rank, world, out_dir):
    import torch
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.configs import ARCHS, MINICPM_2B, reduced
    from repro_torch.core.collectives import all_to_all
    from repro_torch.launch import build_training, make_mesh, make_policy
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import build_model, init_params, params_from_jax
    from repro_torch.models import rwkv as trwkv
    from repro_torch.serve import PromptBuckets, ServeEngine

    out_dir = Path(out_dir)
    out = {}
    mesh = make_mesh(*MS_MESH)

    # reduced minicpm from the reference's parameters, both layouts
    cfg = reduced(MINICPM_2B)
    with np.load(out_dir / "params0.npz") as z:
        flat0 = [z[f"leaf{i}"] for i in range(len(z.files))]
    _, td = tree.flatten(init_params(cfg, device="meta"))
    params = params_from_jax(tree.unflatten(td, flat0), cfg, "cpu")
    prompts = ms_prompts(cfg.vocab_size)
    for mode in MS_MODES:
        policy = make_policy(cfg, mesh, mode=mode, device="cpu")
        model = build_model(cfg, params, policy=policy, device="cpu")
        for k, v in _ms_decode(model, prompts).items():
            out[f"minicpm/{mode}/{k}"] = v

    # the other families on the mesh against mesh=None
    norm = trwkv._group_norm
    trwkv._group_norm = _rwkv_group_norm_exact
    try:
        for arch in MS_FAMILIES:
            fcfg = reduced(ARCHS[arch])
            if fcfg.moe is not None:
                fcfg = with_capacity(fcfg, 4.0)
            frames = ms_frames(fcfg.d_model) if fcfg.encoder_layers else None
            for mode in ("plain",) + MS_MODES:
                m = None if mode == "plain" else mesh
                policy = make_policy(fcfg, m, mode=mode if m else "train",
                                     device="cpu")
                model = build_model(fcfg, generator=torch.Generator()
                                    .manual_seed(0), device="cpu",
                                    policy=policy)
                res = _ms_decode(model, ms_prompts(fcfg.vocab_size), frames)
                for k, v in res.items():
                    out[f"family/{arch}/{mode}/{k}"] = v
    finally:
        trwkv._group_norm = norm

    # MoE on the mesh: reduced deepseek-moe
    base = reduced(ARCHS["deepseek-moe-16b"])
    inp = moe_inputs(base)
    for cf in MOE_FACTORS:
        mcfg = with_capacity(base, cf)
        res = _ms_moe(make_policy(mcfg, None), mcfg, inp, grads=True)
        for k, v in res.items():
            out[f"moe/{cf}/plain/{k}"] = v
        for name, shape, mode in MOE_MESHES:
            policy = make_policy(mcfg, make_mesh(shape, MS_MESH[1]),
                                 mode=mode, device="cpu")
            res = _ms_moe(policy, mcfg, inp, grads=mode == "train")
            for k, v in res.items():
                out[f"moe/{cf}/{name}/{k}"] = v
    # build_training on the mesh against mesh=None (no drops)
    mcfg = with_capacity(base, 4.0)
    for tag, m in (("plain", None), ("mesh", mesh)):
        lp = build_training(mcfg, _train_cfg(2), mesh=m,
                            ckpt_dir=out_dir / f"moe_{tag}{rank}",
                            device="cpu")
        lp.run(2)
        out[f"moe_train/{tag}"] = np.asarray(
            [x["loss"] for x in lp.metrics_log])

    # all_to_all with its backward over the world
    xa, wa = a2a_inputs(world)
    x = torch.from_numpy(xa[rank]).requires_grad_()
    y = all_to_all(x, dist.group.WORLD)
    (g,) = torch.autograd.grad((y * torch.from_numpy(wa[rank])).sum(), x)
    out["a2a/y"], out["a2a/grad"] = y.detach().numpy(), g.numpy()

    # serve_batch(mesh=) and ServeEngine(mesh=) on ("pod", "data")
    smodel = build_model(cfg, params, device="cpu")
    pmesh = make_mesh(SERVE_GRIDS[4], ("pod", "data"))

    def engine():
        return ServeEngine(smodel, num_slots=SERVE_SLOTS,
                           max_len=SERVE_MAX_LEN,
                           buckets=PromptBuckets(SERVE_BUCKETS), mesh=pmesh,
                           device="cpu")

    for i, (s_, c) in enumerate(zip(serve_serial(engine()),
                                    serve_streams(engine()))):
        out[f"engine/serial{i}"] = np.asarray(s_)
        out[f"engine/cont{i}"] = np.asarray(c)
    out["serve_batch"] = serve_batch(
        smodel, torch.from_numpy(ms_prompts(cfg.vocab_size)), gen_len=6,
        mesh=pmesh, device="cpu").numpy()
    return out


def run_jax_mesh_serve(out_dir):
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=4 "
        + os.environ.get("XLA_FLAGS", "")
    )
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro import compat
    from repro.configs.archs import DEEPSEEK_MOE_16B, MINICPM_2B, reduced
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_mesh
    from repro.launch.serve import serve_batch
    from repro.models import build_model
    from repro.models import moe as jmoe
    from repro.serve import PromptBuckets, ServeEngine

    out = {}
    cfg = reduced(MINICPM_2B)
    mesh = make_mesh(*MS_MESH)
    params0 = jax.jit(build_model(cfg).init)(jax.random.PRNGKey(0))
    for i, p in enumerate(jax.tree.leaves(params0)):
        out[f"init{i}"] = np.array(p, copy=True)
    prompts = jnp.asarray(ms_prompts(cfg.vocab_size), jnp.int32)
    devs = list(mesh.devices.flat)
    for mode in MS_MODES:
        policy = jsteps.make_policy(cfg, mesh, mode=mode)
        model = build_model(cfg, policy)
        params = policy.shard_params(params0)
        key = f"minicpm/{mode}"
        out[f"{key}/prefill"] = np.asarray(jax.jit(
            jsteps.make_prefill_step(model))(params, {"tokens": prompts}))
        cache = model.init_decode(params, MS_B, MS_LEN)
        sds = jsteps._attach_cache_shardings(
            jax.eval_shape(lambda: cache), policy)
        cache = jax.device_put(cache, jax.tree.map(lambda s: s.sharding,
                                                   sds))
        flat, _ = jax.tree_util.tree_flatten_with_path(cache)
        for path, leaf in flat:
            name = "/".join(str(k.key) for k in path)
            by_dev = {s.device: s.data.shape for s in leaf.addressable_shards}
            out[f"{key}/cshape/{name}"] = np.asarray(
                [by_dev[d] for d in devs])
        dstep = jax.jit(model.decode_step)
        sstep = jax.jit(jsteps.make_serve_step(model))
        logits = []
        for t in range(MS_P):
            lg, cache = dstep(params, cache, prompts[:, t:t + 1])
            logits.append(np.asarray(lg))
        out[f"{key}/logits"] = np.stack(logits)
        tok = jnp.argmax(logits[-1][:, -1], axis=-1)[:, None].astype(
            jnp.int32)
        toks = [np.asarray(tok)]
        for _ in range(MS_STEPS):
            tok, cache = sstep(params, cache, tok)
            toks.append(np.asarray(tok))
        out[f"{key}/tokens"] = np.concatenate(toks, axis=1)
        for path, leaf in flat:
            name = "/".join(str(k.key) for k in path)
            out[f"{key}/cache/{name}"] = np.asarray(
                jax.tree_util.tree_flatten_with_path(cache)[0][
                    [p for p, _ in flat].index(path)][1])

    # MoE under the same policies
    base = reduced(DEEPSEEK_MOE_16B)
    inp = moe_inputs(base)
    for cf in MOE_FACTORS:
        mcfg = with_capacity(base, cf)
        for name, shape, mode in MOE_MESHES:
            mmesh = make_mesh(shape, MS_MESH[1])
            policy = jsteps.make_policy(mcfg, mmesh, mode=mode)
            params = policy.shard_params(jax.tree.map(jnp.asarray,
                                                      inp["params"]))
            put = lambda a: jax.device_put(  # noqa: E731
                jnp.asarray(a), NamedSharding(mmesh, P(policy.dp)))
            proj = jnp.asarray(inp["proj"])

            def loss(p, x, policy=policy, mcfg=mcfg):
                y, aux = jmoe.moe_apply(p, x, cfg=mcfg, policy=policy)
                return jnp.sum(y * proj) + aux, y

            key = f"moe/{cf}/{name}"
            if mode == "train":
                (lv, y), (gp, gx) = jax.jit(jax.value_and_grad(
                    loss, argnums=(0, 1), has_aux=True))(params,
                                                         put(inp["x"]))
                out[f"{key}/grad/x"] = np.asarray(gx)
                for i, g in enumerate(jax.tree.leaves(gp)):
                    out[f"{key}/grad/{i}"] = np.asarray(g)
            else:
                lv, y = jax.jit(loss)(params, put(inp["x"]))
                yd, _ = jax.jit(lambda p, x, policy=policy, mcfg=mcfg:
                                jmoe.moe_apply(p, x, cfg=mcfg,
                                               policy=policy))(
                    params, put(inp["x_dec"]))
                out[f"{key}/x_dec/y"] = np.asarray(yd)
            out[f"{key}/loss"] = np.asarray(lv)
            out[f"{key}/x/y"] = np.asarray(y)

    # lax.all_to_all on 4 devices
    xa, wa = a2a_inputs(4)
    amesh = make_mesh((4,), ("i",))

    def a2a(x):
        return compat.shard_map(
            lambda t: jax.lax.all_to_all(t[0], "i", 0, 0, tiled=False)[None],
            mesh=amesh, in_specs=P("i"), out_specs=P("i"),
            check_vma=False)(x)

    out["a2a/y"] = np.asarray(jax.jit(a2a)(jnp.asarray(xa)))
    out["a2a/grad"] = np.asarray(jax.jit(jax.grad(
        lambda x: jnp.sum(a2a(x) * jnp.asarray(wa))))(jnp.asarray(xa)))

    # the meshed engine and serve_batch on ("pod", "data")
    model = build_model(cfg)
    pmesh = make_mesh(SERVE_GRIDS[4], ("pod", "data"))

    def engine():
        return ServeEngine(model, params0, num_slots=SERVE_SLOTS,
                           max_len=SERVE_MAX_LEN,
                           buckets=PromptBuckets(SERVE_BUCKETS), mesh=pmesh)

    for i, (s_, c) in enumerate(zip(serve_serial(engine()),
                                    serve_streams(engine()))):
        out[f"engine/serial{i}"] = np.asarray(s_)
        out[f"engine/cont{i}"] = np.asarray(c)
    out["serve_batch"] = np.asarray(serve_batch(
        model, params0, prompts, gen_len=6, mesh=pmesh))
    np.savez(Path(out_dir) / "jax.npz", **out)


def spec_entry(entry):
    """A spec entry as JSON: None, an axis name, or a list of names (a
    one-axis tuple written as the name)."""
    if isinstance(entry, tuple):
        return entry[0] if len(entry) == 1 else list(entry)
    return entry


def run_jax_specs(out_dir):
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=512 "
        + os.environ.get("XLA_FLAGS", "")
    )
    import json

    import jax

    from repro.launch import steps
    from repro.launch.dryrun import cells
    from repro.launch.mesh import make_production_mesh

    def leaf(x):
        return {"shape": list(x.shape), "dtype": str(x.dtype),
                "spec": [spec_entry(e) for e in x.sharding.spec]}

    def paths(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                         for k in path): leaf(x) for path, x in flat}

    out = {}
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        for arch, shape in cells():
            batch = steps.input_specs(arch, shape, mesh)
            _, _, state, _ = steps.state_specs(arch, shape, mesh)
            cell = {"batch": {k: leaf(v) for k, v in batch.items()},
                    "params": [leaf(x) for x in
                               jax.tree.leaves(state["params"])]}
            if "opt" in state:
                cell["mu"] = [leaf(x) for x in jax.tree.leaves(
                    state["opt"].mu)]
                cell["nu"] = [leaf(x) for x in jax.tree.leaves(
                    state["opt"].nu)]
            if "cache" in state:
                cell["cache"] = paths(state["cache"])
            out[f"{arch}/{shape}/{int(multi_pod)}"] = cell
            if steps.SHAPES[shape].kind == "train":
                continue
            batch = steps.input_specs(arch, shape, mesh, serve2d=True)
            _, _, state, _ = steps.state_specs(arch, shape, mesh,
                                               serve2d=True)
            cell = {"batch": {k: leaf(v) for k, v in batch.items()},
                    "params": [leaf(x) for x in
                               jax.tree.leaves(state["params"])]}
            if "cache" in state:
                cell["cache"] = paths(state["cache"])
            out[f"{arch}/{shape}/{int(multi_pod)}/serve2d"] = cell
    (Path(out_dir) / "jax_specs.json").write_text(json.dumps(out))


def spawn_world(mode: str, out_dir: Path, timeout: float = 300.0,
                world: int = WORLD):
    """Run ``mode`` on a gloo world of ``world`` ranks; returns each
    rank's results."""
    store = out_dir / "store"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), mode, str(r),
             str(world), str(store), str(out_dir)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for r in range(world)
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
    for r in range(world):
        with np.load(out_dir / f"rank{r}.npz") as z:
            out.append({k: z[k] for k in z.files})
    return out


def main():
    mode = sys.argv[1]
    if mode.startswith("jax_"):
        {"jax_train": run_jax_train, "jax_rs_ag": run_jax_rs_ag,
         "jax_serve": run_jax_serve, "jax_sharded": run_jax_sharded,
         "jax_specs": run_jax_specs,
         "jax_mesh_serve": run_jax_mesh_serve}[mode](sys.argv[2])
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
        elif mode == "rs_ag":
            out = run_rs_ag(rank, world)
        elif mode == "baselines":
            out = run_baselines(rank, world)
        elif mode == "serve":
            out = run_serve(rank, world, out_dir)
        elif mode == "serve_whisper":
            out = run_serve_whisper(rank, world, out_dir)
        elif mode == "dp_checks":
            out = run_dp_checks(rank, world, out_dir)
        elif mode == "sharded":
            out = run_sharded(rank, world, out_dir)
        elif mode == "mesh_serve":
            out = run_mesh_serve(rank, world, out_dir)
        elif mode == "uneven":
            out = run_uneven(rank, world, out_dir)
        else:
            raise SystemExit(f"unknown mode {mode!r}")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)


if __name__ == "__main__":
    main()
