"""Error feedback adds no transport launch (ROADMAP Queue 3, F3).

One compressed bucket of the allreduce route is four transport calls:
quantize the stripe, unpack the received copies, requantize the fold,
unpack the gathered blocks.  Error feedback's two decodes of this rank's
own wire bytes run the plain version outside the kernel's region, as the
reference pins them to ``impl="xla"``
(``src/repro/core/grad_sync.py:379-386``).

* the port, on a 2x2 gloo world (``repro_torch.examples._world.launch``)
  at int4 with error feedback: 2 + 2 ``transport.*`` kernel regions a
  bucket in the op trace (``launch/trace_analysis``), which the trace
  lint reads and the card's ``transport.LAUNCHES`` follows;
* the reference: 4 ``pallas_call`` sites in the same bucket's jaxpr,
  under a ``shard_map`` on 4 virtual devices with ``check_vma=False``
  (as ``tests/test_transport_kernels.py`` counts them), in a subprocess;
* the synced values and the new residuals are bitwise those of the old
  route, whose decodes went through the wrapper's plain route (and whose
  trace had 2 + 4 regions a bucket).
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.examples import _world

ROOT = Path(__file__).resolve().parents[1]
SIZES = (64, 96, 128)  # the reference test's leaves, one fused bucket
GRID = (2, 2)


class _OldRoute:
    """``grad_sync.ref`` as the error-feedback decodes saw it before the
    repair: through ``transport.unpack_dequantize`` (its plain route on
    the CPU), inside the kernel's region."""

    @staticmethod
    def unpack_dequantize_ref(wire, scales, *, offsets, bits, base,
                              row_stride):
        from repro_torch.kernels import transport

        block = transport.DEFAULT_BLOCK
        wblock = block // 2 if bits == 4 else block
        return transport.unpack_dequantize(
            wire, scales, offsets=offsets, bits=bits,
            cols=wire.shape[1] // wblock * block, base=base,
            row_stride=row_stride, impl="plain")


def _sync(ctx, plan, grads, ef):
    from repro_torch.launch.trace_analysis import analyze_trace, trace_call

    (synced, new_ef), trace = trace_call(ctx.sync_grads, grads, plan=plan,
                                         ef_state=ef)
    regions = analyze_trace(trace).kernel_launches
    return ([t.numpy() for t in synced], [t.numpy() for t in new_ef],
            {k.removeprefix("transport."): v for k, v in regions.items()})


def ef_bucket_rank(rank, topology, device):
    """One int4+EF sync of three float32 leaves with non-zero residuals,
    traced, then the same on the old route."""
    from repro_torch.core import CommContext, CommPolicy, grad_sync

    policy = CommPolicy(algorithm="nap", mean=True, compress_bits=4,
                        error_feedback=True)
    ctx = CommContext(topology, policy)
    rng = np.random.default_rng([7, rank])
    grads = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for s in SIZES]
    ef = [torch.from_numpy((rng.standard_normal(s) * 1e-2).astype(
        np.float32)) for s in SIZES]
    plan = grad_sync.plan_for_tree(grads, cfg=policy, topology=topology)
    out = {"buckets": plan.num_buckets,
           "new": _sync(ctx, plan, grads, ef)}
    saved = grad_sync.ref
    grad_sync.ref = _OldRoute
    try:
        out["old"] = _sync(ctx, plan, grads, ef)
    finally:
        grad_sync.ref = saved
    return out


@pytest.fixture(scope="module")
def reference_pallas_calls():
    """The reference's ``pallas_call`` sites in the same bucket at int4
    with error feedback, on a 2x2 ``("pod", "data")`` mesh; started
    first, read after the port's world."""
    script = f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import jax, jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        from repro import compat
        from repro.core import comm, grad_sync
        from repro.launch.mesh import make_mesh

        mesh = make_mesh({GRID}, ("pod", "data"))
        policy = comm.CommPolicy(algorithm="nap", mean=True,
                                 compress_bits=4, error_feedback=True)
        shapes = [(s,) for s in {SIZES}]

        def f(*leaves):
            topo = comm.Topology.from_mesh(mesh)
            ctx = comm.CommContext(topo, policy)
            plan = grad_sync.plan_for_tree(
                [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes],
                cfg=policy, topology=topo)
            synced, new_ef = grad_sync.sync_with_context(
                list(leaves[:3]), ctx, plan=plan, ef_state=list(leaves[3:]))
            return jnp.concatenate(synced), jnp.concatenate(new_ef)

        args = [jnp.zeros(s, jnp.float32) for s in shapes * 2]
        g = compat.shard_map(f, mesh=mesh, in_specs=tuple(P() for _ in args),
                             out_specs=(P(), P()), check_vma=False)
        print("PALLAS_CALLS", str(jax.make_jaxpr(g)(*args)).count(
            "pallas_call"))
    """
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(script)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def read():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-2000:]
        line = next(v for v in out.splitlines()
                    if v.startswith("PALLAS_CALLS"))
        return int(line.split()[1])

    yield read
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def world(reference_pallas_calls):
    return _world.launch(ef_bucket_rank, device="cpu", grid=GRID,
                         timeout=300)


def test_ef_bucket_is_four_transport_regions_as_the_reference(
        world, reference_pallas_calls):
    for r, out in enumerate(world):
        per = out["buckets"]
        assert per == 1
        assert out["new"][2] == {"quantize_pack": 2 * per,
                                 "unpack_dequantize": 2 * per}, r
        # the old route: two more unpacks a bucket
        assert out["old"][2] == {"quantize_pack": 2 * per,
                                 "unpack_dequantize": 4 * per}, r
    assert reference_pallas_calls() == 4 == sum(world[0]["new"][2].values())


def test_ef_values_and_residuals_unchanged_bitwise(world):
    for out in world:
        for new, old in zip(out["new"][:2], out["old"][:2]):
            for a, b in zip(new, old):
                np.testing.assert_array_equal(a, b)
        # error feedback did something: each rank keeps the error of its
        # own stripe and block, so its residuals are not all zero
        assert np.abs(np.concatenate(out["new"][1])).max() > 0
    # every rank holds the same synced values
    for out in world[1:]:
        for a, b in zip(out["new"][0], world[0]["new"][0]):
            np.testing.assert_array_equal(a, b)
