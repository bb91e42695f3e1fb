"""The op-trace analyzer (``repro_torch.launch.trace_analysis``) and the
roofline's ring model, against known-cost programs and the reference.

Mirrors ``tests/test_hlo_analysis.py`` (a matmul, loops of products, a
batched einsum, traffic that scales with iterations, collectives inside a
loop), and adds: per-chip counting under DTensor on a fake 16 x 16 world
(the local matmul only, not DTensor's shape inference on global shapes),
the ring model per kind against the reference's
``roofline.collective_bytes`` on synthesized HLO, a reduced-minicpm train
step counted alike on CPU tensors and on ``meta``, the JSON round trip,
and kernel regions (the transport's kernel route and plain route count
the same declared work).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from _torch_fakes import fake_kernel_route
from repro.launch import roofline as j_roofline
from repro_torch import trace_regions
from repro_torch.configs import MINICPM_2B, OptimizerConfig, reduced
from repro_torch.data import SyntheticLM
from repro_torch.kernels import _build, transport
from repro_torch.launch import make_train_step, roofline
from repro_torch.launch.trace_analysis import (COLLECTIVE_KINDS,
                                               CollectiveOp, Trace,
                                               analyze_trace, trace_call,
                                               wire_bytes)
from repro_torch.models import Model, build_model, init_params
from repro_torch.optim import adamw_init

SRC = str(Path(__file__).resolve().parents[1] / "src")


def _stats(fn, *args):
    return analyze_trace(trace_call(fn, *args)[1])


def test_plain_matmul_flops():
    st = _stats(lambda x, w: x @ w, torch.ones(64, 128), torch.ones(128, 32))
    assert st.flops == 2 * 64 * 128 * 32
    assert st.dots == 1
    assert st.flops_by_dtype == {"float32": 2 * 64 * 128 * 32}
    # x, w read, the product written
    assert st.memory_bytes == 4 * (64 * 128 + 128 * 32 + 64 * 32)


def test_loop_of_products_counts_every_iteration():
    def f(c):
        for _ in range(17):
            c = c @ c
        return c

    assert _stats(f, torch.ones(64, 64)).flops == 17 * 2 * 64 ** 3


def test_nested_loops_multiply():
    def f(c):
        for _ in range(5):
            for _ in range(3):
                c = c @ c
        return c

    assert _stats(f, torch.ones(32, 32)).flops == 15 * 2 * 32 ** 3


def test_einsum_batched_flops():
    st = _stats(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                torch.ones(4, 16, 32), torch.ones(4, 32, 8))
    assert st.flops == 2 * 4 * 16 * 32 * 8


def test_memory_traffic_scales_with_iterations():
    n = 1 << 16

    def f(c):
        for _ in range(10):
            c = c + 1.0
        return c

    st = _stats(f, torch.ones(n))
    # each iteration reads and writes the carry
    assert st.memory_bytes == 10 * 2 * 4 * n


def test_views_and_allocations_move_no_bytes():
    x = torch.ones(8, 16)
    st = _stats(lambda: (x.view(16, 8).t().unsqueeze(0)[:, :4],
                         torch.empty(100)))
    assert st.memory_bytes == 0 and st.flops == 0


def test_training_step_backward_is_counted():
    lin = torch.nn.Linear(128, 32)
    x = torch.ones(3, 64, 128)
    st = _stats(lambda: lin(x).sum().backward())
    # forward product and the weight's gradient (x needs none)
    assert st.flops == 2 * (2 * 3 * 64 * 128 * 32)


@pytest.fixture(scope="module")
def fake_world():
    """Per-chip counts on a fake 16 x 16 world (rank 0 of 256), in a
    subprocess: the fake default group must not outlive it."""
    script = textwrap.dedent(
        """
        import json
        import torch
        from torch.distributed.tensor import (Replicate, Shard,
                                              distribute_tensor)
        from repro_torch.launch.dryrun import fake_world
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.launch.trace_analysis import (analyze_trace,
                                                       trace_call)

        fake_world(256)
        dm = make_production_mesh().device_mesh("cpu")
        a = distribute_tensor(torch.empty(1024, 1024, device="meta"), dm,
                              [Shard(0), Replicate()], src_data_rank=None)
        b = distribute_tensor(torch.empty(1024, 4096, device="meta"), dm,
                              [Replicate(), Shard(1)], src_data_rank=None)

        def matmul():
            c = a @ b  # (Shard(0), Shard(1)): no communication
            return c.redistribute(dm, [Shard(0), Replicate()])

        _, tr = trace_call(matmul)
        st = analyze_trace(tr)
        model = dm.get_group("model")

        def loop(x):
            for _ in range(6):
                torch.distributed.all_reduce(x, group=model)
            return x

        _, tr2 = trace_call(loop, torch.ones(1024))
        st2 = analyze_trace(tr2)
        print(json.dumps({
            "flops": st.flops, "dots": st.dots,
            "ag": st.collectives["all-gather"],
            "ag_groups": [list(c.group) for c in tr.collectives],
            "ag_partition": [len(c.replica_groups) for c in tr.collectives],
            "ar": st2.collectives["all-reduce"],
            "ar_bytes": st2.collective_bytes,
            "ar_ops": [c.op for c in tr2.collectives],
        }))
        """
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_per_chip_matmul_on_the_fake_16x16_world(fake_world):
    # rank 0's block: (64, 1024) x (1024, 256); DTensor's propagation of
    # the global (1024, 1024) x (1024, 4096) product is not counted
    assert fake_world["flops"] == 2 * 64 * 1024 * 256 == 33_554_432
    assert fake_world["dots"] == 1
    # the gather over "model" (16): result (64, 4096) float32, ring model
    size = 64 * 4096 * 4
    assert fake_world["ag"] == {"bytes": size * 15 / 16, "count": 1.0}
    assert fake_world["ag_groups"] == [list(range(16))]
    assert fake_world["ag_partition"] == [16]  # the 16 rows of the mesh


def test_collectives_inside_a_loop_multiply(fake_world):
    # six in-place all-reduces of 4 KiB over 16 ranks
    assert fake_world["ar_ops"] == ["c10d.allreduce_"] * 6
    assert fake_world["ar"]["count"] == 6
    assert fake_world["ar_bytes"] == 6 * 2 * 4096 * 15 / 16


_HLO_OPS = {"all-reduce": "all-reduce", "all-gather": "all-gather",
            "reduce-scatter": "reduce-scatter", "all-to-all": "all-to-all",
            "collective-permute": "collective-permute"}


@pytest.mark.parametrize("g", [2, 4, 16])
@pytest.mark.parametrize("kind", COLLECTIVE_KINDS)
def test_ring_model_equals_reference(kind, g):
    """One synthesized HLO line per kind through the reference's
    ``collective_bytes``, one trace record through the port's."""
    line = (f"  %c = f32[1024,3]{{1,0}} {_HLO_OPS[kind]}(f32[1024,3]{{1,0}} "
            f"%p), replica_groups=[{256 // g},{g}]<=[256]")
    want = j_roofline.collective_bytes(line)[kind]
    op = CollectiveOp(kind=kind, op="synthetic", index=0, dtypes=("float32",),
                      shapes=((1024, 3),), elems=3072, bytes=3072 * 4.0,
                      group_size=g, group=tuple(range(g)), replica_groups=(),
                      region="")
    got = roofline.collective_bytes([op])[kind]
    assert want["count"] == got["count"] == 1
    assert got["bytes"] == want["bytes"]
    assert wire_bytes(kind, 3072 * 4.0, g) == want["bytes"]


def _minicpm_step(device):
    cfg = reduced(MINICPM_2B)
    gen = None if device == "meta" else torch.Generator().manual_seed(0)
    params = init_params(cfg, generator=gen, device=device)
    model = Model(cfg, params)
    opt = OptimizerConfig(lr=1e-3, schedule="constant", warmup_steps=1)
    step = make_train_step(model, opt, n_micro=2, device=device)
    batch = SyntheticLM(cfg.vocab_size, 32, 4, seed=0).batch(0, "cpu")
    if device == "meta":
        batch = {k: torch.empty_like(v, device="meta")
                 for k, v in batch.items()}
    state = {"model": model, "opt": adamw_init(model.params())}
    _, trace = trace_call(step, state, batch)
    return trace


def test_train_step_counts_alike_on_cpu_and_meta():
    cpu, meta = _minicpm_step("cpu"), _minicpm_step("meta")
    assert cpu.ops == meta.ops
    a, b = analyze_trace(cpu), analyze_trace(meta)
    assert a == b
    assert a.flops > 0 and a.attn_memory_bytes > 0 and a.attn_io_bytes > 0
    # the region's kernel-target bytes replace the score block's traffic
    assert a.memory_bytes_kernel < a.memory_bytes


def test_trace_round_trips_through_json(tmp_path):
    trace = _minicpm_step("meta")
    trace.save(tmp_path / "t.trace.json.gz")
    back = Trace.load(tmp_path / "t.trace.json.gz")
    assert analyze_trace(back) == analyze_trace(trace)
    assert back.peak_bytes == trace.peak_bytes > 0


def test_region_is_a_shared_no_op_without_a_tracer():
    assert not trace_regions.ACTIVE
    r = trace_regions.kernel_region("x", lambda: 1 / 0)
    assert r is trace_regions.kernel_region("y")
    with r as region:
        region.output(torch.ones(1))


def _transport_pair(impl):
    x = torch.randn(3, 1000, generator=torch.Generator().manual_seed(1))
    scales = torch.full((2,), 0.01)
    kw = dict(offsets=(0, 500), bits=4)

    def run():
        w = transport.quantize_pack(x, scales, impl=impl, **kw)
        return transport.unpack_dequantize(w, scales, cols=1000, impl=impl,
                                           **kw)

    return trace_call(run)[1]


def test_transport_plain_route_counts_its_declared_bytes_only():
    st = analyze_trace(_transport_pair("plain"))
    wire = 3 * 1024 // 2  # 1000 columns padded to the 256 block, packed
    declared = (3 * (4 * 1000) + wire) + (wire + 4 * 3 * 1000)
    assert st.memory_bytes == declared
    assert st.flops == 0
    assert st.kernel_launches == {"transport.quantize_pack": 1,
                                  "transport.unpack_dequantize": 1}


def test_transport_kernel_route_counts_the_same_work(monkeypatch):
    plain = analyze_trace(_transport_pair("plain"))
    fake_kernel_route(monkeypatch, _build, transport)
    kernel = analyze_trace(_transport_pair("auto"))
    assert transport.LAUNCHES  # the recorder took the C calls
    assert (kernel.memory_bytes, kernel.flops, kernel.kernel_launches) == (
        plain.memory_bytes, plain.flops, plain.kernel_launches)


def test_model_regions_on_a_tiny_rwkv_and_mamba():
    from repro_torch.configs import ARCHS

    for name in ("rwkv6-1.6b", "jamba-1.5-large-398b"):
        cfg = reduced(ARCHS[name])
        model = build_model(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
        batch = SyntheticLM(cfg.vocab_size, 8, 2, seed=0).batch(0, "cpu")
        (loss, _), trace = trace_call(model, batch)
        st = analyze_trace(trace)
        assert 0 < st.timescan_io_bytes < st.timescan_memory_bytes, name
        kinds = {e["kind"] for e in trace.events}
        assert "timescan" in kinds, name
