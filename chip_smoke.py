#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases (each prints one JSON line; any failure raises and exits non-zero):

1. ``device``: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions.
2. ``build``: compile ``src/repro_torch/kernels/csrc/transport.cu`` with
   ``nvcc`` for ``sm_90a`` (seconds, registers per thread).
3. ``kernels``: both transport kernels against their plain versions on the
   card, bit for bit, over bits / leaf counts / bases / row strides /
   ragged widths and the slice's largest bucket; then their times at the
   main path's bucket shapes (CUDA events, median of 25 after warm-up)
   beside the bytes bound and the plain versions' times.
4. ``train``: minicpm-2b at its published widths (depth cut to 4 layers),
   bf16, world size 1, global batch 8 x 512 from ``SyntheticLM``: 5 steps
   of ``CommPolicy(nap, mean, compress_bits=4, error_feedback=True)``,
   then 3 steps at ``compress_bits=8``.  Launch counters are zeroed just
   before each run and read just after; each kernel must have launched
   exactly (buckets in the plan x steps) times.
5. ``profile``: one more int4+EF step under ``torch.profiler``: device
   busy time by kernel class (transport / matmul / other) and the idle
   share; the full table goes to ``chiprun_out/profile_step.txt``.
6. ``train_vs_plain``: 2 steps of the same int4+EF step with the transport
   routed to the plain versions; parameters and losses must be bitwise
   equal to the kernel run's first 2 steps.
7. ``reference_small``: the reduced config in float32, 2 steps on the card
   (kernels) against the same steps on the CPU (plain versions); losses
   must agree to rtol 1e-4 (cuBLAS and the CPU sum in other orders).

Then a line ``{"kernels": [...]}``, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Needs one CUDA card; exits non-zero
without one, or without the repository's ``src/`` beside this file.
"""

from __future__ import annotations

import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "transport.cu"
if not KERNEL_SRC.is_file():
    sys.exit("chip_smoke.py: src/repro_torch not found beside this script")
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: CUDA is not available")

from repro_torch.configs import (  # noqa: E402
    MINICPM_2B, MINICPM_2B_4L, OptimizerConfig, reduced,
)
from repro_torch.core import CommPolicy  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import transport  # noqa: E402
from repro_torch.launch import (  # noqa: E402
    init_train_state, make_dp_train_step, mesh_topology,
)

# Peak device-memory rate per card (NVIDIA data sheets), bytes/s, and the
# float32 rate outside the tensor cores, op/s.
CARDS = {
    "H100 80GB HBM3": (3.35e12, 67e12),   # H100 SXM
    "H100 PCIe": (2.0e12, 51e12),
    "H200": (4.8e12, 67e12),
}
SEED = 0
BATCH, SEQ = 8, 512


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_rates(name: str) -> tuple[float, float]:
    for key, rates in CARDS.items():
        if key in name:
            return rates
    raise RuntimeError(f"no peak rates on file for card {name!r}")


def median_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = transport.build_library()
    seconds = time.perf_counter() - t0
    log = lib.with_suffix(".log").read_text()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    emit({"phase": "build", "seconds": seconds, "library": lib.name,
          "registers_per_thread": regs})


def _case_offsets(gen, L, span):
    if L == 1:
        return (0,)
    cuts = torch.randperm(span - 1, generator=gen)[: L - 1] + 1
    return (0,) + tuple(sorted(int(c) for c in cuts))


def _check_case(gen, *, bits, L, base, R, row_stride, cols, x=None):
    """Quantize and dequantize through kernel and plain version; returns
    the max abs difference (0.0 when bit-identical), raising otherwise."""
    dev = "cuda"
    span = base + (R - 1) * row_stride + cols + 1
    offsets = _case_offsets(gen, L, span)
    if x is None:
        x = torch.randn((R, cols), generator=gen) * (
            torch.rand((R, cols), generator=gen) * 8
        )
        x = x.to(dev)
    qmax = 2 ** (bits - 1) - 1
    # scales at and below the data's absmax/qmax: rounding and clipping
    jitter = 0.25 + torch.rand(L, generator=gen).to(dev)
    scales = x.abs().max() / qmax * jitter
    kw = dict(offsets=offsets, bits=bits, base=base, row_stride=row_stride)
    wk = transport.quantize_pack(x, scales, **kw)
    wp = transport.quantize_pack(x, scales, impl="plain", **kw)
    dk = transport.unpack_dequantize(wk, scales, cols=cols, **kw)
    dp = transport.unpack_dequantize(wk, scales, cols=cols, impl="plain", **kw)
    # every wire byte value, not just those quantize writes
    wr = torch.randint(0, 256, tuple(wk.shape), generator=gen,
                       dtype=torch.uint8).to(dev).view(wk.dtype)
    rk = transport.unpack_dequantize(wr, scales, cols=cols, **kw)
    rp = transport.unpack_dequantize(wr, scales, cols=cols, impl="plain", **kw)
    torch.cuda.synchronize()
    ok = torch.equal(wk, wp) and torch.equal(dk, dp) and torch.equal(rk, rp)
    err = max(
        (wk.to(torch.int32) - wp.to(torch.int32)).abs().max().item(),
        (dk - dp).abs().max().item(), (rk - rp).abs().max().item(),
    )
    if not ok:
        raise AssertionError(
            f"kernel != plain at bits={bits} L={L} base={base} R={R} "
            f"row_stride={row_stride} cols={cols}: max |diff| {err}"
        )
    return err


def phase_kernels(bucket_sizes, rates) -> dict:
    """``bucket_sizes``: the leaf sizes of each bucket of the main path's
    plan, in fusion order."""
    gen = torch.Generator().manual_seed(SEED)
    n_cases, max_err = 0, 0.0
    for bits in (2, 3, 4, 8):
        for L in (1, 3, 40):
            for base in (0, 1237):
                for R, rs in ((1, 0), (4, 0), (4, 3001)):
                    max_err = max(max_err, _check_case(
                        gen, bits=bits, L=L, base=base, R=R, row_stride=rs,
                        cols=3001,
                    ))
                    n_cases += 1
    big = max(sum(b) for b in bucket_sizes)
    xb = torch.randn((1, big), generator=torch.Generator(device="cuda")
                     .manual_seed(SEED), device="cuda")
    for bits in (4, 8):
        max_err = max(max_err, _check_case(
            gen, bits=bits, L=1, base=0, R=1, row_stride=0, cols=big, x=xb,
        ))
        n_cases += 1
    del xb
    emit({"phase": "kernels", "cases": n_cases, "bit_identical": True,
          "tolerance": "bit-identical (torch.equal)",
          "max_abs_err": max_err, "largest_bucket": [1, big]})

    bw, flops = rates
    timing = {}
    for bits in (4, 8):
        wi = transport.wire_itemsize(bits)
        rows, n_shapes = [], 0
        for sizes in bucket_sizes:
            E = sum(sizes)
            offsets = tuple(sum(sizes[:i]) for i in range(len(sizes)))
            x = torch.randn((1, E), device="cuda")
            s = torch.stack([
                x[0, o:o + n].abs().max() for o, n in zip(offsets, sizes)
            ]) / (2 ** (bits - 1) - 1)
            kw = dict(offsets=offsets, bits=bits)
            # the main path's exact shapes and leaf offsets, bit for bit
            w = transport.quantize_pack(x, s, **kw)
            if not (
                torch.equal(w, transport.quantize_pack(
                    x, s, impl="plain", **kw))
                and torch.equal(
                    transport.unpack_dequantize(w, s, cols=E, **kw),
                    transport.unpack_dequantize(
                        w, s, cols=E, impl="plain", **kw))
            ):
                raise AssertionError(
                    f"kernel != plain at the main path's bucket {sizes}, "
                    f"bits={bits}"
                )
            n_shapes += 1
            q_ms = median_ms(lambda: transport.quantize_pack(x, s, **kw))
            qp_ms = median_ms(
                lambda: transport.quantize_pack(x, s, impl="plain", **kw))
            d_ms = median_ms(
                lambda: transport.unpack_dequantize(w, s, cols=E, **kw))
            dp_ms = median_ms(lambda: transport.unpack_dequantize(
                w, s, cols=E, impl="plain", **kw))
            nbytes = E * (4 + wi)
            # quantize: divide, round, 2 clamps, pack; dequantize: unpack,
            # sign-extend, convert, multiply (per element)
            ops = E * 5
            bound = max(nbytes / bw, ops / flops) * 1e3
            rows.append({"elems": E, "leaves": len(sizes),
                         "quantize_ms": q_ms,
                         "quantize_plain_ms": qp_ms, "dequantize_ms": d_ms,
                         "dequantize_plain_ms": dp_ms, "bound_ms": bound,
                         "bound_by": "bytes" if nbytes / bw >= ops / flops
                         else "operations"})
            del x, w
        tot = lambda k: sum(r[k] for r in rows)
        timing[bits] = {
            "quantize_pack": (tot("quantize_ms"), tot("quantize_plain_ms")),
            "unpack_dequantize": (tot("dequantize_ms"),
                                  tot("dequantize_plain_ms")),
            "bound_ms": tot("bound_ms"),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in rows) else "operations",
        }
        emit({"phase": "kernel_times", "bits": bits,
              "bit_identical_at_bucket_shapes": n_shapes,
              "per_bucket": rows,
              "per_step_ms": {k: v for k, v in timing[bits].items()},
              "library_ms": None,
              "library_ms_reason": "no single PyTorch call computes a "
              "per-leaf-scaled quantize-and-pack (or its inverse)"})
    torch.cuda.empty_cache()
    return {"max_abs_err": max_err, "timing": timing}


OPT = OptimizerConfig(lr=1e-4, schedule="constant", warmup_steps=1)


def _run(cfg, policy, steps, *, device, data, snapshot_after=None):
    topo = mesh_topology(1, 1)
    step = make_dp_train_step(cfg, OPT, topo, policy, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    state = init_train_state(cfg, OPT, policy, generator=gen, device=device)
    losses, times, snap = [], [], None
    for s in range(steps):
        batch = data.batch(s, device)
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        if device != "cpu":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        if snapshot_after is not None and s + 1 == snapshot_after:
            snap = [p.detach().clone() for p in state["model"].leaves()]
    return step.plan, state, losses, times, snap


def phase_train() -> dict:
    cfg = MINICPM_2B_4L
    data = SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=SEED)
    runs, snap, first_losses = [], None, None
    launches = {k: 0 for k in transport.LAUNCHES}
    for bits, ef, steps in ((4, True, 5), (8, False, 3)):
        policy = CommPolicy(algorithm="nap", mean=True, compress_bits=bits,
                            error_feedback=ef)
        # measure this run alone: nothing of an earlier phase stays alive
        gc.collect()
        torch.cuda.empty_cache()
        start_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        transport.reset_launch_counts()
        plan, state, losses, times, s = _run(
            cfg, policy, steps, device="cuda", data=data,
            snapshot_after=2 if bits == 4 else None,
        )
        counts = dict(transport.LAUNCHES)
        if bits == 4:
            snap, first_losses = s, losses[:2]
        if not all(math.isfinite(l) for l in losses):
            raise AssertionError(f"non-finite loss at bits={bits}: {losses}")
        want = plan.num_buckets * steps
        if any(c != want for c in counts.values()):
            raise AssertionError(
                f"launches {counts} != {plan.num_buckets} buckets x {steps} "
                "steps"
            )
        for k, c in counts.items():
            launches[k] += c
        steady = times[1:]
        ms = statistics.median(steady) * 1e3
        runs.append({
            "bits": bits, "error_feedback": ef, "steps": steps,
            "losses": losses, "step_ms": [t * 1e3 for t in times],
            "ms_per_step": ms, "tokens_per_s": BATCH * SEQ / (ms / 1e3),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "memory_allocated_at_start": start_bytes,
            "launches": counts,
            "plan": [{"leaves": list(b.leaves), "elems": b.elems,
                      "dtype": b.dtype, "algorithm": b.algorithm}
                     for b in plan.buckets],
        })
        del state
        torch.cuda.empty_cache()
    emit({"phase": "train", "config": cfg.name, "params": cfg.param_count(),
          "batch": [BATCH, SEQ], "runs": runs})
    return {"launches": launches, "snap": snap, "losses": first_losses}


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def phase_profile() -> None:
    """One int4+EF step of the main path under ``torch.profiler`` (after 2
    warm-up steps): device busy time by kernel class and the idle share.
    The full table goes to ``chiprun_out/profile_step.txt``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = MINICPM_2B_4L
    data = SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=SEED)
    policy = CommPolicy(algorithm="nap", mean=True, compress_bits=4,
                        error_feedback=True)
    step = make_dp_train_step(cfg, OPT, mesh_topology(1, 1), policy,
                              device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    state = init_train_state(cfg, OPT, policy, generator=gen, device="cuda")
    for s in range(2):
        state, _ = step(state, data.batch(s, "cuda"))
    batch = data.batch(2, "cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # device kernels only: an operator's own row repeats its kernels' time
    rows = sorted(
        ((e.key, _device_us(e) / 1e3, e.count) for e in events
         if e.device_type == DeviceType.CUDA and _device_us(e) > 0),
        key=lambda r: -r[1],
    )
    classes = {"transport": 0.0, "matmul": 0.0, "other": 0.0}
    for name, ms, _ in rows:
        low = name.lower()
        if "quantize_pack_kernel" in low or "unpack_dequantize_kernel" in low:
            classes["transport"] += ms
        elif any(k in low for k in ("gemm", "cutlass", "xmma", "cublas")):
            classes["matmul"] += ms
        else:
            classes["other"] += ms
    busy = sum(classes.values())
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_step.txt").write_text(
        events.table(sort_by="self_cuda_time_total", row_limit=60)
    )
    emit({"phase": "profile", "wall_ms": wall_ms, "device_busy_ms": busy,
          "idle_share": (1 - busy / wall_ms) if busy else None,
          "busy_ms_by_class": classes,
          "top_kernels": [[n[:80], ms, c] for n, ms, c in rows[:12]]})
    del state
    torch.cuda.empty_cache()


def phase_train_vs_plain(kernel_run) -> None:
    cfg = MINICPM_2B_4L
    data = SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=SEED)
    policy = CommPolicy(algorithm="nap", mean=True, compress_bits=4,
                        error_feedback=True, transport_impl="plain")
    before = dict(transport.LAUNCHES)
    _, state, losses, _, _ = _run(cfg, policy, 2, device="cuda", data=data)
    if transport.LAUNCHES != before:
        raise AssertionError("the plain route launched a kernel")
    params_equal = all(
        torch.equal(a, b)
        for a, b in zip(state["model"].leaves(), kernel_run["snap"])
    )
    losses_equal = losses == kernel_run["losses"]
    emit({"phase": "train_vs_plain", "steps": 2, "losses_plain": losses,
          "losses_kernel": kernel_run["losses"],
          "params_bitwise_equal": params_equal,
          "losses_bitwise_equal": losses_equal})
    if not (params_equal and losses_equal):
        raise AssertionError("kernel route and plain route differ")
    del state
    torch.cuda.empty_cache()


def phase_reference_small() -> None:
    cfg = reduced(MINICPM_2B)
    data = SyntheticLM(cfg.vocab_size, 64, 8, seed=SEED)
    policy = CommPolicy(algorithm="nap", mean=True, compress_bits=4,
                        error_feedback=True)
    topo = mesh_topology(1, 1)
    losses = {}
    params0 = None
    for dev in ("cpu", "cuda"):
        step = make_dp_train_step(cfg, OPT, topo, policy, device=dev)
        state = init_train_state(
            cfg, OPT, policy, device=dev,
            params=params0,
            generator=None if params0 is not None
            else torch.Generator(device="cpu").manual_seed(SEED),
        )
        if params0 is None:
            params0 = _detached(state["model"].params())
        ls = []
        for s in range(2):
            state, m = step(state, data.batch(s, dev))
            ls.append(float(m["loss"]))
        losses[dev] = ls
    close = all(
        math.isclose(a, b, rel_tol=1e-4)
        for a, b in zip(losses["cpu"], losses["cuda"])
    )
    emit({"phase": "reference_small", "config": cfg.name,
          "losses_cpu_plain": losses["cpu"],
          "losses_cuda_kernels": losses["cuda"], "rtol": 1e-4,
          "close": close})
    if not close:
        raise AssertionError("card and CPU disagree on the reduced config")


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach().clone()


def main() -> None:
    # full float32 matmuls everywhere (the plain reference's precision)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    rates = card_rates(torch.cuda.get_device_name(0))
    phase_build()
    # the main path's bucket shapes, from the plan the train step makes
    from repro_torch.core import Topology, grad_sync
    from repro_torch.models import init_params
    plan = grad_sync.plan_for_tree(
        init_params(MINICPM_2B_4L, device="meta"),
        cfg=CommPolicy(algorithm="nap", compress_bits=4),
        topology=Topology.of(1, 1),
    )
    leaf_elems = [e for e, _ in plan.signature]
    k = phase_kernels(
        [[leaf_elems[i] for i in b.leaves] for b in plan.buckets], rates
    )
    run = phase_train()
    phase_profile()
    phase_train_vs_plain(run)
    phase_reference_small()
    t4 = k["timing"][4]
    replaces = {"quantize_pack": "src/repro/kernels/transport.py:158",
                "unpack_dequantize": "src/repro/kernels/transport.py:222"}
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/transport.cu",
         "replaces": replaces[name],
         "launches": run["launches"][name],
         "max_abs_err": k["max_abs_err"],
         "ms": t4[name][0], "plain_ms": t4[name][1],
         "bound_ms": t4["bound_ms"], "bound_by": t4["bound_by"],
         "library_ms": None}
        for name in ("quantize_pack", "unpack_dequantize")
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
