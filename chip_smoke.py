#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases (each prints one JSON line; any failure raises and exits non-zero):

1. ``device``: the card (``nvidia-smi`` name and power limit, maximum SM
   clock), torch and CUDA versions.
2. ``build``: compile the five sources under
   ``src/repro_torch/kernels/csrc/`` with ``nvcc`` for ``sm_90a``, one
   compiler per source, all at once (seconds); per kernel instance its
   registers, spill bytes, static and dynamic shared memory (flash
   attention's and the rwkv6 scan's at its chunk length) and the count
   of tensor-core, exponential and float32 instructions in its SASS
   (``cuobjdump``; for the Mamba scan, float32 instructions per
   ``MUFU.EX2``), and ptxas's wgmma warnings.  Fails if a flash attention
   instance, bf16 (``tc::flash_attention_tc``) or float32
   (``tc32::flash_attention_tf32x3``), has no ``HGMMA`` (wgmma)
   instruction.
3. ``kernels``: both transport kernels against their plain versions on the
   card, bit for bit, over every width 2..8 / leaf counts / bases / row
   strides / ragged widths, inputs one float into their buffer (the
   wrapper's aligned copy), 40 leaves of a few elements each (boundaries
   inside one thread's run) and the slice's largest bucket; then their
   times at the
   main path's bucket shapes (device time per call: CUDA events around 10
   back-to-back calls, median of 5, after warm-up; and the latency of one
   call on an idle card, host time included, median of 25) beside the
   bytes bound and the plain versions' times.  AdamW's two kernels
   (``kernels.adamw``, the port's own) at the benchmark's configuration,
   deepseek-moe-16b at its published widths, 2 layers and the untied head
   (16 leaves, 1,595,156,480 parameters; gradients scaled so that the clip
   acts): ``adamw_apply`` bit for bit ``optim.adamw._update_leaves`` given
   the same clip scale (int views), ``sq_norm`` the same bits twice and its
   norm within 1e-6 (relative) of a float64 one; then both kernels' times
   (as above) beside their bytes bound (2 B and 22 B a parameter) and the
   plain ``global_norm`` / ``_update_leaves`` times.
4. ``train``: minicpm-2b at its published widths (depth cut to 4 layers),
   bf16, world size 1, global batch 8 x 512 from ``SyntheticLM``: 5 steps
   of ``CommPolicy(nap, mean, compress_bits=4, error_feedback=True)``,
   then 3 steps at ``compress_bits=8``.  Launch counters are zeroed just
   before each run and read just after; each transport kernel must have
   launched exactly (buckets in the plan x steps) times, AdamW's
   ``sq_norm`` once a step and ``adamw_apply`` once a leaf a step (as in
   every phase that trains on the card, with ``mesh=None``).
5. ``profile``: one more int4+EF step under ``torch.profiler``: device
   busy time by kernel class (transport / matmul / other) and the idle
   share; the full table goes to ``chiprun_out/profile_step.txt``.
6. ``train_vs_plain``: 2 steps of the same int4+EF step with the transport
   routed to the plain versions (AdamW on its kernels on both sides, held
   against its plain version in phase ``kernels``); parameters and losses
   must be bitwise equal to the kernel run's first 2 steps.
7. ``reference_small``: the reduced config in float32, 2 steps on the card
   (kernels) against the same steps on the CPU (plain versions); losses
   must agree to rtol 1e-4 (cuBLAS and the CPU sum in other orders).
8. ``ops_kernels``: the three kernels of ``repro_torch.kernels.ops``
   (flash attention, the RWKV6 scan, the Mamba scan) against their plain
   versions on the card, over the CPU tests' matrix (masks, GQA, ragged S
   and d, head widths, state sizes, float32 and bf16) and up to S = 2048,
   in the working type, at 2e-5 (float32) / 2e-2 (bf16); the RWKV6 scan
   also at S = chunk - 1, chunk, chunk + 1 and 2 chunk + 1 of its staged
   chunk, every head width, B*H below and above the 132 SMs, and a bonus
   u shared by the batch or one per batch row; the Mamba scan also with a
   general A (random negative, as the CPU tests draw it) and at d = block
   +- 1, S = chunk +- 1 and 2 chunk + 1 of its channel block and staged
   chunk, batch 3, every N; attention in both types also over cases
   ragged against the tensor-core kernels' 128-row query and 64- (32-)key
   tiles (S 1000 / 2047 / 65, windows 33 / 100 / 1000, GQA 4:1 and 8:1,
   softcap, every head width), each bf16 output row held to a relative L2
   error of 2^-7 beside the elementwise check; attention with keys longer
   and shorter than the queries (Sk != S), in both types: causal and not,
   windows, the softcap, GQA, S and Sk ragged against the tiles, and
   windows that leave query rows with no valid key (those rows must be 0,
   as in the plain version); the RWKV6 scan with a bf16 bonus ``u`` and
   the Mamba scan with a bf16 ``A`` (cast to float32 by the wrappers).
9. ``ops_full_width``: the second slice's main path, ``kernels.ops`` at the
   widths of the models the repository supports (constants below, each
   with its line in ``src/repro/configs/``): launch counters zeroed, each
   case launched once, counters read; then each case held against its
   plain version (flash attention head by head) and timed (kernel and
   ``scaled_dot_product_attention``, where it computes the same function:
   device time per call over 10 back-to-back calls, median of 5, and the
   latency of one call; plain version: one call, median of 3), beside its
   bound.  bf16 attention is held at rtol 2e-2 with an absolute
   term of one bf16 step (2^-7) of each row's largest |plain| value, and
   each row to a relative L2 error of 2^-7 (a dropped 64-key tile at row
   32k reads about 0.04); gemma2's cases are timed again with the softcap
   off, as a measure of its share.  The Mamba scan's bound is the larger
   of its bytes and its exponentials (one ``MUFU.EX2`` per state entry and
   step) over 16 a clock per SM at the maximum SM clock.  Then the float32
   path (phase ``ops_full_width_f32_control``): gemma2's two layers and
   minicpm's shape once more in float32 (the 3xTF32 kernel), counters
   zeroed before and read after, held at 2e-5 and timed beside a bound of
   3 x operations over the TF32 rate (and over the SIMT rate, for
   continuity), minicpm also beside ``scaled_dot_product_attention`` in
   float32 with TF32 off.
10. ``rs_transport``: the two transport kernels in the exact calls the
   compressed sharded sync's reduce-scatter half makes
   (``grad_sync._compressed_reduce_scatter``), as the last rank of a 2x4
   and of a 4x2 grid sees them, at minicpm-2b's largest leaf (the
   122,753 x 2304 embedding), int8 and int4: quantize-pack of the (n, B)
   stripe with ``row_stride=B`` and ``base = lane * S``, unpack-dequantize
   of the n received rows with ``row_stride=0``, ``cols=B`` and the
   block's base.  Wire bytes and outputs bit-identical to the plain
   versions; device time per call (as phase ``kernels``) beside the bytes
   bound and the plain versions' times.
11. ``collectives_world1``: minicpm-2b-4l's gradient tree from one
   backward on the card; ``CommContext.sync_grads_sharded`` then
   ``grad_sync.unshard_grads`` (plain and int4) must give back every leaf bit for
   bit, on the card (timed); each of the twelve registered engines and
   the three NAP extensions, called at world size 1 on a CUDA tensor,
   must return its input bit for bit on the card; the reduce-scatter /
   allgather dispatch decisions over a few grids and sizes are printed.
12. ``serve``: the serving spine at minicpm-2b's published widths, its
   depth cut to 8 of 40 layers (bf16, seed 0): a ``ServeEngine`` of 8 slots x 512
   positions, prompt buckets 32 / 64 / 128 / 256, 12 requests from a seeded
   generator (prompts of 16..256 tokens, 32..128 new tokens), 8 submitted
   at the start and 4 after two engine steps.  Launch counters are zeroed
   just before this run and read just after: no kernel of the repository
   runs on this path (neither package's decode calls one).  Hard checks:
   every request's tokens equal, bitwise, those of a serial run through a
   fresh engine of the same shape; a request whose EOS is a token of its
   own greedy stream stops there; a ``Router`` over two engines sharing
   the model, with the 4 shortest-prompt requests, loses replica 0 after
   two steps and every request still ends with its serial tokens.  Also:
   the reduced config's decode on the card against the CPU (rows at
   unequal indices, 1e-4); decode ms per step (median), decode tokens/s,
   prefill ms per prompt token, peak memory; one decode step of 8 active
   slots under ``torch.profiler`` (device busy, GEMM / other, idle share,
   host syncs, kernel launches; the table goes to
   ``chiprun_out/profile_decode_step.txt``) beside its bytes bound; the
   decode collectives' dispatch at 2x4 and 4x8 (planning only).

13. ``families``: the other decoder-only families at their published
   widths (``repro_torch.configs.CHIP_FAMILIES``: gemma2-27b, qwen2-72b,
   granite-20b and deepseek-moe-16b at 2 layers, jamba-1.5-large at one
   super-layer with 4 of its 16 experts, rwkv6-1.6b and qwen2-vl-2b whole),
   seeded parameters, each freed before the next.  Per config: bf16
   serving through a ``ServeEngine`` of 8 slots x 256 positions, 6 seeded
   requests (prompts 8..48, 8..32 new tokens, 4 at the start and 2 after
   two steps), bitwise equal to a serial run through a fresh engine, no
   kernel launched (decode ms per step, tokens/s, prefill ms per prompt
   token, peak memory); float32 (TF32 off) teacher-forced decode against
   the full forward at B 2, S 32, rtol = atol 2e-3 (jamba with 2 experts;
   MoE capacity factor E / k so the full forward drops no token; for
   deepseek the top-k sets of both paths position by position, a
   difference allowed only where the k-th / (k+1)-th gate margin is
   below 1e-6); gemma2 also over 4,352 tokens (window + 256), its last
   256 positions compared.  Then 2 int4+EF steps of the train step at
   batch 2 x 512 on gemma2-27b-2l, deepseek-moe-16b-2l and rwkv6-1.6b-4l
   (finite losses, transport launches = buckets x steps; deepseek's
   kernel route bitwise equal to its plain route).

14. ``trainer``: the training driver, ``launch.train.build_training``, on
   minicpm-2b at its published widths and all 40 layers (bf16, remat
   "full", the reference's default): global batch 8 x 512 in microbatches
   of 2 (``make_train_step`` at n_micro 4, float32 accumulation), 6 steps
   (ms per step: median after the first; tokens/s; peak memory), one more
   step under ``torch.profiler`` (device busy, GEMM share, idle share,
   launches; the table goes to ``chiprun_out/profile_trainer_step.txt``);
   remat none / dots / full and bf16_bwd on / off at 2 steps each (the
   second step's ms, peak memory, the first losses equal within 2e-2);
   then the resume check at 4 layers (MINICPM_2B_4L) under
   ``torch.use_deterministic_algorithms`` (``CUBLAS_WORKSPACE_CONFIG`` set
   before CUDA starts): 6 steps straight through against 4 steps with a
   checkpoint after step 3 (keep 1) and a fresh loop on the same
   directory run to 6; losses, parameters and moments bitwise equal; the
   checkpoint's bytes and write seconds; a temporary directory, removed.
   Launch counters zeroed before each run and read after: of the
   repository's kernels only AdamW's run on this path.
15. ``dp_ef``: the reference's ``check_dp_training_ef_convergence`` at
   1 x 1 on the card: reduced minicpm-2b in float32 from the port's
   seeded parameters (drawn on the CPU), ``SyntheticLM(seq 32, batch 16,
   seed 3)``, AdamW at constant lr 1e-2, 120 steps each of uncompressed,
   int4 + EF and raw int4 ``nap`` sync through ``make_dp_train_step``;
   the transport on the CUDA kernels (launches = buckets x steps per
   compressed run, counters zeroed before and read after each run) and
   the reference's five criteria held (they hold on the CPU at 1 x 1,
   ``tests/test_torch_dp_checks.py``).
16. ``whisper``: the encoder-decoder, whisper-tiny whole (4 encoder and 4
   decoder layers, d 384, bf16, seeded parameters), with whisper's
   published encoder context of 1500 frames and text context of 448.
   Serving through a ``ServeEngine`` of 8 slots x 448 with
   ``extras_template`` frames (1, 1500, 384): the 6 requests of
   ``family_traffic``, each with its own seeded frames, 4 at the start and
   2 after two steps, bitwise equal to a serial run through a fresh
   engine, no kernel launched (counters zeroed just before, read just
   after); a ``Router`` over two such engines loses replica 0 after two
   steps and every request ends with its serial tokens; decode ms per
   step (median, min), decode tokens/s, prefill ms per prompt token, the
   encoder's ms per request, peak memory.  float32 (TF32 off)
   teacher-forced decode against the full forward at B 2, S 32, 1500
   frames, rtol = atol 2e-3.  Training at batch 8 x 448 with 1500 frames
   a row: 2 int4+EF ``make_dp_train_step`` steps at world size 1 (finite
   losses; each transport kernel launched buckets x steps times, counters
   zeroed before and read after), then 2 steps of ``make_train_step`` at
   n_micro 2: ms per step, peak memory.
17. ``mesh``: the FSDP x TP layout on DTensor, at world size 1 (one card
   holds one rank): ``torch.distributed`` on NCCL in this process
   (``tcp://localhost``, a free port), destroyed at the phase's end.
   ``launch.train.build_training`` on minicpm-2b-4l (bf16, published
   widths) at 8 x 512 in microbatches of 2, 2 steps, on a (1, 1)
   ``("data", "model")`` mesh and with ``mesh=None`` from the same seed:
   losses and every parameter bitwise equal (``mesh=None`` on AdamW's
   kernels; the mesh's DTensor leaves on its plain update, their norm from
   the ``sq_norm`` kernel over the local shards, whose sum runs in another
   order than ``torch.sum``); each route's second-step ms,
   peak memory and one more step under the profiler (launches, device
   busy, idle share; tables ``chiprun_out/profile_mesh_<route>_step.txt``).
   Then ``core.grad_sync.make_grad_sync`` on a (1, 1) ``("pod", "data")``
   mesh over one step's gradient tree as DTensors, ``CommPolicy(nap, mean,
   compress_bits=4)`` and ``8``: launch counters zeroed before each sync
   and read after, each transport kernel launched once per compressed
   bucket of the plan; the result bitwise equal to the same sync on the
   plain transport and to ``sync_with_context`` on the local tensors.

18. ``mesh_serve``: serving and MoE on the (1, 1) mesh at world size 1
   (``phase_mesh_serve``): minicpm-2b-8l prefill, decode and greedy tokens
   bitwise equal across ``mesh=None``, the train layout and ``serve2d``;
   deepseek-moe-16b-2l training (AdamW as in ``mesh``) and ``serve2d``
   decode bitwise equal to ``mesh=None``, and its expert-parallel route at
   one rank.
19. ``dryrun``: the dry run and the op counter (``phase_dryrun``): three
   cells of ``repro_torch.launch.dryrun`` (whisper-tiny train_4k on 16 x
   16, minicpm-2b decode_32k in ``serve2d``, deepseek-moe-16b train_4k on
   2 x 16 x 16), each traced on ``meta`` in its own process and fake world
   on the card's torch (each record ``ok``; roofline terms printed);
   minicpm-2b-4l's train step (8 x 512, microbatches of 2) counted on the
   card and on ``meta`` (equal counts; the counted loss bitwise equal to
   an uncounted step's), its roofline with the H100's constants beside
   its measured ms and device-busy ms; phase ``train``'s int4+EF DP step
   counted on the kernel and plain routes (equal; a launch of each
   transport kernel per compressed bucket at one rank; the wire lint
   clean).
20. ``analysis``: the proof chain of ``repro_torch.analysis``
   (``phase_analysis``): ``python -m repro_torch.analysis`` (the schedule
   sweep and the trace wire lint on a fake 2 x 4 world) and ``--spmd``
   (the SPMD lint of every engine, the compressed sync, the DP step and
   the serve paths, every rank traced) in processes of their own, both
   clean; the protocol sweep's first three scopes at their state floors;
   minicpm-2b-4l's gradient tree synced at world size 1 on the card
   (int8, int4, int4 + EF) under the SPMD lint, on the kernel route and
   the plain route: the same clean report, two transport regions with
   named operands a bucket, the kernels launched once a bucket on the
   kernel route.  The seconds of each part are on the phase's line.
21. ``examples``: the drivers of ``repro_torch.examples``, each as its own
   process (``python -m repro_torch.examples.<name>``, through its
   launcher: one rank on the card over NCCL at 1x1) with ``--report``
   files under ``chiprun_out/``: ``quickstart`` (every engine returns the
   input, no permutation round), ``nap_gradient_sync`` (psum bitwise equal
   to nap: at one rank both are the identity;
   ms a step of each, the median of steps 2-5), ``train_lm`` in its main
   mode at its defaults (LM_100M at its widths, float32, 200 steps of 8 x
   256, a crash at 120 and a resume: the resume step, first and last loss,
   ms a step as the median after each loop's first, tokens/s, peak
   memory), ``train_lm --compressed-smoke`` (8 steps each of int8 and
   int4 + EF on ``reduced(LM_100M)``: each transport kernel launched once
   a bucket a step, AdamW's as in ``train``, counted in the example's
   process from zero; then the same on the plain transport, no transport
   launch, losses bitwise equal), and
   ``serve_decode`` (seconds per arch).  Each process's seconds are on
   the phase's line.

Then a line ``{"kernels": [...]}`` (AdamW's two kernels beside the
ported ones: times from phase ``kernels``, launches from every phase
that trains), the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Needs one CUDA card; exits non-zero
without one, or without the repository's ``src/`` beside this file.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import json
import math
import re
import shutil
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
KERNEL_SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "transport.cu"
if not KERNEL_SRC.is_file():
    sys.exit("chip_smoke.py: src/repro_torch not found beside this script")
sys.path.insert(0, str(ROOT / "src"))
# cuBLAS's deterministic workspace, for phase trainer's resume check under
# torch.use_deterministic_algorithms; set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: CUDA is not available")

from repro_torch.configs import (  # noqa: E402
    CHIP_FAMILIES, MINICPM_2B, MINICPM_2B_4L, MINICPM_2B_8L,
    OptimizerConfig, RWKV6_1_6B_4L, reduced,
)
from repro_torch.core import CommPolicy  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import _build, ops, transport  # noqa: E402
from repro_torch.kernels import adamw as kadamw  # noqa: E402

trw = importlib.import_module("repro_torch.kernels.rwkv6_scan")
tms = importlib.import_module("repro_torch.kernels.mamba_scan")
from repro_torch.launch import (  # noqa: E402
    init_train_state, make_dp_train_step, mesh_topology,
)

# Peak device-memory rate per card (NVIDIA data sheets), bytes/s, the
# float32 rate outside the tensor cores and the dense bf16 and TF32
# tensor-core rates, op/s.
class Rates(NamedTuple):
    bw: float
    f32: float
    bf16: float
    tf32: float


CARDS = {
    "H100 80GB HBM3": Rates(3.35e12, 67e12, 989e12, 495e12),   # H100 SXM
    "H100 PCIe": Rates(2.0e12, 51e12, 756e12, 378e12),
    "H200": Rates(4.8e12, 67e12, 989e12, 495e12),
}
# MUFU.EX2 per clock per SM (the special-function unit's rate on Hopper)
EX2_PER_CLOCK = 16
KERNEL_SOURCES = ("transport", "flash_attention", "rwkv6_scan", "mamba_scan",
                  "adamw")

# Widths of the second slice's main path, from the JAX package's configs
# (src/repro/configs/archs.py and, for the shapes, base.py:217-220).
# gemma2-27b (archs.py:21-39): 32 heads (:26), 16 KV heads (:27), head width
# 128 (:28), sliding window 4096 (:32), attention-logit softcap 50 (:33);
# prefill_32k (base.py:219): S = 32768, batch 32, cut to 1 for run time.
GEMMA2 = dict(B=1, S=32768, H=32, KV=16, hd=128, window=4096, softcap=50.0)
# minicpm-2b (archs.py:42-53): 36 heads (:47), 36 KV heads (:48), d_model
# 2304 (:46) -> head width 64; the port's train-step batch 8 x 512.
MINICPM = dict(B=8, S=512, H=36, KV=36, hd=64)
# rwkv6-1.6b (archs.py:175-187): 32 heads (:180) of 64 (:185); train_4k
# (base.py:218): S = 4096, batch 256, cut to 8.  float32, as rwkv_full
# passes r/k/v/w (src/repro/models/rwkv.py:96).
RWKV6 = dict(B=8, S=4096, H=32, hd=64)
# jamba-1.5-large (archs.py:89-110): d_model 8192 (:93), mamba expand 2 and
# d_state 16 (:108) -> d_inner 16384, N 16; S = 4096, batch 256 cut to 1.
JAMBA = dict(B=1, S=4096, d=2 * 8192, N=16)
SEED = 0
BATCH, SEQ = 8, 512


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_rates(name: str) -> Rates:
    for key, rates in CARDS.items():
        if key in name:
            return rates
    raise RuntimeError(f"no peak rates on file for card {name!r}")


def median_ms(fn, reps: int = 5, warmup: int = 3, launches: int = 10) -> float:
    """Device time per call: the median over ``reps`` of CUDA events around
    ``launches`` back-to-back calls, over ``launches``, after ``warmup``
    calls.  The host prepares the next call while the card runs this one,
    so a call's host time shows only where it exceeds its device time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def call_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """One call between CUDA events on an idle card, median of ``reps``:
    the call's latency, its host time (the wrapper, the launch) included,
    the way the port's earlier kernel times were taken."""
    torch.cuda.synchronize()
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


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def phase_device() -> tuple[str, float]:
    """The ``nvidia-smi`` name and power limit line, and the card's
    maximum SM clock in Hz."""
    smi = _smi("name,power.limit")
    clock = _smi("clocks.max.sm")
    emit({"phase": "device", "nvidia_smi": smi, "clocks_max_sm": clock,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "sms": torch.cuda.get_device_properties(0).multi_processor_count})
    return smi, float(clock.split()[0]) * 1e6


def _kernel_name(mangled: str) -> str:
    """``flash_attention_kernel<float, 128>`` from a mangled name (through
    ``c++filt`` where the machine has it)."""
    if shutil.which("c++filt") is None:
        return mangled
    name = subprocess.run(["c++filt", mangled], capture_output=True,
                          text=True).stdout.strip()
    name = re.sub(r"\(anonymous namespace\)::", "", name)
    return name.split("(")[0].replace("void ", "") or mangled


SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "MUFU.EX2", "FFMA", "FMUL", "FADD")


def _sass_counts(lib: Path) -> dict[str, dict[str, int]]:
    """Tensor-core, TMA, exponential and float32 instructions per kernel in
    a library's SASS."""
    cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name, _, code = body.partition("\n")
        counts[name.strip()] = {
            op: len(re.findall(rf"\b{re.escape(op)}\b", code))
            for op in SASS_OPS}
    return counts


def phase_build() -> dict:
    t0 = time.perf_counter()
    libs = _build.build(*(_build.source(n) for n in KERNEL_SOURCES))
    seconds = time.perf_counter() - t0
    fa_lib = importlib.import_module("repro_torch.kernels.flash_attention")._lib()
    rw_lib = trw._lib()
    kernels, warnings = {}, {}
    for src, lib in libs.items():
        log = lib.with_suffix(".log").read_text()
        sass = _sass_counts(lib)
        kernels[src.name] = {}
        for fn, spill, regs, used in re.findall(
            r"Compiling entry function '([^']+)'.*?"
            r"(\d+) bytes spill stores.*?Used (\d+) registers([^\n]*)",
            log, re.S,
        ):
            name = _kernel_name(fn)
            smem = re.search(r"(\d+) bytes smem", used)
            row = {"registers": int(regs), "spill_store_bytes": int(spill),
                   "static_smem_bytes": int(smem.group(1)) if smem else 0,
                   **sass.get(fn, {})}
            rwkv = re.search(r"rwkv6_scan_kernel<(float|__nv_bfloat16), "
                             r"(\d+)>", name)
            if rwkv:
                row["dynamic_smem_bytes"] = rw_lib.repro_rwkv6_scan_smem(
                    int(rwkv.group(2)), int(rwkv.group(1) != "float"))
                row["chunk"] = trw.CHUNK
            flash = re.search(r"flash_attention_(tc|tf32x3)<(\d+)>", name)
            if flash:
                row["dynamic_smem_bytes"] = fa_lib.repro_flash_attention_smem(
                    int(flash.group(2)), int(flash.group(1) == "tc"))
                if not row.get("HGMMA"):
                    raise AssertionError(f"{name}: no wgmma (HGMMA) in SASS")
            if "mamba_scan_kernel" in name and row.get("MUFU.EX2"):
                # one MUFU.EX2 per state entry and step: the float32
                # instructions beside each, over the whole function
                row["fp32_per_ex2"] = sum(
                    row[op] for op in ("FFMA", "FMUL", "FADD")
                ) / row["MUFU.EX2"]
            kernels[src.name][name] = row
        warnings[src.name] = [line.strip() for line in log.splitlines()
                              if "wgmma" in line.lower()]
    emit({"phase": "build", "seconds": seconds, "parallel": True,
          "libraries": [lib.name for lib in libs.values()],
          "kernels": kernels, "ptxas_wgmma_warnings": warnings})
    return kernels


def _case_offsets(gen, L, span, short_from=None):
    """L leaf starts over [0, span); ``short_from``: the L - 1 cuts fall in
    the 4 L indices after it, so that leaves of a few elements, and several
    leaf boundaries, lie inside one thread's run (and one float4)."""
    if L == 1:
        return (0,)
    if short_from is not None:
        cuts = torch.randperm(4 * L, generator=gen)[: L - 1] + short_from + 1
    else:
        cuts = torch.randperm(span - 1, generator=gen)[: L - 1] + 1
    return (0,) + tuple(sorted(int(c) for c in cuts))


def _check_case(gen, *, bits, L, base, R, row_stride, cols, x=None,
                short=False, misaligned=False):
    """Quantize and dequantize through kernel and plain version; returns
    the max abs difference (0.0 when bit-identical), raising otherwise.
    ``short``: leaf boundaries packed just after ``base`` (the first warp's
    runs); ``misaligned``: x is a view one float into its buffer, so the
    wrapper must hand the kernel an aligned copy."""
    dev = "cuda"
    span = base + (R - 1) * row_stride + cols + 1
    offsets = _case_offsets(gen, L, span, short_from=base if short else None)
    if x is None:
        x = torch.randn((R * cols + 1,), generator=gen) * (
            torch.rand((R * cols + 1,), generator=gen) * 8
        )
        x = x.to(dev)
        x = (x[1:] if misaligned else x[:-1]).view(R, cols)
        assert (x.data_ptr() % 16 != 0) == misaligned
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


# AdamW's kernels at the benchmark's configuration (perfbench's
# deepseek-moe-16b-2l: published widths, two layers, the untied head;
# 1,595,156,480 parameters in 16 leaves) and its optimizer's constants
ADAMW_CFG = dataclasses.replace(CHIP_FAMILIES["deepseek-moe-16b-2l"],
                                tie_embeddings=False)
ADAMW_HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _adamw_kernels(rates) -> tuple[dict, dict]:
    """AdamW's two kernels at ADAMW_CFG's leaves (parameters and gradients
    in the model's dtypes, moments float32, the gradients' norm about 40
    so that the clip acts), on the update of AdamW's first step:
    ``adamw_apply`` bit for bit ``optim.adamw._update_leaves`` given the
    same clip scale, ``sq_norm`` the same bits twice and its norm within
    1e-6 (relative) of a float64 one.  Then each kernel's time, its bytes
    bound (the norm reads 2 B a parameter; the update reads g and reads and
    writes p, m and v, 22 B) and its plain version's time (``global_norm``,
    ``_update_leaves``).  Returns (the check, the times)."""
    from repro_torch import tree
    from repro_torch.models import init_params
    from repro_torch.optim import adamw as optim_adamw

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shapes = [(tuple(t.shape), t.dtype) for t in
              tree.leaves(init_params(ADAMW_CFG, device="meta"))]
    rand = lambda s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    p = [(rand(s) * 0.02).to(dt) for s, dt in shapes]
    g = [(rand(s) * 1e-3).to(dt) for s, dt in shapes]
    m = [rand(s) * 1e-4 for s, _ in shapes]
    v = [torch.rand(s, generator=gen, device=dev) * 1e-6 for s, _ in shapes]
    kadamw.reset_launch_counts()
    sq = kadamw.sq_norm(g)
    deterministic = torch.equal(_bits(sq), _bits(kadamw.sq_norm(g)))
    sq64 = sum(float(t.double().square().sum()) for t in g)
    plain_norm = float(optim_adamw.global_norm(g))
    norm = torch.sqrt(sq)
    f32 = lambda x: torch.full((), x, dtype=torch.float32,  # noqa: E731
                               device=dev)
    # adamw_update's scalars at step 1, grad_clip 1.0, lr 3e-4
    sc = dict(scale=torch.minimum(f32(1.0), f32(1.0) / torch.maximum(
        norm, f32(1e-12))), c1=1.0 - torch.pow(f32(0.9), f32(1)),
        c2=1.0 - torch.pow(f32(0.95), f32(1)), lr_t=f32(3e-4), **ADAMW_HYPER)
    pp, pm, pv = ([t.clone() for t in ts] for ts in (p, m, v))
    optim_adamw._update_leaves(g, optim_adamw.AdamWState(0, pm, pv), pp,
                               **sc)
    kadamw.adamw_apply(g, m, v, p, **sc)
    torch.cuda.synchronize()
    unequal = [f"{what}[{i}]" for what, xs, ys in
               (("p", p, pp), ("m", m, pm), ("v", v, pv))
               for i, (a, b) in enumerate(zip(xs, ys))
               if not torch.equal(_bits(a), _bits(b))]
    del pp, pm, pv
    torch.cuda.empty_cache()
    n = sum(t.numel() for t in p)
    check = {
        "config": ADAMW_CFG.name, "tie_embeddings": False, "leaves": len(p),
        "parameters": n, "launches": dict(kadamw.LAUNCHES),
        "adamw_apply_bitwise_equal_plain": not unequal,
        "unequal_leaves": unequal, "sq_norm_deterministic": deterministic,
        "norm": float(norm), "norm_plain": plain_norm,
        "norm_float64": math.sqrt(sq64),
        "norm_rel_gap_float64": abs(float(norm) - math.sqrt(sq64))
        / math.sqrt(sq64),
        "sq_norm_rel_gap_float64": abs(float(sq) - sq64) / sq64,
        "norm_plain_rel_gap_float64": abs(plain_norm - math.sqrt(sq64))
        / math.sqrt(sq64),
        "tolerance": "adamw_apply bit-identical (int views); the norm "
        "within 1e-6 of float64's"}
    if (unequal or not deterministic or check["launches"] != {
            "sq_norm": 2, "adamw_apply": len(p)}
            or check["norm_rel_gap_float64"] > 1e-6):
        raise AssertionError(f"AdamW kernels: {check}")
    nbytes = lambda ts: sum(t.numel() * t.element_size()  # noqa: E731
                            for t in ts)
    g_bytes = nbytes(g)
    apply_bytes = g_bytes + 2 * (nbytes(p) + nbytes(m) + nbytes(v))
    state = optim_adamw.AdamWState(0, m, v)
    times = {
        "sq_norm": {
            "ms": median_ms(lambda: kadamw.sq_norm(g)),
            "plain_ms": median_ms(lambda: optim_adamw.global_norm(g)),
            "bytes": g_bytes, "bound_ms": g_bytes / rates.bw * 1e3},
        "adamw_apply": {
            "ms": median_ms(lambda: kadamw.adamw_apply(g, m, v, p, **sc)),
            "plain_ms": median_ms(lambda: optim_adamw._update_leaves(
                g, state, p, **sc)),
            "bytes": apply_bytes, "bound_ms": apply_bytes / rates.bw * 1e3},
    }
    for row in times.values():
        row["bound_by"] = "bytes"
        row["achieved_TBps"] = row["bytes"] / row["ms"] / 1e9
    del p, g, m, v, state
    kadamw.reset_launch_counts()
    torch.cuda.empty_cache()
    return check, times


def phase_kernels(bucket_sizes, rates) -> dict:
    """``bucket_sizes``: the leaf sizes of each bucket of the main path's
    plan, in fusion order."""
    gen = torch.Generator().manual_seed(SEED)
    n_cases, max_err = 0, 0.0
    for bits in range(2, 9):
        for L in (1, 3, 40):
            for base in (0, 1237):
                for R, rs in ((1, 0), (4, 0), (4, 3001)):
                    max_err = max(max_err, _check_case(
                        gen, bits=bits, L=L, base=base, R=R, row_stride=rs,
                        cols=3001,
                    ))
                    n_cases += 1
        # widths of whole blocks (no padding, so a misaligned x reaches the
        # wrapper's copy), and 40 leaves of a few elements each
        for base, R, rs in ((0, 1, 0), (1237, 4, 3001)):
            for short, misaligned in ((True, False), (False, True),
                                      (True, True)):
                max_err = max(max_err, _check_case(
                    gen, bits=bits, L=40, base=base, R=R, row_stride=rs,
                    cols=2560, short=short, misaligned=misaligned,
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
    adamw_check, adamw_times = _adamw_kernels(rates)
    emit({"phase": "kernels", "cases": n_cases, "bit_identical": True,
          "tolerance": "bit-identical (torch.equal)",
          "max_abs_err": max_err, "largest_bucket": [1, big],
          "adamw": adamw_check})

    bw, flops = rates.bw, rates.f32
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
            q_call = call_ms(lambda: transport.quantize_pack(x, s, **kw))
            d_call = call_ms(
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
                         "dequantize_plain_ms": dp_ms,
                         "quantize_call_ms": q_call,
                         "dequantize_call_ms": d_call, "bound_ms": bound,
                         "bound_by": "bytes" if nbytes / bw >= ops / flops
                         else "operations"})
            del x, w
        tot = lambda k: sum(r[k] for r in rows)
        timing[bits] = {
            "quantize_pack": (tot("quantize_ms"), tot("quantize_plain_ms")),
            "unpack_dequantize": (tot("dequantize_ms"),
                                  tot("dequantize_plain_ms")),
            "call_ms": {"quantize_pack": tot("quantize_call_ms"),
                        "unpack_dequantize": tot("dequantize_call_ms")},
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
    return {"max_abs_err": max_err, "timing": timing, "adamw": adamw_times}


OPT = OptimizerConfig(lr=1e-4, schedule="constant", warmup_steps=1)
ADAMW_KEYS = tuple(kadamw.LAUNCHES)


def _adamw_launches(steps, leaves, device="cuda", apply=True) -> dict:
    """``kernels.adamw.LAUNCHES`` since its last reset, held to one
    ``sq_norm`` a step and, where ``apply``, one ``adamw_apply`` a leaf a
    step (none off the card)."""
    got = dict(kadamw.LAUNCHES)
    on = int(device != "cpu")
    want = {"sq_norm": steps * on, "adamw_apply": steps * leaves * on * apply}
    if got != want:
        raise AssertionError(f"AdamW launches {got} != {want} ({steps} "
                             f"steps, {leaves} leaves)")
    return got


def _without_adamw(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if k not in ADAMW_KEYS}


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
    launches = {k: 0 for k in (*transport.LAUNCHES, *ADAMW_KEYS)}
    for bits, ef, steps in ((4, True, 5), (8, False, 3)):
        policy = CommPolicy(algorithm="nap", mean=True, compress_bits=bits,
                            error_feedback=ef)
        # measure this run alone: nothing of an earlier phase stays alive
        gc.collect()
        torch.cuda.empty_cache()
        start_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        transport.reset_launch_counts()
        kadamw.reset_launch_counts()
        plan, state, losses, times, s = _run(
            cfg, policy, steps, device="cuda", data=data,
            snapshot_after=2 if bits == 4 else None,
        )
        counts = dict(transport.LAUNCHES)
        adamw = _adamw_launches(steps, len(plan.signature))
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
        for k, c in {**counts, **adamw}.items():
            launches[k] += c
        steady = times[1:]
        ms = statistics.median(steady) * 1e3
        runs.append({
            "bits": bits, "error_feedback": ef, "steps": steps,
            "losses": losses, "step_ms": [t * 1e3 for t in times],
            "ms_per_step": ms, "tokens_per_s": BATCH * SEQ / (ms / 1e3),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "memory_allocated_at_start": start_bytes,
            "launches": counts, "adamw_launches": adamw,
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
    kadamw.reset_launch_counts()
    plan, state, losses, _, _ = _run(cfg, policy, 2, device="cuda",
                                     data=data)
    if transport.LAUNCHES != before:
        raise AssertionError("the plain route launched a kernel")
    # AdamW on its kernels on both sides (held against its plain version
    # in phase kernels)
    adamw = _adamw_launches(2, len(plan.signature))
    params_equal = all(
        torch.equal(a, b)
        for a, b in zip(state["model"].leaves(), kernel_run["snap"])
    )
    losses_equal = losses == kernel_run["losses"]
    emit({"phase": "train_vs_plain", "steps": 2, "losses_plain": losses,
          "losses_kernel": kernel_run["losses"],
          "params_bitwise_equal": params_equal,
          "losses_bitwise_equal": losses_equal, "adamw_launches": adamw})
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


def _rand(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _flash_inputs(gen, B, S, H, KV, hd, dtype, scale=0.5, Sk=None):
    Sk = S if Sk is None else Sk
    return (_rand(gen, B, S, H, hd, dtype=dtype, scale=scale),
            _rand(gen, B, Sk, KV, hd, dtype=dtype, scale=scale),
            _rand(gen, B, Sk, KV, hd, dtype=dtype, scale=scale))


def _rwkv_inputs(gen, B, S, H, hd, dtype):
    r, k, v = (_rand(gen, B, S, H, hd, dtype=dtype, scale=0.5)
               for _ in range(3))
    # RWKV6's decay exp(-exp(.)), in (0, 1)
    w = torch.exp(-torch.exp(_rand(gen, B, S, H, hd, scale=0.5) - 0.5))
    return r, k, v, w.to(dtype), _rand(gen, H, hd, scale=0.1)


def _mamba_inputs(gen, B, S, d, N, dtype, general_A=False):
    # Mamba's own initialisation: dt log-uniform in [1e-3, 1e-1], A = -[1..N];
    # general_A: A = -exp(N(0, 0.5^2)) per entry, as the CPU tests draw it
    # (tests/test_torch_ops.py), so no shortcut for A = -[1..N] passes
    u = torch.rand((B, S, d), generator=gen, device="cuda")
    dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    if general_A:
        A = -torch.exp(_rand(gen, d, N, scale=0.5))
    else:
        A = -torch.arange(1, N + 1, dtype=torch.float32,
                          device="cuda").expand(d, N).contiguous()
    return (_rand(gen, B, S, d, dtype=dtype), dt.to(dtype), A,
            _rand(gen, B, S, N, dtype=dtype), _rand(gen, B, S, N, dtype=dtype))


TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


ROW_REL_L2 = 2.0 ** -7  # bf16 attention: per-row relative L2 error bound


def _row_rel_l2(name, got, want, where) -> float:
    """Largest per-row ||o - o_plain|| / ||o_plain|| (rows along the last
    axis); raises beyond ``ROW_REL_L2``.  ``want`` is the plain version in
    float32 on the same (bf16-valued) inputs, not rounded to bf16."""
    a, b = got.float(), want.float()
    worst = ((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)).max()
    worst = worst.item()
    if not worst <= ROW_REL_L2:
        raise AssertionError(
            f"{name} kernel != plain at {where}: a row's relative L2 error "
            f"is {worst}, bound {ROW_REL_L2}"
        )
    return worst


def _hold(name, got, want, dtype, where, *, row_atol=None) -> float:
    """Max |kernel - plain| in float32; raises beyond the tolerance.

    ``row_atol``: the absolute term is ``row_atol`` times the largest |plain|
    of each row (last axis) instead of ``TOL[dtype]``, for outputs whose
    values are about as small as that tolerance (attention over 32k keys).
    """
    tol = TOL[dtype]
    a, b = got.float(), want.float()
    diff = (a - b).abs()
    err = diff.max().item()
    if row_atol is None:
        atol = tol
    else:
        atol = row_atol * b.abs().amax(dim=-1, keepdim=True)
    ok = torch.isfinite(a).all() and bool((diff <= tol * b.abs() + atol).all())
    del diff
    if not ok:
        raise AssertionError(
            f"{name} kernel != plain at {where}: max |diff| {err}, "
            f"rtol {tol}, atol {'%g x row max' % row_atol if row_atol else tol}"
        )
    return err


FLASH_MASKS = ((True, None, None), (True, 32, None), (True, None, 30.0),
               (False, None, None), (True, 256, 50.0), (False, 64, None))
# ragged against the tensor-core kernels' tiles: 128 query rows; 64 keys
# (bf16), or 64 keys up to hd 64 and 32 at hd 128 (float32) (S, window),
# GQA 4:1 and 8:1, softcap, every head width; both types
FLASH_RAGGED_SHAPES = ((1, 1000, 8, 2, 16), (1, 2047, 8, 1, 32),
                       (2, 1000, 4, 1, 64), (1, 2047, 8, 2, 128),
                       (1, 65, 8, 1, 128))
FLASH_RAGGED_MASKS = ((True, 100, None), (False, 1000, None),
                      (True, 1000, 50.0), (False, None, 30.0),
                      (True, 33, None))


# keys longer / shorter than the queries: (B, S, Sk, H, KV, hd), ragged
# against the 128-row query tiles and the 64- (32-) key tiles, GQA
FLASH_SK_SHAPES = ((1, 1000, 2047, 8, 2, 64), (1, 2047, 1000, 8, 1, 128),
                   (2, 129, 65, 4, 4, 32), (1, 65, 129, 4, 2, 16),
                   (1, 300, 33, 8, 2, 128), (1, 64, 1, 2, 1, 64))
# with Sk < S the windows leave the last queries without a valid key
FLASH_SK_MASKS = ((True, None, None), (False, None, None),
                  (True, 64, None), (False, 100, 50.0), (True, None, 30.0),
                  (True, 16, 50.0))


def _no_key_rows(S, Sk, causal, window) -> int:
    """Query rows with no valid key (start-aligned masks)."""
    q = np.arange(S)[:, None]
    k = np.arange(Sk)[None, :]
    ok = np.ones((S, Sk), dtype=bool)
    if causal:
        ok &= q >= k
    if window:
        ok &= q - k < window
    return int((~ok.any(axis=1)).sum())


def phase_ops_kernels() -> dict:
    """The three ``ops`` kernels against their plain versions over the CPU
    tests' matrix, up to S = 2048; returns the max error per kernel."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    err = {"flash_attention": 0.0, "rwkv6_scan": 0.0, "mamba_scan": 0.0}
    rel_l2, rel_l2_at, cases = 0.0, None, 0
    sk_cases = no_key_rows = bf16_param_cases = 0
    shapes = ((1, 100, 4, 2, 32), (1, 128, 2, 2, 64), (1, 64, 2, 1, 128),
              (2, 2048, 4, 2, 128), (1, 2048, 2, 2, 16), (1, 1000, 4, 1, 64))
    for dtype in (torch.float32, torch.bfloat16):
        flash = [(shape, FLASH_MASKS) for shape in shapes]
        flash += [(shape, FLASH_MASKS + FLASH_RAGGED_MASKS)
                  for shape in FLASH_RAGGED_SHAPES]
        for (B, S, H, KV, hd), masks in flash:
            q, k, v = _flash_inputs(gen, B, S, H, KV, hd, dtype)
            for causal, window, softcap in masks:
                kw = dict(causal=causal, window=window, softcap=softcap)
                where = f"{dtype} B,S,H,KV,hd={B},{S},{H},{KV},{hd} {kw}"
                got = ops.flash_attention(q, k, v, **kw)
                # the plain version computes in float32 and rounds to the
                # inputs' type: run it on float32 copies, round here
                want32 = ops.flash_attention(q.float(), k.float(), v.float(),
                                             impl="plain", **kw)
                err["flash_attention"] = max(err["flash_attention"], _hold(
                    "flash_attention", got, want32.to(dtype), dtype, where))
                if dtype == torch.bfloat16:
                    r = _row_rel_l2("flash_attention", got, want32, where)
                    if r > rel_l2:
                        rel_l2, rel_l2_at = r, where
                cases += 1
        for B, S, Sk, H, KV, hd in FLASH_SK_SHAPES:
            q, k, v = _flash_inputs(gen, B, S, H, KV, hd, dtype, Sk=Sk)
            for causal, window, softcap in FLASH_SK_MASKS:
                kw = dict(causal=causal, window=window, softcap=softcap)
                where = (f"{dtype} B,S,Sk,H,KV,hd={B},{S},{Sk},{H},{KV},{hd} "
                         f"{kw}")
                got = ops.flash_attention(q, k, v, **kw)
                want32 = ops.flash_attention(q.float(), k.float(), v.float(),
                                             impl="plain", **kw)
                err["flash_attention"] = max(err["flash_attention"], _hold(
                    "flash_attention", got, want32.to(dtype), dtype, where))
                if dtype == torch.bfloat16:
                    r = _row_rel_l2("flash_attention", got, want32, where)
                    if r > rel_l2:
                        rel_l2, rel_l2_at = r, where
                dead = _no_key_rows(S, Sk, causal, window)
                if dead:
                    if not bool((got[:, S - dead:] == 0).all()):
                        raise AssertionError(
                            f"flash_attention: rows without a key are not 0 "
                            f"at {where}")
                    no_key_rows += dead
                sk_cases += 1
                cases += 1
        for B, S, H, hd in ((1, 100, 2, 32), (2, 64, 2, 16), (1, 40, 1, 64),
                            (2, 2048, 4, 64)):
            args = _rwkv_inputs(gen, B, S, H, hd, dtype)
            err["rwkv6_scan"] = max(err["rwkv6_scan"], _hold(
                "rwkv6_scan", ops.rwkv6_scan(*args),
                ops.rwkv6_scan(*args, impl="plain"), dtype,
                f"{dtype} B,S,H,hd={B},{S},{H},{hd}"))
            cases += 1
        # ragged against the staged chunk, every head width, B*H below and
        # above the 132 SMs, one bonus per head (Bu = 1) and per batch row
        C = trw.CHUNK
        for S in (C - 1, C, C + 1, 2 * C + 1):
            for hd in trw.HEAD_DIMS:
                for B, H in ((2, 4), (5, 32)):
                    r, k, v, w, u = _rwkv_inputs(gen, B, S, H, hd, dtype)
                    for ub in (u[None], _rand(gen, B, H, hd, scale=0.1)):
                        err["rwkv6_scan"] = max(err["rwkv6_scan"], _hold(
                            "rwkv6_scan", trw.rwkv6_scan_bshd(r, k, v, w, ub),
                            trw.rwkv6_scan_bshd(r, k, v, w, ub,
                                                impl="plain"), dtype,
                            f"{dtype} B,S,H,hd={B},{S},{H},{hd} "
                            f"Bu={ub.shape[0]}"))
                        cases += 1
        mamba = [(shape, general) for general in (False, True)
                 for shape in ((2, 50, 40, 4), (1, 70, 40, 16), (1, 64, 96, 8),
                               (2, 2048, 1000, 16))]
        # ragged against the kernel's channel block and staged chunk, with a
        # general A: d = block +- 1, S = chunk +- 1 and 2 chunk + 1
        Cd, Cs = tms.CHANNELS, tms.CHUNK
        mamba += [((3, S, d, N), True) for d in (Cd - 1, Cd + 1)
                  for S in (Cs - 1, Cs + 1, 2 * Cs + 1)
                  for N in tms.STATE_SIZES]
        for (B, S, d, N), general in mamba:
            args = _mamba_inputs(gen, B, S, d, N, dtype, general_A=general)
            err["mamba_scan"] = max(err["mamba_scan"], _hold(
                "mamba_scan", ops.mamba_scan(*args),
                ops.mamba_scan(*args, impl="plain"), dtype,
                f"{dtype} B,S,d,N={B},{S},{d},{N} general_A={general}"))
            cases += 1
        # a bf16 bonus u / a bf16 A, cast to float32 by the wrappers
        for B, S, H, hd in ((2, 2 * C + 1, 4, 64), (1, 100, 2, 32)):
            r, k, v, w, u = _rwkv_inputs(gen, B, S, H, hd, dtype)
            args = (r, k, v, w, u.to(torch.bfloat16))
            err["rwkv6_scan"] = max(err["rwkv6_scan"], _hold(
                "rwkv6_scan", ops.rwkv6_scan(*args),
                ops.rwkv6_scan(*args, impl="plain"), dtype,
                f"{dtype} B,S,H,hd={B},{S},{H},{hd} bf16 u"))
            bf16_param_cases += 1
            cases += 1
        for B, S, d, N in ((2, 2 * Cs + 1, Cd + 1, 16), (1, 70, 40, 4)):
            x, dt, A, Bm, Cm = _mamba_inputs(gen, B, S, d, N, dtype,
                                             general_A=True)
            args = (x, dt, A.to(torch.bfloat16), Bm, Cm)
            err["mamba_scan"] = max(err["mamba_scan"], _hold(
                "mamba_scan", ops.mamba_scan(*args),
                ops.mamba_scan(*args, impl="plain"), dtype,
                f"{dtype} B,S,d,N={B},{S},{d},{N} bf16 A"))
            bf16_param_cases += 1
            cases += 1
    emit({"phase": "ops_kernels", "cases": cases,
          "flash_sk_ne_s_cases": sk_cases,
          "flash_rows_without_key_checked_zero": no_key_rows,
          "bf16_u_or_A_cases": bf16_param_cases,
          "tolerance": {"float32": TOL[torch.float32],
                        "bfloat16": TOL[torch.bfloat16],
                        "bfloat16_flash_row_rel_l2": ROW_REL_L2},
          "max_abs_err": err, "flash_bf16_worst_row_rel_l2": rel_l2,
          "flash_bf16_worst_row_case": rel_l2_at})
    torch.cuda.empty_cache()
    return err


def _band_pairs(S, causal, window) -> int:
    """(query, key) pairs inside the causal band / window of one head."""
    q = np.arange(S, dtype=np.int64)
    lo = np.maximum(0, q - window + 1) if window else np.zeros_like(q)
    hi = q if causal else np.full_like(q, S - 1)
    return int((hi - lo + 1).sum())


def _bound(nbytes, n_ops, bw, peak) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / bw, n_ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _flash_plain_by_head(q, k, v, **kw):
    """The plain version one head at a time: a 32k x 32k score matrix per
    head fits, all heads at once do not."""
    H, KV = q.shape[2], k.shape[2]
    out = torch.empty_like(q)
    for h in range(H):
        g = h // (H // KV)
        out[:, :, h:h + 1] = ops.flash_attention(
            q[:, :, h:h + 1], k[:, :, g:g + 1], v[:, :, g:g + 1],
            impl="plain", **kw)
    return out


def _mamba_bound(args, out, bw, clock, fp32_per_ex2) -> dict:
    """The scan's bound: the larger of its bytes over the memory rate and
    its exponentials (one MUFU.EX2 per state entry and step) over the
    special-function units' rate at the card's maximum SM clock."""
    x, dt, A, Bm, Cm = args
    B, S, d = x.shape
    nbytes = sum(t.numel() * t.element_size()
                 for t in (x, dt, A, Bm, Cm)) + out.numel() * 4
    ex2 = B * S * d * A.shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t_bytes, t_ex2 = nbytes / bw, ex2 / (sms * EX2_PER_CLOCK * clock)
    return {"bytes": nbytes, "ops": ex2, "ops_counted": "MUFU.EX2",
            "bound_ms": max(t_bytes, t_ex2) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ex2 else "operations",
            "bytes_bound_ms": t_bytes * 1e3, "ex2_bound_ms": t_ex2 * 1e3,
            "clock_hz": clock, "sms": sms, "ex2_per_clock": EX2_PER_CLOCK,
            "fp32_per_ex2_sass": fp32_per_ex2}


def phase_ops_full_width(rates, clock, fp32_per_ex2) -> dict:
    """``clock``: the card's maximum SM clock in Hz; ``fp32_per_ex2``: the
    float32 scan's float32 instructions per MUFU.EX2 in its SASS."""
    bw = rates.bw
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf = torch.bfloat16
    g, m, r, j = GEMMA2, MINICPM, RWKV6, JAMBA
    # gemma2's local and global layers see the same q, k, v shapes
    qkv = _flash_inputs(gen, g["B"], g["S"], g["H"], g["KV"], g["hd"], bf, 1.0)
    cases = [
        ("flash_gemma2_local", "flash_attention", "gemma2-27b", qkv,
         dict(causal=True, window=g["window"], softcap=g["softcap"])),
        ("flash_gemma2_global", "flash_attention", "gemma2-27b", qkv,
         dict(causal=True, window=None, softcap=g["softcap"])),
        ("flash_minicpm", "flash_attention", "minicpm-2b",
         _flash_inputs(gen, m["B"], m["S"], m["H"], m["KV"], m["hd"], bf, 1.0),
         dict(causal=True, window=None, softcap=None)),
        ("rwkv6_1p6b", "rwkv6_scan", "rwkv6-1.6b",
         _rwkv_inputs(gen, r["B"], r["S"], r["H"], r["hd"], torch.float32),
         {}),
        ("mamba_jamba", "mamba_scan", "jamba-1.5-large",
         _mamba_inputs(gen, j["B"], j["S"], j["d"], j["N"], torch.float32),
         {}),
    ]
    gemma2_masks = [(c[0], c[4]) for c in cases[:2]]
    call = {"flash_attention": ops.flash_attention,
            "rwkv6_scan": ops.rwkv6_scan, "mamba_scan": ops.mamba_scan}

    # the main path: every case once, counters zeroed just before
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    outs = [call[kern](*args, **kw) for _, kern, _, args, kw in cases]
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    if any(launches[k] == 0 for k in call):
        raise AssertionError(f"a kernel of the path never launched: {launches}")

    results = []
    for (name, kern, config, args, kw), out in zip(cases, outs):
        dtype = args[0].dtype
        if kern == "flash_attention":
            plain = lambda: _flash_plain_by_head(*args, **kw)
        else:
            plain = lambda: call[kern](*args, impl="plain", **kw)
        # bf16 attention rows over 32k keys are about 0.01 in size: hold them
        # to one bf16 step of the row's largest value, not to 2e-2
        row_atol = 2.0 ** -7 if dtype == bf else None
        extra = {}
        if kern == "flash_attention":
            # the plain version on float32 copies (it computes in float32
            # and rounds to the inputs' type); rounded here for _hold
            want32 = _flash_plain_by_head(*(a.float() for a in args), **kw)
            err = _hold(kern, out, want32.to(dtype), dtype, name,
                        row_atol=row_atol)
            if dtype == bf:
                extra["row_rel_l2"] = _row_rel_l2(kern, out, want32, name)
            del want32
        else:
            err = _hold(kern, out, plain(), dtype, name, row_atol=row_atol)
        ms = median_ms(lambda: call[kern](*args, **kw))
        extra["call_ms"] = call_ms(lambda: call[kern](*args, **kw))
        if kern == "flash_attention" and kw["softcap"] is not None:
            # the same kernel with the softcap off: its tanhf's share
            extra["ms_softcap_off"] = median_ms(
                lambda: call[kern](*args, **{**kw, "softcap": None}))
        plain_ms = median_ms(plain, reps=3, warmup=0, launches=1)
        library_ms, library_note = None, None
        if kern == "flash_attention":
            q, k, v = args
            B, S, H, hd = q.shape
            nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
            n_ops = 4 * hd * _band_pairs(S, kw["causal"], kw["window"]) * B * H
            bound_ms, bound_by = _bound(nbytes, n_ops, bw, rates.bf16)
            if kw["softcap"] is None and kw["window"] is None \
                    and k.shape[2] == H:
                t = lambda x: x.transpose(1, 2)
                library_ms = median_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        t(q), t(k), t(v), is_causal=kw["causal"]))
                library_note = "scaled_dot_product_attention(is_causal=True)"
            else:
                library_note = ("none: no single PyTorch call computes the "
                                "tanh soft-cap inside the softmax")
        elif kern == "rwkv6_scan":
            rr, _, _, _, u = args
            B, S, H, hd = rr.shape
            nbytes = (4 * rr.numel() + u.numel()) * rr.element_size() \
                + out.numel() * 4
            # per state entry and step: r.S (2) and w*S + k*v (3)
            n_ops = 5 * hd * hd * B * H * S
            bound_ms, bound_by = _bound(nbytes, n_ops, bw, rates.f32)
            library_note = "none: no PyTorch call computes the recurrence"
        else:
            extra.update(_mamba_bound(args, out, bw, clock, fp32_per_ex2))
            nbytes, n_ops = extra.pop("bytes"), extra.pop("ops")
            bound_ms, bound_by = extra.pop("bound_ms"), extra.pop("bound_by")
            library_note = "none: no PyTorch call computes the recurrence"
        row = {"case": name, "kernel": kern, "config": config,
               "shape": [list(a.shape) for a in args],
               "dtype": str(dtype).replace("torch.", ""), **kw,
               "ms": ms, "plain_ms": plain_ms, "plain_reps": 3,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bytes": nbytes, "ops": n_ops,
               "library_ms": library_ms, "library": library_note,
               "max_abs_err": err, "tolerance": TOL[dtype],
               "atol": (f"{row_atol} x row max |plain|" if row_atol
                        else TOL[dtype]), **extra}
        emit({"phase": "ops_full_width", **row})
        results.append(row)
    del outs, cases

    # float32: gemma2's two layers again at full length, and minicpm's
    # shape, in float32 (the 3xTF32 kernel), held at 2e-5, so every key tile
    # of the 32k band is checked tightly; its own path, counters zeroed just
    # before and read just after; then timed, minicpm beside
    # scaled_dot_product_attention in float32 (TF32 off, set in main)
    qkv32 = tuple(t.float() for t in qkv)
    del qkv
    f32_cases = [(name, qkv32, kw) for name, kw in gemma2_masks] + [
        ("flash_minicpm", _flash_inputs(gen, m["B"], m["S"], m["H"], m["KV"],
                                        m["hd"], torch.float32, 1.0),
         dict(causal=True, window=None, softcap=None))]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    outs = [ops.flash_attention(*args, **kw) for _, args, kw in f32_cases]
    torch.cuda.synchronize()
    f32_launches = ops.launch_counts()["flash_attention"]
    if f32_launches != len(f32_cases):
        raise AssertionError(
            f"float32 path: {f32_launches} flash launches, want "
            f"{len(f32_cases)}")
    control, f32_times = {}, {}
    for (name, args, kw), got in zip(f32_cases, outs):
        control[name] = _hold("flash_attention", got,
                              _flash_plain_by_head(*args, **kw),
                              torch.float32, name + " (float32)")
        q, k, v = args
        B, S, H, hd = q.shape
        nbytes = 2 * (q.numel() + k.numel()) * 4
        n_ops = 4 * hd * _band_pairs(S, kw["causal"], kw["window"]) * B * H
        # 3xTF32: three TF32 products for each float32 one
        bound_ms, bound_by = _bound(nbytes, 3 * n_ops, bw, rates.tf32)
        long = S > 4096
        reps = dict(reps=3, warmup=1, launches=2) if long else {}
        row = {"ms": median_ms(lambda: ops.flash_attention(*args, **kw),
                               **reps),
               "call_ms": call_ms(lambda: ops.flash_attention(*args, **kw),
                                  reps=5 if long else 25),
               "plain_ms": median_ms(
                   lambda: _flash_plain_by_head(*args, **kw), reps=1,
                   warmup=0, launches=1),
               "plain_reps": 1,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_ms_simt_rate": _bound(nbytes, n_ops, bw, rates.f32)[0],
               "bytes": nbytes, "ops": n_ops,
               "library_ms": None, "library": "none: no single PyTorch call "
               "computes the tanh soft-cap inside the softmax"}
        if kw["softcap"] is None and kw["window"] is None and k.shape[2] == H:
            t = lambda x: x.transpose(1, 2)
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
                t(q), t(k), t(v), is_causal=kw["causal"])
            row["library_ms"] = median_ms(sdpa)
            row["library"] = ("scaled_dot_product_attention(is_causal=True), "
                              "float32, TF32 off")
            row["library_max_abs_err"] = (t(sdpa()) - got).abs().max().item()
        f32_times[name] = row
    del outs, f32_cases, qkv32
    emit({"phase": "ops_full_width_f32_control", "dtype": "float32",
          "kernel": "tc32::flash_attention_tf32x3<hd> after tc32::split_kv<hd>",
          "launches": f32_launches, "tolerance": TOL[torch.float32],
          "max_abs_err": control, "times": f32_times})
    torch.cuda.empty_cache()
    return {"launches": launches, "cases": results, "f32_control": control,
            "f32_times": f32_times, "f32_launches": f32_launches}


# minicpm-2b's largest leaf: the embedding, vocab 122,753 x d_model 2304
# (src/repro/configs/archs.py:42-53)
EMBED_ELEMS = 122_753 * 2304
RS_GRIDS = ((2, 4), (4, 2))


def phase_rs_transport(rates) -> dict:
    """The transport kernels in the calls of the sharded sync's compressed
    reduce-scatter, as the last rank (node n-1, lane ppn-1) of each grid
    makes them at the embedding leaf; bit-identical to the plain versions
    and timed.  Returns the times per (grid, bits)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    e = EMBED_ELEMS
    rows, max_err = [], 0.0
    for n, ppn in RS_GRIDS:
        node, lane = n - 1, ppn - 1
        S = -(-e // ppn)          # the intra reduce-scatter's stripe
        B = -(-S // n)            # one node's block of it
        base = lane * S
        block_base = base + node * B
        stripe = torch.randn((n, B), generator=gen, device="cuda")
        for bits in (8, 4):
            qmax = 2 ** (bits - 1) - 1
            # the agreed leaf scale times ppn (the stripe sums ppn ranks)
            s1 = (stripe.abs().max() / qmax * 1.0001).reshape(1)
            kq = dict(offsets=(0,), bits=bits, base=base, row_stride=B)
            kd = dict(offsets=(0,), bits=bits, cols=B, base=block_base,
                      row_stride=0)
            w = transport.quantize_pack(stripe, s1, **kq)
            wp = transport.quantize_pack(stripe, s1, impl="plain", **kq)
            # the n rows this rank receives: every node's copy of its block
            d = transport.unpack_dequantize(w, s1, **kd)
            dp = transport.unpack_dequantize(w, s1, impl="plain", **kd)
            torch.cuda.synchronize()
            if not (torch.equal(w, wp) and torch.equal(d, dp)):
                raise AssertionError(
                    f"rs_transport: kernel != plain at {n}x{ppn} bits={bits}")
            del wp, dp
            wi = transport.wire_itemsize(bits)
            q_ms = median_ms(lambda: transport.quantize_pack(stripe, s1, **kq))
            d_ms = median_ms(lambda: transport.unpack_dequantize(w, s1, **kd))
            qp_ms = median_ms(lambda: transport.quantize_pack(
                stripe, s1, impl="plain", **kq), reps=3, launches=1)
            dp_ms = median_ms(lambda: transport.unpack_dequantize(
                w, s1, impl="plain", **kd), reps=3, launches=1)
            elems = n * B
            # each kernel reads its input once and writes its output once
            q_bytes = elems * (4 + wi)
            ops_ = elems * 5
            bound = lambda nb: max(nb / rates.bw, ops_ / rates.f32) * 1e3
            rows.append({
                "grid": f"{n}x{ppn}", "rank": [node, lane], "bits": bits,
                "stripe": [n, B], "base": base, "block_base": block_base,
                "quantize_ms": q_ms, "quantize_plain_ms": qp_ms,
                "dequantize_ms": d_ms, "dequantize_plain_ms": dp_ms,
                "bytes": q_bytes, "bound_ms": bound(q_bytes),
                "bound_by": "bytes" if q_bytes / rates.bw >= ops_ / rates.f32
                else "operations",
                "quantize_share_of_bound": bound(q_bytes) / q_ms,
                "dequantize_share_of_bound": bound(q_bytes) / d_ms,
            })
            del w, d
        del stripe
        torch.cuda.empty_cache()
    emit({"phase": "rs_transport", "leaf_elems": e,
          "bit_identical": True, "tolerance": "bit-identical (torch.equal)",
          "max_abs_err": max_err, "calls": rows,
          "library_ms": None,
          "library_ms_reason": "no single PyTorch call computes a "
          "per-leaf-scaled quantize-and-pack (or its inverse)"})
    return {"max_abs_err": max_err, "rows": rows}


def phase_collectives_world1() -> None:
    """The reduce-scatter / allgather surface on CUDA tensors at world
    size 1, where the reference's ``n <= 1`` paths are identities: every
    leaf and every engine must come back bit for bit, on the card."""
    from repro_torch import tree
    from repro_torch.core import CommContext, Topology, comm, extensions
    from repro_torch.core import grad_sync

    cfg = MINICPM_2B_4L
    data = SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=SEED)
    policy = CommPolicy(algorithm="nap", mean=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    state = init_train_state(cfg, OPT, policy, generator=gen, device="cuda")
    model = state["model"]
    leaves, td = tree.flatten(model.params())
    loss, _ = model(data.batch(0, "cuda"))
    grads = tree.unflatten(td, list(torch.autograd.grad(loss, leaves)))
    del state, model, leaves, loss
    n_params = sum(g.numel() for g in tree.leaves(grads))
    topo = mesh_topology(1, 1)
    roundtrip = {}
    for name, kw in (("plain", {}), ("int4", dict(compress_bits=4))):
        ctx = CommContext(topo, CommPolicy(mean=True, **kw))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shards = ctx.sync_grads_sharded(grads)
        full = grad_sync.unshard_grads(shards, grads, ctx=ctx)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        pairs = list(zip(tree.leaves(full), tree.leaves(grads)))
        same = all(a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in pairs)
        shards_cuda = all(t.is_cuda for t in tree.leaves(shards))
        if not (same and shards_cuda):
            raise AssertionError(f"sharded round trip ({name}) changed a "
                                 "leaf or left the card")
        roundtrip[name] = {"ms": ms, "leaves": len(pairs),
                           "bitwise_equal": same}
        del shards, full
    del grads
    torch.cuda.empty_cache()
    x = torch.randn((1000, 37), generator=gen, device="cuda").to(
        torch.bfloat16)
    engines = {}
    for key, spec in comm.registered_engines().items():
        if spec.collective == "allreduce":
            y = CommContext(topo).allreduce(x, algorithm=spec.name)
        elif spec.collective == "reduce_scatter":
            y = CommContext(topo).reduce_scatter(x, algorithm=spec.name)
        else:
            y = CommContext(topo).allgather(x.reshape(-1), elems=x.numel(),
                                            algorithm=spec.name)
        ok = y.is_cuda and torch.equal(y.reshape(x.shape), x)
        engines[key] = ok
    for name, fn in (
        ("nap_allgather", lambda: extensions.nap_allgather(
            x, topology=topo)[0]),
        ("nap_reduce_scatter", lambda: extensions.nap_reduce_scatter(
            x[None], topology=topo)[0]),
        ("nap_allreduce_large", lambda: extensions.nap_allreduce_large(
            x, topology=topo)),
    ):
        y = fn()
        engines[f"extension:{name}"] = y.is_cuda and torch.equal(y, x)
    decisions = {}
    for n, ppn in ((1, 1), (1, 8), (2, 4), (4, 2), (16, 8)):
        ctx = CommContext(Topology.of(n, ppn))
        for coll in ("reduce_scatter", "allgather"):
            for nbytes in (4096, 1 << 24, EMBED_ELEMS * 4):
                decisions[f"{coll}/{n}x{ppn}/{nbytes}"] = ctx.dispatch(
                    nbytes, collective=coll).engine
    emit({"phase": "collectives_world1", "config": cfg.name,
          "grad_params": n_params, "sharded_roundtrip": roundtrip,
          "engines_identity_on_cuda": engines,
          "engines_registered": len(comm.registered_engines()),
          "dispatch": decisions})
    if not all(engines.values()) or len(engines) != 15:
        raise AssertionError(f"an engine changed its input at world size 1 "
                             f"or left the card: {engines}")
    phase_card_constants()


# the four-card grids, and the payloads there whose engine the card's
# constants decide: the tensor-parallel logits allreduce of 8 minicpm-2b
# slots and minicpm-2b-4l's gradient buckets
CARD_GRIDS = ((2, 2), (4, 1), (1, 4))


def card_dispatch_table(params) -> dict:
    """Per grid of ``CARD_GRIDS`` under ``params`` (planning only): the
    NAP<->MLA crossover and ``CommContext.dispatch``'s (engine, chunks)
    for each payload, with the buckets planned under the same
    constants."""
    from repro_torch.core import CommContext, Topology, grad_sync
    from repro_torch.models import init_params

    tree = init_params(MINICPM_2B_4L, device="meta")
    out = {}
    for n, ppn in CARD_GRIDS:
        topo = Topology.of(n, ppn, params=params)
        sizes = {"tp_logits_8_slots": 8 * MINICPM_2B.vocab_size * 4}
        for b in grad_sync.plan_for_tree(tree, cfg=CommPolicy(),
                                         topology=topo).buckets:
            sizes[f"bucket_{b.dtype}_{b.nbytes}"] = b.nbytes
        ctx = CommContext(topo)
        xo = topo.crossover_bytes()
        out[f"{n}x{ppn}"] = {
            "crossover_bytes": xo if math.isfinite(xo) else str(xo),
            "dispatch": {k: [v, *ctx.dispatch(v)] for k, v in sizes.items()}}
    return out


def phase_card_constants() -> None:
    """The constants an NCCL world's executable topology carries (a world
    of one on this card, destroyed after): they must be the card's
    (``perf_model.H100_NVLINK_HOST``); printed with the dispatch they give
    on the four-card grids (:func:`card_dispatch_table`)."""
    import torch.distributed as dist

    from repro_torch.core import Topology
    from repro_torch.core import perf_model as pm

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
        world_size=1)
    try:
        params = Topology.from_world(1, 1).params
        backend = str(dist.get_backend())
    finally:
        dist.destroy_process_group()
    emit({"phase": "collectives_world1", "part": "card_constants",
          "backend": backend, "constants": params.name,
          "fields": dataclasses.asdict(params),
          "dispatch_under_card_constants": card_dispatch_table(params)})
    if params != pm.H100_NVLINK_HOST:
        raise AssertionError(f"an NCCL world's topology carries "
                             f"{params.name}, not the card's constants")


# ---------------------------------------------------------------------------
# the serving spine (phase serve)
# ---------------------------------------------------------------------------

# minicpm-2b at its published widths (src/repro/configs/archs.py:42-53),
# bf16, its 40 layers cut to 8 (MINICPM_2B_8L) to keep the script inside
# its time with phase families beside it.  The engine and its traffic: 8 slots of 512 positions, prompts of
# 16..256 tokens in buckets of 32 / 64 / 128 / 256, 32..128 new tokens,
# 12 requests from a seeded generator, 8 at the start and 4 in flight.
SERVE = dict(num_slots=8, max_len=512, buckets=(32, 64, 128, 256),
             requests=12, first=8, prompt=(16, 256), new=(32, 128))
SERVE_ROUTER_REQUESTS = 4


def serve_traffic(vocab: int, seed: int = SEED) -> list:
    """``(prompt, max_new_tokens)`` of every request, from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(SERVE["requests"]):
        n = int(rng.integers(SERVE["prompt"][0], SERVE["prompt"][1] + 1))
        new = int(rng.integers(SERVE["new"][0], SERVE["new"][1] + 1))
        out.append((rng.integers(0, vocab, n).tolist(), new))
    return out


def serve_engine(model, device, **kw):
    from repro_torch.serve import PromptBuckets, ServeEngine

    return ServeEngine(model, num_slots=SERVE["num_slots"],
                       max_len=SERVE["max_len"],
                       buckets=PromptBuckets(SERVE["buckets"]),
                       device=device, **kw)


def _extras_kw(extras, i) -> dict:
    """``submit``'s keyword for request ``i``'s extras (none without)."""
    return {} if extras is None else {"extras": extras[i]}


def serve_serial(engine, traffic, extras=None) -> list:
    """Each request alone through ``engine``, one after another
    (``extras``: each request's, for an encoder-decoder)."""
    out = []
    for i, (prompt, new) in enumerate(traffic):
        req = engine.submit(prompt, new, **_extras_kw(extras, i))
        out.append(engine.run()[req.rid])
    return out


def serve_continuous(engine, traffic, sync, first: int = SERVE["first"],
                     extras=None) -> tuple[list, list]:
    """Continuous batching: ``first`` requests at the start, the rest after
    two engine steps.  Returns the streams and each prefill's (prompt
    tokens, seconds), timed between device synchronisations."""
    prefills = []
    prefill = engine._prefill

    def timed(req):
        sync()
        t0 = time.perf_counter()
        out = prefill(req)
        sync()
        prefills.append((len(req.prompt), time.perf_counter() - t0))
        return out

    engine._prefill = timed
    reqs = [engine.submit(p, n, **_extras_kw(extras, i))
            for i, (p, n) in enumerate(traffic[:first])]
    for _ in range(2):
        engine.step()
    reqs += [engine.submit(p, n, **_extras_kw(extras, first + i))
             for i, (p, n) in enumerate(traffic[first:])]
    out = engine.run()
    engine._prefill = prefill
    return [out[r.rid] for r in reqs], prefills


def serve_router_resume(model, device, traffic, serial, *, make=None,
                        extras=None) -> dict:
    """A router over two engines sharing ``model`` (``make()`` builds one;
    :func:`serve_engine` by default); replica 0 dies after two steps of
    each.  Every accepted request must end with its serial tokens (the
    resumed ones replay what they had generated; an encoder-decoder's are
    re-prefilled from their own ``extras``)."""
    from repro_torch.serve import Router

    make = make or (lambda: serve_engine(model, device))
    a, b = make(), make()
    router = Router([a, b])
    reqs = [router.submit(p, n, **_extras_kw(extras, i))
            for i, (p, n) in enumerate(traffic)]
    for _ in range(2):
        a.step()
        b.step()
    resumed = [r.rid for r in reqs
               if r.generated and router.placement[r.rid] == 0]
    moved = router.fail_replica(0)
    while not b.idle:
        b.step()
    ok = [r.state == "finished" and r.generated == want
          for r, want in zip(reqs, serial)]
    if not (resumed and all(ok)):
        raise AssertionError(f"router resume: resumed {resumed}, per "
                             f"request equal to serial {ok}")
    return {"requests": len(reqs), "replanned": moved,
            "resumed_mid_stream": len(resumed), "equal_to_serial": all(ok)}


def _serve_profile(engine, traffic) -> dict:
    """One decode step of 8 active slots under ``torch.profiler``: wall,
    device busy (GEMM / other), idle share, host syncs, launches; and the
    valid KV positions the step reads."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for prompt, _ in traffic[: SERVE["num_slots"]]:
        engine.submit(prompt[:16], 4)
    engine.step()  # admissions and their prefills, one decode step
    positions = int(engine._cache["index"].sum()) + SERVE["num_slots"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()  # ends with the tokens' copy to the host
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    classes = {"gemm": 0.0, "other": 0.0}
    for e in events:
        if e.device_type != DeviceType.CUDA or _device_us(e) <= 0:
            continue
        low = e.key.lower()
        key = "gemm" if any(k in low for k in (
            "gemm", "gemv", "nvjet", "cutlass", "xmma", "cublas",
            "sm90_")) else "other"
        classes[key] += _device_us(e) / 1e3
    count = lambda *names: sum(e.count for e in events if e.key in names)
    busy = sum(classes.values())
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_decode_step.txt").write_text(
        events.table(sort_by="self_cuda_time_total", row_limit=60))
    engine.run()
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_ms, "busy_ms_by_class": classes,
            "host_syncs": count("cudaStreamSynchronize",
                                "cudaDeviceSynchronize",
                                "cudaEventSynchronize"),
            "kernel_launches": count("cudaLaunchKernel", "cuLaunchKernel",
                                     "cudaLaunchKernelExC", "cuLaunchKernelEx"),
            "kv_positions_read": positions}


def _serve_small_reference() -> float:
    """The reduced config in float32: the same decode on the card and on
    the CPU, rows at unequal indices (0 / 3 / 7 at the start), logits at
    rtol / atol 1e-4 over 12 steps."""
    from repro_torch.models import build_model

    cfg = reduced(MINICPM_2B)
    cpu = build_model(cfg, generator=torch.Generator().manual_seed(SEED),
                      device="cpu")
    card = build_model(cfg, _detached(cpu.params()), device="cuda")
    toks = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (3, 12))
    caches = {}
    for m in (cpu, card):
        caches[m] = m.init_decode(3, 24)
        caches[m]["index"].copy_(torch.tensor([0, 3, 7]))
    worst = 0.0
    for t in range(12):
        logits = [m.decode_step(caches[m], torch.from_numpy(
            toks[:, t:t + 1]).to(m.device))[0].cpu() for m in (cpu, card)]
        worst = max(worst, float((logits[1] - logits[0]).abs().max()))
        if not torch.allclose(logits[1], logits[0], rtol=1e-4, atol=1e-4):
            raise AssertionError(f"decode logits differ at step {t}: {worst}")
    return worst


def phase_serve(rates, smi) -> None:
    """The serving spine on the card at minicpm-2b's published widths (8
    of its 40 layers): continuous batching against serial decoding (bitwise), the EOS
    exit, a router that loses a replica, one profiled decode step, the
    decode dispatch at 2x4 / 4x8, and the five kernels' launch counts on
    this path (0: neither package's decode calls a kernel)."""
    from repro_torch import tree
    from repro_torch.core import CommContext, Topology, napalg
    from repro_torch.models import build_model
    from repro_torch.serve.engine import decode_dispatch

    t_phase = time.perf_counter()
    small_err = _serve_small_reference()
    cfg = MINICPM_2B_8L
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = build_model(cfg, generator=gen, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    traffic = serve_traffic(cfg.vocab_size)
    sync = torch.cuda.synchronize

    # the main path: counters zeroed just before, read just after
    transport.reset_launch_counts()
    ops.reset_launch_counts()
    engine = serve_engine(model, "cuda")
    t0 = time.perf_counter()
    cont, prefills = serve_continuous(engine, traffic, sync)
    cont_s = time.perf_counter() - t0
    launches = {**dict(transport.LAUNCHES), **ops.launch_counts()}
    steps = engine.fit_rows()
    decode_s = sum(sec for _, sec, _ in steps)  # slice_len 1: one a row
    generated = sum(len(s) for s in cont)
    peak = torch.cuda.max_memory_allocated()
    profile_row = _serve_profile(engine, traffic)
    del engine

    serial_engine = serve_engine(model, "cuda")
    serial = serve_serial(serial_engine, traffic)
    del serial_engine
    equal = [a == b for a, b in zip(cont, serial)]
    if not all(equal):
        raise AssertionError(f"continuous != serial for requests "
                             f"{[i for i, e in enumerate(equal) if not e]}")

    # EOS: a token of request 0's own greedy stream, first seen at k >= 4
    s0 = serial[0]
    k = next(i for i in range(4, len(s0)) if s0[i] not in s0[:i])
    eos_engine = serve_engine(model, "cuda", eos_id=s0[k])
    req = eos_engine.submit(*traffic[0])
    got = eos_engine.run()[req.rid]
    del eos_engine
    if got != s0[: k + 1]:
        raise AssertionError(f"EOS {s0[k]} at {k}: got {len(got)} tokens")

    # the router's requests: the ones with the shortest prompts
    pick = sorted(sorted(range(len(traffic)),
                         key=lambda i: len(traffic[i][0]))[
        :SERVE_ROUTER_REQUESTS])
    router = serve_router_resume(model, "cuda", [traffic[i] for i in pick],
                                 [serial[i] for i in pick])

    # the decode step's bytes bound: weights and head read once (bf16),
    # the KV positions the profiled step reads and the rows it writes
    p = model.params()
    head_bytes = p["embedding"].numel() * p["embedding"].element_size()
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree.leaves(p["stack"]))
    kv_per_pos = (cfg.num_layers * 2 * cfg.num_kv_heads
                  * cfg.resolved_head_dim * 2)
    kv_bytes = (profile_row["kv_positions_read"]
                + SERVE["num_slots"]) * kv_per_pos
    bound_bytes = weight_bytes + head_bytes + kv_bytes
    dispatch = {}
    for n, ppn in ((2, 4), (4, 8)):
        group = n * ppn
        b_max = max(napalg.ragged_splits(SERVE["num_slots"], group))
        dispatch[f"{n}x{ppn}"] = decode_dispatch(
            CommContext(Topology.of(n, ppn)), cfg, group, b_max)
    decode_ms = [sec * 1e3 for _, sec, _ in steps]
    emit({"phase": "serve", "config": cfg.name, "layers": cfg.num_layers,
          "dtype": cfg.dtype, "nvidia_smi": smi,
          "traffic": {"requests": len(traffic),
                      "prompt_tokens": sum(len(p_) for p_, _ in traffic),
                      "max_new_tokens": sum(n_ for _, n_ in traffic),
                      **{k_: v for k_, v in SERVE.items()
                         if k_ in ("num_slots", "max_len", "buckets")}},
          "continuous_s": cont_s, "decode_steps": len(steps),
          "decode_ms_per_step_median": statistics.median(decode_ms),
          "decode_ms_per_step_min": min(decode_ms),
          "decode_tokens_per_s": generated / decode_s,
          "generated_tokens": generated,
          "prefill_ms_per_prompt_token": (
              sum(sec for _, sec in prefills) * 1e3
              / sum(n_ for n_, _ in prefills)),
          "prefills": len(prefills),
          "peak_device_memory_bytes": peak,
          "profile_decode_step": profile_row,
          # the profiler slows the host: busy against an unprofiled step
          "idle_share_of_median_step": 1 - profile_row["device_busy_ms"]
          / statistics.median(decode_ms),
          "decode_step_bound": {
              "weight_bytes": weight_bytes, "head_bytes": head_bytes,
              "kv_bytes": kv_bytes,
              "bound_ms": bound_bytes / rates.bw * 1e3,
              "bound_by": "bytes"},
          "continuous_equals_serial": all(equal),
          "eos": {"token": s0[k], "at": k, "finished_at_eos": True},
          "router": router, "dispatch": dispatch,
          "kernel_launches_on_this_path": launches,
          "small_reference_max_abs_err": small_err,
          "phase_s": time.perf_counter() - t_phase})
    if any(launches.values()):
        raise AssertionError(f"a kernel launched on the serving path: "
                             f"{launches}")
    del model, p
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the other model families (phase families)
# ---------------------------------------------------------------------------

# Each configuration of CHIP_FAMILIES (repro_torch/configs/archs.py: the
# published widths, depth cut, jamba's experts cut to 4) served bf16 by an
# engine of 8 slots x 256 positions: 6 requests from a seeded generator,
# prompts of 8..48 tokens, 8..32 new tokens, 4 at the start and 2 after
# two engine steps.
FAMILY_SERVE = dict(num_slots=8, max_len=256, requests=6, first=4,
                    prompt=(8, 48), new=(8, 32))
# float32 decode against the full forward: B 2, S 32, rtol = atol 2e-3
FAMILY_CHECK = dict(B=2, S=32, tol=2e-3)
# the train step: batch 2 x 512, AdamW, int4 + EF, 2 steps
FAMILY_TRAIN = dict(B=2, S=512, steps=2)
GATE_MARGIN = 1e-6


def family_traffic(vocab: int, seed: int = SEED) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(FAMILY_SERVE["requests"]):
        n = int(rng.integers(FAMILY_SERVE["prompt"][0],
                             FAMILY_SERVE["prompt"][1] + 1))
        new = int(rng.integers(FAMILY_SERVE["new"][0],
                               FAMILY_SERVE["new"][1] + 1))
        out.append((rng.integers(0, vocab, n).tolist(), new))
    return out


def _free():
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _family_serve(model) -> dict:
    """Continuous batching bitwise equal to serial decoding through a
    fresh engine of the same shape; the kernels' launches on this path."""
    from repro_torch.serve import ServeEngine

    cfg = model.cfg
    traffic = family_traffic(cfg.vocab_size)
    make = lambda: ServeEngine(model, num_slots=FAMILY_SERVE["num_slots"],
                               max_len=FAMILY_SERVE["max_len"],
                               device=model.device)
    transport.reset_launch_counts()
    ops.reset_launch_counts()
    engine = make()
    t0 = time.perf_counter()
    cont, prefills = serve_continuous(engine, traffic, torch.cuda.synchronize,
                                      first=FAMILY_SERVE["first"])
    cont_s = time.perf_counter() - t0
    launches = {**dict(transport.LAUNCHES), **ops.launch_counts()}
    steps = engine.fit_rows()
    del engine
    serial = serve_serial(make(), traffic)
    peak = torch.cuda.max_memory_allocated()
    equal = [a == b for a, b in zip(cont, serial)]
    decode_ms = [sec * 1e3 for _, sec, _ in steps]
    row = {
        "requests": len(traffic),
        "prompt_tokens": sum(len(p) for p, _ in traffic),
        "generated_tokens": sum(len(t) for t in cont),
        "continuous_s": cont_s, "decode_steps": len(steps),
        "decode_ms_per_step_median": statistics.median(decode_ms),
        "decode_ms_per_step_min": min(decode_ms),
        "decode_tokens_per_s": sum(len(t) for t in cont)
        / (sum(decode_ms) / 1e3),
        "prefill_ms_per_prompt_token": sum(sec for _, sec in prefills) * 1e3
        / sum(n for n, _ in prefills),
        "peak_device_memory_bytes": peak,
        "continuous_equals_serial": all(equal),
        "kernel_launches_on_this_path": launches,
    }
    if not all(equal):
        raise AssertionError(f"{cfg.name}: continuous != serial for "
                             f"requests {[i for i, e in enumerate(equal) if not e]}")
    if any(launches.values()):
        raise AssertionError(f"{cfg.name}: a kernel launched on the serving "
                             f"path: {launches}")
    return row


class _RouterLog:
    """Records every MoE call's top-k expert sets and the gate margin
    between the k-th and the (k+1)-th expert, by wrapping
    ``repro_torch.models.moe.moe_apply`` (the transformer calls it through
    the module)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.orig = moe, moe.moe_apply

        def wrapped(params, x, *, cfg, **kw):
            k = cfg.moe.top_k
            probs = torch.softmax(x.to(torch.float32) @ params[
                "w_router"].to(torch.float32), dim=-1)
            top = torch.topk(probs, min(k + 1, probs.shape[-1]), dim=-1)
            margin = (top.values[..., k - 1] - top.values[..., k]
                      if top.values.shape[-1] > k  # else no expert is left
                      else torch.full_like(top.values[..., 0], math.inf))
            self.calls.append((top.indices[..., :k].sort(-1).values, margin))
            return self.orig(params, x, cfg=cfg, **kw)

        moe.moe_apply = wrapped
        return self

    def __exit__(self, *exc):
        self.moe.moe_apply = self.orig
        return False


def _decode_vs_full(model, hold: bool = True, extras=None) -> dict:
    """Teacher-forced ``decode_step`` logits against ``Model.logits``,
    float32 (TF32 off), B 2, S 32, at rtol = atol 2e-3; with MoE, the
    top-k sets of the two paths position by position.  ``hold=False``
    reports the error without holding it (rwkv6 at its whole depth).
    ``extras``: an encoder-decoder's ``{"frames": (B, S_enc, D)}``."""
    cfg = model.cfg
    B, S, tol = FAMILY_CHECK["B"], FAMILY_CHECK["S"], FAMILY_CHECK["tol"]
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, S))).to(model.device)
    with _RouterLog() as full_log:
        full = model.logits({"tokens": toks, **(extras or {})})
    cache = model.init_decode(B, S, batch=extras)
    outs, dec_log = [], []
    for t in range(S):
        with _RouterLog() as log:
            logits, cache = model.decode_step(cache, toks[:, t : t + 1])
        outs.append(logits[:, 0])
        dec_log.append(log.calls)
    dec = torch.stack(outs, dim=1)
    row = {"max_abs_err": float((dec - full).abs().max()),
           "max_abs_logit": float(full.abs().max()), "tol": tol,
           "close": bool(torch.allclose(dec, full, rtol=tol, atol=tol))}
    if cfg.moe is not None:
        agree, left_out = [], 0
        for layer, (sets, margin) in enumerate(full_log.calls):
            same = torch.stack([(sets[:, t] == dec_log[t][layer][0][:, 0])
                                .all(-1) for t in range(S)], dim=1)  # (B,S)
            d_margin = torch.stack([dec_log[t][layer][1][:, 0]
                                    for t in range(S)], dim=1)
            near = torch.minimum(margin, d_margin) < GATE_MARGIN
            left_out += int((~same & near).sum())
            if bool((~same & ~near).any()):
                raise AssertionError(
                    f"{cfg.name}: MoE layer {layer}: top-k sets differ at a "
                    "gate margin >= 1e-6")
            # one string a row, one character a position: 1 = same set
            agree += ["".join("1" if x else "0" for x in r)
                      for r in same.tolist()]
        row["topk_sets_agree_by_moe_layer_and_row"] = agree
        row["positions_left_out_for_gate_margin"] = left_out
        row["capacity_factor"] = cfg.moe.capacity_factor
    if hold and not row["close"]:
        raise AssertionError(f"{cfg.name}: decode != full forward: {row}")
    return row


def _gemma2_window(model) -> dict:
    """One float32 sequence of window + 256 tokens through gemma2's 2
    layers: teacher-forced decode against the full forward over the last
    256 positions, where the local layer's ring buffer has wrapped and its
    mask bites."""
    from repro_torch.models.layers import head_dot, softcap
    from repro_torch.models.model import _final_hidden

    cfg = model.cfg
    tail, tol = 256, FAMILY_CHECK["tol"]
    S = cfg.sliding_window + tail
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (1, S))).to(model.device)
    with torch.no_grad():
        hidden, _ = _final_hidden(model.params(), {"tokens": toks}, cfg)
        full = softcap(head_dot(hidden[:, -tail:], model.head_weights()),
                       cfg.final_logit_softcap)
    del hidden
    cache = model.init_decode(1, S)
    t0 = time.perf_counter()
    for t in range(S - tail):
        model.decode_hidden(cache, toks[:, t : t + 1])
    outs = []
    for t in range(S - tail, S):
        logits, cache = model.decode_step(cache, toks[:, t : t + 1])
        outs.append(logits[:, 0])
    dec = torch.stack(outs, dim=1)
    row = {"tokens": S, "window": cfg.sliding_window, "compared": tail,
           "ring_positions": int(cache["stack"]["sub0"]["k"].shape[3]),
           "decode_s": time.perf_counter() - t0,
           "max_abs_err": float((dec - full).abs().max()), "tol": tol,
           "close": bool(torch.allclose(dec, full, rtol=tol, atol=tol))}
    if not row["close"]:
        raise AssertionError(f"gemma2 window check failed: {row}")
    return row


class _ExactGroupNorm:
    """RWKV6's ``_group_norm`` without its bf16 round trip (the port's
    copy of the reference's rounds its float32 output through bf16, a
    discontinuity that turns a one-ulp difference into 2^-8 of the value):
    for the held float32 check of rwkv6 only."""

    def __enter__(self):
        from repro_torch.models import rwkv

        def exact(x, scale, H, hd, eps=1e-5):
            shape = x.shape
            x = x.reshape(*shape[:-1], H, hd).to(torch.float32)
            mu = x.mean(-1, keepdim=True)
            var = x.var(-1, keepdim=True, unbiased=False)
            return ((x - mu) * torch.rsqrt(var + eps)).reshape(shape) * scale

        self.rwkv, self.orig = rwkv, rwkv._group_norm
        rwkv._group_norm = exact
        return self

    def __exit__(self, *exc):
        self.rwkv._group_norm = self.orig
        return False


def _check_config(cfg):
    """The float32 configuration of the decode check: jamba with 2 of its
    experts (45.7 GB); deepseek with a capacity factor of E / k, so the
    full forward's 64 tokens fit every expert (at 1.25 it may drop some,
    which no decode step does); rwkv6 at 4 of its 24 layers, held with
    its group norm's bf16 round trip taken out (:class:`_ExactGroupNorm`).
    Reason: the round trip turns a float32 difference of one ulp between
    the two paths into a jump of 2^-8 of the value (on the CPU at full
    width, decode against full forward: 1.5e-3 at one layer, 0.024 at
    four; without the round trip 5.7e-6 and 2.5e-4), and the random-weight
    stack grows such differences with depth (on the CPU at d 1024 and 24
    layers, without the round trip, a 1e-7 relative change of the input
    moves the logits by 0.029).  The reference's decode and full forward
    agree only because XLA computes both alike, bit for bit.  The whole
    depth and the 4 layers with the round trip are reported, not held."""
    cfg = dataclasses.replace(cfg, name=cfg.name + "-f32", dtype="float32")
    if cfg.pattern[0].mixer == "rwkv6":
        cfg = dataclasses.replace(cfg, name=cfg.name.replace(
            "-f32", "-4l-f32"), num_layers=4)
    if cfg.name.startswith("jamba"):
        cfg = dataclasses.replace(
            cfg, name=cfg.name.replace("-4e", "-2e"),
            moe=dataclasses.replace(cfg.moe, num_experts=2))
    elif cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    return cfg


def _family_train(cfg, device="cuda", *, sizes=FAMILY_TRAIN, data=None,
                  routes=None) -> dict:
    """Int4+EF steps of make_dp_train_step at world size 1 (``sizes``:
    batch B x S, steps; ``data``: SyntheticLM's batches by default):
    finite losses, transport launches = buckets x steps.  With the plain
    transport route among ``routes`` (by default for a MoE configuration)
    the same steps on it, and losses and every parameter leaf bitwise equal
    to the kernel route's."""
    data = data or SyntheticLM(cfg.vocab_size, sizes["S"], sizes["B"],
                               seed=SEED)
    steps = sizes["steps"]
    routes = routes or (("auto", "plain") if cfg.moe is not None
                        else ("auto",))
    row, kept = {"config": cfg.name, "params": cfg.param_count()}, {}
    for impl in routes:
        _free()
        policy = CommPolicy(algorithm="nap", mean=True, compress_bits=4,
                            error_feedback=True, transport_impl=impl)
        transport.reset_launch_counts()
        kadamw.reset_launch_counts()
        plan, state, losses, times, _ = _run(cfg, policy, steps,
                                             device=device, data=data)
        counts = dict(transport.LAUNCHES)
        adamw = _adamw_launches(steps, len(plan.signature), device)
        want = (plan.num_buckets * steps
                if impl == "auto" and device != "cpu" else 0)
        if any(c != want for c in counts.values()):
            raise AssertionError(f"{cfg.name} ({impl}): launches {counts} != "
                                 f"{want}")
        if not all(math.isfinite(l) for l in losses):
            raise AssertionError(f"{cfg.name}: non-finite loss {losses}")
        kept[impl] = (losses, [p.detach().clone() for p in
                               state["model"].leaves()] if len(routes) > 1
                      else None)
        row[impl] = {"losses": losses, "step_ms": [t * 1e3 for t in times],
                     "ms_per_step": times[-1] * 1e3,
                     "tokens_per_s": sizes["B"] * sizes["S"] / times[-1],
                     "peak_device_memory_bytes":
                         torch.cuda.max_memory_allocated(),
                     "buckets": plan.num_buckets,
                     "leaves": len(plan.signature), "launches": counts,
                     "adamw_launches": adamw}
        del state
    if len(routes) > 1:
        (la, pa), (lb, pb) = kept["auto"], kept["plain"]
        row["plain_route_bitwise_equal"] = la == lb and all(
            torch.equal(a, b) for a, b in zip(pa, pb))
        if not row["plain_route_bitwise_equal"]:
            raise AssertionError(f"{cfg.name}: kernel route != plain route")
    _free()
    return row


def phase_families(smi, device="cuda") -> dict:
    """Every other decoder-only family at its published widths: serving
    (bf16), float32 decode against the full forward, gemma2's window at
    4,352 tokens, and the int4+EF train step on three of them.  Returns
    the transport kernels' launches on the train steps.  (``device`` is
    for a CPU rehearsal at reduced sizes.)"""
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    for name, cfg in CHIP_FAMILIES.items():
        t0 = time.perf_counter()
        _free()
        gen = torch.Generator(device=device).manual_seed(SEED)
        model = build_model(cfg, generator=gen, device=device)
        param_bytes = sum(p.numel() * p.element_size()
                          for p in model.leaves())
        serve = _family_serve(model)
        del model
        _free()
        cfg32 = _check_config(cfg)
        reported = None
        if cfg32.num_layers != cfg.num_layers:  # rwkv6: reported, not held
            gen = torch.Generator(device=device).manual_seed(SEED)
            model = build_model(dataclasses.replace(cfg, dtype="float32"),
                                generator=gen, device=device)
            reported = {"whole_depth": _decode_vs_full(model, hold=False)}
            del model
            _free()
        gen = torch.Generator(device=device).manual_seed(SEED)
        model = build_model(cfg32, generator=gen, device=device)
        if reported is not None:
            reported["bf16_round_trip_kept"] = _decode_vs_full(model,
                                                               hold=False)
            with _ExactGroupNorm():
                check = _decode_vs_full(model)
        else:
            check = _decode_vs_full(model)
        window = (_gemma2_window(model) if cfg.sliding_window else None)
        check["peak_device_memory_bytes"] = torch.cuda.max_memory_allocated()
        del model
        emit({"phase": "families", "config": name, "layers": cfg.num_layers,
              "dtype": cfg.dtype, "params": cfg.param_count(),
              "param_bytes": param_bytes, "nvidia_smi": smi,
              "serve": serve,
              "decode_vs_full_f32": {"config": cfg32.name,
                                     "experts": getattr(cfg32.moe,
                                                        "num_experts", None),
                                     **check},
              "gemma2_window_f32": window,
              "decode_vs_full_f32_reported_not_held": reported,
              "seconds": time.perf_counter() - t0})
    launches = {k: 0 for k in (*transport.LAUNCHES, *ADAMW_KEYS)}
    for cfg in (CHIP_FAMILIES["gemma2-27b-2l"],
                CHIP_FAMILIES["deepseek-moe-16b-2l"], RWKV6_1_6B_4L):
        t0 = time.perf_counter()
        row = _family_train(cfg, device)
        for k, c in {**row["auto"]["launches"],
                     **row["auto"]["adamw_launches"]}.items():
            launches[k] += c
        emit({"phase": "families_train", "nvidia_smi": smi, **row,
              "seconds": time.perf_counter() - t0})
    _free()
    emit({"phase": "families_done", "phase_s": time.perf_counter() - t_phase,
          "train_launches": launches})
    return launches



# ---------------------------------------------------------------------------
# the training driver (phases trainer and dp_ef)
# ---------------------------------------------------------------------------

# minicpm-2b at its published widths and all 40 layers (MINICPM_2B, bf16,
# remat "full", the reference's default) through launch.train: global
# batch 8 x 512 in microbatches of 2 (n_micro 4), 6 steps, no checkpoint
# in the timed run; the levers at 2 steps each; the resume check at 4
# layers (a 40-layer checkpoint is about 38 GB on disk).
TRAINER = dict(batch=8, seq=512, microbatch=2, steps=6, lever_steps=2,
               resume_steps=6, resume_stop=4, resume_every=3)
# the reference's check_dp_training_ef_convergence at 1 x 1
# (tests/_multidevice_checks.py:902-976): reduced minicpm-2b in float32,
# SyntheticLM(seq 32, global batch 16, seed 3), AdamW at constant lr 1e-2,
# 120 steps of each transport, all nap
DP_EF = dict(seq=32, batch=16, seed=3, steps=120, lr=1e-2)
DP_EF_RUNS = (
    ("base", dict(algorithm="nap", mean=True)),
    ("ef4", dict(algorithm="nap", mean=True, compress_bits=4,
                 error_feedback=True)),
    ("raw4", dict(algorithm="nap", mean=True, compress_bits=4)),
)


def _all_launches() -> dict:
    return {**dict(transport.LAUNCHES), **ops.launch_counts(),
            **dict(kadamw.LAUNCHES)}


def _reset_launches() -> None:
    transport.reset_launch_counts()
    ops.reset_launch_counts()
    kadamw.reset_launch_counts()


def _train_cfg(steps, **kw):
    from repro_torch.configs import TrainConfig

    base = dict(steps=steps, seq_len=TRAINER["seq"],
                global_batch=TRAINER["batch"],
                microbatch=TRAINER["microbatch"], seed=SEED,
                checkpoint_every=0, optimizer=OPT)
    base.update(kw)
    return TrainConfig(**base)


@contextlib.contextmanager
def _kernel_norm_on_a_mesh(mesh, device="cuda"):
    """On a (1, 1) mesh on a card, the norm in AdamW's plain route, the one
    DTensor leaves take, from the kernel that a ``mesh=None`` run takes
    (``kernels.adamw.sq_norm`` over the local shards, each the whole
    tensor at world size 1), since the kernel sums in another order than
    ``torch.sum``.  The kernel's update is bit for bit the plain one given
    the same norm (phase kernels), so a mesh run held bit for bit against
    ``mesh=None``, which runs as it ships, compares the layouts."""
    from repro_torch import tree
    from repro_torch.optim import adamw as optim_adamw

    if mesh is None or device == "cpu":
        yield
        return

    def norm(grads):
        leaves = tree.leaves(grads)
        local = [_local(g) for g in leaves]
        if any(t.shape != g.shape for t, g in zip(local, leaves)):
            raise AssertionError("a shard is not its whole tensor")
        return torch.sqrt(kadamw.sq_norm([t.contiguous() for t in local]))

    real = optim_adamw.global_norm
    optim_adamw.global_norm = norm
    try:
        yield
    finally:
        optim_adamw.global_norm = real


def _trainer_run(cfg, steps, ckpt_dir, device="cuda", mesh=None,
                 **kw) -> dict:
    """``steps`` steps of ``launch.train.build_training`` (on ``mesh``, if
    given): per-step host time (each step ends in the loss's copy to the
    host, after the AdamW update), losses, peak memory and every kernel's
    launches; with ``mesh=None``, AdamW's held to one ``sq_norm`` a step
    and one ``adamw_apply`` a leaf a step."""
    from repro_torch.launch import build_training

    _free()
    _reset_launches()
    loop = build_training(cfg, _train_cfg(steps, **kw), mesh=mesh,
                          ckpt_dir=ckpt_dir, device=device)
    start = loop.start_step
    loop.run(steps)
    launches = _all_launches()
    log = loop.metrics_log
    if mesh is None:
        _adamw_launches(len(log), len(list(loop.state["model"].leaves())),
                        device)
    losses = [m["loss"] for m in log]
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"{cfg.name}: non-finite loss {losses}")
    times = [m["time_s"] for m in log]
    steady = times[1:] or times
    ms = statistics.median(steady) * 1e3
    return {"loop": loop, "start_step": start, "losses": losses,
            "step_ms": [t * 1e3 for t in times],
            "ms_per_step": ms,
            "tokens_per_s": TRAINER["batch"] * TRAINER["seq"] / (ms / 1e3),
            "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
            "launches": launches, "stragglers": len(loop.monitor.events)}


def _summary(run) -> dict:
    return {k: v for k, v in run.items() if k != "loop"}


def _resume_check(cfg, root: Path, device="cuda") -> dict:
    """6 steps straight through against 4 steps with a checkpoint after
    step 3 (keep 1), resumed by a fresh loop to 6: losses, parameters and
    moments bitwise equal, under deterministic algorithms."""
    every, stop, end = (TRAINER["resume_every"], TRAINER["resume_stop"],
                        TRAINER["resume_steps"])
    free_bytes = shutil.disk_usage(root).free
    straight = _trainer_run(cfg, end, root / "straight", device)
    first = _trainer_run(cfg, stop, root / "resume", device,
                         checkpoint_every=every, keep_checkpoints=1)
    writes = list(first["loop"].ckpt.writes)
    first_losses = first["losses"]
    del first
    _free()
    resumed = _trainer_run(cfg, end, root / "resume", device,
                           checkpoint_every=every, keep_checkpoints=1)
    loop, ref = resumed["loop"], straight["loop"]
    writes += loop.ckpt.writes
    start = resumed["start_step"]  # after the checkpoint of step every - 1
    losses = first_losses[:start] + resumed["losses"]
    st, rs = ref.state, loop.state
    params_equal = all(torch.equal(a, b) for a, b in
                       zip(st["model"].leaves(), rs["model"].leaves()))
    moments_equal = all(torch.equal(a, b) for a, b in
                        zip(st["opt"].mu + st["opt"].nu,
                            rs["opt"].mu + rs["opt"].nu))
    out = {"config": cfg.name, "straight_losses": straight["losses"],
           "resumed_losses": losses, "start_step_of_fresh_loop": start,
           "losses_bitwise_equal": (start == every
                                    and losses == straight["losses"]),
           "params_bitwise_equal": params_equal,
           "moments_bitwise_equal": moments_equal,
           "opt_step": [st["opt"].step, rs["opt"].step],
           "checkpoint_writes": writes,
           "disk_free_bytes_before": free_bytes}
    del straight, resumed, loop, ref, st, rs
    _free()
    return out


def _trainer_profile(loop, table="profile_trainer_step.txt") -> dict:
    """One more step of the loop under ``torch.profiler``
    (:func:`_profile`)."""
    return _profile(lambda: loop.run(loop.start_step + 1), table)


def _profile(fn, table) -> dict:
    """``fn()`` under ``torch.profiler``: device busy time by kernel class
    (GEMM / other), the idle share of its wall time and the number of
    kernel launches.  The table goes to ``chiprun_out/<table>``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    rows = [(e.key, _device_us(e) / 1e3, e.count) for e in events
            if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    gemm = sum(ms for name, ms, _ in rows if any(
        k in name.lower() for k in ("gemm", "cutlass", "xmma", "cublas")))
    busy = sum(ms for _, ms, _ in rows)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / table).write_text(
        events.table(sort_by="self_cuda_time_total", row_limit=60))
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "gemm_ms": gemm,
            "idle_share": 1 - busy / wall_ms if busy else None,
            "kernel_launches": sum(c for _, _, c in rows),
            "top_kernels": [[n[:80], ms, c] for n, ms, c in
                            sorted(rows, key=lambda r: -r[1])[:10]]}


def phase_trainer(smi, cfg=MINICPM_2B, resume_cfg=MINICPM_2B_4L,
                  device="cuda") -> dict:
    """minicpm-2b at all 40 layers through ``launch.train.build_training``
    (bf16, remat full, n_micro 4): ms per step, tokens/s, peak memory,
    one more step profiled; remat none / dots / full and bf16_bwd on / off
    at 2 steps each; the resume check at 4 layers.  Of the repository's
    kernels only AdamW's run on this path (the models call none): every
    other count is read and must be 0.
    (``cfg`` / ``resume_cfg`` / ``device`` are for a CPU rehearsal.)"""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_") as tmp:
        tmp = Path(tmp)
        main_run = _trainer_run(cfg, TRAINER["steps"], tmp / "main", device)
        launches = main_run["launches"]
        main = _summary(main_run)
        if device != "cpu":
            main["profile"] = _trainer_profile(main_run["loop"])
        del main_run
        levers = {"remat": {}, "bf16_bwd": {}}
        n = TRAINER["lever_steps"]
        for remat in ("none", "dots", "full"):
            run = _trainer_run(dataclasses.replace(cfg, remat=remat), n,
                               tmp / f"remat_{remat}", device)
            levers["remat"][remat] = {
                "ms_per_step": run["step_ms"][-1],
                "peak_device_memory_bytes": run["peak_device_memory_bytes"],
                "losses": run["losses"]}
            for k, c in run["launches"].items():
                launches[k] += c
            del run
        for on in (True, False):
            run = _trainer_run(dataclasses.replace(cfg, bf16_bwd=on), n,
                               tmp / f"bf16_bwd_{on}", device)
            levers["bf16_bwd"]["on" if on else "off"] = {
                "ms_per_step": run["step_ms"][-1],
                "peak_device_memory_bytes": run["peak_device_memory_bytes"],
                "losses": run["losses"]}
            for k, c in run["launches"].items():
                launches[k] += c
            del run
        _free()
        first_on = levers["bf16_bwd"]["on"]["losses"][0]
        first_off = levers["bf16_bwd"]["off"]["losses"][0]
        levers["bf16_bwd"]["first_loss_rel_diff"] = (
            abs(first_on - first_off) / abs(first_off))
        torch.use_deterministic_algorithms(True)
        try:
            resume = _resume_check(resume_cfg, tmp, device)
        finally:
            torch.use_deterministic_algorithms(False)
    emit({"phase": "trainer", "config": cfg.name, "layers": cfg.num_layers,
          "params": cfg.param_count(), "dtype": cfg.dtype,
          "remat": cfg.remat, "batch": [TRAINER["batch"], TRAINER["seq"]],
          "microbatch": TRAINER["microbatch"], "nvidia_smi": smi,
          "main": main, "levers": levers, "launches": launches,
          "resume": resume, "phase_s": time.perf_counter() - t_phase})
    if any(_without_adamw(launches).values()):
        raise AssertionError(f"a kernel ran on the trainer's path: "
                             f"{launches}")
    if levers["bf16_bwd"]["first_loss_rel_diff"] > 2e-2:
        raise AssertionError("bf16_bwd changed the first loss by more than "
                             "2e-2")
    if not (resume["losses_bitwise_equal"] and resume["params_bitwise_equal"]
            and resume["moments_bitwise_equal"]):
        raise AssertionError("the resumed run differs from the straight run")
    return launches


def _ef_criteria(base, ef4, raw4) -> dict:
    """The reference's five criteria of the convergence check, with the
    numbers they compare."""
    tail = lambda ls: float(np.mean(ls[-10:]))  # noqa: E731
    base, ef4, raw4 = (np.asarray(x) for x in (base, ef4, raw4))
    out = {"base_tail": tail(base), "ef4_tail": tail(ef4),
           "raw4_tail": tail(raw4),
           "gap_ef": abs(tail(ef4) - tail(base)),
           "gap_raw": abs(tail(raw4) - tail(base)),
           "dev_ef": float(np.mean(np.abs(ef4 - base))),
           "dev_raw": float(np.mean(np.abs(raw4 - base)))}
    out["criteria"] = {
        "finite": bool(np.all(np.isfinite(ef4))),
        "learned": bool(out["base_tail"] < base[0] - 0.5),
        "gap_ef": out["gap_ef"] < 0.15 * out["base_tail"],
        "gap_raw": out["gap_raw"] > out["gap_ef"],
        "dev_raw": out["dev_raw"] > 1.4 * out["dev_ef"],
    }
    return out


def phase_dp_ef(smi, device="cuda") -> dict:
    """The reference's DP-training convergence check at 1 x 1 on the card:
    three 120-step trajectories (uncompressed, int4 + EF, raw int4) from
    the port's seeded parameters (drawn on the CPU, as the CPU test draws
    them), the transport on the CUDA kernels; the five criteria held (they
    hold on the CPU at 1 x 1, tests/test_torch_dp_checks.py).  Returns the
    transport kernels' launches on this path: buckets x steps for each
    compressed run, none for the uncompressed one."""
    from repro_torch.models import init_params

    t0 = time.perf_counter()
    cfg = reduced(MINICPM_2B)
    params = init_params(cfg, generator=torch.Generator().manual_seed(SEED),
                         device="cpu")
    data = SyntheticLM(cfg.vocab_size, DP_EF["seq"], DP_EF["batch"],
                       seed=DP_EF["seed"])
    opt = OptimizerConfig(lr=DP_EF["lr"], schedule="constant",
                          warmup_steps=1)
    topo = mesh_topology(1, 1)
    runs, counts, buckets = {}, {}, {}
    launches = {k: 0 for k in (*transport.LAUNCHES, *ADAMW_KEYS)}
    for name, kw in DP_EF_RUNS:
        policy = CommPolicy(**kw)
        step = make_dp_train_step(cfg, opt, topo, policy, device=device)
        state = init_train_state(cfg, opt, policy, params=params,
                                 device=device)
        batches = [data.batch(s, device) for s in range(DP_EF["steps"])]
        _reset_launches()
        losses = []
        for batch in batches:
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        counts[name] = _all_launches()
        buckets[name] = step.plan.num_buckets
        adamw = _adamw_launches(DP_EF["steps"], len(step.plan.signature),
                                device)
        want = (step.plan.num_buckets * DP_EF["steps"]
                if kw.get("compress_bits") and device != "cpu" else 0)
        got = {k: counts[name][k] for k in transport.LAUNCHES}
        if any(c != want for c in got.values()) or any(
                counts[name][k] for k in ops.launch_counts()):
            raise AssertionError(f"dp_ef {name}: launches {counts[name]} != "
                                 f"{want} of each transport kernel")
        for k, c in {**got, **adamw}.items():
            launches[k] += c
        runs[name] = losses
        del state, step
    res = _ef_criteria(runs["base"], runs["ef4"], runs["raw4"])
    emit({"phase": "dp_ef", "config": cfg.name, "grid": [1, 1],
          "nvidia_smi": smi, "steps": DP_EF["steps"], **res,
          "trajectories": runs, "buckets": buckets, "launches": counts,
          "seconds": time.perf_counter() - t0})
    if not all(res["criteria"].values()):
        raise AssertionError(f"dp_ef: criteria {res['criteria']}")
    return launches


# ---------------------------------------------------------------------------
# the encoder-decoder family (phase whisper)
# ---------------------------------------------------------------------------

# whisper-tiny whole (src/repro/configs/archs.py:191-210): 4 encoder and 4
# decoder layers, d 384, 6 heads, d_ff 1536, vocab 51,865, bf16.  The
# encoder context is whisper's published 1500 frames (30 s of audio) and
# the text context its 448 positions (arXiv:2212.04356).  Serving: 8 slots
# x 448, family_traffic's 6 requests, each with its own seeded frames.
# Training: batch 8 x 448, 1500 frames a row, 2 int4+EF DP steps at world
# size 1, then 2 steps of make_train_step at n_micro 2.
WHISPER = dict(frames=1500, max_len=448, slots=8, B=8, S=448, steps=2,
               n_micro=2)


def _frames(n, d, seed, device, rows=1) -> torch.Tensor:
    """Seeded encoder frames (rows, n, d), float32, scale 0.5."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((rows, n, d), generator=g, device=device) * 0.5


class _WithFrames:
    """``SyntheticLM`` batches with seeded frames (B, n, d) added (the
    reference's data source yields none)."""

    def __init__(self, data, n, d):
        self.data, self.n, self.d = data, n, d

    def batch(self, step, device):
        b = self.data.batch(step, device)
        b["frames"] = _frames(self.n, self.d, SEED + 1000 + step, device,
                              rows=self.data.global_batch)
        return b


def phase_whisper(smi) -> dict:
    """whisper-tiny served and trained end to end: continuous batching
    bitwise equal to serial, no kernel launched, a router losing a replica;
    float32 decode against the full forward; int4+EF DP steps on the
    transport kernels (launches = buckets x steps), bitwise equal to the
    same steps on the plain transport, and make_train_step at n_micro 2.
    Returns the transport kernels' launches on the kernel route's DP
    steps."""
    from repro_torch.configs import WHISPER_TINY
    from repro_torch.launch import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.serve import ServeEngine

    cfg, sizes, device = WHISPER_TINY, WHISPER, "cuda"
    n, D = sizes["frames"], cfg.d_model
    t_phase = time.perf_counter()
    _free()
    gen = torch.Generator(device=device).manual_seed(SEED)
    model = build_model(cfg, generator=gen, device=device)
    param_bytes = sum(p.numel() * p.element_size() for p in model.leaves())
    traffic = family_traffic(cfg.vocab_size)
    extras = [{"frames": _frames(n, D, SEED + i, device)}
              for i in range(len(traffic))]
    template = {"frames": torch.empty((1, n, D), device="meta")}
    make = lambda: ServeEngine(model, num_slots=sizes["slots"],
                               max_len=sizes["max_len"],
                               extras_template=template, device=device)

    # the serving path: counters zeroed just before, read just after
    transport.reset_launch_counts()
    ops.reset_launch_counts()
    engine = make()
    t0 = time.perf_counter()
    cont, prefills = serve_continuous(engine, traffic, torch.cuda.synchronize,
                                      first=FAMILY_SERVE["first"],
                                      extras=extras)
    cont_s = time.perf_counter() - t0
    launches = {**dict(transport.LAUNCHES), **ops.launch_counts()}
    steps = engine.fit_rows()
    del engine
    peak_serve = torch.cuda.max_memory_allocated()
    serial = serve_serial(make(), traffic, extras)
    equal = [a == b for a, b in zip(cont, serial)]
    if not all(equal):
        raise AssertionError("whisper: continuous != serial for requests "
                             f"{[i for i, e in enumerate(equal) if not e]}")
    if any(launches.values()):
        raise AssertionError(f"whisper: a kernel launched on the serving "
                             f"path: {launches}")
    router = serve_router_resume(model, device, traffic, serial, make=make,
                                 extras=extras)
    encoder_ms = []
    for x in extras:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.init_decode(1, sizes["max_len"], batch=x)
        torch.cuda.synchronize()
        encoder_ms.append((time.perf_counter() - t0) * 1e3)
    decode_ms = [sec * 1e3 for _, sec, _ in steps]
    generated = sum(len(t) for t in cont)
    serve = {
        "requests": len(traffic), "frames_per_request": n,
        "slots": sizes["slots"], "max_len": sizes["max_len"],
        "prompt_tokens": sum(len(p) for p, _ in traffic),
        "generated_tokens": generated, "continuous_s": cont_s,
        "decode_steps": len(steps),
        "decode_ms_per_step_median": statistics.median(decode_ms),
        "decode_ms_per_step_min": min(decode_ms),
        "decode_tokens_per_s": generated / (sum(decode_ms) / 1e3),
        "prefill_ms_per_prompt_token": sum(sec for _, sec in prefills)
        * 1e3 / sum(k for k, _ in prefills),
        "encoder_ms_per_request_median": statistics.median(encoder_ms),
        "encoder_ms_per_request": encoder_ms,
        "peak_device_memory_bytes": peak_serve,
        "continuous_equals_serial": True, "router": router,
        "kernel_launches_on_this_path": launches,
    }
    del model
    _free()

    # float32 (TF32 off): teacher-forced decode against the full forward
    cfg32 = dataclasses.replace(cfg, name=cfg.name + "-f32", dtype="float32")
    gen = torch.Generator(device=device).manual_seed(SEED)
    model = build_model(cfg32, generator=gen, device=device)
    check = _decode_vs_full(model, extras={"frames": _frames(
        n, D, SEED + 500, device, rows=FAMILY_CHECK["B"])})
    check["frames"] = n
    check["peak_device_memory_bytes"] = torch.cuda.max_memory_allocated()
    del model
    _free()

    # training: int4+EF DP steps on the transport kernels (counters zeroed
    # just before, read just after) and on the plain transport, bitwise
    # equal; then the microbatched train step
    data = _WithFrames(SyntheticLM(cfg.vocab_size, sizes["S"], sizes["B"],
                                   seed=SEED), n, D)
    steps_n = sizes["steps"]
    dp = _family_train(cfg, device, sizes=sizes, data=data,
                       routes=("auto", "plain"))
    gen = torch.Generator(device=device).manual_seed(SEED)
    model = build_model(cfg, generator=gen, device=device)
    step = make_train_step(model, OPT, n_micro=sizes["n_micro"],
                           device=device)
    tstate = {"model": model, "opt": adamw_init(model.params())}
    t_losses, t_times = [], []
    kadamw.reset_launch_counts()
    for s_ in range(steps_n):
        batch = data.batch(s_, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tstate, m = step(tstate, batch)
        t_losses.append(float(m["loss"]))
        t_times.append(time.perf_counter() - t0)
    if not all(math.isfinite(l) for l in t_losses):
        raise AssertionError(f"whisper: non-finite loss {t_losses}")
    micro = {"n_micro": sizes["n_micro"], "losses": t_losses,
             "adamw_launches": _adamw_launches(
                 steps_n, len(list(model.leaves())), device),
             "step_ms": [t * 1e3 for t in t_times],
             "ms_per_step": t_times[-1] * 1e3,
             "peak_device_memory_bytes": torch.cuda.max_memory_allocated()}
    del tstate, model
    _free()
    emit({"phase": "whisper", "config": cfg.name,
          "encoder_layers": cfg.encoder_layers, "layers": cfg.num_layers,
          "dtype": cfg.dtype, "params": cfg.param_count(),
          "param_bytes": param_bytes, "nvidia_smi": smi, "serve": serve,
          "decode_vs_full_f32": check,
          "train": {"batch": [sizes["B"], sizes["S"]], "frames": n,
                    "dp_int4_ef": dp, "make_train_step": micro},
          "phase_s": time.perf_counter() - t_phase})
    return {**dp["auto"]["launches"],
            **{k: dp["auto"]["adamw_launches"][k]
               + micro["adamw_launches"][k] for k in ADAMW_KEYS}}


# ---------------------------------------------------------------------------
# the FSDP x TP layout on a mesh (phase mesh)
# ---------------------------------------------------------------------------

# minicpm-2b at its published widths, depth cut to 4 layers as phase train
# cuts it (MINICPM_2B_4L), bf16: build_training at 8 x 512 in microbatches
# of 2, 2 steps, on a (1, 1) ("data", "model") mesh and with mesh=None; the
# gradient sync on a (1, 1) ("pod", "data") mesh at int4 and int8.
MESH = dict(batch=8, seq=512, microbatch=2, steps=2, bits=(4, 8))


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _mesh_grad_sync(model, batch, device) -> dict:
    """``make_grad_sync`` on a (1, 1) ``("pod", "data")`` mesh over the
    gradient tree of one step as DTensors: per width, each transport
    kernel's launches against the plan's compressed buckets, and the
    result bitwise equal to the plain transport's and to
    ``sync_with_context`` on the local tensors."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch import tree
    from repro_torch.core import CommContext, grad_sync
    from repro_torch.launch import make_mesh, mesh_topology

    mesh = make_mesh((1, 1), ("pod", "data"))
    dm = mesh.device_mesh(device)
    params = model.params()
    leaves, td = tree.flatten(params)
    with model.policy.scope():
        loss, _ = model(batch)
        grads = torch.autograd.grad(loss, leaves)
    local = [_local(g).detach() for g in grads]
    del grads, loss
    dgrads = tree.unflatten(td, [
        DTensor.from_local(g, dm, [Replicate(), Replicate()],
                           run_check=False) for g in local])
    specs = tree.unflatten(td, [()] * len(local))
    out = {}
    for bits in MESH["bits"]:
        runs = {}
        for route in ("auto", "plain"):
            policy = CommPolicy(algorithm="nap", mean=True,
                                compress_bits=bits, transport_impl=route)
            sync = grad_sync.make_grad_sync(
                policy, mesh, data_axes=("pod", "data"), grad_specs=specs,
                device=device)
            _reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = sync(dgrads)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = _all_launches()
            runs[route] = (tree.leaves(res), launches, ms, sync.plan)
        got, launches, ms, plan = runs["auto"]
        plain, plain_launches, plain_ms, _ = runs["plain"]
        ctx = CommContext(mesh_topology(1, 1),
                          CommPolicy(algorithm="nap", mean=True,
                                     compress_bits=bits))
        direct = tree.leaves(grad_sync.sync_with_context(
            tree.unflatten(td, local), ctx))
        buckets = len(plan.buckets)
        want = buckets if device != "cpu" else 0
        row = {
            "buckets": buckets, "ms": ms, "plain_ms": plain_ms,
            "launches": {k: launches[k] for k in
                         ("quantize_pack", "unpack_dequantize")},
            "plain_launches": {k: plain_launches[k] for k in
                               ("quantize_pack", "unpack_dequantize")},
            "bitwise_equal_plain": all(
                torch.equal(_local(a), _local(b)) for a, b in
                zip(got, plain)),
            "bitwise_equal_sync_with_context": all(
                torch.equal(_local(a), b) for a, b in zip(got, direct)),
            "dtensor_out": all(isinstance(a, DTensor) for a in got),
        }
        out[f"int{bits}"] = row
        if not (row["bitwise_equal_plain"]
                and row["bitwise_equal_sync_with_context"]
                and row["dtensor_out"]):
            raise AssertionError(f"make_grad_sync int{bits}: {row}")
        if any(v != want for v in row["launches"].values()) or any(
                row["plain_launches"].values()):
            raise AssertionError(
                f"make_grad_sync int{bits}: launches {row['launches']} "
                f"(plain {row['plain_launches']}) for {buckets} buckets")
    return out


def phase_mesh(smi, cfg=MINICPM_2B_4L, device="cuda", sizes=MESH) -> dict:
    """The FSDP x TP layout on DTensor at world size 1: ``torch.distributed``
    on NCCL (gloo for a CPU rehearsal), one process, ``tcp://localhost``.
    ``build_training`` on a (1, 1) ``("data", "model")`` mesh and with
    ``mesh=None`` from the same seed (that one first, freed before the
    other), 2 steps each: losses and every parameter bitwise equal (each
    shard is the whole tensor); the second step's ms, peak memory, and one
    more step of each under the profiler (launches, device busy, idle
    share).  Then ``make_grad_sync``
    (:func:`_mesh_grad_sync`).  The process group is destroyed at the end,
    so later phases run as before."""
    import torch.distributed as dist

    from repro_torch.launch import make_mesh

    t_phase = time.perf_counter()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if device != "cpu":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo" if device == "cpu" else "nccl",
        init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1)
    try:
        kw = dict(seq_len=sizes["seq"], global_batch=sizes["batch"],
                  microbatch=sizes["microbatch"])
        steps = sizes["steps"]
        mesh = make_mesh((1, 1), ("data", "model"))
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
            tmp = Path(tmp)
            runs = {}
            # mesh=None first, freed before the mesh run (each peak is its
            # own run's); the parameters are compared on the host
            for name, m in (("plain", None), ("mesh", mesh)):
                with _kernel_norm_on_a_mesh(m, device):
                    run = _trainer_run(cfg, steps, tmp / name, device,
                                       mesh=m, **kw)
                loop = run["loop"]
                params = [_local(p).detach().cpu()
                          for p in loop.state["model"].leaves()]
                summary = {
                    "losses": run["losses"], "step_ms": run["step_ms"],
                    "ms_per_step": run["step_ms"][-1],
                    "peak_device_memory_bytes":
                        run["peak_device_memory_bytes"],
                    "launches": run["launches"]}
                if device != "cpu":
                    summary["profile"] = _trainer_profile(
                        loop, table=f"profile_mesh_{name}_step.txt")
                runs[name] = (summary, params, loop if m else None)
                del run, loop
            mesh_run, mesh_params, mesh_loop = runs["mesh"]
            plain_run, plain_params, _ = runs["plain"]
            bitwise = {
                "losses": mesh_run["losses"] == plain_run["losses"],
                "params": all(torch.equal(a, b) for a, b in
                              zip(mesh_params, plain_params)),
            }
            model = mesh_loop.state["model"]
            data = SyntheticLM(cfg.vocab_size, sizes["seq"], sizes["batch"],
                               seed=SEED, mesh=mesh, batch_axes=("data",))
            sync = _mesh_grad_sync(model, data.batch(0, device), device)
            del runs, mesh_loop, model, mesh_params, plain_params
            _free()
    finally:
        dist.destroy_process_group()
    emit({"phase": "mesh", "config": cfg.name, "layers": cfg.num_layers,
          "dtype": cfg.dtype, "world": 1,
          "mesh": {"train": [[1, 1], ["data", "model"]],
                   "grad_sync": [[1, 1], ["pod", "data"]]},
          "batch": [sizes["batch"], sizes["seq"]],
          "microbatch": sizes["microbatch"], "steps": steps,
          "nvidia_smi": smi, "train": {"mesh": mesh_run,
                                       "plain": plain_run},
          "bitwise_equal": bitwise, "grad_sync": sync,
          "phase_s": time.perf_counter() - t_phase})
    if not all(bitwise.values()):
        raise AssertionError(f"the mesh run differs from mesh=None: "
                             f"{bitwise}")
    if any(_without_adamw(mesh_run["launches"]).values()) or any(
            _without_adamw(plain_run["launches"]).values()):
        raise AssertionError("a kernel ran on the trainer's path")
    on = int(device != "cpu")
    # AdamW: the kernels with mesh=None; its norm kernel alone on the mesh
    if {k: mesh_run["launches"][k] for k in ADAMW_KEYS} != {
            "sq_norm": steps * on, "adamw_apply": 0}:
        raise AssertionError(f"AdamW on the mesh launched "
                             f"{mesh_run['launches']}")
    return {**{k: sum(r["launches"][k] for r in sync.values())
               for k in ("quantize_pack", "unpack_dequantize")},
            **{k: plain_run["launches"][k] for k in ADAMW_KEYS}}


# ---------------------------------------------------------------------------
# serving and MoE on a mesh (phase mesh_serve)
# ---------------------------------------------------------------------------

# minicpm-2b at its published widths, 8 of its 40 layers as phase serve
# cuts it (MINICPM_2B_8L), bf16: 8 rows of 128 seeded prompt tokens and 64
# greedy steps, with mesh=None, on the train layout and on serve2d of a
# (1, 1) ("data", "model") mesh; deepseek-moe-16b at 2 layers as phase
# families cuts it: 2 build_training steps at 2 x 512 on the mesh and with
# mesh=None, decode (8 rows, 16 prompt tokens, 16 steps) on serve2d and
# with mesh=None, and _route_ep on the mesh's one-rank model group over
# 2 x 512 tokens against the local route at its capacity.
MESH_SERVE = dict(rows=8, prompt=128, steps=64, moe_prompt=16, moe_steps=16,
                  train_batch=2, train_seq=512)


def _whole(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _mesh_decode(model, prompts, steps, table) -> dict:
    """``make_prefill_step``'s logits of the last prompt position, the
    teacher-forced prompt through the cached decode and its last
    position's ``decode_step`` logits, ``steps`` greedy tokens through
    ``make_serve_step`` (each step timed between synchronisations), then
    one more step under the profiler (:func:`_profile`)."""
    from repro_torch.launch import make_prefill_step, make_serve_step

    B, P = prompts.shape
    dev = prompts.device
    out = {"prefill": _whole(make_prefill_step(model, tail=1, device=dev)(
        {"tokens": prompts}))}
    cache = model.init_decode(B, P + steps + 1)
    for t in range(P - 1):
        _, cache = model.decode_hidden(cache, prompts[:, t:t + 1])
    logits, cache = model.decode_step(cache, prompts[:, P - 1:])
    out["logits"] = _whole(logits)
    tok = torch.argmax(out["logits"][:, -1], dim=-1)[:, None]
    step = make_serve_step(model, device=dev)
    toks, ms = [tok], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, cache = step(cache, tok)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        toks.append(tok)
    out["tokens"] = torch.cat(toks, dim=1)
    out["ms"] = ms
    out["profile"] = _profile(lambda: step(cache, tok), table)
    return out


def _same(a: dict, b: dict) -> dict:
    return {k: bool(torch.equal(a[k], b[k]))
            for k in ("prefill", "logits", "tokens")}


def _decode_row(run) -> dict:
    return {"decode_ms_per_step_median": statistics.median(run["ms"]),
            "decode_ms_per_step_min": min(run["ms"]),
            "profile_decode_step": run["profile"],
            "peak_device_memory_bytes": run["peak_device_memory_bytes"],
            "finite": bool(torch.isfinite(run["logits"]).all()
                           and torch.isfinite(run["prefill"]).all())}


def _route_ep_one_rank(model, mesh, device, tokens: int) -> dict:
    """``moe._route_ep`` on the mesh's one-rank model group at the
    model's widths (its first layer's experts and router, ``tokens``
    seeded hidden states) against ``moe._route_local`` at the
    expert-parallel route's own capacity: bitwise equal, and timed; at the
    config's capacity factor and at 1.0, where tokens drop."""
    from repro_torch.models import moe as tmoe

    cfg, m = model.cfg, model.cfg.moe
    ffn = {k: v[0].detach() for k, v in
           model.params()["stack"]["sub0"]["ffn"].items()
           if not isinstance(v, dict)}
    gen = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn((tokens, cfg.d_model), generator=gen, device=device,
                    dtype=torch.float32).to(ffn["we_gate"].dtype)
    gate, idx, _, _ = tmoe._router(ffn["w_router"], x[None], m)
    gate, idx = gate[0], idx[0]
    w = [ffn[k] for k in ("we_gate", "we_up", "we_down")]
    group = mesh.device_mesh(device).get_group("model")
    out = {"tokens": tokens, "experts": m.num_experts, "top_k": m.top_k}
    for cf in (m.capacity_factor, 1.0):
        cap_e = tmoe._capacity(tmoe._capacity(tokens, m.top_k, 1, cf), 1,
                               m.num_experts, cf)
        timed = {}
        with torch.no_grad():
            for name, fn in (
                    ("ep", lambda: tmoe._route_ep(
                        x, idx, gate, *w, group=group, cap_factor=cf,
                        act=cfg.act)),
                    ("local", lambda: tmoe._route_local(
                        x, idx, gate, *w, cap_factor=cf, act=cfg.act,
                        cap=cap_e))):
                y = fn()  # warm
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    y = fn()
                torch.cuda.synchronize()
                timed[name] = (y, (time.perf_counter() - t0) / 5 * 1e3)
            _, keep = tmoe._bucket_positions(idx.reshape(-1),
                                             m.num_experts, cap_e)
        out[f"cf{cf}"] = {
            "capacity": cap_e, "dropped_items": int((~keep).sum()),
            "ep_ms": timed["ep"][1], "local_ms": timed["local"][1],
            "bitwise_equal_local": bool(torch.equal(timed["ep"][0],
                                                    timed["local"][0]))}
    return out


def phase_mesh_serve(smi, device="cuda", cfg=MINICPM_2B_8L,
                     moe_cfg=CHIP_FAMILIES["deepseek-moe-16b-2l"],
                     sizes=MESH_SERVE) -> dict:
    """Serving and MoE on a mesh at world size 1 (``torch.distributed`` on
    NCCL, gloo for a CPU rehearsal; one process, ``tcp://localhost``): the
    cached decode and the prefill under the ``ShardingPolicy`` of a (1, 1)
    ``("data", "model")`` mesh in both modes, bitwise equal to
    ``mesh=None`` (every shard is the whole tensor), with each layout's
    decode ms a step, launches, device busy / idle share of one profiled
    step and peak memory; then deepseek-moe's training and ``serve2d``
    decode against ``mesh=None`` and its expert-parallel route at one rank
    (:func:`_route_ep_one_rank`).  The five kernels' launches on these
    paths are counted (0: no model calls a kernel).  The process group is
    destroyed at the end."""
    import torch.distributed as dist

    from repro_torch.launch import make_mesh, make_policy
    from repro_torch.models import build_model, init_params

    t_phase = time.perf_counter()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if device != "cpu":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo" if device == "cpu" else "nccl",
        init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        layouts = (("plain", None, "train"), ("train", mesh, "train"),
                   ("serve2d", mesh, "serve2d"))

        def decode_runs(c, names, rows, prompt, steps, tag):
            gen = torch.Generator(device=device).manual_seed(SEED)
            params = init_params(c, generator=gen, device=device)
            prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
                0, c.vocab_size, (rows, prompt))).to(device)
            runs = {}
            for name, m, mode in layouts:
                if name not in names:
                    continue
                _free()
                model = build_model(c, params, device=device,
                                    policy=make_policy(c, m, mode=mode,
                                                       device=device))
                runs[name] = _mesh_decode(
                    model, prompts, steps,
                    f"profile_mesh_serve_{tag}_{name}_step.txt")
                runs[name]["peak_device_memory_bytes"] = (
                    torch.cuda.max_memory_allocated())
                del model
            del params
            return runs

        # the main path: counters zeroed just before, read just after
        _reset_launches()
        runs = decode_runs(cfg, ("plain", "train", "serve2d"),
                           sizes["rows"], sizes["prompt"], sizes["steps"],
                           "minicpm")
        launches = _all_launches()
        bitwise = {name: _same(runs[name], runs["plain"])
                   for name in ("train", "serve2d")}
        minicpm = {name: _decode_row(run) for name, run in runs.items()}
        del runs

        # deepseek-moe: training on the mesh, decode on serve2d
        _reset_launches()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_moe_") as tmp:
            train, params = {}, {}
            for name, m in (("plain", None), ("mesh", mesh)):
                with _kernel_norm_on_a_mesh(m, device):
                    run = _trainer_run(moe_cfg, 2, Path(tmp) / name, device,
                                       mesh=m, seq_len=sizes["train_seq"],
                                       global_batch=sizes["train_batch"],
                                       microbatch=sizes["train_batch"])
                params[name] = [_local(p).detach().cpu() for p in
                                run["loop"].state["model"].leaves()]
                train[name] = {k: run[k] for k in (
                    "losses", "step_ms", "peak_device_memory_bytes",
                    "launches")}
                del run
                _free()
        moe_bitwise = {
            "train_losses": train["mesh"]["losses"]
            == train["plain"]["losses"],
            "train_params": all(torch.equal(a, b) for a, b in
                                zip(params["mesh"], params["plain"]))}
        del params
        moe_runs = decode_runs(moe_cfg, ("plain", "serve2d"), sizes["rows"],
                               sizes["moe_prompt"], sizes["moe_steps"],
                               "deepseek")
        moe_bitwise["serve2d_decode"] = _same(moe_runs["serve2d"],
                                              moe_runs["plain"])
        moe_decode = {name: _decode_row(run) for name, run in
                      moe_runs.items()}
        del moe_runs
        moe_launches = _all_launches()
        _free()
        gen = torch.Generator(device=device).manual_seed(SEED)
        model = build_model(moe_cfg, generator=gen, device=device)
        route = _route_ep_one_rank(model, mesh, device,
                                   sizes["train_batch"] * sizes["train_seq"])
        del model
        _free()
    finally:
        dist.destroy_process_group()
    emit({"phase": "mesh_serve", "world": 1,
          "mesh": [[1, 1], ["data", "model"]], "nvidia_smi": smi,
          "minicpm": {"config": cfg.name, "layers": cfg.num_layers,
                      "dtype": cfg.dtype, "rows": sizes["rows"],
                      "prompt": sizes["prompt"], "steps": sizes["steps"],
                      "layouts": minicpm, "bitwise_equal_plain": bitwise},
          "deepseek": {"config": moe_cfg.name, "layers": moe_cfg.num_layers,
                       "dtype": moe_cfg.dtype,
                       "train": {"batch": [sizes["train_batch"],
                                           sizes["train_seq"]], **train},
                       "decode": {"rows": sizes["rows"],
                                  "prompt": sizes["moe_prompt"],
                                  "steps": sizes["moe_steps"],
                                  "layouts": moe_decode},
                       "bitwise_equal_plain": moe_bitwise,
                       "route_ep_one_rank": route},
          "kernel_launches_on_this_path": {"minicpm": launches,
                                           "deepseek": moe_launches},
          "phase_s": time.perf_counter() - t_phase})
    bad = [f"{name} {k}" for name, row in bitwise.items()
           for k, ok in row.items() if not ok]
    bad += [k for k, ok in moe_bitwise.items()
            if not (all(ok.values()) if isinstance(ok, dict) else ok)]
    bad += [f"{name} not finite" for name, row in
            {**minicpm, **moe_decode}.items() if not row["finite"]]
    bad += [f"route_ep != the local route at one rank, {k}"
            for k, row in route.items()
            if isinstance(row, dict) and not row["bitwise_equal_local"]]
    if not route["cf1.0"]["dropped_items"]:
        bad.append("route_ep at capacity factor 1.0 dropped nothing")
    if bad:
        raise AssertionError(f"phase mesh_serve: {bad}")
    if any(launches.values()) or any(_without_adamw(moe_launches).values()):
        raise AssertionError("a kernel ran on the mesh serving path")
    # AdamW in deepseek's training, 2 steps: the kernels with mesh=None
    # (held by _trainer_run), its norm kernel alone on the mesh (the last
    # run before the decode's, counters zeroed at each run's start)
    want = {"sq_norm": 2 * int(device != "cpu"), "adamw_apply": 0}
    if {k: moe_launches[k] for k in ADAMW_KEYS} != want:
        raise AssertionError(f"AdamW in deepseek's training on the mesh "
                             f"launched {moe_launches}, not {want}")
    return {**launches, **{k: train["plain"]["launches"][k]
                           for k in ADAMW_KEYS}}


# ---------------------------------------------------------------------------
# the dry run and the op counter (phase dryrun)
# ---------------------------------------------------------------------------

# (arch, shape, multi-pod, --opts): each traced on meta in its own process
# and fake world of 256 / 512 ranks (repro_torch.launch.dryrun)
DRYRUN_CELLS = (("whisper-tiny", "train_4k", False, ""),
                ("minicpm-2b", "decode_32k", False, "serve2d=1"),
                ("deepseek-moe-16b", "train_4k", True, ""))
# the counted train step: phase mesh's (8 x 512 in microbatches of 2)
DRYRUN_COUNT = dict(batch=8, seq=512, microbatch=2, steps=3)


def _dryrun_start() -> list:
    """The dry run's cells, one ``python -m repro_torch.launch.dryrun``
    process each (no card: ``CUDA_VISIBLE_DEVICES`` empty), all at once."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = []
    for arch, shape, multi, opts in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--tag", "chip", "--force"]
        cmd += ["--multi-pod"] if multi else []
        cmd += ["--opts", opts] if opts else []
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    return procs


def _dryrun_finish(procs) -> list:
    """Each cell's record; fails if a process fails or a record is not
    ``ok``.  Every process is ended on the way out."""
    recs = []
    try:
        for (arch, shape, multi, opts), p in zip(DRYRUN_CELLS, procs):
            out, err = p.communicate(timeout=600)
            name = f"{arch} {shape} {'pod2x16x16' if multi else 'pod16x16'}"
            try:
                rec = json.loads(out[out.index("{"):])
            except ValueError:
                raise AssertionError(f"dry run {name}: no record "
                                     f"(rc {p.returncode}):\n{err[-3000:]}")
            if p.returncode or not rec.get("ok"):
                raise AssertionError(f"dry run {name} failed: "
                                     f"{rec.get('error')}\n"
                                     f"{rec.get('traceback', err[-3000:])}")
            roof = rec["roofline"]
            recs.append({"cell": name, "opts": opts, "ok": rec["ok"],
                         "n_micro": rec.get("n_micro"),
                         "trace_s": rec["trace_s"],
                         **{k: roof[k] for k in (
                             "compute_s", "memory_s", "collective_s",
                             "dominant", "memory_kernel_s",
                             "flops_per_chip", "bytes_per_chip",
                             "collective_bytes_per_chip",
                             "model_flops_per_chip")},
                         "memory": rec["memory"]})
    finally:
        _stop(procs)
    return recs


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _count_model(cfg, device, sizes):
    """The step ``build_training``'s loop runs (``make_train_step`` at
    n_micro batch / microbatch, mesh=None) on a fresh model from the
    seed, with its state and first batch; on ``meta`` shapes only."""
    from repro_torch.launch import make_train_step
    from repro_torch.models import Model, build_model, init_params
    from repro_torch.optim import adamw_init

    if device == "meta":
        model = Model(cfg, init_params(cfg, device="meta"))
    else:
        gen = torch.Generator(device=device).manual_seed(SEED)
        model = build_model(cfg, generator=gen, device=device)
    step = make_train_step(model, OPT,
                           n_micro=sizes["batch"] // sizes["microbatch"],
                           device=device)
    data = SyntheticLM(cfg.vocab_size, sizes["seq"], sizes["batch"],
                       seed=SEED)
    batch = data.batch(0, "cpu")
    batch = {k: (torch.empty_like(v, device="meta") if device == "meta"
                 else v.to(device)) for k, v in batch.items()}
    return step, {"model": model, "opt": adamw_init(model.params())}, batch


def _stats_row(st) -> dict:
    return {"flops": st.flops, "bytes": st.memory_bytes,
            "collective_bytes": st.collective_bytes,
            "collectives": st.collectives, "dots": st.dots,
            "flops_by_dtype": st.flops_by_dtype,
            "kernel_launches": st.kernel_launches}


def _dp_route_count(cfg, route: str, device) -> tuple:
    """One traced int4+EF step of phase train's DP step (8 x 512, world
    size 1) on ``route`` (``auto``: the CUDA kernels; ``plain``):
    ``(stats, trace, buckets, kernel counters, loss)``."""
    from repro_torch.launch.trace_analysis import analyze_trace, trace_call

    policy = CommPolicy(algorithm="nap", mean=True, compress_bits=4,
                        error_feedback=True, transport_impl=route)
    step = make_dp_train_step(cfg, OPT, mesh_topology(1, 1), policy,
                              device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    state = init_train_state(cfg, OPT, policy, generator=gen, device=device)
    batch = SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=SEED).batch(
        0, device)
    transport.reset_launch_counts()
    kadamw.reset_launch_counts()
    (state, m), trace = trace_call(step, state, batch)
    torch.cuda.synchronize()
    # AdamW on its kernels on both of the transport's routes
    launches = {**dict(transport.LAUNCHES), **_adamw_launches(
        1, len(step.plan.signature), device)}
    loss = float(m["loss"])
    del state
    _free()
    return analyze_trace(trace), trace, step.plan.num_buckets, launches, loss


def phase_dryrun(smi, cfg=MINICPM_2B_4L, device="cuda",
                 sizes=DRYRUN_COUNT) -> dict:
    """The dry run and the op counter (``repro_torch.launch.dryrun``,
    ``trace_analysis``, ``roofline``, ``analysis.trace_lint``).

    1. The train step ``build_training`` runs on minicpm-2b-4l (phase
       mesh's 8 x 512 in microbatches of 2, ``mesh=None``), uncounted: ms
       a step (the median of steps 2..3) and one step under the profiler
       (device busy).
    2. The dry run's three cells start, each in its own process and fake
       world on ``meta`` (:data:`DRYRUN_CELLS`).
    3. Meanwhile the same step counted on the card and on ``meta``: flops,
       bytes and collectives equal, and the counted step's loss bitwise
       equal to the uncounted one's first step; the roofline's terms with
       the H100's constants, each beside the measured ms and busy ms.
    4. Phase train's int4+EF DP step counted on the kernel route and on
       the plain route: the same flops and bytes, two transport launches
       per compressed bucket at one rank (``lint_collective_counts``: the
       quantize round trip; four on more ranks) matching the kernels'
       own counters, ``lint_compressed_wire`` clean.
    5. The cells' records: each ``ok``; roofline terms, dominant term,
       trace seconds printed.

    A CPU rehearsal (``device="cpu"``, a reduced ``cfg`` and ``sizes``,
    ``torch.cuda``'s synchronize and memory calls stubbed) skips the
    profile and the kernel route's own counters."""
    from repro_torch.analysis import trace_lint as tl
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.trace_analysis import analyze_trace, trace_call

    t_phase = time.perf_counter()
    # 1. uncounted, timed
    _free()
    step, state, batch = _count_model(cfg, device, sizes)
    times, losses = [], []
    for _ in range(sizes["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))  # the loss's copy ends the step
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times[1:]) * 1e3
    prof = (_profile(lambda: step(state, batch), "profile_dryrun_step.txt")
            if device != "cpu" else {"device_busy_ms": None,
                                     "kernel_launches": None})
    del step, state
    _free()
    procs = _dryrun_start()
    try:
        # 3. the same first step, counted on the card and on meta
        step, state, batch = _count_model(cfg, device, sizes)
        (state, m), card_trace = trace_call(step, state, batch)
        counted_loss = float(m["loss"])
        del step, state, batch, m
        _free()
        step, state, batch = _count_model(cfg, "meta", sizes)
        _, meta_trace = trace_call(step, state, batch)
        del step, state, batch
        card, meta = analyze_trace(card_trace), analyze_trace(meta_trace)
        roof = rl.analyze(card, 1, rl.model_flops(cfg, _shape_of(sizes)))
        largest = max(roof.compute_s, roof.memory_s, roof.collective_s)
        counter = {
            "config": cfg.name, "batch": [sizes["batch"], sizes["seq"]],
            "microbatch": sizes["microbatch"], "card": _stats_row(card),
            "meta_equal": _stats_row(card) == _stats_row(meta),
            "loss_uncounted": losses[0], "loss_counted": counted_loss,
            "loss_bitwise": counted_loss == losses[0],
            "compute_s": roof.compute_s, "memory_s": roof.memory_s,
            "memory_kernel_s": roof.memory_kernel_s,
            "collective_s": roof.collective_s, "dominant": roof.dominant,
            "model_flops": roof.model_flops_per_chip,
            "useful_flops_ratio": roof.useful_flops_ratio,
            "peak_bytes_counted": card_trace.peak_bytes,
            "ms_per_step": ms, "step_ms": [t * 1e3 for t in times],
            "device_busy_ms": prof["device_busy_ms"],
            "kernel_launches_profiled": prof["kernel_launches"],
            "largest_term_over_ms": largest * 1e3 / ms,
            "largest_term_over_busy": (
                largest * 1e3 / prof["device_busy_ms"]
                if prof["device_busy_ms"] else None),
        }
        del card_trace, meta_trace
        # 4. the transport's two routes
        routes = {}
        for route in ("auto", "plain"):
            st, trace, buckets, launches, loss = _dp_route_count(
                cfg, route, device)
            routes[route] = {
                "flops": st.flops, "bytes": st.memory_bytes,
                "events": st.kernel_launches, "kernel_counters": launches,
                "buckets": buckets, "loss": loss,
                "lint_counts": [v.message for v in tl.lint_collective_counts(
                    trace, {"transport.quantize_pack": buckets,
                            "transport.unpack_dequantize": buckets})],
                "lint_wire": [v.message for v in tl.lint_compressed_wire(
                    trace, bits=4)],
            }
            del trace
    except BaseException:
        _stop(procs)
        raise
    # 5. the dry run's cells
    cells = _dryrun_finish(procs)
    for c in cells:
        print(f"dryrun {c['cell']} {c['opts'] or '-'}: ok={c['ok']} "
              f"compute_s={c['compute_s']!r} memory_s={c['memory_s']!r} "
              f"collective_s={c['collective_s']!r} "
              f"dominant={c['dominant']} trace_s={c['trace_s']!r}",
              flush=True)
    emit({"phase": "dryrun", "nvidia_smi": smi, "cells": cells,
          "counter": counter, "transport_routes": routes,
          "constants": dataclasses.asdict(rl.H100_SXM),
          "phase_s": time.perf_counter() - t_phase})
    bad = []
    if not counter["meta_equal"]:
        bad.append("the card's count differs from meta's")
    if not counter["loss_bitwise"]:
        bad.append("the counted step's loss differs from the uncounted")
    a, p = routes["auto"], routes["plain"]
    if (a["flops"], a["bytes"]) != (p["flops"], p["bytes"]):
        bad.append("the kernel route and the plain route count differently")
    for name, r in routes.items():
        if r["lint_counts"] or r["lint_wire"]:
            bad.append(f"{name}: {r['lint_counts'] + r['lint_wire']}")
    b = a["buckets"]
    if device != "cpu" and _without_adamw(a["kernel_counters"]) != {
            "quantize_pack": b, "unpack_dequantize": b}:
        bad.append(f"kernel route launched {a['kernel_counters']}")
    if any(_without_adamw(p["kernel_counters"]).values()):
        bad.append("the plain route launched a transport kernel")
    if bad:
        raise AssertionError("phase dryrun: " + "; ".join(bad))
    return dict(a["kernel_counters"])


# ---------------------------------------------------------------------------
# the proof chain's sweeps and the SPMD lint (phase analysis)
# ---------------------------------------------------------------------------

# the compressed syncs linted at world size 1: (bits, error feedback)
ANALYSIS_SYNCS = ((8, False), (4, False), (4, True))


def _analysis_start() -> list:
    """``python -m repro_torch.analysis`` (the schedule sweep and the trace
    wire lint) and ``--spmd``, one process each (host work: no card,
    ``CUDA_VISIBLE_DEVICES`` empty), both at once; tables into
    ``chiprun_out/``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    procs = []
    for name, flags in (("schedules", []), ("spmd", ["--spmd"])):
        cmd = [sys.executable, "-m", "repro_torch.analysis", *flags,
               "--json", str(out / f"analysis_torch_{name}.json")]
        procs.append((name, subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    return procs


def _analysis_finish(procs) -> dict:
    """Each sweep's violations and seconds (the sweep's own, in its
    process); fails if a process fails.  Every process is ended on the
    way out."""
    rows = {}
    try:
        for name, p in procs:
            out, err = p.communicate(timeout=600)
            if p.returncode:
                raise AssertionError(
                    f"python -m repro_torch.analysis ({name}) exited "
                    f"{p.returncode}:\n{out[-3000:]}\n{err[-3000:]}")
            table = json.loads((ROOT / "chiprun_out"
                                / f"analysis_torch_{name}.json").read_text())
            parts = [k for k in ("schedule_verification", "hlo_lint",
                                 "spmd_lint") if k in table]
            rows[name] = {"ok": table["ok"],
                          "violations": {k: table[k]["violations"]
                                         for k in parts},
                          "seconds": {k: table[k]["seconds"] for k in parts}}
            if name == "spmd":
                rows[name]["cells"] = table["spmd_lint"]["cells"]
    finally:
        _stop([p for _, p in procs])
    return rows


def _lint_world1(grads, bits, ef, route):
    """The compressed sync of ``grads`` at world size 1, traced by the
    SPMD lint on ``grads``' device: the report's row, the transport
    regions (all, and with named operands), the plan's buckets and the
    kernels' launches."""
    from repro_torch import tree as tree_util
    from repro_torch.analysis import spmd_lint
    from repro_torch.core import CommContext, grad_sync

    policy = CommPolicy(algorithm="nap", mean=True, compress_bits=bits,
                        error_feedback=ef, transport_impl=route)

    def sync(topo, grads):
        ctx = CommContext(topo, policy)
        plan = grad_sync.plan_for_tree(grads, cfg=policy, topology=topo)
        ef_state = (tree_util.tree_map(torch.zeros_like, grads) if ef
                    else None)
        return grad_sync.sync_with_context(grads, ctx, plan=plan,
                                           ef_state=ef_state)

    _reset_launches()
    traces = spmd_lint.trace_ranks(sync, grads, n_nodes=1, ppn=1)
    launches = dict(transport.LAUNCHES)
    rep = spmd_lint.lint_ranks(traces, label=f"grad_sync[bits={bits},"
                               f"ef={int(ef)}]@1x1")
    regions = traces[0].regions
    transport_regions = [r for r in regions if r[0].startswith("transport.")]
    from repro_torch.core import Topology
    buckets = len(grad_sync.plan_for_tree(
        grads, cfg=policy, topology=Topology.of(1, 1)).buckets)
    return {"row": rep.to_row(), "transport_regions": len(transport_regions),
            "with_operands": sum(1 for _, has in transport_regions if has),
            "buckets": buckets, "launches": launches}


def phase_analysis(smi, cfg=MINICPM_2B_4L, device="cuda") -> dict:
    """The proof chain of ``repro_torch.analysis`` on the card's machine.

    1. ``python -m repro_torch.analysis`` (the schedule sweep over every
       engine and grid, and the trace wire lint of the compressed
       fused-bucket sync as every rank of a fake 2 x 4 world) and
       ``--spmd`` (the SPMD lint of every engine on 2x2 / 3x2 / 2x4 in
       float32 and bfloat16, the compressed sync, the DP train step, the
       serve decode loop and the decode slice), each in its own process,
       started first; both must exit 0 with no violation.
    2. Meanwhile, here: the protocol sweep's first three scopes (230 /
       3,591 / 9,890 states at least) and the layer-0 link.
    3. The compressed sync of ``cfg``'s gradient tree (seeded, on the
       card) at world size 1, int8, int4 and int4 + error feedback, traced
       by the SPMD lint once on the kernel route and once on the plain
       route: the same report on both, no violation, two transport
       regions with named operands a bucket; the kernel route launches
       each kernel once a bucket, the plain route none.

    The seconds of each part go on the phase's line.  A CPU rehearsal
    (``device="cpu"``, a reduced ``cfg``) skips the kernels' counts."""
    from repro_torch import tree as tree_util
    from repro_torch.analysis import __main__ as driver
    from repro_torch.analysis import protocol_check as pc
    from repro_torch.models import init_params

    t_phase = time.perf_counter()
    procs = _analysis_start()
    try:
        t0 = time.perf_counter()
        protocol = driver.run_protocol_sweep(pc.PROTOCOL_GRID[:3])
        protocol_s = time.perf_counter() - t0
        gen = torch.Generator(device=device).manual_seed(SEED)
        grads = tree_util.tree_map(
            lambda t: torch.randn(t.shape, dtype=t.dtype, device=device,
                                  generator=gen),
            init_params(cfg, device="meta"))
        world1 = {}
        for bits, ef in ANALYSIS_SYNCS:
            for route in ("auto", "plain"):
                t0 = time.perf_counter()
                row = _lint_world1(grads, bits, ef, route)
                row["seconds"] = time.perf_counter() - t0
                world1[f"int{bits}{'+ef' if ef else ''}/{route}"] = row
        del grads
    except BaseException:
        _stop([p for _, p in procs])
        raise
    sweeps = _analysis_finish(procs)
    emit({"phase": "analysis", "nvidia_smi": smi, "config": cfg.name,
          "sweeps": sweeps,
          "protocol": {"states": [r["states"] for r in protocol["rows"]],
                       "floors": [r["min_states"] for r in protocol["rows"]],
                       "violations": protocol["violations"],
                       "scope_s": [r["seconds"] for r in protocol["rows"]],
                       "b_max": protocol["layer2_link"]["b_max"],
                       "seconds": protocol_s},
          "world1": world1, "phase_s": time.perf_counter() - t_phase})
    bad = [f"{name}: {row}" for name, row in sweeps.items() if not row["ok"]]
    if protocol["violations"]:
        bad.append(f"protocol: {protocol['violations']} violation(s)")
    for bits, ef in ANALYSIS_SYNCS:
        key = f"int{bits}{'+ef' if ef else ''}"
        a, p = world1[f"{key}/auto"], world1[f"{key}/plain"]
        if a["row"] != p["row"]:
            bad.append(f"{key}: the kernel and plain routes lint differently")
        if not a["row"]["ok"]:
            bad.append(f"{key}: {a['row']['violations']}")
        for route, r in (("auto", a), ("plain", p)):
            if r["with_operands"] != 2 * r["buckets"] or (
                    r["transport_regions"] != r["with_operands"]):
                bad.append(f"{key}/{route}: {r['with_operands']} transport "
                           f"regions with operands for {r['buckets']} "
                           "buckets")
        if device != "cpu" and a["launches"] != {
                "quantize_pack": a["buckets"],
                "unpack_dequantize": a["buckets"]}:
            bad.append(f"{key}: the kernel route launched {a['launches']}")
        if any(p["launches"].values()):
            bad.append(f"{key}: the plain route launched a kernel")
    if bad:
        raise AssertionError("phase analysis: " + "; ".join(bad))
    return sweeps


# the examples' processes: (tag, module, flags); the main mode of
# train_lm at its defaults (200 steps)
EXAMPLES = (
    ("quickstart", "quickstart", ["--grid", "1x1"]),
    ("nap_gradient_sync", "nap_gradient_sync", ["--grid", "1x1"]),
    ("train_lm", "train_lm", []),
    ("compressed", "train_lm", ["--compressed-smoke", "--grid", "1x1"]),
    ("compressed_plain", "train_lm",
     ["--compressed-smoke", "--grid", "1x1", "--transport", "plain"]),
    ("serve_decode", "serve_decode", []),
)


def _run_example(tag, module, flags, timeout=600) -> dict:
    """``python -m repro_torch.examples.<module> <flags> --report <file>``
    in a session of its own (its ranks with it, ended on a timeout); its
    report with the process's seconds.  Fails if it exits non-zero."""
    report = ROOT / "chiprun_out" / f"example_{tag}.json"
    report.parent.mkdir(exist_ok=True)
    report.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    p = subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.examples.{module}", *flags,
         "--report", str(report)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, 9)
            p.wait()
    if p.returncode:
        raise AssertionError(f"example {tag} exited {p.returncode}:\n"
                             f"{out[-3000:]}\n{err[-3000:]}")
    rep = json.loads(report.read_text())
    rep["process_s"] = time.perf_counter() - t0
    return rep


def phase_examples(smi) -> dict:
    """The drivers of ``repro_torch.examples`` on the card (module
    docstring, phase 21).  Returns the compressed smoke's transport
    launches on the kernel route."""
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    reps = {tag: _run_example(tag, module, flags)
            for tag, module, flags in EXAMPLES}
    bad = []
    rows = reps["quickstart"]["rows"]
    for algo, row in rows.items():
        if row["result"] != row["expected"] or row["rounds"] != 0:
            bad.append(f"quickstart {algo} at 1x1: {row}")
    nap = reps["nap_gradient_sync"]
    if nap["rank0"]["psum"]["losses"] != nap["rank0"]["nap"]["losses"]:
        bad.append("nap_gradient_sync at 1x1: psum and nap losses differ")
    lm = {k: v for k, v in reps["train_lm"].items() if k != "example"}
    if not (lm["resumed_at"] > 0
            and lm["last_loss"] < lm["first_loss"] - 0.5):
        bad.append(f"train_lm: {lm}")
    kern, plain = reps["compressed"]["rank0"], reps["compressed_plain"][
        "rank0"]
    launches = {k: 0 for k in (*transport.LAUNCHES, *ADAMW_KEYS)}
    for label, row in kern.items():
        once = row["buckets"] * len(row["losses"])
        if row["launches"] != {"quantize_pack": once,
                               "unpack_dequantize": once}:
            bad.append(f"compressed {label}: launches {row['launches']} for "
                       f"{row['buckets']} buckets x {len(row['losses'])} "
                       "steps")
        # AdamW on its kernels on both of the transport's routes
        for side in (row, plain[label]):
            steps = len(side["losses"])
            if side["adamw_launches"] != {
                    "sq_norm": steps, "adamw_apply": steps * side["leaves"]}:
                bad.append(f"compressed {label}: AdamW launches "
                           f"{side['adamw_launches']} for {side['leaves']} "
                           f"leaves x {steps} steps")
        for k, v in {**row["launches"], **row["adamw_launches"]}.items():
            launches[k] += v
        if any(plain[label]["launches"].values()):
            bad.append(f"compressed {label}: the plain route launched "
                       f"{plain[label]['launches']}")
        if row["losses"] != plain[label]["losses"]:
            bad.append(f"compressed {label}: kernel and plain losses differ")
    emit({"phase": "examples", "nvidia_smi": smi,
          "quickstart": rows,
          "nap_gradient_sync": {
              "ms_per_step": nap["ms_per_step"],
              "losses": {a: nap["rank0"][a]["losses"]
                         for a in ("psum", "nap")},
              "nap_rounds": nap["rank0"]["nap_rounds"],
              "nap_all_reduces": nap["rank0"]["nap_all_reduces"],
              "buckets": nap["rank0"]["buckets"]},
          "train_lm": lm,
          "compressed": {label: {
              "losses": row["losses"], "buckets": row["buckets"],
              "launches": row["launches"],
              "adamw_launches": row["adamw_launches"],
              "ms_per_step": statistics.median(row["ms"][1:]),
              "plain_ms_per_step": statistics.median(
                  plain[label]["ms"][1:]),
              "losses_bitwise_equal_plain":
                  row["losses"] == plain[label]["losses"]}
              for label, row in kern.items()},
          "serve_decode_s": {arch: row["seconds"] for arch, row in
                             reps["serve_decode"]["archs"].items()},
          "process_s": {tag: rep["process_s"] for tag, rep in reps.items()},
          "phase_s": time.perf_counter() - t_phase})
    if bad:
        raise AssertionError("phase examples: " + "; ".join(bad))
    return launches


def _shape_of(sizes):
    from repro_torch.configs.base import ShapeConfig

    return ShapeConfig("count", sizes["seq"], sizes["batch"], "train")


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach().clone()


def main() -> None:
    # full float32 matmuls everywhere (the plain reference's precision)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi, clock = phase_device()
    rates = card_rates(torch.cuda.get_device_name(0))
    build = phase_build()
    # the float32 scan at N 16 (jamba's instance)
    fp32_per_ex2 = next(
        (row.get("fp32_per_ex2") for name, row in build["mamba_scan.cu"].items()
         if re.search(r"mamba_scan_kernel(<float, 16>|IfLi16E)", name)), None)
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
    ops_err = phase_ops_kernels()
    full = phase_ops_full_width(rates, clock, fp32_per_ex2)
    rs = phase_rs_transport(rates)
    phase_collectives_world1()
    phase_serve(rates, smi)
    family_launches = phase_families(smi)
    trainer_launches = phase_trainer(smi)
    dp_ef_launches = phase_dp_ef(smi)
    whisper_launches = phase_whisper(smi)
    mesh_launches = phase_mesh(smi)
    mesh_serve_launches = phase_mesh_serve(smi)
    dryrun_launches = phase_dryrun(smi)
    phase_analysis(smi)
    example_launches = phase_examples(smi)
    t4 = k["timing"][4]
    replaces = {"quantize_pack": "src/repro/kernels/transport.py:158",
                "unpack_dequantize": "src/repro/kernels/transport.py:222"}
    kernels = [
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/transport.cu",
         "replaces": replaces[name],
         "launches": run["launches"][name],
         # the families' train steps (buckets x steps) and serving (0)
         "launches_families_train": family_launches[name],
         "launches_families_serve": 0,
         # the reference's convergence check at 1 x 1 (phase dp_ef) and the
         # training driver (phase trainer)
         "launches_dp_ef": dp_ef_launches[name],
         "launches_trainer": trainer_launches[name],
         # whisper-tiny's int4+EF DP steps (phase whisper)
         "launches_whisper_train": whisper_launches[name],
         # make_grad_sync over DTensors at int4 and int8 (phase mesh)
         "launches_mesh_grad_sync": mesh_launches[name],
         # decode and prefill on a (1, 1) mesh (phase mesh_serve)
         "launches_mesh_serve": mesh_serve_launches[name],
         # the counted int4+EF DP step on the kernel route (phase dryrun)
         "launches_dryrun": dryrun_launches[name],
         # train_lm --compressed-smoke, int8 and int4+EF at 1x1, in the
         # example's own process (phase examples)
         "launches_examples": example_launches[name],
         "max_abs_err": k["max_abs_err"],
         "ms": t4[name][0], "plain_ms": t4[name][1],
         "bound_ms": t4["bound_ms"], "bound_by": t4["bound_by"],
         "library_ms": None,
         # the sharded sync's compressed reduce-scatter calls (phase
         # rs_transport), per grid and width
         "rs_transport": {
             f"{r['grid']}/int{r['bits']}": {
                 "ms": r["quantize_ms" if name == "quantize_pack"
                         else "dequantize_ms"],
                 "plain_ms": r["quantize_plain_ms" if name == "quantize_pack"
                               else "dequantize_plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}
             for r in rs["rows"]}}
        for name in ("quantize_pack", "unpack_dequantize")
    ]
    ops_replaces = {
        "flash_attention": "src/repro/kernels/flash_attention.py:89",
        "rwkv6_scan": "src/repro/kernels/rwkv6_scan.py:65",
        "mamba_scan": "src/repro/kernels/mamba_scan.py:66",
    }
    for name, where in ops_replaces.items():
        rows = [c for c in full["cases"] if c["kernel"] == name]
        tot = lambda key: sum(c[key] for c in rows)
        libs = [c["library_ms"] for c in rows]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": where, "launches": full["launches"][name],
            "launches_families_serve": 0,
            "launches_mesh_serve": mesh_serve_launches[name],
            "launches_trainer": trainer_launches[name],
            "max_abs_err": max([ops_err[name]]
                               + [c["max_abs_err"] for c in rows]),
            # one launch per case of the main path: times are summed
            "ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": tot("bound_ms"),
            "bound_by": ("bytes" if all(c["bound_by"] == "bytes"
                                        for c in rows) else "operations"),
            "library_ms": None if None in libs else sum(libs),
            "cases": {c["case"]: {key: c[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
                for c in rows},
        })
    # attention's two instances: bf16 on the main path above; float32 on
    # its own path (phase ops_full_width_f32_control), summed the same way
    f32 = full["f32_times"]
    kernels[2]["instances"] = {
        "bfloat16": "tc::flash_attention_tc<hd>",
        "float32": "tc32::flash_attention_tf32x3<hd> after tc32::split_kv<hd>",
    }
    kernels[2]["float32"] = {
        "launches": full["f32_launches"],
        "max_abs_err": max(full["f32_control"].values()),
        **{key: sum(c[key] for c in f32.values())
           for key in ("ms", "plain_ms", "bound_ms")},
        "bound_by": "operations" if any(
            c["bound_by"] == "operations" for c in f32.values()) else "bytes",
        "library_ms": None,
        "cases": {name: {key: c[key] for key in (
            "ms", "call_ms", "plain_ms", "bound_ms", "bound_ms_simt_rate",
            "library_ms")} for name, c in f32.items()},
    }
    # AdamW's two kernels, the port's own (the JAX package's AdamW is plain
    # jnp, which XLA fuses): times at the benchmark's configuration
    # (phase kernels), launches in every phase that trains
    phase_launches = {
        "launches": run["launches"], "launches_families_train":
        family_launches, "launches_trainer": trainer_launches,
        "launches_dp_ef": dp_ef_launches,
        "launches_whisper_train": whisper_launches,
        "launches_mesh_train": mesh_launches,
        "launches_mesh_serve_train": mesh_serve_launches,
        "launches_dryrun": dryrun_launches,
        "launches_examples": example_launches}
    for name in ADAMW_KEYS:
        t = k["adamw"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/adamw.cu",
            "replaces": None,
            "replaces_reason": "the port's own: src/repro/optim/adamw.py "
            "is plain jnp",
            **{key: v[name] for key, v in phase_launches.items()},
            "max_abs_err": 0.0 if name == "adamw_apply" else None,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "achieved_TBps": t["achieved_TBps"],
            "library_ms": None,
            "config": ADAMW_CFG.name})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
