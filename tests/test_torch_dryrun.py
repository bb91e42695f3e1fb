"""The port's dry run (``repro_torch.launch.dryrun``), roofline and
reanalysis, beside the reference's.

* ``cells()`` / ``LONG_OK`` and ``model_flops`` of all 33 cells equal the
  reference's.
* The faults the dry run found, on the fake 16 x 16 world (``meta``):
  minicpm-2b's train_4k microbatches (n_micro 4 over a data axis of 16,
  depth cut to 2 layers), minicpm-2b decode_32k in both layouts (36 heads
  over 16 model ranks), and deepseek-moe-16b decode_32k (MoE, whose
  in-place ``c10d`` collectives are counted).
* One subprocess run of ``python -m repro_torch.launch.dryrun`` on
  whisper-tiny train_4k beside the reference's own dry run of the cell:
  the record's keys, ``model_flops_per_chip``, ``memory.argument_bytes``
  within 1%, and the flops per chip site by site (see
  :func:`test_whisper_cell_matches_reference_site_by_site`).
* ``reanalyze`` reproduces a record's roofline from its saved trace.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import textwrap
from collections import Counter
from pathlib import Path

import pytest

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch import hlo_analysis as ha
from repro.launch import roofline as j_roofline
from repro.launch.dryrun import LONG_OK as J_LONG_OK
from repro.launch.dryrun import cells as j_cells
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun, reanalyze, roofline
from repro_torch.launch.trace_analysis import Trace, _matmul_flops

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
TAG = "torchparity"
CELL = "whisper-tiny__train_4k__pod16x16__" + TAG


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    return env


def test_cells_and_long_ok_equal_reference():
    assert list(dryrun.cells()) == list(j_cells())
    assert len(list(dryrun.cells())) == 33
    assert dryrun.LONG_OK == J_LONG_OK


def test_model_flops_equal_reference_for_every_cell():
    for arch, shape in dryrun.cells():
        got = roofline.model_flops(get_config(arch), SHAPES[shape])
        want = j_roofline.model_flops(j_get_config(arch), J_SHAPES[shape])
        assert got == pytest.approx(want, rel=1e-12), (arch, shape)


def test_h100_constants():
    hw = roofline.H100_SXM
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw, hw.name) == (
        989e12, 3.35e12, 450e9, "h100_sxm")


@pytest.fixture(scope="module")
def fake_cells(tmp_path_factory):
    """The faults' cells, each traced on the fake 16 x 16 world in one
    subprocess (its fake default group must not outlive it)."""
    out = tmp_path_factory.mktemp("dryrun_cells")
    script = textwrap.dedent(
        f"""
        import json
        from pathlib import Path
        from repro_torch.launch import dryrun
        from repro_torch.launch.trace_analysis import (Trace, Tracer,
                                                       analyze_trace)

        out = {{}}
        # the microbatch split: n_micro 4 over a data axis of 16
        step, args, info = dryrun.build_cell(
            "minicpm-2b", "train_4k", False,
            cfg_overrides={{"num_layers": 2}}, n_micro=4)
        tracer = Tracer()
        with tracer:
            _, m = step(*args)
        st = analyze_trace(tracer.trace)
        out["f1"] = {{"n_micro": info["n_micro"], "flops": st.flops,
                      "loss_shape": list(m["loss"].shape)}}
        for name, arch, opts in (
                ("decode_train", "minicpm-2b", {{}}),
                ("decode_serve2d", "minicpm-2b", {{"serve2d": "1"}}),
                ("moe_decode", "deepseek-moe-16b", {{}})):
            rec = dryrun.run_cell(arch, "decode_32k", False, opts=opts,
                                  tag=name, force=True,
                                  reports=Path({str(out)!r}))
            tr = Trace.load(Path({str(out)!r}) / (dryrun.cell_name(
                arch, "decode_32k", False) + "__" + name + ".trace.json.gz"))
            rec["ops"] = sorted({{c.op for c in tr.collectives}})
            out[name] = rec
        print(json.dumps(out, default=str))
        """
    )
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=_env(), timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), out


def test_microbatches_split_over_a_wider_data_axis(fake_cells):
    f1 = fake_cells[0]["f1"]
    assert f1["n_micro"] == 4 and f1["flops"] > 0
    assert f1["loss_shape"] == []


@pytest.mark.parametrize("name", ["decode_train", "decode_serve2d"])
def test_uneven_heads_decode_on_the_fake_world(fake_cells, name):
    rec = fake_cells[0][name]
    assert rec["ok"], rec.get("traceback")
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["memory"]["alias_bytes"] > 0  # the cache, updated in place


def test_moe_decode_counts_in_place_collectives(fake_cells):
    rec = fake_cells[0]["moe_decode"]
    assert rec["ok"], rec.get("traceback")
    assert any(op.startswith("c10d.") for op in rec["ops"]), rec["ops"]
    assert rec["roofline"]["collective_bytes_per_chip"] > 0


def test_reanalyze_reproduces_the_roofline(fake_cells):
    _, out = fake_cells
    before = {p.name: json.loads(p.read_text())["roofline"]
              for p in out.glob("*.json")}
    assert len(before) == 3
    assert reanalyze.reanalyze(out) == 3
    after = {p.name: json.loads(p.read_text())["roofline"]
             for p in out.glob("*.json")}
    assert after == before


# ---------------------------------------------------------------------------
# whisper-tiny train_4k beside the reference's dry run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def whisper_pair():
    """Both dry runs of the cell, in parallel subprocesses."""
    port = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "train_4k", "--tag", TAG, "--force"],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    ref = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "train_4k", "--tag", TAG, "--force"],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    outs = {}
    for name, p in (("port", port), ("ref", ref)):
        so, se = p.communicate(timeout=600)
        assert p.returncode == 0, f"{name}: {se[-3000:]}"
        outs[name] = json.loads(so[so.index("{"):])
    return outs


def _ref_dot_sites(hlo: str) -> Counter:
    """The reference's per-chip dot flops by site: ``attn`` (the
    reference analyzer's attention tags), ``head`` (a vocab-sized
    operand or result), ``rest``; while bodies multiplied by their trip
    counts, as ``analyze_hlo`` does."""
    comps, entry = ha._parse(hlo)
    sites: Counter = Counter()

    def dot(comp, inst, mult, tagged):
        out = 1
        for d in ha._shape_dims(inst.shape):
            out *= d
        m = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", inst.rest)
        ops = ha._operand_names(inst.rest)
        k = 1
        if m and ops and ops[0] in comp.instrs:
            lhs = ha._shape_dims(comp.instrs[ops[0]].shape)
            for c in (int(x) for x in m.group(1).split(",") if x):
                k *= lhs[c]
        shapes = inst.shape + " " + " ".join(
            comp.instrs[o].shape for o in ops if o in comp.instrs)
        site = ("attn" if tagged or ha._is_attn_tagged(inst.rest)
                else "head" if "51865" in shapes else "rest")
        sites[site] += 2.0 * out * k * mult

    def walk(name, mult, tagged=False, fused=False):
        comp = comps.get(name)
        if comp is None:
            return
        for iname in comp.order:
            inst = comp.instrs[iname]
            if inst.op == "while" and not fused:
                tm = ha._TRIP_RE.search(inst.rest)
                walk(ha._called_comp(inst.rest, "body"),
                     mult * (int(tm.group(1)) if tm else 1))
            elif inst.op == "call" and not fused:
                walk(ha._called_comp(inst.rest, "to_apply"), mult)
            elif inst.op == "dot":
                dot(comp, inst, mult, tagged)
            elif inst.op in ("fusion", "map") or (fused and inst.op == "call"):
                c = (ha._called_comp(inst.rest, "calls")
                     or ha._called_comp(inst.rest, "to_apply"))
                if c:
                    walk(c, mult, tagged or ha._is_attn_tagged(inst.rest),
                         fused=True)

    walk(entry, 1.0)
    return sites


def _port_dot_sites(trace: Trace, vocab_cols: int) -> Counter:
    sites: Counter = Counter()
    for (op, ins, outs, tag), n in trace.ops.items():
        mm = _matmul_flops(op, ins)
        if mm is None:
            continue
        dims = {d for s, _ in ins + outs for d in s}
        site = "attn" if tag == "attn" else (
            "head" if vocab_cols in dims else "rest")
        sites[site] += mm[0] * n
    return sites


def test_whisper_record_keys_cover_the_reference(whisper_pair):
    port, ref = whisper_pair["port"], whisper_pair["ref"]
    assert port["ok"] and ref["ok"]
    # compile_s -> trace_s; hlo_bytes -> trace_ops
    rename = {"compile_s": "trace_s", "hlo_bytes": "trace_ops"}
    assert {rename.get(k, k) for k in ref} <= set(port)
    # XLA's temp bytes -> the peak of the step's live tensors; no code
    mem = {"temp_bytes": "peak_bytes"}
    assert {mem.get(k, k) for k in ref["memory"]
            if k != "generated_code_bytes"} <= set(port["memory"])
    assert set(ref["roofline"]) == set(port["roofline"])
    assert port["roofline"]["hw"] == "h100_sxm"
    assert port["roofline"]["dominant"] in ("compute", "memory",
                                            "collective")
    assert port["roofline"]["collective_bytes_per_chip"] > 0


def test_whisper_model_flops_and_arguments_match(whisper_pair):
    port, ref = whisper_pair["port"], whisper_pair["ref"]
    assert port["roofline"]["model_flops_per_chip"] == pytest.approx(
        ref["roofline"]["model_flops_per_chip"], rel=1e-12)
    assert port["memory"]["argument_bytes"] == pytest.approx(
        ref["memory"]["argument_bytes"], rel=0.01)


def test_whisper_cell_matches_reference_site_by_site(whisper_pair):
    """The two programs do different work at two sites (ROADMAP Queue 3,
    kept on purpose), and about the same elsewhere:

    * attention: whisper-tiny's 6 heads do not divide the 16-way model
      axis; the port computes all 6 heads of its rows on every model rank
      (the heads replicated over it), where GSPMD splits them 3 + 3, so
      the port does exactly twice the reference's attention products;
    * the LM head (vocab 51,865, which 16 does not divide): DTensor shards
      the vocab unevenly over the model axis (ceil(51865 / 16) = 3,242
      columns a rank) in the logits, their input gradient and the weight
      gradient; GSPMD replicates the vocab for the first two and shards
      only the weight gradient over the model dimension (384 / 16);
    * the rest (projections, MLPs): within 3x of the reference: DTensor
      keeps the forward tensor-parallel, but for some input gradients
      gathers whole weights where GSPMD stays tensor-parallel.
    """
    import gzip

    ref_hlo = ROOT / "reports" / "dryrun" / f"{CELL}.hlo.gz"
    with gzip.open(ref_hlo, "rt") as fh:
        ref = _ref_dot_sites(fh.read())
    trace = Trace.load(dryrun.REPORTS / f"{CELL}.trace.json.gz")
    port = _port_dot_sites(trace, 3242)
    rec = whisper_pair["port"]["roofline"]
    assert sum(port.values()) == rec["flops_per_chip"]
    assert sum(ref.values()) == pytest.approx(
        whisper_pair["ref"]["roofline"]["flops_per_chip"], rel=1e-9)
    assert port["attn"] == pytest.approx(2 * ref["attn"], rel=1e-9)
    tokens, vocab, d = 16 * 4096, 51865, 384  # per chip: 16 rows of 4096
    assert port["head"] == 3 * 2 * tokens * 3242 * d
    assert ref["head"] == 2 * (2 * tokens * vocab * d) \
        + 2 * tokens * vocab * (d // 16)
    assert ref["rest"] <= port["rest"] <= 3 * ref["rest"]
