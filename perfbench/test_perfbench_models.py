"""The architecture lives in its model file alone (``models/<model>.py``),
and the port's configuration follows from the configuration's file.

What the one-chip cell reads stays as it was before the model file took
the tree, the counts and the loss: its weights to the bit (a digest
computed before the move) and its ``ModelConfig`` field by field (the
mapping as it was, kept here).  A toy architecture given only as files
under a temporary root (a configuration, a model file, a cell's spec and
a traffic mix) runs the whole CPU path with no file of the benchmark
edited: the weights, the tree checked against the port's ``init_params``
on ``meta``, the program's three steps against the reference's, and the
counts."""

import dataclasses
import hashlib
import json
import math

import pytest
import torch

from perfbench import counts, weights
from perfbench import manifest as mf
from perfbench.rank import _check_tree, port_config, run_rank
from perfbench.reference import compare
from perfbench.reference import train as ref_train
from perfbench.test_perfbench_faults import one_rank_world  # noqa: F401

DP1 = "dp1.deepseek-moe-16b-2l.int4ef"
SMALL = {"num_layers": 2, "d_model": 32, "num_heads": 4, "num_kv_heads": 2,
         "head_dim": 8, "d_ff": 48, "vocab_size": 64}
SMALL_MOE = {"num_experts": 4, "top_k": 2, "d_expert": 16,
             "num_shared_experts": 1}
# sha256 over each leaf's path, dtype and bytes in the tree's order, of
# make_params(SMALL, seed 2**31 + 7) on the CPU, computed before the tree
# moved into models/decoder.py
DIGESTS = {
    "bfloat16":
        "09d4364055baa7e757b9a887dcca045bf95c76092a36eabe6f4bf72465b2ee57",
    "float32":
        "1a6fe84091254cba73cb763108298472adbafca8042fa58bee80f3daddeff80b",
}


def _digest(tree) -> str:
    h = hashlib.sha256()
    for path, t in weights.tree_leaves(tree):
        h.update("/".join(path).encode())
        h.update(str(t.dtype).encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("dtype", sorted(DIGESTS))
def test_the_weights_are_the_parent_s_to_the_bit(dtype):
    cell = mf.load_cell(DP1)
    config = dict(cell.config, **SMALL, dtype=dtype)
    config["moe"] = dict(config["moe"], **SMALL_MOE)
    cell = dataclasses.replace(cell, config=config)
    tree = weights.make_params(cell.specs, 2 ** 31 + 7, "cpu")
    assert len(weights.tree_leaves(tree)) == 16
    assert _digest(tree) == DIGESTS[dtype]


def _port_config_before(config: dict):
    """The mapping as it was: the arch's config with a fixed list of keys
    and ``moe`` put in."""
    from repro_torch.configs import get_config

    base = get_config(config["arch"])
    over = {k: config[k] for k in (
        "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
        "d_ff", "vocab_size", "act", "norm_eps", "rope_theta",
        "tie_embeddings", "dtype")}
    if config["ffn"] == "moe":
        over["moe"] = dataclasses.replace(base.moe, **config["moe"])
    return dataclasses.replace(base, name=f"{config['arch']}-bench", **over)


def test_the_one_chip_cell_s_port_config_is_the_parent_s():
    config = mf.load_cell(DP1).config
    got, want = port_config(config), _port_config_before(config)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got == want


def test_the_mapping_puts_in_nested_configurations_and_a_pattern():
    from repro_torch.configs import (MambaConfig, MoEConfig, SubLayer,
                                     get_config)

    # a nested configuration the arch lacks is made whole; a pattern of
    # dicts becomes the port's sublayers; keys of no field are left alone
    cfg = port_config({
        "arch": "minicpm-2b", "model": "anything", "source": "a paper",
        "num_layers": 4, "pattern": [{"mixer": "attn", "ffn": "dense"},
                                     {"mixer": "attn", "ffn": "moe"}],
        "moe": {"num_experts": 4, "top_k": 2, "d_expert": 16},
        "published": {"num_hidden_layers": 40}})
    assert cfg.pattern == (SubLayer("attn", "dense"), SubLayer("attn", "moe"))
    assert cfg.moe == MoEConfig(num_experts=4, top_k=2, d_expert=16)
    assert cfg.num_layers == 4 and cfg.name == "minicpm-2b-bench"
    # one the arch has is put in field by field over its own value
    base = get_config("jamba-1.5-large-398b").mamba
    assert isinstance(base, MambaConfig) and base.d_state != 8
    jamba = port_config({"arch": "jamba-1.5-large-398b",
                         "mamba": {"d_state": 8}})
    assert jamba.mamba == dataclasses.replace(base, d_state=8)


def test_a_missing_model_file_fails_loudly(tmp_path):
    root = _toy_root(tmp_path)
    path = root / "perfbench" / "models" / f"{TOY_MODEL}.py"
    path.unlink()
    with pytest.raises(FileNotFoundError, match=str(path)):
        mf.load_cell(TOY_CELL, mf.load_manifest(root), root=root)
    problems = mf.check_manifest(mf.load_manifest(root), root=root)
    assert problems == [f"config toy: no model file models/{TOY_MODEL}.py"]


# --- a toy architecture, given as files only ---------------------------------

TOY_MODEL = "toy_dense_first"
TOY_CELL = "dp1.toy.int4ef"
# two sublayers repeated: attention with a dense FFN, then attention with
# routed and shared experts (a leading dense layer, as some MoE models
# have); the decoder's file writes one sublayer and cannot hold it
TOY_SOURCE = '''"""A toy: (attention + dense FFN, attention + MoE) repeated."""

import torch

from perfbench.models import decoder as d


def _halves(c):
    half = dict(c, num_layers=c["num_layers"] // 2)
    return dict(half, ffn="dense"), dict(half, ffn="moe")


def leaf_specs(c):
    dense, moe = (d.leaf_specs(h) for h in _halves(c))
    specs = dict(dense)
    for path, spec in moe.items():
        if path[0] == "stack":
            specs[("stack", "sub1") + path[2:]] = spec
    return dict(sorted(specs.items()))


def active_matmul_params(c):
    dense, moe = _halves(c)
    return (d.active_matmul_params(dense) + d.active_matmul_params(moe)
            - c["vocab_size"] * c["d_model"])


def step_flops(c, rows, seq):
    attn = 6 * rows * c["num_heads"] * c["head_dim"] * seq ** 2
    return 6.0 * active_matmul_params(c) * rows * seq \\
        + float(attn) * c["num_layers"]


def loss(params, batch, c, mm=torch.matmul):
    eps, st = c["norm_eps"], params["stack"]
    x = params["embedding"][batch["tokens"]]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l in range(c["num_layers"] // 2):
        for sub in ("sub0", "sub1"):
            p = st[sub]
            x = x + d._attention(p["mixer"], d._rms(x, p["norm1"][l], eps),
                                 l, c, mm)
            h = d._rms(x, p["norm2"][l], eps)
            if sub == "sub1":
                h, a = d._moe(p["ffn"], h, l, c, mm)
                aux = aux + a
            else:
                f = p["ffn"]
                h = d._glu(h, f["w_gate"][l], f["w_up"][l], f["w_down"][l],
                           mm)
            x = x + h
    x = d._rms(x, params["final_norm"], eps)
    logits = mm(x, params["lm_head"])
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, batch["labels"][..., None])[..., 0]
    mask = batch["loss_mask"]
    ce = ((logz - gold) * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return ce + aux
'''


def _toy_root(tmp_path):
    """A checkout's root holding only the toy's files and a manifest."""
    bench = tmp_path / "perfbench"
    for sub in ("configs", "models", "workloads", "traffic"):
        (bench / sub).mkdir(parents=True)
    config = {"arch": "deepseek-moe-16b", "model": TOY_MODEL,
              "num_layers": 4, "d_model": 32, "num_heads": 4,
              "num_kv_heads": 2, "head_dim": 8, "d_ff": 48,
              "vocab_size": 64, "act": "silu", "norm_eps": 1e-6,
              "rope_theta": 10000.0, "tie_embeddings": False,
              "dtype": "float32",
              "pattern": [{"mixer": "attn", "ffn": "dense"},
                          {"mixer": "attn", "ffn": "moe"}],
              "moe": dict(SMALL_MOE, capacity_factor=1.25,
                          router_aux_weight=0.001)}
    (bench / "configs" / "toy.json").write_text(json.dumps(config))
    (bench / "models" / f"{TOY_MODEL}.py").write_text(TOY_SOURCE)
    dp1 = mf.load_cell(DP1)
    (bench / "workloads" / f"{TOY_CELL}.json").write_text(json.dumps(
        dp1.spec))
    (bench / "traffic" / "toy_1x16.json").write_text(json.dumps(
        dict(dp1.traffic, seq_len=16)))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "toy", "source": "a toy", "reduced": [],
                     "file": "perfbench/configs/toy.json", "why": "a toy"}],
        "workloads": [{"name": TOY_CELL, "config": "toy",
                       "traffic": "toy_1x16", "chips": 1, "why": "a toy"}],
        "end_to_end": [], "per_layer": []}))
    return tmp_path


def test_a_new_architecture_runs_the_cpu_path_from_new_files_alone(
        tmp_path, one_rank_world):
    root = _toy_root(tmp_path)
    manifest = mf.load_manifest(root)
    assert mf.check_manifest(manifest, root=root) == []
    cell = mf.load_cell(TOY_CELL, manifest, root=root)
    assert cell.model_path == root / "perfbench" / "models" / \
        f"{TOY_MODEL}.py"
    # the tree: the decoder's leaves twice over, as the port lays it out
    specs = cell.specs
    assert len(specs) == 25
    assert specs[("stack", "sub0", "ffn", "w_gate")][0] == (2, 32, 48)
    assert specs[("stack", "sub1", "ffn", "we_up")][0] == (2, 4, 32, 16)
    cfg = port_config(cell.config)
    assert len(cfg.pattern) == 2 and cfg.num_super_layers == 2
    _check_tree(weights.make_params(specs, 3, "cpu"), cfg)
    # the counts: head 64*32; attention 32*(4+2*2)*8 + 32*32 = 3,072 a
    # layer; dense 3*32*48 = 4,608; MoE (2 + 1)*3*32*16 + 32*4 = 4,736
    active = 2048 + 2 * (3072 + 4608) + 2 * (3072 + 4736)
    assert cell.model.active_matmul_params(cell.config) == active
    want = {"flops": 6.0 * active * 16 + 6 * 4 * 8 * 16 ** 2 * 4,
            "transport_bytes": 2.0 * (4.5 * weights.n_elements(specs)
                                      + 4 * 25)}
    assert counts.of_cell(cell) == pytest.approx(want)
    # the program's three steps against the reference's, which follows it
    # at a float32 size to rounding
    res = run_rank(cell, 2 ** 31 + 7, rank=0, world=1, device="cpu",
                   seconds=0.0, trace=False, window=False)
    values, _ = compare.gaps(res.check["program"], res.check["reference"])
    assert res.check["correct"], res.check["rows"]
    assert max(values["loss"], values["loss3"]) < 1e-6
    assert values["grad"] < 1e-5 and values["change"] < 1e-4
    assert values["ef"] < 1e-5 and values["grad_elem"] < 1e-5
    ref = ref_train.run(cell, 2 ** 31 + 7, "cpu", steps=3)
    assert len(ref.losses) == 3 and all(map(math.isfinite, ref.losses))
