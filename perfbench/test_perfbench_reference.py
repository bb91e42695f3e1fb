"""The plain reference on tiny cases worked by hand, and against the
program's step at a tiny float32 size (where the two agree to rounding:
the reference is a reading of the same semantics)."""

import dataclasses
import math
import socket

import numpy as np
import pytest
import torch

from perfbench import manifest as mf
from perfbench import weights
from perfbench.reference import compare, quant, train

TINY = {"num_layers": 2, "d_model": 32, "num_heads": 4, "num_kv_heads": 2,
        "head_dim": 8, "d_ff": 48, "vocab_size": 64, "dtype": "float32"}
TINY_MOE = {"num_experts": 4, "top_k": 2, "d_expert": 16,
            "num_shared_experts": 1}


DP1 = "dp1.deepseek-moe-16b-2l.int4ef"
# the one-chip MoE cell, and a dense decoder under an uncompressed sync
# beside it (the reference's other FFN and sync)
KINDS = ["moe", "dense"]


def tiny(kind: str = "moe", **over):
    cell = mf.load_cell(DP1)
    config = dict(cell.config, **TINY, **over)
    spec = cell.spec
    if kind == "moe":
        config["moe"] = dict(config["moe"], **TINY_MOE)
    else:
        config = dict(config, arch="minicpm-2b", ffn="dense")
        del config["moe"]
        spec = dict(spec, sync={"algorithm": "auto", "mean": True})
    return dataclasses.replace(cell, config=config, spec=spec,
                               traffic=dict(cell.traffic, seq_len=16))


def test_the_round_trip_by_hand():
    c = torch.tensor([1.75, -0.625, 0.25, 0.0])
    # scale 1.75 / 7 = 0.25; -2.5 rounds half to even
    assert quant.round_trip(c, 4).tolist() == [1.75, -0.5, 0.25, 0.0]
    assert quant.round_trip(torch.zeros(3), 4).tolist() == [0.0] * 3


def test_the_schedule_by_hand():
    opt = {"lr": 3e-4, "warmup_steps": 1, "schedule": "constant"}
    assert train.lr_at(opt, 0) == 0.0
    assert train.lr_at(opt, 1) == pytest.approx(3e-4)
    opt = dict(opt, warmup_steps=4)
    assert train.lr_at(opt, 2) == pytest.approx(1.5e-4)


def test_one_adamw_step_by_hand():
    opt = {"betas": [0.9, 0.95], "eps": 1e-8, "weight_decay": 0.1,
           "grad_clip": 1.0, "lr": 0.5, "warmup_steps": 1,
           "schedule": "constant"}
    g = [torch.tensor([3.0, 4.0]), torch.tensor([[0.0]])]
    p = [torch.tensor([1.0, 1.0]), torch.tensor([[2.0]])]
    mu = [torch.zeros_like(t) for t in p]
    nu = [torch.zeros_like(t) for t in p]
    train._adamw(g, mu, nu, p, 1, opt, [torch.float32] * 2)
    # clipped to norm 1: (0.6, 0.8); at the second step (t = 2) the
    # moments' ratio is (0.1 / 0.19) / sqrt(0.05 / 0.0975) per sign
    assert mu[0].tolist() == pytest.approx([0.06, 0.08])
    ratio = (0.1 / 0.19) / math.sqrt(0.05 / 0.0975)
    assert p[0].tolist() == pytest.approx([1 - 0.5 * ratio] * 2)
    # a matrix decays: 2 - 0.5 * (0 + 0.1 * 2)
    assert p[1].item() == pytest.approx(1.9)


@pytest.mark.parametrize("ffn", KINDS)
def test_the_loss_of_zero_projections_by_hand(ffn):
    for tied in (True, False):
        _zero_projections_by_hand(ffn, tied)


def _zero_projections_by_hand(ffn, tied):
    cell = tiny(ffn, tie_embeddings=tied)
    config = cell.config
    tree = weights.make_params(cell.specs, 5, "cpu")
    for path, leaf in weights.tree_leaves(tree):
        if path[0] == "stack":
            leaf.zero_()
    batch = train.batch_tensors({
        "tokens": np.array([[1, 2, 3, 4]], np.int32),
        "labels": np.array([[2, 3, 4, 0]], np.int32),
        "loss_mask": np.array([[1, 1, 1, 0]], np.float32)}, "cpu")
    got = float(cell.model.loss(tree, batch, config))
    # every branch adds zero: the logits are the normed embedding rows
    # against the table, or against the untied head
    E = tree["embedding"].double().numpy()
    W = E.T if tied else tree["lm_head"].double().numpy()
    x = E[[1, 2, 3, 4]]
    x = x / np.sqrt((x ** 2).mean(-1, keepdims=True) + config["norm_eps"])
    logits = x @ W
    logz = np.log(np.exp(logits).sum(-1))
    ce = np.mean([logz[i] - logits[i, [2, 3, 4][i]] for i in range(3)])
    # a uniform router's load-balance term is its weight, once a layer
    aux = config["num_layers"] * config["moe"]["router_aux_weight"] \
        if ffn == "moe" else 0.0
    assert got == pytest.approx(ce + aux, rel=1e-5)


def test_the_gaps_by_hand():
    t = torch.tensor
    prog = train.Readings(losses=[10.0, 9.0, 8.0],
                          grad_norms=[1.0, 2.0, 4.0],
                          change_norms=[1.0, 1.0, 0.0],
                          grad_sample=[t([3., 4.]), t([1., 1.]), t([0., 0.])])
    ref = train.Readings(losses=[10.0, 9.9, 8.4], grad_norms=[1.0, 2.0, 3.0],
                         change_norms=[1.0, 2.0, 5.0],
                         raw_grad_norms=[1.0, 1e-9, 1.0],
                         grad_sample=[t([3., 4.]), t([1., 0.]), t([0., 2.])])
    values, where = compare.gaps(prog, ref)
    assert values["loss"] == pytest.approx(0.9 / 9.9) and where["loss"] == 1
    assert values["loss3"] == pytest.approx(0.4 / 8.4)
    assert values["grad"] == pytest.approx(1 / 3) and where["grad"] == 2
    # the sampled differences 0, 1, 2 over the larger of each leaf's norm
    # (5, 1, 2) and the median leaf's (2): 0, 0.5, 1
    assert values["grad_elem"] == pytest.approx(0.5)
    assert where["grad_elem"] == [2, pytest.approx(1.0)]
    # leaf 1's gradient is nought to rounding: left out of the change
    assert values["change"] == pytest.approx(1.0) and where["change"] == 2
    assert "ef" not in values
    ok, rows = compare.judge(values, {"loss": 0.1, "grad": None,
                                      "change": 1.5})
    assert ok and rows[2] == ["grad", values["grad"], None]
    assert [r[0] for r in rows] == ["loss", "loss3", "grad", "grad_elem",
                                    "change"]
    # a side that kept no sample (a frozen step's sync never ran) reads 1
    assert compare.gaps(dataclasses.replace(prog, grad_sample=None),
                        ref)[0]["grad_elem"] == 1.0
    assert not compare.judge(values, {"change": 0.5})[0]
    assert not compare.judge(dict(values, loss=math.nan),
                             {"loss": 1})[0]


def test_the_residuals_gap_by_hand():
    base = dict(losses=[1.0, 1.0, 1.0], grad_norms=[1.0],
                change_norms=[1.0], grad_sample=[torch.ones(2)])
    ref = train.Readings(**base, raw_grad_norms=[1.0],
                         ef_norms=[[2.0, 4.0, 1.0], [3.0, 4.0, 1.0]])
    prog = train.Readings(**base, ef_norms=[[2.0, 4.0, 1.0],
                                            [3.0, 2.0, 1.5]])
    values, where = compare.gaps(prog, ref)
    # step 1, leaf 1: |2 - 4| / 4; leaf 2 against the median leaf's 3
    assert values["ef"] == pytest.approx(0.5) and where["ef"] == [1, 1]
    assert not compare.judge(values, {"ef": 0.4})[0]
    assert compare.judge(values, {"ef": 0.6})[0]


@pytest.fixture
def one_rank_world():
    from perfbench.rank import close_world, init_world

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    init_world(0, 1, torch.device("cpu"), port)
    yield
    close_world()


@pytest.mark.parametrize("kind", KINDS, ids=[
    DP1, "dp4.minicpm-2b-4l.2x2.bf16"])
def test_the_reference_follows_the_program_at_a_tiny_float32_size(
        kind, one_rank_world):
    from perfbench.rank import run_rank

    res = run_rank(tiny(kind), 2 ** 31 + 7, rank=0, world=1, device="cpu",
                   seconds=0.0, trace=False, window=False)
    values, _ = compare.gaps(res.check["program"], res.check["reference"])
    assert max(values["loss"], values["loss3"]) < 1e-6
    assert values["grad"] < 1e-5 and values["change"] < 1e-4
    assert values.get("ef", 0.0) < 1e-5 and values["grad_elem"] < 1e-5
    assert ("ef" in values) == (kind == "moe")
