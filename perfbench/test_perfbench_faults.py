"""A run whose timed path is broken underneath comes out not correct:
the cell's run (without the harness's look for a card) on the CPU at a
small float32 size, held to the cell's own limits, once for each fault
the cell can have (``rank.FAULTS``: the exchange between chips only where
there are chips, the residual only under error feedback), and the
control (the reference at float8 in the program's place) likewise.  The
sound run of the same size is correct.  The harness's four-rank path is
driven the same way on a 2x2 gloo world, by a dense decoder under an
uncompressed sync at the limits the four-card cell had."""

import dataclasses
import socket

import pytest
import torch

from perfbench import manifest as mf
from perfbench.harness import launch
from perfbench.rank import FAULTS, run_rank
from perfbench.reference import compare, train

SEED = 2 ** 32 + 11
# small, but with the cells' logit scale (0.02 * sqrt(d) at the
# embedding's init): a control's or a fault's change of the loss reads as
# it would at the cells' widths; 64 tokens a step, so that one altered
# token is a visible share of them.  The wire carries two bits here: over
# leaves this small, two bits leave most elements at zero after the round
# trip as four do over the cell's leaves of 10^8 elements, whose scale
# follows their largest, so that a dropped residual reads as on the chip
# (`ef` 0.34, `change` 0.35 here; 0.31-0.34 and 0.25-0.32 at the cell's
# size on an H100)
TINY = {"num_layers": 2, "d_model": 256, "num_heads": 4, "num_kv_heads": 4,
        "head_dim": 64, "d_ff": 512, "vocab_size": 256, "dtype": "float32"}
TINY_MOE = {"num_experts": 4, "top_k": 2, "d_expert": 128,
            "num_shared_experts": 1}
DP1 = "dp1.deepseek-moe-16b-2l.int4ef"
# the limits that the held four-card cell (minicpm-2b-4l, bf16, 2x2) was
# calibrated to on the chip (PERF.md, Open questions)
FOUR_RANK_LIMITS = {"loss": 4.5e-4, "grad": 0.12, "change": 0.004}


def tiny(four_ranks: bool = False):
    cell = mf.load_cell(DP1)
    config = dict(cell.config, **TINY)
    config["moe"] = dict(config["moe"], **TINY_MOE)
    traffic = dict(cell.traffic, global_batch=4, seq_len=16)
    cell = dataclasses.replace(cell, config=config, traffic=traffic,
                               spec=dict(cell.spec, sync=dict(
                                   cell.spec["sync"], compress_bits=2)))
    if not four_ranks:
        return cell
    config = dict(config, arch="minicpm-2b", ffn="dense")
    del config["moe"]
    return dataclasses.replace(cell, chips=4, config=config, spec=dict(
        cell.spec, grid=[2, 2], sync={"algorithm": "auto", "mean": True},
        limits=FOUR_RANK_LIMITS))


def _faults_of(cell) -> list:
    sync = cell.spec["sync"]
    return [f for f in FAULTS
            if (f != "no_exchange" or cell.chips > 1)
            and (f != "ef_dropped" or sync.get("error_feedback"))]


def fault_runs(rank, device, cell, faults):
    """Every run of ``faults`` (``None``: sound) in one world: rank 0's
    ``[(fault, correct, rows)]``."""
    out = []
    for fault in faults:
        res = run_rank(cell, SEED, rank=rank, world=cell.chips,
                       device=device, seconds=0.0, trace=False, fault=fault,
                       window=False)
        if rank == 0:
            out.append((fault, res.check["correct"], res.check["rows"]))
    return out


@pytest.fixture
def one_rank_world():
    from perfbench.rank import close_world, init_world

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    init_world(0, 1, torch.device("cpu"), port)
    yield
    close_world()


@pytest.mark.parametrize("fault", [None] + _faults_of(tiny()))
def test_one_chip_cell_is_correct_only_when_sound(fault, one_rank_world):
    cell = tiny()
    [(f, correct, rows)] = fault_runs(0, "cpu", cell, [fault])
    assert correct == (fault is None), rows


def test_the_one_chip_cell_can_have_every_fault_but_the_exchange():
    assert _faults_of(tiny()) == [f for f in FAULTS if f != "no_exchange"]


def test_four_chip_cell_is_correct_only_when_sound():
    cell = tiny(four_ranks=True)
    faults = [None] + _faults_of(cell)
    assert "no_exchange" in faults and "ef_dropped" not in faults
    got = launch(fault_runs, cell.chips, cell, faults, device_type="cpu")
    for fault, correct, rows in got:
        assert correct == (fault is None), (fault, rows)


@pytest.mark.parametrize("four_ranks", [False, True], ids=[
    DP1, "dp4.minicpm-2b-4l.2x2.bf16"])
def test_the_control_is_not_correct(four_ranks):
    cell = tiny(four_ranks)
    ref = train.run(cell, SEED, "cpu")
    ctl = train.run(cell, SEED, "cpu", mm=train.fp8_matmul)
    values, _ = compare.gaps(ctl, ref)
    correct, rows = compare.judge(values, cell.spec["limits"])
    assert not correct, rows
