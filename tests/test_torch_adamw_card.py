"""The port's AdamW kernels on the card, against its plain version.

* ``adamw_apply`` is bit for bit ``_update_leaves`` for every parameter,
  gradient and moment dtype, with and without clipping, over 1-D and
  higher leaves, sizes that are not a multiple of the 8-element group,
  16-byte-misaligned leaves, and one leaf of a stacked expert weight of
  deepseek-moe-16b (369,098,752 elements).
* ``sq_norm`` lies within 1e-6 (relative) of a float64 sum and gives the
  same bits twice, over more leaves than one launch takes.
* Three steps of ``make_dp_train_step`` on a reduced deepseek-moe in bf16
  (int4 + error feedback) give the same bits on the kernel route and on
  the plain route, the norm forced to the kernel's on both.

Needs a CUDA card (the kernels have no CPU mode); skipped without one.
Run on the card: ``PYTHONPATH=src python3 -m pytest -q -m cuda
tests/test_torch_adamw_card.py``.  No JAX here: the card's machine has
none.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch import tree
from repro_torch.configs import ARCHS, OptimizerConfig, reduced
from repro_torch.core import CommPolicy
from repro_torch.data import SyntheticLM
from repro_torch.kernels import adamw as kadamw
from repro_torch.launch import (init_train_state, make_dp_train_step,
                                mesh_topology)
from repro_torch.optim import adamw as optim_adamw

pytestmark = pytest.mark.cuda

HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
SHAPES = [(1000,), (37, 129), (3, 8, 16), (13,), (5, 7)]
EXPERTS = (2, 64, 2048, 1408)  # w_gate, w_up or w_down of the stacked MoE


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the AdamW kernels have no CPU mode")
    kadamw.reset_launch_counts()
    yield torch.device("cuda")
    kadamw.reset_launch_counts()
    torch.cuda.empty_cache()


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _misaligned(n, dtype, device):
    """A contiguous n-element view one element into its buffer."""
    return torch.empty(n + 1, dtype=dtype, device=device)[1:]


def _leaves(gen, shapes, pdt, gdt, mdt, device, misaligned=False):
    def make(shape, dtype, fill):
        x = fill(shape)
        if misaligned:
            t = _misaligned(x.numel(), dtype, device).view(shape)
            t.copy_(x)
            return t
        return x.to(dtype)

    rand = lambda s: torch.randn(s, generator=gen, device=device)  # noqa
    g = [make(s, gdt, lambda s: rand(s) * 3.0) for s in shapes]
    p = [make(s, pdt, lambda s: rand(s) * 0.5) for s in shapes]
    m = [make(s, mdt, lambda s: rand(s) * 0.1) for s in shapes]
    v = [make(s, mdt, lambda s: torch.rand(s, generator=gen, device=device)
              * 0.01) for s in shapes]
    return g, p, m, v


def _scalars(device, clip, step=3):
    f32 = lambda x: torch.full((), x, dtype=torch.float32,  # noqa: E731
                               device=device)
    c1 = 1.0 - torch.pow(f32(HYPER["b1"]), f32(step))
    c2 = 1.0 - torch.pow(f32(HYPER["b2"]), f32(step))
    return dict(scale=f32(0.3712) if clip else None, c1=c1, c2=c2,
                lr_t=f32(3e-4))


def _plain_vs_kernel(g, p, m, v, sc):
    """Both routes from the same leaves; returns (plain, kernel) leaves."""
    pp, pm, pv = ([t.clone() for t in ts] for ts in (p, m, v))
    state = optim_adamw.AdamWState(0, pm, pv)
    optim_adamw._update_leaves(g, state, pp, **sc, **HYPER)
    kadamw.adamw_apply(g, m, v, p, **sc, **HYPER)
    return (pp, pm, pv), (p, m, v)


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("mdt", DTYPES)
@pytest.mark.parametrize("gdt", DTYPES)
@pytest.mark.parametrize("pdt", DTYPES)
def test_adamw_apply_equals_the_plain_version_bitwise(card, pdt, gdt, mdt,
                                                      clip):
    gen = torch.Generator(device=card).manual_seed(7)
    sc = _scalars(card, clip)
    for misaligned in (False, True):
        g, p, m, v = _leaves(gen, SHAPES, pdt, gdt, mdt, card, misaligned)
        plain, kernel = _plain_vs_kernel(g, p, m, v, sc)
        for want_ts, got_ts in zip(plain, kernel):
            for want, got in zip(want_ts, got_ts):
                assert got.dtype == want.dtype
                assert torch.equal(_bits(got), _bits(want))
    assert kadamw.LAUNCHES["adamw_apply"] == 2 * len(SHAPES)


def test_adamw_apply_on_an_expert_leaf_bitwise(card):
    gen = torch.Generator(device=card).manual_seed(8)
    g, p, m, v = _leaves(gen, [EXPERTS], torch.bfloat16, torch.bfloat16,
                         torch.float32, card)
    plain, kernel = _plain_vs_kernel(g, p, m, v, _scalars(card, True))
    for want_ts, got_ts in zip(plain, kernel):
        assert torch.equal(_bits(got_ts[0]), _bits(want_ts[0]))


def _float64_sum(leaves) -> float:
    return sum(float(t.double().square().sum()) for t in leaves)


def test_sq_norm_is_deterministic_and_close_to_float64(card):
    gen = torch.Generator(device=card).manual_seed(9)
    leaves = []
    for i in range(70):  # two launches of 64 leaves at most
        n = int(torch.randint(1, 50_000, (), generator=gen, device=card))
        dtype = DTYPES[i % 2]
        x = torch.randn(n, generator=gen, device=card) * (i + 1)
        t = _misaligned(n, dtype, card) if i % 7 == 3 else torch.empty(
            n, dtype=dtype, device=card)
        leaves.append(t.copy_(x))
    leaves.append(torch.empty(0, device=card))
    leaves.append(torch.randn(EXPERTS, generator=gen, device=card).to(
        torch.bfloat16))
    a, b = kadamw.sq_norm(leaves), kadamw.sq_norm(leaves)
    assert a.dtype == torch.float32 and a.dim() == 0
    assert torch.equal(_bits(a), _bits(b))
    want = _float64_sum(leaves)
    assert abs(float(a) - want) <= 1e-6 * want
    assert kadamw.LAUNCHES["sq_norm"] == 2


def test_dp_step_equals_the_plain_route_bitwise(card, monkeypatch):
    cfg = dataclasses.replace(reduced(ARCHS["deepseek-moe-16b"]),
                              dtype="bfloat16")
    opt = OptimizerConfig(lr=1e-3, schedule="constant", warmup_steps=1)
    pol = CommPolicy(algorithm="nap", mean=True, compress_bits=4,
                     error_feedback=True)
    data = SyntheticLM(cfg.vocab_size, 64, 4, seed=0)

    def run():
        step = make_dp_train_step(cfg, opt, mesh_topology(1, 1), pol,
                                  device="cuda")
        state = init_train_state(
            cfg, opt, pol, device="cuda",
            generator=torch.Generator(device=card).manual_seed(0))
        losses, norms = [], []
        for s in range(3):
            state, m = step(state, data.batch(s, card))
            losses.append(m["loss"].clone())
            norms.append(m["grad_norm"].clone())
        leaves = [t.detach().clone() for t in
                  tree.leaves(state["model"].params())]
        return losses, norms, leaves, [t.clone() for t in state["opt"].mu]

    kernel = run()
    assert kadamw.LAUNCHES["sq_norm"] == 3
    assert kadamw.LAUNCHES["adamw_apply"] == 3 * len(kernel[2])
    kadamw.reset_launch_counts()
    # the plain route, the one CPU leaves take, its norm the kernel's (the
    # two sums' orders differ)
    monkeypatch.setattr(optim_adamw, "_use_kernels", lambda *leaves: False)
    monkeypatch.setattr(optim_adamw, "global_norm",
                        lambda g: torch.sqrt(kadamw.sq_norm(g)))
    plain = run()
    assert kadamw.LAUNCHES["adamw_apply"] == 0
    for want_ts, got_ts in zip(plain, kernel):
        for want, got in zip(want_ts, got_ts):
            assert torch.equal(_bits(got), _bits(want))
