"""The port's transport plain versions against the JAX package's kernels.

Same inputs (numpy, from seeds) through ``repro.kernels.transport`` — the
jnp oracle (``impl="xla"``) over the full sweep, the Pallas kernel in
interpret mode on a subset — and through ``repro_torch.kernels.transport``
on CPU tensors (its plain version).  Wire bytes must be bit-identical and
dequantized values exactly equal.  The CUDA kernels themselves are held
against the same plain versions on the card by ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from repro.kernels import transport as jt
from repro_torch.kernels import transport as tt

from _torch_fakes import fake_kernel_route


def _case(seed, bits, L, base, R, row_stride, cols):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((R, cols)) * rng.uniform(0, 8, (R, cols)))
    x = x.astype(np.float32)
    span = base + (R - 1) * row_stride + cols + 1
    cuts = rng.choice(np.arange(1, span), size=L - 1, replace=False)
    offsets = (0,) + tuple(sorted(int(c) for c in cuts))
    qmax = 2 ** (bits - 1) - 1
    # scales at and below absmax/qmax: both rounding and clipping happen
    scales = (np.abs(x).max() / qmax * rng.uniform(0.25, 1.25, L)).astype(
        np.float32
    )
    return x, scales, offsets


def _both(x, scales, offsets, bits, base, row_stride, cols, impl):
    kw = dict(offsets=offsets, bits=bits, base=base, row_stride=row_stride)
    wj = np.asarray(
        jt.quantize_pack(jnp.asarray(x), jnp.asarray(scales), impl=impl, **kw)
    )
    wt = tt.quantize_pack(torch.from_numpy(x), torch.from_numpy(scales), **kw)
    assert wt.dtype == {4: torch.uint8}.get(bits, torch.int8)
    np.testing.assert_array_equal(wt.numpy(), wj)
    # dequantize: the quantized bytes and every other byte value
    rng = np.random.default_rng(bits * 7 + len(offsets))
    noise = rng.integers(0, 256, wj.shape, dtype=np.uint8).view(wj.dtype)
    for w in (wj, noise):
        dj = np.asarray(jt.unpack_dequantize(
            jnp.asarray(w), jnp.asarray(scales), cols=cols, impl=impl, **kw
        ))
        dt = tt.unpack_dequantize(
            torch.from_numpy(np.array(w)),
            torch.from_numpy(scales), cols=cols, **kw,
        )
        assert dt.shape == dj.shape
        np.testing.assert_array_equal(dt.numpy(), dj)


@pytest.mark.parametrize("rows", [(1, 0), (3, 0), (3, "B")])
@pytest.mark.parametrize("base", [0, 37])
@pytest.mark.parametrize("L", [1, 3, 5])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_plain_matches_jax_oracle(bits, L, base, rows):
    R, rs = rows
    cols = 300  # ragged: not a multiple of the 256-element block
    rs = cols if rs == "B" else rs
    x, scales, offsets = _case(bits * 100 + L, bits, L, base, R, rs, cols)
    _both(x, scales, offsets, bits, base, rs, cols, impl="xla")


@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_plain_matches_pallas_interpret(bits, L):
    R, cols, base = 2, 520, 11
    x, scales, offsets = _case(bits + L, bits, L, base, R, cols, cols)
    _both(x, scales, offsets, bits, base, cols, cols, impl="pallas")


@settings(max_examples=25, deadline=None)
@given(
    bits=st.sampled_from([2, 3, 4, 5, 8]),
    L=st.integers(1, 6),
    base=st.integers(0, 1000),
    R=st.integers(1, 3),
    strided=st.booleans(),
    cols=st.integers(1, 700),
    seed=st.integers(0, 2**16),
)
def test_plain_matches_jax_oracle_fuzz(bits, L, base, R, strided, cols, seed):
    # L segments need L - 1 distinct cuts; base=0, R=1 leaves only cols
    # positions to cut at, so a narrow row is widened to hold them
    cols = max(cols, L - 1)
    rs = cols if strided else 0
    x, scales, offsets = _case(seed, bits, L, base, R, rs, cols)
    _both(x, scales, offsets, bits, base, rs, cols, impl="xla")


def test_wrapper_rejects_bad_inputs():
    x = torch.zeros((1, 256))
    s = torch.ones(1)
    with pytest.raises(ValueError):
        tt.quantize_pack(x.double(), s, offsets=(0,), bits=8)
    with pytest.raises(ValueError):
        tt.quantize_pack(x, s, offsets=(0, 1), bits=8)
    with pytest.raises(ValueError):
        tt.quantize_pack(x, s, offsets=(0,), bits=9)
    with pytest.raises(ValueError):
        tt.unpack_dequantize(
            torch.zeros((1, 100), dtype=torch.int8), s, offsets=(0,),
            bits=8, cols=100,
        )
    with pytest.raises(ValueError):
        tt.unpack_dequantize(
            torch.zeros((1, 256), dtype=torch.int8), s, offsets=(0,),
            bits=4, cols=100,
        )


def test_cpu_route_launches_no_kernel():
    tt.reset_launch_counts()
    x = torch.randn(2, 300)
    s = torch.ones(1)
    w = tt.quantize_pack(x, s, offsets=(0,), bits=4)
    tt.unpack_dequantize(w, s, offsets=(0,), bits=4, cols=300)
    assert tt.LAUNCHES == {"quantize_pack": 0, "unpack_dequantize": 0}


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rng = np.random.default_rng(0)
    for bits in (2, 3, 4, 8):
        x, scales, offsets = _case(bits, bits, 3, 5, 4, 700, 700)
        xc = torch.from_numpy(x).cuda()
        sc = torch.from_numpy(scales).cuda()
        kw = dict(offsets=offsets, bits=bits, base=5, row_stride=700)
        wk = tt.quantize_pack(xc, sc, **kw)
        wp = tt.quantize_pack(xc, sc, impl="plain", **kw)
        assert torch.equal(wk, wp)
        noise = torch.from_numpy(
            rng.integers(0, 256, tuple(wk.shape), dtype=np.uint8)
        ).cuda().view(wk.dtype)
        for w in (wk, noise):
            assert torch.equal(
                tt.unpack_dequantize(w, sc, cols=700, **kw),
                tt.unpack_dequantize(w, sc, cols=700, impl="plain", **kw),
            )


@pytest.mark.parametrize("bits,wire_cols,cols", [
    (4, 256, 500), (8, 512, 500), (3, 256, 256),
])
@pytest.mark.parametrize("base,row_stride", [(0, 0), (37, 512)])
def test_unpack_dequantize_marshals_the_c_call(monkeypatch, bits, wire_cols,
                                               cols, base, row_stride):
    rec = fake_kernel_route(monkeypatch, tt._build, tt)
    tt.reset_launch_counts()
    R, offsets = 3, (0, 7, 7, 300)
    wire = torch.zeros((R, wire_cols), dtype=tt.wire_dtype(bits))
    scales = torch.ones(len(offsets))
    out = tt.unpack_dequantize(wire, scales, offsets=offsets, bits=bits,
                               cols=cols, base=base, row_stride=row_stride)
    ((name, args),) = rec.calls
    assert name == "repro_unpack_dequantize"
    dev_offsets = tt._device_offsets(offsets, wire.device)
    assert args == (
        wire.data_ptr(), out.data_ptr(), dev_offsets.data_ptr(),
        scales.data_ptr(), len(offsets), R, wire_cols, base, row_stride, bits,
        0, 0,
    )
    assert dev_offsets.tolist() == list(offsets)
    assert dev_offsets.dtype == torch.int64
    # padded width (R, Cw / wire block * 256), sliced to the caller's cols
    assert out.shape == (R, cols) and out.dtype == torch.float32
    assert out.stride() == (wire_cols * (2 if bits == 4 else 1), 1)
    assert tt.LAUNCHES == {"quantize_pack": 0, "unpack_dequantize": 1}
    tt.reset_launch_counts()


def test_unpack_dequantize_hands_the_kernel_an_aligned_wire(monkeypatch):
    rec = fake_kernel_route(monkeypatch, tt._build, tt)
    # a contiguous view one byte into its buffer: the kernel loads 16 bytes
    # at a time, so the wrapper passes an aligned copy
    wire = torch.zeros(2 * 128 + 1, dtype=torch.uint8)[1:].view(2, 128)
    assert wire.data_ptr() % 16
    tt.unpack_dequantize(wire, torch.ones(1), offsets=(0,), bits=4, cols=256)
    ((_, args),) = rec.calls
    assert args[0] % 16 == 0 and args[0] != wire.data_ptr()
    tt.reset_launch_counts()


@pytest.mark.parametrize("bits,cols,wire_cols", [
    (4, 500, 256), (8, 512, 512), (2, 300, 512), (7, 256, 256),
])
@pytest.mark.parametrize("base,row_stride", [(0, 0), (37, 500)])
def test_quantize_pack_marshals_the_c_call(monkeypatch, bits, cols,
                                           wire_cols, base, row_stride):
    rec = fake_kernel_route(monkeypatch, tt._build, tt)
    tt.reset_launch_counts()
    R, offsets = 3, (0, 7, 7, 300)
    x = torch.zeros((R, cols))
    scales = torch.ones(len(offsets))
    out = tt.quantize_pack(x, scales, offsets=offsets, bits=bits, base=base,
                           row_stride=row_stride)
    ((name, args),) = rec.calls
    assert name == "repro_quantize_pack"
    padded = -(-cols // 256) * 256
    dev_offsets = tt._device_offsets(offsets, x.device)
    # C signature: x, out, offsets, scales, L, R, C, base, row_stride,
    # bits, device, stream; C the width padded to whole 256-element blocks
    assert args[1:] == (
        out.data_ptr(), dev_offsets.data_ptr(), scales.data_ptr(),
        len(offsets), R, padded, base, row_stride, bits, 0, 0,
    )
    assert args[0] % 16 == 0
    assert (args[0] == x.data_ptr()) == (padded == cols)
    assert out.shape == (R, wire_cols) and out.dtype == tt.wire_dtype(bits)
    assert tt.LAUNCHES == {"quantize_pack": 1, "unpack_dequantize": 0}
    tt.reset_launch_counts()


def test_quantize_pack_hands_the_kernel_an_aligned_x(monkeypatch):
    rec = fake_kernel_route(monkeypatch, tt._build, tt)
    # a contiguous view one float into its buffer, of whole blocks (no
    # padding copy): the kernel loads x as float4s, so the wrapper passes
    # an aligned copy
    x = torch.zeros(2 * 512 + 1)[1:].view(2, 512)
    assert x.data_ptr() % 16
    tt.quantize_pack(x, torch.ones(1), offsets=(0,), bits=4)
    ((_, args),) = rec.calls
    assert args[0] % 16 == 0 and args[0] != x.data_ptr()
    assert args[5:7] == (2, 512)
    tt.reset_launch_counts()
