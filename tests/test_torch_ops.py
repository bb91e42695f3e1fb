"""The port's attention and scan wrappers against the JAX package's kernels.

Same inputs (numpy, from seeds) through ``repro.kernels.ops`` twice — the
Pallas kernel in interpret mode (``impl="pallas"`` on the CPU) and the jnp
oracle (``impl="xla"``) — and through ``repro_torch.kernels.ops`` on CPU
tensors (its plain versions, with the GQA mapping and the head layout of
the wrappers).  Tolerances are those of ``tests/test_kernels.py``: 2e-5
for float32 and 2e-2 for bf16, compared in float32.  The CUDA kernels are
held against the same plain versions on the card by ``chip_smoke.py``
(phases ``ops_kernels`` and ``ops_full_width``).
"""

from __future__ import annotations

import ctypes
import importlib
import math
import re

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.rwkv6_scan import rwkv6_scan_pallas
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import adamw as kadamw

from _torch_fakes import fake_kernel_route

# the package exports the wrappers under their submodules' names
tfa = importlib.import_module("repro_torch.kernels.flash_attention")
trw = importlib.import_module("repro_torch.kernels.rwkv6_scan")
tms = importlib.import_module("repro_torch.kernels.mamba_scan")

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
_NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arr(rng, shape, dtype, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32).astype(
        _NP[dtype]
    )


def _torch(a, dtype):
    return torch.from_numpy(a.astype(np.float32)).to(_TORCH[dtype])


def _close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(
        got.to(torch.float32).numpy(),
        np.asarray(want).astype(np.float32),
        rtol=TOL[dtype], atol=TOL[dtype],
    )


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,H,KV,hd",
    [
        (1, 100, 4, 2, 32),   # ragged S, GQA 4 -> 2
        (1, 128, 2, 2, 64),
        (1, 64, 2, 1, 128),   # GQA 2 -> 1
    ],
)
@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None),
    (True, 32, None),
    (True, None, 30.0),
    (False, None, None),
])
def test_flash_attention_matches_jax(B, S, H, KV, hd, causal, window,
                                     softcap, dtype):
    rng = np.random.default_rng(B * S + hd + H)
    q = _arr(rng, (B, S, H, hd), dtype)
    k = _arr(rng, (B, S, KV, hd), dtype)
    v = _arr(rng, (B, S, KV, hd), dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ops.flash_attention(
        _torch(q, dtype), _torch(k, dtype), _torch(v, dtype), **kw
    )
    assert got.shape == (B, S, H, hd) and got.dtype == _TORCH[dtype]
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    for impl in ("pallas", "xla"):
        want = jops.flash_attention(
            jq, jk, jv, impl=impl, block_q=64, block_k=64, **kw
        )
        _close(got, want, dtype)


@pytest.mark.parametrize("window", [None, 20])
def test_flash_attention_flat_layout_matches_pallas(window):
    """The (BH, S, hd) form against ``flash_attention_pallas`` itself."""
    rng = np.random.default_rng(7)
    q, k, v = (_arr(rng, (3, 72, 32), "float32") for _ in range(3))
    got = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        window=window, softcap=50.0,
    )
    want = flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        softcap=50.0, block_q=32, block_k=32, interpret=True,
    )
    _close(got, want, "float32")


# keys longer / shorter than the queries: (B, S, Sk, H, KV, hd)
SK_SHAPES = [
    (1, 40, 72, 2, 2, 16),    # Sk > S
    (1, 72, 40, 2, 1, 32),    # Sk < S, GQA 2 -> 1
    (2, 100, 37, 4, 2, 64),   # Sk < S, ragged against 32-row blocks
]
SK_MASKS = [
    (True, None, None),
    (True, 16, None),     # Sk < S: rows past the last key's window
    (True, None, 30.0),
    (False, None, None),
    (False, 8, 50.0),     # Sk < S: fully masked rows, with the softcap
]


def _valid_rows(S, Sk, causal, window):
    """(S,) bool: query rows with at least one valid key."""
    rel = np.arange(S)[:, None] - np.arange(Sk)[None, :]
    ok = np.ones_like(rel, dtype=bool)
    if causal:
        ok &= rel >= 0
    if window is not None:
        ok &= rel < window
    return ok.any(axis=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Sk,H,KV,hd", SK_SHAPES)
@pytest.mark.parametrize("causal,window,softcap", SK_MASKS)
def test_flash_attention_other_key_lengths_match_jax(B, S, Sk, H, KV, hd,
                                                     causal, window, softcap,
                                                     dtype):
    """k / v of Sk != S keys, start-aligned masks (``rel = q - k``).

    The port matches the reference's jnp oracle on every row.  Rows with
    no valid key give 0 there (and in the port); the reference's Pallas
    kernel leaves the mean of V over its padded key tiles in such rows
    (p = 1 on every masked key), so it is held on the other rows."""
    rng = np.random.default_rng(S * Sk + hd + H)
    q = _arr(rng, (B, S, H, hd), dtype)
    k = _arr(rng, (B, Sk, KV, hd), dtype)
    v = _arr(rng, (B, Sk, KV, hd), dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ops.flash_attention(
        _torch(q, dtype), _torch(k, dtype), _torch(v, dtype), **kw
    )
    assert got.shape == (B, S, H, hd) and got.dtype == _TORCH[dtype]
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    _close(got, jops.flash_attention(jq, jk, jv, impl="xla", **kw), dtype)
    rows = _valid_rows(S, Sk, causal, window)
    want = jops.flash_attention(jq, jk, jv, impl="pallas", block_q=32,
                                block_k=32, **kw)
    _close(got[:, rows], np.asarray(want)[:, rows], dtype)
    assert not got[:, ~rows].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_rows_without_keys_give_zero(dtype):
    # a window of 4 over 10 keys: queries 13.. see no key
    rng = np.random.default_rng(3)
    q = _torch(_arr(rng, (1, 20, 2, 16), dtype), dtype)
    k, v = (_torch(_arr(rng, (1, 10, 2, 16), dtype), dtype) for _ in "kv")
    out = ops.flash_attention(q, k, v, causal=True, window=4)
    assert out[:, 13:].eq(0).all() and out[:, :13].abs().sum(-1).gt(0).all()
    np.testing.assert_array_equal(
        _valid_rows(20, 10, True, 4), np.arange(20) < 13)


# ---------------------------------------------------------------------------
# rwkv6 scan
# ---------------------------------------------------------------------------


def _rwkv_inputs(rng, shape, dtype):
    r, k, v = (_arr(rng, shape, dtype) for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))).astype(
        np.float32).astype(_NP[dtype])  # decay in (0, 1)
    return r, k, v, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,H,hd", [(1, 100, 2, 32), (2, 64, 2, 16), (1, 40, 1, 64)]
)
def test_rwkv6_scan_matches_jax(B, S, H, hd, dtype):
    rng = np.random.default_rng(B + S + hd)
    r, k, v, w = _rwkv_inputs(rng, (B, S, H, hd), dtype)
    u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    got = ops.rwkv6_scan(
        *(_torch(a, dtype) for a in (r, k, v, w)), torch.from_numpy(u)
    )
    assert got.shape == (B, S, H, hd) and got.dtype == torch.float32
    j = [jnp.asarray(a) for a in (r, k, v, w, u)]
    for impl in ("pallas", "xla"):
        _close(got, jops.rwkv6_scan(*j, impl=impl, chunk=64), dtype)


def test_rwkv6_scan_flat_layout_matches_pallas():
    """The (BH, S, hd) form, with one bonus row per (batch, head)."""
    rng = np.random.default_rng(11)
    r, k, v, w = _rwkv_inputs(rng, (3, 50, 16), "float32")
    u = (rng.standard_normal((3, 16)) * 0.1).astype(np.float32)
    got = trw.rwkv6_scan(*(torch.from_numpy(a) for a in (r, k, v, w, u)))
    want = rwkv6_scan_pallas(
        *(jnp.asarray(a) for a in (r, k, v, w, u)), chunk=16, interpret=True
    )
    _close(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_scan_takes_a_bf16_bonus(dtype):
    """A bf16 ``u`` is cast to float32, as the reference's kernel does
    (``u_ref[0].astype(float32)``)."""
    B, S, H, hd = 1, 8, 2, 16
    rng = np.random.default_rng(21)
    r, k, v, w = _rwkv_inputs(rng, (B, S, H, hd), dtype)
    u = _arr(rng, (H, hd), "bfloat16", scale=0.1)
    got = ops.rwkv6_scan(*(_torch(a, dtype) for a in (r, k, v, w)),
                         _torch(u, "bfloat16"))
    assert got.shape == (B, S, H, hd) and got.dtype == torch.float32
    j = [jnp.asarray(a) for a in (r, k, v, w, u)]
    for impl in ("pallas", "xla"):
        _close(got, jops.rwkv6_scan(*j, impl=impl, chunk=8), dtype)


# ---------------------------------------------------------------------------
# mamba scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,d,N", [(2, 50, 40, 4), (1, 70, 40, 16), (1, 64, 96, 8)]
)
def test_mamba_scan_matches_jax(B, S, d, N, dtype):
    rng = np.random.default_rng(B * S + d + N)
    x = _arr(rng, (B, S, d), dtype)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, d)))).astype(
        np.float32).astype(_NP[dtype])  # softplus: dt > 0
    A = -np.exp(rng.standard_normal((d, N)) * 0.5).astype(np.float32)
    Bm = _arr(rng, (B, S, N), dtype)
    Cm = _arr(rng, (B, S, N), dtype)
    got = ops.mamba_scan(
        _torch(x, dtype), _torch(dt, dtype), torch.from_numpy(A),
        _torch(Bm, dtype), _torch(Cm, dtype),
    )
    assert got.shape == (B, S, d) and got.dtype == torch.float32
    j = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    for impl in ("pallas", "xla"):
        # ragged tiles in the reference: chunk 16 over S, block 32 over d
        _close(got, jops.mamba_scan(*j, impl=impl, chunk=16, block_d=32),
               dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_takes_a_bf16_A(dtype):
    """A bf16 ``A`` is cast to float32, as the reference's kernel does
    (``A_ref[...].astype(float32)``)."""
    B, S, d, N = 1, 8, 32, 4
    rng = np.random.default_rng(22)
    x = _arr(rng, (B, S, d), dtype)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, d)))).astype(
        np.float32).astype(_NP[dtype])
    A = (-np.exp(rng.standard_normal((d, N)) * 0.5)).astype(
        np.float32).astype(ml_dtypes.bfloat16)
    Bm, Cm = _arr(rng, (B, S, N), dtype), _arr(rng, (B, S, N), dtype)
    got = ops.mamba_scan(_torch(x, dtype), _torch(dt, dtype),
                         _torch(A, "bfloat16"), _torch(Bm, dtype),
                         _torch(Cm, dtype))
    assert got.shape == (B, S, d) and got.dtype == torch.float32
    j = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    for impl in ("pallas", "xla"):
        _close(got, jops.mamba_scan(*j, impl=impl, chunk=8, block_d=32),
               dtype)


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------


def _flash_args(hd=32, dtype=torch.float32, device="cpu"):
    return [torch.zeros((1, 8, 2, hd), dtype=dtype, device=device)
            for _ in range(3)]


def _scan_args(N=4, dtype=torch.float32):
    x = torch.zeros((1, 8, 16), dtype=dtype)
    BC = torch.zeros((1, 8, N), dtype=dtype)
    return [x, x.clone(), torch.zeros((16, N)), BC, BC.clone()]


def _rwkv_args(hd=16, dtype=torch.float32):
    return [torch.zeros((1, 8, 2, hd), dtype=dtype) for _ in range(4)] + [
        torch.zeros((2, hd))]


@pytest.mark.parametrize("case", [
    "device", "meta_device", "dtype", "mixed_dtype", "hd", "impl", "window",
    "gqa", "no_keys", "kv_shapes",
])
def test_flash_attention_rejects(case):
    q, k, v = _flash_args()
    kw = {}
    if case == "device":
        k = k.to("meta")
    elif case == "meta_device":
        q, k, v = _flash_args(device="meta")
    elif case == "dtype":
        q, k, v = _flash_args(dtype=torch.float16)
    elif case == "mixed_dtype":
        v = v.to(torch.bfloat16)
    elif case == "hd":
        q, k, v = _flash_args(hd=48)
    elif case == "impl":
        kw["impl"] = "pallas"
    elif case == "window":
        kw["window"] = 0
    elif case == "gqa":
        k = v = torch.zeros((1, 8, 3, 32))
    elif case == "no_keys":
        k = v = torch.zeros((1, 0, 2, 32))
    elif case == "kv_shapes":
        k = torch.zeros((1, 9, 2, 32))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("case", [
    "device", "dtype", "mixed_dtype", "hd", "impl", "u_dtype", "u_shape",
])
def test_rwkv6_scan_rejects(case):
    r, k, v, w, u = _rwkv_args()
    kw = {}
    if case == "device":
        w = w.to("meta")
    elif case == "dtype":
        r, k, v, w, u = _rwkv_args(dtype=torch.float16)
    elif case == "mixed_dtype":
        k = k.to(torch.bfloat16)
    elif case == "hd":
        r, k, v, w, u = _rwkv_args(hd=128)
    elif case == "impl":
        kw["impl"] = "cuda"
    elif case == "u_dtype":
        # float32 and bf16 are taken (bf16 cast, as the reference does)
        u = u.to(torch.float16)
    elif case == "u_shape":
        u = torch.zeros((3, 16))
    with pytest.raises(ValueError):
        ops.rwkv6_scan(r, k, v, w, u, **kw)


@pytest.mark.parametrize("case", [
    "device", "dtype", "mixed_dtype", "N", "impl", "A_dtype", "BC_shape",
])
def test_mamba_scan_rejects(case):
    x, dt, A, B, C = _scan_args()
    kw = {}
    if case == "device":
        C = C.to("meta")
    elif case == "dtype":
        x, dt, A, B, C = _scan_args(dtype=torch.float64)
    elif case == "mixed_dtype":
        dt = dt.to(torch.bfloat16)
    elif case == "N":
        x, dt, A, B, C = _scan_args(N=5)
    elif case == "impl":
        kw["impl"] = "xla"
    elif case == "A_dtype":
        # float32 and bf16 are taken (bf16 cast, as the reference does)
        A = A.to(torch.float16)
    elif case == "BC_shape":
        B = torch.zeros((1, 7, 4))
    with pytest.raises(ValueError):
        ops.mamba_scan(x, dt, A, B, C, **kw)


def test_cpu_route_launches_no_kernel():
    ops.reset_launch_counts()
    ops.flash_attention(*_flash_args())
    ops.rwkv6_scan(*_rwkv_args())
    ops.mamba_scan(*_scan_args())
    for impl in ("auto", "plain"):
        ops.mamba_scan(*_scan_args(), impl=impl)
    assert ops.launch_counts() == {
        "flash_attention": 0, "rwkv6_scan": 0, "mamba_scan": 0,
    }


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "_DEFAULT_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(_build.source("mamba_scan"))
    assert not (tmp_path / "build").exists()


def test_every_kernel_source_is_built_for_sm90a_without_fast_math():
    names = sorted(p.stem for p in _build.source("x").parent.glob("*.cu"))
    assert names == ["adamw", "flash_attention", "mamba_scan", "rwkv6_scan",
                     "transport"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not any("fast_math" in f for f in _build.NVCC_FLAGS)
    for mod, src in ((tfa, "flash_attention"), (trw, "rwkv6_scan"),
                     (tms, "mamba_scan"), (kadamw, "adamw")):
        assert mod._SOURCE == _build.source(src) and mod._SOURCE.is_file()


def test_ref_names_match_the_reference():
    assert {"flash_attention_ref", "rwkv6_scan_ref", "mamba_scan_ref"} <= set(
        ref.__all__)


# ---------------------------------------------------------------------------
# the ctypes call, with the library stubbed out
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_launch(monkeypatch):
    """Route CPU tensors to the kernel path with a recording library."""
    rec = fake_kernel_route(monkeypatch, _build, tfa)
    ops.reset_launch_counts()
    yield rec
    ops.reset_launch_counts()


# code: the route, 1 = bf16 (one C call), 0 = float32 (the 3xTF32 split
# pre-pass, then the attention)
@pytest.mark.parametrize("dtype,code", [(torch.float32, 0),
                                        (torch.bfloat16, 1)])
@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (False, 5, 30.0),
])
@pytest.mark.parametrize("hd", [16, 128])
def test_flash_attention_marshals_the_c_call(fake_launch, dtype, code, causal,
                                             window, softcap, hd):
    B, S, H, KV = 2, 9, 4, 2
    q = torch.zeros((B, S, H, hd), dtype=dtype)
    k, v = (torch.zeros((B, S, KV, hd), dtype=dtype) for _ in range(2))
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap)
    mask = (int(causal), 0 if window is None else window,
            1.0 / math.sqrt(hd), 0.0 if softcap is None else softcap, 0, 0)
    if code == 1:
        ((name, args),) = fake_launch.calls
        assert name == "repro_flash_attention"
        assert args == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), B, S, S, H, KV, hd, *mask)
    else:
        (split, _), (name, args) = fake_launch.calls
        assert split == "repro_flash_attention_tf32x3_split"
        assert name == "repro_flash_attention_tf32x3"
        assert args[0] == q.data_ptr() and args[3] == out.data_ptr()
        assert args[4:] == (B, S, S, H, KV, hd, tfa.KEY_PAD, *mask)
    assert out.shape == q.shape and out.dtype == dtype
    assert out.data_ptr() not in (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert ops.launch_counts()["flash_attention"] == 1


@pytest.mark.parametrize("S,Sp", [(9, 64), (64, 64), (65, 128)])
def test_flash_attention_float32_marshals_the_split_then_the_attention(
        fake_launch, monkeypatch, S, Sp):
    # the pre-pass writes K's tf32 hi / lo planes (2, B, S, KV, hd) and
    # V^T's (2, B, KV, hd, Sp), S padded to KEY_PAD keys, into scratch the
    # wrapper allocates; the attention reads them
    B, H, KV, hd = 2, 4, 2, 32
    q = torch.zeros((B, S, H, hd))
    k, v = torch.zeros((B, S, KV, hd)), torch.zeros((B, S, KV, hd))
    made = []
    empty = torch.empty

    def spy(*shape, **kw):
        t = empty(*shape, **kw)
        made.append(t)
        return t

    monkeypatch.setattr(torch, "empty", spy)
    out = ops.flash_attention(q, k, v, window=7)
    monkeypatch.undo()
    ks, vts = (t for t in made if t.dim() == 5)
    assert ks.shape == (2, B, S, KV, hd) and vts.shape == (2, B, KV, hd, Sp)
    assert ks.dtype == vts.dtype == torch.float32
    (split, sargs), (name, args) = fake_launch.calls
    # C signatures: k, v, ks, vts, B, Sk, KV, hd, Sp, device, stream; then
    # q, ks, vts, o, B, S, Sk, H, KV, hd, Sp, causal, window, scale,
    # softcap, device, stream
    assert split == "repro_flash_attention_tf32x3_split"
    assert sargs == (k.data_ptr(), v.data_ptr(), ks.data_ptr(),
                     vts.data_ptr(), B, S, KV, hd, Sp, 0, 0)
    assert name == "repro_flash_attention_tf32x3"
    assert args == (q.data_ptr(), ks.data_ptr(), vts.data_ptr(),
                    out.data_ptr(), B, S, S, H, KV, hd, Sp, 1, 7,
                    1.0 / math.sqrt(hd), 0.0, 0, 0)
    assert ops.launch_counts()["flash_attention"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,Sk,Sp", [(9, 70, 128), (70, 9, 64), (64, 65, 128)])
def test_flash_attention_marshals_other_key_lengths(fake_launch, monkeypatch,
                                                    dtype, S, Sk, Sp):
    # both entries take the key length beside S; the float32 scratch is
    # sized by Sk (K's planes) and by Sk padded to KEY_PAD (V^T's)
    B, H, KV, hd = 2, 4, 2, 32
    q = torch.zeros((B, S, H, hd), dtype=dtype)
    k, v = (torch.zeros((B, Sk, KV, hd), dtype=dtype) for _ in "kv")
    made = []
    empty = torch.empty

    def spy(*shape, **kw):
        t = empty(*shape, **kw)
        made.append(t)
        return t

    monkeypatch.setattr(torch, "empty", spy)
    out = ops.flash_attention(q, k, v, causal=False, window=5)
    monkeypatch.setattr(torch, "empty", empty)
    assert out.shape == q.shape and out.dtype == dtype
    mask = (0, 5, 1.0 / math.sqrt(hd), 0.0, 0, 0)
    if dtype == torch.bfloat16:
        ((name, args),) = fake_launch.calls
        assert name == "repro_flash_attention"
        assert args[4:] == (B, S, Sk, H, KV, hd, *mask)
        return
    ks, vts = (t for t in made if t.dim() == 5)
    assert ks.shape == (2, B, Sk, KV, hd)
    assert vts.shape == (2, B, KV, hd, Sp)
    (_, sargs), (_, args) = fake_launch.calls
    assert sargs[4:] == (B, Sk, KV, hd, Sp, 0, 0)
    assert args[4:] == (B, S, Sk, H, KV, hd, Sp, *mask)


def test_flash_attention_flat_layout_marshals_one_head(fake_launch):
    q, k, v = (torch.zeros((6, 9, 32), dtype=torch.bfloat16)
               for _ in range(3))
    out = tfa.flash_attention(q, k, v, window=4)
    ((_, args),) = fake_launch.calls
    # (BH, S, hd) goes in as (BH, S, 1, hd): one head, no KV grouping
    assert args[4:12] == (6, 9, 9, 1, 1, 32, 1, 4)
    assert out.shape == (6, 9, 32) and out.dtype == torch.bfloat16


def test_flash_attention_hands_the_kernel_aligned_bases(fake_launch):
    # contiguous views one element into their buffers: the kernels' tensor
    # maps need 16-byte aligned bases, so the wrapper passes copies
    q, k, v = (torch.zeros(1 + 9 * 2 * 16, dtype=torch.bfloat16)[1:]
               .view(1, 9, 2, 16) for _ in range(3))
    assert all(t.data_ptr() % 16 for t in (q, k, v))
    ops.flash_attention(q, k, v)
    ((_, args),) = fake_launch.calls
    assert all(p % 16 == 0 for p in args[:4])
    assert not {q.data_ptr(), k.data_ptr(), v.data_ptr()} & set(args[:3])
    # float32: the pre-pass reads aligned k, v; the attention an aligned q
    fake_launch.calls.clear()
    q, k, v = (t.float() for t in (q, k, v))
    q, k, v = (torch.zeros(1 + t.numel())[1:].view(t.shape) for t in (q, k, v))
    assert all(t.data_ptr() % 16 for t in (q, k, v))
    ops.flash_attention(q, k, v)
    (_, sargs), (_, args) = fake_launch.calls
    assert all(p % 16 == 0 for p in sargs[:4] + args[:4])
    assert not {k.data_ptr(), v.data_ptr()} & set(sargs[:2])
    assert args[0] != q.data_ptr()


@pytest.fixture
def fake_rwkv(monkeypatch):
    """Route CPU tensors to the rwkv6 kernel path with a recording
    library."""
    rec = fake_kernel_route(monkeypatch, _build, trw)
    ops.reset_launch_counts()
    yield rec
    ops.reset_launch_counts()


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0),
                                        (torch.bfloat16, 1)])
@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("per_batch_u", [False, True])
def test_rwkv6_scan_marshals_the_c_call(fake_rwkv, dtype, code, hd,
                                        per_batch_u):
    B, S, H = 3, 9, 2
    r, k, v, w = (torch.zeros((B, S, H, hd), dtype=dtype) for _ in range(4))
    u = torch.zeros((B if per_batch_u else 1, H, hd))
    out = trw.rwkv6_scan_bshd(r, k, v, w, u)
    ((name, args),) = fake_rwkv.calls
    assert name == "repro_rwkv6_scan"
    # C signature: r, k, v, w, u, o, B, S, H, hd, u_batch_stride, dtype,
    # device, stream
    assert args == (
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        out.data_ptr(), B, S, H, hd, H * hd if per_batch_u else 0, code, 0, 0,
    )
    assert out.shape == r.shape and out.dtype == torch.float32
    assert ops.launch_counts()["rwkv6_scan"] == 1


def test_rwkv6_scan_flat_layout_marshals_one_head_per_row(fake_rwkv):
    r, k, v, w = (torch.zeros((6, 9, 32)) for _ in range(4))
    out = trw.rwkv6_scan(r, k, v, w, torch.zeros((6, 32)))
    ((_, args),) = fake_rwkv.calls
    # (BH, S, hd) goes in as (BH, S, 1, hd), u (BH, 1, hd): a bonus per row
    assert args[6:12] == (6, 9, 1, 32, 32, 0)
    assert out.shape == (6, 9, 32)


def test_rwkv6_scan_hands_the_kernel_aligned_inputs(fake_rwkv):
    # contiguous views one element into their buffers: the kernel stages
    # r, k, v, w with 16-byte copies, so the wrapper passes aligned copies
    r, k, v, w = (torch.zeros(1 + 9 * 2 * 16)[1:].view(1, 9, 2, 16)
                  for _ in range(4))
    assert all(t.data_ptr() % 16 for t in (r, k, v, w))
    ops.rwkv6_scan(r, k, v, w, torch.zeros((2, 16)))
    ((_, args),) = fake_rwkv.calls
    assert all(p % 16 == 0 for p in args[:4])
    assert not {t.data_ptr() for t in (r, k, v, w)} & set(args[:4])


@pytest.fixture
def fake_mamba(monkeypatch):
    """Route CPU tensors to the mamba kernel path with a recording
    library."""
    rec = fake_kernel_route(monkeypatch, _build, tms)
    ops.reset_launch_counts()
    yield rec
    ops.reset_launch_counts()


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0),
                                        (torch.bfloat16, 1)])
@pytest.mark.parametrize("N", [4, 8, 16])
@pytest.mark.parametrize("d", [32, 33])
def test_mamba_scan_marshals_the_c_call(fake_mamba, dtype, code, N, d):
    Bsz, S = 3, 9
    x, dt = (torch.zeros((Bsz, S, d), dtype=dtype) for _ in range(2))
    Bm, Cm = (torch.zeros((Bsz, S, N), dtype=dtype) for _ in range(2))
    A = torch.zeros((d, N))
    y = ops.mamba_scan(x, dt, A, Bm, Cm)
    ((name, args),) = fake_mamba.calls
    assert name == "repro_mamba_scan"
    # rows of x / dt and y of whole 16-byte pieces: d = 33 is padded to
    # 36 floats or 40 bf16 values, and y sliced back to d columns
    ld = d if d == 32 else {torch.float32: 36, torch.bfloat16: 40}[dtype]
    # C signature: x, dt, A, B, C, y, Bsz, S, D, ld, N, dtype, device,
    # stream
    assert args[6:] == (Bsz, S, d, ld, N, code, 0, 0)
    assert args[2:5] == (A.data_ptr(), Bm.data_ptr(), Cm.data_ptr())
    if ld == d:
        assert args[:2] == (x.data_ptr(), dt.data_ptr())
        assert args[5] == y.data_ptr()
    else:
        assert not {x.data_ptr(), dt.data_ptr(), y.data_ptr()} & set(args)
    assert y.shape == (Bsz, S, d) and y.dtype == torch.float32
    assert y.is_contiguous()
    assert ops.launch_counts()["mamba_scan"] == 1


def test_mamba_scan_hands_the_kernel_aligned_inputs(fake_mamba):
    # contiguous views one element into their buffers: the kernel stages x,
    # dt, B, C with 16-byte copies, so the wrapper passes aligned copies
    x, dt = (torch.zeros(1 + 9 * 32)[1:].view(1, 9, 32) for _ in range(2))
    Bm, Cm = (torch.zeros(1 + 9 * 16)[1:].view(1, 9, 16) for _ in range(2))
    assert all(t.data_ptr() % 16 for t in (x, dt, Bm, Cm))
    ops.mamba_scan(x, dt, torch.zeros((32, 16)), Bm, Cm)
    ((_, args),) = fake_mamba.calls
    assert all(args[i] % 16 == 0 for i in (0, 1, 3, 4, 5))
    assert not {t.data_ptr() for t in (x, dt, Bm, Cm)} & set(args[:6])


class _ArgtypesLib:
    """Stands in for a loaded library: keeps what ``_lib()`` sets on each
    C function."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, type("CFunction", (), {})())


def _c_params(source: str, name: str) -> list:
    """The ctypes types of an extern "C" function's parameters, read from
    its definition in the kernel source."""
    m = re.search(rf"^(?:int|int64_t) {name}\(([^)]*)\)", source, re.M)
    assert m, f"{name} not defined in the source"
    scalar = {"int64_t": ctypes.c_int64, "int": ctypes.c_int,
              "float": ctypes.c_float, "double": ctypes.c_double}
    params = filter(None, (p.strip() for p in m.group(1).split(",")))
    return [ctypes.c_void_p if "*" in p else scalar[p.split()[0]]
            for p in params]


@pytest.mark.parametrize("module,fn", [
    (tfa, "repro_flash_attention"), (tfa, "repro_flash_attention_smem"),
    (trw, "repro_rwkv6_scan"), (trw, "repro_rwkv6_scan_smem"),
    (tms, "repro_mamba_scan"),
    (tfa, "repro_flash_attention_tf32x3_split"),
    (tfa, "repro_flash_attention_tf32x3"),
])
def test_ctypes_argtypes_match_the_c_definitions(monkeypatch, module, fn):
    # ctypes passes what argtypes says: a parameter added to or taken from
    # a launcher must show in its wrapper's argtypes, type for type
    lib = _ArgtypesLib()
    monkeypatch.setattr(_build, "load", lambda source: lib)
    monkeypatch.setattr(module, "_LIB", None)
    module._lib()
    source = module._SOURCE.read_text()
    assert list(lib.fns[fn].argtypes) == _c_params(source, fn)
