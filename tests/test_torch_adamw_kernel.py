"""The route and the C calls of the port's AdamW kernels, and its plain
version against the JAX package's AdamW.

* Routing (``optim.adamw_update``): CPU and ``meta`` leaves take the plain
  version and launch nothing; the route is ``_build.use_kernel``'s over
  every leaf, moments included; leaves on several devices and a
  non-contiguous leaf on a card raise.
* The C calls, with the library replaced by a recorder
  (``tests/_torch_fakes.py``): dtype codes, the device scalars as
  pointers (never host floats), the decay flag by ``p.dim()``, the python
  scalars as the float32 values PyTorch casts them to, and each launcher's
  ctypes argtypes against its C definition in ``csrc/adamw.cu``.
* The op tracer counts the kernel route and the plain route alike.
* The plain version against ``repro.optim.adamw_update`` over two steps on
  small trees of float32 and bf16 leaves, both moment dtypes, with and
  without clipping: float32 values at rtol 1e-6 (XLA may contract a
  product and a sum into one FMA where PyTorch rounds both), bf16 values
  within one bf16 step (2^-7) of the reference's.

The CUDA kernels themselves are held bit for bit against the plain version
on the card by ``tests/test_torch_adamw_card.py``.
"""

from __future__ import annotations

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro_torch.kernels import _build
from repro_torch.kernels import adamw as kadamw
from repro_torch.launch.trace_analysis import analyze_trace, trace_call
from repro_torch.optim import adamw_init, adamw_update

from _torch_fakes import fake_kernel_route

SHAPES = {"w": (5, 7), "b": (7,), "e": (2, 3, 4)}
HYPER = dict(betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)


def _tree(seed, dtype, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(
        (rng.standard_normal(s) * scale).astype(np.float32)).to(dtype)
        for k, s in SHAPES.items()}


def _clone(tree):
    return {k: v.clone() for k, v in tree.items()}


@pytest.fixture
def fake_lib(monkeypatch):
    kadamw.reset_launch_counts()
    yield fake_kernel_route(monkeypatch, _build, kadamw)
    kadamw.reset_launch_counts()


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_leaves_take_the_plain_version_and_launch_nothing(dtype):
    kadamw.reset_launch_counts()
    params, grads = _tree(0, dtype), _tree(1, dtype)
    state = adamw_init(params)
    adamw_update(grads, state, params, lr=1e-3, **HYPER)
    assert kadamw.LAUNCHES == {"sq_norm": 0, "adamw_apply": 0}


def test_meta_leaves_take_the_plain_version():
    # the dry run's leaves: shapes only, nothing launched
    kadamw.reset_launch_counts()
    params = {k: v.to("meta") for k, v in _tree(0, torch.bfloat16).items()}
    grads = {k: torch.empty_like(v) for k, v in params.items()}
    state, m = adamw_update(grads, adamw_init(params), params, lr=1e-3,
                            **HYPER)
    assert m["grad_norm"].device.type == "meta" and state.step == 1
    assert kadamw.LAUNCHES == {"sq_norm": 0, "adamw_apply": 0}


def test_the_route_is_use_kernel_over_every_leaf(monkeypatch, fake_lib):
    # _build.use_kernel decides, handed the gradients, both moments and
    # the parameters: the plain version where it says so, else the kernels
    seen = []

    def decide(impl, *tensors):
        seen.append((impl, len(tensors)))
        return decide.kernel

    monkeypatch.setattr(_build, "use_kernel", decide)
    params, grads = _tree(0, torch.float32), _tree(1, torch.float32)
    want = _clone(params)
    decide.kernel = False
    adamw_update(grads, adamw_init(params), params, lr=1e-3, **HYPER)
    assert fake_lib.calls == []
    assert kadamw.LAUNCHES == {"sq_norm": 0, "adamw_apply": 0}
    decide.kernel = True
    adamw_update(grads, adamw_init(want), want, lr=1e-3, **HYPER)
    assert [name for name, _ in fake_lib.calls] == [
        "repro_sq_norm_partials", "repro_sq_norm"] + \
        ["repro_adamw_apply"] * len(SHAPES)
    assert seen[:2] == [("auto", 4 * len(SHAPES))] * 2


def _refuse_non_contiguous(impl, *tensors):
    # _build.use_kernel's check of tensors on a card
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("a non-contiguous CUDA tensor")
    return True


@pytest.mark.parametrize("case", ["devices", "non_contiguous"])
def test_route_rejects(case, monkeypatch):
    kadamw.reset_launch_counts()
    params, grads = _tree(0, torch.float32), _tree(1, torch.float32)
    state = adamw_init(params)
    if case == "devices":
        grads["b"] = grads["b"].to("meta")
    else:
        # a second moment laid out transposed, on a card
        monkeypatch.setattr(_build, "use_kernel", _refuse_non_contiguous)
        state.nu[-1] = torch.zeros(SHAPES["w"][::-1]).t()
    with pytest.raises(ValueError):
        adamw_update(grads, state, params, lr=1e-3, **HYPER)
    assert kadamw.LAUNCHES == {"sq_norm": 0, "adamw_apply": 0}


# ---------------------------------------------------------------------------
# the C calls
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pdt,gdt,mdt", [
    (torch.bfloat16, torch.bfloat16, "float32"),
    (torch.bfloat16, torch.float32, "bfloat16"),
    (torch.float32, torch.float32, "float32"),
    (torch.float32, torch.bfloat16, "bfloat16"),
])
@pytest.mark.parametrize("grad_clip", [1.0, None])
def test_adamw_update_marshals_the_c_calls(fake_lib, pdt, gdt, mdt,
                                           grad_clip):
    params, grads = _tree(0, pdt), _tree(1, gdt)
    state = adamw_init(params, moment_dtype=mdt)
    adamw_update(grads, state, params, lr=1e-3, grad_clip=grad_clip,
                 **HYPER)
    code = {torch.float32: 0, torch.bfloat16: 1}
    leaves = sorted(SHAPES)  # the tree's leaf order
    (n1, a1), (n2, a2), *applies = fake_lib.calls
    L = len(leaves)
    assert (n1, a1) == ("repro_sq_norm_partials", (L,))
    assert n2 == "repro_sq_norm"
    ptrs, ns, codes = (list(a) for a in a2[:3])
    assert ptrs == [grads[k].data_ptr() for k in leaves]
    assert ns == [grads[k].numel() for k in leaves]
    assert codes == [code[gdt]] * L
    assert a2[3] == L and a2[6:] == (0, 0)
    assert all(type(x) is int for x in a2[4:6])  # partials and out: pointers
    assert [n for n, _ in applies] == ["repro_adamw_apply"] * L
    b1, b2 = HYPER["betas"]
    for i, (_, args) in enumerate(applies):
        k = leaves[i]
        p, m, v = params[k], state.mu[i], state.nu[i]
        # C: p, g, m, v, n, p / g / m dtype codes, scale, c1, c2, lr, the
        # six python scalars, decay, device, stream
        assert args[:5] == (p.data_ptr(), grads[k].data_ptr(), m.data_ptr(),
                            v.data_ptr(), p.numel())
        assert args[5:8] == (code[pdt], code[gdt], code[m.dtype])
        scale, *scalars = args[8:12]
        assert (scale is None) == (grad_clip is None)
        # the device scalars travel as pointers, never as host floats
        assert all(type(x) is int for x in scalars + ([scale] if grad_clip
                                                      else []))
        assert args[12:18] == (b1, b2, 1 - b1, 1 - b2, HYPER["eps"],
                               HYPER["weight_decay"])
        assert args[18] == int(p.dim() >= 2) and args[19:] == (0, 0)
    assert kadamw.LAUNCHES == {"sq_norm": 1, "adamw_apply": L}


def test_adamw_apply_passes_the_scalars_by_pointer(fake_lib):
    p, g = torch.zeros(3, 4, dtype=torch.bfloat16), torch.zeros(3, 4)
    m, v = torch.zeros(3, 4), torch.zeros(3, 4)
    one = lambda x: torch.full((), x)  # noqa: E731
    scale, c1, c2, lr = one(0.5), one(0.1), one(0.05), one(1e-3)
    kadamw.adamw_apply([g], [m], [v], [p], scale=scale, c1=c1, c2=c2,
                       lr_t=lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    ((_, args),) = fake_lib.calls
    assert args[8:12] == tuple(t.data_ptr() for t in (scale, c1, c2, lr))


@pytest.mark.parametrize("case", ["dtype", "shape", "scalar", "moments"])
def test_adamw_apply_rejects(fake_lib, case):
    g = p = m = v = torch.zeros(4)
    one = torch.ones(())
    kw = dict(scale=None, c1=one, c2=one, lr_t=one, b1=0.9, b2=0.95,
              eps=1e-8, weight_decay=0.1)
    if case == "dtype":
        g = torch.zeros(4, dtype=torch.float16)
    elif case == "shape":
        m = torch.zeros(5)
    elif case == "scalar":
        kw["c1"] = torch.ones(2)
    else:
        v = torch.zeros(4, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        kadamw.adamw_apply([g], [m], [v], [p], **kw)
    assert kadamw.LAUNCHES["adamw_apply"] == 0


@pytest.mark.parametrize("x", [0.9, 0.95, 1 - 0.9, 1 - 0.95, 1e-8, 0.1,
                               0.999, 1 - 0.999, 3e-4])
def test_python_scalars_reach_the_kernel_as_pytorch_casts_them(x):
    # ctypes.c_float rounds the double as PyTorch does when a float32
    # kernel takes a python scalar (the factor of t * x)
    t = torch.tensor([1.0, -3.0, 1e-30, 7.5])
    as_c = ctypes.c_float(x).value
    assert torch.equal(t * x, t * torch.tensor(as_c, dtype=torch.float32))
    assert as_c == torch.tensor(x, dtype=torch.float64).float().item()


def _c_params(source: str, name: str) -> list:
    m = re.search(rf"^(?:int|int64_t) {name}\(([^)]*)\)", source, re.M)
    assert m, f"{name} not defined in the source"
    scalar = {"int64_t": ctypes.c_int64, "int": ctypes.c_int,
              "float": ctypes.c_float}
    params = filter(None, (p.strip() for p in m.group(1).split(",")))
    return [ctypes.c_void_p if "*" in p else scalar[p.split()[0]]
            for p in params]


class _ArgtypesLib:
    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, type("CFunction", (), {})())


@pytest.mark.parametrize("fn", ["repro_sq_norm_partials", "repro_sq_norm",
                                "repro_adamw_apply"])
def test_ctypes_argtypes_match_the_c_definitions(monkeypatch, fn):
    lib = _ArgtypesLib()
    monkeypatch.setattr(_build, "load", lambda source: lib)
    monkeypatch.setattr(kadamw, "_LIB", None)
    kadamw._lib()
    assert list(lib.fns[fn].argtypes) == _c_params(
        kadamw._SOURCE.read_text(), fn)
    monkeypatch.setattr(kadamw, "_LIB", None)


# ---------------------------------------------------------------------------
# the op tracer
# ---------------------------------------------------------------------------


def _traced_update():
    params, grads = _tree(0, torch.bfloat16), _tree(1, torch.bfloat16)
    state = adamw_init(params)
    trace = trace_call(
        lambda: adamw_update(grads, state, params, lr=1e-3, **HYPER))[1]
    return trace, analyze_trace(trace)


def test_kernel_route_counts_as_the_plain_route(monkeypatch):
    trace, plain = _traced_update()
    n = sum(int(np.prod(s)) for s in SHAPES.values())
    # the norm reads g (2 B); the update reads g and reads and writes p
    # (2 B each) and both moments (4 B each); the scalars' ops count apart
    assert {e["name"]: e["io_bytes"] for e in trace.events} == {
        "adamw.sq_norm": 2 * n, "adamw.apply": (2 + 2 * (2 + 4 + 4)) * n}
    assert plain.kernel_launches == {"adamw.sq_norm": 1, "adamw.apply": 1}
    fake_kernel_route(monkeypatch, _build, kadamw)
    _, kernel = _traced_update()
    assert kadamw.LAUNCHES["adamw_apply"] == len(SHAPES)
    kadamw.reset_launch_counts()
    assert (kernel.memory_bytes, kernel.flops, kernel.kernel_launches) == (
        plain.memory_bytes, plain.flops, plain.kernel_launches)


# ---------------------------------------------------------------------------
# the plain version against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grad_clip", [0.5, None])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_matches_jax(dtype, moment_dtype, grad_clip):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    params = _tree(0, dtype)
    # copies: the port updates its leaves in place
    jparams = {k: jnp.asarray(v.float().numpy().copy()).astype(jdt)
               for k, v in params.items()}
    state = adamw_init(params, moment_dtype=moment_dtype)
    jstate = j_adamw_init(jparams, moment_dtype=moment_dtype)
    kw = dict(grad_clip=grad_clip, **HYPER)
    for step in range(2):
        grads = _tree(10 + step, dtype, scale=0.3)
        jgrads = {k: jnp.asarray(v.float().numpy()).astype(jdt)
                  for k, v in grads.items()}
        state, m = adamw_update(grads, state, params, lr=1e-2, **kw)
        jparams, jstate, jm = j_adamw_update(jgrads, jstate, jparams,
                                             lr=1e-2, **kw)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    leaves = sorted(SHAPES)
    for got, want in [(params[k], jparams[k]) for k in leaves] + [
            (state.mu[i], jstate.mu[k]) for i, k in enumerate(leaves)] + [
            (state.nu[i], jstate.nu[k]) for i, k in enumerate(leaves)]:
        want = np.asarray(want.astype(jnp.float32))
        rtol = 1e-6 if got.dtype == torch.float32 else 2 ** -7
        np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                                   atol=1e-12)
