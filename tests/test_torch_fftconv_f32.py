"""Kernel 1 (f32) on the radix-16 route, checked without a card: the route
function takes the radix-16 kernel at every FFT size the f32 SaShiMi paths
launch kernel 1 at; a plain torch model of the f32 instances' schedule
(tests/torch_r16.py::_model with ``roots``: the twiddles as products of
once-rounded roots, the D-skip added in the store pass, the exact GELU)
against float64 (its error at most twice the plain f32 version's) and
against JAX's f32 kernels (``fast=False``, interpret mode); the wrappers'
launch arguments on both routes; on CPU tensors the wrappers are their
plain versions."""

import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_fftconv_tc import _OnCard, _bf16_sizes
from torch_r16 import _model

import jax.numpy as jnp

from diffwave_sashimi_tpu.ops import fftconv2 as f2
from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.ops import cuda_lib

# the module (ops.fftconv is the training entry's wrapper)
fc = importlib.import_module("diffwave_sashimi_torch.ops.fftconv")

C64 = torch.complex64
F32 = torch.float32


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,L", _bf16_sizes())
def test_conv_plan_routes_every_f32_size(n, L):
    """The f32 paths launch kernel 1 at the sizes the bf16 paths launch 1f
    at (the same model tiers), and the route function gives both
    activation types the radix-16 kernel there; other sizes keep the
    Stockham kernel."""
    assert fc.conv_plan(n) == fc.radix16_plan(n)
    assert fc.conv_plan(n).route == "radix16"
    assert fc.conv_plan(n // 32) == fc.STOCKHAM


def _inputs(B, H, L, n, seed):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)   # noqa: E731
    return dict(u=f(B, H, L), a=(0.5 + rng.rand(B, L)).astype(np.float32),
                c=0.3 * f(B, L), bias=0.3 * f(B, H), k=0.05 * f(H, n),
                D=f(H))


def _sampling(d, n):
    """Kernel 1's sampling form on the radix-16 route, as the model runs
    it: u' = a u + c + bias, the conv with khat (no D in the spectrum),
    then gelu_erf(y + D u'); and the f32 spectrum."""
    B, H, L = d["u"].shape
    xn = (torch.from_numpy(d["u"]) * torch.from_numpy(d["a"])[:, None]
          + torch.from_numpy(d["c"])[:, None]
          + torch.from_numpy(d["bias"])[:, :, None])
    khat = torch.fft.rfft(torch.from_numpy(d["k"]), n=n)
    y = _model(xn.reshape(B * H, L), khat.repeat(B, 1), L,
               fc.radix16_plan(n), roots=True).reshape(B, H, L)
    return F.gelu(y + torch.from_numpy(d["D"])[:, None] * xn), khat


def _conv(d, n, conj):
    B, H, L = d["u"].shape
    khat = torch.fft.rfft(torch.from_numpy(d["k"]), n=n)
    kp = (khat.conj() if conj else khat).repeat(B, 1)
    y = _model(torch.from_numpy(d["u"]).reshape(B * H, L), kp, L,
               fc.radix16_plan(n), roots=True)
    return y.reshape(B, H, L), khat


def _args(d, khat):
    return ([torch.from_numpy(d[k]) for k in ("u", "a", "c", "bias")]
            + [khat, torch.from_numpy(d["D"])])


def _sampling64(d, khat):
    """Kernel 1's sampling function in float64 on the same f32 inputs."""
    u, a, c, bias, D = (torch.from_numpy(d[k]).double()
                        for k in ("u", "a", "c", "bias", "D"))
    n = 2 * (khat.shape[-1] - 1)
    xn = u * a[:, None] + c[:, None] + bias[:, :, None]
    y = torch.fft.irfft(torch.fft.rfft(xn, n=n) * khat.to(torch.complex128),
                        n=n)[..., :u.shape[-1]]
    return F.gelu(y + D[:, None] * xn)


def _l2(out, ref):
    return float((out.double() - ref).norm() / ref.norm())


def _hold(out, plain, ref64):
    """The f32 bar: within 1e-4 x max(1, max|plain|) of the plain version,
    within 2e-6 of max|ref| of float64, and a relative L2 error against
    float64 at most twice the plain version's (torch.fft's)."""
    scale = float(ref64.abs().max())
    assert float((out - plain).abs().max()) <= 1e-4 * max(
        1.0, float(plain.abs().max()))
    assert float((out.double() - ref64).abs().max()) <= 2e-6 * scale
    assert _l2(out, ref64) <= 2 * _l2(plain, ref64), (
        _l2(out, ref64), _l2(plain, ref64))


# Sizes: SC09's deepest tier (n 2048, L 1000 <= n/2: the pruned load, the
# radix-4 first pass), an odd L, L > n/2 at n 2048 and at n 8192 (the
# radix-16 first pass and store pass, whose twiddles are roots too), the
# vocoder's deepest tier (L 8960 > n/2 at n 16384, the radix-2 first
# pass) and SC09's top tier (n 32768, four passes)
SCHEDULE_CASES = [(1000, 2048), (999, 2048), (1500, 2048), (4000, 8192),
                  (4601, 8192), (8960, 16384), (16000, 32768)]


@pytest.mark.parametrize("L,n", SCHEDULE_CASES)
def test_schedule_sampling_vs_float64_and_plain(L, n):
    """The sampling form's schedule held as ``_hold`` says against
    ``fftconv_ln_bias_gelu_d_ref`` and float64."""
    d = _inputs(2, 3, L, n, seed=L + 1)
    out, khat = _sampling(d, n)
    args = _args(d, khat)
    _hold(out, ops.fftconv_ln_bias_gelu_d_ref(*args), _sampling64(d, khat))


@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("L,n", SCHEDULE_CASES)
def test_schedule_conv_vs_float64_and_plain(L, n, conj):
    """The training entry's schedule (``conj``: the input gradient's form)
    held as ``_hold`` says against ``fftconv_ref`` and float64."""
    d = _inputs(2, 3, L, n, seed=L + 2)
    out, khat = _conv(d, n, conj)
    k64 = khat.to(torch.complex128)
    ref64 = torch.fft.irfft(torch.fft.rfft(
        torch.from_numpy(d["u"]).double(), n=n) * (k64.conj() if conj
                                                   else k64), n=n)[..., :L]
    _hold(out, ops.fftconv_ref(torch.from_numpy(d["u"]), khat, conj), ref64)


def _jax_layout(d, n):
    B, H, L = d["u"].shape
    lay = f2.choose_layout(L, n, H)
    kfr, kfi = f2.kernel_spectrum(jnp.asarray(d["k"]), lay)
    return lay, kfr, kfi


def _jax_out(yc, lay, L):
    return np.asarray(jnp.asarray(f2.from_compact(yc, lay, L), jnp.float32))


def _close_f32(out, ref):
    assert np.abs(out - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())


# (L, n): SC09's deepest tier and an L > n/2 at n 2048, and a short row
# at each larger size (n 8192: the radix-16 first pass; 16384: radix 2;
# 32768: four passes)
JAX_CASES = [(1000, 2048), (1500, 2048), (2000, 8192), (3000, 16384),
             (5000, 32768)]


@pytest.mark.parametrize("L,n", JAX_CASES)
def test_schedule_sampling_matches_jax(L, n):
    """The sampling form's schedule vs JAX ``fftconv2_ln_bias_gelu_d``
    with fast=False on its f32 layout (``_conv2_impl``, interpret mode, as
    tests/test_torch_fftconv_tc.py runs the bf16 form), at the f32 bar."""
    B, H = 2, 16
    d = _inputs(B, H, L, n, seed=13 + L)
    out, _ = _sampling(d, n)
    lay, kfr, kfi = _jax_layout(d, n)

    def comp(x):
        return f2.to_compact(jnp.asarray(x)[:, None], lay)[:, :, 0]
    yc = f2._conv2_impl(f2.to_compact(jnp.asarray(d["u"]), lay), kfr, kfi,
                        jnp.asarray(d["D"]).reshape(H // lay.HB, lay.HB, 1),
                        lay, False, "gelu_d",
                        prologue=(comp(d["a"]), comp(d["c"]),
                                  jnp.asarray(d["bias"])))
    _close_f32(out.numpy(), _jax_out(yc, lay, L))


@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("L,n", JAX_CASES)
def test_schedule_conv_matches_jax(L, n, conj):
    """The training entry's schedule vs JAX ``fftconv2`` with fast=False
    on its f32 layout (interpret mode; JAX's call on -kfi for ``conj``),
    at the f32 bar."""
    B, H = 2, 16
    d = _inputs(B, H, L, n, seed=17 + L)
    out, _ = _conv(d, n, conj)
    lay, kfr, kfi = _jax_layout(d, n)
    yc = f2._conv2_impl(f2.to_compact(jnp.asarray(d["u"]), lay), kfr,
                        -kfi if conj else kfi, None, lay, False, "none")
    _close_f32(out.numpy(), _jax_out(yc, lay, L))


# ---- the wrappers -------------------------------------------------------

@pytest.mark.parametrize("n,L", _bf16_sizes() + [(1024, 500)])
@pytest.mark.parametrize("form", ["sampling", "conv", "conj"])
def test_wrappers_pass_their_signatures(monkeypatch, n, L, form):
    """Kernel 1's wrappers on f32 u hand the entry point of the route
    conv_plan gives exactly the arguments its ctypes signature names, the
    stream apart (on the radix-16 route the plan's threads and smem last),
    and count one launch on kernel 1's wrapper and none on 1f's."""
    calls = []
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *a: calls.append(
        (name, a)))
    monkeypatch.setattr(cuda_lib, "check", lambda *a: None)
    B, H = 2, 8
    u = torch.zeros(B, H, L).as_subclass(_OnCard)
    khat = torch.zeros(H, n // 2 + 1, dtype=C64)
    f = torch.zeros(B, L)
    plan = fc.conv_plan(n)
    r16 = plan.route == "radix16"
    before = {k: fn.launches for k, fn in ops.COUNTED.items()}
    if form == "sampling":
        wrapper = "fftconv_ln_bias_gelu_d"
        ops.fftconv_ln_bias_gelu_d(u, f, f, torch.zeros(B, H), khat,
                                   torch.zeros(H))
        entry = ("dwst_fftconv_r16_ln_bias_gelu_d" if r16
                 else "dwst_fftconv_ln_bias_gelu_d")
        tail = (B, H, L, n)
    else:
        wrapper = "fftconv"
        ops.fftconv(u, khat, conj=form == "conj")
        entry = "dwst_fftconv_r16" if r16 else "dwst_fftconv"
        tail = (B, H, L, n, int(form == "conj"))
    after = {k: fn.launches for k, fn in ops.COUNTED.items()}
    assert {k for k in after if after[k] != before[k]} == {wrapper}
    assert after[wrapper] == before[wrapper] + 1
    (name, args), = calls
    assert name == entry
    sig = cuda_lib._SIGNATURES[entry]
    assert len(args) + 1 == len(sig)
    for a, t in zip(args, sig):
        assert isinstance(a, int) and (t is cuda_lib._P or abs(a) < 2 ** 31)
    assert args[-len(tail) - 2 * r16:len(args) - 2 * r16] == tail
    if r16:
        assert args[-2:] == (plan.threads, plan.smem)


@pytest.mark.parametrize("plan", [fc.STOCKHAM, fc.radix16_plan(2048)],
                         ids=["stockham", "radix16"])
def test_launchers_take_the_plan_given(monkeypatch, plan):
    """``launch_sampling`` and ``launch_conv`` on f32 u launch kernel 1's
    entry of the route of the plan they are handed (chip_smoke.py times
    both routes in turns with them) and count nothing; they refuse a
    float64 u before any launch."""
    calls = []
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *a: calls.append(
        name))
    B, H, L, n = 2, 8, 1000, 2048
    khat = torch.zeros(H, n // 2 + 1, dtype=C64)
    f = torch.zeros(B, L)
    before = {k: fn.launches for k, fn in ops.COUNTED.items()}
    for dtype in (torch.float64,):
        u = torch.zeros(B, H, L, dtype=dtype).as_subclass(_OnCard)
        with pytest.raises(ValueError, match="float32"):
            fc.launch_sampling(u, f, f, torch.zeros(B, H), khat,
                               torch.zeros(H), plan)
        with pytest.raises(ValueError, match="float32"):
            fc.launch_conv(u, khat, False, plan)
    assert calls == []
    monkeypatch.setattr(cuda_lib, "check", lambda *a: None)
    u = torch.zeros(B, H, L, dtype=F32).as_subclass(_OnCard)
    fc.launch_sampling(u, f, f, torch.zeros(B, H), khat, torch.zeros(H),
                       plan)
    fc.launch_conv(u, khat, True, plan)
    r16 = "_r16" if plan.route == "radix16" else ""
    assert calls == [f"dwst_fftconv{r16}_ln_bias_gelu_d", f"dwst_fftconv{r16}"]
    assert {k: fn.launches for k, fn in ops.COUNTED.items()} == before


def test_wrappers_are_their_plain_versions_on_cpu():
    """On CPU f32 tensors both kernel-1 wrappers return their plain
    versions' results bit for bit and count no launch, at L > n/2 too."""
    before = {k: fn.launches for k, fn in ops.COUNTED.items()}
    for L, n in ((1000, 2048), (1500, 2048)):
        d = _inputs(2, 4, L, n, seed=19)
        khat = torch.fft.rfft(torch.from_numpy(d["k"]), n=n)
        args = _args(d, khat)
        assert torch.equal(ops.fftconv_ln_bias_gelu_d(*args),
                           ops.fftconv_ln_bias_gelu_d_ref(*args))
        for conj in (False, True):
            assert torch.equal(ops.fftconv(args[0], khat, conj),
                               ops.fftconv_ref(args[0], khat, conj))
    assert {k: fn.launches for k, fn in ops.COUNTED.items()} == before


# ---- chip_smoke.py's view of kernel 1 ---------------------------------------

def _chip_smoke():
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("name,one,one_f", [
    ("fftconv_r16_kernel<16384, true, float>", True, False),
    ("fftconv_r16_kernel<1024, false, float>", True, False),
    ("fftconv_r16_kernel<16384, true, __nv_bfloat16>", False, True),
    ("fftconv_kernel<true, float>", True, False),
    ("fftconv_kernel<false, __nv_bfloat16>", False, True),
    ("fftconv_dkf_r16_kernel<16384, 1, float>", False, False),
    ("fftconv_dkf_kernel<__nv_bfloat16>", False, False),
    ("fftconv_int8_kernel<float, 256>", False, False)])
def test_trace_groups_tell_kernel_1_from_1f(name, one, one_f):
    """chip_smoke.py's trace groups book each instance of the radix-16 and
    Stockham kernels by its activation type: f32 instances to kernel 1,
    bf16 ones to 1f, and nothing else to either."""
    smoke = _chip_smoke()
    assert smoke.is_1(name) == one and smoke.is_1f(name) == one_f


def test_chip_smoke_lists_kernel_1_instances():
    """The kernels line's kernel-1 entries list the radix-16 kernel's f32
    instances' ptxas reports (``<M, FUSED, float>`` at every radix-16
    size, which phase 1 requires and holds to no spill) and nothing
    else."""
    smoke = _chip_smoke()
    want = [f"fftconv_r16_kernel<{n // 2}, {f}, float>"
            for n in fc.RADIX16_SIZES for f in ("true", "false")]
    ptxas = {k: {"registers": 128} for k in want + [
        "fftconv_dkf_r16_kernel<16384, 1, float>", "cauchy_fwd_kernel<4>"]}
    for name in ("fftconv_ln_bias_gelu_d", "fftconv"):
        parts = smoke.kernel_parts(name, ptxas)
        assert sorted(parts["ptxas"]) == sorted(want)
        assert parts["global_kernels"] == ["fftconv_r16_kernel",
                                           "fftconv_kernel"]
