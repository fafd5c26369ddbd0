"""Kernel 1f's radix-16 route, checked without a card: the route function
and the plan it gives at every FFT size the bf16 paths launch 1f at; a
plain torch model of the kernel's schedule (csrc/fftconv.cu::
fftconv_r16_kernel: the load pass that reads only the input's nonzero
part, the radix-R0 and radix-16 Stockham passes with their index maps, the
merged pass in which each thread folds its two butterflies' spectrum pairs
with the D-skip added to the spectrum, and the store pass that writes only
the first L outputs) against the JAX ``fast=True`` kernel in interpret
mode, the port's plain versions and a float64 conv; the wrappers' launch
arguments; on CPU tensors the wrappers are their plain versions."""

import importlib
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffwave_sashimi_tpu.ops import fftconv2 as f2
from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.config import load_config
from diffwave_sashimi_torch.ops import chmix, cuda_lib
from torch_r16 import _dft, _held, _model, _pass, _root  # noqa: F401

# the module (ops.fftconv is the training entry's wrapper)
fc = importlib.import_module("diffwave_sashimi_torch.ops.fftconv")

BF = torch.bfloat16
C64 = torch.complex64


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bf16_sizes():
    """(n, L) of every kernel-1f launch of the shipped bf16 paths: SC09's
    three tiers at the model's d_model and at 256 (the same lengths), the
    vocoder's deepest tier (a 6.5 s utterance, 143360 samples / 16)."""
    out = set()
    for exp in ("sc09", "ljspeech"):
        m = load_config(overrides=[f"experiment={exp}"]).model
        L, Lt = (143360 if exp == "ljspeech" else m.L), m.L
        for i in range(len(m.pool) + 1):
            # the S4 kernel is capped at the tier's trained length Lt
            n = 1 << (L + min(L, Lt) - 1).bit_length()
            if n <= 32768:
                out.add((n, L))
            if i < len(m.pool):
                L, Lt = L // m.pool[i], Lt // m.pool[i]
    return sorted(out)


def test_bf16_sizes_are_the_paths():
    assert _bf16_sizes() == [(2048, 1000), (8192, 4000), (16384, 8960),
                             (32768, 16000)]


@pytest.mark.parametrize("n,L", _bf16_sizes())
def test_conv_plan_routes_every_bf16_size(n, L):
    """Every size the bf16 paths take has a radix-16 instance, and the
    route function gives its plan there (the radix-16 kernel won at each
    in turns on the card); the plan's passes multiply to M = n/2, all
    radix 16 but the first, at least two of them; M / 32 threads and
    M + M/16 slots of 8 bytes, within a block's 227 KB."""
    assert n in fc.RADIX16_SIZES
    plan = fc.conv_plan(n)
    r16 = fc.radix16_plan(n)
    assert plan == r16
    M = n // 2
    assert math.prod(r16.radices) == M and r16.radices[1:] == (16,) * (
        len(r16.radices) - 1) and len(r16.radices) >= 3
    assert r16.radices[0] in (2, 4, 8, 16)
    assert r16.threads == M // 32 and r16.threads * 32 == M
    assert r16.smem == 8 * (M + M // 16) <= chmix.SMEM_LIMIT
    assert L <= n
    assert fc.conv_plan(1024) == fc.STOCKHAM       # no instance: Stockham


# ---- the schedule model (tests/torch_r16.py) -------------------------------

def _inputs(B, H, L, n, seed):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)   # noqa: E731
    return dict(u=f(B, H, L), a=(0.5 + rng.rand(B, L)).astype(np.float32),
                c=0.3 * f(B, L), bias=0.3 * f(B, H), k=0.05 * f(H, n),
                D=f(H))


# Sizes: SC09's deepest tier (n 2048, L 1000 <= n/2: the pruned load, and
# the radix-4 first pass), an odd L, L > n/2 (the load reads the upper half
# too) at n 2048 and at n 8192 (the radix-16 first pass) with odd L, the
# vocoder's deepest tier (L 8960 > n/2 at n 16384, the radix-2 first pass)
# and SC09's top tier (n 32768, four passes)
SCHEDULE_CASES = [(1000, 2048), (999, 2048), (1500, 2048), (4000, 8192),
                  (4601, 8192), (8960, 16384), (16000, 32768)]


def _conv64(x, kp64, L, n):
    return torch.fft.irfft(torch.fft.rfft(x.double(), n=n) * kp64,
                           n=n)[..., :L]


@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("L,n", SCHEDULE_CASES)
def test_schedule_model_is_the_conv(L, n, conj):
    """The schedule's f32 output before the epilogue vs the float64 conv of
    the same rows with the same spectrum (D added to every bin in the
    sampling form, conjugated in the input-gradient form): within 2e-6 of
    max|ref| (f32 rounding of 14-15 passes)."""
    d = _inputs(2, 3, L, n, seed=L)
    k = torch.fft.rfft(torch.from_numpy(d["k"]).double(), n=n)
    x = torch.from_numpy(d["u"]).reshape(-1, L)
    Dd = torch.from_numpy(d["D"]).double()
    if conj:
        kp64 = k.conj()
    else:
        kp64 = k + Dd[:, None]
    kp64 = kp64.repeat(2, 1)
    y = _model(x, kp64.to(C64), L, fc.radix16_plan(n))
    ref = _conv64(x, kp64, L, n)
    err = float((y.double() - ref).abs().max())
    assert err <= 2e-6 * float(ref.abs().max()), err


def _schedule_sampling(d, L, n):
    """Kernel 1f's sampling form on the radix-16 route, as the model runs
    it: u' = a u + c + bias (u bf16), the conv with khat + D, gelu_fast,
    rounded to bf16."""
    B, H = d["bias"].shape
    u = torch.from_numpy(d["u"]).to(BF).float()
    a, c = torch.from_numpy(d["a"]), torch.from_numpy(d["c"])
    xn = u * a[:, None] + c[:, None] + torch.from_numpy(d["bias"])[:, :, None]
    khat = torch.fft.rfft(torch.from_numpy(d["k"]), n=n)
    kp = (khat + torch.from_numpy(d["D"])[:, None]).repeat(B, 1)
    y = _model(xn.reshape(B * H, L), kp, L, fc.radix16_plan(n))
    return ops.gelu_fast(y).to(BF).reshape(B, H, L), khat


def _schedule_conv(d, L, n, conj):
    B, H = d["bias"].shape
    u = torch.from_numpy(d["u"]).to(BF).float()
    khat = torch.fft.rfft(torch.from_numpy(d["k"]), n=n)
    kp = (khat.conj() if conj else khat).repeat(B, 1)
    y = _model(u.reshape(B * H, L), kp, L, fc.radix16_plan(n))
    return y.to(BF).reshape(B, H, L), khat


def _jax_inputs(d):
    t = torch.from_numpy(d["u"]).to(BF)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def _rel(out, ref):
    return np.abs(out - ref).max() / np.abs(ref).max()


def _close_to_one_rounding(out, ref):
    """Within about one bf16 rounding of the output (2^-8 relative; the
    two sum in other orders, so a value near a rounding boundary may land
    on the neighbouring bf16 value), and within chip_smoke.py's TOL_BF16
    bar of 1e-2 x max(1, max|ref|)."""
    err = (out.float() - ref.float()).abs()
    assert float((err <= 1e-5 + 2 ** -7 * ref.float().abs()).float().mean()) \
        > 0.999, float(err.max())
    assert float(err.max()) <= 1e-2 * max(1.0, float(ref.float().abs().max()))


@pytest.mark.parametrize("L,n", [(1000, 2048), (1500, 2048), (999, 2048)])
def test_schedule_sampling_matches_jax_and_plain(L, n):
    """The sampling form's schedule vs JAX ``fftconv2_ln_bias_gelu_d`` with
    fast=True on its bf16 layout (``_conv2_impl``, interpret mode, as
    tests/test_torch_bf16.py runs it: the JAX chain in bf16, conv rel.
    error ~4e-3, so 1.5e-2 of max|ref|), and vs the port's plain version
    (``fftconv_ln_bias_gelu_d_ref``: one bf16 rounding)."""
    B, H = 2, 16
    d = _inputs(B, H, L, n, seed=3 + L)
    out, khat = _schedule_sampling(d, L, n)
    args = [torch.from_numpy(d["u"]).to(BF)] + [
        torch.from_numpy(d[k]) for k in ("a", "c", "bias")] + [
        khat, torch.from_numpy(d["D"])]
    _close_to_one_rounding(out, ops.fftconv_ln_bias_gelu_d_ref(*args))
    if L % 2:                 # JAX's compact layout takes even L only
        return
    ju, _ = _jax_inputs(d)
    lay = f2.choose_layout(L, n, H, bf16=True)
    kfr, kfi = f2.kernel_spectrum(jnp.asarray(d["k"]), lay)

    def comp(x):
        return f2.to_compact(jnp.asarray(x)[:, None], lay)[:, :, 0]
    yc = f2._conv2_impl(f2.to_compact(ju, lay), kfr, kfi,
                        jnp.asarray(d["D"]).reshape(H // lay.HB, lay.HB, 1),
                        lay, True, "gelu_d",
                        prologue=(comp(d["a"]), comp(d["c"]),
                                  jnp.asarray(d["bias"])))
    ref = np.asarray(jnp.asarray(f2.from_compact(yc, lay, L), jnp.float32))
    assert _rel(out.float().numpy(), ref) <= 1.5e-2


@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("L,n", [(1000, 2048), (1500, 2048)])
def test_schedule_conv_matches_jax_and_plain(L, n, conj):
    """The training entry's schedule (``conj``: the input gradient's form)
    vs JAX ``fftconv2`` with fast=True on its bf16 layout (interpret mode,
    JAX's call on -kfi for ``conj``; 1.5e-2 of max|ref|) and vs the port's
    ``fftconv_ref`` (one bf16 rounding)."""
    B, H = 2, 16
    d = _inputs(B, H, L, n, seed=7 + L)
    out, khat = _schedule_conv(d, L, n, conj)
    _close_to_one_rounding(out, ops.fftconv_ref(
        torch.from_numpy(d["u"]).to(BF), khat, conj))
    ju, _ = _jax_inputs(d)
    lay = f2.choose_layout(L, n, H, bf16=True)
    kfr, kfi = f2.kernel_spectrum(jnp.asarray(d["k"]), lay)
    yc = f2._conv2_impl(f2.to_compact(ju, lay), kfr, -kfi if conj else kfi,
                        None, lay, True, "none")
    ref = np.asarray(jnp.asarray(f2.from_compact(yc, lay, L), jnp.float32))
    assert _rel(out.float().numpy(), ref) <= 1.5e-2


def test_d_folded_into_the_spectrum_is_the_d_skip():
    """Adding D to every bin of the spectrum is the D-skip: irfft(rfft(u')
    (khat + D))[:L] = conv(u', k) + D u' (float64, to 1e-12)."""
    L, n, H = 700, 2048, 4
    d = _inputs(1, H, L, n, seed=5)
    x = torch.from_numpy(d["u"]).double()
    k = torch.fft.rfft(torch.from_numpy(d["k"]).double(), n=n)
    Dd = torch.from_numpy(d["D"]).double()
    lhs = _conv64(x, k + Dd[:, None], L, n)
    rhs = _conv64(x, k, L, n) + Dd[:, None] * x
    assert float((lhs - rhs).abs().max()) <= 1e-12


# ---- the wrappers -------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card, so that a wrapper takes
    its launch route up to the launcher."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("n,L", _bf16_sizes() + [(1024, 500)])
@pytest.mark.parametrize("form", ["sampling", "conv", "conj"])
def test_wrappers_pass_their_signatures(monkeypatch, n, L, form):
    """Kernel 1f's wrappers hand the entry point of the route conv_plan
    gives exactly the arguments its ctypes signature names, the stream
    apart (addresses where it takes pointers, ints where it takes ints;
    on the radix-16 route the plan's threads and smem last), and count one
    launch."""
    calls = []
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *a: calls.append(
        (name, a)))
    monkeypatch.setattr(cuda_lib, "check", lambda *a: None)
    B, H = 2, 8
    u = torch.zeros(B, H, L, dtype=BF).as_subclass(_OnCard)
    khat = torch.zeros(H, n // 2 + 1, dtype=C64)
    f = torch.zeros(B, L)
    plan = fc.conv_plan(n)
    r16 = plan.route == "radix16"
    if form == "sampling":
        wrapper = ops.fftconv_ln_bias_gelu_d_bf16
        before = wrapper.launches
        ops.fftconv_ln_bias_gelu_d(u, f, f, torch.zeros(B, H), khat,
                                   torch.zeros(H))
        entry = ("dwst_fftconv_r16_ln_bias_gelu_d_bf16" if r16
                 else "dwst_fftconv_ln_bias_gelu_d_bf16")
        tail = (B, H, L, n)
    else:
        wrapper = ops.fftconv_bf16
        before = wrapper.launches
        ops.fftconv(u, khat, conj=form == "conj")
        entry = "dwst_fftconv_r16_bf16" if r16 else "dwst_fftconv_bf16"
        tail = (B, H, L, n, int(form == "conj"))
    assert wrapper.launches == before + 1
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
    """``launch_sampling`` and ``launch_conv`` (on bf16 u) launch the route
    of the plan they are handed (chip_smoke.py times both routes in turns
    with them) and count nothing."""
    calls = []
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *a: calls.append(
        name))
    monkeypatch.setattr(cuda_lib, "check", lambda *a: None)
    B, H, L, n = 2, 8, 1000, 2048
    u = torch.zeros(B, H, L, dtype=BF).as_subclass(_OnCard)
    khat = torch.zeros(H, n // 2 + 1, dtype=C64)
    f = torch.zeros(B, L)
    before = {k: fn.launches for k, fn in ops.COUNTED.items()}
    fc.launch_sampling(u, f, f, torch.zeros(B, H), khat, torch.zeros(H),
                       plan)
    fc.launch_conv(u, khat, True, plan)
    r16 = "_r16" if plan.route == "radix16" else ""
    assert calls == [f"dwst_fftconv{r16}_ln_bias_gelu_d_bf16",
                     f"dwst_fftconv{r16}_bf16"]
    assert {k: fn.launches for k, fn in ops.COUNTED.items()} == before


def test_wrappers_are_their_plain_versions_on_cpu():
    """On CPU tensors both 1f wrappers return their plain versions' results
    bit for bit and count no launch, at L > n/2 too."""
    for L, n in ((1000, 2048), (1500, 2048)):
        d = _inputs(2, 4, L, n, seed=9)
        khat = torch.fft.rfft(torch.from_numpy(d["k"]), n=n)
        u = torch.from_numpy(d["u"]).to(BF)
        rest = [torch.from_numpy(d[k]) for k in ("a", "c", "bias")] + [
            khat, torch.from_numpy(d["D"])]
        before = {k: fn.launches for k, fn in ops.COUNTED.items()}
        assert torch.equal(ops.fftconv_ln_bias_gelu_d_bf16(u, *rest),
                           ops.fftconv_ln_bias_gelu_d_ref(u, *rest))
        for conj in (False, True):
            assert torch.equal(ops.fftconv_bf16(u, khat, conj),
                               ops.fftconv_ref(u, khat, conj))
        assert {k: fn.launches for k, fn in ops.COUNTED.items()} == before
