"""Port parity for the int8 S4 conv (kernel 12, ``+compute.conv_int8``):
its plain version against the JAX package's int8 kernel in interpret mode
(``_conv2_impl(..., int8=True)`` at one channel per program, HB = 1, where
the scale granularity is the port's) and against an f64 direct conv, the
quantized constants the CUDA kernel reads, the routing of the int8 ops,
and ``generate.main`` routing ``+compute.conv_int8=true`` to them.

Tolerances: the JAX suite's int8 budget is a relative error < 3e-2 of
max|ref| against an f64 direct conv (tests/test_fftconv2.py:237-262).  The
port and the JAX kernel quantize the same stages independently (the port
rounds each stage's float output to bf16 once before it is quantized; the
JAX kernel runs the stages at the activation dtype), so they are held to
each other at about that budget, and each to the f64 conv at it."""

import os

import numpy as np
import pytest
import torch

from test_torch_common import SMALL_CFG

import jax.numpy as jnp
from scipy.special import erf

from diffwave_sashimi_tpu.ops import fftconv2 as f2
from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.config import load_config
from diffwave_sashimi_torch.models import construct_model
from diffwave_sashimi_torch.ops import int8conv as q8
from diffwave_sashimi_torch.runtime import generate as port_generate
from diffwave_sashimi_torch.runtime.checkpoint import save_checkpoint
from diffwave_sashimi_torch.utils.exp import local_directory


def _inputs(L, n, B, H, prologue, seed=3):
    """(u, a, c, bias, k, D) numpy; without ``prologue`` the JAX int8 test's
    case: u' = u, k ~ 0.3 N(0, 1), D = 0."""
    rng = np.random.RandomState(seed)
    u = rng.randn(B, H, L).astype(np.float32)
    if prologue:
        a = (0.5 + rng.rand(B, L)).astype(np.float32)
        c = (0.3 * rng.randn(B, L)).astype(np.float32)
        bias = (0.3 * rng.randn(B, H)).astype(np.float32)
        D = (0.3 * rng.randn(H)).astype(np.float32)
    else:
        a, c = np.ones((B, L), np.float32), np.zeros((B, L), np.float32)
        bias, D = np.zeros((B, H), np.float32), np.zeros(H, np.float32)
    k = (0.3 * rng.randn(H, min(n, 2 * L))).astype(np.float32)
    return u, a, c, bias, k, D


def _port_args(u, a, c, bias, k, D, n, bf16):
    tu = torch.from_numpy(u)
    tu = tu.to(torch.bfloat16) if bf16 else tu
    return [tu] + [torch.from_numpy(x) for x in (a, c, bias)] + [
        torch.fft.rfft(torch.from_numpy(k), n=n), torch.from_numpy(D)]


def _max_rel(out, ref):
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _rms(out, ref):
    return float(np.sqrt(((out - ref) ** 2).mean() / (ref ** 2).mean()))


@pytest.mark.parametrize("bf16", [False, True])
def test_int8_matches_jax_int8_kernel_at_hb1(bf16):
    """Both forms against the JAX kernel with fast = bf16 on the port's
    layout (R 64, S 32, Rc 32 at n 2048).  f32 (exact GELU, f32 out): the
    same f32 arithmetic in another order, so only a value at a rounding
    tie lands on the other int8 code: max <= 2e-3, rms <= 2e-4 of the
    reference, 1/100 of the int8 error itself (rms 3.5e-2 here).  bf16
    (gelu_fast, bf16 out): the JAX kernel also rounds each stage's output
    to bf16 and the port does not, so the two quantize independently: rms
    <= 6e-2 of each other, and the port's rms error against the exact conv
    (kernel 1's plain version) within 1.25x of the JAX kernel's."""
    L, n, B, H = 1000, 2048, 2, 16
    u, a, c, bias, k, D = _inputs(L, n, B, H, prologue=True)
    R, S, Rc = q8.int8_layout(n, L)
    lay = f2.choose_layout(L, n, H, R=R, HB=1, bf16=bf16)
    assert (lay.S, lay.Rc, lay.HB) == (S, Rc, 1)
    args = _port_args(u, a, c, bias, k, D, n, bf16)
    ju = jnp.asarray(args[0].float().numpy()).astype(
        jnp.bfloat16 if bf16 else jnp.float32)
    kfr, kfi = f2.kernel_spectrum(jnp.asarray(k), lay)

    def comp(x):                         # (B, L) -> compact (B, S, Rc)
        return f2.to_compact(jnp.asarray(x)[:, None], lay)[:, :, 0]

    yc = f2._conv2_impl(f2.to_compact(ju, lay), kfr, kfi,
                        jnp.asarray(D).reshape(H, 1, 1), lay, bf16, "gelu_d",
                        prologue=(comp(a), comp(c), jnp.asarray(bias)),
                        int8=True)
    ref = np.asarray(f2.from_compact(yc, lay, L).astype(jnp.float32))
    out = ops.fftconv_int8_ref(*args)
    assert out.dtype == args[0].dtype
    out = out.float().numpy()
    if not bf16:
        assert _max_rel(out, ref) <= 2e-3 and _rms(out, ref) <= 2e-4
        return
    exact = ops.fftconv_ln_bias_gelu_d_ref(*args).float().numpy()
    assert _rms(out, ref) <= 6e-2, _rms(out, ref)
    assert _rms(out, exact) <= 1.25 * _rms(ref, exact)


@pytest.mark.parametrize("bf16", [False, True])
def test_int8_matches_f64_direct_conv_and_differs_from_exact(bf16):
    """The JAX int8 test's case (L 1000, n 2048, B 2, H 16): gelu of the
    int8 conv within 3e-2 of max|ref| of gelu of the f64 direct conv (the
    GELU is 1.13-Lipschitz at most), and not the exact path's output."""
    L, n, B, H = 1000, 2048, 2, 16
    u, a, c, bias, k, D = _inputs(L, n, B, H, prologue=False)
    args = _port_args(u, a, c, bias, k, D, n, bf16)
    x = args[0].double().numpy()
    y = np.fft.irfft(np.fft.rfft(x, n=n) * np.fft.rfft(
        k.astype(np.float64), n=n), n=n)[..., :L]
    ref = 0.5 * y * (1.0 + erf(y / np.sqrt(2.0)))
    out = ops.fftconv_int8_ref(*args).double().numpy()
    assert _max_rel(out, ref) < 3e-2, _max_rel(out, ref)
    exact = ops.fftconv_ln_bias_gelu_d_ref(*args).double().numpy()
    assert _max_rel(out, exact) > 1e-3


@pytest.mark.parametrize("bf16", [False, True])
def test_int8_mean_split_keeps_offset_rows_in_budget(bf16):
    """Rows offset by a constant (the step bias, 1.5 here against unit
    fluctuations, at the top tier's length): the JAX algorithm (no W)
    misses the f64 conv by far more than 3e-2 of its max, the mean split
    (W from ``int8_spectrum``, the conv of the window, to 1e-5 of an f64
    one) brings it within 3e-2."""
    L, n, B, H = 16000, 32768, 1, 8
    u, a, c, bias, k, D = _inputs(L, n, B, H, prologue=False)
    bias = np.full((B, H), 1.5, np.float32)
    k = 0.05 * k
    args = _port_args(u, a, c, bias, k, D, n, bf16)
    x = args[0].double().numpy() + bias[:, :, None]
    K = np.fft.rfft(k.astype(np.float64), n=n)
    y = np.fft.irfft(np.fft.rfft(x, n=n) * K, n=n)[..., :L]
    ref = 0.5 * y * (1.0 + erf(y / np.sqrt(2.0)))
    khat, W = ops.int8_spectrum(args[4], L)
    W64 = np.fft.irfft(np.fft.rfft(np.ones(L), n=n) * K, n=n)[..., :L]
    assert _max_rel(W.numpy(), W64) < 1e-5
    bare = ops.fftconv_int8_ref(*args).double().numpy()
    split = ops.fftconv_int8_ref(*args, W=W).double().numpy()
    assert _max_rel(bare, ref) > 6e-2, _max_rel(bare, ref)
    assert _max_rel(split, ref) < 3e-2, _max_rel(split, ref)


@pytest.mark.parametrize("n,L,layout", [(32768, 16000, (256, 128, 128)),
                                        (8192, 4000, (256, 32, 128)),
                                        (2048, 1000, (64, 32, 32))])
def test_int8_constants_are_the_kernels_layout(n, L, layout):
    """The SC09 tiers' layouts (JAX's R = 256 family; S raised to 32 at
    n 2048), the per-tensor quantization of ``_consts_q8``, and the int8
    buffer the CUDA kernel reads: the factors transposed so each product's
    contraction is innermost, DsP's and EsP's rows paired per 16-row tile
    (row g the real row i, row g + 8 the imaginary row of the same i)."""
    assert q8.int8_layout(n, L) == layout
    R, S, Rc = layout
    k = q8.int8_consts(n, L)
    q = k["q"]
    for name, m in q.items():
        assert m.dtype == np.int8 and np.abs(m).max() == 127, name
    assert np.all(np.abs(q["Alt8"][0]) == 127)
    flat, off = k["flat"], 0

    def take(shape):
        nonlocal off
        size = int(np.prod(shape))
        off += size
        return flat[off - size:off].reshape(shape)
    np.testing.assert_array_equal(take((R, Rc)), q["Drr"].T)
    np.testing.assert_array_equal(take((R, Rc)), q["Dri"].T)
    dsp, esp = take((S, 2 * S)), take((2 * S, S))
    for p in range(S):
        i = 8 * (p // 16) + p % 8
        want = i if p % 16 < 8 else S // 2 + i
        np.testing.assert_array_equal(dsp[p], q["DsP"][want])
    for p in range(2 * S):
        i = 8 * (p // 16) + p % 8
        want = i if p % 16 < 8 else S + i
        np.testing.assert_array_equal(esp[p], q["EsP"][want])
    np.testing.assert_array_equal(take((Rc, R)), q["Err"].T)
    np.testing.assert_array_equal(take((Rc, R)), q["Eri"].T)
    assert off == flat.size


def test_int8_ops_route_and_refuse_kernel9_sizes():
    """FUSED_INT8 / PLAIN_INT8 differ from FUSED / PLAIN in the conv and
    its spectrum only; the int8 conv takes the (khat, W) of
    ``int8_spectrum`` (a bare half spectrum: no mean split); the CPU
    wrapper is the plain version (no launch); a factorized (kernel 9)
    spectrum and FFT sizes outside [1024, 32768] are refused."""
    assert ops.FUSED_INT8._replace(conv=ops.s4_conv,
                                   spectrum=ops.sampling_spectrum) == ops.FUSED
    assert ops.PLAIN_INT8._replace(conv=ops.s4_conv_ref,
                                   spectrum=ops.sampling_spectrum) == ops.PLAIN
    L, n, B, H = 1000, 2048, 1, 8
    args = _port_args(*_inputs(L, n, B, H, prologue=True), n, True)
    spec = ops.int8_spectrum(args[4], L)
    before = ops.fftconv_int8.launches
    bare = ops.fftconv_int8_ref(*args)
    split = ops.fftconv_int8_ref(*args, W=spec[1])
    for conv in (ops.FUSED_INT8.conv, ops.PLAIN_INT8.conv):
        assert torch.equal(conv(*args), bare)
        assert torch.equal(conv(*args[:4], spec, args[5]), split)
    assert ops.fftconv_int8.launches == before
    kp = ops.long_spectrum(torch.fft.rfft(torch.randn(H, 65536), n=65536))
    for conv in (ops.FUSED_INT8.conv, ops.PLAIN_INT8.conv):
        with pytest.raises(NotImplementedError, match="kernel 1's FFT"):
            conv(args[0], *args[1:4], kp, args[5])
    for bad in (512, 65536, 3000):
        with pytest.raises(ValueError, match="int8 conv"):
            q8.int8_layout(bad, 100)


def test_generate_main_routes_conv_int8(tmp_path, monkeypatch):
    """``+compute.conv_int8=true`` samples through the int8 conv (every
    block of every step), at the config's bf16 and at f32; without it no
    int8 conv runs."""
    monkeypatch.chdir(tmp_path)
    over = ["experiment=sc09", "model.d_model=8", "model.n_layers=1",
            "diffusion.T=2", "generate.n_samples=1", "+generate.device=cpu"]
    cfg = load_config(overrides=over)
    run, ckpt = local_directory(None, cfg.model, cfg.diffusion, cfg.dataset,
                                "checkpoint")
    save_checkpoint(ckpt, 1, construct_model(
        SMALL_CFG, generator=torch.Generator().manual_seed(0)))
    calls = []
    real = q8.fftconv_int8_ref

    def spy(u, *rest):
        calls.append(u.dtype)
        return real(u, *rest)
    monkeypatch.setattr(q8, "fftconv_int8_ref", spy)
    for extra, want in (([], []),
                        (["+compute.conv_int8=true"], [torch.bfloat16] * 10),
                        (["+compute.conv_int8=true", "compute.precision=f32"],
                         [torch.float32] * 10)):
        calls.clear()
        port_generate.main(over + extra)
        assert calls == want, (extra, calls)     # 5 blocks x 2 steps
    wavs = os.listdir(os.path.join("exp", run, "waveforms", "1"))
    assert wavs == ["0k_0.wav"]
