"""Port parity: the kernel modules' plain versions (and the wrappers' CPU
route) vs the JAX package's functions, plus the init-time helpers (hippo,
nplr, weight norm).  Inputs from numpy seeds, f32 on the CPU."""

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (single-threaded torch)

import jax.numpy as jnp

from diffwave_sashimi_tpu.ops import chmix as jchmix
from diffwave_sashimi_tpu.ops import fftconv2 as f2
from diffwave_sashimi_tpu.ops import hippo as jhippo
from diffwave_sashimi_tpu.ops import nplr as jnplr
from diffwave_sashimi_tpu.ops.cauchy import cauchy_sym as jcauchy
from diffwave_sashimi_tpu.ops.cauchy import cauchy_sym_naive as jnaive
from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.ops import hippo, nplr
from diffwave_sashimi_torch.ops.conv import WNConv1d


def _c(rng, *shape, scale=1.0):
    return ((rng.randn(*shape) + 1j * rng.randn(*shape)) * scale).astype(
        np.complex64)


def _rel(out, ref):
    return float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("Lz", [9, 501])
def test_cauchy_matches_jax_cauchy_sym_and_naive(Lz):
    """Max error <= 2e-5 of max|ref| (complex64 sums of 32 terms)."""
    rng = np.random.RandomState(0)
    H, N = 8, 32
    v = _c(rng, 2, 3, H, N)
    w = (-np.abs(rng.randn(H, N)) * 0.5 + 1j * rng.randn(H, N) * 20).astype(
        np.complex64) * 0.01
    z = _c(rng, Lz, scale=3.0)
    ref = np.asarray(jcauchy(jnp.asarray(v), jnp.asarray(z), jnp.asarray(w)))
    naive = np.asarray(jnaive(jnp.asarray(v), jnp.asarray(z), jnp.asarray(w)))
    tv, tz, tw = map(torch.from_numpy, (v, z, w))
    out = ops.cauchy_sym(tv, tz, tw).numpy()
    assert out.shape == (2, 3, H, Lz)
    assert _rel(out, ref) < 2e-5
    assert _rel(out, naive) < 2e-5
    fused = ops.cauchy_sym_fused(tv, tz, tw)       # CPU route: plain
    np.testing.assert_array_equal(fused.numpy(), out)


@pytest.mark.parametrize("L,n,B,H", [(1000, 2048, 2, 16), (500, 1024, 3, 8)])
def test_fused_conv_matches_jax_fftconv2(L, n, B, H):
    """Plain kernel-1 version vs fftconv2_ln_bias_gelu_d (strict f32, the
    compact layout at choose_layout(L, n, H)): atol 1e-4, rtol 1e-4."""
    rng = np.random.RandomState(1)
    u = rng.randn(B, H, L).astype(np.float32)
    a = (0.5 + rng.rand(B, L)).astype(np.float32)
    c = (0.3 * rng.randn(B, L)).astype(np.float32)
    bias = (0.3 * rng.randn(B, H)).astype(np.float32)
    k = (0.05 * rng.randn(H, n)).astype(np.float32)
    D = rng.randn(H).astype(np.float32)

    lay = f2.choose_layout(L, n, H)
    kfr, kfi = f2.kernel_spectrum(jnp.asarray(k), lay)

    def comp(x):                         # (B, L) -> compact (B, S, Rc)
        return f2.to_compact(jnp.asarray(x)[:, None], lay)[:, :, 0]

    yc = f2.fftconv2_ln_bias_gelu_d(f2.to_compact(jnp.asarray(u), lay),
                                    comp(a), comp(c), jnp.asarray(bias),
                                    kfr, kfi, jnp.asarray(D), lay, False)
    ref = np.asarray(f2.from_compact(yc, lay, L))

    khat = torch.fft.rfft(torch.from_numpy(k), n=n)
    args = [torch.from_numpy(x) for x in (u, a, c, bias)] + [
        khat, torch.from_numpy(D)]
    out = ops.fftconv_ln_bias_gelu_d_ref(*args).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    before = ops.fftconv_ln_bias_gelu_d.launches
    np.testing.assert_array_equal(ops.fftconv_ln_bias_gelu_d(*args).numpy(),
                                  out)
    assert ops.fftconv_ln_bias_gelu_d.launches == before   # no kernel on CPU


def _chmix_inputs(B=2, H=16, L=40, F=32, seed=2):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)   # noqa: E731
    return dict(y=f(B, H, L), x=f(B, H, L) + 0.5, skip=f(B, H, L),
                w=f(2 * H, H) / 4, b=f(2 * H), w1=f(F, H) / 4, b1=f(F),
                w2=f(H, F) / 6, b2=f(H), m=f(1), s=np.abs(f(1)) + 0.5)


def test_glu_matches_jax_glu_res_ref():
    """Plain kernel-2 version vs glu_res_ref (compact layout with S = 1 is
    the flat layout): atol 1e-5, rtol 1e-5."""
    d = _chmix_inputs()
    j = lambda k: jnp.asarray(d[k])   # noqa: E731
    ref = np.asarray(jchmix.glu_res_ref(j("y")[:, None], j("x")[:, None],
                                        j("w"), j("b")))[:, 0]
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    out = ops.glu_res_ref(t["y"], t["x"], t["w"], t["b"]).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(
        ops.mix_glu_res(t["y"], t["x"], t["w"], t["b"]).numpy(), out)


@pytest.mark.parametrize("with_skip", [False, True])
def test_ff_matches_jax_ln_ff_res_ref(with_skip):
    """Plain kernel-3 version vs ln_ff_res_ref, output and emitted channel
    stats: atol 1e-5, rtol 1e-5."""
    d = _chmix_inputs()
    j = lambda k: jnp.asarray(d[k])   # noqa: E731
    skip_j = j("skip")[:, None] if with_skip else None
    ref, rm, rv = jchmix.ln_ff_res_ref(j("x")[:, None], j("m"), j("s"),
                                       j("w1"), j("b1"), j("w2"), j("b2"),
                                       skip=skip_j, emit_stats=True)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    args = (t["x"], t["m"], t["s"], t["w1"], t["b1"], t["w2"], t["b2"],
            t["skip"] if with_skip else None)
    out, mo, vo = ops.ln_ff_res_ref(*args, emit_stats=True)
    for o, r in ((out, np.asarray(ref)[:, 0]), (mo, np.asarray(rm)[:, 0]),
                 (vo, np.asarray(rv)[:, 0])):
        np.testing.assert_allclose(o.numpy(), r, atol=1e-5, rtol=1e-5)
    plain = ops.ln_ff_res_ref(*args)
    np.testing.assert_array_equal(ops.ln_ff_res(*args).numpy(),
                                  plain.numpy())


def test_hippo_legs_matches_jax():
    w, P, B = hippo.legs_nplr(64, 1, 8)
    jw, jP, jB = jhippo.combination("legs", 64, 1, 8)
    for a, b in ((w, jw), (P, jP), (B, jB)):
        np.testing.assert_allclose(a, b, atol=1e-12)


def test_discretize_and_setup_C_match_jax():
    """dA, dB and C~ = (I - dA^L)^* C at L = 16000 (14 squarings of dA):
    max error <= 1e-4 of max|ref| in complex64."""
    rng = np.random.RandomState(3)
    H, N2 = 4, 32
    w_np, P_np, B_np = hippo.legs_nplr(2 * N2, 1, H)
    w = w_np.astype(np.complex64)
    P = P_np.astype(np.complex64)
    Bm = B_np.astype(np.complex64)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), H)).astype(np.float32)
    C = _c(rng, 2, H, N2, scale=0.7)
    jdA, jdB = jnplr.discretize(*map(jnp.asarray, (w, P, Bm, dt)))
    dA, dB = nplr.discretize(*map(torch.from_numpy, (w, P, Bm, dt)))
    assert _rel(dA.numpy(), np.asarray(jdA)) < 1e-5
    assert _rel(dB.numpy(), np.asarray(jdB)) < 1e-5
    jC = np.asarray(jnplr.setup_C(jnp.asarray(C), jdA, 16000))
    tC = nplr.setup_C(torch.from_numpy(C), dA, 16000).numpy()
    assert _rel(tC, jC) < 1e-4
    v = _c(rng, H, 2 * N2, 37)
    jI, jv = jnplr.power_contract(37, jdA, jnp.asarray(v))
    tI, tv = nplr.power_contract(37, dA, torch.from_numpy(v))
    assert _rel(tI.numpy(), np.asarray(jI)) < 1e-4
    assert _rel(tv.numpy(), np.asarray(jv)) < 1e-4


def test_wnconv_effective_weight_matches_jax():
    from diffwave_sashimi_tpu.ops.conv import WNConv1d as JWN
    rng = np.random.RandomState(4)
    v = rng.randn(6, 5, 1).astype(np.float32)
    g = rng.rand(6).astype(np.float32) + 0.5
    b = rng.randn(6).astype(np.float32)
    ref = JWN(5, 6, kernel_size=1).apply(
        {"params": {"v": v, "g": g, "b": b}},
        method=lambda m: m.effective_weight())
    conv = WNConv1d(5, 6)
    with torch.no_grad():
        conv.conv["weight_v"].copy_(torch.from_numpy(v))
        conv.conv["weight_g"].copy_(torch.from_numpy(g).reshape(6, 1, 1))
        conv.conv["bias"].copy_(torch.from_numpy(b))
    np.testing.assert_allclose(conv.effective_weight().detach().numpy(),
                               np.asarray(ref), atol=1e-6, rtol=1e-6)
    x = rng.randn(2, 5, 7).astype(np.float32)
    jy = JWN(5, 6, kernel_size=1).apply({"params": {"v": v, "g": g, "b": b}},
                                        jnp.asarray(x))
    np.testing.assert_allclose(conv(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jy), atol=1e-5, rtol=1e-5)
