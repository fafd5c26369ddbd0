"""Port parity for the long S4 FFT convolution (kernel 9): the plain version
against the JAX package's four-step Pallas conv (``fftconv_fused``, run in
interpret mode on the CPU at strict f32, and its channel-batched schedule),
the factorized spectrum the port builds once per run against its
definition, and the routing by FFT size.  Tolerance: 1e-5 x max(1, max
|ref|) (f32 transforms of a few thousand points)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import erf

import test_torch_common  # noqa: F401  (single-threaded torch)

from diffwave_sashimi_tpu.ops import fftconv_pallas as fp
from diffwave_sashimi_torch import ops

fl = importlib.import_module("diffwave_sashimi_torch.ops.fftconv_long")


def _case(B, H, L, n, L_k, seed=0):
    """u (B, H, L) and the combined bidirectional time kernel (H, n) of an
    S4 kernel of L_k taps each way (anticausal taps at the buffer's end)."""
    rng = np.random.RandomState(seed)
    u = rng.randn(B, H, L).astype(np.float32)
    k = np.zeros((H, n), np.float32)
    k[:, :L_k] = 0.05 * rng.randn(H, L_k)
    k[:, n - L_k:] += 0.05 * rng.randn(H, L_k)
    return u, k


def _port_spectrum(kf, n):
    """The JAX factorized spectrum (2, H, N1, K2) -> the port's (H, N1, N2),
    through the flat half spectrum as ``fftconv_pallas._unfused`` reads
    it."""
    N1, K2 = kf.shape[2:]
    half = np.asarray(kf[0]) + 1j * np.asarray(kf[1])
    half = np.swapaxes(half, -1, -2).reshape(kf.shape[1], N1 * K2)
    khat = torch.from_numpy(half[:, :n // 2 + 1].astype(np.complex64))
    return fl.long_spectrum(khat)


def _within(out, ref, tol=1e-5):
    err = float(np.max(np.abs(out - ref)))
    assert err <= tol * max(1.0, float(np.max(np.abs(ref)))), err


@pytest.mark.parametrize("L,n,L_k", [(200, 512, 200), (700, 2048, 300),
                                     (700, 2048, 700)])
def test_plain_long_conv_matches_jax_fftconv_fused(L, n, L_k):
    """B2, H8: the TPU kernel's contract against fftconv_fused and the
    unfused path, and the sampling form against fftconv_fused with the
    prologue and epilogue written out."""
    B, H = 2, 8
    u, k = _case(B, H, L, n, L_k)
    kf = fp.factorize_kernel_freq(jnp.asarray(k), n)
    ref = np.asarray(fp.fftconv_fused(jnp.asarray(u), kf, n, L, False))
    unfused = np.asarray(fp._unfused(jnp.asarray(u), kf, n, L))
    kp = _port_spectrum(kf, n)
    before = ops.fftconv_long.launches
    out = ops.fftconv_long(torch.from_numpy(u), kp).numpy()
    assert ops.fftconv_long.launches == before        # no kernel on the CPU
    _within(out, ref)
    _within(out, unfused)

    rng = np.random.RandomState(1)
    a = (0.5 + rng.rand(B, L)).astype(np.float32)
    c = (0.3 * rng.randn(B, L)).astype(np.float32)
    bias = (0.3 * rng.randn(B, H)).astype(np.float32)
    D = rng.randn(H).astype(np.float32)
    up = u * a[:, None] + c[:, None] + bias[:, :, None]
    y = np.asarray(fp.fftconv_fused(jnp.asarray(up), kf, n, L, False))
    z = y + D[:, None] * up
    gelu = 0.5 * z * (1.0 + erf(z / np.sqrt(2.0)))
    args = [torch.from_numpy(x) for x in (u, a, c, bias)]
    fused = ops.fftconv_long_ln_bias_gelu_d(*args, kp,
                                            torch.from_numpy(D)).numpy()
    _within(fused, gelu)


def test_plain_long_conv_matches_jax_batched_schedule(monkeypatch):
    """Row 10: the channel-batched schedule (opt-in BATCHED, N1 = N2 = 128)
    computes the same function; B1, H8, n 16384."""
    monkeypatch.setitem(fp.BATCHED, "enabled", True)
    B, H, L, n = 1, 8, 10000, 16384
    u, k = _case(B, H, L, n, 4000, seed=2)
    kf = fp.factorize_kernel_freq(jnp.asarray(k), n)
    ref = np.asarray(fp._fftconv_impl(jnp.asarray(u), kf, n, L, False))
    out = ops.fftconv_long(torch.from_numpy(u), _port_spectrum(kf, n))
    _within(out.numpy(), ref)


@pytest.mark.parametrize("n", [256, 2048, 1 << 15])
def test_long_spectrum_is_the_factorized_full_dft(n):
    """kp[h, k1, k2] = DFT_n(k)[k1 + N1 k2]; the half spectrum comes back
    exactly; its first K2 columns are the JAX factorize_kernel_freq."""
    H = 3
    _, k = _case(1, H, 1, n, n // 4, seed=3)
    khat = torch.fft.rfft(torch.from_numpy(k), n=n)
    kp = fl.long_spectrum(khat)
    N1, N2 = fl.split(n)
    assert (N1, N2) == (fp._consts(n)["N1"], fp._consts(n)["N2"])
    assert kp.shape == (H, N1, N2) and kp.dtype == torch.complex64
    full = np.fft.fft(k.astype(np.float64), axis=-1)
    want = full.reshape(H, N2, N1).transpose(0, 2, 1)
    _within(kp.numpy(), want, 1e-6)
    assert torch.equal(fl.half_spectrum(kp)[:, 1:-1], khat[:, 1:-1])
    assert float(fl.half_spectrum(kp)[:, [0, -1]].imag.abs().max()) == 0.0
    kf = np.asarray(fp.factorize_kernel_freq(jnp.asarray(k), n))
    K2 = kf.shape[-1]
    _within(kp.numpy()[:, :, :K2], kf[0] + 1j * kf[1], 1e-6)


def test_sampling_spectrum_routes_by_fft_size():
    """Half spectra up to kernel 1's n = 32768 stay; above, kernel 9's
    layout; above 2^20, refused.  s4_conv follows the layout."""
    H = 2
    small = torch.fft.rfft(torch.randn(H, 32768), n=32768)
    assert fl.sampling_spectrum(small) is small
    big = torch.fft.rfft(torch.randn(H, 65536), n=65536)
    kp = fl.sampling_spectrum(big)
    assert kp.shape == (H, 256, 256)
    with pytest.raises(ValueError, match="past the long conv"):
        fl.sampling_spectrum(torch.zeros(1, (1 << 20) + 1,
                                         dtype=torch.complex64))
    g = torch.Generator().manual_seed(0)
    u = torch.randn(2, H, 30000, generator=g)
    a, c = torch.rand(2, 30000, generator=g) + 0.5, torch.zeros(2, 30000)
    bias, D = torch.randn(2, H, generator=g), torch.randn(H, generator=g)
    assert torch.equal(ops.s4_conv(u, a, c, bias, kp, D),
                       ops.fftconv_long_ln_bias_gelu_d_ref(u, a, c, bias,
                                                           kp, D))
    assert torch.equal(ops.PLAIN.conv(u, a, c, bias, kp, D),
                       ops.FUSED.conv(u, a, c, bias, kp, D))
    assert torch.equal(ops.s4_conv(u, a, c, bias, small, D),
                       ops.fftconv_ln_bias_gelu_d_ref(u, a, c, bias, small,
                                                      D))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    u = torch.zeros(2, 4, 300)
    with pytest.raises(ValueError, match="power-of-two split"):
        fl._check(u, torch.zeros(4, 32, 8, dtype=torch.complex64))
    with pytest.raises(ValueError, match="power-of-two split"):
        fl._check(u, torch.zeros(4, 16, 16, dtype=torch.complex64))
    with pytest.raises(ValueError, match="contiguous CUDA"):
        fl._check(u, torch.zeros(4, 16, 32, dtype=torch.complex64))
