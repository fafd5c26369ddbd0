"""Fused S4 FFT convolution for the sampling path (kernel 1).

Port of ``diffwave_sashimi_tpu/ops/fftconv2.py::fftconv2_ln_bias_gelu_d``
in the flat (B, H, L) layout: the DiffWave block head (norm1 as a
per-position scale/shift + the diffusion-step bias) rides the convolution
as a prologue and the S4 D-skip + exact GELU as its epilogue.  The CUDA
kernel is ``csrc/fftconv.cu``; :func:`fftconv_ln_bias_gelu_d_ref` is its
plain PyTorch version (torch.fft), used for CPU tensors and as the on-card
comparison.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib


def fftconv_ln_bias_gelu_d_ref(u, a, c, bias, khat, D):
    """u' = a u + c + bias;  gelu(irfft(rfft(u', n) khat, n)[:L] + D u').

    u: (B, H, L); a, c: (B, L); bias: (B, H); khat: (H, n/2+1) complex64
    (the rfft of the combined bidirectional kernel at size n >= 2L);
    D: (H,).  Returns (B, H, L) float32.
    """
    L = u.shape[-1]
    n = 2 * (khat.shape[-1] - 1)
    xn = u * a[:, None, :] + c[:, None, :] + bias[:, :, None]
    y = torch.fft.irfft(torch.fft.rfft(xn, n=n) * khat, n=n)[..., :L]
    return F.gelu(y + D[:, None] * xn)


def fftconv_ln_bias_gelu_d(u, a, c, bias, khat, D):
    """Kernel-1 wrapper: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (same arguments as the plain version)."""
    if not u.is_cuda:
        return fftconv_ln_bias_gelu_d_ref(u, a, c, bias, khat, D)
    B, H, L = u.shape
    n = 2 * (khat.shape[-1] - 1)
    if n & (n - 1) or n < max(4, L):
        raise ValueError(f"FFT size {n} must be a power of two >= L = {L}")
    for t, shape in ((u, (B, H, L)), (a, (B, L)), (c, (B, L)),
                     (bias, (B, H)), (D, (H,))):
        cuda_lib.check(t, shape, torch.float32)
    cuda_lib.check(khat, (H, n // 2 + 1), torch.complex64)
    out = torch.empty_like(u)
    cuda_lib.launch("dwst_fftconv_ln_bias_gelu_d", u.data_ptr(), a.data_ptr(),
                    c.data_ptr(), bias.data_ptr(), khat.data_ptr(),
                    D.data_ptr(), out.data_ptr(), B, H, L, n)
    fftconv_ln_bias_gelu_d.launches += 1
    return out


fftconv_ln_bias_gelu_d.launches = 0
