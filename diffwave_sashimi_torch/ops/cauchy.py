"""Symmetric Cauchy sum: the S4 (NPLR) resolvent evaluation (kernel 4).

    r[..., l] = sum_n v_n / (z_l - w_n) + conj(v_n) / (z_l - conj(w_n))

Port of ``diffwave_sashimi_tpu/ops/cauchy.py::cauchy_sym`` (plain version,
conjugate pairs included -- the reference's vendored ``cauchy_naive`` drops
them) and of ``ops/cauchy_pallas.py::cauchy_sym_pallas`` (the kernel, CUDA
source ``csrc/cauchy.cu``).  Both use the all-real form of each conjugate
pair, (a z + b) / (z^2 + c z + d) with a = 2 Re v, b = -2 Re(v conj w),
c = -2 Re w, d = |w|^2.
"""

from __future__ import annotations

import torch

from . import cuda_lib


def _coefficients(v, w):
    a = 2.0 * v.real
    b = -2.0 * (v.real * w.real + v.imag * w.imag)
    return a, b, -2.0 * w.real, w.real ** 2 + w.imag ** 2


def cauchy_sym(v, z, w):
    """Plain version.  v: (..., H, N) complex64; z: (Lz,) complex64;
    w: (H, N) complex64.  Returns (..., H, Lz) complex64."""
    a, b, c, d = _coefficients(v, w)
    denom = z * z + c[..., None] * z + d[..., None]     # (H, N, Lz)
    g0 = 1.0 / denom
    g1 = z * g0
    return (torch.einsum("...hn,hnl->...hl", a.to(g1.dtype), g1)
            + torch.einsum("...hn,hnl->...hl", b.to(g0.dtype), g0))


def cauchy_sym_fused(v, z, w):
    """Kernel-4 wrapper (same arguments and result as :func:`cauchy_sym`):
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if not v.is_cuda:
        return cauchy_sym(v, z, w)
    comp = v.shape[:-2]
    H, N = v.shape[-2:]
    K = 1
    for s in comp:
        K *= s
    a, b, c, d = _coefficients(v, w)
    a = a.reshape(K, H, N).contiguous()
    b = b.reshape(K, H, N).contiguous()
    c, d = c.contiguous(), d.contiguous()
    z = z.contiguous()
    Lz = z.shape[0]
    for t, shape in ((a, (K, H, N)), (b, (K, H, N)), (c, (H, N)), (d, (H, N))):
        cuda_lib.check(t, shape, torch.float32)
    cuda_lib.check(z, (Lz,), torch.complex64)
    out = torch.empty((K, H, Lz), dtype=torch.complex64, device=v.device)
    cuda_lib.launch("dwst_cauchy", a.data_ptr(), b.data_ptr(), c.data_ptr(),
                    d.data_ptr(), z.data_ptr(), out.data_ptr(), K, H, N, Lz)
    cauchy_sym_fused.launches += 1
    return out.reshape(*comp, H, Lz)


cauchy_sym_fused.launches = 0
