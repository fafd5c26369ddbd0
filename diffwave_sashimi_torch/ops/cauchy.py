"""Symmetric Cauchy sum: the S4 (NPLR) resolvent evaluation (kernel 4)
and its closed-form backward (kernel 8).

    r[..., l] = sum_n v_n / (z_l - w_n) + conj(v_n) / (z_l - conj(w_n))

Port of ``diffwave_sashimi_tpu/ops/cauchy.py::cauchy_sym`` (plain version,
conjugate pairs included -- the reference's vendored ``cauchy_naive`` drops
them) and of ``ops/cauchy_pallas.py::cauchy_sym_pallas`` with its custom
VJP ``_cauchy_quad`` (the kernels, CUDA source ``csrc/cauchy.cu``).  Both
use the all-real form of each conjugate pair, (a z + b) / (z^2 + c z + d)
with a = 2 Re v, b = -2 Re(v conj w), c = -2 Re w, d = |w|^2.  The
autograd Function takes and returns real tensors only (a, b, c, d ->
out_re, out_im); the coefficients and ``torch.complex`` stay outside it in
torch autograd, so torch's complex-gradient conventions never reach the
kernels.
"""

from __future__ import annotations

import torch

from . import cuda_lib


def _coefficients(v, w):
    a = 2.0 * v.real
    b = -2.0 * (v.real * w.real + v.imag * w.imag)
    return a, b, -2.0 * w.real, w.real ** 2 + w.imag ** 2


def cauchy_quad_ref(a, b, c, d, z):
    """out[k, m, l] = sum_n (a[k,m,n] z_l + b[k,m,n]) / (z_l^2 + c[m,n] z_l
    + d[m,n]) as (out_re, out_im), each (K, M, Lz) real."""
    g0 = 1.0 / (z * z + c[..., None] * z + d[..., None])    # (M, N, Lz)
    g1 = z * g0
    out = (torch.einsum("kmn,mnl->kml", a.to(g1.dtype), g1)
           + torch.einsum("kmn,mnl->kml", b.to(g0.dtype), g0))
    return out.real, out.imag


def cauchy_sym(v, z, w):
    """Plain version.  v: (..., H, N) complex64; z: (Lz,) complex64;
    w: (H, N) complex64.  Returns (..., H, Lz) complex64."""
    comp = v.shape[:-2]
    H, N = v.shape[-2:]
    a, b, c, d = _coefficients(v, w)
    K = a.numel() // (H * N)
    out_re, out_im = cauchy_quad_ref(a.reshape(K, H, N), b.reshape(K, H, N),
                                     c, d, z)
    return torch.complex(out_re, out_im).reshape(*comp, H, z.shape[0])


def cauchy_bwd_ref(a, b, c, d, z, g_re, g_im):
    """Closed-form gradients of :func:`cauchy_quad_ref` for the cotangents
    (g_re, g_im) of (out_re, out_im), summed over l (JAX ``_bwd_kernel``):
    with G0 = 1/den, G1 = z/den, gc_k = g_re_k - i g_im_k,

        da_kn = sum_l Re(gc_k G1),  db_kn = sum_l Re(gc_k G0)
        dd_n  = -sum_l Re(G0 G0 T), dc_n = -sum_l Re(G1 G0 T),
        T = z A + Bb,  A = sum_k a_kn gc_k,  Bb = sum_k b_kn gc_k.

    Returns (da, db, dc, dd) shaped like (a, b, c, d)."""
    g0 = 1.0 / (z * z + c[..., None] * z + d[..., None])    # (M, N, Lz)
    g1 = z * g0
    gc = torch.complex(g_re, -g_im)                          # (K, M, Lz)
    da = torch.einsum("kml,mnl->kmn", gc, g1).real
    db = torch.einsum("kml,mnl->kmn", gc, g0).real
    A = torch.einsum("kmn,kml->mnl", a.to(gc.dtype), gc)
    Bb = torch.einsum("kmn,kml->mnl", b.to(gc.dtype), gc)
    w = g0 * (z * A + Bb)
    return da, db, -(g1 * w).real.sum(-1), -(g0 * w).real.sum(-1)


def _contiguous(*ts):
    return [t.contiguous() for t in ts]


def cauchy_quad(a, b, c, d, z):
    """Kernel-4 wrapper: :func:`cauchy_quad_ref` as the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if not a.is_cuda:
        return cauchy_quad_ref(a, b, c, d, z)
    K, M, N = a.shape
    Lz = z.shape[0]
    a, b, c, d, z = _contiguous(a, b, c, d, z)
    for t, shape in ((a, (K, M, N)), (b, (K, M, N)), (c, (M, N)),
                     (d, (M, N))):
        cuda_lib.check(t, shape, torch.float32)
    cuda_lib.check(z, (Lz,), torch.complex64)
    out = torch.empty((K, M, Lz), dtype=torch.complex64, device=a.device)
    cuda_lib.launch("dwst_cauchy", a.data_ptr(), b.data_ptr(), c.data_ptr(),
                    d.data_ptr(), z.data_ptr(), out.data_ptr(), K, M, N, Lz)
    cauchy_quad.launches += 1
    return out.real, out.imag


cauchy_quad.launches = 0


def cauchy_bwd(a, b, c, d, z, g_re, g_im):
    """Kernel-8 wrapper: :func:`cauchy_bwd_ref` as the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if not a.is_cuda:
        return cauchy_bwd_ref(a, b, c, d, z, g_re, g_im)
    K, M, N = a.shape
    Lz = z.shape[0]
    a, b, c, d, z = _contiguous(a, b, c, d, z)
    g = torch.complex(g_re, g_im).contiguous()
    for t, shape in ((a, (K, M, N)), (b, (K, M, N)), (c, (M, N)),
                     (d, (M, N))):
        cuda_lib.check(t, shape, torch.float32)
    cuda_lib.check(z, (Lz,), torch.complex64)
    cuda_lib.check(g, (K, M, Lz), torch.complex64)
    da, db = torch.empty_like(a), torch.empty_like(b)
    dc, dd = torch.empty_like(c), torch.empty_like(d)
    cuda_lib.launch("dwst_cauchy_bwd", a.data_ptr(), b.data_ptr(),
                    c.data_ptr(), d.data_ptr(), z.data_ptr(), g.data_ptr(),
                    da.data_ptr(), db.data_ptr(), dc.data_ptr(),
                    dd.data_ptr(), K, M, N, Lz)
    cauchy_bwd.launches += 1
    return da, db, dc, dd


cauchy_bwd.launches = 0


class _CauchyQuad(torch.autograd.Function):
    """Forward kernel 4, backward kernel 8 (JAX ``_cauchy_quad``), on real
    tensors only; z is a constant."""

    @staticmethod
    def forward(ctx, a, b, c, d, z):
        ctx.save_for_backward(a, b, c, d, z)
        out_re, out_im = cauchy_quad(a, b, c, d, z)
        return out_re.contiguous(), out_im.contiguous()

    @staticmethod
    def backward(ctx, g_re, g_im):
        a, b, c, d, z = ctx.saved_tensors
        if g_re is None:
            g_re = torch.zeros_like(g_im)
        if g_im is None:
            g_im = torch.zeros_like(g_re)
        return (*cauchy_bwd(a, b, c, d, z, g_re, g_im), None)


def cauchy_sym_fused(v, z, w):
    """Same arguments and result as :func:`cauchy_sym`, through kernels 4
    and 8 (the plain versions for CPU tensors); differentiable in v and w
    through the coefficient construction."""
    comp = v.shape[:-2]
    H, N = v.shape[-2:]
    a, b, c, d = _coefficients(v, w)
    K = a.numel() // (H * N)
    out_re, out_im = _CauchyQuad.apply(a.reshape(K, H, N), b.reshape(K, H, N),
                                       c, d, z)
    return torch.complex(out_re, out_im).reshape(*comp, H, z.shape[0])
