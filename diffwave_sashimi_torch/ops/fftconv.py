"""S4 FFT convolution (kernel 1) and its spectrum gradient (kernel 5).

Ports of ``diffwave_sashimi_tpu/ops/fftconv2.py`` in the flat (B, H, L)
layout, CUDA source ``csrc/fftconv.cu``:

- sampling form, ``fftconv2_ln_bias_gelu_d``: the DiffWave block head
  (norm1 as a per-position scale/shift + the diffusion-step bias) rides
  the convolution as a prologue and the S4 D-skip + exact GELU as its
  epilogue (:func:`fftconv_ln_bias_gelu_d`); for bf16 activations its
  ``fast=True`` form, kernel 1f (:func:`fftconv_ln_bias_gelu_d_bf16`: bf16
  in and out, the chain f32, :func:`gelu_fast`);
- training form, ``fftconv2`` with its custom VJP: the plain conv
  ``y = irfft(rfft(u, n) khat, n)[:L]`` (:func:`fftconv`), whose input
  gradient is the same conv with ``conj(khat)`` (k is real), and the
  spectrum gradient ``fftconv2_dkf`` (:func:`fftconv_dkf`), wrapped as the
  autograd Function :func:`fftconv_train`, which takes the long route of
  :mod:`.fftconv_long` past kernel 1's FFT sizes; for bf16 activations their
  ``fast=True`` forms, kernel 1f's training entry (:func:`fftconv_bf16`)
  and kernel 5f (:func:`fftconv_dkf_bf16`): bf16 in (and, for the conv,
  out), the transforms f32, the spectrum gradient complex64.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
PyTorch version (the ``*_ref`` functions, torch.fft with explicit
formulas) for CPU tensors; the plain versions are also the on-card
comparison.

Kernels 1 and 1f (both forms each) have two routes, chosen by the FFT
size alone (:func:`conv_plan`): the radix-16 kernel
(``fftconv_r16_kernel<M, FUSED, T>``: the zero half of the input pruned,
the spectrum split merged into the passes around it; for 1f the D-skip
folded into the spectrum, for kernel 1 twiddles from once-rounded roots,
the D-skip in the epilogue and the exact GELU) at :data:`RADIX16_SIZES`,
every size the SaShiMi paths launch them at; the Stockham kernel
(``fftconv_kernel``) at the rest.

Kernels 5 and 5f have two routes too, chosen by the FFT size (and sized by
the batch) in :func:`dkf_plan`: the radix-16 kernel
(``fftconv_dkf_r16_kernel``: the batch's transforms of u and g in
parallel, several a block at the smaller sizes, a thread-block cluster of
blocks a channel, the batch summed over the cluster's shared memory in b
order) at :data:`RADIX16_SIZES`, the
Stockham kernel (``fftconv_dkf_kernel``: one block a channel walking the
batch) at the rest.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import cuda_lib


# The JAX package's polynomial GELU (ops/fftconv2.py::_gelu_fast): a fit
# of gelu(x) - x/2 as a degree-7 polynomial in x^2 on [-4, 4], |err| <
# 1.3e-3, x itself above 4.
_GELU_C = (3.98530402e-01, -6.54241398e-02, 9.14217304e-03,
           -8.87377753e-04, 5.52706534e-05, -1.95562042e-06,
           2.95654090e-08)


def widen(t):
    """bf16 activations as f32 for the float arithmetic around a product;
    other dtypes as they are."""
    return t.float() if t.dtype == torch.bfloat16 else t


def as_operand(w, dtype):
    """A product's operand as a bf16 product takes it when ``dtype`` is
    bf16 (rounded to bf16, held in f32: an f32 product of such operands is
    the f32-accumulated product of the rounded ones); else as it is."""
    return w.to(dtype).float() if dtype == torch.bfloat16 else w


def gelu_fast(x):
    """The bf16 path's GELU (f32 in, f32 out)."""
    xc = x.clamp(-4.0, 4.0)
    x2 = xc * xc
    p = torch.full_like(x2, _GELU_C[-1])
    for c in _GELU_C[-2::-1]:
        p = p * x2 + c
    return torch.where(x > 4.0, x, 0.5 * xc + x2 * p)


def gelu_fast_grad(x):
    """d/dx of :func:`gelu_fast` (JAX ``ops/chmix.py::_gelu_fast_grad``):
    0.5 + 2 x (p + x^2 p') on [-4, 4], with p' the derivative of the
    polynomial in x^2; 1 above 4 and 0 below -4."""
    xc = x.clamp(-4.0, 4.0)
    x2 = xc * xc
    p = torch.full_like(x2, _GELU_C[-1])
    for c in _GELU_C[-2::-1]:
        p = p * x2 + c
    n = len(_GELU_C) - 1
    pp = torch.full_like(x2, n * _GELU_C[n])
    for i in range(n - 1, 0, -1):
        pp = pp * x2 + i * _GELU_C[i]
    inner = 0.5 + 2.0 * xc * (p + x2 * pp)
    return torch.where(x > 4.0, torch.ones_like(x),
                       torch.where(x < -4.0, torch.zeros_like(x), inner))


KERNEL1_MAX_N = 32768     # kernel 1's largest FFT (one block's shared memory)


def _fft_size_of(khat) -> int:
    return 2 * (khat.shape[-1] - 1)


# Kernels 1's and 1f's radix-16 route (csrc/fftconv.cu::
# fftconv_r16_kernel): each thread holds R16_HELD complex values between
# passes; the FFT sizes the kernel has instances for: every size the
# SaShiMi paths launch kernel 1 or 1f at (SC09's three tiers, the
# vocoder's deepest, d_model 256's), at each of which it beat the Stockham
# kernel in turns on the H100 (PERF.md, §6, kernels 1 and 1f)
R16_HELD = 32
RADIX16_SIZES = (2048, 8192, 16384, 32768)


class ConvPlan(NamedTuple):
    """How kernel 1 or 1f runs at one FFT size: the route (``"radix16"`` or
    ``"stockham"``), and on the radix-16 route the radices of the forward
    complex transform's passes (first to last; the inverse runs them in
    the other order), the threads a block and its shared-memory bytes (0
    each on the Stockham route, which sizes its own launch)."""
    route: str
    radices: tuple
    threads: int
    smem: int


STOCKHAM = ConvPlan("stockham", (), 0, 0)


def radix16_plan(n: int) -> ConvPlan:
    """The radix-16 route at FFT size n (of :data:`RADIX16_SIZES`): the
    M = n/2 point complex transform of the packed real row as one pass of
    radix R0 = M / 16^P and P >= 2 passes of radix 16 (M = 16384: 4, 16,
    16, 16), M / 32 threads (a thread takes 32 values a pass: two radix-16
    butterflies, or 32 / R0 of the radix-R0 pass), and M + M/16 slots of
    8 bytes (one pad slot per 16 values)."""
    M = n // 2
    P = (M.bit_length() - 2) // 4
    return ConvPlan("radix16", (M >> (4 * P),) + (16,) * P, M // R16_HELD,
                    8 * (M + M // 16))


def conv_plan(n: int) -> ConvPlan:
    """Kernels 1's and 1f's route at FFT size n, by n alone (both forms,
    both activation types): the radix-16 kernel for
    n in :data:`RADIX16_SIZES`, the Stockham kernel for every other n.
    The kernel takes the plan as given: this is the one place it is
    computed."""
    return radix16_plan(n) if n in RADIX16_SIZES else STOCKHAM


# Kernels 5 and 5f's radix-16 route (csrc/fftconv.cu::
# fftconv_dkf_r16_kernel): at most DKF_MAX_ROWS batch rows a chunk (2 rows
# transforms, u and g of each row), and at each FFT size the transforms a
# block (csrc dkf_per_block: a chunk's 8 one-warp transforms at n 2048, one
# elsewhere)
DKF_MAX_ROWS = 4
DKF_PER_BLOCK = {2048: 2 * DKF_MAX_ROWS, 8192: 1, 16384: 1, 32768: 1}


class DkfPlan(NamedTuple):
    """How kernel 5 or 5f runs at one FFT size and batch: the route
    (``"radix16"`` or ``"stockham"``), and on the radix-16 route the batch
    rows a chunk, the transforms a block, the blocks of a channel's
    thread-block cluster, the threads a block and its shared-memory bytes
    (0 each on the Stockham route, which sizes its own launch)."""
    route: str
    rows: int
    per_block: int
    cluster: int
    threads: int
    smem: int


DKF_STOCKHAM = DkfPlan("stockham", 0, 0, 0, 0, 0)


def dkf_plan(n: int, B: int, rows: int | None = None) -> DkfPlan:
    """Kernel 5's or 5f's route at FFT size n and batch B: the radix-16
    kernel for n in :data:`RADIX16_SIZES` (min(B, DKF_MAX_ROWS) rows a
    chunk, or ``rows``, which chip_smoke.py times the route at;
    DKF_PER_BLOCK[n] transforms of :func:`radix16_plan`'s threads and
    shared memory a block; ceil(2 rows / per_block) blocks a cluster), the
    Stockham kernel for every other n.  The kernel takes the plan as
    given: this is the one place it is computed.  Raises ValueError for B
    < 1, rows outside 1 .. DKF_MAX_ROWS, or n not a power of two >= 32."""
    if B < 1:
        raise ValueError(f"batch {B} must be >= 1")
    rows = min(B, DKF_MAX_ROWS) if rows is None else rows
    if not 1 <= rows <= DKF_MAX_ROWS:
        raise ValueError(f"rows {rows} must be in 1 .. {DKF_MAX_ROWS}")
    _check_fft_size(n, 1)
    if n not in RADIX16_SIZES:
        return DKF_STOCKHAM
    r16, q = radix16_plan(n), DKF_PER_BLOCK[n]
    return DkfPlan("radix16", rows, q, -(-2 * rows // q), q * r16.threads,
                   q * r16.smem)


def _check_fft_size(n: int, L: int) -> None:
    if n & (n - 1) or n < max(32, L):
        raise ValueError(f"FFT size {n} must be a power of two >= "
                         f"max(32, L = {L})")


def fftconv_ln_bias_gelu_d_ref(u, a, c, bias, khat, D):
    """u' = a u + c + bias;  gelu(irfft(rfft(u', n) khat, n)[:L] + D u').

    u: (B, H, L) float32, or bfloat16 for kernel 1f's function (u' and the
    conv in f32, gelu_fast, the result rounded to bf16); a, c: (B, L);
    bias: (B, H); khat: (H, n/2+1) complex64 (the rfft of the combined
    bidirectional kernel at size n >= 2L); D: (H,), all float32.  Returns
    (B, H, L) in u's dtype.
    """
    L = u.shape[-1]
    n = 2 * (khat.shape[-1] - 1)
    xn = widen(u) * a[:, None, :] + c[:, None, :] + bias[:, :, None]
    y = torch.fft.irfft(torch.fft.rfft(xn, n=n) * khat, n=n)[..., :L]
    gelu = gelu_fast if u.dtype == torch.bfloat16 else F.gelu
    return gelu(y + D[:, None] * xn).to(u.dtype)


def fftconv_ln_bias_gelu_d(u, a, c, bias, khat, D):
    """Kernel-1 wrapper: the CUDA kernel on the route :func:`conv_plan`
    gives its FFT size for CUDA tensors, the plain version for CPU tensors
    (same arguments as the plain version); bf16 activations go to kernel
    1f."""
    if not u.is_cuda:
        return fftconv_ln_bias_gelu_d_ref(u, a, c, bias, khat, D)
    if u.dtype == torch.bfloat16:
        return fftconv_ln_bias_gelu_d_bf16(u, a, c, bias, khat, D)
    out = launch_sampling(u, a, c, bias, khat, D,
                          conv_plan(_fft_size_of(khat)))
    fftconv_ln_bias_gelu_d.launches += 1
    return out


fftconv_ln_bias_gelu_d.launches = 0


def fftconv_ln_bias_gelu_d_bf16(u, a, c, bias, khat, D):
    """Kernel-1f wrapper (u bf16, the rest as kernel 1's): the CUDA kernel
    on the route :func:`conv_plan` gives its FFT size for CUDA tensors,
    the plain version for CPU tensors."""
    if not u.is_cuda:
        return fftconv_ln_bias_gelu_d_ref(u, a, c, bias, khat, D)
    out = launch_sampling(u, a, c, bias, khat, D,
                          conv_plan(_fft_size_of(khat)))
    fftconv_ln_bias_gelu_d_bf16.launches += 1
    return out


fftconv_ln_bias_gelu_d_bf16.launches = 0


def launch_sampling(u, a, c, bias, khat, D, plan):
    """Check the sampling arguments of kernel 1 (u float32) or 1f (u
    bf16) and launch it on ``plan``'s route (uncounted; the wrappers
    count)."""
    B, H, L = u.shape
    n = _fft_size_of(khat)
    _check_fft_size(n, L)
    bf16 = u.dtype == torch.bfloat16
    cuda_lib.check(u, (B, H, L), torch.bfloat16 if bf16 else torch.float32)
    for t, shape in ((a, (B, L)), (c, (B, L)), (bias, (B, H)), (D, (H,))):
        cuda_lib.check(t, shape, torch.float32)
    cuda_lib.check(khat, (H, n // 2 + 1), torch.complex64)
    out = torch.empty_like(u)
    args = (u.data_ptr(), a.data_ptr(), c.data_ptr(), bias.data_ptr(),
            khat.data_ptr(), D.data_ptr(), out.data_ptr(), B, H, L, n)
    suffix = "_bf16" if bf16 else ""
    if plan.route == "radix16":
        cuda_lib.launch(f"dwst_fftconv_r16_ln_bias_gelu_d{suffix}", *args,
                        plan.threads, plan.smem)
    else:
        cuda_lib.launch(f"dwst_fftconv_ln_bias_gelu_d{suffix}", *args)
    return out


def fftconv_ref(u, khat, conj=False):
    """y = irfft(rfft(u, n) khat, n)[:L] (``conj``: with conj(khat), the
    adjoint of the same conv).  u: (B, H, L) float32, or bfloat16 for
    kernel 1f's training function (the conv in f32, the result rounded to
    bf16); khat: (H, n/2+1) complex64.  Returns (B, H, L) in u's dtype."""
    L = u.shape[-1]
    n = _fft_size_of(khat)
    k = khat.conj() if conj else khat
    return torch.fft.irfft(torch.fft.rfft(widen(u), n=n) * k,
                           n=n)[..., :L].to(u.dtype)


def fftconv_dkf_ref(u, g, n):
    """The khat gradient of :func:`fftconv_ref` for the output cotangent
    g, as torch autograd defines it for a complex input: sum over the
    batch of conj(rfft(u, n)) c_k rfft(g, n), where c_k = 1/n at the DC
    and Nyquist bins and 2/n between them (the adjoint of irfft counts the
    interior bins twice and the real parts of the two edge bins once).
    u, g: (B, H, L) float32, or bfloat16 (kernel 5f's function: the
    transforms and the sum in f32).  Returns (H, n/2+1) complex64."""
    U = torch.fft.rfft(widen(u), n=n)
    G = torch.fft.rfft(widen(g), n=n)
    c = torch.full((n // 2 + 1,), 2.0 / n, dtype=U.real.dtype,
                   device=u.device)
    c[0] = c[-1] = 1.0 / n
    return (U.conj() * G).sum(dim=0) * c


def fftconv(u, khat, conj=False):
    """Kernel-1 training entry: :func:`fftconv_ref` as a CUDA kernel (the
    sampling kernel's FFT code without its prologue and epilogue) on the
    route :func:`conv_plan` gives its FFT size for CUDA tensors, the plain
    version for CPU tensors; bf16 activations go to kernel 1f's training
    entry."""
    if not u.is_cuda:
        return fftconv_ref(u, khat, conj)
    if u.dtype == torch.bfloat16:
        return fftconv_bf16(u, khat, conj)
    out = launch_conv(u, khat, conj, conv_plan(_fft_size_of(khat)))
    fftconv.launches += 1
    return out


fftconv.launches = 0


def fftconv_bf16(u, khat, conj=False):
    """Kernel 1f's training entry (u and the result bf16, khat complex64):
    the CUDA kernel on the route :func:`conv_plan` gives its FFT size for
    CUDA tensors, the plain version for CPU tensors."""
    if not u.is_cuda:
        return fftconv_ref(u, khat, conj)
    out = launch_conv(u, khat, conj, conv_plan(_fft_size_of(khat)))
    fftconv_bf16.launches += 1
    return out


fftconv_bf16.launches = 0


def launch_conv(u, khat, conj, plan):
    """Check the arguments of kernel 1's training entry (u float32) or
    1f's (u bf16) and launch it on ``plan``'s route (uncounted; the
    wrappers count)."""
    B, H, L = u.shape
    n = _fft_size_of(khat)
    _check_fft_size(n, L)
    bf16 = u.dtype == torch.bfloat16
    cuda_lib.check(u, (B, H, L), torch.bfloat16 if bf16 else torch.float32)
    cuda_lib.check(khat, (H, n // 2 + 1), torch.complex64)
    out = torch.empty_like(u)
    args = (u.data_ptr(), khat.data_ptr(), out.data_ptr(), B, H, L, n,
            int(conj))
    suffix = "_bf16" if bf16 else ""
    if plan.route == "radix16":
        cuda_lib.launch(f"dwst_fftconv_r16{suffix}", *args, plan.threads,
                        plan.smem)
    else:
        cuda_lib.launch(f"dwst_fftconv{suffix}", *args)
    return out


def fftconv_dkf(u, g, n):
    """Kernel-5 wrapper: :func:`fftconv_dkf_ref` as a CUDA kernel (batch
    summed inside the kernel) on the route :func:`dkf_plan` gives for CUDA
    tensors, the plain version for CPU tensors; bf16 activations go to
    kernel 5f."""
    if not u.is_cuda:
        return fftconv_dkf_ref(u, g, n)
    if u.dtype == torch.bfloat16:
        return fftconv_dkf_bf16(u, g, n)
    return _launch_dkf(fftconv_dkf, torch.float32, u, g, n)


fftconv_dkf.launches = 0


def fftconv_dkf_bf16(u, g, n):
    """Kernel-5f wrapper (u, g bf16; the result complex64): the CUDA kernel
    on the route :func:`dkf_plan` gives for CUDA tensors, the plain version
    for CPU tensors."""
    if not u.is_cuda:
        return fftconv_dkf_ref(u, g, n)
    return _launch_dkf(fftconv_dkf_bf16, torch.bfloat16, u, g, n)


fftconv_dkf_bf16.launches = 0


def _launch_dkf(wrapper, dtype, u, g, n):
    """Launch kernel 5 or 5f (u and g of ``dtype``) on the route
    :func:`dkf_plan` gives and count it on ``wrapper``."""
    cuda_lib.check(u, tuple(u.shape), dtype)
    out = launch_dkf(u, g, n, dkf_plan(n, u.shape[0]))
    wrapper.launches += 1
    return out


def launch_dkf(u, g, n, plan):
    """Check the arguments of kernel 5 (u and g float32) or 5f (bf16) and
    launch it on ``plan``'s route (uncounted; the wrappers count)."""
    B, H, L = u.shape
    _check_fft_size(n, L)
    dtype = torch.bfloat16 if u.dtype == torch.bfloat16 else torch.float32
    for t in (u, g):
        cuda_lib.check(t, (B, H, L), dtype)
    out = torch.empty((H, n // 2 + 1), dtype=torch.complex64,
                      device=u.device)
    entry = ("dwst_fftconv_dkf_bf16" if dtype == torch.bfloat16
             else "dwst_fftconv_dkf")
    cuda_lib.launch(entry, u.data_ptr(), g.data_ptr(), out.data_ptr(), B, H,
                    L, n, plan.rows, plan.threads, plan.smem)
    return out


class _FFTConvTrain(torch.autograd.Function):
    """y = fftconv(u, khat); du = fftconv(g, khat, conj) (kernel 1),
    dkhat = fftconv_dkf(u, g) (kernel 5); for bf16 u (and so bf16 g) the
    wrappers take kernels 1f and 5f.  Saves u and khat."""

    @staticmethod
    def forward(ctx, u, khat):
        ctx.save_for_backward(u, khat)
        return fftconv(u, khat)

    @staticmethod
    def backward(ctx, g):
        u, khat = ctx.saved_tensors
        g = g.contiguous()
        du = dk = None
        if ctx.needs_input_grad[0]:
            du = fftconv(g, khat, conj=True)
        if ctx.needs_input_grad[1]:
            dk = fftconv_dkf(u, g, _fft_size_of(khat))
        return du, dk


def fftconv_train(u, khat):
    """Differentiable S4 conv of the training path (JAX ``fftconv2`` and
    its custom VJP), routed by the FFT size: kernels 1 and 5 (1f and 5f
    for bf16 u) up to :data:`KERNEL1_MAX_N`, past it kernel 9's training
    entries and kernel 5L (:func:`.fftconv_long.fftconv_long_train`); on
    the CPU their plain versions."""
    if _fft_size_of(khat) > KERNEL1_MAX_N:
        from .fftconv_long import fftconv_long_train
        return fftconv_long_train(u, khat)
    return _FFTConvTrain.apply(u.contiguous(), khat.contiguous())
