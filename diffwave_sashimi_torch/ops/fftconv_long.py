"""Long S4 FFT convolution (kernel 9): FFT sizes past kernel 1's.

Port of ``diffwave_sashimi_tpu/ops/fftconv_pallas.py::fftconv_fused`` (the
four-step DFT conv, TPU kernels ``_kernel`` and ``_kernel_batched``), CUDA
source ``csrc/fftconv_long.cu``.  Kernel 1 (:mod:`.fftconv`) holds a whole
row in one block's shared memory, which caps it at n = 32768; the vocoder
convolves at up to n = 2^18 (the generation length plus the S4 kernel
capped at the trained length), so :func:`sampling_spectrum` puts the
spectrum of every n above kernel 1's cap into this kernel's layout once per
run, and the sampling conv :func:`s4_conv` routes by that layout:

- ``(H, n/2+1)`` half spectrum, n <= 32768: kernel 1;
- ``(H, N1, N2)`` factorized spectrum, 32768 < n <= 2^20: kernel 9.

The factorized spectrum is the JAX kernel's (k1, k2) order, Hermitian
completed: ``kp[h, k1, k2] = K[h, k1 + N1 k2]`` over the full n-point DFT
K of the real combined kernel, with the DC and Nyquist bins real (the
parts ``irfft`` reads).  Entries:

- :func:`fftconv_long`: ``y = irfft(rfft(u, n) K, n)[:L]``, the TPU
  kernel's contract, or with ``conj=True`` the same with ``conj(K)``: the
  training conv past kernel 1's FFT sizes and its input gradient;
- :func:`fftconv_long_ln_bias_gelu_d`: the sampling form with kernel 1's
  norm1/bias prologue and D-skip + GELU epilogue; for bf16 activations its
  bf16 form, kernel 9f (:func:`fftconv_long_ln_bias_gelu_d_bf16`).

Each launches its CUDA kernel for CUDA tensors and runs its plain version
(``*_ref``: the half spectrum back out of the layout, then torch.fft) for
CPU tensors.  On the card the f32 forms take three passes through a
device-memory scratch at every n; kernel 9f's FFT size alone picks its
route (:func:`long_plan`): at n 2^16 and 2^17 a thread-block cluster that
holds one transform row in its blocks' shared memory, at every other n
the three passes.

The training route past kernel 1's FFT sizes, :func:`fftconv_long_train`
(JAX ``fftconv2``'s custom VJP on its compact layout, which the JAX
package takes there: ``fftconv2.py:671-704`` and ``:798-840``), is an
autograd Function: the conv by :func:`fftconv_long`, its input gradient
by the same with ``conj=True`` (the conv's adjoint, as the output is as
long as the input), and the spectrum gradient by kernel 5L
(:func:`fftconv_dkf_long`, the TPU kernel ``fftconv2.py::_dkf_kernel``'s
function at 2^16 <= n <= 2^20, CUDA source ``csrc/fftconv_long.cu``).
Both take bf16 activations as they are: kernel 9's training entry has a
bf16 form (bf16 in and out, the chain f32, y rounded once: the f32 entry's
result on the widened input, narrowed), and kernel 5L reads bf16.  Kernel
5L's FFT size alone picks its route (:func:`dkf_long_plan`): at n 2^16
and 2^17 a thread-block cluster of 8 blocks a channel that holds its
transforms in its blocks' shared memory, one launch and no scratch; at
every other n two passes through a device-memory scratch.

Kernel 9f computes what the JAX package computes around kernel 9 at bf16
(its v1 path, ``models/s4.py:705-712``, and its flat path, which computes
the same function): the bf16 conv input ``u' = a u + c + bias`` rounded to
bf16, the f32 conv of it, ``v = y + D u'`` in f32 rounded to bf16, and the
exact GELU of that, stored as bf16.  The TPU kernel's ``fast`` flag changes
only its MXU precision, and off the TPU its fast form is its strict one.
Kernel 1f's sampling form rounds neither u' nor v and takes ``gelu_fast``
(the compact path's function), so the two differ there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import cuda_lib
from .fftconv import (KERNEL1_MAX_N, fftconv_dkf_ref, fftconv_ln_bias_gelu_d,
                      fftconv_ln_bias_gelu_d_ref, fftconv_ref)

MAX_N = 1 << 20           # kernel 9's largest (N1, N2 <= 1024), and 5L's
DKF_LONG_MIN_N = 1 << 16  # kernel 5L's smallest: kernel 5 takes the rest
# kernel 9f's cluster route: the complex values a block holds (1024
# threads x 16, csrc/fftconv_long.cu::CLUSTER_VALUES); the FFT sizes the
# kernel has instances for, C = n / CLUSTER_VALUES blocks a cluster (16 is
# past the portable cluster size of 8, which the H100 allows); and those
# :func:`long_plan` routes to it, where it beats the three passes on the
# H100 (PERF.md, Findings PR 13; at n 2^18 the three passes win)
CLUSTER_VALUES = 16384
CLUSTER_SIZES = (1 << 16, 1 << 17, 1 << 18)
CLUSTER_NS = (1 << 16, 1 << 17)
# 8-byte slots of a block's stash, 9f's conv input u' as a bf16 pair a
# value (csrc/fftconv_long.cu::STASH_SLOTS)
CLUSTER_STASH = CLUSTER_VALUES // 2


def split(n: int):
    """n = N1 N2 with N1 = 2^floor(l/2), N2 = 2^ceil(l/2) for n = 2^l (the
    JAX package's mxu_fft._split_size for powers of two)."""
    l = n.bit_length() - 1
    return 1 << (l // 2), 1 << (l - l // 2)


class LongPlan(NamedTuple):
    """How kernel 9f runs at one FFT size: the route (``"cluster"`` or
    ``"three_pass"``), and on the cluster route the blocks a cluster, the
    columns n2 and rows k1 a block takes, and its shared-memory bytes (0
    each on the three-pass route, which sizes its own passes)."""
    route: str
    cluster: int
    cols: int
    rows: int
    smem: int


THREE_PASS = LongPlan("three_pass", 0, 0, 0, 0)


def cluster_plan(n: int, C: int = 0) -> LongPlan:
    """The cluster route's partition of an n-point transform over C blocks
    (by default n / 16384: 4, 8, 16 at :data:`CLUSTER_SIZES`, each block
    16384 complex values): block j takes columns [j N2/C, (j+1) N2/C)
    (every n1) in the column phases and rows [j N1/C, (j+1) N1/C) (every
    k2) in the row phase, holding its stash and the larger of the two in
    shared memory, N + 1 slots an N-point transform
    (csrc/fft_stockham.cuh::Swz)."""
    N1, N2 = split(n)
    C = C or n // CLUSTER_VALUES
    cols, rows = N2 // C, N1 // C
    return LongPlan("cluster", C, cols, rows,
                    8 * (CLUSTER_STASH
                         + max(cols * (N1 + 1), rows * (N2 + 1))))


def long_plan(n: int) -> LongPlan:
    """Kernel 9f's route at FFT size n, by n alone: the cluster route for
    n in :data:`CLUSTER_NS`, the three-pass route for every other n.  The
    kernel takes the plan as given: this is the one place it is
    computed."""
    return cluster_plan(n) if n in CLUSTER_NS else THREE_PASS


def max_active_clusters(n: int) -> int:
    """How many clusters of the cluster route at FFT size n (of
    :data:`CLUSTER_SIZES`) the card holds at once
    (``cudaOccupancyMaxActiveClusters``); raises on a CUDA error."""
    got = cuda_lib.library().dwst_fftconv_long_max_clusters(
        n, cluster_plan(n).smem)
    if got < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters at n {n}: CUDA "
                           f"error {-got}")
    return got


class DkfLongPlan(NamedTuple):
    """How kernel 5L runs at one FFT size: the route (``"cluster"`` or
    ``"two_pass"``) and the blocks a cluster (0 on the two-pass route).
    The cluster kernel's instance at n sizes its blocks and their shared
    memory (csrc/fftconv_long.cu::dkf_cluster_instance)."""
    route: str
    cluster: int


DKF_TWO_PASS = DkfLongPlan("two_pass", 0)
# kernel 5L's cluster route (csrc/fftconv_long.cu::dkf_cluster_kernel):
# the FFT sizes it has instances for, each in clusters of 8 blocks (the
# portable size; csrc DKF_CLUSTER): 8192 complex values a block, two
# blocks an SM, at n 2^16, and 16384, one an SM, at 2^17.  Blocks of 16384
# values at 2^16 and of 8192 at 2^17 were slower in turns on the H100
# (PERF.md, Findings)
DKF_CLUSTER_NS = (1 << 16, 1 << 17)
DKF_CLUSTER = DkfLongPlan("cluster", 8)


def dkf_long_plan(n: int) -> DkfLongPlan:
    """Kernel 5L's route at FFT size n, by n alone: the cluster route for
    n in :data:`DKF_CLUSTER_NS`, the two passes for every other n up to
    :data:`MAX_N` (past 2^17 a cluster of the portable size cannot hold a
    channel's transforms).  This is the one place it is chosen."""
    return DKF_CLUSTER if n in DKF_CLUSTER_NS else DKF_TWO_PASS


def max_active_dkf_clusters(n: int) -> int:
    """How many clusters of kernel 5L's cluster route at FFT size n (of
    :data:`DKF_CLUSTER_NS`) the card holds at once
    (``cudaOccupancyMaxActiveClusters``); raises on a CUDA error."""
    got = cuda_lib.library().dwst_fftconv_dkf_long_max_clusters(n)
    if got < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters of kernel 5L at "
                           f"n {n}: CUDA error {-got}")
    return got


def long_spectrum(khat: torch.Tensor) -> torch.Tensor:
    """(H, n/2+1) half spectrum -> (H, N1, N2) complex64 factorized
    Hermitian-completed spectrum ``kp[h, k1, k2] = K[h, k1 + N1 k2]``."""
    H, half = khat.shape
    n = 2 * (half - 1)
    N1, N2 = split(n)
    full = torch.cat([khat, khat[:, 1:-1].flip(-1).conj()], dim=-1)
    full[:, 0] = khat[:, 0].real                   # irfft reads only the
    full[:, n // 2] = khat[:, -1].real             # real parts of these
    return full.reshape(H, N2, N1).transpose(1, 2).contiguous()


def half_spectrum(kp: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`long_spectrum`: (H, N1, N2) -> (H, n/2+1)."""
    H, N1, N2 = kp.shape
    n = N1 * N2
    return kp.transpose(1, 2).reshape(H, n)[:, :n // 2 + 1]


def sampling_spectrum(khat: torch.Tensor, L: int = 0) -> torch.Tensor:
    """The sampling conv's spectrum in the layout of the kernel that takes
    its FFT size: kernel 1's half spectrum as it is up to
    :data:`KERNEL1_MAX_N`, kernel 9's factorized one up to :data:`MAX_N`.
    Built once per run, outside the T-step loop (``L``, the valid length,
    is for the int8 form's :func:`.int8conv.int8_spectrum`)."""
    n = 2 * (khat.shape[-1] - 1)
    if n <= KERNEL1_MAX_N:
        return khat
    if n > MAX_N:
        raise ValueError(f"FFT size {n} is past the long conv's {MAX_N}: "
                         f"generation length too long for one pass")
    return long_spectrum(khat)


def fftconv_long_ref(u, kp, conj=False):
    """Plain version of :func:`fftconv_long`."""
    return fftconv_ref(u, half_spectrum(kp), conj)


def fftconv_long_ln_bias_gelu_d_ref(u, a, c, bias, kp, D):
    """Plain version of :func:`fftconv_long_ln_bias_gelu_d` (kernel 9f's,
    :func:`fftconv_long_ln_bias_gelu_d_bf16_ref`, for bf16 u)."""
    if u.dtype == torch.bfloat16:
        return fftconv_long_ln_bias_gelu_d_bf16_ref(u, a, c, bias, kp, D)
    return fftconv_ln_bias_gelu_d_ref(u, a, c, bias, half_spectrum(kp), D)


def fftconv_long_ln_bias_gelu_d_bf16_ref(u, a, c, bias, kp, D):
    """Plain version of kernel 9f: u (B, H, L) bf16, the rest as kernel
    9's; u' = a u + c + bias rounded to bf16, the conv in f32, v = y + D u'
    rounded to bf16, the exact GELU of it in f32, the result bf16."""
    L, n = u.shape[-1], kp.shape[1] * kp.shape[2]
    xn = (u.float() * a[:, None, :] + c[:, None, :]
          + bias[:, :, None]).to(torch.bfloat16).float()
    y = torch.fft.irfft(torch.fft.rfft(xn, n=n) * half_spectrum(kp),
                        n=n)[..., :L]
    v = (y + D[:, None] * xn).to(torch.bfloat16)
    return F.gelu(v.float()).to(torch.bfloat16)


def _check(u, kp, dtype=torch.float32):
    """(B, H, L, n) of a launch with u of ``dtype``; raise on what the
    kernel does not take."""
    B, H, L = u.shape
    N1, N2 = kp.shape[1:]
    n = N1 * N2
    if n & (n - 1) or n < 256 or n > MAX_N or L > n or (N1, N2) != split(n):
        raise ValueError(f"long conv: spectrum {tuple(kp.shape)} is no "
                         f"power-of-two split of 256 <= n <= {MAX_N} "
                         f">= L = {L}")
    cuda_lib.check(u, (B, H, L), dtype)
    cuda_lib.check(kp, (H, N1, N2), torch.complex64)
    return B, H, L, n


def _scratch(B, H, n, device, plan):
    """The three-pass route's scratch, one complex n-row per (pair of batch
    rows, channel); the cluster route takes none (a null pointer)."""
    if plan.route == "cluster":
        return None
    return torch.empty(((B + 1) // 2 * H, n), dtype=torch.complex64,
                       device=device)


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def fftconv_long(u, kp, conj=False):
    """Kernel-9 wrapper, the TPU kernel's contract (u f32 or bf16, y of
    its dtype; ``conj``: with conj(K)), the training conv and its input
    gradient: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if not u.is_cuda:
        return fftconv_long_ref(u, kp, conj)
    out = launch_long(u, kp, conj)
    fftconv_long.launches += 1
    return out


fftconv_long.launches = 0


def launch_long(u, kp, conj=False):
    """Check the arguments of kernel 9's training entry and launch it
    (uncounted; the wrapper counts): its bf16 form for bf16 u, the f32
    one for f32 u, on the three passes."""
    bf16 = u.dtype == torch.bfloat16
    B, H, L, n = _check(u, kp, torch.bfloat16 if bf16 else torch.float32)
    out, scratch = torch.empty_like(u), _scratch(B, H, n, u.device,
                                                 THREE_PASS)
    cuda_lib.launch("dwst_fftconv_long_bf16" if bf16 else "dwst_fftconv_long",
                    u.data_ptr(), kp.data_ptr(), scratch.data_ptr(),
                    out.data_ptr(), B, H, L, n, int(conj))
    return out


def fftconv_dkf_long(u, g, n):
    """Kernel-5L wrapper: :func:`.fftconv.fftconv_dkf_ref` (u, g (B, H, L)
    f32 or bf16 -> (H, n/2+1) complex64, the batch summed in the kernel)
    as a CUDA kernel for CUDA tensors at 2^16 <= n <= 2^20, the plain
    version for CPU tensors."""
    if not u.is_cuda:
        return fftconv_dkf_ref(u, g, n)
    out = launch_dkf_long(u, g, n)
    fftconv_dkf_long.launches += 1
    return out


fftconv_dkf_long.launches = 0


def launch_dkf_long(u, g, n, plan=None):
    """Check kernel 5L's arguments and launch it (uncounted; the wrapper
    counts): u and g of one dtype, f32 or bf16, on ``plan``'s route (by
    default :func:`dkf_long_plan`'s); the two-pass route with a scratch
    of one complex n-row per (b, h), the cluster route with none."""
    B, H, L = u.shape
    if n & (n - 1) or not DKF_LONG_MIN_N <= n <= MAX_N or L > n:
        raise ValueError(f"kernel 5L: FFT size {n} is no power of two in "
                         f"[{DKF_LONG_MIN_N}, {MAX_N}] >= L = {L}")
    plan = plan or dkf_long_plan(n)
    bf16 = u.dtype == torch.bfloat16
    for t in (u, g):
        cuda_lib.check(t, (B, H, L), torch.bfloat16 if bf16
                       else torch.float32)
    out = torch.empty((H, n // 2 + 1), dtype=torch.complex64,
                      device=u.device)
    scratch = None if plan.route == "cluster" else torch.empty(
        (B * H, n), dtype=torch.complex64, device=u.device)
    cuda_lib.launch("dwst_fftconv_dkf_long_bf16" if bf16
                    else "dwst_fftconv_dkf_long", u.data_ptr(), g.data_ptr(),
                    _ptr(scratch), out.data_ptr(), B, H, L, n, plan.cluster)
    return out


class _FFTConvLongTrain(torch.autograd.Function):
    """y = fftconv_long(u, kp); du = fftconv_long(g, kp, conj=True)
    (kernel 9's training entry, at u's and g's dtype), dkhat =
    fftconv_dkf_long(u, g) (kernel 5L), with kp the factorized spectrum
    of khat (H, n/2+1).  Saves u and kp."""

    @staticmethod
    def forward(ctx, u, khat):
        kp = long_spectrum(khat)
        ctx.save_for_backward(u, kp)
        return fftconv_long(u, kp)

    @staticmethod
    def backward(ctx, g):
        u, kp = ctx.saved_tensors
        g = g.contiguous()
        du = dk = None
        if ctx.needs_input_grad[0]:
            du = fftconv_long(g, kp, conj=True)
        if ctx.needs_input_grad[1]:
            dk = fftconv_dkf_long(u, g, kp.shape[1] * kp.shape[2])
        return du, dk


def fftconv_long_train(u, khat):
    """The training conv past kernel 1's FFT sizes (u (B, H, L) f32 or
    bf16, khat (H, n/2+1) complex64): kernel 9's training entries and
    kernel 5L on the card up to MAX_N (past it they raise ValueError),
    their plain versions on the CPU at any n."""
    return _FFTConvLongTrain.apply(u.contiguous(), khat.contiguous())


def fftconv_long_ln_bias_gelu_d(u, a, c, bias, kp, D):
    """Kernel-9 wrapper, sampling form (arguments as kernel 1's, with the
    factorized spectrum); bf16 activations go to kernel 9f."""
    if not u.is_cuda:
        return fftconv_long_ln_bias_gelu_d_ref(u, a, c, bias, kp, D)
    if u.dtype == torch.bfloat16:
        return fftconv_long_ln_bias_gelu_d_bf16(u, a, c, bias, kp, D)
    out = launch_sampling(u, a, c, bias, kp, D)
    fftconv_long_ln_bias_gelu_d.launches += 1
    return out


fftconv_long_ln_bias_gelu_d.launches = 0


def fftconv_long_ln_bias_gelu_d_bf16(u, a, c, bias, kp, D):
    """Kernel-9f wrapper (u bf16, the rest as kernel 9's): the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if not u.is_cuda:
        return fftconv_long_ln_bias_gelu_d_bf16_ref(u, a, c, bias, kp, D)
    out = launch_sampling(u, a, c, bias, kp, D)
    fftconv_long_ln_bias_gelu_d_bf16.launches += 1
    return out


fftconv_long_ln_bias_gelu_d_bf16.launches = 0


def launch_sampling(u, a, c, bias, kp, D, plan=None):
    """Check the arguments of kernel 9's sampling form (9f's for bf16 u;
    the rest f32) and launch it: 9f on ``plan``'s route (by default
    :func:`long_plan`'s), the f32 form on the three passes; uncounted (the
    wrappers count their launches)."""
    bf16 = u.dtype == torch.bfloat16
    B, H, L, n = _check(u, kp, torch.bfloat16 if bf16 else torch.float32)
    plan = (plan or long_plan(n)) if bf16 else THREE_PASS
    for t, shape in ((a, (B, L)), (c, (B, L)), (bias, (B, H)), (D, (H,))):
        cuda_lib.check(t, shape, torch.float32)
    out, scratch = torch.empty_like(u), _scratch(B, H, n, u.device, plan)
    args = (u.data_ptr(), a.data_ptr(), c.data_ptr(), bias.data_ptr(),
            kp.data_ptr(), D.data_ptr(), _ptr(scratch), out.data_ptr(), B,
            H, L, n)
    if bf16:
        cuda_lib.launch("dwst_fftconv_long_ln_bias_gelu_d_bf16", *args,
                        *plan[1:])
    else:
        cuda_lib.launch("dwst_fftconv_long_ln_bias_gelu_d", *args)
    return out


def s4_conv(u, a, c, bias, khat, D):
    """The sampling form's conv, routed by the spectrum's layout (see
    :func:`sampling_spectrum`) and the activations' dtype: kernel 9 (9f for
    bf16) for a factorized spectrum, kernel 1 (1f for bf16) for a half
    spectrum."""
    if khat.dim() == 3:
        return fftconv_long_ln_bias_gelu_d(u, a, c, bias, khat, D)
    return fftconv_ln_bias_gelu_d(u, a, c, bias, khat, D)


def s4_conv_ref(u, a, c, bias, khat, D):
    """Plain version of :func:`s4_conv`."""
    if khat.dim() == 3:
        return fftconv_long_ln_bias_gelu_d_ref(u, a, c, bias, khat, D)
    return fftconv_ln_bias_gelu_d_ref(u, a, c, bias, khat, D)
