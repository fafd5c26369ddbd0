"""Symmetric Cauchy sum: the S4 (NPLR) resolvent evaluation (kernel 4)
and its closed-form backward (kernel 8).

    r[..., l] = sum_n v_n / (z_l - w_n) + conj(v_n) / (z_l - conj(w_n))

Port of ``diffwave_sashimi_tpu/ops/cauchy.py::cauchy_sym`` (plain version,
conjugate pairs included -- the reference's vendored ``cauchy_naive`` drops
them) and of ``ops/cauchy_pallas.py::cauchy_sym_pallas`` with its custom
VJP ``_cauchy_quad`` (the kernels, CUDA source ``csrc/cauchy.cu``).  Both
use the all-real form of each conjugate pair, (a z + b) / (z^2 + c z + d)
with a = 2 Re v, b = -2 Re(v conj w), c = -2 Re w, d = |w|^2.  The
autograd Function takes and returns real tensors only (a, b, c, d -> one
float32 (K, M, Lz, 2) tensor of (re, im) pairs, the memory of a complex64
(K, M, Lz) tensor); the coefficients and ``torch.view_as_complex`` stay
outside it in torch autograd, so torch's complex-gradient conventions
never reach the kernels, and the S4 kernel construction reads kernel 4's
output with no copy.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from . import cuda_lib


def _coefficients(v, w):
    a = 2.0 * v.real
    b = -2.0 * (v.real * w.real + v.imag * w.imag)
    return a, b, -2.0 * w.real, w.real ** 2 + w.imag ** 2


def quad_operands(v, w):
    """The real operands (a, b, c, d) of kernels 4 and 8 for residues v
    (..., H, N) and poles w (H, N): a and b as (K, H, N), c and d (H, N)."""
    H, N = v.shape[-2:]
    a, b, c, d = _coefficients(v, w)
    K = a.numel() // (H * N)
    return a.reshape(K, H, N), b.reshape(K, H, N), c, d


def _quad_complex(a, b, c, d, z):
    """:func:`cauchy_quad_ref`'s sum as one complex (K, M, Lz) tensor."""
    g0 = 1.0 / (z * z + c[..., None] * z + d[..., None])    # (M, N, Lz)
    g1 = z * g0
    return (torch.einsum("kmn,mnl->kml", a.to(g1.dtype), g1)
            + torch.einsum("kmn,mnl->kml", b.to(g0.dtype), g0))


def cauchy_quad_ref(a, b, c, d, z):
    """out[k, m, l] = sum_n (a[k,m,n] z_l + b[k,m,n]) / (z_l^2 + c[m,n] z_l
    + d[m,n]) as (out_re, out_im), each (K, M, Lz) real."""
    out = _quad_complex(a, b, c, d, z)
    return out.real, out.imag


def cauchy_sym(v, z, w):
    """Plain version.  v: (..., H, N) complex64; z: (Lz,) complex64;
    w: (H, N) complex64.  Returns (..., H, Lz) complex64."""
    out_re, out_im = cauchy_quad_ref(*quad_operands(v, w), z)
    return torch.complex(out_re, out_im).reshape(*v.shape[:-1], z.shape[0])


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


# Kernel 4's launch shape (csrc/cauchy.cu, the FWD_ constants): the most
# threads a block, the positions a thread, the most components, and the
# shared memory a block may use (past 48 KB by opting in).
FWD_THREADS, FWD_P, FWD_KMAX, FWD_SMEM_MAX = 128, 4, 8, 232448


class FwdPlan(NamedTuple):
    threads: int   # threads a block, a multiple of 32; FWD_P positions each
    splits: int    # blocks a channel
    smem: int      # bytes of shared memory a block: the channel's records


def _fwd_smem(K, N):
    """Bytes of N records [c, d, a_0.., b_0..], each padded to float4s."""
    return N * ((2 * K + 2 + 3) // 4) * 16


def cauchy_fwd_refusal(K, N):
    """Why kernel 4 takes no (K, N), or None."""
    if not 1 <= K <= FWD_KMAX:
        return (f"kernel 4 (cauchy) has instances for K 1-{FWD_KMAX} "
                f"components, not K {K}")
    nmax = FWD_SMEM_MAX // _fwd_smem(K, 1)
    if not 1 <= N <= nmax:
        return (f"kernel 4 (cauchy) stages a channel's N states in one "
                f"block's shared memory, N 1-{nmax} at K {K}, not N {N}")
    return None


@functools.lru_cache(maxsize=None)
def cauchy_fwd_plan(K, M, N, Lz, sms):
    """Kernel 4's launch at (K, M, N, Lz) on a card of ``sms`` SMs, the one
    place that sizes it: each of the M channels splits its Lz positions
    into ``splits`` blocks of ``threads`` threads, FWD_P positions a
    thread.  A block has FWD_THREADS threads unless the grid would then
    give an SM fewer than two blocks: then more, smaller blocks (down to
    one warp), as far as the positions allow.  Shared memory: the
    channel's N records.  Raises ValueError on a (K, N) no instance
    takes."""
    why = cauchy_fwd_refusal(K, N)
    if why:
        raise ValueError(why)
    splits = math.ceil(Lz / (FWD_THREADS * FWD_P))
    if M * splits < 2 * sms:
        splits = min(math.ceil(2 * sms / M), math.ceil(Lz / (32 * FWD_P)))
    threads = 32 * math.ceil(math.ceil(Lz / splits) / (32 * FWD_P))
    return FwdPlan(threads, math.ceil(Lz / (threads * FWD_P)),
                   _fwd_smem(K, N))


def cauchy_quad(a, b, c, d, z):
    """Kernel-4 wrapper: :func:`cauchy_quad_ref`'s sum as one float32
    (K, M, Lz, 2) tensor of (re, im) pairs, by the CUDA kernel for CUDA
    tensors (``cauchy_fwd_plan``'s launch), by the plain version for CPU
    tensors (``torch.view_as_real`` of its complex sum)."""
    if not a.is_cuda:
        return torch.view_as_real(_quad_complex(a, b, c, d, z))
    K, M, N = a.shape
    Lz = z.shape[0]
    plan = cauchy_fwd_plan(K, M, N, Lz, cuda_lib.sm_count(a.device))
    a, b, c, d, z = _contiguous(a, b, c, d, z)
    for t, shape in ((a, (K, M, N)), (b, (K, M, N)), (c, (M, N)),
                     (d, (M, N))):
        cuda_lib.check(t, shape, torch.float32)
    cuda_lib.check(z, (Lz,), torch.complex64)
    out = torch.empty((K, M, Lz, 2), dtype=torch.float32, device=a.device)
    cuda_lib.launch("dwst_cauchy", a.data_ptr(), b.data_ptr(), c.data_ptr(),
                    d.data_ptr(), z.data_ptr(), out.data_ptr(), K, M, N, Lz,
                    *plan)
    cauchy_quad.launches += 1
    return out


cauchy_quad.launches = 0


# Kernel 8's launch shape (csrc/cauchy.cu, the BWD_ constants): threads a
# block (8 warps), positions a warp stages at a time, the blocks an SM
# holds up to K 6 (its __launch_bounds__; one less past K 6, where 64
# registers a thread would spill), the most components and the most states
# (one warp's lanes), and the longest chain of positions a thread sums.
BWD_THREADS, BWD_CHUNK, BWD_BLOCKS_PER_SM = 256, 16, 4
BWD_KMAX, BWD_NMAX, BWD_CHAIN = 8, 32, 64


class BwdPlan(NamedTuple):
    span: int      # positions a block, whole chunks for each warp
    splits: int    # blocks a channel; past 1, a reduce pass sums them
    smem: int      # bytes of shared memory a block


def cauchy_bwd_refusal(K, N):
    """Why kernel 8 takes no (K, N), or None."""
    if not 1 <= K <= BWD_KMAX:
        return (f"kernel 8 (cauchy_bwd) has instances for K 1-{BWD_KMAX} "
                f"components, not K {K}")
    if not 1 <= N <= BWD_NMAX:
        return (f"kernel 8 (cauchy_bwd) holds N 1-{BWD_NMAX} states, one a "
                f"lane of a warp, not N {N}")
    return None


@functools.lru_cache(maxsize=None)
def cauchy_bwd_plan(K, M, N, Lz, sms):
    """Kernel 8's launch at (K, M, N, Lz) on a card of ``sms`` SMs, the one
    place that sizes it: each of the M channels splits its Lz positions
    into ``splits`` blocks of ``span``, a whole number of chunks of
    BWD_CHUNK for each of a block's 8 warps.  A span is at most BWD_CHAIN
    positions a warp, so a thread's serial chain stays short; it shrinks
    further only where the grid would give an SM fewer than two blocks:
    each block pays its coefficients' and first chunk's latency and its
    warps' sum (``cauchy_bwd_parts.py`` times half the span).  Shared
    memory: each warp's two stages (a chunk's z and z^2 in one float4 a
    position, then g's K values in float4s), or the warps' 2K + 2 sums of
    32 lanes, whichever is larger.  Raises ValueError on a (K, N) no
    instance takes."""
    why = cauchy_bwd_refusal(K, N)
    if why:
        raise ValueError(why)
    warps = BWD_THREADS // 32
    unit = warps * BWD_CHUNK
    splits = max(math.ceil(Lz / (BWD_CHAIN * warps)), math.ceil(2 * sms / M))
    span = unit * math.ceil(math.ceil(Lz / splits) / unit)
    stages = warps * 2 * BWD_CHUNK * (1 + (K + 1) // 2) * 16
    return BwdPlan(span, math.ceil(Lz / span),
                   max(stages, warps * (2 * K + 2) * 32 * 4))


def _g_layout(g_re, g_im):
    """(g_re, g_im, element stride) for the kernel: the real and imaginary
    views of one complex (K, M, Lz) tensor as they lie (stride 2; each
    pair 8-byte aligned, as a complex64 tensor's are), two contiguous
    planes as they are (stride 1), anything else copied into planes."""
    K, M, Lz = g_re.shape
    for gs in (2, 1):
        want = (M * Lz * gs, Lz * gs, gs)
        if g_re.stride() == want and g_im.stride() == want and (
                gs == 1 or (g_im.data_ptr() == g_re.data_ptr() + 4
                            and g_re.data_ptr() % 8 == 0)):
            return g_re, g_im, gs
    return g_re.contiguous(), g_im.contiguous(), 1


def cauchy_bwd(a, b, c, d, z, g_re, g_im):
    """Kernel-8 wrapper: :func:`cauchy_bwd_ref` as the CUDA kernel for
    CUDA tensors (``cauchy_bwd_plan``'s launch; g read where it lies), the
    plain version for CPU tensors.  Returns (da, db, dc, dd), views of one
    (2K + 2, M, N) buffer."""
    if not a.is_cuda:
        return cauchy_bwd_ref(a, b, c, d, z, g_re, g_im)
    K, M, N = a.shape
    Lz = z.shape[0]
    why = cauchy_bwd_refusal(K, N)
    if why:
        raise ValueError(why)
    a, b, c, d, z = _contiguous(a, b, c, d, z)
    for t, shape in ((a, (K, M, N)), (b, (K, M, N)), (c, (M, N)),
                     (d, (M, N))):
        cuda_lib.check(t, shape, torch.float32)
    cuda_lib.check(z, (Lz,), torch.complex64)
    for g in (g_re, g_im):
        if tuple(g.shape) != (K, M, Lz) or not g.is_cuda \
                or g.dtype != torch.float32:
            raise ValueError(f"kernel 8's cotangents must be CUDA float32 "
                             f"tensors of shape {(K, M, Lz)}, got {g.dtype} "
                             f"{tuple(g.shape)} on {g.device}")
    g_re, g_im, gs = _g_layout(g_re, g_im)
    plan = cauchy_bwd_plan(K, M, N, Lz, cuda_lib.sm_count(a.device))
    out = torch.empty((2 * K + 2, M, N), dtype=torch.float32,
                      device=a.device)
    part = (torch.empty((plan.splits, 2 * K + 2, M, N), dtype=torch.float32,
                        device=a.device) if plan.splits > 1 else out)
    cuda_lib.launch("dwst_cauchy_bwd", a.data_ptr(), b.data_ptr(),
                    c.data_ptr(), d.data_ptr(), z.data_ptr(),
                    g_re.data_ptr(), g_im.data_ptr(), gs, out.data_ptr(),
                    part.data_ptr(), K, M, N, Lz, *plan)
    cauchy_bwd.launches += 1
    return out[:K], out[K:2 * K], out[2 * K], out[2 * K + 1]


cauchy_bwd.launches = 0


class _CauchyQuad(torch.autograd.Function):
    """Forward kernel 4, backward kernel 8 (JAX ``_cauchy_quad``), on real
    tensors only; z is a constant.  The forward returns kernel 4's
    (K, M, Lz, 2) output as it is; the backward hands kernel 8 its
    cotangent's real and imaginary parts where they lie."""

    @staticmethod
    def forward(ctx, a, b, c, d, z):
        ctx.save_for_backward(a, b, c, d, z)
        return cauchy_quad(a, b, c, d, z)

    @staticmethod
    def backward(ctx, g):
        a, b, c, d, z = ctx.saved_tensors
        return (*cauchy_bwd(a, b, c, d, z, g[..., 0], g[..., 1]), None)


def cauchy_sym_fused(v, z, w):
    """Same arguments and result as :func:`cauchy_sym`, through kernels 4
    and 8 (the plain versions for CPU tensors); differentiable in v and w
    through the coefficient construction.  The result is a view of kernel
    4's output."""
    out = _CauchyQuad.apply(*quad_operands(v, w), z)
    return torch.view_as_complex(out).reshape(*v.shape[:-1], z.shape[0])
