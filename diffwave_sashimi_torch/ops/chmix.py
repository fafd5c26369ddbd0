"""Fused position-wise channel-mixing branches of the DiffWave block:
kernels 2 and 3 (forward) and 6 and 7 (their backward passes).

Ports of ``diffwave_sashimi_tpu/ops/chmix.py`` in the flat (B, H, L)
layout (channel axis 1): ``mix_glu_res`` and ``ln_ff_res`` (sampling),
and the training Functions ``mix_glu_res_train`` / ``ln_ff_res_train``
whose backward passes are ``_glu_bwd_kernel`` / ``_ff_bwd_kernel``.  The
CUDA kernels are ``csrc/chmix.cu``; the ``*_ref`` functions are their
plain PyTorch versions (explicit formulas, not autograd), used for CPU
tensors and as the on-card comparison.

bf16 activations take the ``fast=True`` forms, kernels 2f and 3f
(:func:`mix_glu_res_bf16`, :func:`ln_ff_res_bf16`) and their backward
passes 6f and 7f (:func:`glu_res_bwd_bf16`, :func:`ln_ff_res_bwd_bf16`),
by the tensors' dtype.  Forward: the weights, and FF's normalised input
and GELU output, are rounded to bf16 before their products, which
accumulate in f32; bias, sigmoid, LN statistics, the polynomial GELU and
the residual adds are f32, and the output is rounded to bf16 (its
statistics are the f32 output's); kernel 3f multiplies on the tensor
cores and takes channel widths that are multiples of 16.  Backward (JAX
``_bmm`` / ``_bmmc``): both operands of every per-position product (z = W
y, dy = W^T dz, z = W1 xn, dh = W2^T g, dxn = W1^T dz) are rounded to
bf16, the weight gradients contract the unrounded f32 dz, xn and GELU
output, the GELU's derivative is the polynomial's, dy and dx are rounded
to bf16 and the weight, bias, m and s gradients stay f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import cuda_lib
from .fftconv import as_operand, gelu_fast, gelu_fast_grad, widen

# positions per split-K partial of the weight gradients (kernels 6 and 7)
WGRAD_POSITIONS = 2048


def glu_res_ref(y, res, w, b):
    """res + GLU over channels of (w @ y + b).  y, res: (B, H, L), f32 or
    bf16 (kernel 2f's function); w: (2H, H); b: (2H,) f32."""
    z = (torch.einsum("bhl,oh->bol", widen(y), as_operand(w, y.dtype))
         + b[None, :, None])
    H = y.shape[1]
    return (widen(res) + z[:, :H] * torch.sigmoid(z[:, H:])).to(res.dtype)


def mix_glu_res(y, res, w, b):
    """Kernel-2 wrapper: CUDA kernel for CUDA tensors, else the plain
    version; bf16 activations go to kernel 2f."""
    if not y.is_cuda:
        return glu_res_ref(y, res, w, b)
    if y.dtype == torch.bfloat16:
        return mix_glu_res_bf16(y, res, w, b)
    B, H, L = y.shape
    _check_width(H)
    for t, shape in ((y, (B, H, L)), (res, (B, H, L)), (w, (2 * H, H)),
                     (b, (2 * H,))):
        cuda_lib.check(t, shape, torch.float32)
    out = torch.empty_like(res)
    cuda_lib.launch("dwst_glu_res", y.data_ptr(), res.data_ptr(),
                    w.data_ptr(), b.data_ptr(), out.data_ptr(), B, H, L)
    mix_glu_res.launches += 1
    return out


mix_glu_res.launches = 0


def mix_glu_res_bf16(y, res, w, b):
    """Kernel-2f wrapper (y, res bf16; w, b f32): CUDA kernel for CUDA
    tensors, else the plain version."""
    if not y.is_cuda:
        return glu_res_ref(y, res, w, b)
    B, H, L = y.shape
    _check_width(H)
    for t, shape in ((y, (B, H, L)), (res, (B, H, L))):
        cuda_lib.check(t, shape, torch.bfloat16)
    for t, shape in ((w, (2 * H, H)), (b, (2 * H,))):
        cuda_lib.check(t, shape, torch.float32)
    out = torch.empty_like(res)
    cuda_lib.launch("dwst_glu_res_bf16", y.data_ptr(), res.data_ptr(),
                    w.data_ptr(), b.data_ptr(), out.data_ptr(), B, H, L)
    mix_glu_res_bf16.launches += 1
    return out


mix_glu_res_bf16.launches = 0


def ln_ff_res_ref(x, m, s, w1, b1, w2, b2, skip=None, emit_stats=False):
    """x + w2 @ gelu(w1 @ TLN(x) + b1) + b2 [+ skip], TLN the scalar-affine
    channel LayerNorm (population std, no eps).  With ``emit_stats`` also
    returns the output's channel mean and E[x^2] - mean^2, each (B, L).

    x, skip: (B, H, L), f32 or bf16 (kernel 3f's function); w1: (F, H);
    b1: (F,); w2: (H, F); b2: (H,); m, s: (1,), all f32.  The statistics
    are f32, of the output before it is rounded to x's dtype."""
    dt = x.dtype
    x = widen(x)
    var, mean = torch.var_mean(x, dim=1, unbiased=False, keepdim=True)
    xn = as_operand((s / torch.sqrt(var)) * (x - mean + m), dt)
    z = (torch.einsum("bhl,fh->bfl", xn, as_operand(w1, dt))
         + b1[None, :, None])
    z = as_operand(gelu_fast(z), dt) if dt == torch.bfloat16 else F.gelu(z)
    out = (x + torch.einsum("bfl,hf->bhl", z, as_operand(w2, dt))
           + b2[None, :, None])
    if skip is not None:
        out = out + widen(skip)
    if not emit_stats:
        return out.to(dt)
    mo = out.mean(dim=1)
    return out.to(dt), mo, (out * out).mean(dim=1) - mo * mo


def ln_ff_res(x, m, s, w1, b1, w2, b2, skip=None, emit_stats=False):
    """Kernel-3 wrapper: CUDA kernel for CUDA tensors, else the plain
    version (same arguments and results); bf16 activations go to kernel
    3f."""
    if not x.is_cuda:
        return ln_ff_res_ref(x, m, s, w1, b1, w2, b2, skip, emit_stats)
    if x.dtype == torch.bfloat16:
        return ln_ff_res_bf16(x, m, s, w1, b1, w2, b2, skip, emit_stats)
    B, H, L = x.shape
    _check_width(H, w1.shape[0])
    out, mean, var = _ff_outputs(torch.float32, x, m, s, w1, b1, w2, b2, skip,
                                 emit_stats)
    cuda_lib.launch("dwst_ln_ff_res", *_ptrs(x, skip, w1, b1, w2, b2, m, s,
                                              out, mean, var),
                    B, H, w1.shape[0], L)
    ln_ff_res.launches += 1
    return (out, mean, var) if emit_stats else out


ln_ff_res.launches = 0


def ln_ff_res_bf16(x, m, s, w1, b1, w2, b2, skip=None, emit_stats=False):
    """Kernel-3f wrapper (x, skip and the output bf16; weights, m, s and
    the statistics f32): CUDA kernel for CUDA tensors, else the plain
    version.  The kernel multiplies on the tensor cores, so H and F must
    be multiples of 16 (:func:`check_ff_bf16_widths`).  A call launches
    two kernels, counted as one launch: a pass that rounds the weights to
    bf16 into a scratch of its own, then the tensor-core kernel."""
    if not x.is_cuda:
        return ln_ff_res_ref(x, m, s, w1, b1, w2, b2, skip, emit_stats)
    B, H, L = x.shape
    Fd = w1.shape[0]
    check_ff_bf16_widths(H, Fd)
    out, mean, var = _ff_outputs(torch.bfloat16, x, m, s, w1, b1, w2, b2,
                                 skip, emit_stats)
    wb = w1.new_empty((2 * Fd * H,), dtype=torch.bfloat16)
    P, smem = ff_bf16_plan(B, H, Fd, L, cuda_lib.sm_count(x.device))
    cuda_lib.launch("dwst_ln_ff_res_bf16",
                    *_ptrs(x, skip, w1, b1, w2, b2, m, s, out, mean, var, wb),
                    B, H, Fd, L, P, smem)
    ln_ff_res_bf16.launches += 1
    return (out, mean, var) if emit_stats else out


ln_ff_res_bf16.launches = 0

# shared memory one block may use on sm_90 (227 KB)
SMEM_LIMIT = 232448


def ff_bf16_plan(B, H, F, L, sms=132):
    """Kernel 3f's tile plan on a card of ``sms`` SMs: (P positions a
    block, shared-memory bytes a block), the grid being ceil(L / P) x B
    blocks.  P = 16384 / H within [32, 128], two blocks an SM below H 512
    at F = 2H; past H 256, P 64 where the grid still fills two waves of
    one block an SM (each block reads both weight matrices, 2 MB in bf16
    at H 512, so a wider P halves those reads per position).  The block
    keeps per-position f32 sums and statistics (18 P floats), its H-row
    input tile as bf16, and one region that holds the F-row bf16 GELU tile
    and then GEMM 2's H-row f32 output tile, rows padded to P + 8.  The
    kernel (``csrc/chmix.cu::ln_ff_res_tc_kernel``) takes these bytes as
    given: this is the one place they are computed."""
    def smem(P):
        return (18 * P * 4 + H * (P + 8) * 2
                + max(F * (P + 8) * 2, H * (P + 8) * 4))

    P = 128 if H <= 128 else (64 if H <= 256 else 32)
    if H > 256 and B * -(-L // 64) >= 2 * sms and smem(64) <= SMEM_LIMIT:
        P = 64
    return P, smem(P)


def check_ff_bf16_widths(H, F):
    """Raise ValueError unless kernel 3f takes channel widths H and F: its
    mma tiles are 16 channels deep, so both must be positive multiples of
    16; its eight warps hold at most 16384 / P output channels (H <= 512);
    and its tiles must fit one block's shared memory."""
    for name, w in (("H", H), ("F", F)):
        if w <= 0 or w % 16:
            raise ValueError(f"kernel 3f: channel width {name} = {w} must be "
                             f"a positive multiple of 16")
    if H > 512:
        raise ValueError(f"kernel 3f: channel width H = {H} is over 512")
    smem = ff_bf16_plan(1, H, F, 1)[1]
    if smem > SMEM_LIMIT:
        raise ValueError(f"kernel 3f: widths H = {H}, F = {F} need {smem} "
                         f"bytes of shared memory a block, over {SMEM_LIMIT}")


def _ff_outputs(dtype, x, m, s, w1, b1, w2, b2, skip, emit_stats):
    """Check the arguments of kernel 3 or 3f (activations of ``dtype``) and
    allocate its output and, with ``emit_stats``, its mean and var."""
    B, H, L = x.shape
    Fd = w1.shape[0]
    for t, shape in ((w1, (Fd, H)), (b1, (Fd,)), (w2, (H, Fd)), (b2, (H,)),
                     (m, (1,)), (s, (1,))):
        cuda_lib.check(t, shape, torch.float32)
    for t in (x,) if skip is None else (x, skip):
        cuda_lib.check(t, (B, H, L), dtype)
    if not emit_stats:
        return torch.empty_like(x), None, None
    return (torch.empty_like(x), x.new_empty((B, L), dtype=torch.float32),
            x.new_empty((B, L), dtype=torch.float32))


def _ptrs(*tensors):
    """Device addresses of tensors, None (a null pointer) for None."""
    return [None if t is None else t.data_ptr() for t in tensors]


def _check_width(*widths):
    """The kernels load weights in k-tiles of 8 channels (two float4).
    (Widths whose activation tile overflows shared memory, H > 512 for the
    FF kernel, are refused at launch.)"""
    for w in widths:
        if w % 8:
            raise ValueError(f"channel width {w} must be a multiple of 8 "
                             f"for the CUDA kernels")


def _gelu_grad(z):
    """d/dz of the exact (erf) GELU."""
    return (0.5 * (1.0 + torch.erf(z * (1.0 / math.sqrt(2.0))))
            + z * torch.exp(-0.5 * z * z) * (1.0 / math.sqrt(2.0 * math.pi)))


def glu_res_bwd_ref(y, w, b, g):
    """Backward of :func:`glu_res_ref` for the output cotangent g, z
    recomputed from y (JAX ``_glu_bwd_kernel``): returns (dy, dw, db);
    the residual's gradient is g itself.  y, g: f32, or bf16 (kernel 6f's
    function: the ``fast=True`` algebra of the module docstring, dy bf16,
    dw and db f32)."""
    dt = y.dtype
    y, g = widen(y), widen(g)
    H = y.shape[1]
    z = (torch.einsum("bhl,oh->bol", y, as_operand(w, dt))
         + b[None, :, None])
    a, sig = z[:, :H], torch.sigmoid(z[:, H:])
    dz = torch.cat([g * sig, g * a * sig * (1.0 - sig)], dim=1)
    dy = torch.einsum("bol,oh->bhl", as_operand(dz, dt), as_operand(w, dt))
    return (dy.to(dt), torch.einsum("bol,bhl->oh", dz, y),
            dz.sum(dim=(0, 2)))


def ln_ff_res_bwd_ref(x, m, s, w1, b1, w2, b2, g):
    """Backward of :func:`ln_ff_res_ref` (without stats) for the output
    cotangent g, everything recomputed from x with the algebra of JAX
    ``_ff_bwd_kernel`` (var = E[x^2] - mean^2):

        dx = g + r (dxn - S1) - r rstd^2 xc S2,   r = s rstd, xc = x - mean
        S1 = mean_h dxn,  S2 = mean_h dxn (xc + m)

    Returns (dx, dm, ds, dw1, db1, dw2, db2); a skip's gradient is g.
    x, g: f32, or bf16 (kernel 7f's function: the ``fast=True`` algebra of
    the module docstring with :func:`gelu_fast` and its derivative, dx
    bf16, the rest f32)."""
    dt = x.dtype
    x, g = widen(x), widen(g)
    gelu, gelu_grad = ((gelu_fast, gelu_fast_grad) if dt == torch.bfloat16
                       else (F.gelu, _gelu_grad))
    mean = x.mean(dim=1, keepdim=True)
    var = (x * x).mean(dim=1, keepdim=True) - mean * mean
    rstd = torch.rsqrt(var)
    xc = x - mean
    r = s * rstd
    xn = r * (xc + m)
    z = (torch.einsum("bhl,fh->bfl", as_operand(xn, dt), as_operand(w1, dt))
         + b1[None, :, None])
    dz = gelu_grad(z) * torch.einsum("bhl,hf->bfl", as_operand(g, dt),
                                     as_operand(w2, dt))
    dxn = torch.einsum("bfl,fh->bhl", as_operand(dz, dt), as_operand(w1, dt))
    S1 = dxn.mean(dim=1, keepdim=True)
    S2 = (dxn * (xc + m)).mean(dim=1, keepdim=True)
    dx = g + r * (dxn - S1) - r * rstd * rstd * xc * S2
    return (dx.to(dt), (dxn * r).sum().reshape(1),
            (dxn * rstd * (xc + m)).sum().reshape(1),
            torch.einsum("bfl,bhl->fh", dz, xn), dz.sum(dim=(0, 2)),
            torch.einsum("bhl,bfl->hf", g, gelu(z)), g.sum(dim=(0, 2)))


def _wgrad_scratch(x, B, L, rows, cols):
    """Split-K partials of a (rows x cols) weight gradient plus its
    (rows,) bias gradient, one slice per WGRAD_POSITIONS positions of one
    batch row; and the reduced result, whose first rows * cols entries are
    the weight gradient and last rows the bias gradient (both in x's
    dtype and on its device)."""
    splits = B * -(-L // WGRAD_POSITIONS)
    size = rows * cols + rows
    return x.new_empty((splits, size)), x.new_empty((size,))


def glu_res_bwd(y, w, b, g):
    """Kernel-6 wrapper (same arguments and results as
    :func:`glu_res_bwd_ref`): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; bf16 activations go to kernel 6f."""
    if not y.is_cuda:
        return glu_res_bwd_ref(y, w, b, g)
    if y.dtype == torch.bfloat16:
        return glu_res_bwd_bf16(y, w, b, g)
    return _launch_glu_bwd(glu_res_bwd, "dwst_glu_res_bwd", torch.float32, y,
                           w, b, g)


glu_res_bwd.launches = 0


def glu_res_bwd_bf16(y, w, b, g):
    """Kernel-6f wrapper (y, g and dy bf16; w, b, dw, db f32): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if not y.is_cuda:
        return glu_res_bwd_ref(y, w, b, g)
    return _launch_glu_bwd(glu_res_bwd_bf16, "dwst_glu_res_bwd_bf16",
                           torch.bfloat16, y, w, b, g)


glu_res_bwd_bf16.launches = 0


def _launch_glu_bwd(wrapper, entry, dtype, y, w, b, g):
    """Check the arguments of kernel 6 or 6f (activations of ``dtype``, the
    dz scratch and the gradients f32), launch ``entry`` and count it on
    ``wrapper``."""
    B, H, L = y.shape
    _check_width(H)
    for t in (y, g):
        cuda_lib.check(t, (B, H, L), dtype)
    for t, shape in ((w, (2 * H, H)), (b, (2 * H,))):
        cuda_lib.check(t, shape, torch.float32)
    wt = w.t().contiguous()
    dy = torch.empty_like(y)
    dz = w.new_empty((B, 2 * H, L))
    part, grads = _wgrad_scratch(w, B, L, 2 * H, H)
    cuda_lib.launch(entry, y.data_ptr(), g.data_ptr(), w.data_ptr(),
                    wt.data_ptr(), b.data_ptr(), dy.data_ptr(), dz.data_ptr(),
                    part.data_ptr(), grads.data_ptr(), B, H, L,
                    WGRAD_POSITIONS)
    wrapper.launches += 1
    return dy, grads[:2 * H * H].view(2 * H, H), grads[2 * H * H:]


def ln_ff_res_bwd(x, m, s, w1, b1, w2, b2, g):
    """Kernel-7 wrapper (same arguments and results as
    :func:`ln_ff_res_bwd_ref`): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors; bf16 activations go to kernel 7f."""
    if not x.is_cuda:
        return ln_ff_res_bwd_ref(x, m, s, w1, b1, w2, b2, g)
    if x.dtype == torch.bfloat16:
        return ln_ff_res_bwd_bf16(x, m, s, w1, b1, w2, b2, g)
    return _launch_ff_bwd(ln_ff_res_bwd, "dwst_ln_ff_res_bwd", torch.float32,
                          x, m, s, w1, b1, w2, b2, g)


ln_ff_res_bwd.launches = 0


def ln_ff_res_bwd_bf16(x, m, s, w1, b1, w2, b2, g):
    """Kernel-7f wrapper (x, g and dx bf16; the weights, m, s and their
    gradients f32): the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if not x.is_cuda:
        return ln_ff_res_bwd_ref(x, m, s, w1, b1, w2, b2, g)
    return _launch_ff_bwd(ln_ff_res_bwd_bf16, "dwst_ln_ff_res_bwd_bf16",
                          torch.bfloat16, x, m, s, w1, b1, w2, b2, g)


ln_ff_res_bwd_bf16.launches = 0


def _launch_ff_bwd(wrapper, entry, dtype, x, m, s, w1, b1, w2, b2, g):
    """Check the arguments of kernel 7 or 7f (activations of ``dtype``; the
    xn, GELU-output and dz scratch and the gradients f32), launch
    ``entry`` and count it on ``wrapper``."""
    B, H, L = x.shape
    Fd = w1.shape[0]
    _check_width(H, Fd)
    for t in (x, g):
        cuda_lib.check(t, (B, H, L), dtype)
    for t, shape in ((w1, (Fd, H)), (b1, (Fd,)), (w2, (H, Fd)), (b2, (H,)),
                     (m, (1,)), (s, (1,))):
        cuda_lib.check(t, shape, torch.float32)
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    dx = torch.empty_like(x)
    xn = w1.new_empty((B, H, L))
    hact = w1.new_empty((B, Fd, L))
    dz = w1.new_empty((B, Fd, L))
    # per-block (dm, ds) partials: at most one block per 16 positions
    stat_part = w1.new_empty((B * -(-L // 16), 2))
    dms = w1.new_empty((2,))
    part1, grads1 = _wgrad_scratch(w1, B, L, Fd, H)
    part2, grads2 = _wgrad_scratch(w1, B, L, H, Fd)
    cuda_lib.launch(entry, x.data_ptr(), g.data_ptr(), w1.data_ptr(),
                    b1.data_ptr(), w1t.data_ptr(), w2t.data_ptr(),
                    m.data_ptr(), s.data_ptr(), dx.data_ptr(), xn.data_ptr(),
                    hact.data_ptr(), dz.data_ptr(), stat_part.data_ptr(),
                    dms.data_ptr(), part1.data_ptr(), grads1.data_ptr(),
                    part2.data_ptr(), grads2.data_ptr(), B, H, Fd, L,
                    WGRAD_POSITIONS)
    wrapper.launches += 1
    return (dx, dms[0:1], dms[1:2], grads1[:Fd * H].view(Fd, H),
            grads1[Fd * H:], grads2[:H * Fd].view(H, Fd), grads2[H * Fd:])


class _GluResTrain(torch.autograd.Function):
    """Forward kernel 2, backward kernel 6 (JAX ``_glu_train``); 2f and 6f
    for bf16 activations."""

    @staticmethod
    def forward(ctx, y, res, w, b):
        ctx.save_for_backward(y, w, b)
        return mix_glu_res(y, res, w, b)

    @staticmethod
    def backward(ctx, g):
        y, w, b = ctx.saved_tensors
        g = g.contiguous()
        dy, dw, db = glu_res_bwd(y, w, b, g)
        return dy, g, dw, db


def mix_glu_res_train(y, res, w, b):
    """Differentiable res + GLU(w y + b)."""
    return _GluResTrain.apply(y.contiguous(), res.contiguous(),
                              w.contiguous(), b.contiguous())


class _LnFFResTrain(torch.autograd.Function):
    """Forward kernel 3 (no stats), backward kernel 7 (JAX ``_ff_train``
    and ``_ff_train_skip``; a skip's gradient is g); 3f and 7f for bf16
    activations."""

    @staticmethod
    def forward(ctx, x, m, s, w1, b1, w2, b2, skip):
        ctx.save_for_backward(x, m, s, w1, b1, w2, b2)
        ctx.has_skip = skip is not None
        return ln_ff_res(x, m, s, w1, b1, w2, b2, skip)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        grads = ln_ff_res_bwd(*ctx.saved_tensors, g)
        return (*grads, g if ctx.has_skip else None)


def ln_ff_res_train(x, m, s, w1, b1, w2, b2, skip=None):
    """Differentiable x + w2 gelu(w1 TLN(x) + b1) + b2 [+ skip]."""
    return _LnFFResTrain.apply(
        x.contiguous(), m.contiguous(), s.contiguous(), w1.contiguous(),
        b1.contiguous(), w2.contiguous(), b2.contiguous(),
        None if skip is None else skip.contiguous())
