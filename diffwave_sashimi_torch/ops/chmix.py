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
statistics are the f32 output's); kernels 2f and 3f multiply on the
tensor cores and take channel widths that are multiples of 16.  Backward (JAX
``_bmm`` / ``_bmmc``): both operands of every per-position product (z = W
y, dy = W^T dz, z = W1 xn, dh = W2^T g, dxn = W1^T dz) are rounded to
bf16, the weight gradients contract the unrounded f32 dz, xn and GELU
output, the GELU's derivative is the polynomial's, dy and dx are rounded
to bf16 and the weight, bias, m and s gradients stay f32; kernels 6f
and 7f multiply on the tensor cores and take channel widths that are
multiples of 16.  The weight gradients of 6, 6f, 7 and 7f are one tiled
contraction over all positions, in split-K partials summed in a fixed
order (``wgrad_plan``), on the fp32 FMAs.  Kernels 2's, 3's, 6's and
7's per-position products run on the tensor cores in 3xTF32: each f32
operand split into two tf32 parts, hi and lo, and a product taken as lo
hi + hi lo + hi hi with f32 sums, which keeps f32 accuracy.

Widths: each kernel's plan (``glu_tf32_plan``, ``ff_tf32_plan``,
``glu_bwd_tf32_plan``, ``ff_bwd_plan``, ``glu_bf16_plan``, ``ff_bf16_plan``,
``glu_bwd_bf16_plan``, ``ff_bwd_bf16_plan``)
is the one place its positions a block and its shared-memory bytes are
computed, and its refusal function (``glu_refusal`` and the like) says
whether it takes a block's widths at an activation dtype.  Every kernel
takes every tier of d_model 128 and 256 (H up to 1024, F = 2H).  A
wrapper given widths its kernel does not take raises ValueError on CUDA
tensors before it launches; ``models.check_supported`` refuses such a
model on the card by name before it is built.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from . import cuda_lib
from .fftconv import as_operand, gelu_fast, gelu_fast_grad, widen

def glu_res_ref(y, res, w, b):
    """res + GLU over channels of (w @ y + b).  y, res: (B, H, L), f32 or
    bf16 (kernel 2f's function); w: (2H, H); b: (2H,) f32."""
    z = (torch.einsum("bhl,oh->bol", widen(y), as_operand(w, y.dtype))
         + b[None, :, None])
    H = y.shape[1]
    return (widen(res) + z[:, :H] * torch.sigmoid(z[:, H:])).to(res.dtype)


def mix_glu_res(y, res, w, b):
    """Kernel-2 wrapper: CUDA kernel for CUDA tensors, else the plain
    version; bf16 activations go to kernel 2f.  The kernel's product runs
    on the tensor cores at f32 accuracy (3xTF32); H must be a multiple of
    8 (:func:`glu_refusal`).  A call launches two kernels, counted as one
    launch: a pass that splits W's value and gate halves into tf32 parts
    in mma fragment order into a scratch of its own, then the 3xTF32
    kernel, sized by :func:`glu_tf32_plan`."""
    if not y.is_cuda:
        return glu_res_ref(y, res, w, b)
    if y.dtype == torch.bfloat16:
        return mix_glu_res_bf16(y, res, w, b)
    B, H, L = y.shape
    _raise(glu_refusal(H, torch.float32))
    for t, shape in ((y, (B, H, L)), (res, (B, H, L)), (w, (2 * H, H)),
                     (b, (2 * H,))):
        cuda_lib.check(t, shape, torch.float32)
    out = torch.empty_like(res)
    wf = w.new_empty((glu_tf32_split_floats(H),))
    cuda_lib.launch("dwst_glu_res", *_ptrs(y, res, w, b, out, wf), B, H, L,
                    *glu_tf32_plan(B, H, L, cuda_lib.sm_count(y.device)))
    mix_glu_res.launches += 1
    return out


mix_glu_res.launches = 0


def mix_glu_res_bf16(y, res, w, b):
    """Kernel-2f wrapper (y, res bf16; w, b f32): CUDA kernel for CUDA
    tensors, else the plain version.  The kernel multiplies on the tensor
    cores, so H must be a multiple of 16 up to 1024
    (:func:`check_glu_bf16_widths`).  A call launches two kernels, counted
    as one launch: a pass that rounds W to bf16 into a scratch of its own,
    then the tensor-core kernel."""
    if not y.is_cuda:
        return glu_res_ref(y, res, w, b)
    B, H, L = y.shape
    check_glu_bf16_widths(H)
    for t, shape in ((y, (B, H, L)), (res, (B, H, L))):
        cuda_lib.check(t, shape, torch.bfloat16)
    for t, shape in ((w, (2 * H, H)), (b, (2 * H,))):
        cuda_lib.check(t, shape, torch.float32)
    out = torch.empty_like(res)
    wb = w.new_empty((2 * H * H,), dtype=torch.bfloat16)
    cuda_lib.launch("dwst_glu_res_bf16", *_ptrs(y, res, w, b, out, wb),
                    B, H, L,
                    *glu_bf16_plan(B, H, L, cuda_lib.sm_count(y.device)))
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
    3f.  The kernel's two products run on the tensor cores at f32 accuracy
    (3xTF32); H and F must be multiples of 8 (:func:`ff_refusal`).  A call
    launches two kernels, counted as one launch: a pass that splits W1 and
    W2 into tf32 parts in mma fragment order into a scratch of its own,
    then the 3xTF32 kernel, sized by :func:`ff_tf32_plan`."""
    if not x.is_cuda:
        return ln_ff_res_ref(x, m, s, w1, b1, w2, b2, skip, emit_stats)
    if x.dtype == torch.bfloat16:
        return ln_ff_res_bf16(x, m, s, w1, b1, w2, b2, skip, emit_stats)
    B, H, L = x.shape
    Fd = w1.shape[0]
    _raise(ff_refusal(H, Fd, torch.float32))
    out, mean, var = _ff_outputs(torch.float32, x, m, s, w1, b1, w2, b2, skip,
                                 emit_stats)
    wf = w1.new_empty((ff_tf32_split_floats(H, Fd),))
    cuda_lib.launch("dwst_ln_ff_res", *_ptrs(x, skip, w1, b1, w2, b2, m, s,
                                              out, mean, var, wf),
                    B, H, Fd, L, *ff_tf32_plan(H, Fd))
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
# an SM's shared memory on sm_90 (228 KB), of which the card reserves 1 KB
# for each block it holds
SMEM_SM, SMEM_RESERVED = 233472, 1024
# csrc/chmix.cu: NT threads a block; TK channels a tf32 mma k-step (the
# f32 kernels' widths are multiples of it)
NT, TK = 256, 8
# the positions a block kernel 7 (3xTF32) is built for (the P cases of
# its launcher in csrc/chmix.cu), widest first
FF_BWD_PS = (64, 32, 16, 8)
# the positions a block kernel 3 (3xTF32) is built for, widest first
FF_TF32_PS = (128, 64, 32, 16, 8)
# kernel 2's (3xTF32): the positions a block it is built for at one block
# an SM, widest first; its (P, blocks an SM) instances of more blocks, in
# the order its plan tries them; the most split-weight bytes a block may
# read from L2 per position there (kernel 11's rule: a narrower P re-reads
# the weights more often)
GLU_TF32_PS = (32, 16, 8)
GLU_TF32_SHARED = ((64, 2), (32, 2))
GLU_TF32_WEIGHT_BYTES = 16384
# kernel 6's (3xTF32 pass): the positions a block it is built for at one
# block an SM, widest first, and its (P, blocks an SM) instances of more
# blocks (the same rule of split-weight bytes a position as kernel 2's)
GLU_BWD_TF32_PS = (64, 32, 16, 8)
GLU_BWD_TF32_SHARED = ((64, 2),)
# the widest H kernels 2f, 3f, 6f and 7f take
GLU_BF16_MAX_H = FF_BF16_MAX_H = FF_BWD_BF16_MAX_H = 1024
# the positions a block kernels 6f and 7f are built for, widest first
GLU_BWD_BF16_PS = FF_BWD_BF16_PS = (128, 64, 32, 16)
# csrc/chmix.cu's weight-gradient GEMM: output tile (WGRAD_TILE squared)
# and positions a stage (WGRAD_STEP); a split-K partial's positions are a
# multiple of WGRAD_ALIGN, and at least one stage
WGRAD_TILE, WGRAD_STEP, WGRAD_ALIGN = 128, 32, 8


def _positions(H):
    """P = 16384 / H within [32, 128]: the bf16 tensor-core kernels'
    default."""
    return 128 if H <= 128 else (64 if H <= 256 else 32)


def _fitted(ps, P0, smem):
    """(P, smem(P)) for the widest P of ``ps`` up to P0 whose tiles fit
    one block's shared memory (the narrowest if none does: the kernel's
    refusal then names the bytes)."""
    ps = [P for P in ps if P <= P0]
    P = next((P for P in ps if smem(P) <= SMEM_LIMIT), ps[-1])
    return P, smem(P)


@functools.lru_cache(maxsize=None)
def glu_tf32_plan(B, H, L, sms=132):
    """Kernel 2's tile plan (``csrc/chmix.cu::glu_res_tf32_kernel``) on a
    card of ``sms`` SMs: (P positions a block, blocks an SM the kernel is
    built for, shared-memory bytes a block), the grid being ceil(L / P) x
    B blocks.  The block keeps the f32 y tile (H rows) and each of its 8
    warps a 16-row f32 staging tile, rows of :func:`ff_bwd_ld` floats.
    Several blocks an SM hide each other's latencies, so the plan takes
    the first of GLU_TF32_SHARED whose blocks' tiles fit an SM and whose
    block reads at most GLU_TF32_WEIGHT_BYTES of split weights (2H x H, 8
    bytes an entry) per position: P 64 at two blocks at H 128 and 256.
    Else one block an SM, at the widest of GLU_TF32_PS whose tiles fit and
    whose grid fills at least 90% of one wave (each block reads the whole
    split weight from L2, so a wider P reads it less often per position,
    while a grid short of a wave leaves SMs idle), else the narrowest that
    fits: P 32 at SC09's, the vocoder's and d_model 256's H 512 and at H
    1024.  P 64 at one block an SM (64 sums of one value and one gate
    m-tile a thread) lost to P 32 (two of each) at every such tier but
    one on an H100 (chip_smoke.py's ``p_ms``).  The kernel takes these as
    given: this is the one place they are computed."""
    for P, blocks in GLU_TF32_SHARED:
        smem = glu_tf32_smem(H, P)
        if (2 * H * H * 8 <= GLU_TF32_WEIGHT_BYTES * P
                and blocks * (smem + SMEM_RESERVED) <= SMEM_SM):
            return P, blocks, smem
    fits = [P for P in GLU_TF32_PS
            if glu_tf32_smem(H, P) <= SMEM_LIMIT] or GLU_TF32_PS[-1:]
    P = next((P for P in fits if B * -(-L // P) >= 0.9 * sms), fits[-1])
    return P, 1, glu_tf32_smem(H, P)


def glu_tf32_smem(H, P):
    """Kernel 2's shared-memory bytes a block at width H and P positions
    (:func:`glu_tf32_plan`): the H-row y tile and 8 warps' 16-row staging
    tiles, f32 rows of ``ff_bwd_ld(P)`` floats."""
    return (H + 16 * (NT // 32)) * ff_bwd_ld(P) * 4


def glu_tf32_split_floats(H):
    """Floats of kernel 2's split-weight scratch: W's value half Wa (H x
    H) then its gate half Wg, each as ``csrc/mma_tf32.cuh`` lays it out
    (m-tiles of 16 rows, zero past H, by k-tiles of 8, 256 floats a
    tile)."""
    return 256 * 2 * -(-H // 16) * (H // 8)


@functools.lru_cache(maxsize=None)
def ff_tf32_plan(H, F):
    """Kernel 3's tile plan (``csrc/chmix.cu::ln_ff_res_tf32_kernel``): (P
    positions a block, FC hidden rows a chunk, blocks an SM the kernel is
    built for, shared-memory bytes a block), the grid being ceil(L / P) x
    B blocks.  Where two blocks' tiles at P 64 fit an SM (H 128, F 256),
    P 64 at two blocks an SM: the other block's warps hide each one's
    latencies, which outweighs reading the weights twice as often
    (chip_smoke.py's p_ms of kernel 3 on an H100, against P 128 at one
    block).  Else one block an SM, and since each block reads both split
    weight matrices whole from L2, P is the
    widest of FF_TF32_PS whose tiles fit: the x tile (H rows), then either
    the whole F-row GELU tile (FC = F; the sums of W2's product then go
    over the x tile) or an FC-row chunk of it and an H-row tile of those
    sums, rows of :func:`ff_bwd_ld` floats, beside 2 NT floats of partial
    sums and 2 P of statistics.  FC is the widest multiple of 16 MT 8 (a
    chunk's m-tiles spread over the 8 warps, MT each) that fits, else of 16
    MT, and a P whose chunks would leave more than half the warps idle
    gives way to the next: P 64, 32, 16 at H 256, 512, 1024, F = 2H, the
    chunks from H 512.  The kernel takes these as given: this is the one
    place they are computed."""
    two = ff_tf32_smem(H, F, 64, F)
    if 2 * (two + SMEM_RESERVED) <= SMEM_SM:
        return 64, F, 2, two
    for P in FF_TF32_PS:
        if ff_tf32_smem(H, F, P, F) <= SMEM_LIMIT:
            return P, F, 1, ff_tf32_smem(H, F, P, F)
        unit = 16 * _tf32_mt(P)           # one warp's m-tiles
        wide = NT // 32 * unit            # the 8 warps' m-tiles
        rows = (SMEM_LIMIT // 4 - 2 * NT - 2 * P) // ff_bwd_ld(P) - 2 * H
        FC = rows // wide * wide or rows // unit * unit
        if FC >= wide // 2:
            return P, FC, 1, ff_tf32_smem(H, F, P, FC)
    P = FF_TF32_PS[-1]
    FC = 16 * _tf32_mt(P)
    return P, FC, 1, ff_tf32_smem(H, F, P, FC)


def ff_tf32_smem(H, F, P, FC):
    """Kernel 3's shared-memory bytes a block at widths H, F, P positions
    and FC hidden rows a chunk (:func:`ff_tf32_plan`)."""
    rows = H + min(F, FC) + (H if FC < F else 0)
    return 4 * (2 * NT + 2 * P + rows * ff_bwd_ld(P))


def _tf32_mt(P):
    """m-tiles a warp takes at once in kernel 3's first product at P
    positions and one block an SM (``FfTf32Tile<P, 1>::MT1``): 64 sums a
    thread, at most 4."""
    n8 = P // 8
    return 1 if n8 >= 16 else min(16 // n8, 4)


def ff_tf32_split_floats(H, F):
    """Floats of kernel 3's split-weight scratch: W1 (F x H) then W2 (H x
    F), each as ``csrc/mma_tf32.cuh`` lays them out (m-tiles of 16 rows,
    zero past the matrix, by k-tiles of 8, 256 floats a tile)."""
    return 256 * (-(-F // 16) * (H // 8) + -(-H // 16) * (F // 8))


@functools.lru_cache(maxsize=None)
def glu_bwd_tf32_plan(B, H, L, sms=132):
    """Kernel 6's tile plan (``csrc/chmix.cu::glu_res_bwd_tf32_kernel``) on
    a card of ``sms`` SMs: (P positions a block, blocks an SM the kernel is
    built for, shared-memory bytes a block), the grid being ceil(L / P) x
    B blocks.  The block keeps the f32 y tile (H rows) and the dz tile (2H
    rows, g until each entry's own thread overwrites it), rows of
    :func:`ff_bwd_ld` floats.  As :func:`glu_tf32_plan`: the first of
    GLU_BWD_TF32_SHARED whose blocks' tiles fit an SM, whose block reads at
    most GLU_TF32_WEIGHT_BYTES of split weights (W and W^T, 8 bytes an
    entry) per position and whose grid fills at least 90% of one wave of
    that many blocks an SM, P 64 at two blocks at H 128; else one block an
    SM at the widest of GLU_BWD_TF32_PS whose tiles fit and whose grid
    fills at least 90% of one wave, else the narrowest that fits: P 64 at
    H 256, 16 at H 512, 8 at H 1024 (SC09's and d_model 256's tiers at
    B4).  The kernel takes these as given: this is the one place they are
    computed."""
    for P, blocks in GLU_BWD_TF32_SHARED:
        smem = glu_bwd_tf32_smem(H, P)
        if (4 * H * H * 8 <= GLU_TF32_WEIGHT_BYTES * P
                and blocks * (smem + SMEM_RESERVED) <= SMEM_SM
                and B * -(-L // P) >= 0.9 * blocks * sms):
            return P, blocks, smem
    fits = [P for P in GLU_BWD_TF32_PS
            if glu_bwd_tf32_smem(H, P) <= SMEM_LIMIT] or GLU_BWD_TF32_PS[-1:]
    P = next((P for P in fits if B * -(-L // P) >= 0.9 * sms), fits[-1])
    return P, 1, glu_bwd_tf32_smem(H, P)


def glu_bwd_tf32_smem(H, P):
    """Kernel 6's shared-memory bytes a block at width H and P positions
    (:func:`glu_bwd_tf32_plan`): the H-row y tile and the 2H-row dz tile,
    f32 rows of ``ff_bwd_ld(P)`` floats."""
    return 3 * H * ff_bwd_ld(P) * 4


def glu_bwd_tf32_split_floats(H):
    """Floats of kernel 6's split-weight scratch: W's value half Wa (H x
    H), its gate half Wg, then W^T (H x 2H), each as ``csrc/mma_tf32.cuh``
    lays it out (m-tiles of 16 rows, zero past H, by k-tiles of 8, 256
    floats a tile)."""
    Ht = -(-H // 16)
    return 256 * (2 * Ht * (H // 8) + Ht * (H // 4))


def ff_bwd_plan(H, F):
    """Kernel 7's tile plan (``csrc/chmix.cu::ln_ff_res_bwd_tf32_kernel``):
    (P positions a block, shared-memory bytes a block), the grid being
    ceil(L / P) x B blocks of one block an SM.  P = 8192 / H within [16,
    64], halved until the tiles fit (8 at H 1024, F 2048): each block
    reads the three split weight matrices whole from L2, so a wider P
    reads them less often per position.  The block keeps 2 NT floats of
    partial sums and 4 P of statistics, and its f32 x (then xn, then dxn)
    and g tiles and its F-row dz tile, rows of :func:`ff_bwd_ld` floats.
    The kernel takes these bytes as given: this is the one place they are
    computed."""
    P0 = 64 if H <= 128 else (32 if H <= 256 else 16)
    return _fitted(FF_BWD_PS, P0, lambda P: 4 * (
        2 * NT + 4 * P + (2 * H + F) * ff_bwd_ld(P)))


def ff_bwd_ld(P):
    """Floats a row of kernel 7's f32 tiles at P positions: P padded so
    that the row stride is 8 or 24 modulo 32 banks (a tf32 B fragment's 32
    loads, rows t and columns g of lane 4 g + t, fall on distinct banks)
    and rows stay 16-byte aligned."""
    return P if P == 8 else P + 8


def ff_bwd_split_floats(H, F):
    """Floats of kernel 7's split-weight scratch: W1 (F x H), W1^T and W2^T
    (``csrc/mma_tf32.cuh``: m-tiles of 16 rows, zero past the matrix, by
    k-tiles of 8, each as its 32 lanes' tf32 hi fragments then their lo
    fragments, 256 floats a tile)."""
    return 256 * (2 * -(-F // 16) * (H // 8) + -(-H // 16) * (F // 8))


def glu_bf16_plan(B, H, L, sms=132):
    """Kernel 2f's tile plan on a card of ``sms`` SMs: (P positions a
    block, shared-memory bytes a block), the grid being ceil(L / P) x B
    blocks of one block an SM.  P = 16384 / H within [32, 128]; past H 256,
    P 64 where the grid still fills two waves (each block reads W whole,
    so a wider P halves those reads per position).  The block keeps its
    H-row y tile as bf16 and, for one pass of value rows (16384 / P of
    them, or H if fewer), the f32 gated product and the bf16 res rows,
    rows padded to P + 8.  The kernel (``csrc/chmix.cu::
    glu_res_tc_kernel``) takes these bytes as given: this is the one place
    they are computed."""
    def smem(P):
        return (P + 8) * (H * 2 + min(H, 16384 // P) * (4 + 2))

    P = _positions(H)
    if H > 256 and B * -(-L // 64) >= 2 * sms and smem(64) <= SMEM_LIMIT:
        P = 64
    return P, smem(P)


def glu_bwd_bf16_plan(B, H, L, sms=132):
    """Kernel 6f's tile plan on a card of ``sms`` SMs: (P positions a
    block, shared-memory bytes a block), the grid being ceil(L / P) x B
    blocks of one block an SM.  P is the widest of GLU_BWD_BF16_PS whose
    tiles fit one block and whose grid fills at least 90% of one wave
    (each block reads the bf16 W and W^T whole from L2, so a wider P
    reads them less often per position, while a grid short of a wave
    leaves SMs idle), else the narrowest that fits: 128 at H 128 and 256,
    32 at H 512 and L 1000 (B4), 16 at H 1024.  The block keeps two bf16
    tiles, rows padded to P + 8: the H-row y tile, which holds bf16(dy)
    once the first product is done, and the 2H-row dz tile, whose first H
    rows hold g until each entry's own thread overwrites it with
    bf16(da).  The kernel (``csrc/chmix.cu::glu_res_bwd_tc_kernel``)
    takes these bytes as given: this is the one place they are computed
    (:func:`glu_bwd_bf16_smem`)."""
    fits = [P for P in GLU_BWD_BF16_PS
            if glu_bwd_bf16_smem(H, P) <= SMEM_LIMIT] or GLU_BWD_BF16_PS[-1:]
    P = next((P for P in fits if B * -(-L // P) >= 0.9 * sms), fits[-1])
    return P, glu_bwd_bf16_smem(H, P)


def glu_bwd_bf16_smem(H, P):
    """Kernel 6f's shared-memory bytes a block at width H and P positions
    (:func:`glu_bwd_bf16_plan`): the H-row y tile and the 2H-row dz tile,
    bf16 rows of P + 8."""
    return 3 * H * (P + 8) * 2


def ff_bf16_plan(B, H, F, L, sms=132):
    """Kernel 3f's tile plan on a card of ``sms`` SMs: (P positions a
    block, shared-memory bytes a block), the grid being ceil(L / P) x B
    blocks.  P = 16384 / H within [32, 128], two blocks an SM below H 512
    at F = 2H; past H 256, P 64 where the grid still fills two waves of
    one block an SM (each block reads both weight matrices, 2 MB in bf16
    at H 512, so a wider P halves those reads per position); 16 past H
    512, where GEMM 2's warps hold 8 m-tiles each.  The block
    keeps per-position f32 sums and statistics (18 P floats), its H-row
    input tile as bf16, and one region that holds the F-row bf16 GELU tile
    and then GEMM 2's H-row f32 output tile, rows padded to P + 8.  The
    kernel (``csrc/chmix.cu::ln_ff_res_tc_kernel``) takes these bytes as
    given: this is the one place they are computed."""
    def smem(P):
        return (18 * P * 4 + H * (P + 8) * 2
                + max(F * (P + 8) * 2, H * (P + 8) * 4))

    P = _positions(H)
    if H > 512:
        P = 16
    elif H > 256 and B * -(-L // 64) >= 2 * sms and smem(64) <= SMEM_LIMIT:
        P = 64
    return P, smem(P)


@functools.lru_cache(maxsize=None)
def ff_bwd_bf16_plan(H, F):
    """Kernel 7f's tile plan: (P positions a block, shared-memory bytes a
    block), the grid being ceil(L / P) x B blocks of one block an SM.  P
    is the widest of FF_BWD_BF16_PS with H P <= 16384 (the 8 warps' 128 /
    P m-tiles of dxn cover H rows, and each thread's 8-position chunk
    holds at most 8 of its rows), halved until the tiles fit.  The block
    keeps 20 P floats of per-warp sums and statistics, its H-row bf16 x
    (then xn) and g tiles, and one region that holds the F-row bf16 dz
    tile and then the H-row f32 dxn tile, rows padded to P + 8.  P depends
    on the widths alone: a narrower P re-reads the three bf16 weight
    matrices from L2 more often.  The kernel
    (``csrc/chmix.cu::ln_ff_res_bwd_tc_kernel``) takes these bytes as
    given: this is the one place they are computed."""
    def smem(P):
        return (20 * P * 4 + 2 * H * (P + 8) * 2
                + max(F * (P + 8) * 2, H * (P + 8) * 4))

    P0 = next((P for P in FF_BWD_BF16_PS if H * P <= 16384),
              FF_BWD_BF16_PS[-1])
    return _fitted(FF_BWD_BF16_PS, P0, smem)


@functools.lru_cache(maxsize=None)
def wgrad_plan(B, M, N, L, sms=132):
    """The split-K plan of one weight gradient (M x N, plus its M bias
    entries) contracted over B batch rows of L positions
    (``csrc/chmix.cu::wgrad_kernel``, one block of WGRAD_TILE squared
    outputs an SM): (positions a split, splits, bytes of the f32
    partials).  Each batch row is cut into the fewest splits that give at
    least two waves of blocks on ``sms`` SMs and fill at least 90% of the
    waves they take (else the fullest of up to four times the fewest), so
    that no wave runs nearly empty; the positions a split are a multiple
    of WGRAD_ALIGN, so that every split starts 16 bytes aligned, and at
    least one stage of WGRAD_STEP.  A row too short for two waves is cut
    into splits of one stage."""
    tiles = -(-M // WGRAD_TILE) * -(-N // WGRAD_TILE)

    def split(n):              # (positions a split, splits a batch row)
        tc = max(WGRAD_STEP, -(-L // n // WGRAD_ALIGN) * WGRAD_ALIGN)
        return tc, -(-L // tc)

    def blocks(n):
        return tiles * B * split(n)[1]

    def fill(n):               # the share of its waves' SMs the grid fills
        return blocks(n) / (-(-blocks(n) // sms) * sms)

    n0 = max(1, -(-2 * sms // (tiles * B)))
    cands = [n for n in range(n0, 4 * n0 + 1) if blocks(n) >= 2 * sms]
    if cands:
        n = next((n for n in cands if fill(n) >= 0.9), max(cands, key=fill))
    else:
        n = -(-L // WGRAD_STEP)
    tc, per_row = split(n)
    splits = B * per_row
    return tc, splits, splits * (M * N + M) * 4


def _width_refusal(kernel, widths, step, smem, max_h=None):
    """Why ``kernel`` does not take ``widths`` ((name, width) pairs, H
    first), each of which must be a positive multiple of ``step``, H at
    most ``max_h``, on ``smem`` bytes of shared memory a block; None if it
    does."""
    for name, w in widths:
        if w <= 0 or w % step:
            return (f"kernel {kernel}: channel width {name} = {w} must be a "
                    f"positive multiple of {step}")
    H = widths[0][1]
    if max_h is not None and H > max_h:
        return f"kernel {kernel}: channel width H = {H} is over {max_h}"
    if smem > SMEM_LIMIT:
        return (f"kernel {kernel}: widths "
                + ", ".join(f"{n} = {w}" for n, w in widths)
                + f" need {smem} bytes of shared memory a block, over "
                f"{SMEM_LIMIT}")
    return None


def glu_refusal(H, dtype):
    """None if kernel 2 (f32) or 2f (bf16 activations) takes channel
    width H, else why not.  Kernel 2's tf32 mma k-steps are 8 channels
    deep (its m-tiles of 16 pad with zero rows), and its tiles fit one
    block up to H 7136 at P 8; 2f's mma tiles are 16 deep and its plan
    holds up to GLU_BF16_MAX_H rows."""
    if dtype != torch.bfloat16:
        return _width_refusal("2", (("H", H),), TK,
                              glu_tf32_plan(1, H, 1)[2])
    return _width_refusal("2f", (("H", H),), 16, glu_bf16_plan(1, H, 1)[1],
                          GLU_BF16_MAX_H)


def ff_refusal(H, F, dtype):
    """None if kernel 3 (f32) or 3f (bf16 activations) takes widths H and
    F (hidden), else why not.  3f's eight warps hold at most 128 output
    channels each, so H <= FF_BF16_MAX_H."""
    widths = (("H", H), ("F", F))
    if dtype != torch.bfloat16:
        return _width_refusal("3", widths, TK, ff_tf32_plan(H, F)[3])
    return _width_refusal("3f", widths, 16, ff_bf16_plan(1, H, F, 1)[1],
                          FF_BF16_MAX_H)


def glu_bwd_refusal(H, dtype):
    """None if kernel 6 (f32) or 6f (bf16 activations) takes width H,
    else why not.  Kernel 6's tf32 mma k-steps are 8 channels deep (its
    m-tiles of 16 pad with zero rows), and its tiles fit one block up to H
    2416 at P 8; 6f's mma tiles are 16 channels deep and its plan holds up
    to GLU_BF16_MAX_H rows, as 2f's."""
    if dtype != torch.bfloat16:
        return _width_refusal("6", (("H", H),), TK,
                              glu_bwd_tf32_plan(1, H, 1)[2])
    return _width_refusal("6f", (("H", H),), 16,
                          glu_bwd_bf16_plan(1, H, 1)[1], GLU_BF16_MAX_H)


def ff_bwd_refusal(H, F, dtype):
    """None if kernel 7 (f32) or 7f (bf16 activations) takes widths H and
    F, else why not.  Kernel 7's tf32 mma k-steps are 8 channels deep (its
    m-tiles of 16 pad with zero rows); 7f's mma tiles are 16 channels deep
    and its plan holds up to FF_BWD_BF16_MAX_H rows."""
    widths = (("H", H), ("F", F))
    if dtype != torch.bfloat16:
        return _width_refusal("7", widths, TK, ff_bwd_plan(H, F)[1])
    return _width_refusal("7f", widths, 16, ff_bwd_bf16_plan(H, F)[1],
                          FF_BWD_BF16_MAX_H)


def _raise(refusal):
    if refusal is not None:
        raise ValueError(refusal)


def check_glu_bf16_widths(H):
    """Raise ValueError, naming the width, unless kernel 2f takes H: a
    positive multiple of 16 up to GLU_BF16_MAX_H."""
    _raise(glu_refusal(H, torch.bfloat16))


def check_ff_bf16_widths(H, F):
    """Raise ValueError, naming the width, unless kernel 3f takes H and F:
    positive multiples of 16 (its mma tiles are 16 channels deep), H <=
    FF_BF16_MAX_H, and tiles that fit one block's shared memory."""
    _raise(ff_refusal(H, F, torch.bfloat16))


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
    """(positions a split, partials, result) of a (rows x cols) weight
    gradient plus its (rows,) bias gradient by :func:`wgrad_plan`: the
    split-K partials, one slice a split of one batch row; the reduced
    result, whose first rows * cols entries are the weight gradient and
    last rows the bias gradient (both in x's dtype and on its device)."""
    tc, splits, _ = wgrad_plan(B, rows, cols, L, cuda_lib.sm_count(x.device))
    size = rows * cols + rows
    return tc, x.new_empty((splits, size)), x.new_empty((size,))


def glu_res_bwd(y, w, b, g):
    """Kernel-6 wrapper (same arguments and results as
    :func:`glu_res_bwd_ref`): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; bf16 activations go to kernel 6f.  The pass's
    two products run on the tensor cores at f32 accuracy (3xTF32); H must
    be a multiple of 8 (:func:`glu_bwd_refusal`).  A call launches,
    counted as one launch: a pass that splits W's value and gate halves
    and its transpose into tf32 parts in mma fragment order into a scratch
    of its own, the 3xTF32 pass (sized by :func:`glu_bwd_tf32_plan`), and
    the weight-gradient contraction with its split-K sum."""
    if not y.is_cuda:
        return glu_res_bwd_ref(y, w, b, g)
    if y.dtype == torch.bfloat16:
        return glu_res_bwd_bf16(y, w, b, g)
    B, H, L = y.shape
    _raise(glu_bwd_refusal(H, torch.float32))
    dy, dz, tc, part, grads = _glu_bwd_buffers(torch.float32, y, w, b, g)
    wf = w.new_empty((glu_bwd_tf32_split_floats(H),))
    cuda_lib.launch("dwst_glu_res_bwd",
                    *_ptrs(y, g, w, b, dy, dz, part, grads, wf), B, H, L, tc,
                    *glu_bwd_tf32_plan(B, H, L, cuda_lib.sm_count(y.device)))
    glu_res_bwd.launches += 1
    return dy, grads[:2 * H * H].view(2 * H, H), grads[2 * H * H:]


glu_res_bwd.launches = 0


def glu_res_bwd_bf16(y, w, b, g):
    """Kernel-6f wrapper (y, g and dy bf16; w, b, dw, db f32): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.  The
    per-position products run on the tensor cores, so H must be a multiple
    of 16 up to 1024 (:func:`glu_bwd_refusal`).  A call launches, counted
    as one launch: a pass that rounds W and its transpose to bf16 into a
    scratch of its own, in mma fragment order, the tensor-core pass, and
    the weight-gradient contraction with its split-K sum."""
    if not y.is_cuda:
        return glu_res_bwd_ref(y, w, b, g)
    B, H, L = y.shape
    _raise(glu_bwd_refusal(H, torch.bfloat16))
    dy, dz, tc, part, grads = _glu_bwd_buffers(torch.bfloat16, y, w, b, g)
    wb = w.new_empty((4 * H * H,), dtype=torch.bfloat16)
    cuda_lib.launch("dwst_glu_res_bwd_bf16",
                    *_ptrs(y, g, w, b, dy, dz, part, grads, wb),
                    B, H, L, tc,
                    *glu_bwd_bf16_plan(B, H, L, cuda_lib.sm_count(y.device)))
    glu_res_bwd_bf16.launches += 1
    return dy, grads[:2 * H * H].view(2 * H, H), grads[2 * H * H:]


glu_res_bwd_bf16.launches = 0


def _glu_bwd_buffers(dtype, y, w, b, g):
    """Check the arguments of kernel 6 or 6f (activations of ``dtype``, the
    rest f32) and allocate dy, the f32 dz scratch (B, 2H, L) and the
    weight gradient's split-K partials and result (:func:`_wgrad_scratch`):
    returns (dy, dz, positions a split, partials, result)."""
    B, H, L = y.shape
    for t in (y, g):
        cuda_lib.check(t, (B, H, L), dtype)
    for t, shape in ((w, (2 * H, H)), (b, (2 * H,))):
        cuda_lib.check(t, shape, torch.float32)
    return (torch.empty_like(y), w.new_empty((B, 2 * H, L)),
            *_wgrad_scratch(w, B, L, 2 * H, H))


def ln_ff_res_bwd(x, m, s, w1, b1, w2, b2, g):
    """Kernel-7 wrapper (same arguments and results as
    :func:`ln_ff_res_bwd_ref`): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors; bf16 activations go to kernel 7f.  The
    kernel's products run on the tensor cores at f32 accuracy (3xTF32); H
    and F must be multiples of 8 (:func:`ff_bwd_refusal`).  A call
    launches, counted as one launch: a pass that splits W1 and the
    transposes of W1 and W2 into tf32 parts in mma fragment order into a
    scratch of its own, the 3xTF32 pass, the (dm, ds) sum, and the two
    weight-gradient contractions with their split-K sums."""
    if not x.is_cuda:
        return ln_ff_res_bwd_ref(x, m, s, w1, b1, w2, b2, g)
    if x.dtype == torch.bfloat16:
        return ln_ff_res_bwd_bf16(x, m, s, w1, b1, w2, b2, g)
    B, H, L = x.shape
    Fd = w1.shape[0]
    _raise(ff_bwd_refusal(H, Fd, torch.float32))
    P, smem = ff_bwd_plan(H, Fd)
    out, tc, ptrs, _scratch = _ff_bwd_buffers(torch.float32, P, x, m, s,
                                              w1, b1, w2, b2, g)
    wf = w1.new_empty((ff_bwd_split_floats(H, Fd),))
    cuda_lib.launch("dwst_ln_ff_res_bwd",
                    *_ptrs(x, g, w1, b1, w2, m, s, out[0]), *ptrs,
                    wf.data_ptr(), B, H, Fd, L, tc, P, smem)
    ln_ff_res_bwd.launches += 1
    return out


ln_ff_res_bwd.launches = 0


def ln_ff_res_bwd_bf16(x, m, s, w1, b1, w2, b2, g):
    """Kernel-7f wrapper (x, g and dx bf16; the weights, m, s and their
    gradients f32): the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  The per-position products run on the tensor cores,
    so H and F must be multiples of 16, H up to 1024
    (:func:`ff_bwd_refusal`).  A call launches, counted as one launch: a
    pass that rounds W1 and the transposes of W1 and W2 to bf16 into a
    scratch of its own, the tensor-core pass, the (dm, ds) sum, and the two
    weight-gradient contractions with their split-K sums."""
    if not x.is_cuda:
        return ln_ff_res_bwd_ref(x, m, s, w1, b1, w2, b2, g)
    B, H, L = x.shape
    Fd = w1.shape[0]
    _raise(ff_bwd_refusal(H, Fd, torch.bfloat16))
    P, smem = ff_bwd_bf16_plan(H, Fd)
    out, tc, ptrs, _scratch = _ff_bwd_buffers(torch.bfloat16, P, x, m, s,
                                              w1, b1, w2, b2, g)
    wb = w1.new_empty((3 * Fd * H,), dtype=torch.bfloat16)
    cuda_lib.launch("dwst_ln_ff_res_bwd_bf16",
                    *_ptrs(x, g, w1, b1, w2, m, s, out[0]), *ptrs,
                    wb.data_ptr(),
                    B, H, Fd, L, tc, P, smem)
    ln_ff_res_bwd_bf16.launches += 1
    return out


ln_ff_res_bwd_bf16.launches = 0


def _ff_bwd_buffers(dtype, P, x, m, s, w1, b1, w2, b2, g):
    """Check the arguments of kernel 7 or 7f (activations of ``dtype``, the
    rest f32) and allocate, for P positions a block, dx, one f32 tensor of
    the results after dx (each weight gradient followed by its bias
    gradient, then (dm, ds)) and one f32 scratch (xn, GELU output, dz, the (dm,
    ds) partial of each block, each weight gradient's split-K partials),
    each segment 256-byte aligned.  Returns (the wrapper's results, dx
    first; positions a weight-gradient split; the addresses of the scratch
    and results in the entries' order; the scratch, which the caller holds
    until it has launched)."""
    B, H, L = x.shape
    Fd = w1.shape[0]
    for t in (x, g):
        cuda_lib.check(t, (B, H, L), dtype)
    for t, shape in ((w1, (Fd, H)), (b1, (Fd,)), (w2, (H, Fd)), (b2, (H,)),
                     (m, (1,)), (s, (1,))):
        cuda_lib.check(t, shape, torch.float32)
    # the two contractions have the same output tiles, so the same splits
    tc, splits, _ = wgrad_plan(B, Fd, H, L, cuda_lib.sm_count(x.device))
    n1, n2 = Fd * H + Fd, H * Fd + H
    sizes = (B * H * L, B * Fd * L, B * Fd * L, 2 * B * -(-L // P),
             splits * n1, splits * n2)
    offs = [0]
    for n in sizes:
        offs.append(offs[-1] + -(-n // 64) * 64)
    scratch = w1.new_empty((offs[-1],))
    res = w1.new_empty((n1 + n2 + 2,))
    at, rp = scratch.data_ptr(), res.data_ptr()
    xn, hact, dz, stat_part, part1, part2 = (at + 4 * o for o in offs[:-1])
    ptrs = (xn, hact, dz, stat_part, rp + 4 * (n1 + n2), part1, rp, part2,
            rp + 4 * n1)
    dms = res[n1 + n2:]
    out = (torch.empty_like(x), dms[0:1], dms[1:2],
           res[:Fd * H].view(Fd, H), res[Fd * H:n1],
           res[n1:n1 + H * Fd].view(H, Fd), res[n1 + H * Fd:n1 + n2])
    return out, tc, ptrs, scratch


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
