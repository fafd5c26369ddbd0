"""The WaveNet block's tail: gate + res/skip 1x1 convs (kernels 11, 11f).

Port of ``diffwave_sashimi_tpu/ops/wavenet_gate.py``.  After the dilated
conv, h (B, 2C, L), each WaveNet block computes

    out  = tanh(h[:, :C]) * sigmoid(h[:, C:])
    res  = (x + W_r out + b_r) * sqrt(1/2)       W_r (C, C)
    skip = W_s out + b_s                          W_s (S, C)

``gate_res_skip`` is the kernel wrapper: the CUDA kernel
(``csrc/wavenet_gate.cu``) for CUDA tensors, else ``gate_res_skip_ref``, the
plain PyTorch version (explicit formulas), which is also what the training
form differentiates: the tail has no backward kernel, in JAX either.  bf16
activations take the JAX kernel's ``fast=True`` form, kernel 11f
(:func:`gate_res_skip_bf16`): the gate in f32 rounded to bf16, the weights
rounded to bf16 for products that accumulate in f32, the f32 biases and
the residual sum in f32, res and skip rounded to bf16.  Kernel 11f
multiplies on the tensor cores; :func:`gate_bf16_plan` sizes its tiles.
Kernel 11, the f32 form, multiplies on the tensor cores at f32 accuracy
(3xTF32: each f32 operand split into two tf32 parts, hi and lo, and a
product taken as lo hi + hi lo + hi hi with f32 sums);
:func:`gate_tf32_plan` sizes its tiles.
"""

from __future__ import annotations

import math

import torch

from . import cuda_lib
from .chmix import NT, SMEM_LIMIT, SMEM_RESERVED, SMEM_SM, ff_bwd_ld
from .fftconv import as_operand, widen

SQRT_HALF = math.sqrt(0.5)
# kernel 11f's positions a block (the P cases of csrc/wavenet_gate.cu's
# launcher), widest first, and the stacked rows one pass of its 8 warps
# computes at each (GateTile<P>::ROWS)
GATE_BF16_PS = (128, 64, 32)
GATE_BF16_ROWS = {128: 128, 64: 256, 32: 512}
# kernel 11's positions a block at one block an SM (csrc/wavenet_gate.cu's
# launcher), widest first; the (P, blocks an SM) it is also built for, most
# blocks first; and the split weight bytes a block may read from L2 per
# position at those: past 16 KB a position the reads cost more than the
# extra blocks gain (chip_smoke.py's p_ms of kernel 11 on an H100: at C
# 256, S 256, 32 KB a position at P 32, three blocks an SM lose to P 64 at
# two)
GATE_TF32_PS = (128, 64, 32, 16, 8)
GATE_TF32_SHARED = ((32, 3), (64, 2))
GATE_TF32_WEIGHT_BYTES = 16384


def gate_res_skip_ref(h, x, wr, br, ws, bs):
    """(res (B, C, L), skip (B, S, L)) for h (B, 2C, L), x (B, C, L) of one
    dtype, f32 (kernel 11's function) or bf16 (11f's); the weights and
    biases f32."""
    C = x.shape[1]
    hf = widen(h)
    out = as_operand(torch.tanh(hf[:, :C]) * torch.sigmoid(hf[:, C:]),
                     h.dtype)
    res = (widen(x) + (torch.einsum("ck,bkl->bcl", as_operand(wr, h.dtype),
                                    out) + br[None, :, None])) * SQRT_HALF
    skip = torch.einsum("sk,bkl->bsl", as_operand(ws, h.dtype), out) \
        + bs[None, :, None]
    return res.to(x.dtype), skip.to(x.dtype)


def gate_res_skip(h, x, wr, br, ws, bs):
    """Kernel-11 wrapper: the CUDA kernel for CUDA tensors, else the plain
    version (same arguments and results); bf16 activations go to kernel
    11f.  The kernel's products run on the tensor cores at f32 accuracy
    (3xTF32); C must be a multiple of 8 (:func:`gate_tf32_refusal`).  A
    call launches two kernels, counted as one launch: a pass that splits
    the stacked weight [W_r; W_s] into tf32 parts in mma fragment order
    into a scratch of its own, then the 3xTF32 kernel, sized by
    :func:`gate_tf32_plan`."""
    if not h.is_cuda:
        return gate_res_skip_ref(h, x, wr, br, ws, bs)
    if h.dtype == torch.bfloat16:
        return gate_res_skip_bf16(h, x, wr, br, ws, bs)
    B, C, L = x.shape
    S = ws.shape[0]
    refusal = gate_tf32_refusal(C, S)
    if refusal is not None:
        raise ValueError(refusal)
    for t, shape in ((h, (B, 2 * C, L)), (x, (B, C, L)), (wr, (C, C)),
                     (br, (C,)), (ws, (S, C)), (bs, (S,))):
        cuda_lib.check(t, shape, torch.float32)
    res = torch.empty_like(x)
    skip = x.new_empty((B, S, L))
    wf = x.new_empty((gate_tf32_split_floats(C, S),))
    cuda_lib.launch("dwst_gate_res_skip", h.data_ptr(), x.data_ptr(),
                    wr.data_ptr(), br.data_ptr(), ws.data_ptr(),
                    bs.data_ptr(), res.data_ptr(), skip.data_ptr(),
                    wf.data_ptr(), B, C, S, L,
                    *gate_tf32_plan(B, C, S, L, cuda_lib.sm_count(x.device)))
    gate_res_skip.launches += 1
    return res, skip


gate_res_skip.launches = 0


def gate_tf32_plan(B, C, S, L, sms=132):
    """Kernel 11's tile plan on a card of ``sms`` SMs: (P positions a
    block, blocks an SM the kernel is built for, shared-memory bytes a
    block), the grid being ceil(L / P) x B blocks.  The block keeps the
    f32 gate tile (C rows) and each of its 8 warps a 16-row f32 staging
    tile, rows of :func:`ops.chmix.ff_bwd_ld` floats.  Several blocks an
    SM hide each other's latencies, so the plan takes the first of
    GATE_TF32_SHARED whose blocks' tiles fit an SM and whose block reads at
    most GATE_TF32_WEIGHT_BYTES of split weights ((C + S) x C, 8 bytes an
    entry) per position: P 64 at two blocks at C 256, S 256; P 32 at three
    at C 128, S 256.  Else one block an SM, at the widest of GATE_TF32_PS
    whose tiles fit and whose grid fills one wave (the narrowest that fits
    if none does; the narrowest if none fits: the refusal then names the
    bytes).  S sizes no tile: the warps take the stacked rows' m-tiles in
    turns.  The kernel (``csrc/wavenet_gate.cu::
    gate_res_skip_tf32_kernel``) takes these as given: this is the one
    place they are computed."""
    for P, blocks in GATE_TF32_SHARED:
        smem = gate_tf32_smem(C, P)
        if ((C + S) * C * 8 <= GATE_TF32_WEIGHT_BYTES * P
                and blocks * (smem + SMEM_RESERVED) <= SMEM_SM):
            return P, blocks, smem
    fits = [P for P in GATE_TF32_PS
            if gate_tf32_smem(C, P) <= SMEM_LIMIT] or GATE_TF32_PS[-1:]
    P = next((P for P in fits if B * -(-L // P) >= sms), fits[-1])
    return P, 1, gate_tf32_smem(C, P)


def gate_tf32_smem(C, P):
    """Kernel 11's shared-memory bytes a block at residual width C and P
    positions (:func:`gate_tf32_plan`): the C-row gate tile and 8 warps'
    16-row staging tiles, f32 rows of ``ff_bwd_ld(P)`` floats."""
    return (C + 16 * (NT // 32)) * ff_bwd_ld(P) * 4


def gate_tf32_split_floats(C, S):
    """Floats of kernel 11's split-weight scratch: the stacked weight [W_r;
    W_s] ((C + S) x C) as ``csrc/mma_tf32.cuh`` lays it out (m-tiles of 16
    rows, zero past C + S, by k-tiles of 8, 256 floats a tile)."""
    return 256 * -(-(C + S) // 16) * (C // 8)


def gate_tf32_refusal(C, S):
    """None if kernel 11 takes residual width C and skip width S, else why
    not: C a positive multiple of 8 (its tf32 mma k-steps are 8 channels
    deep; the stacked weight's last m-tile pads with zero rows, so S may be
    anything positive), and tiles that fit one block's shared memory at
    the narrowest P (C up to 7136)."""
    if C <= 0 or C % 8:
        return (f"residual width {C} must be a multiple of 8 for the CUDA "
                f"kernel (weight k-tiles of 8)")
    if S <= 0:
        return f"kernel 11: skip width S = {S} must be positive"
    smem = gate_tf32_plan(1, C, S, 1)[2]
    if smem > SMEM_LIMIT:
        return (f"kernel 11: widths C = {C}, S = {S} need {smem} bytes of "
                f"shared memory a block, over {SMEM_LIMIT}")
    return None


def gate_bf16_plan(B, C, S, L, sms=132):
    """Kernel 11f's tile plan on a card of ``sms`` SMs: (P positions a
    block, shared-memory bytes a block), the grid being ceil(L / P) x B
    blocks.  The block keeps the bf16 gate tile (C rows padded to a
    multiple of 16) and a bf16 staging tile for one pass of stacked rows
    (GATE_BF16_ROWS[P], or all C + S padded to 16 if fewer), rows padded to
    P + 8.  Two blocks an SM overlap one block's loads and gate with the
    other's products, so P is the widest whose tiles let two blocks share
    an SM and whose grid still fills one wave of two blocks an SM (each
    block reads the whole bf16 weight from L2, so a wider P reads it less
    often per position); the narrowest of those if none fills a wave; if
    no P lets two blocks share an SM, the widest that fits one.  The kernel
    (``csrc/wavenet_gate.cu::gate_res_skip_tc_kernel``) takes these bytes
    as given: this is the one place they are computed."""
    kp, mp = 16 * -(-C // 16), 16 * -(-(C + S) // 16)

    def smem(P):
        return (kp + min(mp, GATE_BF16_ROWS[P])) * (P + 8) * 2

    two = [P for P in GATE_BF16_PS
           if 2 * (smem(P) + SMEM_RESERVED) <= SMEM_SM]
    if two:
        P = next((P for P in two if B * -(-L // P) >= 2 * sms), two[-1])
    else:
        P = next((P for P in GATE_BF16_PS if smem(P) <= SMEM_LIMIT),
                 GATE_BF16_PS[-1])
    return P, smem(P)


def gate_bf16_refusal(C, S):
    """None if kernel 11f takes residual width C and skip width S, else
    why not: C a positive multiple of 8 (kernel 11's rule too; 11f pads
    its rounded weights to 16 with zeros), S positive, and tiles that fit
    one block's shared memory at the narrowest P (C up to 2384 at any
    S)."""
    if C <= 0 or C % 8:
        return (f"kernel 11f: residual width C = {C} must be a positive "
                f"multiple of 8")
    if S <= 0:
        return f"kernel 11f: skip width S = {S} must be positive"
    smem = gate_bf16_plan(1, C, S, 1)[1]
    if smem > SMEM_LIMIT:
        return (f"kernel 11f: widths C = {C}, S = {S} need {smem} bytes of "
                f"shared memory a block, over {SMEM_LIMIT}")
    return None


def gate_res_skip_bf16(h, x, wr, br, ws, bs):
    """Kernel-11f wrapper (h, x and the results bf16; the weights and
    biases f32): the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  The kernel multiplies on the tensor cores.  A call
    launches two kernels, counted as one launch: a pass that rounds the
    stacked weight [W_r; W_s] to bf16 into a scratch of its own, then the
    tensor-core kernel, sized by :func:`gate_bf16_plan`."""
    if not h.is_cuda:
        return gate_res_skip_ref(h, x, wr, br, ws, bs)
    B, C, L = x.shape
    S = ws.shape[0]
    refusal = gate_bf16_refusal(C, S)
    if refusal is not None:
        raise ValueError(refusal)
    for t, shape in ((h, (B, 2 * C, L)), (x, (B, C, L))):
        cuda_lib.check(t, shape, torch.bfloat16)
    for t, shape in ((wr, (C, C)), (br, (C,)), (ws, (S, C)), (bs, (S,))):
        cuda_lib.check(t, shape, torch.float32)
    if wr.data_ptr() % 16 or ws.data_ptr() % 16:
        raise ValueError("the weights' rounding pass reads them four values "
                         "at a time: they must start on a 16-byte boundary")
    res = torch.empty_like(x)
    skip = x.new_empty((B, S, L))
    wf = x.new_empty((16 * -(-(C + S) // 16) * 16 * -(-C // 16),))
    P, smem = gate_bf16_plan(B, C, S, L, cuda_lib.sm_count(x.device))
    cuda_lib.launch("dwst_gate_res_skip_bf16", h.data_ptr(), x.data_ptr(),
                    wr.data_ptr(), br.data_ptr(), ws.data_ptr(),
                    bs.data_ptr(), res.data_ptr(), skip.data_ptr(),
                    wf.data_ptr(), B, C, S, L, P, smem)
    gate_res_skip_bf16.launches += 1
    return res, skip


gate_res_skip_bf16.launches = 0
