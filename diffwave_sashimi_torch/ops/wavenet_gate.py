"""The WaveNet block's tail: gate + res/skip 1x1 convs (kernel 11).

Port of ``diffwave_sashimi_tpu/ops/wavenet_gate.py``.  After the dilated
conv, h (B, 2C, L), each WaveNet block computes

    out  = tanh(h[:, :C]) * sigmoid(h[:, C:])
    res  = (x + W_r out + b_r) * sqrt(1/2)       W_r (C, C)
    skip = W_s out + b_s                          W_s (S, C)

``gate_res_skip`` is the kernel wrapper: the CUDA kernel
(``csrc/wavenet_gate.cu``) for CUDA tensors, else ``gate_res_skip_ref``, the
plain PyTorch version (explicit formulas), which is also what the training
form differentiates: the tail has no backward kernel, in JAX either.  The
JAX ``fast=True`` form (bf16 products) waits on the bf16 policy.
"""

from __future__ import annotations

import math

import torch

from . import cuda_lib

SQRT_HALF = math.sqrt(0.5)
FAST_TODO = ("the bf16 (fast=True) form of the WaveNet tail is not ported: "
             "ROADMAP.md queue 2, entry 2 (bf16 WaveNet)")


def gate_res_skip_ref(h, x, wr, br, ws, bs, fast: bool = False):
    """(res (B, C, L), skip (B, S, L)) for h (B, 2C, L), x (B, C, L)."""
    if fast:
        raise NotImplementedError(FAST_TODO)
    C = x.shape[1]
    out = torch.tanh(h[:, :C]) * torch.sigmoid(h[:, C:])
    res = (x + torch.einsum("ck,bkl->bcl", wr, out)
           + br[None, :, None]) * SQRT_HALF
    skip = torch.einsum("sk,bkl->bsl", ws, out) + bs[None, :, None]
    return res, skip


def gate_res_skip(h, x, wr, br, ws, bs, fast: bool = False):
    """Kernel-11 wrapper: the CUDA kernel for CUDA tensors, else the plain
    version (same arguments and results)."""
    if fast:
        raise NotImplementedError(FAST_TODO)
    if not h.is_cuda:
        return gate_res_skip_ref(h, x, wr, br, ws, bs)
    B, C, L = x.shape
    S = ws.shape[0]
    if C % 8:
        raise ValueError(f"residual width {C} must be a multiple of 8 for "
                         f"the CUDA kernel (weight k-tiles of 8)")
    for t, shape in ((h, (B, 2 * C, L)), (x, (B, C, L)), (wr, (C, C)),
                     (br, (C,)), (ws, (S, C)), (bs, (S,))):
        cuda_lib.check(t, shape, torch.float32)
    if wr.data_ptr() % 16 or ws.data_ptr() % 16:
        raise ValueError("the kernel reads the weights as float4: they must "
                         "start on a 16-byte boundary")
    res = torch.empty_like(x)
    skip = x.new_empty((B, S, L))
    cuda_lib.launch("dwst_gate_res_skip", h.data_ptr(), x.data_ptr(),
                    wr.data_ptr(), br.data_ptr(), ws.data_ptr(), bs.data_ptr(),
                    res.data_ptr(), skip.data_ptr(), B, C, S, L)
    gate_res_skip.launches += 1
    return res, skip


gate_res_skip.launches = 0
