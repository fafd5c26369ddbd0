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
the residual sum in f32, res and skip rounded to bf16.
"""

from __future__ import annotations

import math

import torch

from . import cuda_lib
from .fftconv import as_operand, widen

SQRT_HALF = math.sqrt(0.5)


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
    11f."""
    if not h.is_cuda:
        return gate_res_skip_ref(h, x, wr, br, ws, bs)
    if h.dtype == torch.bfloat16:
        return gate_res_skip_bf16(h, x, wr, br, ws, bs)
    return _launch(gate_res_skip, "dwst_gate_res_skip", torch.float32, h, x,
                   wr, br, ws, bs)


gate_res_skip.launches = 0


def gate_res_skip_bf16(h, x, wr, br, ws, bs):
    """Kernel-11f wrapper (h, x and the results bf16; the weights and
    biases f32): the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if not h.is_cuda:
        return gate_res_skip_ref(h, x, wr, br, ws, bs)
    return _launch(gate_res_skip_bf16, "dwst_gate_res_skip_bf16",
                   torch.bfloat16, h, x, wr, br, ws, bs)


gate_res_skip_bf16.launches = 0


def _launch(wrapper, entry, dtype, h, x, wr, br, ws, bs):
    """Check the arguments of kernel 11 or 11f (h and x of ``dtype``, the
    weights f32), launch ``entry`` and count it on ``wrapper``."""
    B, C, L = x.shape
    S = ws.shape[0]
    if C % 8:
        raise ValueError(f"residual width {C} must be a multiple of 8 for "
                         f"the CUDA kernel (weight k-tiles of 8)")
    for t, shape in ((h, (B, 2 * C, L)), (x, (B, C, L))):
        cuda_lib.check(t, shape, dtype)
    for t, shape in ((wr, (C, C)), (br, (C,)), (ws, (S, C)), (bs, (S,))):
        cuda_lib.check(t, shape, torch.float32)
    if wr.data_ptr() % 16 or ws.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("the kernel reads the weights and x four values at "
                         "a time: they must start on a 16-byte boundary")
    res = torch.empty_like(x)
    skip = x.new_empty((B, S, L))
    cuda_lib.launch(entry, h.data_ptr(), x.data_ptr(), wr.data_ptr(),
                    br.data_ptr(), ws.data_ptr(), bs.data_ptr(),
                    res.data_ptr(), skip.data_ptr(), B, C, S, L)
    wrapper.launches += 1
    return res, skip
