"""Fused position-wise channel-mixing branches of the DiffWave block
(kernels 2 and 3).

Ports of ``diffwave_sashimi_tpu/ops/chmix.py::mix_glu_res`` and
``::ln_ff_res`` in the flat (B, H, L) layout (channel axis 1).  The CUDA
kernels are ``csrc/chmix.cu``; :func:`glu_res_ref` and
:func:`ln_ff_res_ref` are their plain PyTorch versions, used for CPU
tensors and as the on-card comparison.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib


def glu_res_ref(y, res, w, b):
    """res + GLU over channels of (w @ y + b).  y, res: (B, H, L);
    w: (2H, H); b: (2H,)."""
    z = torch.einsum("bhl,oh->bol", y, w) + b[None, :, None]
    H = y.shape[1]
    return res + z[:, :H] * torch.sigmoid(z[:, H:])


def mix_glu_res(y, res, w, b):
    """Kernel-2 wrapper: CUDA kernel for CUDA tensors, else the plain
    version."""
    if not y.is_cuda:
        return glu_res_ref(y, res, w, b)
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


def ln_ff_res_ref(x, m, s, w1, b1, w2, b2, skip=None, emit_stats=False):
    """x + w2 @ gelu(w1 @ TLN(x) + b1) + b2 [+ skip], TLN the scalar-affine
    channel LayerNorm (population std, no eps).  With ``emit_stats`` also
    returns the output's channel mean and E[x^2] - mean^2, each (B, L).

    x, skip: (B, H, L); w1: (F, H); b1: (F,); w2: (H, F); b2: (H,);
    m, s: (1,)."""
    var, mean = torch.var_mean(x, dim=1, unbiased=False, keepdim=True)
    xn = (s / torch.sqrt(var)) * (x - mean + m)
    z = F.gelu(torch.einsum("bhl,fh->bfl", xn, w1) + b1[None, :, None])
    out = x + torch.einsum("bfl,hf->bhl", z, w2) + b2[None, :, None]
    if skip is not None:
        out = out + skip
    if not emit_stats:
        return out
    mo = out.mean(dim=1)
    return out, mo, (out * out).mean(dim=1) - mo * mo


def ln_ff_res(x, m, s, w1, b1, w2, b2, skip=None, emit_stats=False):
    """Kernel-3 wrapper: CUDA kernel for CUDA tensors, else the plain
    version (same arguments and results)."""
    if not x.is_cuda:
        return ln_ff_res_ref(x, m, s, w1, b1, w2, b2, skip, emit_stats)
    B, H, L = x.shape
    Fd = w1.shape[0]
    _check_width(H, Fd)
    args = [(x, (B, H, L)), (w1, (Fd, H)), (b1, (Fd,)), (w2, (H, Fd)),
            (b2, (H,)), (m, (1,)), (s, (1,))]
    if skip is not None:
        args.append((skip, (B, H, L)))
    for t, shape in args:
        cuda_lib.check(t, shape, torch.float32)
    out = torch.empty_like(x)
    mean = var = None
    if emit_stats:
        mean = x.new_empty((B, L))
        var = x.new_empty((B, L))
    cuda_lib.launch("dwst_ln_ff_res", x.data_ptr(),
                    None if skip is None else skip.data_ptr(),
                    w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                    b2.data_ptr(), m.data_ptr(), s.data_ptr(), out.data_ptr(),
                    None if mean is None else mean.data_ptr(),
                    None if var is None else var.data_ptr(), B, H, Fd, L)
    ln_ff_res.launches += 1
    return (out, mean, var) if emit_stats else out


ln_ff_res.launches = 0


def _check_width(*widths):
    """The kernels load weights in k-tiles of 8 channels (two float4).
    (Widths whose activation tile overflows shared memory, H > 512 for the
    FF kernel, are refused at launch.)"""
    for w in widths:
        if w % 8:
            raise ValueError(f"channel width {w} must be a multiple of 8 "
                             f"for the CUDA kernels")
