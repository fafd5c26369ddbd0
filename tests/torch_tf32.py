"""A plain torch model of the f32 tile products of ``csrc/mma_tf32.cuh``
(3xTF32), shared by the tests of kernels 3, 7 and 11 (f32): ``tf32``, a
model of ``cvt.rna.tf32.f32`` with the kernels' clearing of the 13 low
bits; ``split``, the hi/lo split it feeds; ``mm3``, a product taken as
the kernels take theirs (per k-step of 8, lo hi + hi lo + hi hi summed
from zero, then added to the f32 sum in k order)."""

import numpy as np
import torch
import torch.nn.functional as F


def tf32(x):
    """x (f32) rounded as the kernel's ``to_tf32``: its 13 low significand
    bits to nearest, ties away from zero (the integer add carries into the
    exponent, so subnormals, the largest finite values and signs come out
    right), the low bits cleared; inf and nan stay so."""
    u = x.contiguous().numpy().view(np.uint32)
    r = (u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return torch.from_numpy(np.where(np.isfinite(x.numpy()), r, u)
                            .astype(np.uint32).view(np.float32))


def split(x):
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi) (x - hi exact in f32)."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a, b, acc=None):
    """a (M, K) @ b (B, K, N) as the kernel's 3xTF32 products: per k-step
    of 8 (K zero-padded to a multiple of 8), lo(a) hi(b) + hi(a) lo(b) +
    hi(a) hi(b) summed from zero, then added to the f32 sum in order; the
    sum starts from ``acc`` (B, M, N) where given, as a product taken in
    pieces of k-steps carries its sums from piece to piece."""
    K = a.shape[1]
    pad = -K % 8
    a = F.pad(a, (0, pad))
    b = F.pad(b, (0, 0, 0, pad))
    ah, al = split(a)
    bh, bl = split(b)
    if acc is None:
        acc = torch.zeros(b.shape[0], a.shape[0], b.shape[2])
    for k in range(0, K + pad, 8):
        s = slice(k, k + 8)
        acc = acc + (al[:, s] @ bh[:, s] + ah[:, s] @ bl[:, s]
                     + ah[:, s] @ bh[:, s])
    return acc
