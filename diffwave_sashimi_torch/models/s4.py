"""S4 layer and NPLR kernel: sampling and training paths.

Port of ``diffwave_sashimi_tpu/models/s4.py``: ``SSKernelNPLR.__call__``
(the kernel-construction forward, without ``state`` and without the
``extend_C`` doubling for generation beyond the trained length) and the
S4 layer's fused sampling and training paths.  The layer's convolution
kernel depends only on parameters, so at sampling
:meth:`S4.compute_kernel_freq` runs once per run and its spectrum is
reused by all T steps; in training it runs in every step, differentiably
(Cauchy through kernels 4 and 8, Woodbury, bilinear fix, irfft, the
bidirectional combine and rfft in torch autograd).

Parameters keep the reference's names and its ``view_as_real`` storage of
complex tensors (trailing dim 2): ``kernel.kernel.C`` (c, H, N/2, 2),
``.B`` (1, S, N/2, 2), ``.P`` (rank, S, N/2, 2), ``.inv_w_real``,
``.w_imag`` (S, N/2), ``.log_dt`` (H,), ``D`` (1, H) and
``output_linear.0.weight`` (2H, H) / ``.bias`` (2H,).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import FUSED, Ops, hippo, widen
from ..ops.conv import TorchLinear
from ..ops.nplr import discretize, setup_C


def _c2r(x: np.ndarray) -> torch.Tensor:
    return torch.tensor(np.stack([x.real, x.imag], axis=-1),
                        dtype=torch.float32)


def _fft_size(min_n: int) -> int:
    """Next power of two >= min_n."""
    return 1 << (min_n - 1).bit_length()


def _combine_bidirectional(k: torch.Tensor, c: int, n: int) -> torch.Tensor:
    """(2c, H, L_k) forward/backward kernels -> one length-n circular kernel
    (c, H, n): the anticausal taps go at the END of the n-buffer (circular
    lag -j), as in the JAX package (models/s4.py:87-102)."""
    L_k = k.shape[-1]
    assert n >= 2 * L_k, (n, L_k)
    out = k.new_zeros(c, k.shape[1], n)
    out[..., :L_k] = k[:c]
    out[..., n - L_k:] += torch.flip(k[c:], dims=(-1,))
    return out


@functools.lru_cache(maxsize=8)
def _fft_nodes(L: int):
    """(omega, z) for the length-L kernel as host complex64 numpy, with the
    JAX package's complex64 pow accumulation: at the Nyquist node 1 + omega
    rounds to nearly 0, so z is huge, and any other way of computing the
    nodes changes the kernel there."""
    omega = (np.complex64(np.exp(-2j * np.pi / L))
             ** np.arange(L // 2 + 1, dtype=np.float32)).astype(np.complex64)
    z = (2 * (1 - omega) / (1 + omega)).astype(np.complex64)
    return omega, z


@functools.lru_cache(maxsize=16)
def _fft_nodes_on(L: int, device: torch.device):
    """:func:`_fft_nodes` as tensors on ``device``, copied there once: a
    copy from host memory blocks the host until the card's queue drains,
    and the training step builds every layer's kernel in every step."""
    omega, z = _fft_nodes(L)
    return torch.from_numpy(omega).to(device), torch.from_numpy(z).to(device)


def woodbury(r: torch.Tensor, rank: int) -> torch.Tensor:
    """Low-rank correction r00 - r01 (I + r11)^-1 r10, the blocks split off
    the last ``rank`` entries of r's first two axes (ref models/s4.py:
    765-790): closed forms for rank 1 and 2, an inverse otherwise."""
    if rank == 1:
        return r[:-1, :-1] - r[:-1, -1:] * r[-1:, :-1] / (1 + r[-1:, -1:])
    r00, r01 = r[:-rank, :-rank], r[:-rank, -rank:]
    r10, r11 = r[-rank:, :-rank], r[-rank:, -rank:]
    if rank == 2:
        det = (1 + r11[:1, :1]) * (1 + r11[1:, 1:]) - r11[:1, 1:] * r11[1:, :1]
        s = (r01[:, :1] * (1 + r11[1:, 1:]) * r10[:1]
             + r01[:, 1:] * (1 + r11[:1, :1]) * r10[1:]
             - r01[:, :1] * r11[:1, 1:] * r10[1:]
             - r01[:, 1:] * r11[1:, :1] * r10[:1]) / det
        return r00 - s
    inv = torch.linalg.inv(
        torch.eye(rank, dtype=r.dtype, device=r.device)
        + torch.movedim(r11, (0, 1), (-2, -1)))
    inv = torch.movedim(inv, (-2, -1), (0, 1))
    # blocks i, j, k, m; (h, l) carried through.  The JAX package's string
    # here repeats the output index l and raises for rank >= 3.
    return r00 - torch.einsum("ijhl,jkhl,kmhl->imhl", r01, inv, r10)


class SSKernelNPLR(nn.Module):
    """K_L(dA, dB, C~) for A = diag(w) - P P^* (HiPPO-LegS init)."""

    def __init__(self, H: int, N: int = 64, l_max: int = 1, channels: int = 1,
                 rank: int = 1, n_ssm: Optional[int] = None,
                 dt_min: float = 0.001, dt_max: float = 0.1,
                 real_tolerance: float = 1e-3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        S = n_ssm if n_ssm is not None else H
        if H % S:
            raise ValueError(f"n_ssm {S} must divide H {H}")
        self.H, self.N, self.l_max, self.rank = H, N, l_max, rank
        N2 = N // 2
        w_np, P_np, B_np = hippo.legs_nplr(N, rank, S)
        log_dt = torch.rand(H, generator=generator) * (
            math.log(dt_max) - math.log(dt_min)) + math.log(dt_min)
        self.log_dt = nn.Parameter(log_dt)
        self.B = nn.Parameter(_c2r(B_np[None]))
        self.P = nn.Parameter(_c2r(P_np))
        w_real = np.clip(w_np.real, None, -real_tolerance)
        # torch.tensor (not from_numpy) follows a default-device context, so
        # a model built under torch.device("cuda") initialises on the card
        self.inv_w_real = nn.Parameter(torch.tensor(np.log(-w_real),
                                                    dtype=torch.float32))
        self.w_imag = nn.Parameter(torch.tensor(w_np.imag,
                                                dtype=torch.float32))
        # raw C ~ CN(0, 1), stored as C~ = (I - dA^L)^* C for the trained
        # length (the reference applies this lazily on first forward)
        C = torch.randn(channels, H, N2, dtype=torch.complex64,
                        generator=generator)
        if l_max and l_max > 0:
            with torch.no_grad():
                dA, _ = discretize(self._w(), self._broadcast(
                    torch.view_as_complex(self.P), 1), self._broadcast(
                    torch.view_as_complex(self.B), 1)[0], log_dt.exp())
                C = setup_C(C, dA, l_max)
        self.C = nn.Parameter(torch.view_as_real(C).contiguous())

    def _broadcast(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Tile the n_ssm copies up to H (einops 't n -> (v t) n')."""
        reps = [1] * x.dim()
        reps[dim] = self.H // x.shape[dim]
        return x.repeat(*reps)

    def _w(self) -> torch.Tensor:
        w = torch.complex(-torch.exp(self.inv_w_real), self.w_imag)
        return self._broadcast(w, 0)

    def cauchy_operands(self):
        """The Cauchy sum's residues v ((1 + rank, channels + rank, H, N)),
        its poles w dt (H, N), and dt (H)."""
        C = torch.view_as_complex(self.C)
        B = self._broadcast(torch.view_as_complex(self.B), 1)
        P = self._broadcast(torch.view_as_complex(self.P), 1)
        v = torch.cat([B, P])[:, None] * torch.cat([C, P.conj()])[None]
        dt = torch.exp(self.log_dt)
        return v, self._w() * dt[:, None], dt

    def forward(self, L: int, ops: Ops = FUSED) -> torch.Tensor:
        """The length-L convolution kernel, (channels, H, L)."""
        internal_L = self.l_max if (self.l_max and self.l_max > 0) else L
        if L > internal_L:
            raise NotImplementedError(
                "kernels longer than the trained length need extend_C, "
                "which is not ported yet")
        omega, z = _fft_nodes_on(internal_L, self.C.device)
        v, w, dt = self.cauchy_operands()
        r = ops.cauchy(v, z, w) * dt[None, None, :, None]
        k_f = woodbury(r, self.rank) * 2 / (1 + omega)    # + bilinear fix
        k = torch.fft.irfft(k_f, n=internal_L)[..., :L]   # (1, c, H, L)
        return k[0]


class S4(nn.Module):
    """Bidirectional S4 layer.  Sampling path: fused conv (kernel 1, or
    kernel 9 for FFT sizes past kernel 1's, by the spectrum's layout) with
    the block's norm1 + step bias as prologue and D-skip + GELU as
    epilogue, then the output linear + GLU + block residual (kernel 2).
    Training path: the conv (kernels 1 and 5), D-skip and exact GELU in
    autograd, then output linear + GLU + residual (kernels 2 and 6); at
    bf16 the kernels' fast forms."""

    def __init__(self, d_model: int, d_state: int = 64, l_max: int = 1,
                 bidirectional: bool = True, rank: int = 1,
                 n_ssm: Optional[int] = None, dt_min: float = 0.001,
                 dt_max: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        H = d_model
        self.l_max, self.bidirectional = l_max, bidirectional
        self.kernel = nn.ModuleDict({"kernel": SSKernelNPLR(
            H, N=d_state, l_max=l_max, channels=2 if bidirectional else 1,
            rank=rank, n_ssm=n_ssm, dt_min=dt_min, dt_max=dt_max,
            generator=generator)})
        self.D = nn.Parameter(torch.randn(1, H, generator=generator))
        # reference key: output_linear.0 (Sequential(linear, GLU))
        self.output_linear = nn.ModuleList(
            [TorchLinear(H, 2 * H, generator=generator)])

    def compute_kernel(self, L: int, ops: Ops = FUSED) -> torch.Tensor:
        """(c, H, L_kernel) with L_kernel = min(L, l_max)."""
        L_kernel = L if not self.l_max else min(L, self.l_max)
        return self.kernel["kernel"](L_kernel, ops)

    def compute_kernel_freq(self, L: int, ops: Ops = FUSED) -> torch.Tensor:
        """(H, n/2+1) complex64 spectrum of the combined kernel at the
        power-of-two n >= L_kernel + L, L_kernel = min(L, l_max): the
        conv's input (the sampling form's through
        ``ops.sampling_spectrum``)."""
        k = self.compute_kernel(L, ops)
        n = _fft_size(k.shape[-1] + L)
        if self.bidirectional:
            k = _combine_bidirectional(k, 1, n)
        return torch.fft.rfft(k, n=n)[0]

    def forward(self, x, khat, a, c, bias, residual, ops: Ops = FUSED):
        """residual + GLU(W gelu(conv(a x + c + bias) + D (a x + c + bias)))
        for x (B, H, L); a, c (B, L) norm1 scale/shift; bias (B, H).  The
        conv takes x and residual in their dtype (f32 or bf16) and the
        prologue (a, c, bias) in f32."""
        y = ops.conv(x, a, c, widen(bias), khat, self.D[0])
        lin = self.output_linear[0]
        return ops.glu(y, residual, lin.weight, lin.bias)

    def forward_train(self, u, khat, residual, ops: Ops = FUSED):
        """residual + GLU(W gelu(conv(u) + D u)), differentiable in u, khat
        and the layer's parameters (JAX models/s4.py:664-686).  Every
        activation in u's dtype: for bf16 the conv's output is bf16, D is
        cast to bf16 and the D-skip, its add and the exact GELU run on bf16
        tensors, as in JAX."""
        y = ops.conv_train(u, khat) + self.D[0].to(u.dtype)[:, None] * u
        lin = self.output_linear[0]
        return ops.glu_train(F.gelu(y), residual, lin.weight, lin.bias)
