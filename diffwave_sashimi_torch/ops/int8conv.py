"""The int8 S4 convolution, sampling form (kernel 12).

Port of the int8 branch of ``diffwave_sashimi_tpu/ops/fftconv2.py::_kernel``
(``_conv2_impl(..., int8=True)``, the quantized factors of ``_consts_q8``),
CUDA source ``csrc/fftconv_int8.cu``.  It computes kernel 1's sampling
function (norm1/bias prologue, conv, D-skip + GELU) with the length-n DFTs
factored four-step, n = R S, and the four DFT stages as int8 x int8 ->
int32 products:

- the factor matrices (Dr, DsP, EsP, Er) are quantized per tensor, scale
  max|m| / 127, round half to even, once per (n, L) on the host
  (:func:`int8_consts`);
- each stage's input gets a fresh symmetric scale max|t| / 127 over one
  (b, h) row's stage tensor (the JAX kernel's granularity at HB = 1), and
  the int32 result is dequantized by the product of the two scales;
- twiddles, the spectrum product, the Nyquist bin (whose int8 path is
  exact) and the epilogue are f32, at both precisions (the JAX kernel's
  bf16 form also rounds each stage's output to bf16; this port keeps the
  chain f32 at bf16, as kernel 1f does).

The layout is JAX's (``default_R``, ``choose_layout``) except that S is at
least 32, since every product's contraction must be a multiple of the
tensor-core step of 32 (:func:`int8_layout`).  bf16 activations take the
bf16 path's epilogue (``gelu_fast``, bf16 out), f32 ones the exact GELU.

One departure, on the sampling path: each (b, h) row's mean over t < L is
taken out of the int8 chain and its conv added back in float, from the
window conv W that :func:`int8_spectrum` builds once per run.  The step
bias offsets every row by a constant, whose window spectrum otherwise sets
every stage's per-tensor scale: the JAX algorithm then loses ~1e-1 of the
output's max at n = 32768 and fails the int8 quality gate of BASELINE.md
at d128/n6.  Called with a bare half spectrum (no W), the function is the
JAX package's unchanged, which is what the tests hold against it.

:func:`fftconv_int8` launches the kernel for CUDA tensors, sized by
:func:`int8_plan` (threads a block, its shared-memory regions and the
stages' factor offsets, which the kernel takes as given), and runs the
plain version :func:`fftconv_int8_ref` (the integer products as float64
matmuls of the int8 values, exact at these depths) for CPU tensors.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_lib
from .fftconv import _fft_size_of, gelu_fast
from .fftconv_long import sampling_spectrum

MAX_N = 32768       # one row's staged stage tensor in a block's shared memory
MIN_S = 32          # the contraction of the iA stage; mma's k step
# the scales' order, as csrc/fftconv_int8.cu reads them
_SCALES = ("Drr", "Dri", "DsP", "EsP", "Err", "Eri", "Alt8")
_TODO = ("the int8 conv runs at kernel 1's FFT sizes (n <= 32768); the "
         "vocoder's longer convolutions (kernel 9) have no int8 form in the "
         "JAX package either")


def int8_layout(n: int, L: int):
    """(R, S, Rc) for FFT size n and L valid samples: JAX's R = max(min(256,
    n / 8), n / 256), then S = n / R raised to at least 32; Rc the next
    power of two >= ceil(L / S), within [32, R]."""
    if n & (n - 1) or not 1024 <= n <= MAX_N:
        raise ValueError(f"int8 conv: FFT size {n} must be a power of two "
                         f"in [1024, {MAX_N}]")
    R = max(min(256, n // 8), n // 256)
    S = max(n // R, MIN_S)
    R = n // S
    Rc = 1 << (-(-L // S) - 1).bit_length()
    Rc = min(max(Rc, 32), R)
    if Rc * S < L:
        raise ValueError(f"int8 conv: L = {L} does not fit n = {n}")
    return R, S, Rc


# kernel 12's shared memory (csrc/fftconv_int8.cu): int8 operand rows
# padded by PAD bytes, output-staging rows by OPAD floats; what an H100
# gives a block (static and dynamic) and an SM (each block taking 1 KB
# more); a bound on the kernel's static shared memory (its reductions)
PAD, OPAD = 16, 4
SMEM_BLOCK, SMEM_SM, SMEM_RESERVED, SMEM_STATIC = 232448, 233472, 1024, 256
# the kernel's instances, threads a block; at most 128 registers a thread
# (__launch_bounds__), so 512 threads an SM
THREADS = (128, 256, 512)
REG_THREADS = 512


class Int8Plan(NamedTuple):
    """How kernel 12 runs at one layout: threads a block, blocks an SM,
    dynamic shared-memory bytes, and the regions: A (at 0; x, then Y,
    then an output chunk), B (at ``b_off``; B, then T), F (at ``f_off``;
    the factors, stage s's at ``f_off + stage_off[s]``); S1's factor
    panels over kr (1: Dr staged once), iB's output chunk of t1 columns,
    whether Er is staged a chunk at a time, and ``prefetch`` (bit s, s
    1-3: stage s's factors copied during stage s - 1)."""
    threads: int
    blocks_per_sm: int
    smem: int
    a_bytes: int
    b_off: int
    b_bytes: int
    f_off: int
    f_bytes: int
    stage_off: tuple
    stage_bytes: tuple
    panels: int
    chunk: int
    er_chunked: bool
    prefetch: int


def int8_plan(n: int, L: int) -> Int8Plan:
    """Kernel 12's plan at FFT size n and L valid samples (refusing what
    :func:`int8_layout` refuses).  Regions: A holds max(x (S rows of Rc),
    Y (R rows of S), an output chunk of ``chunk`` t1 rows of S + OPAD
    floats, halved from Rc until it is no larger than x or Y); B
    max(B (R rows of 2S), T (2S rows of R)); F each stage's factors, Dr
    (2R rows of Rc), DsP (S of 2S), EsP (2S of S), Er (2 Rc of R), every
    int8 row padded by PAD bytes.  Threads: the fewest of
    :data:`THREADS` at which REG_THREADS / threads blocks an SM hold A, B
    and the largest stage's factors; failing that 512, with Dr in panels
    over kr and Er a chunk at a time where they do not fit.  F holds two
    consecutive stages' factors where the room allows it, stages 0 and 2
    at its start and 1 and 3 at its end, and stage s's copy then runs
    during stage s - 1."""
    R, S, Rc = int8_layout(n, L)
    x, Y = S * (Rc + PAD), R * (S + PAD)
    chunk = Rc
    while chunk > 16 and chunk * (S + OPAD) * 4 > max(x, Y):
        chunk //= 2
    A = max(x, Y, chunk * (S + OPAD) * 4)
    Bsz = max(R * (2 * S + PAD), 2 * S * (R + PAD))
    dr, er = 2 * R * (Rc + PAD), 2 * Rc * (R + PAD)
    dsp, esp = S * (2 * S + PAD), 2 * S * (S + PAD)

    def room(threads):
        blocks = REG_THREADS // threads
        return min(SMEM_BLOCK, SMEM_SM // blocks - SMEM_RESERVED) \
            - SMEM_STATIC - A - Bsz
    threads = next((t for t in THREADS if max(dr, dsp, esp, er) <= room(t)),
                   THREADS[-1])
    free = room(threads)
    panels = 1
    while dr // panels > free:
        panels *= 2
    er_chunked = er > free
    f = (dr // panels, dsp, esp, 2 * chunk * (R + PAD) if er_chunked else er)
    whole = (panels == 1, True, True, not er_chunked)
    pairs = [f[s - 1] + f[s] for s in (1, 2, 3)
             if whole[s - 1] and whole[s] and f[s - 1] + f[s] <= free]
    F = max(f + tuple(pairs))
    stage_off = tuple(0 if s % 2 == 0 else F - f[s] for s in range(4))
    prefetch = sum(1 << s for s in (1, 2, 3) if whole[s - 1] and whole[s]
                   and f[s - 1] + f[s] <= F)
    smem = A + Bsz + F
    blocks = min(REG_THREADS // threads,
                 SMEM_SM // (smem + SMEM_STATIC + SMEM_RESERVED))
    return Int8Plan(threads, blocks, smem, A, A, Bsz, A + Bsz, F, stage_off,
                    f, panels, chunk, er_chunked, prefetch)


def _quantize(m: np.ndarray):
    """The JAX package's ``_consts_q8`` for one matrix: (int8, f32 scale)."""
    s = float(np.max(np.abs(m))) / 127.0
    return np.round(m / s).astype(np.int8), np.float32(s)


@functools.lru_cache(maxsize=16)
def int8_consts(n: int, L: int):
    """The quantized factors for (n, L), as numpy: ``q`` name -> int8
    matrix in the JAX orientation (Drr, Dri (Rc, R); DsP (S, 2S); EsP
    (2S, S); Err, Eri (R, Rc)), ``scales`` name -> f32, the f32 twiddles
    ``tw`` = exp(-2 pi i t2 kr / n) and ``twm`` (its conjugate), each (S,
    R) as (real, imaginary) (the kernel reads ``tw`` too, so both compute
    the stages' values with the same f32 operations); and ``flat``, the
    int8 buffer the CUDA kernel reads: DrrT, DriT, DsP and EsP with rows
    paired (row g of a 16-row tile holds the real row, g + 8 the imaginary
    one of the same index), ErrT, EriT."""
    R, S, Rc = int8_layout(n, L)
    Q2 = S // 2
    f32 = np.float32
    t1, kr, t2 = np.arange(Rc), np.arange(R), np.arange(S)
    ks = np.arange(S // 2 + 1)
    Dr = np.exp(-2j * np.pi * np.outer(t1, kr) / R)      # (Rc, R)
    Ds = np.exp(-2j * np.pi * np.outer(ks, t2) / S)      # (Q, S)
    Es = np.exp(2j * np.pi * np.outer(t2, ks) / S)       # (S, Q)
    Er = np.exp(2j * np.pi * np.outer(kr, t1) / R)       # (R, Rc)
    Dsr2, Dsi2 = Ds.real[:Q2], Ds.imag[:Q2]
    Esr2, Esi2 = Es.real[:, :Q2], Es.imag[:, :Q2]
    alt8 = np.zeros((8, S), f32)
    alt8[0] = (-1.0) ** t2
    mats = {"Drr": Dr.real.astype(f32), "Dri": Dr.imag.astype(f32),
            "DsP": np.block([[Dsr2, -Dsi2], [Dsi2, Dsr2]]).astype(f32),
            "EsP": np.block([[Esr2, -Esi2], [Esi2, Esr2]]).astype(f32),
            "Err": Er.real.astype(f32), "Eri": Er.imag.astype(f32),
            "Alt8": alt8}
    q, scales = {}, {}
    for name, m in mats.items():
        q[name], scales[name] = _quantize(m)

    def paired(rows: int, half: int):
        """Row order putting row i (< half) and row half + i in one tile."""
        return [8 * (p // 16) + p % 8 + (half if p % 16 >= 8 else 0)
                for p in range(rows)]
    flat = np.concatenate([
        q["Drr"].T.ravel(), q["Dri"].T.ravel(),
        q["DsP"][paired(S, Q2)].ravel(), q["EsP"][paired(2 * S, S)].ravel(),
        q["Err"].T.ravel(), q["Eri"].T.ravel()])
    tw = np.exp(-2j * np.pi * np.outer(t2, kr) / n)
    return {"layout": (R, S, Rc), "q": q, "scales": scales, "flat": flat,
            "tw": (tw.real.astype(f32), tw.imag.astype(f32)),
            "twm": (tw.real.astype(f32), (-tw.imag).astype(f32))}


@functools.lru_cache(maxsize=16)
def _on_device(n: int, L: int, device: torch.device):
    """The kernel's int8 buffer, and its f32 buffer (the scales padded to
    8, then the twiddles as (re, im) pairs, [S][R]), on ``device``, copied
    once."""
    k = int8_consts(n, L)
    qs = np.zeros(8, np.float32)
    qs[:len(_SCALES)] = [k["scales"][s] for s in _SCALES]
    qs = np.concatenate([qs, np.stack(k["tw"], axis=-1).ravel()])
    return (torch.from_numpy(k["flat"]).to(device),
            torch.from_numpy(qs).to(device))


def _q8(t):
    """The JAX kernel's q8 per (b, h) row: (int values as float, scale)."""
    s = t.abs().amax(dim=(-2, -1), keepdim=True).clamp_min(1e-20) * (
        1.0 / 127.0)
    return torch.round(t * (1.0 / s)), s


def _mm8(a, b):
    """An int8 product, exact: the int32 sums are < 2^24 here."""
    return (a.double() @ b.double()).float()


def int8_spectrum(khat, L: int):
    """The int8 ops' sampling spectrum (``ops.FUSED_INT8.spectrum``): for
    kernel 1's FFT sizes, (khat, W) with W (H, L) f32 the conv of the
    window 1[t < L] by the kernel, ``irfft(rfft(1[t < L], n) khat, n)[:L]``;
    past them the exact conv's spectrum, which the int8 conv refuses."""
    n = _fft_size_of(khat)
    if n > MAX_N:
        return sampling_spectrum(khat)
    w = torch.ones(L, dtype=torch.float32, device=khat.device)
    W = torch.fft.irfft(torch.fft.rfft(w, n=n) * khat, n=n)[..., :L]
    return khat, W.contiguous()


def fftconv_int8_ref(u, a, c, bias, khat, D, W=None):
    """Plain version of kernel 12 (arguments and result as kernel 1's
    sampling form: u f32 or bf16, the rest f32, khat (H, n/2+1); W (H, L)
    the window conv, to split off each row's mean, or None).  Every
    float operation that feeds a quantizer is the kernel's, one by one, so
    the two quantize to the same codes but at rare rounding ties."""
    B, H, L = u.shape
    n = _fft_size_of(khat)
    k = int8_consts(n, L)
    R, S, Rc = k["layout"]
    Q2 = S // 2
    dev = u.device
    q = {name: torch.from_numpy(m.astype(np.float64)).to(dev)
         for name, m in k["q"].items()}
    sc = {name: float(v) for name, v in k["scales"].items()}
    twr, twi = (torch.from_numpy(m).to(dev) for m in k["tw"])
    tmr, tmi = (torch.from_numpy(m).to(dev) for m in k["twm"])

    xn = u.float() * a[:, None, :] + c[:, None, :] + bias[:, :, None]
    x = xn
    if W is not None:
        mu = (xn.double().sum(-1, keepdim=True) / L).float()
        x = xn - mu
    x = F.pad(x, (0, Rc * S - L)).reshape(B, H, Rc, S).transpose(-1, -2)
    qx, sx = _q8(x)                                       # x[t2][t1]
    Ar = _mm8(qx, q["Drr"]) * (sx * sc["Drr"])
    Ai = _mm8(qx, q["Dri"]) * (sx * sc["Dri"])
    qB, sB = _q8(torch.cat([Ar * twr - Ai * twi, Ar * twi + Ai * twr],
                           dim=-2))
    X = _mm8(q["DsP"], qB) * (sB * sc["DsP"])            # [Xr; Xi]
    kk = (torch.arange(R, device=dev)[None, :]
          + R * torch.arange(Q2, device=dev)[:, None])    # (ks, kr)
    ck = torch.where(kk == 0, 1.0 / n, 2.0 / n).float()
    Kr, Ki = ck * khat.real[:, kk], ck * khat.imag[:, kk]
    Xr, Xi = X[..., :Q2, :], X[..., Q2:, :]
    qY, sY = _q8(torch.cat([Xr * Kr - Xi * Ki, Xr * Ki + Xi * Kr], dim=-2))
    # the Nyquist bin: alt . quantized Br[:, 0], times the real spectrum
    alt = q["Alt8"][0]                                    # +-127
    xnyq = (qB[..., :S, 0].double() @ alt).float() * (
        sB[..., 0, 0] * sc["Alt8"])
    ynyq = xnyq * (khat.real[:, n // 2] * (1.0 / n))
    Z = _mm8(q["EsP"], qY) * (sY * sc["EsP"])             # [Zr; Zi]
    Zr, Zi = Z[..., :S, :].clone(), Z[..., S:, :]
    Zr[..., 0] += (alt / 127.0).float() * ynyq[..., None]
    qTr, sTr = _q8(Zr * tmr - Zi * tmi)
    qTi, sTi = _q8(Zr * tmi + Zi * tmr)
    y = (_mm8(qTr, q["Err"]) * (sTr * sc["Err"])
         - _mm8(qTi, q["Eri"]) * (sTi * sc["Eri"]))        # y[t2][t1]
    y = y.transpose(-1, -2).reshape(B, H, Rc * S)[..., :L]
    if W is not None:
        y = y + mu * W
    gelu = gelu_fast if u.dtype == torch.bfloat16 else F.gelu
    return gelu(y + D[:, None] * xn).to(u.dtype)


def fftconv_int8(u, a, c, bias, khat, D, W=None):
    """Kernel-12 wrapper: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if not u.is_cuda:
        return fftconv_int8_ref(u, a, c, bias, khat, D, W)
    B, H, L = u.shape
    n = _fft_size_of(khat)
    R, S, Rc = int8_layout(n, L)
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int8 conv: activations must be f32 or bf16, got "
                         f"{u.dtype}")
    cuda_lib.check(u, (B, H, L), u.dtype)
    for t, shape in ((a, (B, L)), (c, (B, L)), (bias, (B, H)), (D, (H,))):
        cuda_lib.check(t, shape, torch.float32)
    cuda_lib.check(khat, (H, n // 2 + 1), torch.complex64)
    if W is not None:
        cuda_lib.check(W, (H, L), torch.float32)
    qc, qs = _on_device(n, L, u.device)
    p = int8_plan(n, L)
    out = torch.empty_like(u)
    cuda_lib.launch("dwst_fftconv_int8", u.data_ptr(), a.data_ptr(),
                    c.data_ptr(), bias.data_ptr(), khat.data_ptr(),
                    D.data_ptr(), None if W is None else W.data_ptr(),
                    qc.data_ptr(), qs.data_ptr(),
                    out.data_ptr(), B, H, L, n, R, S, Rc,
                    int(u.dtype == torch.bfloat16), *plan_args(p))
    fftconv_int8.launches += 1
    return out


fftconv_int8.launches = 0


def plan_args(p: Int8Plan):
    """The plan's ints in the order ``dwst_fftconv_int8`` takes them."""
    return (p.threads, p.smem, p.b_off, p.f_off, *p.stage_off, p.panels,
            p.chunk, int(p.er_chunked), p.prefetch)


def _split(spec):
    """(khat, W) of an :func:`int8_spectrum` (a bare half spectrum: W
    None); a factorized (kernel 9) spectrum is refused."""
    if isinstance(spec, tuple):
        return spec
    if spec.dim() == 3:
        raise NotImplementedError(_TODO)
    return spec, None


def s4_conv_int8(u, a, c, bias, spec, D):
    """The sampling conv of the int8 ops (``ops.FUSED_INT8``): kernel 12
    on the spectrum of :func:`int8_spectrum`."""
    khat, W = _split(spec)
    return fftconv_int8(u, a, c, bias, khat, D, W)


def s4_conv_int8_ref(u, a, c, bias, spec, D):
    """Plain version of :func:`s4_conv_int8` (``ops.PLAIN_INT8``)."""
    khat, W = _split(spec)
    return fftconv_int8_ref(u, a, c, bias, khat, D, W)
