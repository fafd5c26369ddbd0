"""Port parity for SaShiMi training past FFT size 32768 (the vocoder's
``ljspeech_harder`` lengths): the long training Function
(``ops.fftconv_long.fftconv_long_train``, which ``ops.fftconv_train``
takes past kernel 1's sizes) against the JAX ``fftconv2`` custom VJP on
its ``default_R`` layout (on the CPU ``conv2_ref`` and autodiff); a plain
torch model of kernel 5L's schedule (csrc/fftconv_long.cu: the packed
real rows, the M = N1 N2 four-step transform with its twiddles, the row
pairs {k1, N1 - k1} of pass B and each bin's partner among them, the
split into the real spectrum, the batch sum in b order, the c_k scale)
against float64 and the plain version, on both of its routes: the two
passes through a scratch and, at n 2^16 and 2^17, the thread-block
cluster a channel (each block's columns, the exchange into whole row
pairs, the row phase, the split, the b-order sum, the store); their
partitions and launch sizing, read from the source; the routes
``dkf_long_plan`` gives; the wrappers' launch arguments and refusals
(kernel 9's bf16 training entry among them, which the Function now
takes for bf16 activations with no widening); and one training step of
``sashimi_small`` at L 44000 (top tier at n 2^17) against JAX.
Inputs from numpy seeds; tolerances relative to max(1, max|ref|) unless
stated."""

import importlib
import os
import re

import numpy as np
import pytest
import torch

from test_torch_common import SMALL_CFG, perturbed, port_model
from test_torch_fftconv_tc import _OnCard

import jax
import jax.numpy as jnp

from diffwave_sashimi_tpu.diffusion.schedule import \
    schedule_from_cfg as jax_schedule
from diffwave_sashimi_tpu.ops import fftconv2 as f2
from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.diffusion.loss import training_loss
from diffwave_sashimi_torch.diffusion.schedule import schedule_from_cfg
from diffwave_sashimi_torch.models import check_supported
from diffwave_sashimi_torch.ops import cuda_lib
from diffwave_sashimi_torch.utils.jax_compat import params_from_jax

# the module (ops.fftconv_long is kernel 9's contract wrapper)
fl = importlib.import_module("diffwave_sashimi_torch.ops.fftconv_long")

BF = torch.bfloat16
C64 = torch.complex64
CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "diffwave_sashimi_torch", "csrc")
# (L, n): the two FFT sizes past kernel 1's that the shipped configs train
# at (ljspeech_harder's top tier, L 44000, n 2^17) or that 9f's cluster
# route serves (n 2^16)
LONG_CASES = [(30000, 1 << 16), (44000, 1 << 17)]
# at bf16 both sides round the conv and its input gradient to bf16 (the
# port's transforms f32, JAX's conv2_ref f32 on the CPU): kernel 1f's bar;
# the spectrum gradient, pulled back to the time-domain kernel, at kernel
# 5f's (tests/test_torch_bf16_train.py)
TOL_CONV_BF16, TOL_DKF_BF16 = 1.5e-2, 1e-2


def _src_int(name, src="fftconv_long.cu"):
    with open(os.path.join(CSRC, src)) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             f.read()).group(1))


TC, ROW_THREADS = _src_int("TC"), _src_int("ROW_THREADS")
VPT = _src_int("VPT", "fft_stockham.cuh")
CLUSTER_THREADS = _src_int("CLUSTER_THREADS")
CLUSTER_VALUES = _src_int("CLUSTER_VALUES")
DKF_CLUSTER = _src_int("DKF_CLUSTER")


def _bound(out, ref, tol):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    err = np.abs(out - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), (err,
                                                      np.abs(ref).max())


# ---- the Function against JAX's custom VJP --------------------------------

@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("L,n", LONG_CASES)
def test_long_train_matches_jax_fftconv2_vjp(L, n, bf16):
    """y, du and dk of the port's training conv (routed past kernel 1's
    sizes to the long Function) vs JAX ``fftconv2`` on
    ``choose_layout(L, n, H, R=default_R(n))`` and its VJP, both pulled
    back to the time-domain kernel k (JAX through kernel_spectrum(k, lay),
    the port through rfft(k, n)): 1e-4 at f32; at bf16 TOL_CONV_BF16 for
    y and du, TOL_DKF_BF16 for dk."""
    B, H = 2, 8
    rng = np.random.RandomState(L + bf16)
    u = rng.randn(B, H, L).astype(np.float32)
    g = rng.randn(B, H, L).astype(np.float32)
    k = (0.05 * rng.randn(H, n)).astype(np.float32)
    dtype = BF if bf16 else torch.float32
    tu, tg = (torch.from_numpy(a).to(dtype) for a in (u, g))
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    ju, jg = (jnp.asarray(t.float().numpy()).astype(jdt) for t in (tu, tg))
    lay = f2.choose_layout(L, n, H, R=f2.default_R(n), bf16=bf16)

    def conv(uu, kk):
        kfr, kfi = f2.kernel_spectrum(kk, lay)
        return f2.from_compact(f2.fftconv2(f2.to_compact(uu, lay), kfr, kfi,
                                           lay, bf16), lay, L)
    y_ref, vjp = jax.vjp(conv, ju, jnp.asarray(k))
    du_ref, dk_ref = vjp(jg)

    tu.requires_grad_(True)
    tk = torch.from_numpy(k).requires_grad_(True)
    before = {name: fn.launches for name, fn in ops.COUNTED.items()}
    y = ops.fftconv_train(tu, torch.fft.rfft(tk, n=n))
    assert type(y.grad_fn).__name__ == "_FFTConvLongTrainBackward"
    assert y.dtype == dtype and tuple(y.shape) == (B, H, L)
    y.backward(tg)
    assert {name: fn.launches for name, fn in ops.COUNTED.items()} == before
    tol_y = TOL_CONV_BF16 if bf16 else 1e-4
    _bound(y.detach().float().numpy(), np.asarray(y_ref, np.float32), tol_y)
    _bound(tu.grad.float().numpy(), np.asarray(du_ref, np.float32), tol_y)
    _bound(tk.grad.numpy(), np.asarray(dk_ref),
           TOL_DKF_BF16 if bf16 else 1e-4)


def test_long_train_is_autograd_of_the_plain_conv():
    """At n 2^17 on the CPU the Function's y, du and dkhat equal torch
    autograd of ``fftconv_ref`` to f32 roundoff (the plain versions it
    runs are that conv and its two adjoints)."""
    B, H, L, n = 2, 3, 44000, 1 << 17
    rng = np.random.RandomState(5)
    u = torch.from_numpy(rng.randn(B, H, L).astype(np.float32))
    g = torch.from_numpy(rng.randn(B, H, L).astype(np.float32))
    khat = torch.fft.rfft(torch.from_numpy(
        (0.05 * rng.randn(H, n)).astype(np.float32)), n=n)
    outs = []
    for fn in (fl.fftconv_long_train, ops.fftconv_ref):
        uu, kk = u.clone().requires_grad_(True), khat.clone().requires_grad_(
            True)
        y = fn(uu, kk)
        y.backward(g)
        outs.append((y.detach(), uu.grad, kk.grad))
    for mine, ref in zip(*outs):
        scale = float(ref.abs().max())
        assert float((mine - ref).abs().max()) <= 1e-5 * max(1.0, scale)


# ---- kernel 5L's schedule --------------------------------------------------

def _split(M):
    l = M.bit_length() - 1
    return 1 << (l // 2), 1 << (l - l // 2)


def _dkf_row(p, side, N1):
    """csrc dkf_row: the row of slot side of pair p."""
    return np.where(side == 0, p, np.where(p == 0, N1 // 2, N1 - p))


def _rpb(N2):
    """Pass B's rows a block of each of u and g (2 rpb N2 = ROW_THREADS
    VPT)."""
    return ROW_THREADS * VPT // (2 * N2)


def _pair_bins(p0, q, k2, M, N1):
    """The bin of u slot q (the row dkf_row(p0 + q/2, q % 2)) at k2 in a
    block whose pairs start at p0, as the kernels find it: its k1 and k,
    its partner M - k's (k1r, k2r), the slot qr that holds the partner's
    row in the block, and the row that slot holds."""
    k1 = _dkf_row(p0 + q // 2, q & 1, N1)
    k = k1 + N1 * k2
    kr = (M - k) & (M - 1)
    k1r, k2r = kr & (N1 - 1), kr // N1
    qr = np.where(k1r == k1, q, q ^ 1)
    return dict(k1=k1, k=k, k1r=k1r, k2r=k2r, qr=qr,
                slot_row=_dkf_row(p0 + qr // 2, qr & 1, N1))


def _bins(n):
    """Pass B's bins in the kernel's order: for each block x and element i
    = tid + e ROW_THREADS of its u slots, (k1, k2) of the bin, (k1r, k2r)
    of its partner M - k, and the slot rows of both in the block, all as
    arrays over (x, e, tid)."""
    M = n // 2
    N1, N2 = _split(M)
    rpb = _rpb(N2)
    x = np.arange(N1 // rpb)[:, None, None]
    i = (np.arange(ROW_THREADS)[None, None, :]
         + ROW_THREADS * np.arange(VPT // 2)[None, :, None])
    q, k2 = i // N2, i % N2
    b = _pair_bins(x * (rpb // 2), q, k2, M, N1)
    out = dict(k=b["k"], k1=b["k1"], k2=k2, k1r=b["k1r"], k2r=b["k2r"],
               slot_row=b["slot_row"])
    shape = np.broadcast_shapes(*(a.shape for a in out.values()))
    return dict({s: np.broadcast_to(a, shape).copy() for s, a in
                 out.items()}, M=M, N1=N1, N2=N2)


def _twiddle(m, M, dtype):
    """exp(-2 pi i m / M), once rounded (the kernel's sincospif)."""
    a = torch.from_numpy(np.asarray(m, np.float64) * (2.0 / M)) * np.pi
    return torch.polar(torch.ones_like(a), -a).to(dtype)


def _model(u, g, n, cdt=C64):
    """Kernel 5L's schedule in torch, complex ``cdt`` throughout: pass A's
    packed rows and column transforms times W_M^(n2 k1), pass B's row
    transforms, each bin split from its partner's slot, the products added
    in b order, the c_k scale; the Nyquist bin from bin 0's thread."""
    B, H, L = u.shape
    rdt = torch.float32 if cdt == C64 else torch.float64
    bins = _bins(n)
    M, N1, N2 = bins["M"], bins["N1"], bins["N2"]

    def spectrum(x):              # pass A and the row FFTs: (B, H, N1, N2)
        xp = torch.zeros(B, H, n, dtype=rdt)
        xp[..., :min(L, n)] = x[..., :n].to(rdt)
        z = torch.complex(xp[..., 0::2], xp[..., 1::2]).reshape(B, H, N1, N2)
        a = torch.fft.fft(z, dim=2)                       # [k1, n2]
        a = a * _twiddle(np.arange(N1)[:, None] * np.arange(N2)[None, :], M,
                         cdt)
        return torch.fft.fft(a, dim=3)                    # [k1, k2]
    Zu, Zg = spectrum(u), spectrum(g)
    k1, k2, k1r, k2r = (torch.from_numpy(bins[s].ravel())
                        for s in ("k1", "k2", "k1r", "k2r"))
    k = torch.from_numpy(bins["k"].ravel())
    w = _twiddle(bins["k"].ravel(), n, cdt)

    def split(a, c):
        e = torch.complex(0.5 * (a.real + c.real), 0.5 * (a.imag - c.imag))
        o = torch.complex(0.5 * (a.imag + c.imag), -0.5 * (a.real - c.real))
        return e + w * o
    acc = torch.zeros(H, k.numel(), dtype=cdt)
    nyq = torch.zeros(H, dtype=rdt)
    for b in range(B):
        xu = split(Zu[b][:, k1, k2], Zu[b][:, k1r, k2r])
        xg = split(Zg[b][:, k1, k2], Zg[b][:, k1r, k2r])
        acc = acc + xu.conj() * xg
        zu, zg = Zu[b][:, 0, 0], Zg[b][:, 0, 0]
        nyq = nyq + (zu.real - zu.imag) * (zg.real - zg.imag)
    out = torch.zeros(H, M + 1, dtype=cdt)
    c = torch.where(k == 0, 1.0 / n, 2.0 / n).to(rdt)
    out[:, k] = acc * c
    out[:, M] = (nyq / n).to(cdt)
    return out


def _l2(out, wide):
    return float((out.to(torch.complex128) - wide).abs().norm()
                 / wide.abs().norm())


# (B, H, L, n): the shipped sizes (n 2^16 and 2^17), an odd L at n 2^18,
# and 5L's largest, n 2^20, with L past n/2
SCHEDULE_CASES = [(4, 2, 30000, 1 << 16), (2, 2, 44000, 1 << 17),
                  (3, 1, 70001, 1 << 18), (1, 1, 600000, 1 << 20)]


@pytest.mark.parametrize("B,H,L,n", SCHEDULE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_schedule_model_vs_float64_and_plain(B, H, L, n, dtype):
    """The schedule's result on f32 and bf16 inputs (g 1e-3 the scale of
    u: the two rows' transforms keep their own scales) against float64:
    its relative L2 error at most twice the plain version's, within 1e-4
    of the plain version, and the DC and Nyquist bins real; the same
    schedule in float64 equals float64 to 1e-12."""
    rng = np.random.RandomState(n + B)
    u = torch.from_numpy(rng.randn(B, H, L).astype(np.float32)).to(dtype)
    g = torch.from_numpy((1e-3 * rng.randn(B, H, L)).astype(
        np.float32)).to(dtype)
    wide = ops.fftconv_dkf_ref(u.double(), g.double(), n)
    plain = ops.fftconv_dkf_ref(u, g, n)
    out = _model(u, g, n)
    assert out.shape == (H, n // 2 + 1) and out.dtype == C64
    assert _l2(out, wide) <= 2 * _l2(plain, wide)
    assert float((out - plain).abs().max()) <= 1e-4 * float(
        plain.abs().max())
    assert float(out[:, 0].imag.abs().max()) == 0.0
    assert float(out[:, -1].imag.abs().max()) == 0.0
    assert _l2(_model(u, g, n, torch.complex128), wide) <= 1e-12


@pytest.mark.parametrize("n", [1 << s for s in range(16, 21)])
def test_pass_b_bins_cover_the_spectrum_once(n):
    """At every size 5L takes, pass B's blocks own each bin k of 0 .. M-1
    once, and each bin's partner M - k lies in a slot of the same block
    (its own row, or the other row of its pair)."""
    b = _bins(n)
    assert np.array_equal(np.sort(b["k"].ravel()), np.arange(b["M"]))
    assert np.array_equal(b["slot_row"], b["k1r"])


@pytest.mark.parametrize("n", [1 << s for s in range(16, 21)])
def test_launch_sizing_at_every_size(n):
    """The launcher's sizes (csrc launch_dkf_long, constants read from the
    source): pass A TC columns of the N1-point transforms, at most 1024
    threads and within a block's shared memory; pass B 2 rpb rows of
    N2 values = ROW_THREADS VPT, whole pairs a block (N1/2 pairs, rpb/2 a
    block), VPT / 2 bins a thread, within 48 KB."""
    N1, N2 = _split(n // 2)
    assert 128 <= N1 <= N2 <= 1024 and N2 % TC == 0
    assert TC * N1 // VPT <= 1024
    assert TC * (N1 + N1 // 32 + 1) * 8 <= 232448
    rpb = _rpb(N2)
    assert rpb >= 2 and rpb % 2 == 0 and (N1 // 2) % (rpb // 2) == 0
    assert 2 * rpb * N2 == ROW_THREADS * VPT
    assert 2 * rpb * (N2 + N2 // 32 + 1) * 8 <= 48 * 1024
    assert (N1 // rpb) * ROW_THREADS * (VPT // 2) == n // 2


# ---- kernel 5L's cluster route ---------------------------------------------

def _geometry(n):
    """csrc dkf_cluster_kernel's constants at FFT size n, C = DKF_CLUSTER
    blocks a cluster (NT threads a block, VPT values a thread)."""
    M, C = n // 2, DKF_CLUSTER
    N1, N2 = _split(M)
    NT = n // (C * VPT)
    cols, rows = N2 // C, N1 // C
    span = 2 * cols
    return dict(M=M, N1=N1, N2=N2, C=C, NT=NT, COLS=cols, ROWS=rows,
                PAIRS=rows // 2, SPAN=span, KS=NT // span, CV=VPT,
                BINS=rows * N2 // NT)


def _grid(d, per):
    """(j, tid, e) index arrays over the C blocks, the block's NT threads
    and ``per`` values a thread."""
    return (np.arange(d["C"])[:, None, None],
            np.arange(d["NT"])[None, :, None],
            np.arange(per)[None, None, :])


def _exchange(n):
    """The exchange of the kernel, as flat arrays over (block j, tid, value
    e): the column c and row k1 a thread reads (s 0 u, 1 g; n2 its
    position), and the block, row slot and position it stores to."""
    d = _geometry(n)
    j, tid, e = _grid(d, d["CV"])
    c, k1 = tid % d["SPAN"], tid // d["SPAN"] + e * d["KS"]
    n2 = j * d["COLS"] + c % d["COLS"]
    side = (k1 >= d["N1"] // 2).astype(int)
    p = np.where(side == 1, np.where(k1 == d["N1"] // 2, 0, d["N1"] - k1),
                 k1)
    slot = np.where(c < d["COLS"], 0, d["ROWS"]) + 2 * (p % d["PAIRS"]) \
        + side
    out = dict(j=j, s=c // d["COLS"], k1=k1, n2=n2, dest=p // d["PAIRS"],
               slot=slot)
    shape = np.broadcast_shapes(*(a.shape for a in out.values()))
    return {key: np.broadcast_to(a, shape).flatten() for key, a in
            out.items()}


def _owned_bins(n):
    """The split's bins, flat over (block j, tid, e): the u slot q and k2 of
    the bin a thread owns, its k, and its partner's slot and k2."""
    d = _geometry(n)
    j, tid, e = _grid(d, d["BINS"])
    i = tid + e * d["NT"]
    q, k2 = i // d["N2"], i % d["N2"]
    b = _pair_bins(j * d["PAIRS"], q, k2, d["M"], d["N1"])
    out = dict(j=j, q=q, k2=k2, k=b["k"], qr=b["qr"], k2r=b["k2r"],
               k1r=b["k1r"], qr_row=b["slot_row"])
    shape = np.broadcast_shapes(*(a.shape for a in out.values()))
    return {key: np.broadcast_to(a, shape).flatten() for key, a in
            out.items()}


def _stored_bins(n):
    """The store after the batch, flat over (block j, tid, e): the u slot
    and k2 a thread reads, and the bin k it writes."""
    d = _geometry(n)
    j, tid, e = _grid(d, d["BINS"])
    i = tid + e * d["NT"]
    r, k2 = i % d["ROWS"], i // d["ROWS"]
    q = np.where(r < d["PAIRS"], 2 * r, 2 * (d["ROWS"] - 1 - r) + 1)
    k = _dkf_row(j * d["PAIRS"] + q // 2, q & 1, d["N1"]) + d["N1"] * k2
    shape = np.broadcast_shapes(j.shape, q.shape, k2.shape, k.shape)
    return {key: np.broadcast_to(a, shape).flatten() for key, a in
            dict(j=j, q=q, k2=k2, k=k).items()}


def _column_twiddles(n, cdt):
    """W_M^(n2 k1) as the exchange forms it, (N1, N2): once rounded at
    every 8th value of a thread (k1 = k10 + e KS, e % 8 == 0), times the
    once-rounded step W_M^(KS n2) in between."""
    d = _geometry(n)
    n2 = torch.arange(d["N2"], dtype=torch.float64)
    step = _twiddle(d["KS"] * n2.numpy(), d["M"], cdt)
    tw = torch.zeros(d["N1"], d["N2"], dtype=cdt)
    for e in range(d["CV"]):
        k1 = np.arange(d["KS"]) + e * d["KS"]
        if e % 8 == 0:
            cur = _twiddle(k1[:, None] * np.arange(d["N2"])[None, :], d["M"],
                           cdt)
        tw[k1] = cur
        cur = cur * step
    return tw


def _cluster_model(u, g, n, cdt=C64):
    """Kernel 5L's cluster route in torch, complex ``cdt`` throughout:
    for
    b in order, each block's columns of the packed u_b and g_b (zero past
    L), their N1-point transforms times the exchange's twiddles, the
    exchange's stores into the blocks' row slots, the N2-point row
    transforms, each owned bin split from its partner's slot and added to
    its sum; then the c_k scale and the store's map.  The Nyquist bin from
    bin 0's thread."""
    B, H, L = u.shape
    d = _geometry(n)
    M, N1, N2, C, ROWS = d["M"], d["N1"], d["N2"], d["C"], d["ROWS"]
    rdt = torch.float32 if cdt == C64 else torch.float64
    ex, own, st = _exchange(n), _owned_bins(n), _stored_bins(n)
    tw = _column_twiddles(n, cdt)
    w = _twiddle(own["k"], n, cdt)

    def packed(x):
        xp = torch.zeros(H, n, dtype=rdt)
        xp[:, :min(L, n)] = x[:, :n].to(rdt)
        return torch.complex(xp[:, 0::2], xp[:, 1::2]).reshape(H, N1, N2)

    def split(a, c):
        e = torch.complex(0.5 * (a.real + c.real), 0.5 * (a.imag - c.imag))
        o = torch.complex(0.5 * (a.imag + c.imag), -0.5 * (a.real - c.real))
        return e + w * o
    acc = torch.zeros(H, own["k"].size, dtype=cdt)
    nyq = torch.zeros(H, dtype=rdt)
    for b in range(B):
        cols = torch.stack([torch.fft.fft(packed(x[b]), dim=1) * tw
                            for x in (u, g)], dim=1)     # (H, s, k1, n2)
        rows = torch.zeros(H, C, 2 * ROWS, N2, dtype=cdt)
        rows[:, ex["dest"], ex["slot"], ex["n2"]] = cols[:, ex["s"],
                                                         ex["k1"], ex["n2"]]
        rows = torch.fft.fft(rows, dim=3)                # (H, j, slot, k2)
        jj = own["j"]
        xu = split(rows[:, jj, own["q"], own["k2"]],
                   rows[:, jj, own["qr"], own["k2r"]])
        xg = split(rows[:, jj, own["q"] + ROWS, own["k2"]],
                   rows[:, jj, own["qr"] + ROWS, own["k2r"]])
        acc = acc + xu.conj() * xg
        zu, zg = rows[:, 0, 0, 0], rows[:, 0, ROWS, 0]
        nyq = nyq + (zu.real - zu.imag) * (zg.real - zg.imag)
    c = torch.where(torch.from_numpy(own["k"]) == 0, 1.0 / n, 2.0 / n)
    staged = torch.zeros(H, C, ROWS, N2, dtype=cdt)
    staged[:, own["j"], own["q"], own["k2"]] = acc * c.to(rdt)
    out = torch.zeros(H, M + 1, dtype=cdt)
    out[:, st["k"]] = staged[:, st["j"], st["q"], st["k2"]]
    out[:, M] = (nyq / n).to(cdt)
    return out


# (B, H, L, n): the shipped sizes, odd L, and L = n (no zero past L)
CLUSTER_CASES = [(4, 2, 30000, 1 << 16), (2, 2, 44000, 1 << 17),
                 (3, 1, 20001, 1 << 16), (1, 2, 43999, 1 << 17),
                 (2, 1, 1 << 16, 1 << 16), (1, 1, 1 << 17, 1 << 17),
                 (2, 1, 32769, 1 << 16)]


@pytest.mark.parametrize("B,H,L,n", CLUSTER_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_cluster_model_vs_float64_and_plain(B, H, L, n, dtype):
    """The cluster route's schedule on f32 and bf16 inputs at the shipped
    sizes (and odd L, and L = n), g 1e-3 the scale of u, against float64:
    the bars of
    ``test_schedule_model_vs_float64_and_plain`` (its relative L2 error at
    most twice the plain version's, within 1e-4 of the plain version, the
    DC and Nyquist bins real, the same schedule in float64 equal to
    float64 to 1e-12)."""
    rng = np.random.RandomState(n + B + 7)
    u = torch.from_numpy(rng.randn(B, H, L).astype(np.float32)).to(dtype)
    g = torch.from_numpy((1e-3 * rng.randn(B, H, L)).astype(
        np.float32)).to(dtype)
    wide = ops.fftconv_dkf_ref(u.double(), g.double(), n)
    plain = ops.fftconv_dkf_ref(u, g, n)
    out = _cluster_model(u, g, n)
    assert out.shape == (H, n // 2 + 1) and out.dtype == C64
    assert _l2(out, wide) <= 2 * _l2(plain, wide)
    assert float((out - plain).abs().max()) <= 1e-4 * float(
        plain.abs().max())
    assert float(out[:, 0].imag.abs().max()) == 0.0
    assert float(out[:, -1].imag.abs().max()) == 0.0
    assert _l2(_cluster_model(u, g, n, torch.complex128), wide) <= 1e-12


@pytest.mark.parametrize("n", fl.DKF_CLUSTER_NS)
def test_cluster_partition_and_exchange(n):
    """On the cluster route: the exchange moves every (u or g, k1, n2)
    value once and fills every row slot of every block once (a
    bijection), each value into the slot of its own row k1; the blocks'
    threads own each bin k of 0 .. M-1 once, with its partner M - k in a
    slot of the same block; the store writes each bin once, the one its
    slot holds."""
    d = _geometry(n)
    ex = _exchange(n)
    src = (ex["s"] * d["N1"] + ex["k1"]) * d["N2"] + ex["n2"]
    assert np.array_equal(np.sort(src), np.arange(2 * d["M"]))
    dst = (ex["dest"] * 2 * d["ROWS"] + ex["slot"]) * d["N2"] + ex["n2"]
    assert np.array_equal(np.sort(dst), np.arange(2 * d["M"]))
    # each source block sends its own columns, each slot holds its row
    assert np.array_equal(ex["n2"] // d["COLS"], ex["j"])
    q = ex["slot"] % d["ROWS"]
    assert np.array_equal(ex["s"], ex["slot"] // d["ROWS"])
    assert np.array_equal(
        _dkf_row(ex["dest"] * d["PAIRS"] + q // 2, q & 1, d["N1"]),
        ex["k1"])
    own = _owned_bins(n)
    assert np.array_equal(np.sort(own["k"]), np.arange(d["M"]))
    assert np.array_equal(own["qr_row"], own["k1r"])
    assert (own["q"] < d["ROWS"]).all() and (own["qr"] < d["ROWS"]).all()
    st = _stored_bins(n)
    assert np.array_equal(np.sort(st["k"]), np.arange(d["M"]))
    held = own["k"][np.argsort((own["j"] * d["ROWS"] + own["q"]) * d["N2"]
                               + own["k2"])]
    at = (st["j"] * d["ROWS"] + st["q"]) * d["N2"] + st["k2"]
    assert np.array_equal(held[at], st["k"])


@pytest.mark.parametrize("n", fl.DKF_CLUSTER_NS)
def test_cluster_sizing_read_from_the_source(n):
    """The cluster route's sizes, constants read from the source: clusters
    of DKF_CLUSTER = 8 blocks (the portable size, the plan's), so blocks of
    512 threads and 8192 values at n 2^16 (two an SM) and of 1024 and
    16384 at 2^17 (one an SM), VPT values a thread; each block's 2 COLS
    column transforms and 2 ROWS row transforms (whole pairs) its threads
    at N / 16 a transform; the source's instance at n is
    dkf_cluster_at<N1, N2, T> of split(n / 2), its threads n / (8 VPT);
    its shared memory, as the source's dkf_cluster_slots and
    dkf_cluster_smem compute it (the transforms' slots and the sums of the
    block's bins, at N + 1 slots an N-point row), within a block's 227 KB
    and, at two blocks an SM, two within the SM's 228 KB with 1 KB
    reserved a block."""
    assert (CLUSTER_VALUES, CLUSTER_THREADS) == (16384, 1024)
    assert DKF_CLUSTER == 8 and fl.DKF_CLUSTER.cluster == DKF_CLUSTER
    d = _geometry(n)
    assert d["NT"] * VPT * DKF_CLUSTER == n
    assert d["NT"] == {1 << 16: 512, 1 << 17: 1024}[n]
    assert 2 * d["COLS"] * d["N1"] == 2 * d["ROWS"] * d["N2"] == \
        d["NT"] * VPT
    assert 2 * d["COLS"] * (d["N1"] // VPT) == d["NT"]
    assert 2 * d["ROWS"] * (d["N2"] // VPT) == d["NT"]
    assert d["ROWS"] % 2 == 0 and d["KS"] * d["CV"] == d["N1"]
    assert d["COLS"] % 16 == 0 and d["BINS"] * d["NT"] == \
        d["ROWS"] * d["N2"]
    with open(os.path.join(CSRC, "fftconv_long.cu")) as f:
        src = f.read()
    case = re.search(rf"case 1 << {n.bit_length() - 1}: return "
                     rf"dkf_cluster_at<(\d+), (\d+), T>\(\);", src)
    assert case and tuple(map(int, case.groups())) == (d["N1"], d["N2"])
    assert "constexpr int NT = 2 * N1 * N2 / (DKF_CLUSTER * CV);" in src
    assert re.search(
        r"constexpr int cols = 2 \* \(N2 / C\) \* Swz::stride\(N1\);\s*"
        r"constexpr int rows = 2 \* \(N1 / C\) \* Swz::stride\(N2\);\s*"
        r"return cols > rows \? cols : rows;", src)
    assert "return 8 * (dkf_cluster_slots<N1, N2, NT>() + (N1 / C) * " \
        "Swz::stride(N2));" in src
    smem = 8 * (max(2 * d["COLS"] * (d["N1"] + 1),
                    2 * d["ROWS"] * (d["N2"] + 1))
                + d["ROWS"] * (d["N2"] + 1))
    assert smem <= 232448
    per_sm = CLUSTER_THREADS // d["NT"]
    assert per_sm * (smem + 1024) <= 228 * 1024


def test_dkf_long_plan_routes():
    """dkf_long_plan by n alone: the cluster route in clusters of 8, the
    portable size, at n 2^16 (blocks of 8192 values, two an SM) and 2^17
    (16384, one an SM), the two passes at 2^18, 2^19 and 2^20."""
    assert [fl.dkf_long_plan(1 << s) for s in (16, 17)] == [
        ("cluster", 8)] * 2
    assert all(fl.dkf_long_plan(1 << s) == fl.DKF_TWO_PASS
               for s in (18, 19, 20))
    assert fl.DKF_TWO_PASS == ("two_pass", 0)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(CSRC), os.pardir,
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_reports_5l_instances_under_5l():
    """chip_smoke.py's kernels line: kernel 5L's entry carries ptxas's
    reports of its own instances, KERNEL_5L (its two passes and the
    cluster kernel's instance at each n of the cluster route, <N1, N2, NT>
    as the source sizes it, by input type), and no other; kernels 5 and
    5f's entry the radix-16 route's; kernel 9's training entry lists its
    three passes."""
    smoke = _chip_smoke()
    cluster = [f"dkf_cluster_kernel<{d['N1']}, {d['N2']}, {d['NT']}, {t}>"
               for d in map(_geometry, fl.DKF_CLUSTER_NS)
               for t in ("float", "bf16")]
    assert smoke.KERNEL_5L == ("dkf_cols_kernel<float>",
                               "dkf_cols_kernel<bf16>", "dkf_rows_kernel",
                               *cluster)
    r16 = "fftconv_dkf_r16_kernel<16384, 1, float>"
    ptxas = {k: {"registers": 64, "spill_bytes": 0}
             for k in smoke.KERNEL_5L + (r16, "cauchy_fwd_kernel<4>")}
    parts = smoke.kernel_parts("fftconv_dkf_long", ptxas)
    assert list(parts["ptxas"]) == list(smoke.KERNEL_5L)
    assert parts["global_kernels"] == ["dkf_cluster_kernel",
                                       "dkf_cols_kernel", "dkf_rows_kernel"]
    assert list(smoke.kernel_parts("fftconv_dkf", ptxas)["ptxas"]) == [r16]
    assert smoke.kernel_parts("fftconv_long", ptxas) == {
        "global_kernels": ["cols_fwd_kernel", "rows_kernel",
                           "cols_inv_kernel"]}


# ---- the wrappers ----------------------------------------------------------

@pytest.mark.parametrize("n", [1 << 16, 1 << 17, 1 << 18])
@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_dkf_long_wrapper_passes_its_signature(monkeypatch, dtype, n):
    """Kernel 5L's wrapper hands its entry (by dtype) exactly the
    arguments its ctypes signature names, the stream apart, and counts one
    launch: on the cluster route (n 2^16, 2^17) no scratch (a null
    pointer, no allocation) and the plan's 8 blocks a cluster, on the two
    passes (n 2^18, or by a plan override) a scratch and 0; kernel
    9's training entries pass conj 0 and 1, the f32 entry for f32 u and
    the bf16 one for bf16 u, whose output is bf16."""
    calls = []
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *a: calls.append(
        (name, a)))
    monkeypatch.setattr(cuda_lib, "check", lambda *a: None)
    B, H, L = 2, 4, 44000
    u = torch.zeros(B, H, L, dtype=dtype).as_subclass(_OnCard)
    plan = fl.dkf_long_plan(n)
    before = ops.fftconv_dkf_long.launches
    out = ops.fftconv_dkf_long(u, u, n)
    assert tuple(out.shape) == (H, n // 2 + 1) and out.dtype == C64
    assert ops.fftconv_dkf_long.launches == before + 1
    name, args = calls[-1]
    assert name == ("dwst_fftconv_dkf_long_bf16" if dtype == BF
                    else "dwst_fftconv_dkf_long")
    sig = cuda_lib._SIGNATURES[name]
    assert len(args) == len(sig) - 1
    assert args[4:] == (B, H, L, n, plan.cluster)
    assert (args[2] == 0) == (plan.route == "cluster")
    fl.launch_dkf_long(u, u, n, fl.DKF_TWO_PASS)
    name, args = calls[-1]
    assert args[2] != 0 and args[4:] == (B, H, L, n, 0)
    kp = torch.zeros(H, *fl.split(n), dtype=C64)
    for conj in (0, 1):
        count = ops.fftconv_long.launches
        y = ops.fftconv_long(u, kp, conj=bool(conj))
        assert ops.fftconv_long.launches == count + 1
        assert y.dtype == dtype and tuple(y.shape) == (B, H, L)
        name, args = calls[-1]
        assert name == ("dwst_fftconv_long_bf16" if dtype == BF
                        else "dwst_fftconv_long")
        assert len(args) == len(cuda_lib._SIGNATURES[name]) - 1
        assert args[4:] == (B, H, L, n, conj)


def test_long_function_hands_bf16_to_its_kernels(monkeypatch):
    """The training Function with bf16 activations hands them as they are
    to kernel 9's training entry (forward, and conj in backward: bf16 u and
    g in, bf16 y and du out, no widening and no narrowing copy around the
    call) and to kernel 5L; f32 activations stay f32."""
    seen = []

    def record(name, fn):
        def wrapper(x, *a, **k):
            seen.append((name, x.dtype, k.get("conj", False)))
            return fn(x, *a, **k)
        return wrapper
    monkeypatch.setattr(fl, "fftconv_long",
                        record("conv", fl.fftconv_long_ref))
    monkeypatch.setattr(fl, "fftconv_dkf_long",
                        record("dkf", ops.fftconv_dkf_ref))
    n, L = 1 << 16, 30000
    rng = np.random.RandomState(11)
    khat = torch.fft.rfft(torch.from_numpy(
        (0.05 * rng.randn(2, n)).astype(np.float32)), n=n)
    for dtype in (BF, torch.float32):
        seen.clear()
        u = torch.from_numpy(rng.randn(2, 2, L).astype(np.float32)).to(
            dtype).requires_grad_(True)
        kk = khat.clone().requires_grad_(True)
        y = fl.fftconv_long_train(u, kk)
        y.backward(torch.ones_like(y))
        assert y.dtype == dtype and u.grad.dtype == dtype
        assert seen == [("conv", dtype, False), ("conv", dtype, True),
                        ("dkf", dtype, False)]


@pytest.mark.parametrize("n,L", [(1 << 15, 16000), (1 << 21, 44000),
                                 (1 << 16, 70000), (3 << 16, 44000)])
def test_dkf_long_refuses_sizes_it_does_not_take(monkeypatch, n, L):
    """Past 2^20, below 2^16 (kernel 5's sizes), L > n or n not a power of
    two: a ValueError before any launch."""
    calls = []
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *a: calls.append(
        name))
    u = torch.zeros(1, 2, L).as_subclass(_OnCard)
    with pytest.raises(ValueError, match="kernel 5L"):
        ops.fftconv_dkf_long(u, u, n)
    assert calls == []


def test_long_wrappers_are_their_plain_versions_on_cpu():
    """On CPU tensors 5L's wrapper and kernel 9's training entries return
    their plain versions bit for bit and count nothing."""
    rng = np.random.RandomState(3)
    n, L = 1 << 16, 30000
    khat = torch.fft.rfft(torch.from_numpy(
        (0.1 * rng.randn(2, n)).astype(np.float32)), n=n)
    kp = ops.long_spectrum(khat)
    before = {k: fn.launches for k, fn in ops.COUNTED.items()}
    for dtype in (torch.float32, BF):
        u = torch.from_numpy(rng.randn(2, 2, L).astype(np.float32)).to(dtype)
        g = torch.from_numpy(rng.randn(2, 2, L).astype(np.float32)).to(dtype)
        assert torch.equal(ops.fftconv_dkf_long(u, g, n),
                           ops.fftconv_dkf_ref(u, g, n))
    u = u.float()
    assert torch.equal(ops.fftconv_long(u, kp), fl.fftconv_long_ref(u, kp))
    assert torch.equal(ops.fftconv_long(u, kp, conj=True),
                       fl.fftconv_long_ref(u, kp, conj=True))
    assert {k: fn.launches for k, fn in ops.COUNTED.items()} == before


@pytest.mark.parametrize("L,device,refused", [
    (44000, "cuda", False), (524288, "cuda", False), (524289, "cuda", True),
    (524289, "cpu", False)])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_training_length_refused_past_the_long_conv(L, device, refused,
                                                    precision):
    """On the card training takes every length up to the long conv's FFT
    size 2^20 at either precision and refuses past it by size; the CPU's
    plain path takes any length."""
    cfg = dict(SMALL_CFG, d_model=128, L=L)    # widths the card takes
    if not refused:
        check_supported(cfg, precision, train=True, device_type=device)
        return
    with pytest.raises(ValueError, match="past the long conv"):
        check_supported(cfg, precision, train=True, device_type=device)


# ---- one training step at L 44000 ------------------------------------------

DIFFUSION = {"T": 200, "beta_0": 0.0001, "beta_T": 0.02, "beta": None}
L_LONG = 44000
LONG_CFG = dict(SMALL_CFG, L=L_LONG)


def test_train_step_at_44000_matches_jax(sashimi_small):
    """``sashimi_small`` at L 44000 (tiers n 2^17, 32768, 8192; the top
    tier's two blocks through the long Function): the loss to 1e-5
    relative and every gradient tensor to 1e-4 of its max |JAX grad|
    (init_conv's weight_v as roundoff, as tests/test_torch_train.py
    states it), against ``jax.value_and_grad`` of JAX Sashimi's training
    form on the CPU.  ``*.log_dt`` to 1e-2: its gradient sums the Cauchy
    terms' dt-derivatives over 22001 FFT nodes in complex64 with
    cancellation (tests/test_torch_train.py's 1e-3 is for 8001); in the
    top tier's last block (u_layers.3) the port's f32 gradient is 1.1e-3
    off a float64 evaluation of the same model and JAX's 3.2e-4, of a
    largest entry of 0.167, and every other block's log_dt stays within
    1e-6 of float64 on both sides."""
    model, params = sashimi_small
    p = perturbed(params, seed=2)
    jm = model.clone(L=L_LONG)
    rng = np.random.RandomState(4)
    audio = (0.5 * rng.randn(1, 1, L_LONG)).astype(np.float32)
    t = np.array([57], np.int32)
    z = rng.randn(1, 1, L_LONG).astype(np.float32)
    abar = np.asarray(jax_schedule(DIFFUSION).alpha_bar)[t].reshape(1, 1, 1)

    def loss_fn(q):
        x_t = jnp.sqrt(abar) * audio + jnp.sqrt(1.0 - abar) * z
        eps = jm.apply(q, x_t, jnp.asarray(t), None, train=True)
        return jnp.mean((eps - z) ** 2)
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(p)
    tm = port_model(p, LONG_CFG)
    loss = training_loss(tm, torch.from_numpy(audio),
                         schedule_from_cfg(DIFFUSION), t=torch.from_numpy(t),
                         z=torch.from_numpy(z))
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    ref = params_from_jax(jax.tree.map(np.asarray, jgrads), LONG_CFG)
    named = dict(tm.named_parameters())
    g_scale = float(ref["init_conv.0.conv.weight_g"].abs().max())
    for name, g in ref.items():
        mine = named[name].grad.reshape(g.shape)
        if name == "init_conv.0.conv.weight_v":
            assert float(mine.abs().max()) <= 1e-6 * g_scale
            continue
        tol = 1e-2 if name.endswith("kernel.kernel.log_dt") else 1e-4
        scale = float(g.abs().max())
        assert scale > 0, name
        assert float((mine - g).abs().max()) <= tol * scale, name
