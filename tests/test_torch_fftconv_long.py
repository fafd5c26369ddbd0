"""Port parity for the long S4 FFT convolution (kernel 9): the plain version
against the JAX package's four-step Pallas conv (``fftconv_fused``, run in
interpret mode on the CPU at strict f32, and its channel-batched schedule),
the factorized spectrum the port builds once per run against its
definition, the routing by FFT size, the cluster route's plan, and a model
of the cluster route's schedule (its block partition, its two exchanges as
tile moves between the blocks' shared-memory slots, its twiddles) at a
scaled-down split.  Tolerance: 1e-5 x max(1, max |ref|) (f32 transforms of
a few thousand points)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import erf

import test_torch_common  # noqa: F401  (single-threaded torch)

from diffwave_sashimi_tpu.ops import fftconv_pallas as fp
from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.ops import cuda_lib

fl = importlib.import_module("diffwave_sashimi_torch.ops.fftconv_long")


def _case(B, H, L, n, L_k, seed=0):
    """u (B, H, L) and the combined bidirectional time kernel (H, n) of an
    S4 kernel of L_k taps each way (anticausal taps at the buffer's end)."""
    rng = np.random.RandomState(seed)
    u = rng.randn(B, H, L).astype(np.float32)
    k = np.zeros((H, n), np.float32)
    k[:, :L_k] = 0.05 * rng.randn(H, L_k)
    k[:, n - L_k:] += 0.05 * rng.randn(H, L_k)
    return u, k


def _port_spectrum(kf, n):
    """The JAX factorized spectrum (2, H, N1, K2) -> the port's (H, N1, N2),
    through the flat half spectrum as ``fftconv_pallas._unfused`` reads
    it."""
    N1, K2 = kf.shape[2:]
    half = np.asarray(kf[0]) + 1j * np.asarray(kf[1])
    half = np.swapaxes(half, -1, -2).reshape(kf.shape[1], N1 * K2)
    khat = torch.from_numpy(half[:, :n // 2 + 1].astype(np.complex64))
    return fl.long_spectrum(khat)


def _within(out, ref, tol=1e-5):
    err = float(np.max(np.abs(out - ref)))
    assert err <= tol * max(1.0, float(np.max(np.abs(ref)))), err


@pytest.mark.parametrize("L,n,L_k", [(200, 512, 200), (700, 2048, 300),
                                     (700, 2048, 700)])
def test_plain_long_conv_matches_jax_fftconv_fused(L, n, L_k):
    """B2, H8: the TPU kernel's contract against fftconv_fused and the
    unfused path, and the sampling form against fftconv_fused with the
    prologue and epilogue written out."""
    B, H = 2, 8
    u, k = _case(B, H, L, n, L_k)
    kf = fp.factorize_kernel_freq(jnp.asarray(k), n)
    ref = np.asarray(fp.fftconv_fused(jnp.asarray(u), kf, n, L, False))
    unfused = np.asarray(fp._unfused(jnp.asarray(u), kf, n, L))
    kp = _port_spectrum(kf, n)
    before = ops.fftconv_long.launches
    out = ops.fftconv_long(torch.from_numpy(u), kp).numpy()
    assert ops.fftconv_long.launches == before        # no kernel on the CPU
    _within(out, ref)
    _within(out, unfused)

    rng = np.random.RandomState(1)
    a = (0.5 + rng.rand(B, L)).astype(np.float32)
    c = (0.3 * rng.randn(B, L)).astype(np.float32)
    bias = (0.3 * rng.randn(B, H)).astype(np.float32)
    D = rng.randn(H).astype(np.float32)
    up = u * a[:, None] + c[:, None] + bias[:, :, None]
    y = np.asarray(fp.fftconv_fused(jnp.asarray(up), kf, n, L, False))
    z = y + D[:, None] * up
    gelu = 0.5 * z * (1.0 + erf(z / np.sqrt(2.0)))
    args = [torch.from_numpy(x) for x in (u, a, c, bias)]
    fused = ops.fftconv_long_ln_bias_gelu_d(*args, kp,
                                            torch.from_numpy(D)).numpy()
    _within(fused, gelu)


def test_plain_long_conv_matches_jax_batched_schedule(monkeypatch):
    """Row 10: the channel-batched schedule (opt-in BATCHED, N1 = N2 = 128)
    computes the same function; B1, H8, n 16384."""
    monkeypatch.setitem(fp.BATCHED, "enabled", True)
    B, H, L, n = 1, 8, 10000, 16384
    u, k = _case(B, H, L, n, 4000, seed=2)
    kf = fp.factorize_kernel_freq(jnp.asarray(k), n)
    ref = np.asarray(fp._fftconv_impl(jnp.asarray(u), kf, n, L, False))
    out = ops.fftconv_long(torch.from_numpy(u), _port_spectrum(kf, n))
    _within(out.numpy(), ref)


@pytest.mark.parametrize("n", [256, 2048, 1 << 15])
def test_long_spectrum_is_the_factorized_full_dft(n):
    """kp[h, k1, k2] = DFT_n(k)[k1 + N1 k2]; the half spectrum comes back
    exactly; its first K2 columns are the JAX factorize_kernel_freq."""
    H = 3
    _, k = _case(1, H, 1, n, n // 4, seed=3)
    khat = torch.fft.rfft(torch.from_numpy(k), n=n)
    kp = fl.long_spectrum(khat)
    N1, N2 = fl.split(n)
    assert (N1, N2) == (fp._consts(n)["N1"], fp._consts(n)["N2"])
    assert kp.shape == (H, N1, N2) and kp.dtype == torch.complex64
    full = np.fft.fft(k.astype(np.float64), axis=-1)
    want = full.reshape(H, N2, N1).transpose(0, 2, 1)
    _within(kp.numpy(), want, 1e-6)
    assert torch.equal(fl.half_spectrum(kp)[:, 1:-1], khat[:, 1:-1])
    assert float(fl.half_spectrum(kp)[:, [0, -1]].imag.abs().max()) == 0.0
    kf = np.asarray(fp.factorize_kernel_freq(jnp.asarray(k), n))
    K2 = kf.shape[-1]
    _within(kp.numpy()[:, :, :K2], kf[0] + 1j * kf[1], 1e-6)


def test_sampling_spectrum_routes_by_fft_size():
    """Half spectra up to kernel 1's n = 32768 stay; above, kernel 9's
    layout; above 2^20, refused.  s4_conv follows the layout."""
    H = 2
    small = torch.fft.rfft(torch.randn(H, 32768), n=32768)
    assert fl.sampling_spectrum(small) is small
    big = torch.fft.rfft(torch.randn(H, 65536), n=65536)
    kp = fl.sampling_spectrum(big)
    assert kp.shape == (H, 256, 256)
    with pytest.raises(ValueError, match="past the long conv"):
        fl.sampling_spectrum(torch.zeros(1, (1 << 20) + 1,
                                         dtype=torch.complex64))
    g = torch.Generator().manual_seed(0)
    u = torch.randn(2, H, 30000, generator=g)
    a, c = torch.rand(2, 30000, generator=g) + 0.5, torch.zeros(2, 30000)
    bias, D = torch.randn(2, H, generator=g), torch.randn(H, generator=g)
    assert torch.equal(ops.s4_conv(u, a, c, bias, kp, D),
                       ops.fftconv_long_ln_bias_gelu_d_ref(u, a, c, bias,
                                                           kp, D))
    assert torch.equal(ops.PLAIN.conv(u, a, c, bias, kp, D),
                       ops.FUSED.conv(u, a, c, bias, kp, D))
    assert torch.equal(ops.s4_conv(u, a, c, bias, small, D),
                       ops.fftconv_ln_bias_gelu_d_ref(u, a, c, bias, small,
                                                      D))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    u = torch.zeros(2, 4, 300)
    with pytest.raises(ValueError, match="power-of-two split"):
        fl._check(u, torch.zeros(4, 32, 8, dtype=torch.complex64))
    with pytest.raises(ValueError, match="power-of-two split"):
        fl._check(u, torch.zeros(4, 16, 16, dtype=torch.complex64))
    with pytest.raises(ValueError, match="contiguous CUDA"):
        fl._check(u, torch.zeros(4, 16, 32, dtype=torch.complex64))


@pytest.mark.parametrize("n,C,cols,rows,routed", [
    (1 << 16, 4, 64, 64, True), (1 << 17, 8, 64, 32, True),
    (1 << 18, 16, 32, 32, False)])
def test_long_plan_routes_the_vocoders_sizes_to_the_cluster(n, C, cols,
                                                            rows, routed):
    """The cluster kernel's sizes: one cluster of C = n / 16384 blocks a
    row, each block 16384 complex values (128 KB) as cols columns of N1
    and as rows rows of N2; its N + 1 slots a transform and its 64 KB
    stash within the H100's 232448 bytes a block.  Kernel 9f takes it at
    n 2^16 and 2^17, where it beats the three passes; at 2^18 the three
    passes win, and take 9f there."""
    plan = fl.cluster_plan(n)
    N1, N2 = fl.split(n)
    assert plan == ("cluster", C, cols, rows, plan.smem)
    assert cols * C == N2 and rows * C == N1
    assert cols * N1 == rows * N2 == fl.CLUSTER_VALUES == 1024 * 16
    held = max(cols * (N1 + 1), rows * (N2 + 1))
    assert 128 * 1024 < 8 * held
    assert plan.smem == 8 * (held + fl.CLUSTER_STASH) <= 232448
    assert n in fl.CLUSTER_SIZES
    assert fl.long_plan(n) == (plan if routed else fl.THREE_PASS)


@pytest.mark.parametrize("n", [4096, 1 << 15, 1 << 18, 1 << 19, 1 << 20])
def test_long_plan_keeps_the_three_pass_route_elsewhere(n):
    assert fl.long_plan(n) == fl.THREE_PASS
    assert fl.THREE_PASS.route == "three_pass"


def test_launchers_refuse_cpu_tensors():
    """The sampling form's launcher behind the wrappers (also the route
    yardsticks' entry) raises on CPU tensors, 9f's on either route: only
    the wrappers take the plain version, and only for CPU tensors."""
    B, H, L, n = 2, 2, 300, 1 << 16
    u, kp = torch.zeros(B, H, L), torch.zeros(H, 256, 256,
                                              dtype=torch.complex64)
    a, c = torch.ones(B, L), torch.zeros(B, L)
    bias, D = torch.zeros(B, H), torch.zeros(H)
    for plan in (fl.long_plan(n), fl.THREE_PASS):
        for x in (u, u.to(torch.bfloat16)):
            with pytest.raises(ValueError, match="contiguous CUDA"):
                fl.launch_sampling(x, a, c, bias, kp, D, plan)


def _slot(i):
    """csrc/fft_stockham.cuh::Swz::slot: bits 0-3 of i XOR bits 3-6."""
    return i ^ ((i >> 3) & 15)


def _cluster_schedule(u, kp, plan, pro=None, D=None):
    """A model of csrc/fftconv_long.cu::fftconv_cluster_kernel in f64: per
    (batch pair, channel) row, C blocks each with its own shared-memory
    slots (the Swz layout, N + 1 slots a transform), the column FFTs, the
    two exchanges as the kernel's tile moves (each block's value x goes to
    block x / TILE, the sender reading its own slots and storing into the
    peer's), the twiddles as values cross them, the row FFTs against the
    block's slab of kp, and the column store.  ``pro``: (a, c, bias), the
    sampling form's prologue, with its epilogue gelu_erf(y + D u'); else
    the contract's conv."""
    B, H, L = u.shape
    _, N1, N2 = kp.shape
    n, C, cols, rows = N1 * N2, plan.cluster, plan.cols, plan.rows
    st1, st2, tile = N1 + 1, N2 + 1, cols * rows
    f64, c128 = torch.float64, torch.complex128
    x = u.to(f64)
    if pro is not None:
        a, c, bias = (t.to(f64) for t in pro)
        x = x * a[:, None] + c[:, None] + bias[:, :, None]
    xp = torch.zeros(B + B % 2, H, n, dtype=f64)
    xp[:B, :, :L] = x
    rows_in = torch.complex(xp[0::2], xp[1::2])           # (pairs, H, n)
    kp = kp.to(c128)
    y = torch.empty(rows_in.shape, dtype=c128)
    # phase 1 (load_cols): column cc of block j at z[cc st1 + slot(n1)]
    n1 = torch.arange(N1)[:, None]
    cc = torch.arange(cols)[None, :]
    col_slots = cc * st1 + _slot(n1)                      # (N1, cols)
    q2 = torch.arange(rows)[:, None]
    k2 = torch.arange(N2)[None, :]
    row_slots = q2 * st2 + _slot(k2)                      # (rows, N2)
    # a block's value x of an exchange: its peer, its tile position
    xs = torch.arange(C * tile)
    peer, yy = xs // tile, xs % tile
    e1_q, e1_cc = yy // cols, yy % cols                   # cc fastest
    e2_cc, e2_q = yy // rows, yy % rows                   # q fastest
    for p in range(rows_in.shape[0]):
        for h in range(H):
            z = torch.zeros(C, plan.smem // 8 - fl.CLUSTER_STASH,
                            dtype=c128)
            for j in range(C):
                t = n1 * N2 + j * cols + cc
                z[j, col_slots] = torch.fft.fft(rows_in[p, h][t], dim=0)
            w = torch.zeros_like(z)               # exchange 1
            for j in range(C):
                k1 = peer * rows + e1_q
                n2 = j * cols + e1_cc
                tw = torch.exp(-2j * torch.pi * (n2 * k1).to(f64) / n)
                w[peer, e1_q * st2 + _slot(n2)] = (
                    z[j, e1_cc * st1 + _slot(k1)] * tw)
            z = w
            for j in range(C):                    # phase 2
                X = torch.fft.fft(z[j, row_slots], dim=1)
                X = X * kp[h, j * rows:(j + 1) * rows]
                z[j, row_slots] = torch.fft.ifft(X, dim=1) * N2
            w = torch.zeros_like(z)               # exchange 2
            for j in range(C):
                k1 = j * rows + e2_q
                m2 = peer * cols + e2_cc
                tw = torch.exp(2j * torch.pi * (m2 * k1).to(f64) / n)
                w[peer, e2_cc * st1 + _slot(k1)] = (
                    z[j, e2_q * st2 + _slot(m2)] * tw)
            z = w
            for j in range(C):                    # phase 3 (store_cols)
                t = n1 * N2 + j * cols + cc
                y[p, h][t] = torch.fft.ifft(z[j, col_slots], dim=0) * N1 / n
    out = torch.stack([y.real, y.imag], 1).reshape(-1, H, n)[:B, :, :L]
    if pro is None:
        return out
    v = out + D.to(f64)[:, None] * x
    return 0.5 * v * (1.0 + torch.erf(v / np.sqrt(2.0)))


@pytest.mark.parametrize("B,L,n,C", [(2, 1000, 1024, 4), (3, 700, 1024, 4),
                                     (2, 1500, 2048, 4), (1, 3000, 4096, 8),
                                     (2, 600, 1024, 2)])
def test_cluster_schedule_matches_jax_fftconv_fused(B, L, n, C):
    """The cluster route's schedule at a scaled-down split (the plan's
    partition of n over C blocks; odd B leaves a pair's second row empty)
    against fftconv_fused: the conv alone, and with the sampling form's
    prologue and epilogue written out (9f's bf16 roundings aside)."""
    H = 8                                 # fftconv_fused's HB
    u, k = _case(B, H, L, n, min(L, n - L), seed=4)
    kf = fp.factorize_kernel_freq(jnp.asarray(k), n)
    kp = _port_spectrum(kf, n)
    plan = fl.cluster_plan(n, C)
    N1, N2 = fl.split(n)
    assert plan.cols * C == N2 and plan.rows * C == N1
    ref = np.asarray(fp.fftconv_fused(jnp.asarray(u), kf, n, L, False))
    out = _cluster_schedule(torch.from_numpy(u), kp, plan)
    _within(out.numpy(), ref)

    rng = np.random.RandomState(5)
    a = (0.5 + rng.rand(B, L)).astype(np.float32)
    c = (0.3 * rng.randn(B, L)).astype(np.float32)
    bias = (0.3 * rng.randn(B, H)).astype(np.float32)
    D = rng.randn(H).astype(np.float32)
    up = u * a[:, None] + c[:, None] + bias[:, :, None]
    y = np.asarray(fp.fftconv_fused(jnp.asarray(up), kf, n, L, False))
    z = y + D[:, None] * up
    gelu = 0.5 * z * (1.0 + erf(z / np.sqrt(2.0)))
    fused = _cluster_schedule(torch.from_numpy(u), kp, plan,
                              [torch.from_numpy(t) for t in (a, c, bias)],
                              torch.from_numpy(D))
    _within(fused.numpy(), gelu)


# ---- kernel 9's f32 forms: the three passes' wide column items ----

TC = 16                     # csrc/fftconv_long.cu: columns a column tile


def _items(N1):
    """The f32 column passes' wide items of one column tile (csrc
    load_cols4/store_cols4): item i takes row n1 = i / (TC / 4) and
    columns 4 (i % (TC / 4)) .. + 3 of the tile."""
    CH = TC // 4
    i = np.arange(N1 * CH)
    n1, ch = np.divmod(i, CH)
    return n1, 4 * ch


@pytest.mark.parametrize("N1", [16, 64, 512, 1024])
def test_wide_items_cover_each_tile_once(N1):
    """The items of a column tile cover each (row n1, column) of its TC
    columns once, 16 bytes of one row's run of 64 a load, and the block's
    TC N1 / 16 threads take N1 TC / 4 / (TC N1 / 16) = 4 items each; a
    row's chunk is all in or all past L when L % 4 == 0 (the kernel's
    vec), since it starts at a multiple of 4."""
    n1, col = _items(N1)
    seen = np.zeros((N1, TC), np.int64)
    for j in range(4):
        np.add.at(seen, (n1, col + j), 1)
    assert (seen == 1).all()
    assert len(n1) == 4 * (TC * N1 // 16)
    assert (col % 4 == 0).all()


def _wide_schedule(u, kp, pro=None, D=None):
    """A model of kernel 9's three passes with f32 activations (csrc
    cols_fwd_kernel / rows_kernel / cols_inv_kernel<FUSED, float>, their
    wide column items) in f64: per (batch pair,
    channel) row, pass A's column tiles of TC columns gathered item by
    item (four adjacent columns a load) through the prologue, their
    N1-point FFTs and the twiddle W_n^(n2 k1) into the scratch S[k1][n2];
    pass B's row FFTs, the spectrum product and the inverse with W_n^(-m2
    k1); pass C's inverse column FFTs, 1/n, and the store t = m1 N2 + m2 <
    L, the D-skip's u' formed again from u, a, c and bias (the
    epilogue's re-read) and gelu_erf.  ``pro``: (a, c, bias); else the
    contract's conv."""
    B, H, L = u.shape
    _, N1, N2 = kp.shape
    n = N1 * N2
    f64 = torch.float64
    x = u.to(f64)
    if pro is not None:
        a, c, bias = (t.to(f64) for t in pro)
        xpro = x * a[:, None] + c[:, None] + bias[:, :, None]
    else:
        xpro = x
    xp = torch.zeros(B + B % 2, H, n, dtype=f64)
    xp[:B, :, :L] = xpro
    rows = torch.complex(xp[0::2], xp[1::2])             # (pairs, H, n)
    S = torch.zeros(rows.shape[:2] + (N1, N2), dtype=torch.complex128)
    n1, col = _items(N1)
    k1 = torch.arange(N1, dtype=f64)
    for c0 in range(0, N2, TC):                          # pass A
        tile = torch.zeros(rows.shape[:2] + (TC, N1),
                           dtype=torch.complex128)
        for j in range(4):
            t = torch.from_numpy(n1 * N2 + c0 + col + j)
            tile[..., torch.from_numpy(col + j), torch.from_numpy(n1)] = (
                rows[..., t])
        F = torch.fft.fft(tile, dim=-1)                  # (.., cc, k1)
        n2 = c0 + torch.arange(TC, dtype=f64)
        tw = torch.exp(-2j * torch.pi * n2[:, None] * k1[None, :] / n)
        S[..., c0:c0 + TC] = (F * tw).transpose(-1, -2)
    X = torch.fft.fft(S, dim=-1) * kp.to(torch.complex128)   # pass B
    m2 = torch.arange(N2, dtype=f64)
    S = torch.fft.ifft(X, dim=-1) * N2 * torch.exp(
        2j * torch.pi * k1[:, None] * m2[None, :] / n)
    y = torch.fft.ifft(S, dim=-2) * N1 / n               # pass C
    y = y.reshape(rows.shape[:2] + (n,))
    out = torch.stack([y.real, y.imag], 1).reshape(-1, H, n)[:B, :, :L]
    if pro is None:
        return out
    v = out + D.to(f64)[:, None] * xpro
    return 0.5 * v * (1.0 + torch.erf(v / np.sqrt(2.0)))


@pytest.mark.parametrize("B,L,n", [(2, 1000, 1024), (3, 700, 1024),
                                   (2, 1500, 2048), (3, 3000, 4096)])
def test_wide_schedule_matches_jax_fftconv_fused(B, L, n):
    """The three passes' schedule with wide column items at small n, B2 and
    an odd B3 (a pair's
    second row empty): the conv alone and the sampling form (prologue,
    epilogue with u' formed again) against fftconv_fused, within 1e-5 x
    max(1, max|ref|), and against the plain version's float64 evaluation
    to f64 rounding."""
    H = 8                                 # fftconv_fused's HB
    u, k = _case(B, H, L, n, min(L, n - L), seed=6)
    kf = fp.factorize_kernel_freq(jnp.asarray(k), n)
    kp = _port_spectrum(kf, n)
    ref = np.asarray(fp.fftconv_fused(jnp.asarray(u), kf, n, L, False))
    _within(_wide_schedule(torch.from_numpy(u), kp).numpy(), ref)

    rng = np.random.RandomState(7)
    a = (0.5 + rng.rand(B, L)).astype(np.float32)
    c = (0.3 * rng.randn(B, L)).astype(np.float32)
    bias = (0.3 * rng.randn(B, H)).astype(np.float32)
    D = rng.randn(H).astype(np.float32)
    up = u * a[:, None] + c[:, None] + bias[:, :, None]
    y = np.asarray(fp.fftconv_fused(jnp.asarray(up), kf, n, L, False))
    z = y + D[:, None] * up
    gelu = 0.5 * z * (1.0 + erf(z / np.sqrt(2.0)))
    pro = [torch.from_numpy(t) for t in (a, c, bias)]
    fused = _wide_schedule(torch.from_numpy(u), kp, pro, torch.from_numpy(D))
    _within(fused.numpy(), gelu)
    f64 = ops.fftconv_long_ln_bias_gelu_d_ref(
        torch.from_numpy(u).double(), *(t.double() for t in pro),
        kp.to(torch.complex128), torch.from_numpy(D).double())
    assert float((fused - f64).abs().max()) < 1e-9


class _OnCard(torch.Tensor):
    """A tensor that says it is on the card, so that a launcher takes its
    launch route up to the launcher."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("B,H,L,n", [(2, 128, 143360, 1 << 18),
                                     (2, 256, 35840, 1 << 16),
                                     (2, 128, 100000, 1 << 17),
                                     (2, 128, 300000, 1 << 19),
                                     (3, 8, 3000, 4096)])
def test_f32_sampling_wrapper_passes_its_signature(monkeypatch, B, H, L, n):
    """On the card kernel 9's f32 sampling wrapper hands
    ``dwst_fftconv_long_ln_bias_gelu_d`` exactly the arguments its ctypes
    signature names, the stream apart: the eight addresses (the scratch of
    the three passes, one complex n-row a (batch pair, channel) row, after
    D), then B, H, L, n, and counts one launch, at every n of the
    vocoder's tiers and phase 15's."""
    calls = []
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *a: calls.append(
        (name, a)))
    monkeypatch.setattr(cuda_lib, "check", lambda *a: None)
    N1, N2 = fl.split(n)
    u = torch.empty(B, H, L, device="meta").as_subclass(_OnCard)
    f = torch.empty(1, device="meta")
    kp = torch.empty(H, N1, N2, dtype=torch.complex64, device="meta")
    made = []
    real_empty = torch.empty

    def empty(*a, **k):
        made.append(real_empty(*a, **k))
        return made[-1]
    monkeypatch.setattr(torch, "empty", empty)
    before = ops.fftconv_long_ln_bias_gelu_d.launches
    out = ops.fftconv_long_ln_bias_gelu_d(u, f, f, f, kp, f)
    assert ops.fftconv_long_ln_bias_gelu_d.launches == before + 1
    assert out.shape == (B, H, L)
    (name, got), = calls
    assert name == "dwst_fftconv_long_ln_bias_gelu_d"
    sig = cuda_lib._SIGNATURES[name]
    assert len(got) + 1 == len(sig) == 13
    for a_, t in zip(got, sig):
        assert isinstance(a_, int) and (t is cuda_lib._P or abs(a_) < 2 ** 31)
    assert got[8:] == (B, H, L, n)
    scratch = [t for t in made if t.dtype == torch.complex64]
    assert [tuple(t.shape) for t in scratch] == [((B + 1) // 2 * H, n)]
