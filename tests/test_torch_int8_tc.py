"""Kernel 12's redesign (csrc/fftconv_int8.cu), checked without a card:
its plan (``ops.int8conv.int8_plan``) at every layout ``int8_layout``
takes, and a numpy model of the kernel's tiling: the int8 operands and
staged factors in the shared-memory layout the kernel writes (x by 32-bit
words, each stage's factors copied by ``stage_rows`` at the plan's
offsets, the next stage's copied before the current stage's products where
the plan prefetches), each warp's tile read through ``ldmatrix``'s lane
addresses into ``mma.sync.m16n8k32`` fragments, and the tiles put back by
the epilogues' index maps.  Through that layout each stage's product must
be ``_mm8`` of the host's quantized factors bit for bit; a whole row of
the kernel in that model must give the plain version's output.  Last, the
wrapper's launch arguments carry the plan."""

import re

import numpy as np
import pytest
import torch

from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.ops import cuda_lib
from diffwave_sashimi_torch.ops import int8conv as q8

# SC09's tiers: (n, L) -> (R, S, Rc)
TIERS = {(32768, 16000): (256, 128, 128), (8192, 4000): (256, 32, 128),
         (2048, 1000): (64, 32, 32)}
# beside them, a layout whose Dr and Er do not fit a block whole (Dr in
# panels over kr, Er a chunk at a time)
SPLIT = (32768, 32768)
LANE = np.arange(32)
G, Q = LANE >> 2, LANE & 3


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layouts():
    """Every (n, L) at n 2^10 .. 2^15 and SC09's L, with edge lengths."""
    return [(1 << e, L) for e in range(10, 16)
            for L in (1, 1000, 4000, 8193, 16000, 16385, 32768)]


def _extents(n, L):
    """Bytes the kernel addresses in each region at (n, L): A's x, Y and
    output chunk, B's B and T, and each stage's factors."""
    R, S, Rc = q8.int8_layout(n, L)
    p = q8.int8_plan(n, L)
    PAD, OPAD = q8.PAD, q8.OPAD
    er_rows = p.chunk if p.er_chunked else Rc
    return {"A": max(S * (Rc + PAD), R * (S + PAD),
                     4 * p.chunk * (S + OPAD)),
            "B": max(R * (2 * S + PAD), 2 * S * (R + PAD)),
            "F": (2 * (R // p.panels) * (Rc + PAD), S * (2 * S + PAD),
                  2 * S * (S + PAD), 2 * er_rows * (R + PAD))}


@pytest.mark.parametrize("n,L", _layouts() + [(512, 100), (65536, 1000),
                                              (3000, 100)])
def test_plan_fits_aligns_and_refuses_as_the_layout(n, L):
    """Where int8_layout refuses, int8_plan refuses the same way; else the
    plan fits a block's and an SM's shared memory at its blocks an SM and
    registers a thread, its regions are 16-byte aligned, disjoint and hold
    what the kernel addresses, each stage's factors lie in F, a
    prefetched stage's apart from the stage before it, and the chunk and
    panels divide their dimensions as the kernel's tiles need."""
    try:
        R, S, Rc = q8.int8_layout(n, L)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            q8.int8_plan(n, L)
        return
    p = q8.int8_plan(n, L)
    assert p.threads in q8.THREADS
    assert 1 <= p.blocks_per_sm <= q8.REG_THREADS // p.threads
    assert p.smem + q8.SMEM_STATIC <= q8.SMEM_BLOCK
    assert p.blocks_per_sm * (p.smem + q8.SMEM_STATIC + q8.SMEM_RESERVED) \
        <= q8.SMEM_SM
    ext = _extents(n, L)
    regions = [(0, p.a_bytes), (p.b_off, p.b_bytes), (p.f_off, p.f_bytes)]
    for (o1, s1), (o2, _) in zip(regions, regions[1:]):
        assert o1 + s1 <= o2
    assert p.f_off + p.f_bytes == p.smem
    assert all(o % 16 == 0 and s % 16 == 0 for o, s in regions)
    assert p.a_bytes >= ext["A"] and p.b_bytes >= ext["B"]
    assert p.stage_bytes == ext["F"]
    for s, (off, size) in enumerate(zip(p.stage_off, p.stage_bytes)):
        assert off % 16 == 0 and 0 <= off and off + size <= p.f_bytes
        if s and p.prefetch >> s & 1:
            prev = (p.stage_off[s - 1], p.stage_bytes[s - 1])
            assert off >= prev[0] + prev[1] or off + size <= prev[0]
    assert p.prefetch & 1 == 0
    assert not (p.panels > 1 and p.prefetch & 2)
    assert not (p.er_chunked and p.prefetch & 8)
    assert R % p.panels == 0 and R // p.panels >= 16
    assert Rc % p.chunk == 0 and p.chunk >= 16
    if (n, L) in TIERS:                  # the shipped tiers: every stage
        assert (p.panels, p.er_chunked, p.prefetch) == (1, False, 14)


@pytest.mark.parametrize("n,L", list(TIERS) + [SPLIT])
def test_operand_rows_and_stores_are_conflict_free(n, L):
    """Every int8 operand row stride is an odd number of 16-byte units, so
    each 8-lane phase of an ldmatrix reads eight distinct 16-byte bank
    groups; x's 32-bit stores (8 rows t2 by 4 words a warp) and the output
    staging's stores (rows t1 padded by OPAD floats) hit 32 distinct
    banks."""
    R, S, Rc = q8.int8_layout(n, L)
    p = q8.int8_plan(n, L)
    for stride in (Rc + q8.PAD, 2 * S + q8.PAD, S + q8.PAD, R + q8.PAD):
        for base in range(0, 8):
            assert len({(base + r) * stride // 16 % 8 for r in range(8)}) == 8
    ldx = Rc + q8.PAD
    for w0 in range(0, S * Rc // 4, 32):
        w = w0 + LANE
        t2, hi = (w >> 2) % S, (w >> 2) // S
        addr = t2 * ldx + 4 * (4 * hi + (w & 3))
        assert len({a // 4 % 32 for a in addr}) == 32
    ldo = S + q8.OPAD
    for e in range(4):
        word = (2 * Q + (e & 1)) * ldo + G + 8 * (e >> 1)
        assert len({a % 32 for a in word}) == 32


# ---- a numpy model of the kernel's shared memory and tensor-core tiles --


def _ldsm4(mem, addr):
    """ldmatrix.x4.b16: lane l gives the address of row l % 8 of matrix
    l // 8; lane l's register i holds bytes 4 (l % 4).. of row l // 4 of
    matrix i.  Returns (32 lanes, 4 registers, 4 bytes)."""
    rows = addr[8 * np.arange(4)[None, :] + (LANE // 4)[:, None]]
    return mem[rows[..., None] + 4 * (LANE % 4)[:, None, None]
               + np.arange(4)]


def _mma(a, b):
    """mma.sync.m16n8k32.s8: A (16 x 32) and B (32 x 8) from the lanes'
    fragments (a: 4 registers, b: 2, of 4 int8 each), their int32 product
    as a 16 x 8 tile (lane (g, q)'s c[e] is row g + 8 (e // 2), column
    2 q + e % 2)."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    k = np.arange(4)
    for reg, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 16), (8, 16))):
        A[(G + dr)[:, None], (dc + 4 * Q)[:, None] + k] = a[:, reg]
    for reg in range(2):
        B[(16 * reg + 4 * Q)[:, None] + k, G[:, None]] = b[:, reg]
    return A @ B


def _warp_mma(mem, A, lda, Bm, ldb, m0, n0, K, TM, TN):
    """csrc/fftconv_int8.cu::warp_mma: products p < len(A) of the TM x TN
    tile at (m0, n0), A[p] and Bm[p] the operands' byte offsets; returns
    (P, 16 TM, 8 TN) int64."""
    ra = (m0 + (LANE & 15)) * lda + 16 * (LANE >> 4)
    rb = (n0 + (LANE & 7) + 8 * (LANE >> 4)) * ldb + 16 * ((LANE >> 3) & 1)
    acc = np.zeros((len(A), 16 * TM, 8 * TN), np.int64)
    for k0 in range(0, K, 32):
        for p, (a0, b0) in enumerate(zip(A, Bm)):
            fa = [_ldsm4(mem, a0 + ra + 16 * i * lda + k0) for i in range(TM)]
            fb = []
            for j in range(0, TN, 2):
                r = _ldsm4(mem, b0 + rb + 8 * j * ldb + k0)
                fb += [r[:, 0:2], r[:, 2:4]]
            for i in range(TM):
                for j in range(TN):
                    acc[p, 16 * i:16 * i + 16, 8 * j:8 * j + 8] += _mma(
                        fa[i], fb[j])
    return acc


def _stage_rows(mem, dst, src, rows, w):
    """csrc stage_rows: rows of w bytes from src (dense) to dst, row
    stride w + PAD, 16 bytes a copy."""
    sh = w.bit_length() - 1 - 4
    for i in range(rows << sh):
        r, c = i >> sh, (i - ((i >> sh) << sh)) * 16
        mem[dst + r * (w + q8.PAD) + c:dst + r * (w + q8.PAD) + c + 16] = \
            src[r * w + c:r * w + c + 16]


class _Block:
    """One block's shared memory at (n, L), the plan's regions, and the
    factors staged as the kernel stages them."""

    def __init__(self, n, L):
        self.R, self.S, self.Rc = q8.int8_layout(n, L)
        self.p = q8.int8_plan(n, L)
        k = q8.int8_consts(n, L)
        self.q, self.flat = k["q"], k["flat"]
        self.mem = np.zeros(self.p.smem, np.int8)
        R, S, Rc = self.R, self.S, self.Rc
        self.ldx, self.ldb = Rc + q8.PAD, 2 * S + q8.PAD
        self.ldy, self.ldt = S + q8.PAD, R + q8.PAD
        self.ofs = np.cumsum([0, R * Rc, R * Rc, 2 * S * S, 2 * S * S,
                              R * Rc])        # DrrT, DriT, DsPp, EsPp, ErrT..
        self.B = self.p.b_off

    def F(self, s):
        return self.p.f_off + self.p.stage_off[s]

    def load(self, s, part=0):
        """csrc load_stage(s, part)."""
        R, S, Rc, p, f = self.R, self.S, self.Rc, self.p, self.flat
        RP = R // p.panels
        ER = p.chunk if p.er_chunked else Rc
        o = self.ofs
        if s == 0:
            _stage_rows(self.mem, self.F(0), f[o[0] + part * RP * Rc:], RP, Rc)
            _stage_rows(self.mem, self.F(0) + RP * self.ldx,
                        f[o[1] + part * RP * Rc:], RP, Rc)
        elif s == 1:
            _stage_rows(self.mem, self.F(1), f[o[2]:], S, 2 * S)
        elif s == 2:
            _stage_rows(self.mem, self.F(2), f[o[3]:], 2 * S, S)
        else:
            _stage_rows(self.mem, self.F(3), f[o[4] + part * ER * R:], ER, R)
            _stage_rows(self.mem, self.F(3) + ER * self.ldt,
                        f[o[5] + part * ER * R:], ER, R)

    def prefetch(self, s):
        if self.p.prefetch >> s & 1:
            self.load(s)

    def late(self, s):
        if not self.p.prefetch >> s & 1 and not (s == 3
                                                 and self.p.er_chunked):
            self.load(s)

    # each stage's products, as the kernel's warps run them (all units)
    def s1(self):
        """x (in A) times Dr: (2, S, R), Ar and Ai."""
        R, S, Rc, p = self.R, self.S, self.Rc, self.p
        RP = R // p.panels
        out = np.zeros((2, S, R), np.int64)
        for part in range(p.panels):
            if part:
                self.load(0, part)
            Fr = self.F(0)
            for unit in range((S // 32) * (RP // 16)):
                m0, n0 = unit % (S // 32) * 32, unit // (S // 32) * 16
                acc = _warp_mma(self.mem, [0, 0], self.ldx,
                                [Fr, Fr + RP * self.ldx], self.ldx, m0, n0,
                                Rc, 2, 2)
                k0r = part * RP + n0
                out[:, m0:m0 + 32, k0r:k0r + 16] = acc
        if p.panels > 1:
            self.load(0, 0)
        return out

    def s2(self):
        """DsP times B (in B): (S, R), rows ks < S/2 Xr, then Xi."""
        R, S = self.R, self.S
        out = np.zeros((S, R), np.int64)
        for unit in range((S // 32) * (R // 32)):
            m0, n0 = unit % (S // 32) * 32, unit // (S // 32) * 32
            acc = _warp_mma(self.mem, [self.F(1)], self.ldb, [self.B],
                            self.ldb, m0, n0, 2 * S, 2, 4)[0]
            for i in range(2):           # rows g / g + 8: Xr / Xi of ks
                ks = m0 // 2 + 8 * i
                out[ks:ks + 8, n0:n0 + 32] = acc[16 * i:16 * i + 8]
                out[S // 2 + ks:S // 2 + ks + 8, n0:n0 + 32] = \
                    acc[16 * i + 8:16 * i + 16]
        return out

    def ia(self):
        """EsP times Y (in A): (2S, R), rows t2 < S Zr, then Zi."""
        R, S = self.R, self.S
        out = np.zeros((2 * S, R), np.int64)
        for unit in range((2 * S // 32) * (R // 32)):
            m0, n0 = unit % (2 * S // 32) * 32, unit // (2 * S // 32) * 32
            acc = _warp_mma(self.mem, [self.F(2)], self.ldy, [0], self.ldy,
                            m0, n0, S, 2, 4)[0]
            for i in range(2):           # rows g / g + 8: Zr / Zi of t2
                t2 = m0 // 2 + 8 * i
                out[t2:t2 + 8, n0:n0 + 32] = acc[16 * i:16 * i + 8]
                out[S + t2:S + t2 + 8, n0:n0 + 32] = \
                    acc[16 * i + 8:16 * i + 16]
        return out

    def ib(self):
        """T (in B) times Er, a chunk of t1 at a time: (2, S, Rc)."""
        R, S, Rc, p = self.R, self.S, self.Rc, self.p
        ER = p.chunk if p.er_chunked else Rc
        out = np.zeros((2, S, Rc), np.int64)
        for c0 in range(0, Rc, p.chunk):
            if p.er_chunked:
                self.load(3, c0 // p.chunk)
            off = 0 if p.er_chunked else c0 * self.ldt
            Fr, Fi = self.F(3) + off, self.F(3) + ER * self.ldt + off
            for unit in range((S // 32) * (p.chunk // 16)):
                m0, n0 = unit % (S // 32) * 32, unit // (S // 32) * 16
                acc = _warp_mma(self.mem, [self.B, self.B + S * self.ldt],
                                self.ldt, [Fr, Fi], self.ldt, m0, n0, R, 2, 2)
                out[:, m0:m0 + 32, c0 + n0:c0 + n0 + 16] = acc
        return out

    def put_x(self, qx):
        """x (S x Rc codes, [t2][t1]) by the kernel's 32-bit words."""
        S, Rc = self.S, self.Rc
        for w in range(S * Rc // 4):
            t2, hi = (w >> 2) % S, (w >> 2) // S
            t1 = 4 * (4 * hi + (w & 3))
            for j in range(4):
                t = (t1 + j) * S + t2
                assert (t // S, t % S) == (t1 + j, t2)
                self.mem[t2 * self.ldx + t1 + j] = qx[t2, t1 + j]

    def put_cols(self, off, ld, m):
        """m (rows j, columns c) stored by column: mem[off + c ld + j]."""
        for c in range(m.shape[1]):
            self.mem[off + c * ld:off + c * ld + m.shape[0]] = m[:, c]

    def put_rows(self, off, ld, m):
        for r in range(m.shape[0]):
            self.mem[off + r * ld:off + r * ld + m.shape[1]] = m[r]


def _mm8(a, b):
    return a.astype(np.int64) @ b.astype(np.int64)


def _codes(rng, *shape):
    return rng.randint(-127, 128, size=shape).astype(np.int8)


@pytest.mark.parametrize("n,L", list(TIERS) + [SPLIT])
def test_tiles_reproduce_the_quantized_products(n, L):
    """Each stage's product through the staged layout, ldmatrix's lane
    addresses and the mma fragments is ``_mm8`` of the host's quantized
    factors (``int8_consts``'s q) bit for bit: x Dr, DsP [Br; Bi], EsP
    [Yr; Yi], Tr Err and Ti Eri, on random int8 stage inputs; a
    prefetched stage's copy, landing during the stage before it, leaves
    that stage's factors whole."""
    blk = _Block(n, L)
    R, S, Rc, q = blk.R, blk.S, blk.Rc, blk.q
    rng = np.random.RandomState(n % 9973 + L)
    qx = _codes(rng, S, Rc)
    blk.load(0)
    blk.put_x(qx)
    blk.prefetch(1)
    a = blk.s1()
    np.testing.assert_array_equal(a[0], _mm8(qx, q["Drr"]))
    np.testing.assert_array_equal(a[1], _mm8(qx, q["Dri"]))
    qB = _codes(rng, 2 * S, R)                 # [Br; Bi] (t2 rows, kr)
    blk.put_cols(blk.B, blk.ldb, qB)
    blk.late(1)
    blk.prefetch(2)
    np.testing.assert_array_equal(blk.s2(), _mm8(q["DsP"], qB))
    qY = _codes(rng, S, R)                     # [Yr; Yi] (ks rows, kr)
    blk.put_cols(0, blk.ldy, qY)
    blk.late(2)
    blk.prefetch(3)
    np.testing.assert_array_equal(blk.ia(), _mm8(q["EsP"], qY))
    qT = _codes(rng, 2 * S, R)                 # [Tr; Ti] (t2 rows, kr)
    blk.put_rows(blk.B, blk.ldt, qT)
    blk.late(3)
    y = blk.ib()
    np.testing.assert_array_equal(y[0], _mm8(qT[:S], q["Err"]))
    np.testing.assert_array_equal(y[1], _mm8(qT[S:], q["Eri"]))


def _q8(v):
    """The kernel's q8 over a stage tensor: (codes, scale), f32 op by op."""
    f32 = np.float32
    s = np.maximum(np.abs(v).max(), f32(1e-20)) * f32(1.0 / 127.0)
    inv = f32(1.0) / s
    return np.clip(np.rint(v * inv), -127, 127).astype(np.int8), s


def _kernel_row(blk, xn, kh, n, L):
    """One row of csrc/fftconv_int8.cu without the mean split, in numpy
    f32 op by op: its stages' products through ``_Block`` (staged factors,
    ldmatrix, mma tiles), the epilogues' f32 arithmetic at the index maps
    the tiles give (k = kr + R ks, the irfft scale c_k, the Nyquist bin
    from B's column kr = 0, the conjugate twiddles, two scales for T), the
    output in time order t = t1 S + t2.  Returns y + D-free conv (L,)."""
    f32 = np.float32
    R, S, Rc, q = blk.R, blk.S, blk.Rc, blk.q
    sc = {k: f32(v) for k, v in q8.int8_consts(n, L)["scales"].items()}
    twr, twi = q8.int8_consts(n, L)["tw"]
    x = np.zeros(Rc * S, f32)
    x[:L] = xn
    qx, sx = _q8(x.reshape(Rc, S).T)                    # [t2][t1]
    blk.mem[:] = 0
    blk.load(0)
    blk.put_x(qx)
    blk.prefetch(1)
    A = blk.s1().astype(f32)
    xr, xi = A[0] * (sx * sc["Drr"]), A[1] * (sx * sc["Dri"])
    qB, sB = _q8(np.concatenate([xr * twr - xi * twi, xr * twi + xi * twr]))
    blk.put_cols(blk.B, blk.ldb, qB)
    s = int(sum((1 - 2 * (j & 1)) * int(qB[j, 0]) for j in range(S)))
    x_nyq = f32(127 * s) * (sB * sc["Alt8"])
    yn = x_nyq * (f32(kh[n // 2].real) * (f32(1.0) / f32(n)))
    blk.late(1)
    blk.prefetch(2)
    X = blk.s2().astype(f32) * (sB * sc["DsP"])
    Q2 = S // 2
    k = np.arange(R)[None, :] + R * np.arange(Q2)[:, None]
    c_in = f32(2.0) / f32(n)
    ck = np.where(k == 0, f32(0.5) * c_in, c_in).astype(f32)
    Kr, Ki = ck * kh[k].real.astype(f32), ck * kh[k].imag.astype(f32)
    Xr, Xi = X[:Q2], X[Q2:]
    qY, sY = _q8(np.concatenate([Xr * Kr - Xi * Ki, Xr * Ki + Xi * Kr]))
    blk.put_cols(0, blk.ldy, qY)
    blk.late(2)
    blk.prefetch(3)
    Z = blk.ia().astype(f32) * (sY * sc["EsP"])
    zr, zi = Z[:S].copy(), Z[S:]
    zr[:, 0] = zr[:, 0] + np.where(np.arange(S) & 1, -yn, yn).astype(f32)
    qTr, sTr = _q8(zr * twr - zi * -twi)
    qTi, sTi = _q8(zr * -twi + zi * twr)
    blk.put_rows(blk.B, blk.ldt, np.concatenate([qTr, qTi]))
    blk.late(3)
    y = blk.ib().astype(f32)
    y = y[0] * (sTr * sc["Err"]) - y[1] * (sTi * sc["Eri"])  # [t2][t1]
    return y.T.reshape(-1)[:L]


@pytest.mark.parametrize("n,L,H,dtype", [
    (2048, 1000, 2, torch.float32), (2048, 1000, 2, torch.bfloat16),
    (32768, 16000, 1, torch.float32)])
def test_kernel_rows_give_the_plain_version(n, L, H, dtype):
    """Whole rows through the model of the kernel (no mean split: the
    JAX algorithm, every float operation the plain version's) give
    ``fftconv_int8_ref``'s output bit for bit, the D-skip and the form's
    GELU applied as the plain version applies them."""
    rng = np.random.RandomState(L + H)
    B = 1
    u = torch.from_numpy(rng.randn(B, H, L).astype(np.float32)).to(dtype)
    a = torch.from_numpy((0.5 + rng.rand(B, L)).astype(np.float32))
    c = torch.from_numpy((0.3 * rng.randn(B, L)).astype(np.float32))
    bias = torch.from_numpy((0.3 * rng.randn(B, H)).astype(np.float32))
    D = torch.from_numpy((0.3 * rng.randn(H)).astype(np.float32))
    khat = torch.fft.rfft(torch.from_numpy(
        (0.05 * rng.randn(H, L)).astype(np.float32)), n=n)
    ref = ops.fftconv_int8_ref(u, a, c, bias, khat, D)
    xn = u.float() * a[:, None, :] + c[:, None, :] + bias[:, :, None]
    blk = _Block(n, L)
    y = np.stack([_kernel_row(blk, xn[0, h].numpy(), khat[h].numpy(), n, L)
                  for h in range(H)])[None]
    gelu = ops.gelu_fast if dtype == torch.bfloat16 else torch.nn.functional.gelu
    out = gelu(torch.from_numpy(y) + D[:, None] * xn).to(dtype)
    assert torch.equal(out, ref)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card, so that the wrapper takes
    its launch route up to the launcher."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("n,L", list(TIERS))
@pytest.mark.parametrize("B", [4, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_passes_the_plan(monkeypatch, n, L, B, dtype):
    """On a CUDA tensor the wrapper launches ``dwst_fftconv_int8`` with
    exactly the arguments its ctypes signature names, the stream apart
    (addresses where it takes pointers, ints where it takes ints), the
    layout and form, then the plan's ints (``plan_args(int8_plan(n,
    L))``), and counts one launch."""
    calls = []
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *a: calls.append(
        (name, a)))
    monkeypatch.setattr(cuda_lib, "check", lambda *a: None)
    H = 4
    u = torch.zeros(B, H, L, dtype=dtype).as_subclass(_OnCard)
    f = torch.zeros(B, L)
    khat = torch.zeros(H, n // 2 + 1, dtype=torch.complex64)
    before = ops.fftconv_int8.launches
    ops.fftconv_int8(u, f, f, torch.zeros(B, H), khat, torch.zeros(H),
                     torch.zeros(H, L))
    assert ops.fftconv_int8.launches == before + 1
    (name, args), = calls
    sig = cuda_lib._SIGNATURES[name]
    assert name == "dwst_fftconv_int8" and len(args) + 1 == len(sig)
    for v, t in zip(args, sig):
        assert isinstance(v, int) and (t is cuda_lib._P or abs(v) < 2 ** 31)
    plan = q8.plan_args(q8.int8_plan(n, L))
    assert args[10:18] == (B, H, L, n, *TIERS[n, L],
                           int(dtype == torch.bfloat16))
    assert args[18:] == plan and len(plan) == 12
