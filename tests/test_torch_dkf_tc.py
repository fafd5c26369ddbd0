"""Kernels 5 and 5f on their radix-16 route, checked without a card: the
plan function at every FFT size the bf16 paths launch 5f at and its
refusals; a plain torch model of the kernel's schedule (csrc/fftconv.cu::
fftconv_dkf_r16_kernel: the load pass that reads only the packed row's
nonzero part, the radix-R0 and radix-16 Stockham passes with their index
maps, the last forward pass in place, the split of each thread's pairs
into the real row's half spectrum from its own slots, the bins shared out
over a channel's cluster, and the batch sum in b order, chunk by chunk,
with the c_k fold last) against the JAX ``fast=True`` kernel in interpret
mode, the port's plain version and float64; the wrappers' launch
arguments; on CPU tensors the wrappers are their plain versions."""

import importlib

import numpy as np
import pytest
import torch

from test_torch_fftconv_tc import _OnCard, _bf16_sizes
from torch_r16 import (_dft, _held, _pass, _root, _roots_chain,
                       _roots_pass_chain)

import jax
import jax.numpy as jnp

from diffwave_sashimi_tpu.ops import fftconv2 as f2
from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.ops import chmix, cuda_lib

# the module (ops.fftconv is the training entry's wrapper)
fc = importlib.import_module("diffwave_sashimi_torch.ops.fftconv")

BF = torch.bfloat16
C64 = torch.complex64
# Kernel 5f vs JAX at bf16, pulled back to the time-domain kernel (as
# tests/test_torch_bf16_train.py holds the plain version): JAX's chain runs
# its DFT matmuls on bf16 operands, the port's transforms in f32
TOL_DKF_BF16 = 1e-2


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---- the plan -------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("n", fc.RADIX16_SIZES)
def test_dkf_plan_at_every_radix16_size(n, B):
    """At every size the bf16 paths launch 5f at, the plan takes the
    radix-16 route with min(B, 4) rows a chunk, DKF_PER_BLOCK[n]
    transforms a block of kernel 1f's radix-16 transform (M / 32 threads
    and M + M/16 slots of 8 bytes each): a chunk's 8 one-warp transforms
    at n 2048, one elsewhere; ceil(2 rows / per_block) blocks a cluster,
    within the portable 8; a chunk size given is taken."""
    assert n in {s for s, _ in _bf16_sizes()}
    plan = fc.dkf_plan(n, B)
    r16 = fc.radix16_plan(n)
    q = fc.DKF_PER_BLOCK[n]
    assert plan.route == "radix16" and plan.per_block == q
    assert plan.rows == min(B, fc.DKF_MAX_ROWS)
    assert plan.cluster == -(-2 * plan.rows // q) <= 8
    assert (plan.threads, plan.smem) == (q * r16.threads, q * r16.smem)
    assert plan.threads == q * n // 64 <= 512
    assert plan.smem == 8 * q * (n // 2 + n // 32) <= chmix.SMEM_LIMIT
    # a chunk's 8 one-warp transforms a block at n 2048, one elsewhere
    assert q == (2 * fc.DKF_MAX_ROWS if n == 2048 else 1)
    for rows in range(1, fc.DKF_MAX_ROWS + 1):
        assert fc.dkf_plan(n, B, rows) == plan._replace(
            rows=rows, cluster=-(-2 * rows // q))


def test_dkf_plan_other_sizes_and_refusals():
    """Every other power of two takes the Stockham kernel; a batch below 1,
    a chunk size outside 1 .. 4 or a size that is not a power of two >= 32
    is refused."""
    for n in (32, 1024, 4096, 65536):
        assert fc.dkf_plan(n, 4) == fc.DKF_STOCKHAM
    for n, B in ((2048, 0), (8192, -1), (3000, 4), (16, 4), (0, 1)):
        with pytest.raises(ValueError):
            fc.dkf_plan(n, B)
    for rows in (0, 5):
        with pytest.raises(ValueError):
            fc.dkf_plan(2048, 4, rows)


# ---- the schedule model ---------------------------------------------------

def _spectra(x, L, plan):
    """The kernel's half spectra of real rows x (R, L) f32: (R, M)
    complex64 in natural order, X[k] at k >= 1 and (X[0], X[M]), both
    real, packed in k = 0, as the block's slots hold them after the
    split."""
    NT = plan.threads // plan.per_block
    M = 32 * NT
    R0 = fc.radix16_plan(2 * M).radices[0]
    # the load pass: packed p = j + r M/R0 read only where 2p < L (where
    # L <= M the butterflies' upper half is never read), radix R0 at Ns 1
    Lp = (L + 1) // 2
    xp = torch.zeros(x.shape[0], 2 * Lp)
    xp[:, :L] = x
    packed = torch.complex(xp[:, 0::2], xp[:, 1::2])
    j, r = torch.arange(M // R0), torch.arange(R0)
    p = j[:, None] + r[None, :] * (M // R0)
    v = torch.zeros(x.shape[0], M // R0, R0, dtype=C64)
    live = p < Lp
    v[:, live] = packed[:, p[live]]
    if L <= M:
        assert not live[:, R0 // 2:].any()
    z = torch.empty(x.shape[0], M, dtype=C64)
    z[:, j[:, None] * R0 + r[None, :]] = _dft(v, False)
    # the forward radix-16 passes, all but the last
    Ns = R0
    while Ns * 16 < M:
        z = _pass(z, 16, Ns, False, NT, _roots_pass_chain)
        Ns *= 16
    assert Ns * 16 == M
    # the last forward pass in place on each thread's two butterflies: j0
    # = t's roots a[i] = W_M^(2^i t), j1 = M/16 - t's W_16^(2^i)
    # conj(a[i]) (thread 0's j1 = M/32: W_32^(2^i))
    k, partner, j1 = _held(M)
    T, S = M // 32, M // 16
    js = torch.cat([torch.arange(T)[:, None].expand(T, 16),
                    j1[:, None].expand(T, 16)], dim=1)
    rs = torch.arange(32) % 16
    vals = torch.stack([z[:, js[:, :16] + rs[None, :16] * S],
                        z[:, js[:, 16:] + rs[None, 16:] * S]], dim=2)
    t = torch.arange(T)
    a = torch.stack([_root(t << i, M) for i in range(4)], -1)
    a1 = torch.stack([_root(S << i, M) * a[:, i].conj()
                      for i in range(4)], -1)
    a1[0] = torch.stack([_root(T << i, M) for i in range(4)])
    vals = vals * torch.stack([_roots_chain(a), _roots_chain(a1)], dim=1)
    vals = _dft(vals, False).reshape(x.shape[0], T, 32)   # Z[k] at slots
    # the split, pair by pair from the thread's own slots: the thread's
    # pairs (csrc r16_bin) are outputs 0-15 of j0 for t >= 1; for t = 0
    # outputs 1-8 of j0 (8: M/2, its own partner) and 0-7 of j1
    s = torch.arange(32)
    prim = (s < 16).expand(T, 32).clone()
    prim[0] = ((s >= 1) & (s <= 8)) | ((s >= 16) & (s < 24))
    q = torch.where(prim, s.expand(T, 32), partner)    # the pair's first
    a = torch.gather(vals, 2, q[None].expand_as(vals))
    c = torch.gather(vals, 2, torch.gather(partner, 1, q)[None].expand_as(
        vals))
    w = _root(torch.gather(k, 1, q), 2 * M)            # W^k of the first
    e = 0.5 * (a + c.conj())
    o = (a - c.conj()) / 2j
    X = torch.where(prim, e + w * o, (e - w * o).conj())
    z0 = vals[:, 0, 0]                                 # DC and Nyquist
    X[:, 0, 0] = torch.complex(z0.real + z0.imag, z0.real - z0.imag)
    out = torch.empty(x.shape[0], M, dtype=C64)
    out[:, k] = X
    return out


def _bins(M, C):
    """Block c of a channel's cluster of C sums the bins [lo, hi)."""
    span = -(-M // C)
    return [(min(M, c * span), min(M, c * span + span)) for c in range(C)]


def _model(u, g, n, rows=None):
    """The kernel's result on u, g (B, H, L) (bf16 or f32): (H, n/2+1)
    complex64.  A channel's cluster of blocks walks the batch in chunks of
    rows (the plan's, by default); block c sums its bins, each bin's sum
    starting at 0 and taking conj(U_b) G_b in b order, crossing chunks
    unscaled; c_k, a power of two, scales the sums after the last.  Real
    arithmetic, one rounding an operation, as the kernel's."""
    B, H, L = u.shape
    plan = fc.dkf_plan(n, B, rows)
    rows, M = plan.rows, n // 2
    U = _spectra(u.float().reshape(B * H, L), L, plan).reshape(B, H, M)
    G = _spectra(g.float().reshape(B * H, L), L, plan).reshape(B, H, M)
    sre, sim = torch.empty(H, M), torch.empty(H, M)   # the running sums
    bins = _bins(M, plan.cluster)
    assert bins[0][0] == 0 and bins[-1][1] == M and all(
        a[1] == b[0] for a, b in zip(bins, bins[1:]))
    for b0 in range(0, B, rows):
        for lo, hi in bins:
            re = torch.zeros(H, hi - lo) if b0 == 0 else sre[:, lo:hi]
            im = torch.zeros(H, hi - lo) if b0 == 0 else sim[:, lo:hi]
            for b in range(b0, min(B, b0 + rows)):
                ur, ui = U[b].real[:, lo:hi], U[b].imag[:, lo:hi]
                gr, gi = G[b].real[:, lo:hi], G[b].imag[:, lo:hi]
                pr, pi = ur * gr + ui * gi, ur * gi - ui * gr
                if lo == 0:      # (DC, Nyquist): the real parts' products
                    pr[:, 0], pi[:, 0] = ur[:, 0] * gr[:, 0], \
                        ui[:, 0] * gi[:, 0]
                re, im = re + pr, im + pi
            sre[:, lo:hi], sim[:, lo:hi] = re, im
    out = torch.empty(H, M + 1, dtype=C64)
    out[:, :M] = torch.complex(sre, sim) * (2.0 / n)
    out[:, 0] = torch.complex(sre[:, 0] / n, torch.zeros(H))
    out[:, M] = torch.complex(sim[:, 0] / n, torch.zeros(H))
    return out


def _dkf64(u, g, n):
    """The function in float64 on the same (rounded) inputs."""
    U = torch.fft.rfft(u.double(), n=n)
    G = torch.fft.rfft(g.double(), n=n)
    c = torch.full((n // 2 + 1,), 2.0 / n, dtype=torch.float64)
    c[0] = c[-1] = 1.0 / n
    return (U.conj() * G).sum(dim=0) * c


def _inputs(B, H, L, seed, dtype=BF):
    rng = np.random.RandomState(seed)
    u = torch.from_numpy((0.3 * rng.randn(B, H, L)).astype(np.float32))
    g = torch.from_numpy(rng.randn(B, H, L).astype(np.float32))
    return u.to(dtype), g.to(dtype)


def _err(out, ref):
    return float((out.to(torch.complex128) - ref).abs().max())


def _l2(out, ref):
    """Relative L2 error of out against the complex128 ref."""
    return float((out.to(torch.complex128) - ref).abs().norm()
                 / ref.abs().norm())


def _hold(u, g, n):
    """The schedule vs float64 of the same inputs: within 1e-6 of
    max|ref| (f32 rounding of 5-6 passes and a B-term sum), its relative
    L2 error at most twice the plain version's (torch.fft's; the twiddles
    as products of once-rounded roots keep it near 1.4x, where running
    products cost about 4x), and within 1e-5 of max|ref| of the plain
    version ``fftconv_dkf_ref``."""
    out = _model(u, g, n)
    ref64 = _dkf64(u, g, n)
    plain = ops.fftconv_dkf_ref(u, g, n)
    scale = float(ref64.abs().max())
    assert _err(out, ref64) <= 1e-6 * scale
    assert _l2(out, ref64) <= 2 * _l2(plain, ref64)
    assert _err(out, plain.to(torch.complex128)) <= 1e-5 * scale
    return out


# (L, n, B): each FFT size with even and odd L, L > n/2 at n 2048 (the
# load reads the upper half too, the radix-4 first pass), the vocoder's
# deepest length at n 16384 (the radix-2 first pass), SC09's top tier at
# n 32768 (four passes); B 1, 3 and 4
SCHEDULE_CASES = [(1000, 2048, 4), (999, 2048, 3), (1500, 2048, 1),
                  (4000, 8192, 3), (4001, 8192, 4), (8960, 16384, 1),
                  (7999, 16384, 3), (16000, 32768, 4), (15999, 32768, 1)]


@pytest.mark.parametrize("L,n,B", SCHEDULE_CASES)
def test_schedule_model_vs_float64_and_plain(L, n, B):
    """The schedule's result on bf16 inputs held as ``_hold`` says; the
    DC and Nyquist bins real."""
    u, g = _inputs(B, 2, L, seed=L + B)
    out = _hold(u, g, n)
    assert float(out[:, 0].imag.abs().max()) == 0.0
    assert float(out[:, -1].imag.abs().max()) == 0.0


def test_schedule_model_f32_inputs():
    """Kernel 5's form (u and g f32) runs the same schedule, held as
    ``_hold`` says, at n 8192 with odd L."""
    _hold(*_inputs(3, 2, 3001, seed=11, dtype=torch.float32), 8192)


@pytest.mark.parametrize("B", [5, 6])
def test_batch_sum_is_the_same_for_every_chunk_size(B):
    """The batch terms are added in b order whatever the chunk size: the
    schedule's result at 1, 2, 3 and 4 rows a chunk (clusters of 2 to 8
    blocks, the bins shared out differently, the sums crossing chunks
    unscaled) is the same bit for bit."""
    u, g = _inputs(B, 3, 1000, seed=B)
    outs = [_model(u, g, 2048, rows) for rows in (1, 2, 3, 4)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


@pytest.mark.parametrize("L,n,B", [(1000, 2048, 3), (4000, 8192, 4)])
def test_schedule_matches_jax_fast_kernel(L, n, B):
    """The schedule vs JAX ``fftconv2_dkf`` with fast=True on its bf16
    layout (interpret mode), both pulled back to the time-domain kernel k
    (H, n) (JAX through the vjp of kernel_spectrum(k, lay), the port's
    through the vjp of rfft(k, n)), at TOL_DKF_BF16 of max|ref|."""
    H = 4
    u, g = _inputs(B, H, L, seed=7 + L)
    lay = f2.choose_layout(L, n, H, bf16=True)
    ju, jg = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
              for t in (u, g))
    dkfr, dkfi = f2.fftconv2_dkf(f2.to_compact(ju, lay),
                                 f2.to_compact(jg, lay), lay, True)
    k = (0.3 * np.random.RandomState(L).randn(H, n)).astype(np.float32)
    _, vjp = jax.vjp(lambda kk: f2.kernel_spectrum(kk, lay), jnp.asarray(k))
    (ref,) = vjp((dkfr, dkfi))
    ref = np.asarray(ref)
    tk = torch.from_numpy(k).requires_grad_(True)
    (dk,) = torch.autograd.grad(torch.fft.rfft(tk, n=n), tk,
                                _model(u, g, n))
    assert np.abs(dk.numpy() - ref).max() <= TOL_DKF_BF16 * np.abs(ref).max()


def test_bins_cover_the_spectrum_once():
    """At every size and chunk size (1-4 rows: clusters of 1 to 8 blocks),
    the blocks' bin ranges cover 0 .. M-1 once, each at most ceil(M / C)
    bins; a cluster's blocks hold the chunk's 2 rows transforms, at most
    per_block a block and fewer than per_block spare."""
    for n in fc.RADIX16_SIZES:
        M = n // 2
        for rows in range(1, fc.DKF_MAX_ROWS + 1):
            plan = fc.dkf_plan(n, 4, rows)
            C = plan.cluster
            assert 0 <= C * plan.per_block - 2 * rows < plan.per_block
            covered = torch.zeros(M, dtype=torch.int64)
            for lo, hi in _bins(M, C):
                assert hi - lo <= -(-M // C)
                covered[lo:hi] += 1
            assert bool((covered == 1).all())


# ---- the wrappers -------------------------------------------------------

@pytest.mark.parametrize("B", [1, 4, 6])
@pytest.mark.parametrize("n,L", _bf16_sizes() + [(1024, 500)])
@pytest.mark.parametrize("dtype", [BF, torch.float32], ids=["5f", "5"])
def test_wrappers_pass_their_signatures(monkeypatch, n, L, B, dtype):
    """Kernel 5's and 5f's wrappers hand their entry point exactly the
    arguments its ctypes signature names, the stream apart (addresses where
    it takes pointers, ints where it takes ints; the plan dkf_plan gives,
    rows, threads and smem, last), and count one launch."""
    calls = []
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *a: calls.append(
        (name, a)))
    monkeypatch.setattr(cuda_lib, "check", lambda *a: None)
    H = 8
    u = torch.zeros(B, H, L, dtype=dtype).as_subclass(_OnCard)
    wrapper = ops.fftconv_dkf_bf16 if dtype == BF else ops.fftconv_dkf
    before = {k: fn.launches for k, fn in ops.COUNTED.items()}
    out = ops.fftconv_dkf(u, u, n)
    assert tuple(out.shape) == (H, n // 2 + 1) and out.dtype == C64
    after = {k: fn.launches for k, fn in ops.COUNTED.items()}
    name = "fftconv_dkf_bf16" if dtype == BF else "fftconv_dkf"
    assert after == dict(before, **{name: before[name] + 1})
    assert wrapper.launches == before[name] + 1
    (entry, args), = calls
    assert entry == ("dwst_fftconv_dkf_bf16" if dtype == BF
                     else "dwst_fftconv_dkf")
    sig = cuda_lib._SIGNATURES[entry]
    assert len(args) + 1 == len(sig)
    for a, t in zip(args, sig):
        assert isinstance(a, int) and (t is cuda_lib._P or abs(a) < 2 ** 31)
    plan = fc.dkf_plan(n, B)
    assert args[3:] == (B, H, L, n, plan.rows, plan.threads, plan.smem)
    assert plan.route == "stockham" or plan.cluster * plan.per_block >= \
        2 * min(B, fc.DKF_MAX_ROWS)
    assert plan.route == ("stockham" if n == 1024 else "radix16")


@pytest.mark.parametrize("plan", [fc.DKF_STOCKHAM, fc.dkf_plan(2048, 3)],
                         ids=["stockham", "radix16"])
def test_launcher_takes_the_plan_given(monkeypatch, plan):
    """``launch_dkf`` launches on the plan it is handed (chip_smoke.py
    times both routes in turns with it) and counts nothing."""
    calls = []
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *a: calls.append(
        (name, a[-3:])))
    monkeypatch.setattr(cuda_lib, "check", lambda *a: None)
    u = torch.zeros(3, 8, 1000, dtype=BF).as_subclass(_OnCard)
    before = {k: fn.launches for k, fn in ops.COUNTED.items()}
    fc.launch_dkf(u, u, 2048, plan)
    assert calls == [("dwst_fftconv_dkf_bf16",
                      (plan.rows, plan.threads, plan.smem))]
    assert {k: fn.launches for k, fn in ops.COUNTED.items()} == before


def test_bf16_wrapper_refuses_other_dtypes(monkeypatch):
    """Kernel 5f's wrapper takes bf16 u and g only: f32 tensors on the
    card raise before any launch (kernel 5's wrapper takes those)."""
    calls = []
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *a: calls.append(
        name))
    u = torch.zeros(2, 4, 1000).as_subclass(_OnCard)
    with pytest.raises(ValueError):
        ops.fftconv_dkf_bf16(u, u, 2048)
    assert calls == []


def test_wrappers_are_their_plain_versions_on_cpu():
    """On CPU tensors both wrappers return the plain version's result bit
    for bit and count no launch."""
    for dtype in (BF, torch.float32):
        u, g = _inputs(3, 4, 700, seed=2, dtype=dtype)
        before = {k: fn.launches for k, fn in ops.COUNTED.items()}
        ref = ops.fftconv_dkf_ref(u, g, 2048)
        assert torch.equal(ops.fftconv_dkf(u, g, 2048), ref)
        wrapper = ops.fftconv_dkf_bf16 if dtype == BF else ops.fftconv_dkf
        assert torch.equal(wrapper(u, g, 2048), ref)
        assert {k: fn.launches for k, fn in ops.COUNTED.items()} == before
