"""Kernel 8's lanes design (csrc/cauchy.cu::cauchy_bwd_lanes_kernel), checked
without a card: its plan (``ops.cauchy.cauchy_bwd_plan``) at every shape the
shipped training paths launch it at; a plain torch model of the kernel's
schedule (the plan's splits and chunks, each warp's positions, the per-lane
sums, the power-of-two scaling with one reciprocal, the warps' pairwise sum
and the splits' four chains) against the JAX custom VJP of
``cauchy_sym_pallas`` (its ``_bwd_kernel`` in interpret mode), the plain
version ``cauchy_bwd_ref`` and a complex128 evaluation, on the coefficients
and nodes of a freshly initialised S4 kernel; the wrapper's launch
arguments (g read where it lies); the refusals; on CPU tensors the wrapper
is its plain version.  Tolerances are on the max error relative to the max
|reference| of each output."""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (single-threaded torch)

import jax
import jax.numpy as jnp

from diffwave_sashimi_tpu.ops.cauchy_pallas import _cauchy_quad
from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.config import load_config
from diffwave_sashimi_torch.models.s4 import S4, SSKernelNPLR, _fft_nodes
from diffwave_sashimi_torch.ops import cauchy as cq
from diffwave_sashimi_torch.ops import cuda_lib

SMS = 132                       # an H100 SXM's SMs
SMEM_SM = 232448                # shared memory of one SM a kernel may use
WARPS = cq.BWD_THREADS // 32
UNIT = WARPS * cq.BWD_CHUNK     # a span is whole chunks for every warp


def _shipped_shapes():
    """(K, M, N, Lz) of every kernel-8 launch of the shipped training
    paths: each UNet tier of SC09's model and of phase 24's d_model 256
    (K = (1 + rank)(channels + rank) = 6 for the bidirectional rank-1
    layer, N = d_state / 2 conjugate pairs, Lz = L // 2 + 1)."""
    m = load_config(overrides=["experiment=sc09"]).model
    N = inspect.signature(S4).parameters["d_state"].default // 2
    out = []
    for d_model in (m.d_model, 256):
        H, L = d_model, m.L
        for i in range(len(m.pool) + 1):
            out.append((6, H, N, L // 2 + 1))
            if i < len(m.pool):
                H, L = H * m.expand, L // m.pool[i]
    return out


def test_shipped_shapes_are_the_paths():
    assert _shipped_shapes() == [(6, 128, 32, 8001), (6, 256, 32, 2001),
                                 (6, 512, 32, 501), (6, 256, 32, 8001),
                                 (6, 512, 32, 2001), (6, 1024, 32, 501)]


PLANS = {(6, 128, 32, 8001): (512, 16), (6, 256, 32, 2001): (512, 4),
         (6, 512, 32, 501): (512, 1), (6, 256, 32, 8001): (512, 16),
         (6, 512, 32, 2001): (512, 4), (6, 1024, 32, 501): (512, 1)}


@pytest.mark.parametrize("shape", _shipped_shapes())
def test_plan_at_every_shipped_shape(shape):
    """The plan covers [0, Lz) with whole chunks for every warp and no
    empty block, keeps each thread's chain at most BWD_CHAIN positions,
    gives each of 132 SMs at least two blocks, and its shared memory fits
    a block without opting in (48 KB) and the SM's blocks together."""
    K, M, N, Lz = shape
    plan = cq.cauchy_bwd_plan(K, M, N, Lz, SMS)
    assert (plan.span, plan.splits) == PLANS[shape]
    assert plan.span % UNIT == 0
    assert (plan.splits - 1) * plan.span < Lz <= plan.splits * plan.span
    assert plan.span // WARPS <= cq.BWD_CHAIN
    assert M * plan.splits >= 2 * SMS
    assert plan.smem == max(WARPS * 2 * cq.BWD_CHUNK * (1 + (K + 1) // 2)
                            * 16, WARPS * (2 * K + 2) * 32 * 4) == 16384
    assert plan.smem <= 48 * 1024
    assert cq.BWD_BLOCKS_PER_SM * plan.smem <= SMEM_SM


@pytest.mark.parametrize("K", range(1, cq.BWD_KMAX + 1))
@pytest.mark.parametrize("Lz", [1, 63, 64, 65, 96, 501, 2001, 8001, 16001])
def test_plan_covers_every_length(K, Lz):
    """At any K the kernel has an instance for and any length, the plan's
    blocks cover the positions in whole chunks for every warp, with no
    empty block."""
    plan = cq.cauchy_bwd_plan(K, 64, 32, Lz, SMS)
    assert plan.span >= UNIT and plan.span % UNIT == 0
    assert (plan.splits - 1) * plan.span < Lz <= plan.splits * plan.span
    assert plan.span // WARPS <= cq.BWD_CHAIN
    assert plan.smem <= 48 * 1024


def test_source_constants_are_the_plans():
    """The plan's constants are the kernel's (csrc/cauchy.cu): its threads,
    chunk, blocks an SM up to K 6 (its __launch_bounds__, one less past
    K 6), lanes and KMAX."""
    src = (Path(cq.__file__).parents[1] / "csrc" / "cauchy.cu").read_text()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", src)}
    assert const["BWD_THREADS"] == cq.BWD_THREADS
    assert const["BWD_CHUNK"] == cq.BWD_CHUNK
    assert const["BWD_BLOCKS_PER_SM"] == cq.BWD_BLOCKS_PER_SM
    assert const["BWD_LANES"] == cq.BWD_NMAX
    assert const["KMAX"] == cq.BWD_KMAX
    assert re.search(r"__launch_bounds__\(\s*BWD_THREADS, K > 6 \? "
                     r"BWD_BLOCKS_PER_SM - 1 : BWD_BLOCKS_PER_SM\)", src)
    assert "atomicAdd" not in src


@pytest.mark.parametrize("K,N,what", [(0, 32, "K 0"), (9, 32, "K 9"),
                                      (6, 33, "N 33"), (6, 0, "N 0")])
def test_plan_refuses_by_name(K, N, what):
    with pytest.raises(ValueError, match=f"kernel 8 .*{what}"):
        cq.cauchy_bwd_plan(K, 128, N, 8001, SMS)


# ---- a plain torch model of the kernel's schedule ------------------------

def _pow2_inverse(x):
    """The kernel's pow2_inverse: 2^-e for x = 2^e x [1, 2), from x's
    exponent bits."""
    bits = x.contiguous().view(torch.int32) & 0x7F800000
    return (0x7F000000 - bits).view(torch.float32)


def _pairwise(v, dim):
    """The kernel's fixed pairwise order over a power-of-two axis:
    ((v0 + v1) + (v2 + v3)) + ..."""
    while v.shape[dim] > 1:
        v = v.unflatten(dim, (-1, 2))
        v = v.select(dim + 1, 0) + v.select(dim + 1, 1)
    return v.squeeze(dim)


def _four_chains(part):
    """cauchy_bwd_reduce_kernel's order over the splits (axis 0): four
    interleaved chains (a tail past a multiple of four into the first),
    then (s0 + s1) + (s2 + s3)."""
    S = part.shape[0]
    acc = [torch.zeros_like(part[0]) for _ in range(4)]
    for s in range(S - S % 4):
        acc[s % 4] = acc[s % 4] + part[s]
    for s in range(S - S % 4, S):
        acc[0] = acc[0] + part[s]
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def schedule_model(a, b, c, d, z, g_re, g_im, plan):
    """What cauchy_bwd_lanes_kernel computes, in f32 torch ops in the
    kernel's order (products and sums rounded apart where the kernel fuses
    them): block (s, m), warp w and lane n sum, in order, the positions of
    the block's chunks w, w + WARPS, ... of BWD_CHUNK positions, with the
    lane's state's coefficients (lanes past N as c 0, d 1, a = b = 0);
    the warps' sums pairwise, the splits' in four chains.  Returns (da,
    db, dc, dd)."""
    K, M, N = a.shape
    Lz, S, L32 = z.shape[0], plan.splits, 32
    pad = lambda t, v: torch.cat(                            # noqa: E731
        [t, torch.full((*t.shape[:-1], L32 - N), v)], -1)
    cn, dn = pad(c, 0.0), pad(d, 1.0)                        # (M, 32)
    an, bn = pad(a, 0.0), pad(b, 0.0)                        # (K, M, 32)
    zr, zi = z.real.contiguous(), z.imag.contiguous()
    sa = torch.zeros(K, S, WARPS, M, L32)
    sb = torch.zeros(K, S, WARPS, M, L32)
    sc = torch.zeros(S, WARPS, M, L32)
    sd = torch.zeros(S, WARPS, M, L32)
    s_i = torch.arange(S)[:, None]
    w_i = torch.arange(WARPS)[None, :]
    for t in range(plan.span // WARPS):
        i, j = divmod(t, cq.BWD_CHUNK)       # the warp's i-th chunk, j-th
        l = s_i * plan.span + (w_i + i * WARPS) * cq.BWD_CHUNK + j
        ok = (l < Lz)[..., None, None]                       # (S, W, 1, 1)
        lc = l.clamp(max=Lz - 1)
        x, y = zr[lc][..., None, None], zi[lc][..., None, None]
        z2r, z2i = x * x - y * y, 2.0 * x * y
        den_r, den_i = z2r + cn * x + dn, z2i + cn * y
        s = _pow2_inverse(torch.maximum(den_r.abs(), den_i.abs()))
        sr, si = den_r * s, den_i * s
        tt = (1.0 / (sr * sr + si * si)) * s
        g0r, g0i = sr * tt, -si * tt
        g1r, g1i = x * g0r - y * g0i, x * g0i + y * g0r
        Ar = Ai = Br = Bi = torch.zeros(())
        for k in range(K):
            gr = g_re[k][:, lc].permute(1, 2, 0)[..., None]  # (S, W, M, 1)
            gi = g_im[k][:, lc].permute(1, 2, 0)[..., None]
            sa[k] = torch.where(ok, sa[k] + gr * g1r + gi * g1i, sa[k])
            sb[k] = torch.where(ok, sb[k] + gr * g0r + gi * g0i, sb[k])
            Ar, Ai = Ar + an[k] * gr, Ai - an[k] * gi
            Br, Bi = Br + bn[k] * gr, Bi - bn[k] * gi
        tr, ti = x * Ar - y * Ai + Br, x * Ai + y * Ar + Bi
        wr, wi = g0r * tr - g0i * ti, g0r * ti + g0i * tr
        sc = torch.where(ok, sc - g1r * wr + g1i * wi, sc)
        sd = torch.where(ok, sd - g0r * wr + g0i * wi, sd)
    q = torch.cat([sa, sb, sc[None], sd[None]])              # (Q, S, W, M, 32)
    q = _pairwise(q, 2)                                      # (Q, S, M, 32)
    q = _four_chains(q.transpose(0, 1))[..., :N]             # (Q, M, N)
    return q[:K], q[K:2 * K], q[2 * K], q[2 * K + 1]


def _s4_inputs(H, L, tail=None, seed=0):
    """The real coefficients (a, b, c, d) and nodes z that a freshly
    initialised bidirectional S4 kernel hands kernel 8 (K 6, N 32), and
    seeded normal cotangents (g_re, g_im); with ``tail``, only the last
    ``tail`` nodes (they hold the Nyquist node)."""
    kern = SSKernelNPLR(H, N=64, l_max=L, channels=2,
                        generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        a, b, c, d = cq.quad_operands(*kern.cauchy_operands()[:2])
    z = torch.from_numpy(_fft_nodes(L)[1])
    if tail:
        z = z[-tail:].contiguous()
    rng = np.random.RandomState(seed + 1)
    g = [torch.from_numpy(rng.randn(*a.shape[:2], z.shape[0])
                          .astype(np.float32)) for _ in range(2)]
    return a, b, c, d, z, *g


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))


CASES = [(1000, None), (4000, None), (16000, 96)]       # Lz 501, 2001, tail


@pytest.mark.parametrize("L,tail", CASES, ids=["Lz501", "Lz2001", "nyquist"])
def test_schedule_model_matches_plain_and_complex128(L, tail):
    """The schedule model at H 8 vs cauchy_bwd_ref (complex64) and a
    complex128 evaluation of the same formulas: 1e-4 of max|ref|.  The
    Nyquist case's last node has |z| ~ 1e4, where |den|^2 would leave the
    f32 range without the scaling."""
    a, b, c, d, z, gr, gi = _s4_inputs(8, L, tail)
    plan = cq.cauchy_bwd_plan(6, 8, 32, z.shape[0], SMS)
    out = schedule_model(a, b, c, d, z, gr, gi, plan)
    ref = ops.cauchy_bwd_ref(a, b, c, d, z, gr, gi)
    ref64 = ops.cauchy_bwd_ref(*(t.double() for t in (a, b, c, d)),
                               z.to(torch.complex128), gr.double(),
                               gi.double())
    for o, r, r64 in zip(out, ref, ref64):
        assert torch.isfinite(o).all()
        assert _rel(o, r) < 1e-4
        assert _rel(o, r64) < 1e-4
    if tail:
        assert float(z.abs().max()) > 1e4


@pytest.mark.parametrize("K,M,N,Lz", [(3, 6, 20, 777), (8, 5, 32, 1001),
                                     (1, 4, 7, 65)])
def test_schedule_model_at_ragged_shapes(K, M, N, Lz):
    """Off the shipped shapes (N below a warp's 32 lanes, the rest masked;
    odd K and K = 8; partial chunks and splits), the schedule model on
    seeded coefficients over an S4 kernel's eigenvalues vs cauchy_bwd_ref
    and complex128: 1e-4 of max|ref|."""
    L = 2 * (Lz - 1)
    kern = SSKernelNPLR(M, N=2 * N, l_max=L, channels=1,
                        generator=torch.Generator().manual_seed(K))
    rng = np.random.RandomState(K + M)
    with torch.no_grad():
        w = kern.cauchy_operands()[1]
    v = torch.from_numpy((rng.randn(K, M, N) + 1j * rng.randn(K, M, N))
                         .astype(np.complex64))
    a, b, c, d = cq.quad_operands(v, w)
    z = torch.from_numpy(_fft_nodes(L)[1])
    gr, gi = (torch.from_numpy(rng.randn(K, M, Lz).astype(np.float32))
              for _ in range(2))
    plan = cq.cauchy_bwd_plan(K, M, N, Lz, SMS)
    out = schedule_model(a, b, c, d, z, gr, gi, plan)
    ref = ops.cauchy_bwd_ref(a, b, c, d, z, gr, gi)
    ref64 = ops.cauchy_bwd_ref(*(t.double() for t in (a, b, c, d)),
                               z.to(torch.complex128), gr.double(),
                               gi.double())
    for o, r, r64 in zip(out, ref, ref64):
        assert _rel(o, r) < 1e-4 and _rel(o, r64) < 1e-4


@pytest.mark.parametrize("L,tail", [(1000, None), (16000, 96)],
                         ids=["Lz501", "nyquist"])
def test_schedule_model_matches_jax_bwd_kernel(L, tail):
    """The schedule model at H 8 vs the gradients of the real coefficients
    from the JAX custom VJP that ``cauchy_sym_pallas`` differentiates
    through (``_cauchy_quad``, its ``_bwd_kernel`` in interpret mode):
    1e-4 of max|ref|."""
    a, b, c, d, z, gr, gi = _s4_inputs(8, L, tail, seed=3)
    plan = cq.cauchy_bwd_plan(6, 8, 32, z.shape[0], SMS)
    out = schedule_model(a, b, c, d, z, gr, gi, plan)
    j = lambda t: jnp.asarray(t.numpy())                      # noqa: E731
    _, vjp = jax.vjp(_cauchy_quad, j(a), j(b), j(c), j(d),
                     j(z.real.contiguous()), j(z.imag.contiguous()))
    ref = vjp((j(gr), j(gi)))[:4]
    for o, r in zip(out, ref):
        assert _rel(o, r) < 1e-4


def test_scaling_is_exact_and_in_range():
    """pow2_inverse scales |den| into [1, 2) by a power of two, so the
    scaled parts are exact and their squared modulus lies in [1, 8), from
    the smallest to the Nyquist node's largest denominators."""
    rng = np.random.RandomState(5)
    mag = 10.0 ** rng.uniform(-30, 30, 4096)
    x = torch.from_numpy((mag * rng.randn(4096)).astype(np.float32))
    y = torch.from_numpy((mag * rng.randn(4096)).astype(np.float32))
    s = _pow2_inverse(torch.maximum(x.abs(), y.abs()))
    sx, sy = x * s, y * s
    top = torch.maximum(sx.abs(), sy.abs())
    assert bool(((top >= 1) & (top < 2)).all())
    assert torch.equal(sx / s, x) and torch.equal(sy / s, y)
    q = sx * sx + sy * sy
    assert bool(((q >= 1) & (q < 8)).all())
    m = torch.frexp(torch.maximum(x.abs(), y.abs()))[1]
    assert torch.equal(s, torch.ldexp(torch.ones_like(x), 1 - m))


# ---- the wrapper ---------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card, so that the wrapper takes
    its launch route up to the launcher."""

    @property
    def is_cuda(self):
        return True


def _card_inputs(K, M, N, Lz):
    a = torch.zeros(K, M, N).as_subclass(_OnCard)
    b, c, d = torch.zeros(K, M, N), torch.zeros(M, N), torch.ones(M, N)
    z = torch.zeros(Lz, dtype=torch.complex64)
    return a, b, c, d, z


@pytest.fixture
def launches(monkeypatch):
    calls = []
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *a: calls.append(
        (name, a)))
    monkeypatch.setattr(cuda_lib, "check", lambda *a: None)
    monkeypatch.setattr(cuda_lib, "sm_count", lambda dev: SMS)
    return calls


@pytest.mark.parametrize("shape", _shipped_shapes()[:3] + [(3, 8, 20, 96)])
def test_wrapper_reads_complex_views_in_place(launches, shape):
    """Given the real and imaginary views of one complex cotangent (as
    autograd hands ``_CauchyQuad.backward`` the gradient of
    ``torch.complex``), the wrapper passes that tensor's address with
    element stride 2 and the imaginary view's 4 bytes on, copies nothing,
    hands over exactly the ctypes signature's arguments with the plan
    last, and counts one launch."""
    K, M, N, Lz = shape
    G = torch.zeros(K, M, Lz, dtype=torch.complex64).as_subclass(_OnCard)
    before = cq.cauchy_bwd.launches
    da, db, dc, dd = cq.cauchy_bwd(*_card_inputs(K, M, N, Lz), G.real,
                                   G.imag)
    assert cq.cauchy_bwd.launches == before + 1
    (name, args), = launches
    assert name == "dwst_cauchy_bwd"
    sig = cuda_lib._SIGNATURES[name]
    assert len(args) + 1 == len(sig)
    for x, t in zip(args, sig):
        assert isinstance(x, int) and (t is cuda_lib._P or abs(x) < 2 ** 31)
    assert args[5] == G.data_ptr() and args[6] == G.data_ptr() + 4
    assert args[7] == 2
    plan = cq.cauchy_bwd_plan(K, M, N, Lz, SMS)
    assert args[10:] == (K, M, N, Lz, *plan)
    assert da.shape == db.shape == (K, M, N) and dc.shape == dd.shape == (M, N)
    assert args[8] == da.data_ptr()
    if plan.splits == 1:
        assert args[9] == args[8]
    assert da.data_ptr() + 4 * K * M * N == db.data_ptr()
    assert dd.data_ptr() == dc.data_ptr() + 4 * M * N


def test_wrapper_passes_planes_with_stride_1(launches):
    """Two contiguous planes go as they are, with stride 1; anything else
    (here a strided view beside a plane) is copied into planes."""
    K, M, N, Lz = 6, 16, 32, 501
    gr = torch.zeros(K, M, Lz).as_subclass(_OnCard)
    gi = torch.zeros(K, M, Lz).as_subclass(_OnCard)
    cq.cauchy_bwd(*_card_inputs(K, M, N, Lz), gr, gi)
    args = launches[-1][1]
    assert (args[5], args[6], args[7]) == (gr.data_ptr(), gi.data_ptr(), 1)
    G = torch.zeros(K, M, Lz, dtype=torch.complex64).as_subclass(_OnCard)
    cq.cauchy_bwd(*_card_inputs(K, M, N, Lz), gr, G.imag)
    args = launches[-1][1]
    assert args[7] == 1 and args[5] == gr.data_ptr()
    assert args[6] != G.data_ptr() + 4


def test_wrapper_copies_unaligned_pairs_into_planes(launches):
    """Interleaved real and imaginary parts whose pairs are not 8-byte
    aligned (here a float buffer read from its second element) cannot go
    as one complex tensor's views: the wrapper copies them into planes
    and passes stride 1."""
    K, M, N, Lz = 6, 16, 32, 501
    buf = torch.zeros(2 * K * M * Lz + 2).as_subclass(_OnCard)
    gr = buf[1:-1].view(K, M, Lz, 2)[..., 0]
    gi = buf[1:-1].view(K, M, Lz, 2)[..., 1]
    assert gi.data_ptr() == gr.data_ptr() + 4 and gr.data_ptr() % 8 == 4
    cq.cauchy_bwd(*_card_inputs(K, M, N, Lz), gr, gi)
    args = launches[-1][1]
    assert args[7] == 1 and args[5] != gr.data_ptr()


@pytest.mark.parametrize("K,N,what", [(9, 32, "K 9"), (6, 33, "N 33")])
def test_wrapper_refuses_before_any_launch(launches, K, N, what):
    before = cq.cauchy_bwd.launches
    G = torch.zeros(K, 4, 96, dtype=torch.complex64).as_subclass(_OnCard)
    with pytest.raises(ValueError, match=f"kernel 8 .*{what}"):
        cq.cauchy_bwd(*_card_inputs(K, 4, N, 96), G.real, G.imag)
    assert launches == [] and cq.cauchy_bwd.launches == before


@pytest.mark.parametrize("shape,dtype", [((6, 4, 95), torch.float32),
                                         ((6, 4, 96), torch.float64)])
def test_wrapper_refuses_other_cotangents(launches, shape, dtype):
    """A cotangent of another shape or dtype than (K, M, Lz) float32 raises
    before any launch."""
    before = cq.cauchy_bwd.launches
    gr = torch.zeros(6, 4, 96).as_subclass(_OnCard)
    gi = torch.zeros(shape, dtype=dtype).as_subclass(_OnCard)
    with pytest.raises(ValueError, match="kernel 8's cotangents"):
        cq.cauchy_bwd(*_card_inputs(6, 4, 32, 96), gr, gi)
    assert launches == [] and cq.cauchy_bwd.launches == before


def test_training_path_hands_complex_views(monkeypatch):
    """The S4 kernel's construction under autograd (``SSKernelNPLR``
    forward through ``cauchy_sym_fused``) hands kernel 8 the real and
    imaginary views of one complex cotangent, which the wrapper reads in
    place (stride 2, no copy)."""
    seen = []

    def spy(a, b, c, d, z, g_re, g_im):
        r, i, gs = cq._g_layout(g_re, g_im)
        seen.append((gs, r.data_ptr() == g_re.data_ptr(),
                     i.data_ptr() == r.data_ptr() + 4))
        return cq.cauchy_bwd_ref(a, b, c, d, z, g_re, g_im)
    monkeypatch.setattr(cq, "cauchy_bwd", spy)
    kern = SSKernelNPLR(4, N=64, l_max=256, channels=2,
                        generator=torch.Generator().manual_seed(1))
    (kern(256, ops.FUSED) ** 2).sum().backward()
    assert seen == [(2, True, True)]


def test_wrapper_is_its_plain_version_on_cpu():
    """On CPU tensors the wrapper returns cauchy_bwd_ref's results bit for
    bit and counts no launch."""
    a, b, c, d, z, gr, gi = _s4_inputs(4, 1000, seed=7)
    before = {k: fn.launches for k, fn in ops.COUNTED.items()}
    for o, r in zip(ops.cauchy_bwd(a, b, c, d, z, gr, gi),
                    ops.cauchy_bwd_ref(a, b, c, d, z, gr, gi)):
        assert torch.equal(o, r)
    assert {k: fn.launches for k, fn in ops.COUNTED.items()} == before
