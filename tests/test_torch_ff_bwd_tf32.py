"""Kernel 7 (the f32 FF backward) on the tensor cores at f32 accuracy, and
the weight-gradient contraction of kernels 6 and 7, checked without a
card.

- ``tf32`` (``tests/torch_tf32.py``), a torch model of
  ``cvt.rna.tf32.f32`` (with the kernel's clearing of the 13 low bits),
  bit for bit on hand-picked values, and the split x = hi + lo it feeds
  (``csrc/mma_tf32.cuh::split``).
- A plain model of the kernel's products (``mm3``: per k-step of 8, lo hi
  + hi lo + hi hi summed from zero, then added to an f32 sum) and of its
  contractions (``contract``: f32 split-K partials of ``wgrad_plan``,
  summed in order, as ``wgrad_kernel`` forms them on the fp32 FMAs),
  beside ``ln_ff_res_bwd_ref``: kernel 7's seven results and kernel 6's
  weight gradient at H 128 / F 256 and H 1024 / F 2048 lie within twice
  the plain f32 version's error against float64 (``_f64_err``: a tensor's
  relative L2 error, dm and ds on the scale of their terms' magnitudes),
  and within 1e-4 x max(1, max|ref|) of JAX's ``_ff_bwd_kernel`` /
  ``_glu_bwd_kernel`` (fast=False, interpret mode, as the JAX package's
  tests run them on the CPU).
- Kernel 7's plan (``ops.chmix.ff_bwd_plan``) at every tier kernel 7 took
  before its redesign, its refusals against that kernel's, and the
  split-weight scratch's fragment-order map (a bijection onto W1, W1^T and
  W2^T, zero padding rows).
- On CPU tensors the wrapper is its plain version; on the card it hands its
  entry the arguments its ctypes signature names.

torch runs single-threaded (``test_torch_common``); inputs from numpy
seeds."""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import test_torch_common  # noqa: F401  (single-threaded torch)
from test_torch_ff_bwd_tc import SC09, VOCODER, _tier_id
from test_torch_fftconv_tc import _OnCard

import jax
import jax.numpy as jnp

from diffwave_sashimi_tpu.ops import chmix as jchmix
from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.ops import chmix, cuda_lib
from torch_tf32 import mm3, split, tf32

TOL_KERNEL = 1e-4          # chip_smoke.py's bar: x max(1, max|ref|)
F32 = torch.float32
NT = 256                   # csrc/chmix.cu: threads a block


# ---- cvt.rna.tf32.f32 and the split ----------------------------------------

def _bits(*words):
    return torch.from_numpy(np.array(words, np.uint32).view(np.float32))


# (input bits, rounded bits)
ROUNDING = [
    (0x3F800000, 0x3F800000),     # 1.0
    (0x3F801000, 0x3F802000),     # a tie: away from zero (even is down)
    (0x3F800FFF, 0x3F800000),     # below the tie
    (0x3F801001, 0x3F802000),     # above the tie
    (0x3F803000, 0x3F804000),     # a tie whose even neighbour is up
    (0xBF801000, 0xBF802000),     # negative tie: away from zero
    (0xBF800FFF, 0xBF800000),
    (0x3FFFF000, 0x40000000),     # carries into the exponent
    (0x00001000, 0x00002000),     # subnormal tie
    (0x00000FFF, 0x00000000),     # subnormal rounds to zero
    (0x80000FFF, 0x80000000),     # negative subnormal to -0
    (0x007FF000, 0x00800000),     # largest subnormals to the smallest normal
    (0x7F7FEFFF, 0x7F7FE000),     # below the largest tf32
    (0x7F7FF000, 0x7F800000),     # past it: inf
    (0x00000000, 0x00000000),
    (0x80000000, 0x80000000),
    (0x7F800000, 0x7F800000),     # inf
    (0xFF800000, 0xFF800000),     # -inf
]


@pytest.mark.parametrize("word,want", ROUNDING,
                         ids=[f"{w:08x}" for w, _ in ROUNDING])
def test_tf32_rounds_as_cvt_rna(word, want):
    """``tf32`` gives cvt.rna.tf32.f32's value bit for bit: nearest, ties
    away from zero, on normals, subnormals, signed zeros and infinities."""
    got = tf32(_bits(word)).numpy().view(np.uint32)[0]
    assert got == want, f"{word:08x} -> {got:08x}, want {want:08x}"


def test_tf32_keeps_nan():
    """A nan (quiet or signalling payload) stays a nan."""
    out = tf32(_bits(0x7FC00000, 0x7F800001, 0xFFFFFFFF))
    assert bool(torch.isnan(out).all())


@pytest.mark.parametrize("scale", [1e-20, 1.0, 1e30])
def test_split_keeps_22_bits(scale):
    """hi and lo are tf32 (13 low bits clear), x - hi is exact, and hi + lo
    is x to within 2^-22 |x| (about 22 of f32's 24 significand bits)
    while x - hi stays a normal f32."""
    x = torch.from_numpy(np.random.RandomState(1).randn(10000)
                         .astype(np.float32)) * scale
    hi, lo = split(x)
    for p in (hi, lo):
        assert not (p.numpy().view(np.uint32) & 0x1FFF).any()
    x64 = x.double()
    assert torch.equal((x - hi).double(), x64 - hi.double())
    err = (hi.double() + lo.double() - x64).abs()
    assert bool((err <= 2.0 ** -22 * x64.abs()).all())


# ---- the plain model of the kernel's products and contractions -------------

def contract(X, Y):
    """The contraction of X (B, M, L) and Y (B, N, L): (X Y^T over all
    positions, X's row sums), from f32 split-K partials of ``wgrad_plan``
    (tc positions a split of a batch row) summed in order."""
    B, M, L = X.shape
    N = Y.shape[1]
    tc, splits, _ = chmix.wgrad_plan(B, M, N, L)
    w, rows = torch.zeros(M, N), torch.zeros(M)
    for bb in range(B):
        for t in range(0, L, tc):
            s = slice(t, min(L, t + tc))
            w = w + X[bb, :, s] @ Y[bb, :, s].t()
            rows = rows + X[bb, :, s].sum(dim=1)
    return w, rows


def ff_bwd_model(x, m, s, w1, b1, w2, b2, g):
    """Kernel 7's function as the kernel computes it: the f32 algebra of
    ``ln_ff_res_bwd_ref`` with the three per-position products in 3xTF32
    (``mm3``) and both weight gradients by ``contract``."""
    mean = x.mean(dim=1, keepdim=True)
    var = (x * x).mean(dim=1, keepdim=True) - mean * mean
    rstd = torch.rsqrt(var)
    xc = x - mean
    r = s * rstd
    xn = r * (xc + m)
    z = mm3(w1, xn) + b1[None, :, None]
    dz = chmix._gelu_grad(z) * mm3(w2.t().contiguous(), g)
    dxn = mm3(w1.t().contiguous(), dz)
    S1 = dxn.mean(dim=1, keepdim=True)
    S2 = (dxn * (xc + m)).mean(dim=1, keepdim=True)
    dx = g + r * (dxn - S1) - r * rstd * rstd * xc * S2
    dw1, db1 = contract(dz, xn)
    dw2, db2 = contract(g, F.gelu(z))
    return (dx, (dxn * r).sum().reshape(1),
            (dxn * rstd * (xc + m)).sum().reshape(1), dw1, db1, dw2, db2)


def _flat(a):
    """JAX's compact (B, S, H, Rc) as the port's flat (B, H, S Rc)."""
    a = np.asarray(a)
    B, S, H, Rc = a.shape
    return torch.from_numpy(np.ascontiguousarray(
        a.transpose(0, 2, 1, 3).reshape(B, H, S * Rc)))


def _ff_data(H, Fd, seed, B=2, S=1, Rc=128):
    rng = np.random.RandomState(seed)

    def f(*shape, sc=1.0, off=0.0):
        return (rng.randn(*shape) * sc + off).astype(np.float32)
    return dict(x=f(B, S, H, Rc, sc=0.3, off=0.1), g=f(B, S, H, Rc),
                w1=f(Fd, H, sc=1 / np.sqrt(H)), b1=f(Fd, sc=0.1),
                w2=f(H, Fd, sc=1 / np.sqrt(Fd)), b2=f(H, sc=0.1),
                m=np.array([0.1], np.float32), s=np.array([1.2], np.float32))


NAMES = ("dx", "dm", "ds", "dw1", "db1", "dw2", "db2")


def _err(outs, refs):
    """Each result's max |out - ref| / max(1, max|ref|) (chip_smoke.py's
    kernel bar)."""
    return {n: float((o.double() - r.double()).abs().max()
                     / max(1.0, float(r.double().abs().max())))
            for n, o, r in zip(NAMES, outs, refs)}


def _f64_err(outs, refs, scales=None):
    """The worst error against float64 over the results (chip_smoke.py's
    float64 gate): ||out - ref|| / ||ref||, or ||out - ref|| / scales[i]
    for result i in ``scales`` (``_sum_scales``: a sum that cancels has
    its rounding error bounded by its terms' magnitudes)."""
    scales = scales or {}
    return max(float((o.double() - r.double()).norm()
                     / (scales[i] if i in scales else r.double().norm()))
               for i, (o, r) in enumerate(zip(outs, refs)))


def _sum_scales(x, m, s, w1, b1, w2, b2, g):
    """{1: sum |dxn r|, 2: sum |dxn rstd (xc + m)|} in float64: the
    magnitudes of the terms of dm and ds (results 1 and 2)."""
    x, m, s, w1, b1, w2, g = (a.double() for a in (x, m, s, w1, b1, w2, g))
    mean = x.mean(dim=1, keepdim=True)
    rstd = torch.rsqrt((x * x).mean(dim=1, keepdim=True) - mean * mean)
    xc = x - mean
    z = torch.einsum("bhl,fh->bfl", s * rstd * (xc + m), w1) + b1[:, None]
    dz = chmix._gelu_grad(z) * torch.einsum("bhl,hf->bfl", g, w2)
    dxn = torch.einsum("bfl,fh->bhl", dz, w1)
    return {1: float((dxn * s * rstd).abs().sum()),
            2: float((dxn * rstd * (xc + m)).abs().sum())}


@pytest.mark.parametrize("H,Fd", [(128, 256), (1024, 2048)])
def test_ff_bwd_model_vs_float64_and_jax(H, Fd):
    """Kernel 7's model at B2, L 128: its results lie within twice the
    plain f32 version's error against float64 (the worst of ``_f64_err``
    over all seven, dm and ds on their terms' scale), and all seven within
    TOL_KERNEL x max(1, max|ref|) of JAX's _ff_bwd_kernel (fast=False,
    interpret mode, through the VJP of _ff_train)."""
    d = _ff_data(H, Fd, seed=H)
    names = ("m", "s", "w1", "b1", "w2", "b2")
    _, vjp = jax.vjp(lambda *a: jchmix._ff_train(False, *a),
                     jnp.asarray(d["x"]), *(jnp.asarray(d[k]) for k in names))
    jx = vjp(jnp.asarray(d["g"]))
    jref = [_flat(jx[0])] + [torch.from_numpy(np.asarray(v)).reshape(-1)
                             for v in jx[1:]]
    args = (_flat(d["x"]), *(torch.from_numpy(d[k]) for k in names),
            _flat(d["g"]))
    model = ff_bwd_model(*args)
    plain = ops.ln_ff_res_bwd_ref(*args)
    f64 = ops.ln_ff_res_bwd_ref(*(a.double() for a in args))
    scales = _sum_scales(*args)
    e_model = _f64_err(model, f64, scales)
    e_plain = _f64_err(plain, f64, scales)
    assert e_model <= 2 * e_plain, (e_model, e_plain)
    e_jax = _err([o.reshape(-1) for o in model], [r.reshape(-1) for r in jref])
    assert max(e_jax.values()) <= TOL_KERNEL, e_jax


def _glu_data(H, seed, B=2, S=1, Rc=128):
    rng = np.random.RandomState(seed)

    def f(*shape, sc=1.0):
        return (rng.randn(*shape) * sc).astype(np.float32)
    return dict(y=f(B, S, H, Rc), res=f(B, S, H, Rc), g=f(B, S, H, Rc),
                w=f(2 * H, H, sc=1 / np.sqrt(H)), b=f(2 * H, sc=0.1))


@pytest.mark.parametrize("H", [128, 1024])
def test_glu_bwd_weight_grad_model_vs_float64_and_jax(H):
    """Kernel 6's weight and bias gradients through the contraction (its dz
    from the plain f32 pass, which the kernel's fp32 pass computes):
    within twice the plain f32 version's error against float64
    and within TOL_KERNEL x max(1, max|ref|) of JAX's _glu_bwd_kernel
    (fast=False, interpret mode)."""
    d = _glu_data(H, seed=H + 1)
    _, vjp = jax.vjp(lambda *a: jchmix._glu_train(False, *a),
                     *(jnp.asarray(d[k]) for k in ("y", "res", "w", "b")))
    _, _, jdw, jdb = vjp(jnp.asarray(d["g"]))
    y, g = _flat(d["y"]), _flat(d["g"])
    w, b = torch.from_numpy(d["w"]), torch.from_numpy(d["b"])
    z = torch.einsum("bhl,oh->bol", y, w) + b[None, :, None]
    sig = torch.sigmoid(z[:, H:])
    dz = torch.cat([g * sig, g * z[:, :H] * sig * (1 - sig)], dim=1)
    model = contract(dz, y)
    plain = ops.glu_res_bwd_ref(y, w, b, g)[1:]
    f64 = ops.glu_res_bwd_ref(y.double(), w.double(), b.double(),
                              g.double())[1:]
    e_model, e_plain = _f64_err(model, f64), _f64_err(plain, f64)
    assert e_model <= 2 * e_plain, (e_model, e_plain)
    jref = (torch.from_numpy(np.asarray(jdw)),
            torch.from_numpy(np.asarray(jdb)).reshape(-1))
    e_jax = _err(model, jref)
    assert max(e_jax.values()) <= TOL_KERNEL, e_jax


# ---- the plan, the refusals, the scratch map -------------------------------

def _plan_before(H, Fd):
    """Kernel 7's plan before its redesign (fp32 FMAs on gemm_chunk tiles):
    (P, bytes) of its x, g and hidden tiles ((2H + F) x P), its (8 x 16384
    / P + 4) weight tile, 2 NT floats of sums and 4 P of statistics."""
    P0 = 64 if H <= 128 else (32 if H <= 256 else 16)
    return chmix._fitted((64, 32, 16, 8), P0, lambda P: 4 * (
        (2 * H + Fd) * P + 8 * (16384 // P + 4) + 2 * NT + 4 * P))


@pytest.mark.parametrize("hidden", [2, 1], ids=["F=2H", "F=H"])
@pytest.mark.parametrize("tier", SC09 + VOCODER, ids=_tier_id)
def test_ff_bwd_plan_holds_every_tile(tier, hidden):
    """At every tier of d_model 128 and 256 and the vocoder's, F = 2H and F
    = H: no refusal; P one the kernel is built for; the bytes hold the statistics (2 NT + 4 P floats)
    and the x, g and dz tiles, rows of ff_bwd_ld(P) floats, within one
    block's 227 KB; every region starts 16-byte aligned, and a tf32 B
    fragment's 32 loads (row t, column g of lane 4 g + t) and a float2
    store's 16 lanes fall on distinct banks."""
    _, H, _ = tier
    Fd = hidden * H
    assert chmix.ff_bwd_refusal(H, Fd, F32) is None
    P, smem = chmix.ff_bwd_plan(H, Fd)
    assert P in chmix.FF_BWD_PS
    LD = chmix.ff_bwd_ld(P)
    stats = 4 * (2 * NT + 4 * P)
    assert smem == stats + 4 * LD * (2 * H + Fd) <= chmix.SMEM_LIMIT
    assert stats % 16 == 0 and 4 * LD % 16 == 0 and LD >= P
    assert LD % 32 in (8, 24)
    lanes = [(t * LD + g) % 32 for g in range(8) for t in range(4)]
    assert sorted(lanes) == list(range(32))
    pairs = [(g * LD + 2 * t) % 32 for g in range(4) for t in range(4)]
    assert sorted(pairs) == list(range(0, 32, 2))


WIDTHS = [(H, Fd) for H in (8, 16, 24, 40, 128, 200, 256, 512, 768, 1024,
                            1536, 2048, 3584)
          for Fd in (8, H, 2 * H, 3 * H, 4 * H, 100, 4096)]


@pytest.mark.parametrize("H,Fd", WIDTHS)
def test_ff_bwd_refuses_no_width_it_took(H, Fd):
    """Kernel 7 takes every width it took before its redesign (multiples
    of 8 whose tiles fit), refuses widths that are not multiples of 8 by
    the same message, and refuses for shared memory only widths whose
    tiles no longer fit even at P 8 (2H + F past 7196), which it refused
    before too; it takes more (2H + F from 5144 to 7196, d_model 256 with
    ff 4 among them: kernel 3 still refuses those models)."""
    why = chmix.ff_bwd_refusal(H, Fd, F32)
    steps = H % 8 or Fd % 8
    before = None if steps or _plan_before(H, Fd)[1] <= chmix.SMEM_LIMIT \
        else "shared memory"
    if steps:
        assert why is not None and "must be a positive multiple of 8" in why
    elif before is None:
        assert why is None
    elif why is not None:
        assert "of shared memory a block" in why
        assert 2 * H + Fd > 7196
    else:
        assert 2 * H + Fd <= 7196


def _split_map(H, Fd):
    """The split kernel's map (csrc/chmix.cu::split_weights_tf32_kernel,
    read as load_a_split reads it): for each scratch float, (matrix j, row
    r, column k, part) where matrix 0 is W1 (F x H), 1 W1^T (H x F), 2 W2^T
    (F x H), part 0 hi and 1 lo; r past the matrix's rows marks padding."""
    n0 = -(-Fd // 16) * (H // 8)
    n1 = -(-H // 16) * (Fd // 8)
    out = np.zeros((2 * n0 + n1, 2, 32, 4, 3), np.int64)
    for tile in range(2 * n0 + n1):
        j = 0 if tile < n0 else (1 if tile < n0 + n1 else 2)
        tix = tile - (0, n0, n0 + n1)[j]
        Kt = (Fd if j == 1 else H) // 8
        mt, kt = divmod(tix, Kt)
        for lane in range(32):
            g, t = divmod(lane, 4)
            for i in range(4):
                out[tile, :, lane, i] = (j, 16 * mt + g + 8 * (i & 1),
                                         8 * kt + t + 4 * (i >> 1))
    return out


@pytest.mark.parametrize("H,Fd", [(16, 32), (24, 40), (8, 8), (40, 24),
                                  (128, 256)])
def test_split_scratch_is_a_bijection(H, Fd):
    """The split-weight scratch (ff_bwd_split_floats floats) holds every
    entry of W1, W1^T and W2^T exactly once in each part (hi, lo), in the
    fragment order load_a_split reads (tile, part, lane, register), and
    zero rows past F and H (m-tiles of 16); hi + lo of a weight is the
    weight to 2^-22."""
    mp = _split_map(H, Fd)
    assert mp[..., 0].size == chmix.ff_bwd_split_floats(H, Fd)
    rng = np.random.RandomState(5)
    w1 = rng.randn(Fd, H).astype(np.float32)
    w2 = rng.randn(H, Fd).astype(np.float32)
    mats = (w1, w1.T, w2.T)
    hi, lo = (p.numpy() for p in split(torch.from_numpy(w1)))
    w2h, w2l = (p.numpy() for p in split(torch.from_numpy(w2)))
    parts = ((hi, hi.T, w2h.T), (lo, lo.T, w2l.T))
    for part in (0, 1):
        seen = [np.zeros(a.shape, np.int64) for a in mats]
        flat = mp[:, part].reshape(-1, 3)
        for j, r, k in flat:
            if r >= mats[j].shape[0]:
                continue                        # a zero padding row
            seen[j][r, k] += 1
        assert all((s == 1).all() for s in seen)
        # the kernel's values: the weight's part, or 0 past the matrix
        vals = np.array([parts[part][j][r, k] if r < mats[j].shape[0]
                         else 0.0 for j, r, k in flat], np.float32)
        pad = np.array([r >= mats[j].shape[0] for j, r, k in flat])
        assert (vals[pad] == 0).all()
    w1r = torch.from_numpy(w1)
    assert torch.allclose(split(w1r)[0] + split(w1r)[1], w1r, rtol=2 ** -21,
                          atol=0)


# ---- the wrapper --------------------------------------------------------------

def _ff_args(B, H, Fd, L, seed=3, dtype=F32, wrap=None):
    rng = np.random.RandomState(seed)

    def f(*shape, sc=1.0):
        t = torch.from_numpy((rng.randn(*shape) * sc).astype(np.float32))
        return t if wrap is None else t.as_subclass(wrap)
    return (f(B, H, L).to(dtype), f(1, sc=0.1), 1.0 + f(1, sc=0.1),
            f(Fd, H, sc=0.3), f(Fd, sc=0.1), f(H, Fd, sc=0.3), f(H, sc=0.1),
            f(B, H, L).to(dtype))


def test_wrapper_is_its_plain_version_on_cpu():
    """On CPU tensors kernel 7's wrapper returns its plain version's
    results bit for bit at F = 2H and F = H, and counts no launch."""
    before = {k: fn.launches for k, fn in ops.COUNTED.items()}
    for Fd in (32, 16):
        args = _ff_args(2, 16, Fd, 40)
        ref = ops.ln_ff_res_bwd_ref(*args)
        assert all(torch.equal(a, b)
                   for a, b in zip(ops.ln_ff_res_bwd(*args), ref))
    assert {k: fn.launches for k, fn in ops.COUNTED.items()} == before


@pytest.mark.parametrize("B,H,Fd,L", [(2, 128, 256, 1000), (2, 24, 40, 1001),
                                      (1, 1024, 2048, 64)])
def test_wrapper_passes_its_signature(monkeypatch, B, H, Fd, L):
    """On the card kernel 7's wrapper hands ``dwst_ln_ff_res_bwd`` exactly
    the arguments its ctypes signature names, the stream apart (addresses
    where it takes pointers; the widths, tc, and the plan's P and bytes
    last), and counts one launch."""
    calls = []
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *a: calls.append(
        (name, a)))
    monkeypatch.setattr(cuda_lib, "check", lambda *a: None)
    monkeypatch.setattr(cuda_lib, "sm_count", lambda dev: 132)
    args = _ff_args(B, H, Fd, L, wrap=_OnCard)
    before = ops.ln_ff_res_bwd.launches
    ops.ln_ff_res_bwd(*args)
    assert ops.ln_ff_res_bwd.launches == before + 1
    (name, got), = calls
    assert name == "dwst_ln_ff_res_bwd"
    sig = cuda_lib._SIGNATURES[name]
    assert len(got) + 1 == len(sig)
    for a, t in zip(got, sig):
        assert isinstance(a, int) and (t is cuda_lib._P or abs(a) < 2 ** 31)
    tc = chmix.wgrad_plan(B, Fd, H, L, 132)[0]
    assert got[-7:] == (B, H, Fd, L, tc, *chmix.ff_bwd_plan(H, Fd))


def test_wrapper_refuses_before_any_launch():
    """On a CUDA tensor kernel 7's wrapper raises ValueError naming the
    width before it allocates or launches anything: H not a multiple of
    8."""
    before = {k: f.launches for k, f in ops.COUNTED.items()}
    x = types.SimpleNamespace(is_cuda=True, dtype=F32, shape=(4, 20, 1000))
    w1 = types.SimpleNamespace(shape=(40, 20))
    with pytest.raises(ValueError, match="kernel 7: channel width H = 20"):
        ops.ln_ff_res_bwd(x, None, None, w1, None, None, None, x)
    assert {k: f.launches for k, f in ops.COUNTED.items()} == before
