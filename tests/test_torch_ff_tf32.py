"""Kernel 3 (the f32 FF branch) on the tensor cores at f32 accuracy,
checked without a card.

- A plain model of the kernel (``ff_model``): kernel 3's f32 algebra (LN
  statistics with var = E[x^2] - mean^2, the exact GELU, (x + W2 z) + b2
  then skip, the output's statistics) with its two products in 3xTF32
  (``tests/torch_tf32.py::mm3``), held against float64 (each output's
  relative L2 error at most twice the plain f32 version's) and against
  JAX's ``ln_ff_res`` (fast=False, interpret mode, as the JAX package's
  tests run it on the CPU) within 1e-4 x max(1, max|ref|), at H 128 / F
  256 and H 1024 / F 2048; W2's product taken in chunks of the hidden
  rows, as the kernel takes it past H 256, is the whole product bit for
  bit.
- The plan (``ops.chmix.ff_tf32_plan``) at every tier: the layout fits
  one block, rows conflict-free; it refuses no width the FMA design took.
- The split-weight scratch's map (a bijection onto W1 and W2, zero
  padding rows) at ragged widths.
- On CPU tensors the wrapper is its plain version; on the card it hands
  its entry the arguments its ctypes signature names, and refuses widths
  before any launch.

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

import jax.numpy as jnp

from diffwave_sashimi_tpu.ops import chmix as jchmix
from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.ops import chmix, cuda_lib
from torch_tf32 import mm3, split

TOL_KERNEL = 1e-4          # chip_smoke.py's bar: x max(1, max|ref|)
F32 = torch.float32
NT = 256                   # csrc/chmix.cu: threads a block


def ff_model(x, m, s, w1, b1, w2, b2, skip=None, FC=None):
    """Kernel 3's function as the kernel computes it: (out, mean, var)
    with the two products in 3xTF32, W2's in chunks of FC hidden rows (the
    sums carried from chunk to chunk, as the kernel carries them in
    shared memory)."""
    mean = x.mean(dim=1, keepdim=True)
    var = (x * x).mean(dim=1, keepdim=True) - mean * mean
    xn = s * torch.rsqrt(var) * (x - mean + m)
    z = F.gelu(mm3(w1, xn) + b1[None, :, None])
    Fd = w1.shape[0]
    FC = FC or Fd
    acc = None
    for f0 in range(0, Fd, FC):
        acc = mm3(w2[:, f0:f0 + FC], z[:, f0:f0 + FC], acc)
    out = x + acc + b2[None, :, None]
    if skip is not None:
        out = out + skip
    mo = out.mean(dim=1)
    return out, mo, (out * out).mean(dim=1) - mo * mo


def _data(B, H, Fd, L, seed):
    rng = np.random.RandomState(seed)

    def f(*shape, sc=1.0, off=0.0):
        return (rng.randn(*shape) * sc + off).astype(np.float32)
    return dict(x=f(B, H, L, sc=0.3, off=0.1), skip=f(B, H, L),
                w1=f(Fd, H, sc=1 / np.sqrt(H)), b1=f(Fd, sc=0.1),
                w2=f(H, Fd, sc=1 / np.sqrt(Fd)), b2=f(H, sc=0.1),
                m=np.array([0.1], np.float32), s=np.array([1.2], np.float32))


NAMES = ("x", "m", "s", "w1", "b1", "w2", "b2", "skip")


def _f64_err(outs, refs):
    """The worst relative L2 error over the outputs (chip_smoke.py's
    float64 gate)."""
    return max(float((o.double() - r.double()).norm() / r.double().norm())
               for o, r in zip(outs, refs))


@pytest.mark.parametrize("H,Fd,L", [(128, 256, 128), (128, 256, 77),
                                    (1024, 2048, 64)])
def test_ff_model_vs_float64_and_jax(H, Fd, L):
    """Kernel 3's model at B2 (W2's product in the chunks ff_tf32_plan
    gives at this width): out, mean and var lie within twice the plain f32
    version's error against float64, and within TOL_KERNEL x max(1,
    max|ref|) of JAX's ln_ff_res (fast=False, interpret mode) with the
    skip and the statistics."""
    d = _data(2, H, Fd, L, seed=H + L)
    t = [torch.from_numpy(d[k]) for k in NAMES]
    FC = chmix.ff_tf32_plan(H, Fd)[1]
    model = ff_model(*t, FC=FC)
    plain = ops.ln_ff_res_ref(*t, emit_stats=True)
    f64 = ops.ln_ff_res_ref(*(a.double() for a in t), emit_stats=True)
    e_model, e_plain = _f64_err(model, f64), _f64_err(plain, f64)
    assert e_model <= 2 * e_plain, (e_model, e_plain)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    ref = jchmix.ln_ff_res(j["x"][:, None], j["m"], j["s"], j["w1"],
                           j["b1"], j["w2"], j["b2"], False,
                           skip=j["skip"][:, None], emit_stats=True)
    for o, r in zip(model, ref):
        r = torch.from_numpy(np.array(r)[:, 0])
        err = float((o - r).abs().max()) / max(1.0, float(r.abs().max()))
        assert err <= TOL_KERNEL, err


@pytest.mark.parametrize("FC", [16, 48, 128, 200])
def test_chunked_product_is_the_whole_product(FC):
    """A product taken in pieces of k-tiles, the sums carried from piece to
    piece in k order (warp_gemm_3xtf32_acc over the chunks), equals the
    product taken whole, bit for bit."""
    rng = np.random.RandomState(FC)
    a = torch.from_numpy(rng.randn(40, 400).astype(np.float32))
    b = torch.from_numpy(rng.randn(2, 400, 24).astype(np.float32))
    acc = None
    for k0 in range(0, 400, FC):
        acc = mm3(a[:, k0:k0 + FC], b[:, k0:k0 + FC], acc)
    assert torch.equal(acc, mm3(a, b))


# ---- the plan, the refusals, the scratch map -------------------------------

def _layout(H, Fd, P, FC):
    """Bytes of kernel 3's tiles (csrc/chmix.cu::ln_ff_res_tf32_kernel): 2
    NT floats of sums, 2 P of statistics, the H-row x tile, the GELU tile
    (F rows, or FC a chunk) and, with chunks, the H-row tile of sums, f32
    rows of ff_bwd_ld(P)."""
    rows = H + min(Fd, FC) + (H if FC < Fd else 0)
    return 4 * (2 * NT + 2 * P + rows * chmix.ff_bwd_ld(P))


def _mt(P):
    """m-tiles a warp at P and one block an SM (FfTf32Tile<P, 1>::MT1)."""
    return 1 if P >= 128 else min(128 // P, 4)


@pytest.mark.parametrize("hidden", [2, 1], ids=["F=2H", "F=H"])
@pytest.mark.parametrize("tier", SC09 + VOCODER, ids=_tier_id)
def test_ff_tf32_plan_holds_every_tile(tier, hidden):
    """At every tier of d_model 128 and 256 and the vocoder's (H 128 to
    1024), F = 2H and F = H: no refusal; P 64 at two blocks an SM where two
    blocks' tiles fit an SM (H 128), else at one block the widest P whose
    tiles fit, P = 16384 / H at F = 2H; FC all of F, or a multiple of a
    warp's m-tiles that leaves no more than half the warps idle; the bytes
    the layout's, within one block's 227 KB; every region 16-byte aligned,
    a B fragment's 32 loads and a float2 store's 16 lanes on distinct
    banks."""
    _, H, _ = tier
    Fd = hidden * H
    assert chmix.ff_refusal(H, Fd, F32) is None
    P, FC, blocks, smem = chmix.ff_tf32_plan(H, Fd)
    assert smem == _layout(H, Fd, P, FC) <= chmix.SMEM_LIMIT
    two = 2 * (_layout(H, Fd, 64, Fd) + 1024) <= 228 * 1024
    assert (P, blocks) == (64, 2) if two else (
        P in chmix.FF_TF32_PS and blocks == 1)
    if blocks == 1:
        wider = [p for p in chmix.FF_TF32_PS if p > P]
        assert all(_layout(H, Fd, p, Fd) > chmix.SMEM_LIMIT for p in wider)
    if hidden == 2:
        assert two == (H == 128)
        assert P == (64 if H == 128 else 16384 // H)
    unit = 16 * (1 if blocks > 1 else _mt(P))
    assert FC == Fd or (FC % unit == 0 and FC >= 4 * unit)
    LD = chmix.ff_bwd_ld(P)
    assert (2 * NT + 2 * P) * 4 % 16 == 0 and LD % 4 == 0
    lanes = [(t * LD + g) % 32 for g in range(8) for t in range(4)]
    assert sorted(lanes) == list(range(32))
    pairs = [(g * LD + 2 * t) % 32 for g in range(4) for t in range(4)]
    assert sorted(pairs) == list(range(0, 32, 2))


def _fma_plan(H, Fd):
    """Kernel 3's plan before its redesign (fp32 FMAs on gemm_chunk tiles):
    (P, bytes) of its input and hidden tiles ((H + F) x P), its (8 x 16384
    / P + 4) weight tile, 2 NT floats of sums and 2 P of statistics, P
    halved from 16384 / H (within [32, 128]) to 16 until they fit."""
    P0 = 128 if H <= 128 else (64 if H <= 256 else 32)
    return chmix._fitted((128, 64, 32, 16), P0, lambda P: 4 * (
        (H + Fd) * P + 8 * (16384 // P + 4) + 2 * NT + 2 * P))


WIDTHS = [(H, Fd) for H in (8, 16, 20, 24, 40, 128, 200, 256, 512, 768,
                            1024, 1536, 2048, 3072, 3584)
          for Fd in (8, H, 2 * H, 3 * H, 4 * H, 100, 4096)]


@pytest.mark.parametrize("H,Fd", WIDTHS)
def test_ff_tf32_refuses_no_width_it_took(H, Fd):
    """Kernel 3 takes every width its FMA design took (multiples of 8 whose
    tiles fit), refuses widths that are not multiples of 8 by the same
    message, and refuses for shared memory only widths whose tiles no
    longer fit even at P 8 (H + F past 7196 with the whole GELU tile, 2H
    past about 7180 with chunks), which the FMA design refused too."""
    why = chmix.ff_refusal(H, Fd, F32)
    steps = H % 8 or Fd % 8
    took = not steps and _fma_plan(H, Fd)[1] <= chmix.SMEM_LIMIT
    if steps:
        assert why is not None and "must be a positive multiple of 8" in why
    elif took:
        assert why is None
    elif why is not None:
        assert "of shared memory a block" in why
        assert _layout(H, Fd, 8, Fd) > chmix.SMEM_LIMIT


def _split_map(H, Fd):
    """The split's map (csrc/mma_tf32.cuh::split_weights with kernel 3's
    jobs, read as load_a_split reads it): for each scratch float, (matrix
    j, row r, column k) where matrix 0 is W1 (F x H) and 1 is W2 (H x F);
    r past the matrix's rows marks padding."""
    n0 = -(-Fd // 16) * (H // 8)
    n1 = -(-H // 16) * (Fd // 8)
    out = np.zeros((n0 + n1, 2, 32, 4, 3), np.int64)
    for tile in range(n0 + n1):
        j = 0 if tile < n0 else 1
        tix = tile - (0, n0)[j]
        Kt = (H if j == 0 else Fd) // 8
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
    """Kernel 3's split-weight scratch (ff_tf32_split_floats floats) holds
    every entry of W1 and W2 exactly once in each part (hi, lo), in the
    fragment order load_a_split reads (tile, part, lane, register), zero
    rows past F and H (m-tiles of 16); hi + lo of a weight is the weight
    to 2^-22."""
    mp = _split_map(H, Fd)
    assert mp[..., 0].size == chmix.ff_tf32_split_floats(H, Fd)
    rng = np.random.RandomState(7)
    mats = (rng.randn(Fd, H).astype(np.float32),
            rng.randn(H, Fd).astype(np.float32))
    for part in (0, 1):
        seen = [np.zeros(a.shape, np.int64) for a in mats]
        for j, r, k in mp[:, part].reshape(-1, 3):
            if r < mats[j].shape[0]:
                seen[j][r, k] += 1
        assert all((s == 1).all() for s in seen)
    for w in mats:
        hi, lo = split(torch.from_numpy(w))
        assert torch.allclose(hi + lo, torch.from_numpy(w), rtol=2 ** -21,
                              atol=0)


# ---- the wrapper --------------------------------------------------------------

def _ff_args(B, H, Fd, L, seed=3, wrap=None):
    rng = np.random.RandomState(seed)

    def f(*shape, sc=1.0):
        t = torch.from_numpy((rng.randn(*shape) * sc).astype(np.float32))
        return t if wrap is None else t.as_subclass(wrap)
    return (f(B, H, L), f(1, sc=0.1), 1.0 + f(1, sc=0.1), f(Fd, H, sc=0.3),
            f(Fd, sc=0.1), f(H, Fd, sc=0.3), f(H, sc=0.1), f(B, H, L))


@pytest.mark.parametrize("emit_stats", [False, True])
def test_wrapper_is_its_plain_version_on_cpu(emit_stats):
    """On CPU tensors kernel 3's wrapper returns its plain version's
    results bit for bit, with and without the skip and the statistics,
    and counts no launch."""
    before = {k: fn.launches for k, fn in ops.COUNTED.items()}
    for Fd in (32, 16):
        args = _ff_args(2, 16, Fd, 40)
        for skip in (None, args[7]):
            ref = ops.ln_ff_res_ref(*args[:7], skip, emit_stats)
            got = ops.ln_ff_res(*args[:7], skip, emit_stats)
            if not emit_stats:
                ref, got = (ref,), (got,)
            assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert {k: fn.launches for k, fn in ops.COUNTED.items()} == before


@pytest.mark.parametrize("B,H,Fd,L", [(2, 128, 256, 1000), (2, 24, 40, 1001),
                                      (1, 1024, 2048, 64)])
@pytest.mark.parametrize("emit_stats", [False, True])
def test_wrapper_passes_its_signature(monkeypatch, B, H, Fd, L, emit_stats):
    """On the card kernel 3's wrapper hands ``dwst_ln_ff_res`` exactly the
    arguments its ctypes signature names, the stream apart (addresses
    where it takes pointers, a null one for a missing skip or statistics;
    the widths and the plan's P, FC, blocks an SM and bytes last), and
    counts one launch."""
    calls = []
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *a: calls.append(
        (name, a)))
    monkeypatch.setattr(cuda_lib, "check", lambda *a: None)
    args = _ff_args(B, H, Fd, L, wrap=_OnCard)
    before = ops.ln_ff_res.launches
    ops.ln_ff_res(*args[:7], None, emit_stats)
    assert ops.ln_ff_res.launches == before + 1
    (name, got), = calls
    assert name == "dwst_ln_ff_res"
    sig = cuda_lib._SIGNATURES[name]
    assert len(got) + 1 == len(sig)
    for a, t in zip(got, sig):
        if t is cuda_lib._P:
            assert a is None or isinstance(a, int)
        else:
            assert isinstance(a, int) and abs(a) < 2 ** 31
    assert got[1] is None                         # no skip
    assert (got[9] is None) == (not emit_stats)   # mean
    assert isinstance(got[11], int)               # the split scratch
    assert got[-8:] == (B, H, Fd, L, *chmix.ff_tf32_plan(H, Fd))


@pytest.mark.parametrize("H,Fd,match", [(20, 40, "H = 20"),
                                        (16, 36, "F = 36"),
                                        (7200, 8, "of shared memory")])
def test_wrapper_refuses_before_any_launch(H, Fd, match):
    """On a CUDA tensor kernel 3's wrapper raises ValueError naming the
    width before it allocates or launches anything: H or F not a multiple
    of 8, or tiles past one block at P 8."""
    before = {k: f.launches for k, f in ops.COUNTED.items()}
    x = types.SimpleNamespace(is_cuda=True, dtype=F32, shape=(4, H, 1000))
    w1 = types.SimpleNamespace(shape=(Fd, H))
    with pytest.raises(ValueError, match=f"kernel 3: .*{match}"):
        ops.ln_ff_res(x, None, None, w1, None, None, None)
    assert {k: f.launches for k, f in ops.COUNTED.items()} == before
