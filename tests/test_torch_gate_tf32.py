"""Kernel 11 (the f32 WaveNet gate and res/skip convs) on the tensor cores
at f32 accuracy, checked without a card.

- A plain model of the kernel (``gate_model``): the f32 gate (tanh a /
  (1 + exp(-g))), the stacked product [W_r; W_s] out in 3xTF32
  (``tests/torch_tf32.py::mm3``), res = (x + (W_r out + b_r)) sqrt(1/2) and
  skip = W_s out + b_s, held against float64 (each output's relative L2
  error at most twice the plain f32 version's) and against JAX's
  ``gate_res_skip`` (fast=False, interpret mode, as the JAX package's
  tests run it) within 1e-4 x max(1, max|ref|), at C 128 and a wide C 512.
- The plan (``ops.wavenet_gate.gate_tf32_plan``) at every ``GATE_CASES``
  shape and every C up to 512: the layout fits one block, rows
  conflict-free; it refuses no width the FMA design took.
- The split-weight scratch's map (a bijection onto [W_r; W_s], zero
  padding rows) at ragged widths (C 24, S 40 among them).
- On CPU tensors the wrapper is its plain version; on the card it hands
  its entry the arguments its ctypes signature names, and refuses widths
  before any launch.

torch runs single-threaded (``test_torch_common``); inputs from numpy
seeds."""

import math

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (single-threaded torch)
from test_torch_fftconv_tc import _OnCard

import jax.numpy as jnp

from diffwave_sashimi_tpu.ops.wavenet_gate import gate_res_skip as jax_gate
from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.ops import chmix, cuda_lib, wavenet_gate as wg
from torch_tf32 import mm3, split

TOL_KERNEL = 1e-4          # chip_smoke.py's bar: x max(1, max|ref|)
NT = 256                   # csrc/wavenet_gate.cu: threads a block
SMS = 132                  # the H100's SMs
# chip_smoke.py's GATE_CASES (B, C, S, L): the sampling path's, B16, and
# wavenet_small's widths at a ragged length
GATE_CASES = ((4, 256, 256, 16000), (16, 256, 256, 16000),
              (4, 128, 256, 8960))


def gate_model(h, x, wr, br, ws, bs):
    """Kernel 11's function as the kernel computes it: (res, skip) with the
    stacked product in 3xTF32."""
    C = x.shape[1]
    out = torch.tanh(h[:, :C]) / (1.0 + torch.exp(-h[:, C:]))
    acc = mm3(torch.cat([wr, ws]), out)
    res = (x + (acc[:, :C] + br[None, :, None])) * wg.SQRT_HALF
    return res, acc[:, C:] + bs[None, :, None]


def _data(B, C, S, L, seed=0):
    """The JAX kernel test's inputs (tests/test_wavenet_gate.py), as
    test_torch_wavenet.py makes them."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 2 * C, L).astype(np.float32),
            (0.3 * rng.randn(B, C, L)).astype(np.float32),
            (0.2 * rng.randn(C, C)).astype(np.float32),
            (0.1 * rng.randn(C)).astype(np.float32),
            (0.2 * rng.randn(S, C)).astype(np.float32),
            (0.1 * rng.randn(S)).astype(np.float32))


def _f64_err(outs, refs):
    """The worst relative L2 error over the outputs (chip_smoke.py's
    float64 gate)."""
    return max(float((o.double() - r.double()).norm() / r.double().norm())
               for o, r in zip(outs, refs))


@pytest.mark.parametrize("B,C,S,L", [(2, 128, 256, 128), (1, 128, 128, 333),
                                     (1, 512, 512, 128)])
def test_gate_model_vs_float64_and_jax(B, C, S, L):
    """Kernel 11's model: res and skip lie within twice the plain f32
    version's error against float64, and within TOL_KERNEL x max(1,
    max|ref|) of JAX's gate_res_skip (fast=False, interpret mode)."""
    data = _data(B, C, S, L, seed=C + L)
    t = [torch.from_numpy(a) for a in data]
    model = gate_model(*t)
    plain = ops.gate_res_skip_ref(*t)
    f64 = ops.gate_res_skip_ref(*(a.double() for a in t))
    e_model, e_plain = _f64_err(model, f64), _f64_err(plain, f64)
    assert e_model <= 2 * e_plain, (e_model, e_plain)
    ref = jax_gate(*map(jnp.asarray, data), fast=False)
    for o, r in zip(model, ref):
        r = torch.from_numpy(np.array(r))
        err = float((o - r).abs().max()) / max(1.0, float(r.abs().max()))
        assert err <= TOL_KERNEL, err


# ---- the plan, the refusals, the scratch map -------------------------------

def _layout(C, P):
    """Bytes of kernel 11's tiles (csrc/wavenet_gate.cu::
    gate_res_skip_tf32_kernel): the f32 gate tile (C rows) and 8 warps'
    16-row staging tiles, rows of ff_bwd_ld(P) floats."""
    return (C + 16 * 8) * chmix.ff_bwd_ld(P) * 4


@pytest.mark.parametrize("B,C,S,L", GATE_CASES, ids=str)
def test_gate_tf32_plan_at_gate_cases(B, C, S, L):
    """At every shape chip_smoke.py holds kernel 11 at: P 64 at two blocks
    an SM at C 256, S 256 (16 KB of split weights a position), P 32 at
    three at C 128, S 256 (12 KB), tiles the layout's, that many blocks'
    tiles within an SM's 228 KB, a grid of several waves."""
    P, blocks, smem = wg.gate_tf32_plan(B, C, S, L, sms=SMS)
    assert (P, blocks) == ((64, 2) if C == 256 else (32, 3))
    assert (C + S) * C * 8 / P <= wg.GATE_TF32_WEIGHT_BYTES
    assert smem == _layout(C, P) <= chmix.SMEM_LIMIT
    assert blocks * (smem + 1024) <= 228 * 1024
    assert B * math.ceil(L / P) >= 2 * blocks * SMS
    assert wg.gate_tf32_refusal(C, S) is None


@pytest.mark.parametrize("C", range(8, 513, 8))
def test_gate_tf32_plan_holds_every_tile(C):
    """At every residual width up to 512 (multiples of 8) with S in {8,
    40, C, 2C}, at a short, a middle and a long sequence: the first of the
    shared (P, blocks an SM) whose blocks fit an SM and whose block reads at
    most GATE_TF32_WEIGHT_BYTES of split weights a position, else at one
    block the widest P that fits and fills a wave (else the narrowest that
    fits); the layout's bytes within 227 KB; the staging tiles 16-byte
    aligned, a B fragment's 32 loads, a float2 store's 16 lanes and a
    quarter-warp's 16-byte reads on distinct banks."""
    for S in (8, 40, C, 2 * C):
        assert wg.gate_tf32_refusal(C, S) is None
        shared = [(p, n) for p, n in wg.GATE_TF32_SHARED
                  if (C + S) * C * 8 <= wg.GATE_TF32_WEIGHT_BYTES * p
                  and n * (_layout(C, p) + 1024) <= 228 * 1024]
        for B, L in ((1, 100), (4, 1000), (4, 16000)):
            P, blocks, smem = wg.gate_tf32_plan(B, C, S, L, sms=SMS)
            assert smem == _layout(C, P) <= chmix.SMEM_LIMIT
            fits = [p for p in wg.GATE_TF32_PS
                    if _layout(C, p) <= chmix.SMEM_LIMIT]
            full = [p for p in fits if B * math.ceil(L / p) >= SMS]
            assert (P, blocks) == (shared[0] if shared else (
                full[0] if full else fits[-1], 1))
            LD = chmix.ff_bwd_ld(P)
            assert C * LD * 4 % 16 == 0 and 16 * LD * 4 % 16 == 0
            lanes = [(t * LD + g) % 32 for g in range(8) for t in range(4)]
            assert sorted(lanes) == list(range(32))
            pairs = [(g * LD + 2 * t) % 32 for g in range(4)
                     for t in range(4)]
            assert sorted(pairs) == list(range(0, 32, 2))


def _fma_smem(C):
    """Shared memory of kernel 11's FMA design at residual width C: the f32
    gate tile (C x P, P = 16384 / C within [32, 128]) and its (8 x TM + 4)
    weight tile, TM = 8 (256 / (P / 8)) rows."""
    P = max(32, min(128, 16384 // C))
    return (C * P + 8 * (8 * (256 // (P // 8)) + 4)) * 4


@pytest.mark.parametrize("C", [8, 24, 128, 256, 1000, 1672, 1680, 1688,
                               2048, 4096, 7136, 7144])
@pytest.mark.parametrize("S", [1, 40, 256])
def test_gate_tf32_refuses_no_width_it_took(C, S):
    """Kernel 11 takes every width its FMA design took (C a multiple of 8
    whose tiles fit one block: up to 1680), and more: it refuses for
    shared memory only past C 7136, where even P 8's tiles outgrow a
    block."""
    why = wg.gate_tf32_refusal(C, S)
    if _fma_smem(C) <= chmix.SMEM_LIMIT:
        assert why is None
    if C <= 7136:
        assert why is None
    else:
        assert "of shared memory a block" in why


@pytest.mark.parametrize("C,S,match", [
    (12, 8, "residual width 12 must be a multiple of 8"),
    (0, 8, "residual width 0 must be a multiple of 8"),
    (16, 0, "S = 0 must be positive")])
def test_gate_tf32_refusal_names_the_width(C, S, match):
    """C not a positive multiple of 8 (the FMA design's message) or S not
    positive is refused by name."""
    assert match in wg.gate_tf32_refusal(C, S)


def _split_map(C, S):
    """The split's map (csrc/mma_tf32.cuh::split_weights with kernel 11's
    job, read as load_a_split reads it): for each scratch float, (row r,
    column k) of the stacked weight [W_r; W_s]; r past C + S marks
    padding."""
    Mt, Kt = -(-(C + S) // 16), C // 8
    out = np.zeros((Mt * Kt, 2, 32, 4, 2), np.int64)
    for tile in range(Mt * Kt):
        mt, kt = divmod(tile, Kt)
        for lane in range(32):
            g, t = divmod(lane, 4)
            for i in range(4):
                out[tile, :, lane, i] = (16 * mt + g + 8 * (i & 1),
                                         8 * kt + t + 4 * (i >> 1))
    return out


@pytest.mark.parametrize("C,S", [(24, 40), (8, 8), (40, 24), (16, 3),
                                 (256, 256), (128, 256)])
def test_split_scratch_is_a_bijection(C, S):
    """Kernel 11's split-weight scratch (gate_tf32_split_floats floats)
    holds every entry of [W_r; W_s] exactly once in each part (hi, lo), in
    the fragment order load_a_split reads (tile, part, lane, register),
    rows past C + S zero (an m-tile of 16 may hold rows of both W_r and
    W_s, and the last pads); hi + lo is the weight to 2^-22."""
    mp = _split_map(C, S)
    assert mp[..., 0].size == wg.gate_tf32_split_floats(C, S)
    for part in (0, 1):
        seen = np.zeros((C + S, C), np.int64)
        for r, k in mp[:, part].reshape(-1, 2):
            if r < C + S:
                seen[r, k] += 1
        assert (seen == 1).all()
    w = torch.from_numpy(np.random.RandomState(9).randn(C + S, C)
                         .astype(np.float32))
    hi, lo = split(w)
    assert torch.allclose(hi + lo, w, rtol=2 ** -21, atol=0)


# ---- the wrapper --------------------------------------------------------------

@pytest.mark.parametrize("B,C,S,L", [(2, 24, 40, 333), (1, 16, 8, 64)])
def test_wrapper_is_its_plain_version_on_cpu(B, C, S, L):
    """On CPU tensors kernel 11's wrapper returns its plain version's f32
    res and skip bit for bit, at a width that is a multiple of 8 but not
    16 with S != C and a ragged L, and counts no launch."""
    data = [torch.from_numpy(a) for a in _data(B, C, S, L)]
    before = {k: f.launches for k, f in ops.COUNTED.items()}
    ref = ops.gate_res_skip_ref(*data)
    out = ops.gate_res_skip(*data)
    assert [o.shape for o in out] == [(B, C, L), (B, S, L)]
    assert all(torch.equal(o, r) for o, r in zip(out, ref))
    assert {k: f.launches for k, f in ops.COUNTED.items()} == before


@pytest.mark.parametrize("B,C,S,L", GATE_CASES + ((2, 24, 40, 333),))
def test_wrapper_passes_its_signature(monkeypatch, B, C, S, L):
    """On the card kernel 11's wrapper hands ``dwst_gate_res_skip`` exactly
    the arguments its ctypes signature names, the stream apart (addresses
    where it takes pointers, the split scratch after skip; the widths and
    the plan's P, blocks an SM and bytes last), and counts one launch."""
    calls = []
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *a: calls.append(
        (name, a)))
    monkeypatch.setattr(cuda_lib, "check", lambda *a: None)
    monkeypatch.setattr(cuda_lib, "sm_count", lambda dev: SMS)
    # meta tensors: the shipped shapes with no memory (their addresses 0)
    data = [torch.empty(s, device="meta").as_subclass(_OnCard) for s in (
        (B, 2 * C, L), (B, C, L), (C, C), (C,), (S, C), (S,))]
    before = ops.gate_res_skip.launches
    ops.gate_res_skip(*data)
    assert ops.gate_res_skip.launches == before + 1
    (name, got), = calls
    assert name == "dwst_gate_res_skip"
    sig = cuda_lib._SIGNATURES[name]
    assert len(got) + 1 == len(sig)
    for a, t in zip(got, sig):
        assert isinstance(a, int) and (t is cuda_lib._P or abs(a) < 2 ** 31)
    assert got[:9] == (0,) * 9
    assert got[-7:] == (B, C, S, L, *wg.gate_tf32_plan(B, C, S, L, SMS))


@pytest.mark.parametrize("C,S,match", [
    (12, 8, "residual width 12 must be a multiple of 8"),
    (16, 0, "S = 0 must be positive"),
    (7144, 8, "C = 7144, S = 8 need .* bytes")])
def test_wrapper_refuses_before_any_launch(C, S, match):
    """Widths kernel 11 does not take raise ValueError naming them from the
    wrapper before it checks a tensor or launches anything (meta tensors
    stand in for x and W_s)."""
    x = torch.empty(1, C, 8, device="meta")
    ws = torch.empty(S, C, device="meta")
    before = {k: f.launches for k, f in ops.COUNTED.items()}
    with pytest.raises(ValueError, match=match):
        ops.gate_res_skip(torch.empty(0).as_subclass(_OnCard), x, None,
                          None, ws, None)
    assert {k: f.launches for k, f in ops.COUNTED.items()} == before
