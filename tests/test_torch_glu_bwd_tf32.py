"""Kernel 6 (the f32 GLU backward) with its pass on the tensor cores at f32
accuracy, checked without a card.

- A plain model of the kernel (``glu_bwd_model``): z = W y in 3xTF32
  (``tests/torch_tf32.py::mm3``), da = g sig and dgate = g a sig (1 - sig)
  in f32, dy = W^T dz in 3xTF32, and the weight and bias gradients by the
  contraction's f32 split-K partials (``contract``), held against float64
  (the worst relative L2 error over dy, dW and db at most twice the plain
  f32 version's) and against JAX's ``_glu_bwd_kernel`` (fast=False,
  interpret mode, through the VJP of ``_glu_train``) within 1e-4 x max(1,
  max|ref|), at H 128, a ragged H 24 and a wide H 1024.
- The plan (``ops.chmix.glu_bwd_tf32_plan``) at every training tier and at
  every H up to 1024: the layout fits one block (and an SM at its
  blocks), rows conflict-free; it refuses no width the FMA design took.
- The split-weight scratch's map: W's value and gate halves (zero rows to
  whole m-tiles) and W^T taken from W by strides, each a bijection; the
  warps' units cover every dz row pair and every dy row once.
- On CPU tensors the wrapper is its plain version; on the card it hands
  its entry the arguments its ctypes signature names, and refuses widths
  before any launch.

torch runs single-threaded (``test_torch_common``); inputs from numpy
seeds."""

import os
import re

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (single-threaded torch)
from test_torch_ff_bwd_tf32 import contract
from test_torch_fftconv_tc import _OnCard
from test_torch_glu_tf32 import _chip_smoke

import jax
import jax.numpy as jnp

from diffwave_sashimi_tpu.ops import chmix as jchmix
from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.ops import chmix, cuda_lib
from torch_tf32 import mm3, split

TOL_KERNEL = 1e-4          # chip_smoke.py's bar: x max(1, max|ref|)
NWARPS = 8                 # csrc/chmix.cu: warps a block
SMS = 132                  # the H100's SMs
SM_BYTES = 228 * 1024      # an SM's shared memory on sm_90


def glu_bwd_model(y, w, b, g):
    """Kernel 6's function as the kernel computes it: both per-position
    products in 3xTF32, the sigmoid and dz in f32 (sig = 1 / (1 + exp(-(zg
    + bg)))), the weight and bias gradients by the fp32 contraction."""
    H = y.shape[1]
    z = mm3(w, y)
    a = z[:, :H] + b[None, :H, None]
    sig = 1.0 / (1.0 + torch.exp(-(z[:, H:] + b[None, H:, None])))
    dz = torch.cat([g * sig, g * a * sig * (1.0 - sig)], dim=1)
    dy = mm3(w.t().contiguous(), dz)
    return (dy, *contract(dz, y))


def _data(H, seed, B=2, S=1, Rc=128):
    """The JAX compact layout (B, S, H, Rc) of y, res and g, and W, b."""
    rng = np.random.RandomState(seed)

    def f(*shape, sc=1.0):
        return (rng.randn(*shape) * sc).astype(np.float32)
    return dict(y=f(B, S, H, Rc), res=f(B, S, H, Rc), g=f(B, S, H, Rc),
                w=f(2 * H, H, sc=1 / np.sqrt(H)), b=f(2 * H, sc=0.1))


def _flat(a):
    """JAX's compact (B, S, H, Rc) as the port's flat (B, H, S Rc)."""
    a = np.array(a)
    B, S, H, Rc = a.shape
    return torch.from_numpy(np.ascontiguousarray(
        a.transpose(0, 2, 1, 3).reshape(B, H, S * Rc)))


def _f64_err(outs, refs):
    """The worst relative L2 error against float64 over the results
    (chip_smoke.py's float64 gate)."""
    return max(float((o.double() - r.double()).norm() / r.double().norm())
               for o, r in zip(outs, refs))


@pytest.mark.parametrize("H", [128, 24, 1024])
def test_glu_bwd_model_vs_float64_and_jax(H):
    """Kernel 6's model at B2, L 128: its dy, dW and db lie within twice
    the plain f32 version's error against float64 (the worst over the
    three), and within TOL_KERNEL x max(1, max|ref|) of JAX's
    _glu_bwd_kernel (fast=False, interpret mode)."""
    d = _data(H, seed=H + 7)
    _, vjp = jax.vjp(lambda *a: jchmix._glu_train(False, *a),
                     *(jnp.asarray(d[k]) for k in ("y", "res", "w", "b")))
    jdy, _, jdw, jdb = vjp(jnp.asarray(d["g"]))
    args = (_flat(d["y"]), torch.from_numpy(d["w"]), torch.from_numpy(d["b"]),
            _flat(d["g"]))
    model = glu_bwd_model(*args)
    plain = ops.glu_res_bwd_ref(*args)
    f64 = ops.glu_res_bwd_ref(*(a.double() for a in args))
    e_model, e_plain = _f64_err(model, f64), _f64_err(plain, f64)
    assert e_model <= 2 * e_plain, (e_model, e_plain)
    refs = (_flat(jdy), torch.from_numpy(np.asarray(jdw)),
            torch.from_numpy(np.asarray(jdb)).reshape(-1))
    for out, ref in zip(model, refs):
        err = float((out.double() - ref.double()).abs().max())
        assert err <= TOL_KERNEL * max(1.0, float(ref.abs().max())), err


# ---- the plan, the refusals, the scratch map -------------------------------

def _layout(H, P):
    """Bytes of kernel 6's tiles (csrc/chmix.cu::glu_res_bwd_tf32_kernel):
    the f32 y tile (H rows) and dz tile (2H rows), rows of ff_bwd_ld(P)
    floats."""
    return 3 * H * chmix.ff_bwd_ld(P) * 4


def _expected_plan(B, H, L):
    """Kernel 6's plan rule: the first shared (P, blocks) whose blocks fit
    an SM, whose block reads at most GLU_TF32_WEIGHT_BYTES of split W and
    W^T a position and whose grid fills 90% of a wave of them, else one
    block at the widest P that fits and fills 90% of a wave, else the
    narrowest that fits."""
    for P, blocks in chmix.GLU_BWD_TF32_SHARED:
        if (4 * H * H * 8 <= chmix.GLU_TF32_WEIGHT_BYTES * P
                and blocks * (_layout(H, P) + 1024) <= SM_BYTES
                and B * -(-L // P) >= 0.9 * blocks * SMS):
            return P, blocks
    fits = [P for P in chmix.GLU_BWD_TF32_PS
            if _layout(H, P) <= chmix.SMEM_LIMIT] or chmix.GLU_BWD_TF32_PS[-1:]
    full = [P for P in fits if B * -(-L // P) >= 0.9 * SMS]
    return (full or fits[-1:])[0], 1


def _mv(P, blocks):
    """Value m-tiles a warp takes at once in z = W y (csrc
    GluBwdTf32Tile::MV)."""
    return 1 if blocks > 1 or P // 8 >= 8 else 2


def _mt2(P, blocks):
    """m-tiles of dy a warp takes at once (csrc GluBwdTf32Tile::MT2)."""
    return 1 if blocks > 1 else min(16 // (P // 8), 4)


# (B, H, L, P, blocks an SM): SC09's training tiers (B4), ljspeech_harder's
# (B2, L 44000), d_model 256's H 1024 tier (L 1000)
TIERS = [(4, 128, 16000, 64, 2), (4, 256, 4000, 64, 1), (4, 512, 1000, 16, 1),
         (2, 128, 44000, 64, 2), (2, 256, 11000, 64, 1),
         (2, 512, 2750, 16, 1), (4, 1024, 1000, 8, 1)]


@pytest.mark.parametrize("B,H,L,P,blocks", TIERS)
def test_glu_bwd_tf32_plan_at_every_tier(B, H, L, P, blocks):
    """At the training tiers: P 64 at two blocks an SM at H 128 (at most
    16 KB of split weights a position), P 64 at one block at H 256, 16 at
    H 512 and 8 at H 1024, where the wider tiles do not fit; the tiles the
    layout's, within a block and, at two blocks, within an SM."""
    got = chmix.glu_bwd_tf32_plan(B, H, L, SMS)
    assert got[:2] == (P, blocks) == _expected_plan(B, H, L)
    assert got[2] == _layout(H, P) <= chmix.SMEM_LIMIT
    assert blocks * (got[2] + 1024) <= SM_BYTES
    assert chmix.glu_bwd_refusal(H, torch.float32) is None


@pytest.mark.parametrize("H", range(8, 1025, 8))
def test_glu_bwd_tf32_plan_holds_every_tile(H):
    """At every width up to 1024 (multiples of 8), at a short, a middle
    and a long sequence: the plan's rule, a P and blocks an SM the kernel
    is built for, the layout's bytes within 227 KB, both tiles 16-byte
    aligned, a B fragment's 32 loads and a float2 access's 16 lanes on
    distinct banks."""
    for B, L in ((1, 100), (2, 1001), (4, 16000)):
        P, blocks, smem = chmix.glu_bwd_tf32_plan(B, H, L, SMS)
        assert (P, blocks) == _expected_plan(B, H, L)
        assert (P, blocks) in chmix.GLU_BWD_TF32_SHARED or (
            blocks == 1 and P in chmix.GLU_BWD_TF32_PS)
        assert smem == _layout(H, P) <= chmix.SMEM_LIMIT
        LD = chmix.ff_bwd_ld(P)
        assert H * LD * 4 % 16 == 0
        lanes = [(t * LD + g) % 32 for g in range(8) for t in range(4)]
        assert sorted(lanes) == list(range(32))
        pairs = [(g * LD + 2 * t) % 32 for g in range(4) for t in range(4)]
        assert sorted(pairs) == list(range(0, 32, 2))


def _fma_smem(H):
    """Shared memory of kernel 6's FMA design at width H (as its plan,
    deleted with it, computed it): the f32 y and dz tiles (3H x P, P =
    16384 / H within [32, 128], halved to 16 until they fit) and its (8 x
    16384 / P + 4) weight tile."""
    P = max(32, min(128, 16384 // H))

    def smem(P):
        return 4 * (3 * H * P + 8 * (16384 // P + 4))
    while P > 16 and smem(P) > chmix.SMEM_LIMIT:
        P //= 2
    return smem(P)


@pytest.mark.parametrize("H", [8, 24, 128, 256, 512, 1024, 1032, 1040,
                               2048, 2416, 2424])
def test_glu_bwd_tf32_refuses_no_width_it_took(H):
    """Kernel 6 takes every width its FMA design took (H a multiple of 8
    whose tiles fit one block: up to 1032), and more: it refuses for
    shared memory only past H 2416, where even P 8's tiles outgrow a
    block."""
    why = chmix.glu_bwd_refusal(H, torch.float32)
    if _fma_smem(H) <= chmix.SMEM_LIMIT:
        assert why is None
    if H <= 2416:
        assert why is None
    else:
        assert "of shared memory a block" in why


@pytest.mark.parametrize("H", [0, -8, 12, 20])
def test_glu_bwd_tf32_refusal_names_the_width(H):
    """H not a positive multiple of 8 (the tf32 k-step) is refused by
    name, as the FMA design's k-tiles of 8 refused it."""
    assert chmix.glu_bwd_refusal(H, torch.float32) == (
        f"kernel 6: channel width H = {H} must be a positive multiple of 8")


def _tile_map(M, K, tiles, rows_of):
    """(row r, column k) of each scratch entry of ``tiles`` m16k8 tiles of
    an M x K matrix in fragment order (csrc/mma_tf32.cuh::split_weights:
    tile mt Kt + kt, lane 4 g + t, register i: row 16 mt + g + 8 (i & 1),
    column 8 kt + t + 4 (i >> 1)), the row mapped by ``rows_of`` and -1
    past M (a zero padding row)."""
    Kt = K // 8
    mt, kt = np.divmod(np.arange(tiles), Kt)
    g, t = np.divmod(np.arange(32), 4)
    i = np.arange(4)
    r = 16 * mt[:, None, None] + g[None, :, None] + 8 * (i & 1)
    k = 8 * kt[:, None, None] + t[None, :, None] + 4 * (i >> 1)
    return np.stack([np.where(r < M, rows_of(r), -1),
                     np.broadcast_to(k, r.shape)], -1)


def _split_map(H):
    """The split's three jobs as load_a_split reads them: W's value half
    (rows 0 .. H-1 of W), its gate half (rows H .. 2H-1), each padded to
    whole m-tiles, then W^T (H x 2H), whose entry (r, k) is W[k][r];
    entries as (row of W, column of W), -1 for padding."""
    Ht = -(-H // 16)
    n = Ht * (H // 8)
    wa = _tile_map(H, H, n, lambda r: r)
    wg = _tile_map(H, H, n, lambda r: r + H)
    wt = _tile_map(H, 2 * H, Ht * (H // 4), lambda r: r)[..., ::-1]
    wt = np.where(wt[..., 1:2] >= 0, wt, -1)
    return wa, wg, wt


@pytest.mark.parametrize("H", [8, 24, 40, 128, 136])
def test_split_scratch_is_a_bijection(H):
    """Kernel 6's split-weight scratch (glu_bwd_tf32_split_floats floats:
    hi and lo parts) holds every entry of W exactly once in W's two halves
    and once again in W^T, in the fragment order load_a_split reads, each
    half's and W^T's rows padded with zeros to whole m-tiles (at a ragged
    H, a multiple of 8 and not of 16, no m-tile mixes value and gate
    rows); hi + lo is the weight to 2^-22."""
    wa, wg, wt = _split_map(H)
    tiles = wa.shape[0] + wg.shape[0] + wt.shape[0]
    assert 2 * 128 * tiles == chmix.glu_bwd_tf32_split_floats(H)
    for maps in ((wa, wg), (wt,)):
        seen = np.zeros((2 * H, H), np.int64)
        for mp in maps:
            r, k = mp.reshape(-1, 2).T
            np.add.at(seen, (r[r >= 0], k[r >= 0]), 1)
        assert (seen == 1).all()
    assert (wa[..., 0][wa[..., 0] >= 0] < H).all()
    assert (wg[..., 0][wg[..., 0] >= 0] >= H).all()
    w = torch.from_numpy(np.random.RandomState(9).randn(2 * H, H)
                         .astype(np.float32))
    hi, lo = split(w)
    assert torch.allclose(hi + lo, w, rtol=2 ** -21, atol=0)


@pytest.mark.parametrize("H", [8, 24, 128, 136, 512, 1024, 2416])
def test_warps_cover_every_row_once(H):
    """The warps' units (csrc glu_res_bwd_tf32_kernel) at every (P, blocks)
    the kernel is built for: in z = W y, warp w takes units w, w + 8, ...,
    each MV value m-tiles from mt0 = MV u and (through
    warp_gemm_3xtf32_ring's groups, gap Ht) their gate m-tiles, so each
    value row o < H is formed once, by the thread that holds gate row H +
    o; in dy = W^T dz each unit MT2 m-tiles of H, so each dy row is
    written once."""
    Ht = -(-H // 16)
    wa, wg, _ = _split_map(H)
    Kt = H // 8
    for P, blocks in (*chmix.GLU_BWD_TF32_SHARED,
                      *((P, 1) for P in chmix.GLU_BWD_TF32_PS)):
        MV, MT = _mv(P, blocks), _mt2(P, blocks)
        rows, dy_rows = [], []
        for warp in range(NWARPS):
            u = warp
            while u * MV < Ht:
                mt0 = MV * u
                for m in range(MV):
                    vt, gt = mt0 + m, Ht + mt0 + m
                    if vt >= Ht:
                        continue
                    v_rows = wa[vt * Kt, :, :, 0]
                    g_rows = wg[(gt - Ht) * Kt, :, :, 0]
                    ok = v_rows >= 0
                    assert (g_rows[ok] == v_rows[ok] + H).all()
                    rows += [int(r) for r in np.unique(v_rows[ok])]
                u += NWARPS
            u = warp
            while u * MT < Ht:
                for m in range(MT):
                    r0 = 16 * (MT * u + m)
                    dy_rows += [r for r in range(r0, r0 + 16) if r < H]
                u += NWARPS
        assert sorted(rows) == list(range(H))
        assert sorted(dy_rows) == list(range(H))


# ---- the wrapper --------------------------------------------------------------

def _args(B, H, L, seed=5):
    rng = np.random.RandomState(seed)

    def f(*s, sc=1.0):
        return torch.from_numpy((rng.randn(*s) * sc).astype(np.float32))
    return f(B, H, L), f(2 * H, H, sc=0.3), f(2 * H, sc=0.1), f(B, H, L)


@pytest.mark.parametrize("B,H,L", [(2, 24, 333), (1, 16, 64)])
def test_wrapper_is_its_plain_version_on_cpu(B, H, L):
    """On CPU tensors kernel 6's wrapper returns its plain version's f32
    results bit for bit, at a width that is a multiple of 8 but not 16 and
    a ragged L, and counts no launch."""
    args = _args(B, H, L)
    before = {k: f.launches for k, f in ops.COUNTED.items()}
    out = ops.glu_res_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(out,
                                                  ops.glu_res_bwd_ref(*args)))
    assert out[0].dtype == torch.float32 and out[0].shape == (B, H, L)
    assert {k: f.launches for k, f in ops.COUNTED.items()} == before


@pytest.mark.parametrize("B,H,L", [(4, 128, 16000), (4, 256, 4000),
                                   (4, 512, 1000), (4, 1024, 1000),
                                   (2, 24, 1001)])
def test_wrapper_passes_its_signature(monkeypatch, B, H, L):
    """On the card kernel 6's wrapper hands ``dwst_glu_res_bwd`` exactly
    the arguments its ctypes signature names, the stream apart (addresses
    where it takes pointers, the split scratch after the gradients'
    buffers; the widths, the contraction's positions a split and the
    plan's P, blocks an SM and bytes last), and counts one launch."""
    calls = []
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *a: calls.append(
        (name, a)))
    monkeypatch.setattr(cuda_lib, "check", lambda *a: None)
    monkeypatch.setattr(cuda_lib, "sm_count", lambda dev: SMS)
    # meta tensors: the shipped shapes with no memory (their addresses 0)
    y, w, b, g = (torch.empty(s, device="meta").as_subclass(_OnCard) for s in
                  ((B, H, L), (2 * H, H), (2 * H,), (B, H, L)))
    before = {k: f.launches for k, f in ops.COUNTED.items()}
    dy, dw, db = ops.glu_res_bwd(y, w, b, g)
    after = {k: f.launches for k, f in ops.COUNTED.items()}
    assert {k for k in after if after[k] != before[k]} == {"glu_res_bwd"}
    assert after["glu_res_bwd"] == before["glu_res_bwd"] + 1
    (name, got), = calls
    assert name == "dwst_glu_res_bwd"
    sig = cuda_lib._SIGNATURES[name]
    assert len(got) + 1 == len(sig) == 17
    for a, t in zip(got, sig):
        assert isinstance(a, int) and (t is cuda_lib._P or abs(a) < 2 ** 31)
    assert got[:9] == (0,) * 9
    tc = chmix.wgrad_plan(B, 2 * H, H, L, SMS)[0]
    assert got[-7:] == (B, H, L, tc, *chmix.glu_bwd_tf32_plan(B, H, L, SMS))
    assert dy.shape == (B, H, L) and dw.shape == (2 * H, H)
    assert db.shape == (2 * H,)


@pytest.mark.parametrize("H,match", [
    (12, "H = 12 must be a positive multiple of 8"),
    (2424, "H = 2424 need .* bytes")])
def test_wrapper_refuses_before_any_launch(monkeypatch, H, match):
    """Widths kernel 6 does not take raise ValueError naming them from the
    wrapper before it checks a tensor or launches anything (meta tensors
    stand in for y and g)."""
    calls = []
    monkeypatch.setattr(cuda_lib, "launch", lambda *a: calls.append(a))
    y = torch.empty(1, H, 8, device="meta").as_subclass(_OnCard)
    before = {k: f.launches for k, f in ops.COUNTED.items()}
    with pytest.raises(ValueError, match=match):
        ops.glu_res_bwd(y, None, None, y)
    assert calls == []
    assert {k: f.launches for k, f in ops.COUNTED.items()} == before


# ---- what chip_smoke.py and the source say of kernel 6 ----------------------

def test_instances_are_the_plans():
    """csrc/chmix.cu's entry builds kernel 6's pass at exactly the (P,
    blocks an SM) its plan may pick, and chip_smoke.py's phase 1 requires
    each of them (TF32_KERNELS, with their tf32 HMMA instructions) and
    kernel 6's split; no instance of the FMA pass is left."""
    src = open(os.path.join(os.path.dirname(__file__), os.pardir,
                            "diffwave_sashimi_torch", "csrc",
                            "chmix.cu")).read()
    built = {(int(p), int(b)) for p, b in re.findall(
        r"run\(launch_glu_bwd_tf32<(\d+), (\d+)>\)", src)}
    plans = {*chmix.GLU_BWD_TF32_SHARED,
             *((P, 1) for P in chmix.GLU_BWD_TF32_PS)}
    assert built == plans
    assert "glu_res_bwd_kernel<" not in src
    smoke = _chip_smoke()
    assert {tuple(map(int, k.split(", "))) for k in
            smoke.TF32_KERNELS["glu_res_bwd_tf32_kernel"]} == plans
    assert "split_weights_tf32_kernel<6>" in smoke.TF32_SPLITS
    assert "glu_res_bwd_tf32_kernel" in smoke.PORT_KERNELS
    assert "glu_res_bwd_kernel" not in smoke.PORT_KERNELS


def test_chip_smoke_bound_counts_the_3xtf32_pass():
    """chip_smoke.py's bound of kernel 6 at SC09's top tier (B4 H128
    L16000) counts its pass's two products as three TF32 products each (8
    H^2 B L operations, 0.0508 ms at 495 T/s) and its contraction on the
    fp32 FMAs (4 H^2 B L, 0.0626 ms at 67 T/s): 0.1134 ms, bound by
    operations; its trace parts are the split and the pass, the
    contraction and its sum."""
    smoke = _chip_smoke()
    B, H, L = 4, 128, 16000
    ops_, _ = smoke.work("glu_res_bwd", B, H, L, 32768)
    assert ops_ == {"tf32": 3 * 8 * H * H * B * L, "fp32": 4 * H * H * B * L}
    ms, by = smoke.bound("glu_res_bwd", B, H, L, 32768)
    assert by == "operations" and abs(ms - 0.1134) < 5e-4
    parts = smoke.kernel_parts("glu_res_bwd", {}, {})
    assert parts["global_kernels"] == [
        "glu_res_bwd_tf32_kernel", "split_weights_tf32_kernel<6>",
        "wgrad_kernel", "reduce_splits_kernel"]
