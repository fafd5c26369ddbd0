"""Kernel 2 (the f32 GLU branch) on the tensor cores at f32 accuracy,
checked without a card.

- A plain model of the kernel (``glu_model``): [a; g] = W y in 3xTF32
  (``tests/torch_tf32.py::mm3``), out = res + (a + b_a) / (1 + exp(-(g +
  b_g))) in f32, held against float64 (its relative L2 error at most
  twice the plain f32 version's) and against JAX's ``_glu_kernel``
  (fast=False, interpret mode) and ``mix_glu_res`` (fast=False) within
  1e-4 x max(1, max|ref|), at H 128, a ragged H 24 and a wide H 1024.
- The plan (``ops.chmix.glu_tf32_plan``) at every tier and every H up to
  2048: the layout fits one block (and an SM at its blocks), rows
  conflict-free; it refuses no width the FMA design took.
- The split-weight scratch's map (a bijection onto W's value and gate
  halves, zero padding rows) at ragged H, and the warps' pairing of each
  value m-tile with its gate m-tile, which covers every output row once.
- On CPU tensors the wrapper is its plain version; on the card it hands
  its entry the arguments its ctypes signature names, and refuses widths
  before any launch.

torch runs single-threaded (``test_torch_common``); inputs from numpy
seeds."""

import functools

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (single-threaded torch)
from test_torch_fftconv_tc import _OnCard

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from diffwave_sashimi_tpu.ops import chmix as jchmix
from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.ops import chmix, cuda_lib
from torch_tf32 import mm3, split

TOL_KERNEL = 1e-4          # chip_smoke.py's bar: x max(1, max|ref|)
NT, NWARPS = 256, 8        # csrc/chmix.cu: threads and warps a block
SMS = 132                  # the H100's SMs
SM_BYTES = 228 * 1024      # an SM's shared memory on sm_90


def glu_model(y, res, w, b):
    """Kernel 2's function as the kernel computes it: the product in
    3xTF32, then res + (a + b_a) / (1 + exp(-(g + b_g)))."""
    H = y.shape[1]
    z = mm3(w, y)
    g = z[:, H:] + b[None, H:, None]
    return res + (z[:, :H] + b[None, :H, None]) / (1.0 + torch.exp(-g))


def _data(B, H, L, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)   # noqa: E731
    return (f(B, H, L), f(B, H, L) + 0.5,
            (f(2 * H, H) / np.sqrt(H)).astype(np.float32), 0.1 * f(2 * H))


def _compact(x, S):
    """(B, H, L) -> the JAX compact (B, S, H, L / S), t = s Rc + r (the
    channel kernels are position-wise)."""
    B, H, L = x.shape
    return jnp.transpose(jnp.asarray(x).reshape(B, H, S, L // S),
                         (0, 2, 1, 3))


def _flat(xc):
    B, S, H, Rc = xc.shape
    return np.transpose(np.asarray(xc, np.float32),
                        (0, 2, 1, 3)).reshape(B, H, S * Rc)


def _jax_glu_kernel(y, res, w, b):
    """JAX ``_glu_kernel`` with fast=False run in interpret mode on the
    compact layout, one program a batch row (mix_glu_res's block specs)."""
    S = 2 if y.shape[-1] % 2 == 0 else 1
    yc, rc = _compact(y, S), _compact(res, S)
    b2 = jnp.asarray(b).reshape(-1, 1)
    w = jnp.asarray(w)

    def io(xc):
        return pl.BlockSpec((1,) + xc.shape[1:], lambda i: (i, 0, 0, 0))

    def full(a):
        return pl.BlockSpec(a.shape, lambda *_: (0,) * a.ndim)
    out = pl.pallas_call(
        functools.partial(jchmix._glu_kernel, fast=False),
        grid=(yc.shape[0],), in_specs=[io(yc), io(rc), full(w), full(b2)],
        out_specs=io(rc), out_shape=jax.ShapeDtypeStruct(rc.shape, rc.dtype),
        interpret=True)(yc, rc, w, b2)
    return _flat(out), _flat(jchmix.mix_glu_res(yc, rc, w, jnp.asarray(b),
                                                fast=False))


def _f64_err(out, ref):
    return float((out.double() - ref).norm() / ref.norm())


@pytest.mark.parametrize("B,H,L", [(2, 128, 128), (2, 24, 77),
                                   (1, 1024, 64)])
def test_glu_model_vs_float64_and_jax(B, H, L):
    """Kernel 2's model: within twice the plain f32 version's relative L2
    error against float64, and within TOL_KERNEL x max(1, max|ref|) of
    JAX's f32 GLU, its Pallas kernel in interpret mode and its public
    function (fast=False)."""
    data = _data(B, H, L, seed=H + L)
    t = [torch.from_numpy(a) for a in data]
    model = glu_model(*t)
    plain = ops.glu_res_ref(*t)
    f64 = ops.glu_res_ref(*(a.double() for a in t))
    e_model, e_plain = _f64_err(model, f64), _f64_err(plain, f64)
    assert e_model <= 2 * e_plain, (e_model, e_plain)
    for ref in _jax_glu_kernel(*data):
        err = np.abs(model.numpy() - ref).max()
        assert err <= TOL_KERNEL * max(1.0, np.abs(ref).max()), err


# ---- the plan, the refusals, the scratch map -------------------------------

def _layout(H, P):
    """Bytes of kernel 2's tiles (csrc/chmix.cu::glu_res_tf32_kernel): the
    f32 y tile (H rows) and 8 warps' 16-row staging tiles, rows of
    ff_bwd_ld(P) floats."""
    return (H + 16 * NWARPS) * chmix.ff_bwd_ld(P) * 4


def _mv(P, blocks):
    """Value m-tiles a warp takes at once (csrc GluTf32Tile::MV): one at
    two blocks an SM or 8 n-tiles (64 sums a thread with its gate
    m-tile), else two."""
    return 1 if blocks > 1 or P // 8 >= 8 else 2


def _expected_plan(B, H, L):
    """Kernel 2's plan rule: the first shared (P, blocks) whose blocks fit
    an SM and whose block reads at most GLU_TF32_WEIGHT_BYTES of split
    weights a position, else one block at the widest P that fits and
    fills 90% of a wave, else the narrowest that fits."""
    for P, blocks in chmix.GLU_TF32_SHARED:
        if (2 * H * H * 8 <= chmix.GLU_TF32_WEIGHT_BYTES * P
                and blocks * (_layout(H, P) + 1024) <= SM_BYTES):
            return P, blocks
    fits = [P for P in chmix.GLU_TF32_PS
            if _layout(H, P) <= chmix.SMEM_LIMIT] or chmix.GLU_TF32_PS[-1:]
    full = [P for P in fits if B * -(-L // P) >= 0.9 * SMS]
    return (full or fits[-1:])[0], 1


# (B, H, L, P, blocks an SM): SC09's tiers, the vocoder's (B2), d_model
# 256's H 1024 tier (L 1000)
TIERS = [(4, 128, 16000, 64, 2), (4, 256, 4000, 64, 2), (4, 512, 1000, 32, 1),
         (2, 128, 143360, 64, 2), (2, 256, 35840, 64, 2),
         (2, 512, 8960, 32, 1), (4, 1024, 1000, 32, 1)]


@pytest.mark.parametrize("B,H,L,P,blocks", TIERS)
def test_glu_tf32_plan_at_every_tier(B, H, L, P, blocks):
    """At SC09's and the vocoder's tiers (H 128, 256, 512) and d_model
    256's H 1024: P 64 at two blocks an SM at H 128 and 256 (at most 16 KB
    of split weights a position), else one block at P 32, the widest it
    is built for at one block, whose grid fills a wave there; the tiles
    the layout's, within a block and, at two blocks, within an SM."""
    got = chmix.glu_tf32_plan(B, H, L, SMS)
    assert got[:2] == (P, blocks) == _expected_plan(B, H, L)
    assert got[2] == _layout(H, P) <= chmix.SMEM_LIMIT
    assert blocks * (got[2] + 1024) <= SM_BYTES
    assert chmix.glu_refusal(H, torch.float32) is None


@pytest.mark.parametrize("H", range(8, 2049, 8))
def test_glu_tf32_plan_holds_every_tile(H):
    """At every width up to 2048 (multiples of 8), at a short, a middle
    and a long sequence: the plan's rule, a P and blocks an SM the kernel
    is built for (csrc dwst_glu_res's instances), the layout's bytes
    within 227 KB, the y tile and the staging tiles 16-byte aligned, a B
    fragment's 32 loads, a float2 store's 16 lanes and a quarter-warp's
    16-byte reads on distinct banks."""
    for B, L in ((1, 100), (4, 1000), (4, 16000)):
        P, blocks, smem = chmix.glu_tf32_plan(B, H, L, SMS)
        assert (P, blocks) == _expected_plan(B, H, L)
        assert (P, blocks) in chmix.GLU_TF32_SHARED or (
            blocks == 1 and P in chmix.GLU_TF32_PS)
        assert smem == _layout(H, P) <= chmix.SMEM_LIMIT
        LD = chmix.ff_bwd_ld(P)
        assert H * LD * 4 % 16 == 0 and 16 * LD * 4 % 16 == 0
        lanes = [(t * LD + g) % 32 for g in range(8) for t in range(4)]
        assert sorted(lanes) == list(range(32))
        pairs = [(g * LD + 2 * t) % 32 for g in range(4) for t in range(4)]
        assert sorted(pairs) == list(range(0, 32, 2))


def _fma_smem(H):
    """Shared memory of kernel 2's FMA design at width H (as its plan,
    deleted with it, computed it): the f32 y tile (H x P, P = 16384 / H
    within [32, 128], halved to 32 until it fits) and its (8 x 16384 / P +
    4) weight tile."""
    P = max(32, min(128, 16384 // H))
    while P > 32 and 4 * (H * P + 8 * (16384 // P + 4)) > chmix.SMEM_LIMIT:
        P //= 2
    return 4 * (H * P + 8 * (16384 // P + 4))


@pytest.mark.parametrize("H", [8, 24, 128, 256, 1000, 1024, 1680, 1688,
                               2048, 4096, 7136, 7144])
def test_glu_tf32_refuses_no_width_it_took(H):
    """Kernel 2 takes every width its FMA design took (H a multiple of 8
    whose tiles fit one block: up to 1680), and more: it refuses for
    shared memory only past H 7136, where even P 8's tiles outgrow a
    block."""
    why = chmix.glu_refusal(H, torch.float32)
    if _fma_smem(H) <= chmix.SMEM_LIMIT:
        assert why is None
    if H <= 7136:
        assert why is None
    else:
        assert "of shared memory a block" in why


@pytest.mark.parametrize("H", [0, -8, 12, 20])
def test_glu_tf32_refusal_names_the_width(H):
    """H not a positive multiple of 8 (the tf32 k-step) is refused by
    name, as the FMA design's k-tiles of 8 refused it."""
    why = chmix.glu_refusal(H, torch.float32)
    assert f"kernel 2: channel width H = {H} must be a positive multiple " \
           f"of 8" == why


def _split_map(H):
    """The split's map (csrc/mma_tf32.cuh::split_weights with kernel 2's
    two jobs, read as load_a_split reads it): for each scratch float, (row
    r, column k) of W (2H x H); the value half's rows 0 .. H-1 in tiles 0
    .. Ht Kt - 1, the gate half's H .. 2H-1 after them; a row at or past
    the end of its half (marked -1) is padding."""
    Ht, Kt = -(-H // 16), H // 8
    half, tix = np.divmod(np.arange(2 * Ht * Kt), Ht * Kt)
    mt, kt = np.divmod(tix, Kt)
    g, t = np.divmod(np.arange(32), 4)
    i = np.arange(4)
    r = 16 * mt[:, None, None] + g[None, :, None] + 8 * (i & 1)
    k = 8 * kt[:, None, None] + t[None, :, None] + 4 * (i >> 1)
    row = np.where(r < H, half[:, None, None] * H + r, -1)
    out = np.stack([row, k], -1)[:, None]            # (tile, part, ...)
    return np.broadcast_to(out, (out.shape[0], 2) + out.shape[2:])


@pytest.mark.parametrize("H", [8, 24, 40, 128, 136])
def test_split_scratch_is_a_bijection(H):
    """Kernel 2's split-weight scratch (glu_tf32_split_floats floats)
    holds every entry of W exactly once in each part (hi, lo), in the
    fragment order load_a_split reads (tile, part, lane, register), each
    half's rows padded with zeros to whole m-tiles (so at a ragged H, a
    multiple of 8 and not of 16, no m-tile mixes value and gate rows); hi
    + lo is the weight to 2^-22."""
    mp = _split_map(H)
    assert mp[..., 0].size == chmix.glu_tf32_split_floats(H)
    for part in (0, 1):
        seen = np.zeros((2 * H, H), np.int64)
        r, k = mp[:, part].reshape(-1, 2).T
        np.add.at(seen, (r[r >= 0], k[r >= 0]), 1)
        assert (seen == 1).all()
    w = torch.from_numpy(np.random.RandomState(9).randn(2 * H, H)
                         .astype(np.float32))
    hi, lo = split(w)
    assert torch.allclose(hi + lo, w, rtol=2 ** -21, atol=0)


@pytest.mark.parametrize("H", [8, 24, 128, 136, 512, 1024, 1680])
def test_warps_pair_every_value_row_with_its_gate_row(H):
    """The warps' units (csrc glu_res_tf32_kernel: warp w takes units w, w
    + 8, ..., each MV value m-tiles from mt0 = MV u and, through
    warp_gemm_3xtf32_ring's groups (MG MV, gap Ht), the gate m-tiles Ht +
    mt0 ..) at every (P, blocks) the kernel is built for: each output row
    o < H is written once, by the thread holding value row o and gate
    row H + o of W (the split map's rows at the two tiles it loads); the
    tiles a unit loads past 2 Ht are the zero rows load_a_split returns."""
    Ht = -(-H // 16)
    mp = _split_map(H)
    Kt = H // 8
    for P, blocks in (*chmix.GLU_TF32_SHARED,
                      *((P, 1) for P in chmix.GLU_TF32_PS)):
        MV = _mv(P, blocks)
        rows = []
        for warp in range(NWARPS):
            u = warp
            while u * MV < Ht:
                mt0 = MV * u
                tiles = [mt0 + m % MV + Ht * (m // MV) for m in range(2 * MV)]
                for m in range(MV):
                    vt, gt = tiles[m], tiles[MV + m]
                    if 16 * vt >= H:
                        break
                    assert gt < 2 * Ht
                    # lane 4 g + t, register i: row 16 mt + g + 8 (i & 1)
                    v_rows = mp[vt * Kt, 0, :, :, 0]
                    g_rows = mp[gt * Kt, 0, :, :, 0]
                    ok = v_rows >= 0
                    assert (g_rows[ok] == v_rows[ok] + H).all()
                    assert (g_rows[~ok] == -1).all()
                    rows += [int(r) for r in np.unique(v_rows[ok])]
                u += NWARPS
        assert sorted(rows) == list(range(H))


# ---- the wrapper --------------------------------------------------------------

@pytest.mark.parametrize("B,H,L", [(2, 24, 333), (1, 16, 64)])
def test_wrapper_is_its_plain_version_on_cpu(B, H, L):
    """On CPU tensors kernel 2's wrapper returns its plain version's f32
    output bit for bit, at a width that is a multiple of 8 but not 16 and
    a ragged L, and counts no launch."""
    data = [torch.from_numpy(a) for a in _data(B, H, L)]
    before = {k: f.launches for k, f in ops.COUNTED.items()}
    out = ops.mix_glu_res(*data)
    assert out.shape == (B, H, L) and out.dtype == torch.float32
    assert torch.equal(out, ops.glu_res_ref(*data))
    assert {k: f.launches for k, f in ops.COUNTED.items()} == before


@pytest.mark.parametrize("B,H,L", [(4, 128, 16000), (4, 256, 4000),
                                   (4, 512, 1000), (4, 1024, 1000),
                                   (2, 24, 333)])
def test_wrapper_passes_its_signature(monkeypatch, B, H, L):
    """On the card kernel 2's wrapper hands ``dwst_glu_res`` exactly the
    arguments its ctypes signature names, the stream apart (addresses
    where it takes pointers, the split scratch after out; the widths and
    the plan's P, blocks an SM and bytes last), and counts one launch."""
    calls = []
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *a: calls.append(
        (name, a)))
    monkeypatch.setattr(cuda_lib, "check", lambda *a: None)
    monkeypatch.setattr(cuda_lib, "sm_count", lambda dev: SMS)
    # meta tensors: the shipped shapes with no memory (their addresses 0)
    data = [torch.empty(s, device="meta").as_subclass(_OnCard) for s in (
        (B, H, L), (B, H, L), (2 * H, H), (2 * H,))]
    before = {k: f.launches for k, f in ops.COUNTED.items()}
    ops.mix_glu_res(*data)
    after = {k: f.launches for k, f in ops.COUNTED.items()}
    assert {k for k in after if after[k] != before[k]} == {"glu_res"}
    assert after["glu_res"] == before["glu_res"] + 1
    (name, got), = calls
    assert name == "dwst_glu_res"
    sig = cuda_lib._SIGNATURES[name]
    assert len(got) + 1 == len(sig)
    for a, t in zip(got, sig):
        assert isinstance(a, int) and (t is cuda_lib._P or abs(a) < 2 ** 31)
    assert got[:6] == (0,) * 6
    assert got[-6:] == (B, H, L, *chmix.glu_tf32_plan(B, H, L, SMS))


@pytest.mark.parametrize("H,match", [
    (12, "H = 12 must be a positive multiple of 8"),
    (7144, "H = 7144 need .* bytes")])
def test_wrapper_refuses_before_any_launch(monkeypatch, H, match):
    """Widths kernel 2 does not take raise ValueError naming them from the
    wrapper before it checks a tensor or launches anything (meta tensors
    stand in for y and res)."""
    calls = []
    monkeypatch.setattr(cuda_lib, "launch", lambda *a: calls.append(a))
    y = torch.empty(1, H, 8, device="meta").as_subclass(_OnCard)
    before = {k: f.launches for k, f in ops.COUNTED.items()}
    with pytest.raises(ValueError, match=match):
        ops.mix_glu_res(y, y, None, None)
    assert calls == []
    assert {k: f.launches for k, f in ops.COUNTED.items()} == before


# ---- what chip_smoke.py and the source say of kernel 2 ----------------------

def _chip_smoke():
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_instances_are_the_plans():
    """csrc/chmix.cu's entry builds kernel 2 at exactly the (P, blocks an
    SM) its plan may pick (GLU_TF32_SHARED, and GLU_TF32_PS at one block),
    and chip_smoke.py's phase 1 requires each of them (TF32_KERNELS) and
    kernel 2's split."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(__file__), os.pardir,
                            "diffwave_sashimi_torch", "csrc",
                            "chmix.cu")).read()
    built = {(int(p), int(b)) for p, b in re.findall(
        r"run\(launch_glu_tf32<(\d+), (\d+)>\)", src)}
    plans = {*chmix.GLU_TF32_SHARED, *((P, 1) for P in chmix.GLU_TF32_PS)}
    assert built == plans
    smoke = _chip_smoke()
    assert {tuple(map(int, k.split(", "))) for k in
            smoke.TF32_KERNELS["glu_res_tf32_kernel"]} == plans
    assert "split_weights_tf32_kernel<2>" in smoke.TF32_SPLITS
    assert "glu_res_tf32_kernel" in smoke.PORT_KERNELS


def test_chip_smoke_bound_counts_the_3xtf32_work():
    """chip_smoke.py's bound of kernel 2 at SC09's top tier (B4 H128
    L16000) counts its product as three TF32 products (4 H^2 B L
    operations each, 0.0254 ms at 495 T/s) beside its bytes (y and res
    read, out written, the weights: 0.0294 ms at 3.35 TB/s), so bytes
    bound it; on the fp32 FMAs the product alone took 0.0626 ms."""
    smoke = _chip_smoke()
    B, H, L = 4, 128, 16000
    ops_, nbytes = smoke.work("glu_res", B, H, L, 32768)
    assert ops_ == {"tf32": 3 * 4 * H * H * B * L}
    assert nbytes == 3 * B * H * L * 4 + (2 * H * H + 2 * H) * 4
    ms, by = smoke.bound("glu_res", B, H, L, 32768)
    assert by == "bytes" and abs(ms - 0.0294) < 5e-4
    assert abs(1e3 * 4 * H * H * B * L / smoke.PEAK_OPS["fp32"]
               - 0.0626) < 5e-4
    parts = smoke.kernel_parts("glu_res", {}, {})
    assert parts["global_kernels"] == ["split_weights_tf32_kernel<2>",
                                       "glu_res_tf32_kernel"]
