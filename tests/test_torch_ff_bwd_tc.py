"""Kernel 7f's tile plan and width rule, and the weight-gradient
contraction's split plan (kernels 6, 6f, 7 and 7f), checked without a
card: 7f's plan holds its kernel's layout in one block's shared memory at
every tier of d_model 128 and 256 (F = 2H and F = H) and at the vocoder's
tiers; widths 7f does not take are refused by name before a launch; the
split plan fills at least two waves of the H100's 132 SMs at every SC09
tier and sizes its partials; on CPU tensors the 7f wrapper is its plain
version."""

import types

import numpy as np
import pytest
import torch

from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.config import load_config
from diffwave_sashimi_torch.ops import chmix

BF = torch.bfloat16
SMS = 132                       # the H100's SMs
NT, NWARPS = 256, 8             # csrc/chmix.cu: threads and warps a block


def _tiers(experiment, L, B):
    """(B, H, L) of each UNet tier of an experiment's shipped model at
    generated length L and batch B, and at d_model 256."""
    m = load_config(overrides=[f"experiment={experiment}"]).model
    out = []
    for d_model in (m.d_model, 256):
        H, Lt = d_model, L
        for i in range(len(m.pool) + 1):
            out.append((B, H, Lt))
            if i < len(m.pool):
                H, Lt = H * m.expand, Lt // m.pool[i]
    return sorted(set(out))


SC09 = _tiers("sc09", 16000, 4)
VOCODER = _tiers("ljspeech", 143360, 2)


def _tier_id(t):
    return "B{}-H{}-L{}".format(*t)


@pytest.mark.parametrize("hidden", [2, 1], ids=["F=2H", "F=H"])
@pytest.mark.parametrize("tier", SC09 + VOCODER, ids=_tier_id)
def test_ff_bwd_bf16_plan_holds_every_tile(tier, hidden):
    """7f's plan (csrc/chmix.cu::ln_ff_res_bwd_tc_kernel) at each tier: no
    refusal; P one the kernel is built for with H P <= 16384 (the 8 warps'
    128 / P m-tiles of dxn cover H rows, each thread's 8-position chunk
    holds at most 8 of them); the shared memory holds 20 P floats of sums
    and statistics, the H-row bf16 x and g tiles and one region for the
    F-row bf16 dz tile and then the H-row f32 dxn tile, rows padded to P +
    8, within one block's 227 KB; every region starts 16-byte aligned and
    ldmatrix's eight rows fall on distinct banks."""
    _, H, _ = tier
    F = hidden * H
    assert chmix.ff_bwd_refusal(H, F, BF) is None
    P, smem = chmix.ff_bwd_bf16_plan(H, F)
    assert P in chmix.FF_BWD_BF16_PS and H * P <= 16384
    assert 16 * NWARPS * (128 // P) >= H
    assert 8 * (NT // (P // 8)) >= H
    stats = 4 * (2 * NWARPS * P + 4 * P)
    tile = H * (P + 8) * 2
    region = max(F * (P + 8) * 2, H * (P + 8) * 4)
    assert smem == stats + 2 * tile + region <= chmix.SMEM_LIMIT
    assert stats % 16 == 0 and tile % 16 == 0
    assert (P + 8) * 2 // 16 % 2 == 1


@pytest.mark.parametrize("H,F,P", [(128, 256, 128), (256, 512, 64),
                                   (512, 1024, 32), (1024, 2048, 16),
                                   (128, 128, 128), (1024, 1024, 16),
                                   (512, 2048, 16), (144, 288, 64)])
def test_ff_bwd_bf16_plan_takes_the_widest_p_that_fits(H, F, P):
    """P is the widest of 128, 64, 32, 16 with H P <= 16384, halved where
    the tiles do not fit (H 512 with F = 4H); the grid does not change
    it."""
    assert chmix.ff_bwd_bf16_plan(H, F)[0] == P


@pytest.mark.parametrize("H,F,refused", [
    (24, 48, "kernel 7f: channel width H = 24 must be a positive multiple "
             "of 16"),
    (128, 200, "kernel 7f: channel width F = 200 must be a positive "
               "multiple of 16"),
    (0, 16, "kernel 7f: channel width H = 0"),
    (1040, 2080, "kernel 7f: channel width H = 1040 is over 1024"),
    (2048, 4096, "kernel 7f: channel width H = 2048 is over 1024"),
    (1024, 4096, "kernel 7f: widths H = 1024, F = 4096 need 296192 bytes")])
def test_ff_bwd_bf16_refuses_widths_by_name(H, F, refused):
    """7f refuses, naming the width, channel widths that are not positive
    multiples of 16 (its mma tiles are 16 deep), H past 1024, and tiles
    past one block's shared memory; kernel 7 (f32, k-tiles of 8) takes
    the multiples of 8 among them."""
    why = chmix.ff_bwd_refusal(H, F, BF)
    assert why is not None and why.startswith(refused)
    if H == 24:
        assert chmix.ff_bwd_refusal(H, F, torch.float32) is None


def test_ff_bwd_bf16_wrapper_refuses_before_any_launch():
    """On a CUDA tensor the 7f wrapper (and kernel 7's, which routes bf16
    to it) raises ValueError naming the width before it checks, allocates
    or launches anything (a stand-in for the card's tensors: the refusal
    reads only is_cuda, dtype and the shapes)."""
    before = {k: f.launches for k, f in ops.COUNTED.items()}
    x = types.SimpleNamespace(is_cuda=True, dtype=BF, shape=(4, 24, 1000))
    w1 = types.SimpleNamespace(shape=(48, 24))
    for fn in (ops.ln_ff_res_bwd_bf16, ops.ln_ff_res_bwd):
        with pytest.raises(ValueError, match="kernel 7f: channel width "
                                             "H = 24"):
            fn(x, None, None, w1, None, None, None, x)
    assert {k: f.launches for k, f in ops.COUNTED.items()} == before


def _contractions(H):
    """(M, N) of every weight-gradient contraction at a tier: kernel 7's
    and 7f's dW1 (F x H) and dW2 (H x F) at F = 2H and F = H, kernel 6's
    and 6f's dW (2H x H)."""
    return [(2 * H, H), (H, 2 * H), (H, H)]


@pytest.mark.parametrize("tier", SC09, ids=_tier_id)
def test_wgrad_plan_fills_two_waves_and_sizes_its_partials(tier):
    """The contraction's split-K plan at each SC09 tier (d_model 128 and
    256): at least two waves of one block an SM on 132 SMs (a block per
    128 x 128 output tile and split), at least 90% of its waves' SMs busy;
    the positions a split a multiple of 8 (16-byte aligned starts) and at
    least one 32-position stage, covering each batch row in exactly the
    plan's splits; the partials' bytes are splits x (M N + M) f32."""
    B, H, L = tier
    for M, N in _contractions(H):
        tc, splits, nbytes = chmix.wgrad_plan(B, M, N, L, SMS)
        tiles = -(-M // 128) * -(-N // 128)
        blocks = tiles * splits
        assert blocks >= 2 * SMS
        assert blocks / (-(-blocks // SMS) * SMS) >= 0.9
        assert tc % 8 == 0 and tc >= 32
        per_row = splits // B
        assert splits == B * per_row
        assert (per_row - 1) * tc < L <= per_row * tc
        assert nbytes == splits * (M * N + M) * 4


@pytest.mark.parametrize("B,M,N,L", [(1, 16, 16, 100), (2, 256, 128, 1001),
                                     (1, 32, 16, 33)])
def test_wgrad_plan_on_rows_too_short_for_two_waves(B, M, N, L):
    """Where a batch row is too short for two waves, the plan cuts it into
    one-stage splits of 32 positions, the finest it takes."""
    tc, splits, nbytes = chmix.wgrad_plan(B, M, N, L, SMS)
    assert tc == 32 and splits == B * -(-L // 32)
    assert nbytes == splits * (M * N + M) * 4


def test_ff_bwd_bf16_wrapper_is_its_plain_version_on_cpu():
    """On CPU tensors 7f's wrapper (and kernel 7's, for bf16) returns its
    plain version's results bit for bit, at F = 2H and at F = H, and
    counts no launch: dx bf16, the rest f32."""
    rng = np.random.RandomState(3)
    B, H, L = 2, 16, 40

    def f(*s, sc=1.0):
        return torch.from_numpy((rng.randn(*s) * sc).astype(np.float32))
    before = {k: fn.launches for k, fn in ops.COUNTED.items()}
    for F in (2 * H, H):
        args = (f(B, H, L).to(BF), f(1, sc=0.1), 1.0 + f(1, sc=0.1),
                f(F, H, sc=0.3), f(F, sc=0.1), f(H, F, sc=0.3), f(H, sc=0.1),
                f(B, H, L).to(BF))
        ref = ops.ln_ff_res_bwd_ref(*args)
        assert ref[0].dtype == BF
        assert all(r.dtype == torch.float32 for r in ref[1:])
        for fn in (ops.ln_ff_res_bwd_bf16, ops.ln_ff_res_bwd):
            assert all(torch.equal(a, b) for a, b in zip(fn(*args), ref))
    assert {k: fn.launches for k, fn in ops.COUNTED.items()} == before
