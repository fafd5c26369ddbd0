"""Kernel 11f's tile plan and width rule, checked without a card: the
plan's shared memory and positions a block at the WaveNet's shipped
widths and at every residual width 11f takes up to 512, the wrapper's
refusals before any launch, and the plain version on CPU tensors."""

import math

import numpy as np
import pytest
import torch

from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.ops import chmix, wavenet_gate as wg

BF = torch.bfloat16
SMS = 132                       # the H100's SMs
# an SM's shared memory less the card's 1 KB a block, shared by two blocks
TWO_A_SM = (228 * 1024) // 2 - 1024


def _layout(C, S, P):
    """Bytes of kernel 11f's tiles at P (csrc/wavenet_gate.cu::
    gate_res_skip_tc_kernel): the bf16 gate tile (C rows padded to 16) and
    the bf16 staging tile of one pass (8 warps' m-tiles: 128 rows at P
    128, 256 at 64, 512 at 32; or C + S padded to 16 if fewer), rows
    padded to P + 8."""
    kp, mp = 16 * math.ceil(C / 16), 16 * math.ceil((C + S) / 16)
    rows = {128: 128, 64: 256, 32: 512}[P]
    return kp * (P + 8) * 2, min(mp, rows) * (P + 8) * 2, rows


@pytest.mark.parametrize("B", [4, 16])
@pytest.mark.parametrize("C,S,L", [(256, 256, 16000), (256, 256, 16128),
                                   (256, 256, 8960), (128, 256, 16000),
                                   (128, 256, 8960), (128, 256, 16128)],
                         ids=lambda v: str(v))
def test_gate_bf16_plan_at_shipped_widths(B, C, S, L):
    """At sc09_wavenet's widths (C256 S256) and wavenet_small's (C128
    S256), B4 and B16, L 16000, 8960 and 16128 (the conditional model's
    63 mel frames): P 128, whose grid fills a wave of two blocks an SM,
    and tiles that let two blocks share an SM."""
    P, smem = wg.gate_bf16_plan(B, C, S, L, sms=SMS)
    assert P == 128
    assert B * math.ceil(L / P) >= 2 * SMS
    gate, staging, _ = _layout(C, S, P)
    assert smem == gate + staging
    assert smem <= TWO_A_SM and smem <= chmix.SMEM_LIMIT == 227 * 1024
    assert wg.gate_bf16_refusal(C, S) is None


@pytest.mark.parametrize("B,L,want", [(1, 16000, 32), (2, 16000, 64),
                                      (1, 33664, 64), (3, 11264, 128)])
def test_gate_bf16_plan_narrows_p_for_small_grids(B, L, want):
    """Where the grid at P 128 fills less than one wave of two blocks an SM,
    the plan takes the widest narrower P that does, else P 32."""
    P, _ = wg.gate_bf16_plan(B, 256, 256, L, sms=SMS)
    assert P == want


@pytest.mark.parametrize("C", range(8, 513, 8))
def test_gate_bf16_plan_holds_every_tile(C):
    """At every residual width 11f takes up to 512 (multiples of 8) with S
    in {8, 40, C, 2C}, at a short, a middle and a long sequence: the plan
    holds the kernel's layout, within 227 KB; the staging tile starts
    16-byte aligned; ldmatrix's rows fall on distinct banks (row stride /
    16 bytes odd); the passes cover all C + S rows; two blocks share an SM
    wherever some P lets them."""
    for S in (8, 40, C, 2 * C):
        assert wg.gate_bf16_refusal(C, S) is None
        for B, L in ((1, 100), (4, 1000), (4, 16000)):
            P, smem = wg.gate_bf16_plan(B, C, S, L, sms=SMS)
            assert P in wg.GATE_BF16_PS
            gate, staging, rows = _layout(C, S, P)
            assert smem == gate + staging <= chmix.SMEM_LIMIT
            assert gate % 16 == 0 and (P + 8) * 2 // 16 % 2 == 1
            assert math.ceil((C + S) / rows) * rows >= C + S
            if min(sum(_layout(C, S, p)[:2]) for p in wg.GATE_BF16_PS) \
                    <= TWO_A_SM:
                assert smem <= TWO_A_SM


class _OnCard:
    """Stands in for h as a CUDA tensor (there is no card here): the
    wrapper reads only its ``is_cuda`` before it checks the widths."""
    is_cuda = True


@pytest.mark.parametrize("C,S,match", [
    (12, 8, "C = 12 must be a positive multiple of 8"),
    (250, 256, "C = 250 must be a positive multiple of 8"),
    (0, 8, "C = 0 must be a positive multiple of 8"),
    (16, 0, "S = 0 must be positive"),
    (4096, 256, "C = 4096, S = 256 need .* bytes")])
def test_gate_bf16_wrapper_refuses_before_launch(C, S, match):
    """Widths 11f does not take (C not a positive multiple of 8, as the old
    kernel refused; S not positive; tiles past one block at every P) raise
    ValueError naming them from the wrapper before it checks a tensor or
    builds or launches anything (meta tensors stand in for x and W_s)."""
    x = torch.empty(1, C, 8, dtype=BF, device="meta")
    ws = torch.empty(S, C, device="meta")
    before = ops.gate_res_skip_bf16.launches
    with pytest.raises(ValueError, match=match):
        wg.gate_res_skip_bf16(_OnCard(), x, None, None, ws, None)
    assert ops.gate_res_skip_bf16.launches == before


@pytest.mark.parametrize("C,S", [(-8, 8), (8, -1), (1000, 8), (20, 20),
                                 (1680, 4096), (2384, 8), (2392, 8)])
def test_gate_bf16_refusal_names_the_width(C, S):
    """The refusal function alone, at widths no tensor can have: None only
    where C is a positive multiple of 8 up to 2384 and S positive (C 1680,
    the widest the fp32 gate tile of kernel 11 holds, at any S); past
    2384 the tiles outgrow a block."""
    refusal = wg.gate_bf16_refusal(C, S)
    if 0 < C <= 2384 and C % 8 == 0 and S > 0:
        assert refusal is None
    else:
        assert refusal.startswith("kernel 11f: ") and (
            f"C = {C}" in refusal or f"S = {S}" in refusal)


def _gate_data(B, C, S, L, seed=0):
    rng = np.random.RandomState(seed)
    h, x = rng.randn(B, 2 * C, L), 0.3 * rng.randn(B, C, L)
    return (torch.from_numpy(h.astype(np.float32)).to(BF),
            torch.from_numpy(x.astype(np.float32)).to(BF),
            *(torch.from_numpy(w.astype(np.float32)) for w in (
                0.2 * rng.randn(C, C), 0.1 * rng.randn(C),
                0.2 * rng.randn(S, C), 0.1 * rng.randn(S))))


@pytest.mark.parametrize("B,C,S,L", [(2, 24, 40, 333), (1, 16, 8, 64)])
def test_gate_bf16_wrappers_on_cpu_are_the_plain_version(B, C, S, L):
    """On CPU tensors ``gate_res_skip`` and ``gate_res_skip_bf16`` return
    exactly the plain version's bf16 res and skip and count no launch, at
    a width that is a multiple of 8 but not 16 with S != C and a ragged L
    (the card's zero-padding case) and at a plain one."""
    data = _gate_data(B, C, S, L)
    before = (ops.gate_res_skip.launches, ops.gate_res_skip_bf16.launches)
    ref = ops.gate_res_skip_ref(*data)
    for fn in (ops.gate_res_skip, ops.gate_res_skip_bf16):
        out = fn(*data)
        assert [o.shape for o in out] == [(B, C, L), (B, S, L)]
        assert all(o.dtype == BF for o in out)
        assert all(torch.equal(o, r) for o, r in zip(out, ref))
    assert (ops.gate_res_skip.launches,
            ops.gate_res_skip_bf16.launches) == before
