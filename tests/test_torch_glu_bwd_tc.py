"""Kernel 6f's tile plan and width rule, checked without a card: the plan
holds its kernel's layout (csrc/chmix.cu::glu_res_bwd_tc_kernel) in one
block's shared memory at every tier of SC09 and of d_model 256 and at every
width 6f takes; it takes the widest P that fits and whose grid fills 90% of
a wave, else the narrowest; widths 6f does not take are refused by name
before a launch, and a SaShiMi whose widths 2f refuses keeps 2f's message;
the wrappers pass their entry points the arguments the ctypes signatures
name; on CPU tensors the 6f wrapper is its plain version."""

import types

import numpy as np
import pytest
import torch

from test_torch_common import SMALL_CFG

from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.config import load_config
from diffwave_sashimi_torch.models import check_supported
from diffwave_sashimi_torch.ops import chmix, cuda_lib

BF = torch.bfloat16
SMS = 132                       # the H100's SMs
NT, NWARPS = 256, 8             # csrc/chmix.cu: threads and warps a block


def _tiers(L, B):
    """(B, H, L) of each UNet tier of SC09's shipped model at length L and
    batch B, and of the same model at d_model 256."""
    m = load_config(overrides=["experiment=sc09"]).model
    out = []
    for d_model in (m.d_model, 256):
        H, Lt = d_model, L
        for i in range(len(m.pool) + 1):
            out.append((B, H, Lt))
            if i < len(m.pool):
                H, Lt = H * m.expand, Lt // m.pool[i]
    return sorted(set(out))


TIERS = _tiers(16000, 4)


def _layout(H, P):
    """The kernel's tiles at (H, P), from csrc/chmix.cu::GluBwdTile: value
    m-tiles a warp in GEMM 1 (MV), dy m-tiles a warp in GEMM 2 (MT2), and
    the bytes of the y tile and of the 2H-row dz tile."""
    MV, MT2 = min(128 // P, 4), 128 // P
    return MV, MT2, H * (P + 8) * 2, 2 * H * (P + 8) * 2


def _holds(B, H, L):
    """The plan at (B, H, L) against the kernel's layout: P one the kernel
    is built for; the shared memory exactly the y tile and the dz tile,
    within one block's 227 KB, each region 16-byte aligned, ldmatrix's
    eight rows on distinct banks (row stride / 16 bytes odd); at most 128
    f32 sums a thread in GEMM 1 and 64 in GEMM 2; GEMM 1's passes of 128
    MV value rows and GEMM 2's of 128 MT2 rows cover all H rows; each
    thread's rows, NT / (P / 8) apart, cover the tile."""
    P, smem = chmix.glu_bwd_bf16_plan(B, H, L, sms=SMS)
    assert P in chmix.GLU_BWD_BF16_PS
    MV, MT2, y_tile, dz_tile = _layout(H, P)
    assert smem == y_tile + dz_tile <= chmix.SMEM_LIMIT
    assert y_tile % 16 == 0 and dz_tile % 16 == 0
    assert (P + 8) * 2 // 16 % 2 == 1
    assert 2 * MV * (P // 8) * 4 <= 128 and MT2 * (P // 8) * 4 == 64
    rows1, rows2 = NWARPS * 16 * MV, NWARPS * 16 * MT2
    assert -(-H // rows1) * rows1 >= H and -(-H // rows2) * rows2 >= H
    assert NT // (P // 8) * (P // 8) == NT
    return P


@pytest.mark.parametrize("tier", TIERS, ids=lambda t: "B{}-H{}-L{}".format(*t))
def test_glu_bwd_bf16_plan_holds_every_tier(tier):
    """At every tier of SC09's model and of d_model 256 (B4) 6f takes the
    width and its plan holds the kernel's layout."""
    B, H, L = tier
    assert chmix.glu_bwd_refusal(H, BF) is None
    _holds(B, H, L)


@pytest.mark.parametrize("H", range(16, 1025, 16))
def test_glu_bwd_bf16_plan_holds_every_width(H):
    """At every width 6f takes (multiples of 16 up to 1024) and at a
    short, a middle and a long sequence, the plan holds the kernel's
    layout."""
    assert chmix.glu_bwd_refusal(H, BF) is None
    for B, L in ((1, 100), (4, 1000), (2, 143360)):
        _holds(B, H, L)


@pytest.mark.parametrize("B,H,L,P", [
    (4, 128, 16000, 128), (4, 256, 4000, 128), (4, 512, 1000, 32),
    (4, 1024, 1000, 16), (4, 512, 16000, 64), (1, 512, 4224, 32),
    (1, 512, 16896, 64), (2, 1024, 143360, 16), (2, 144, 1001, 16),
    (1, 16, 100, 16), (1, 128, 16000, 128), (1, 128, 8000, 64),
    (1, 128, 7000, 32)])
def test_glu_bwd_bf16_plan_takes_the_widest_p_that_fits(B, H, L, P):
    """P is the widest of 128, 64, 32, 16 whose tiles fit one block (128
    up to H 272, 64 up to H 528, 32 up to H 960) and whose grid of ceil(L /
    P) x B blocks fills 90% of one wave of 132 SMs (119 blocks); where no
    P fills it, the narrowest that fits (the most blocks)."""
    assert chmix.glu_bwd_bf16_plan(B, H, L, sms=SMS)[0] == P


@pytest.mark.parametrize("H,refused", [
    (8, "kernel 6f: channel width H = 8 must be a positive multiple of 16"),
    (24, "kernel 6f: channel width H = 24 must be a positive multiple of "
         "16"),
    (1040, "kernel 6f: channel width H = 1040 is over 1024"),
    (0, "kernel 6f: channel width H = 0 must be a positive multiple of 16"),
    (-16, "kernel 6f: channel width H = -16 must be a positive multiple of "
          "16")])
def test_glu_bwd_bf16_refuses_widths_by_name(H, refused):
    """6f refuses, naming the width, H that is not a positive multiple of
    16 (its mma tiles are 16 deep) or is past 1024; kernel 6 (f32, k-tiles
    of 8) takes 8 and 24."""
    assert chmix.glu_bwd_refusal(H, BF) == refused
    if H in (8, 24):
        assert chmix.glu_bwd_refusal(H, torch.float32) is None


def test_glu_bwd_bf16_wrapper_refuses_before_any_launch(monkeypatch):
    """On a CUDA tensor the 6f wrapper (and kernel 6's, which routes bf16
    to it) raises ValueError naming the width before it checks, allocates
    or launches anything: the launcher is replaced by one that fails the
    test, and the tensors by stand-ins that carry only is_cuda, dtype and
    a shape."""
    monkeypatch.setattr(cuda_lib, "launch", lambda *a: pytest.fail(
        "the wrapper launched a kernel"))
    before = {k: f.launches for k, f in ops.COUNTED.items()}
    y = types.SimpleNamespace(is_cuda=True, dtype=BF, shape=(4, 24, 1000))
    for fn in (ops.glu_res_bwd_bf16, ops.glu_res_bwd):
        with pytest.raises(ValueError, match="kernel 6f: channel width "
                                             "H = 24 must be"):
            fn(y, None, None, y)
    assert {k: f.launches for k, f in ops.COUNTED.items()} == before


@pytest.mark.parametrize("d_model,refused", [
    (8, "kernel 2f: channel width H = 8 must be a positive multiple of 16"),
    (24, "kernel 2f: channel width H = 24 must be a positive multiple of "
         "16"),
    (512, "kernel 2f: channel width H = 2048 is over 1024")])
def test_bf16_training_refusal_keeps_2fs_message(d_model, refused):
    """bf16 training on the card at a width 2f already refuses names 2f,
    word for word, as before 6f took 2f's width rule: check_mixer_widths
    asks 2f first."""
    cfg = dict(SMALL_CFG, d_model=d_model)
    with pytest.raises(NotImplementedError) as e:
        check_supported(cfg, "bf16", True, device_type="cuda")
    assert str(e.value) == (f"{refused}; on the card these widths are not "
                            "ported: ROADMAP.md queue 1, item 8")


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card, so that a wrapper takes
    its launch route up to the launcher."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("dtype,entry", [(BF, "dwst_glu_res_bwd_bf16"),
                                         (torch.float32, "dwst_glu_res_bwd")],
                         ids=["6f", "6"])
def test_glu_bwd_wrappers_pass_their_signatures(monkeypatch, dtype, entry):
    """The wrapper of kernel 6f (and of 6) hands its entry point exactly
    the arguments its ctypes signature names, the stream apart: addresses
    where it takes pointers, ints where it takes ints, ending with (B, H,
    L, positions a weight-gradient split) and the plan (6f's P, smem;
    6's P, blocks an SM, smem); 6f's bf16 weight scratch holds W and W^T
    (4 H^2 entries, 8 H^2 bytes), 6's f32 split scratch W's halves and W^T
    in tf32 parts (no transposed copy of W), and it launches once, counted
    on its wrapper."""
    calls = []
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *a: calls.append(
        (name, a)))
    monkeypatch.setattr(cuda_lib, "check", lambda *a: None)
    monkeypatch.setattr(cuda_lib, "sm_count", lambda dev: SMS)
    made = []
    real_new_empty = torch.Tensor.new_empty

    def new_empty(self, *a, **k):
        made.append(real_new_empty(self, *a, **k))
        return made[-1]
    monkeypatch.setattr(torch.Tensor, "new_empty", new_empty)
    B, H, L = 2, 32, 1001
    y = torch.zeros(B, H, L, dtype=dtype).as_subclass(_OnCard)
    w, b = torch.zeros(2 * H, H), torch.zeros(2 * H)
    wrapper = ops.glu_res_bwd_bf16 if dtype == BF else ops.glu_res_bwd
    before = wrapper.launches
    dy, dw, db = ops.glu_res_bwd(y, w, b, y)
    assert wrapper.launches == before + 1
    (name, args), = calls
    assert name == entry
    sig = cuda_lib._SIGNATURES[entry]
    assert len(args) + 1 == len(sig)
    for a, t in zip(args, sig):
        assert isinstance(a, int) and (t is cuda_lib._P or abs(a) < 2 ** 31)
    tc = chmix.wgrad_plan(B, 2 * H, H, L, SMS)[0]
    plan = (chmix.glu_bwd_bf16_plan(B, H, L, SMS) if dtype == BF
            else chmix.glu_bwd_tf32_plan(B, H, L, SMS))
    assert args[-4 - len(plan):] == (B, H, L, tc, *plan)
    assert dy.dtype == dtype and tuple(dy.shape) == (B, H, L)
    assert tuple(dw.shape) == (2 * H, H) and tuple(db.shape) == (2 * H,)
    if dtype == BF:
        wb = [t for t in made if t.dtype == BF]
        assert [t.numel() for t in wb] == [4 * H * H]
        assert args[8] == wb[0].data_ptr()
    else:
        wf = [t for t in made if t.numel() == chmix.glu_bwd_tf32_split_floats(
            H)]
        assert len(wf) == 1 and args[8] == wf[0].data_ptr()
        assert not any(t.shape == (H, 2 * H) for t in made)


def test_glu_bwd_bf16_wrapper_is_its_plain_version_on_cpu():
    """On CPU tensors 6f's wrapper (and kernel 6's, for bf16) returns its
    plain version's results bit for bit and counts no launch: dy bf16,
    dw and db f32."""
    rng = np.random.RandomState(5)
    B, H, L = 2, 16, 40

    def f(*s, sc=1.0):
        return torch.from_numpy((rng.randn(*s) * sc).astype(np.float32))
    args = (f(B, H, L).to(BF), f(2 * H, H, sc=0.3), f(2 * H, sc=0.1),
            f(B, H, L).to(BF))
    before = {k: fn.launches for k, fn in ops.COUNTED.items()}
    ref = ops.glu_res_bwd_ref(*args)
    assert ref[0].dtype == BF
    assert all(r.dtype == torch.float32 for r in ref[1:])
    for fn in (ops.glu_res_bwd_bf16, ops.glu_res_bwd):
        assert all(torch.equal(a, b) for a, b in zip(fn(*args), ref))
    assert {k: fn.launches for k, fn in ops.COUNTED.items()} == before
