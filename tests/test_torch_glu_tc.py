"""Kernel 2f's tile plan and width rule, the channel mixers' plans at
every tier of d_model 128 and 256, and the port's named refusals, checked
without a card: the plan's shared memory at the shipped tiers and at every
width 2f takes, the positions a block and bytes each fp32 mixer plan picks
up to H 1024, the card's refusal of widths no mixer kernel takes
(sampling and training, f32 and bf16), the refusal of f32 training past
kernel 1's FFT sizes on the card only, and the loader's refusal of mel
datasets."""

import math

import numpy as np

import pytest
import torch

from test_torch_common import SMALL_CFG

from diffwave_sashimi_torch.config import load_config
from diffwave_sashimi_torch.data import dataloader
from diffwave_sashimi_torch.models import check_supported, construct_model
from diffwave_sashimi_torch.models.sashimi import check_train_length
from diffwave_sashimi_torch.ops import chmix

BF, F32 = torch.bfloat16, torch.float32
SMS = 132                       # the H100's SMs


def _tiers(experiment, L, B):
    """(B, H, L) of each UNet tier of an experiment's shipped model at
    generated length L and batch B."""
    m = load_config(overrides=[f"experiment={experiment}"]).model
    out, H = [], m.d_model
    for i in range(len(m.pool) + 1):
        out.append((B, H, L))
        if i < len(m.pool):
            H, L = H * m.expand, L // m.pool[i]
    return out


@pytest.mark.parametrize("tier", [*_tiers("sc09", 16000, 4),
                                  *_tiers("ljspeech", 143360, 2)],
                         ids=lambda t: "B{}-H{}-L{}".format(*t))
def test_glu_bf16_plan_fits_shared_memory(tier):
    """Kernel 2f's plan at SC09's three tiers (B4) and the vocoder's (B2,
    a 6.5 s utterance): the width passes the check, a block's shared
    memory is within the 227 KB a block may use, P is 128 at H 128 and 64
    at H 256, and at H 512 64 exactly where the grid (ceil(L / 64) x B
    blocks) fills two waves of one block an SM, else 32."""
    B, H, L = tier
    chmix.check_glu_bf16_widths(H)
    P, smem = chmix.glu_bf16_plan(B, H, L, sms=SMS)
    assert smem <= chmix.SMEM_LIMIT == 227 * 1024
    want = {128: 128, 256: 64}.get(
        H, 64 if B * -(-L // 64) >= 2 * SMS else 32)
    assert P == want


@pytest.mark.parametrize("H", range(16, 1025, 16))
def test_glu_bf16_plan_holds_every_tile(H):
    """At every width 2f takes (multiples of 16 up to 1024) and at a short,
    a middle and a long sequence, the plan's shared memory holds the
    kernel's layout (csrc/chmix.cu::glu_res_tc_kernel): the H-row bf16 y
    tile, then for one pass of value rows (8 warps x 16 x MV rows, MV P =
    128, or H if fewer) the f32 gated product and the bf16 res rows, rows
    padded to P + 8; each region starts 16-byte aligned, ldmatrix's rows
    fall on distinct banks (row stride / 16 bytes odd), and the passes
    cover all H rows."""
    chmix.check_glu_bf16_widths(H)
    for B, L in ((1, 100), (4, 1000), (2, 143360)):
        P, smem = chmix.glu_bf16_plan(B, H, L, sms=SMS)
        assert P in (32, 64, 128)
        rows = 8 * 16 * (128 // P)
        y_tile, staged = H * (P + 8) * 2, min(H, rows) * (P + 8) * 4
        assert smem >= y_tile + staged + min(H, rows) * (P + 8) * 2
        assert smem <= chmix.SMEM_LIMIT
        assert y_tile % 16 == 0 and staged % 16 == 0
        assert (P + 8) * 2 // 16 % 2 == 1
        assert math.ceil(H / rows) * rows >= H


@pytest.mark.parametrize("H,ok", [
    (16, True), (128, True), (256, True), (512, True), (1008, True),
    (1024, True), (0, False), (-16, False), (8, False), (24, False),
    (1040, False), (2048, False)])
def test_glu_bf16_width_check(H, ok):
    """Kernel 2f's width rule: a positive multiple of 16 up to 1024 (every
    tier of d_model 128 and 256); a refusal is a ValueError that names
    the width."""
    if ok:
        chmix.check_glu_bf16_widths(H)
        assert chmix.glu_refusal(H, BF) is None
        return
    with pytest.raises(ValueError, match=f"H = {H}"):
        chmix.check_glu_bf16_widths(H)


# the positions a block each fp32 mixer plan picks at a tier (H, F = 2H;
# B4 L1000 for kernels 2 and 6, whose plans fill a wave): kernel 2 P 64 at
# two blocks an SM to H 256, then 32; kernel 6 the widest P whose tiles
# fit one block and whose 4 ceil(1000 / P) blocks fill a wave; P halves
# from 8192 / H for kernel 7 until the tiles fit
PLANS = {128: (64, 64, 32, 64), 256: (64, 64, 32, 32),
         512: (32, 32, 16, 16), 1024: (32, 16, 8, 8)}


@pytest.mark.parametrize("dtype", [F32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("H", sorted(PLANS))
def test_mixer_kernels_take_every_tier(H, dtype):
    """Every channel-mixer kernel (2, 3, 6, 7 and their f forms) takes the
    widths of every tier of d_model 128 and 256 (H 128-1024, F = 2H): no
    refusal, and each fp32 plan picks a P its kernel is built for
    (csrc/chmix.cu's launchers) whose tiles fit one block (kernel 3's plan
    also its hidden rows a chunk and blocks an SM: P 64 at two at H
    128)."""
    F = 2 * H
    assert [chmix.glu_refusal(H, dtype), chmix.ff_refusal(H, F, dtype),
            chmix.glu_bwd_refusal(H, dtype),
            chmix.ff_bwd_refusal(H, F, dtype)] == [None] * 4
    ff = chmix.ff_tf32_plan(H, F)
    glu = chmix.glu_tf32_plan(4, H, 1000)
    glu_bwd = chmix.glu_bwd_tf32_plan(4, H, 1000)
    plans = ((glu[0], glu[2]), (ff[0], ff[3]), (glu_bwd[0], glu_bwd[2]),
             chmix.ff_bwd_plan(H, F))
    assert tuple(P for P, _ in plans) == PLANS[H]
    assert ff[2] == (2 if H == 128 else 1)
    assert glu[1] == (2 if H <= 256 else 1)
    glu_built = {P for P, _ in chmix.GLU_TF32_SHARED} | set(chmix.GLU_TF32_PS)
    glu_bwd_built = ({P for P, _ in chmix.GLU_BWD_TF32_SHARED}
                     | set(chmix.GLU_BWD_TF32_PS))
    for (P, smem), built in zip(plans, (glu_built, chmix.FF_TF32_PS,
                                        glu_bwd_built, chmix.FF_BWD_PS)):
        assert P in built and smem <= chmix.SMEM_LIMIT


@pytest.mark.parametrize("H,F", [(1024, 2048), (768, 1536), (1024, 1024),
                                 (512, 1024), (256, 512)])
def test_fp32_mixer_plans_hold_every_tile(H, F):
    """The fp32 plans' bytes hold their kernels' layouts (csrc/chmix.cu):
    kernel 6 the y and dz tiles (3H rows); 2 the y tile and 8 warps' 16-row
    staging tiles, 3 the x
    tile and the hidden rows (all F, or FC a chunk and then an H-row tile
    of sums) and 7 the x, g and hidden tiles ((2H + F) rows), rows of
    ``ff_bwd_ld(P)`` floats, and no weight tile (their split weights come
    from L2); the sums and statistics of 3 and 7 on top.  P at least 8, so
    kernel 7's (dm, ds) partials, one pair a block, are B ceil(L / P)
    pairs."""
    P, _, smem = chmix.glu_bwd_tf32_plan(4, H, 1000)
    assert P >= 8
    assert smem >= 4 * 3 * H * chmix.ff_bwd_ld(P)
    assert smem <= chmix.SMEM_LIMIT
    P, _, smem = chmix.glu_tf32_plan(4, H, 1000)
    assert P >= 8
    assert smem >= 4 * (H + 128) * chmix.ff_bwd_ld(P)
    assert smem <= chmix.SMEM_LIMIT
    P, FC, _, smem = chmix.ff_tf32_plan(H, F)
    rows = H + min(F, FC) + (H if FC < F else 0)
    assert P >= 8
    assert smem >= 4 * (rows * chmix.ff_bwd_ld(P) + 2 * 256)
    assert smem <= chmix.SMEM_LIMIT
    P, smem = chmix.ff_bwd_plan(H, F)
    assert P >= 8
    assert smem >= 4 * ((2 * H + F) * chmix.ff_bwd_ld(P) + 2 * 256)
    assert smem <= chmix.SMEM_LIMIT


@pytest.mark.parametrize("d_model,precision,train,device,refused", [
    (128, "f32", True, "cuda", None), (128, "bf16", True, "cuda", None),
    (256, "f32", True, "cuda", None), (256, "bf16", True, "cuda", None),
    (256, "bf16", False, "cuda", None),
    (8, "f32", True, "cuda", None), (8, "bf16", False, "cpu", None),
    (8, "bf16", False, "cuda", "kernel 2f: channel width H = 8"),
    (200, "bf16", False, "cuda", "kernel 2f: channel width H = 200"),
    (512, "bf16", False, "cuda", "kernel 2f: channel width H = 2048"),
    (512, "f32", False, "cuda", None),
    (512, "f32", True, "cuda", "kernel 7: widths H = 2048"),
    (512, "f32", False, "cpu", None)])
def test_card_refuses_widths_no_mixer_kernel_takes(d_model, precision,
                                                   train, device, refused):
    """``check_supported`` refuses by name, on the card only, a SaShiMi
    whose tier widths a channel-mixer kernel does not take (queue 1, item
    8): bf16 widths that are not multiples of 16, tiers past H 1024, f32
    training past kernel 7's tiles (kernel 2 in 3xTF32 samples d_model
    512's H 2048 tier, kernel 6 in 3xTF32 takes its gradient); every tier of d_model 128 and 256 passes, sampling
    and training."""
    cfg = dict(SMALL_CFG, d_model=d_model)
    if refused is None:
        check_supported(cfg, precision, train, device_type=device)
        return
    with pytest.raises(NotImplementedError,
                       match=f"{refused}.*queue 1, item 8"):
        check_supported(cfg, precision, train, device_type=device)


@pytest.mark.parametrize("precision,kernel", [("f32", "3"), ("bf16", "3f")])
def test_card_refuses_ff_tiles_past_a_block(precision, kernel):
    """At d_model 256 with ff 4 (F = 4096 at H 1024) kernel 3f's tiles do
    not fit one block even at its narrowest P: refused on the card, naming
    the widths and the bytes.  Kernel 3 (f32) takes its hidden rows in
    chunks, so at f32 the card takes the model, sampling and training
    (kernel 7 takes those widths too).  The CPU runs the plain version."""
    cfg = dict(SMALL_CFG, d_model=256, ff=4)
    assert chmix.ff_tf32_plan(1024, 4096)[1] < 4096     # chunks at f32
    if precision == "f32":
        for train in (False, True):
            check_supported(cfg, precision, train, device_type="cuda")
    else:
        with pytest.raises(NotImplementedError,
                           match=f"kernel {kernel}: widths H = 1024, F = "
                                 "4096 need .* bytes.*item 8"):
            check_supported(cfg, precision, device_type="cuda")
    check_supported(cfg, precision, True, device_type="cpu")


def test_generate_refuses_unported_widths_before_the_card(monkeypatch,
                                                          tmp_path):
    """generate() on the card refuses a bf16 model whose widths 2f does
    not take before it looks for a card or a checkpoint; on the CPU the
    same config passes the check."""
    from diffwave_sashimi_torch.runtime import generate as gen_mod
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = {"_name_": "sc09", "data_path": str(tmp_path)}
    diffusion = {"T": 200, "beta_0": 0.0001, "beta_T": 0.02}
    with pytest.raises(NotImplementedError, match="H = 8.*item 8"):
        gen_mod.generate(diffusion, SMALL_CFG, data, precision="bf16")
    check_supported(SMALL_CFG, "bf16", device_type="cpu")


@pytest.mark.parametrize("L,dtype,device,refused", [
    (16000, F32, "cuda", False), (16384, F32, "cuda", False),
    (16385, F32, "cuda", False), (143360, F32, "cuda", False),
    (16385, F32, "cpu", False), (143360, F32, "cpu", False),
    (16385, BF, "cpu", False), (16385, BF, "cuda", False),
    (16000, BF, "cuda", False), (524288, BF, "cuda", False),
    (524289, BF, "cuda", True), (524289, F32, "cuda", True),
    (524289, BF, "cpu", False)])
def test_long_training_refusal_by_length_dtype_device(L, dtype, device,
                                                      refused):
    """Training past kernel 1's FFT size 32768 (L > 16384) runs at either
    precision on either device (kernel 9's training entries and kernel 5L
    on the card); on the card only past the long conv's FFT size 2^20 (L >
    524288) is it refused, by size, at either precision; the CPU trains
    every length, as JAX does (``check_train_length``, through
    ``check_supported`` at d_model 128, whose widths the card takes)."""
    cfg = dict(SMALL_CFG, d_model=128, L=L)
    precision = "bf16" if dtype == BF else "f32"
    if not refused:
        check_train_length(L, device)
        check_supported(cfg, precision, train=True, device_type=device)
        return
    with pytest.raises(ValueError, match=r"past the long conv's 1048576"):
        check_train_length(L, device)
    with pytest.raises(ValueError, match=r"past the long conv's 1048576"):
        check_supported(cfg, precision, train=True, device_type=device)


def test_f32_long_training_refused_before_the_card_is_used(monkeypatch,
                                                           tmp_path):
    """The trainer refuses training past the long conv's FFT size 2^20 on
    the card (its config's L) before it loads data or builds a model; the
    same config passes the check for the CPU, and on the card the
    vocoder's lengths (L 32000: n 65536) pass."""
    from diffwave_sashimi_torch.runtime import train as train_mod
    cfg = dict(SMALL_CFG, L=600000)
    check_supported(cfg, "f32", train=True, device_type="cpu")
    check_supported(dict(SMALL_CFG, L=32000), "f32", train=True,
                    device_type="cuda")
    with pytest.raises(ValueError, match="past the long conv"):
        check_supported(cfg, "f32", train=True, device_type="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(train_mod, "dataloader", lambda *a, **k: (
        pytest.fail("the trainer loaded data before refusing")))
    monkeypatch.chdir(tmp_path)
    diffusion = {"T": 200, "beta_0": 0.0001, "beta_T": 0.02}
    with pytest.raises(ValueError, match="past the long conv"):
        train_mod.train(diffusion, cfg, {"_name_": "sc09",
                                         "data_path": str(tmp_path)}, None,
                        compute_cfg={"precision": "f32"}, device="cuda")


def test_f32_long_training_runs_on_the_cpu():
    """At f32 on the CPU the training form runs past kernel 1's FFT sizes
    (the plain conv): finite gradients at L 32000 (n 65536)."""
    model = construct_model(dict(SMALL_CFG, L=32000), "f32",
                            generator=torch.Generator().manual_seed(0))
    torch.nn.init.normal_(model.final_conv[2].conv.weight, std=0.3)
    x = torch.randn(1, 1, 32000, generator=torch.Generator().manual_seed(2))
    loss = model(x, torch.tensor([9]), train=True).square().mean()
    loss.backward()
    assert torch.isfinite(loss) and loss > 0
    assert all(bool(torch.isfinite(p.grad).all())
               for p in model.parameters() if p.grad is not None)


def test_loader_refuses_mel_datasets_naming_vocoder_training(tmp_path):
    """The loader no longer refuses a mel-conditioned dataset: a
    conditional config gets Mel2Samp's (mel, audio) batches (held against
    JAX's in tests/test_torch_vocoder_train.py), an unconditional one
    SC09's, as JAX's dataloader does."""
    from scipy.io import wavfile
    for i in range(2):
        wavfile.write(str(tmp_path / f"LJ00{i}.wav"), 22050,
                      (np.random.RandomState(i).randn(3000) * 3000).astype(
                          np.int16))
    cfg = {"_name_": "ljspeech", "data_path": str(tmp_path),
           "segment_length": 1024, "filter_length": 64, "hop_length": 16,
           "win_length": 64}
    mel, audio = next(iter(dataloader(cfg, 2, unconditional=False)))
    assert mel.shape == (2, 80, 65) and audio.shape == (2, 1, 1024)
    assert len(dataloader(cfg, 2, unconditional=True)) == 0
