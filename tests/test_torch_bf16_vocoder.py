"""Port parity for bf16 vocoding: kernel 9f's plain version against the JAX
package's four-step Pallas conv (``fftconv_fused`` with fast=True, run in
interpret mode) composed with the bf16 epilogue of its v1 path
(``models/s4.py:707-712``), the bf16 mel upsampler, the mel-conditioned
SaShiMi at bf16 (d8, n1, mel_upsample [4, 4]) at a generation length whose
top tier passes kernel 1's FFT sizes, against JAX's bf16 flat path and its
kernel-9 ("fact") path, alone and in a 3-step sampler, and the shipped
vocoding command on the CPU with no precision override.  Inputs from numpy
seeds; activations rounded to bf16 once, for both."""

import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from test_torch_common import jax_to_numpy, port_model

import jax
import jax.numpy as jnp

from diffwave_sashimi_tpu.diffusion.schedule import \
    schedule_from_cfg as jax_schedule
from diffwave_sashimi_tpu.models.sashimi import Sashimi as JaxSashimi
from diffwave_sashimi_tpu.ops import fftconv_pallas as fp
from diffwave_sashimi_tpu.ops.mel_upsample import MelUpsampler as JaxUp
from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.config import load_config
from diffwave_sashimi_torch.diffusion.sampling import sampling
from diffwave_sashimi_torch.diffusion.schedule import schedule_from_cfg
from diffwave_sashimi_torch.models import construct_model
from diffwave_sashimi_torch.ops.fftconv_long import half_spectrum
from diffwave_sashimi_torch.ops.mel_upsample import MelUpsampler
from diffwave_sashimi_torch.runtime.checkpoint import (load_into,
                                                       save_checkpoint)
from diffwave_sashimi_torch.runtime.generate import main
from diffwave_sashimi_torch.utils.exp import local_directory
from diffwave_sashimi_torch.utils.jax_compat import params_from_jax

BF = torch.bfloat16
HOP = 16                                 # mel_upsample (4, 4)
# trained length 16000 (the shipped one) and a generation length whose top
# tier convolves at n 65536 (L + the kernel's 16000 taps > 32768): kernel
# 9f's plain version there, kernel 1f's at the two lower tiers
L_TRAIN, L_GEN = 16000, 17408
COND_CFG = {"_name_": "sashimi", "unconditional": False,
            "mel_upsample": [4, 4], "in_channels": 1, "out_channels": 1,
            "diffusion_step_embed_dim_in": 128,
            "diffusion_step_embed_dim_mid": 512,
            "diffusion_step_embed_dim_out": 512, "unet": True, "d_model": 8,
            "n_layers": 1, "pool": [4, 4], "expand": 2, "ff": 2,
            "L": L_TRAIN}
DIFFUSION = {"T": 3, "beta_0": 0.0001, "beta_T": 0.05, "beta": None}


def _bf16(x):
    """numpy f32 -> the same values rounded to bf16, as numpy f32."""
    return torch.from_numpy(x).to(BF).float().numpy()


def _rms(out, ref):
    return float(np.sqrt(((out - ref) ** 2).mean() / (ref ** 2).mean()))


def _port_spectrum(kf, n):
    """The JAX factorized spectrum (2, H, N1, K2) -> the port's (H, N1, N2)
    (tests/test_torch_fftconv_long.py)."""
    N1, K2 = kf.shape[2:]
    half = np.asarray(kf[0]) + 1j * np.asarray(kf[1])
    half = np.swapaxes(half, -1, -2).reshape(kf.shape[1], N1 * K2)
    khat = torch.from_numpy(half[:, :n // 2 + 1].astype(np.complex64))
    return ops.long_spectrum(khat)


@pytest.mark.parametrize("L,n", [(200, 512), (700, 2048)])
def test_conv_bf16_matches_jax_fast_kernel_with_v1_epilogue(L, n):
    """B2 H8: kernel 9f's plain version against JAX: the bf16 conv input
    u' = a u + c + bias (rounded to bf16, as JAX's conv input is a bf16
    tensor), ``fftconv_fused(u', fast=True)`` in interpret mode, + D u' in
    f32, rounded to bf16, the exact GELU.  Bar: one bf16 rounding of the
    output, max error <= 1e-2 of max|ref| (the port takes the GELU in f32
    of the rounded value, JAX on the bf16 tensor)."""
    B, H, L_k = 2, 8, min(L, 300)
    rng = np.random.RandomState(3)
    u = _bf16(rng.randn(B, H, L).astype(np.float32))
    a = (0.5 + rng.rand(B, L)).astype(np.float32)
    c = (0.3 * rng.randn(B, L)).astype(np.float32)
    bias = (0.3 * rng.randn(B, H)).astype(np.float32)
    D = rng.randn(H).astype(np.float32)
    k = np.zeros((H, n), np.float32)
    k[:, :L_k] = 0.05 * rng.randn(H, L_k)
    k[:, n - L_k:] += 0.05 * rng.randn(H, L_k)
    kf = fp.factorize_kernel_freq(jnp.asarray(k), n)

    up = _bf16(u * a[:, None] + c[:, None] + bias[:, :, None])
    y = np.asarray(fp.fftconv_fused(jnp.asarray(up), kf, n, L, True))
    v = jnp.asarray(y + D[:, None] * up).astype(jnp.bfloat16)
    ref = np.asarray(jax.nn.gelu(v, approximate=False).astype(jnp.float32))

    kp = _port_spectrum(kf, n)
    args = [torch.from_numpy(x) for x in (u, a, c, bias)] + [
        kp, torch.from_numpy(D)]
    args[0] = args[0].to(BF)
    out = ops.fftconv_long_ln_bias_gelu_d_bf16_ref(*args)
    assert out.dtype == BF
    out = out.float().numpy()
    err = np.abs(out - ref).max()
    assert err <= 1e-2 * np.abs(ref).max(), err
    # kernel 1f's function (unrounded prologue, gelu_fast) is not 9f's
    other = ops.fftconv_ln_bias_gelu_d_ref(args[0], *args[1:4],
                                           half_spectrum(kp),
                                           args[5]).float().numpy()
    assert np.abs(other - out).max() > 0
    before = ops.fftconv_long_ln_bias_gelu_d_bf16.launches
    for fn in (ops.fftconv_long_ln_bias_gelu_d,
               ops.fftconv_long_ln_bias_gelu_d_bf16, ops.s4_conv):
        assert np.array_equal(fn(*args).float().numpy(), out)
    assert ops.fftconv_long_ln_bias_gelu_d_bf16.launches == before


def test_mel_upsampler_bf16_matches_jax():
    """Two stages (4, 8) at bf16: JAX rounds each conv's output to bf16
    before the f32 bias add and rounds again, the port rounds once, and
    both run leaky_relu on bf16; two stages compound to about two bf16
    roundings: max error <= 2e-2 of max|ref|, and the output must differ
    from the f32 upsampler's."""
    rng = np.random.RandomState(2)
    mel = _bf16(rng.randn(2, 80, 9).astype(np.float32))
    params = {f"upsample{i}": {
        "v": rng.randn(1, 1, 3, 2 * s).astype(np.float32),
        "g": np.abs(rng.randn(1)).astype(np.float32) + 0.5,
        "b": rng.randn(1).astype(np.float32)} for i, s in enumerate((4, 8))}
    ref = JaxUp((4, 8), dtype=jnp.bfloat16).apply({"params": params},
                                                  jnp.asarray(mel), 250)
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    up = MelUpsampler((4, 8))
    with torch.no_grad():
        for i, stage in enumerate(up):
            q = params[f"upsample{i}"]
            stage.weight_v.copy_(torch.from_numpy(q["v"]))
            stage.weight_g.copy_(torch.from_numpy(q["g"]).reshape(1, 1, 1, 1))
            stage.bias.copy_(torch.from_numpy(q["b"]))
        out = up(torch.from_numpy(mel).to(BF), 250)
        f32 = up(torch.from_numpy(mel), 250).numpy()
    assert out.dtype == BF and out.shape == (2, 80, 250)
    out = out.float().numpy()
    assert np.abs(out - ref).max() <= 2e-2 * np.abs(ref).max()
    assert np.abs(out - f32).max() > 0


def _perturb(tree, rng, scale=0.05):
    if hasattr(tree, "items"):
        return {k: _perturb(v, rng, scale) for k, v in tree.items()}
    return (tree + scale * rng.randn(*tree.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def cond_bf16():
    """(JAX bf16 model, perturbed numpy params, port bf16 model, port f32
    model), all carrying the same parameters."""
    jm32 = JaxSashimi(d_model=8, n_layers=1, pool=(4, 4), expand=2, ff=2,
                      L=L_TRAIN, unconditional=False, mel_upsample=(4, 4))
    params = jax.jit(jm32.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, 1024), jnp.float32),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 80, 1024 // HOP),
                                             jnp.float32))
    p = _perturb(jax_to_numpy(params), np.random.RandomState(0))
    jm = jm32.clone(dtype=jnp.bfloat16)
    tm = construct_model(COND_CFG, "bf16",
                         generator=torch.Generator().manual_seed(0))
    load_into(tm, params_from_jax(p, COND_CFG))
    return jm, p, tm.eval(), port_model(p, COND_CFG)


def _inputs(B=2, seed=0):
    rng = np.random.RandomState(seed)
    return ((0.5 * rng.randn(B, 1, L_GEN)).astype(np.float32),
            np.array([2, 1], np.int32)[:B],
            rng.randn(B, 80, L_GEN // HOP).astype(np.float32))


def test_bf16_conditional_eps_matches_jax_flat_and_kernel9_paths(cond_bf16):
    """bf16 eps at L 17408 (top tier n 65536) against JAX bf16 on its flat
    path and on its ``compute_kernels(L, "fact")`` path (Pallas kernel 9
    in interpret mode, the v1 epilogue).  The bar of
    tests/test_torch_bf16.py: rms <= 2e-2 and max <= 4e-2 of max|ref|.  It
    also covers an order of rounding: the port adds the mel term to the
    residual before kernel 2 adds the S4 branch, (x + mel) + GLU(...);
    JAX's flat path adds it to the S4 output, x + (y + mel), and at bf16
    the two round differently.  The eps must differ from the
    port's own f32 eps (bf16 really ran)."""
    jm, p, tm, tm32 = cond_bf16
    audio, steps, mel = _inputs()
    args = (jnp.asarray(audio), jnp.asarray(steps), jnp.asarray(mel))
    ref_flat = np.asarray(jax.jit(jm.apply)(p, *args))
    kernels = jax.jit(lambda q: jm.apply(
        q, L_GEN, "fact", method=JaxSashimi.compute_kernels))(p)
    ref_fact = np.asarray(jax.jit(lambda q, a, s, m, k: jm.apply(
        q, a, s, m, kernels=k))(p, *args, kernels))
    x, t, m = map(torch.from_numpy, (audio, steps, mel))
    with torch.no_grad():
        out = tm(x, t, mel=m)
        hoisted = tm(x, t, mel_conds=tm.compute_mel_conds(m, L_GEN))
        out32 = tm32(x, t, mel=m).numpy()
    assert out.dtype == torch.float32 and torch.equal(out, hoisted)
    # kernel 9's factorized spectra at the top tier, half spectra below
    assert [k.dim() for k in tm.compute_kernels(L_GEN)] == [3, 2, 2, 2, 3]
    out = out.numpy()
    assert np.abs(ref_flat).max() > 1e-2
    for ref in (ref_flat, ref_fact):
        assert _rms(out, ref) <= 2e-2, _rms(out, ref)
        assert np.abs(out - ref).max() <= 4e-2 * np.abs(ref).max()
    assert _rms(out, out32) > 1e-3


def test_bf16_vocoder_sampler_matches_jax_loop_with_injected_noise(
        cond_bf16):
    """3 steps at bf16 with one shared noise stack and the hoisted mel
    terms (x_t f32, eps cast to f32): x_0 rms <= 2e-2 and max <= 4e-2 of
    max|ref|, the eps bar."""
    jm, p, tm, _ = cond_bf16
    _, _, mel = _inputs()
    apply = jax.jit(jm.apply)
    js = jax_schedule(DIFFUSION)
    a, ab, sg = (np.asarray(r) for r in (js.alpha, js.alpha_bar, js.sigma))
    shape = (2, 1, L_GEN)
    noise = np.random.RandomState(7).randn(js.T + 1, *shape).astype(
        np.float32)
    x = noise[0]
    for i, t in enumerate(range(js.T - 1, -1, -1)):
        eps = np.asarray(apply(p, jnp.asarray(x), jnp.full((2,), t),
                               jnp.asarray(mel)), np.float32)
        x = (x - (1.0 - a[t]) / np.sqrt(1.0 - ab[t]) * eps) / np.sqrt(a[t])
        if t > 0:
            x = x + sg[t] * noise[i + 1]
    m = torch.from_numpy(mel)
    out = sampling(tm, shape, schedule_from_cfg(DIFFUSION),
                   noise=torch.from_numpy(noise),
                   mel_conds=tm.compute_mel_conds(m, L_GEN)).numpy()
    assert _rms(out, x) <= 2e-2, _rms(out, x)
    assert np.abs(out - x).max() <= 4e-2 * np.abs(x).max()


def test_shipped_vocoding_command_runs_at_bf16_on_the_cpu(tmp_path,
                                                          monkeypatch):
    """``main(["experiment=ljspeech", ...])`` with no precision override
    vocodes at bf16 (the config's default) at a tiny size, writes the wavs
    and fidelity.json, and differs from the same command at
    ``compute.precision=f32`` by bf16 roundings only."""
    data = tmp_path / "wavs"
    data.mkdir()
    rng = np.random.RandomState(0)
    wav = 0.4 * np.sin(2 * np.pi * 220.0 * np.arange(1000) / 22050.0)
    wavfile.write(str(data / "a.wav"), 22050,
                  ((wav + 0.05 * rng.randn(1000)) * 32767).astype(np.int16))
    monkeypatch.chdir(tmp_path)
    shrink = ["experiment=ljspeech", "model.d_model=8", "model.n_layers=1",
              "dataset.segment_length=1024", f"dataset.hop_length={HOP}",
              "dataset.filter_length=64", "dataset.win_length=64",
              "model.mel_upsample=[4,4]", "diffusion.T=3",
              f"dataset.data_path={data}", "generate.mel_name=a",
              "+generate.device=cpu"]
    cfg = load_config(overrides=shrink)
    assert cfg.get_path("compute.precision") == "bf16"
    model = construct_model(cfg.model,
                            generator=torch.Generator().manual_seed(0))
    head = model.final_conv[2].conv
    with torch.no_grad():               # zero-init head: eps would be 0
        head.weight.normal_(0.0, 0.3, generator=torch.Generator()
                            .manual_seed(1))
    run, ckpt = local_directory(None, cfg.model, cfg.diffusion, cfg.dataset,
                                "checkpoint")
    save_checkpoint(ckpt, 0, model)
    wav_dir = os.path.join("exp", run, "waveforms", "0")
    outs = {}
    for label, extra in (("bf16", []), ("f32", ["compute.precision=f32"])):
        main(shrink + extra)
        assert sorted(os.listdir(wav_dir)) == ["0k_0.wav", "0k_1.wav",
                                               "fidelity.json"]
        sr, outs[label] = wavfile.read(os.path.join(wav_dir, "0k_0.wav"))
        assert sr == 22050 and np.isfinite(outs[label]).all()
    frames = 1 + 1000 // HOP
    assert outs["bf16"].shape == (frames * HOP,)
    diff = np.abs(outs["bf16"] - outs["f32"]).max()
    assert 0 < diff <= 5e-2 * np.abs(outs["f32"]).max()
