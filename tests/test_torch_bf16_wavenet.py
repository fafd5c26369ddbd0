"""Port parity for bf16 WaveNet sampling: kernel 11f's plain version against
the JAX package's gate + res/skip Pallas kernel with fast=True (interpret
mode), the WaveNet (res 16, skip 16, 2 layers) at bf16 against JAX
``WaveNet(dtype=bfloat16)``, unconditional and mel-conditioned, alone and
in a 3-step sampler, and the shipped ``experiment=sc09_wavenet`` command on
the CPU with no precision override.  Inputs from numpy seeds; activations
rounded to bf16 once, for both."""

import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from test_torch_common import perturbed, port_model

import jax
import jax.numpy as jnp

from diffwave_sashimi_tpu.diffusion.schedule import \
    schedule_from_cfg as jax_schedule
from diffwave_sashimi_tpu.models.wavenet import WaveNet as JaxWaveNet
from diffwave_sashimi_tpu.ops.wavenet_gate import gate_res_skip as jax_gate
from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.config import load_config
from diffwave_sashimi_torch.diffusion.sampling import sampling
from diffwave_sashimi_torch.diffusion.schedule import schedule_from_cfg
from diffwave_sashimi_torch.models import construct_model
from diffwave_sashimi_torch.runtime.checkpoint import (load_into,
                                                       save_checkpoint)
from diffwave_sashimi_torch.runtime.generate import main
from diffwave_sashimi_torch.utils.exp import local_directory
from diffwave_sashimi_torch.utils.jax_compat import params_from_jax

BF = torch.bfloat16
CFG = {"_name_": "wavenet", "unconditional": True, "in_channels": 1,
       "out_channels": 1, "diffusion_step_embed_dim_in": 128,
       "diffusion_step_embed_dim_mid": 512,
       "diffusion_step_embed_dim_out": 512, "res_channels": 16,
       "skip_channels": 16, "num_res_layers": 2, "dilation_cycle": 2}
COND_CFG = dict(CFG, unconditional=False, mel_upsample=[4, 4])
HOP = 16                                  # mel_upsample (4, 4)
DIFFUSION = {"T": 3, "beta_0": 0.0001, "beta_T": 0.05, "beta": None}


def _rms(out, ref):
    return float(np.sqrt(((out - ref) ** 2).mean() / (ref ** 2).mean()))


def _gate_data(B, C, S, L, seed=0):
    """tests/test_torch_wavenet.py's inputs, h and x rounded to bf16."""
    rng = np.random.RandomState(seed)
    h, x = rng.randn(B, 2 * C, L), 0.3 * rng.randn(B, C, L)
    return (torch.from_numpy(h.astype(np.float32)).to(BF),
            torch.from_numpy(x.astype(np.float32)).to(BF),
            *(torch.from_numpy(w.astype(np.float32)) for w in (
                0.2 * rng.randn(C, C), 0.1 * rng.randn(C),
                0.2 * rng.randn(S, C), 0.1 * rng.randn(S))))


@pytest.mark.parametrize("B,C,S,L", [(2, 16, 8, 256), (2, 16, 8, 200),
                                     (1, 24, 40, 333)])
def test_gate_bf16_matches_jax_fast_kernel(B, C, S, L):
    """Plain kernel-11f version vs JAX ``gate_res_skip(..., fast=True)``
    (interpret mode), both bf16 out.  The two sum the f32 products of the
    same bf16 operands in other orders, and their f32 gates may round to
    neighbouring bf16 values: within about one bf16 rounding (99.9% of
    the outputs within 2^-7 relative + 1e-5, all within 1e-2 of
    max(1, max|ref|))."""
    data = _gate_data(B, C, S, L)
    jargs = [jnp.asarray(t.float().numpy()) for t in data]
    jargs[:2] = [a.astype(jnp.bfloat16) for a in jargs[:2]]
    refs = jax_gate(*jargs, fast=True)
    assert all(r.dtype == jnp.bfloat16 for r in refs)
    outs = ops.gate_res_skip_ref(*data)
    assert [tuple(o.shape) for o in outs] == [(B, C, L), (B, S, L)]
    for out, ref in zip(outs, refs):
        assert out.dtype == BF
        out = out.float().numpy()
        ref = np.asarray(ref.astype(jnp.float32))
        err = np.abs(out - ref)
        assert (err <= 1e-5 + 2 ** -7 * np.abs(ref)).mean() > 0.999, \
            err.max()
        assert err.max() <= 1e-2 * max(1.0, np.abs(ref).max()), err.max()
    before = ops.gate_res_skip_bf16.launches
    for fn in (ops.gate_res_skip, ops.gate_res_skip_bf16):
        assert all(torch.equal(a, b) for a, b in zip(fn(*data), outs))
    assert ops.gate_res_skip_bf16.launches == before


def _models(cfg, seed, *init_args):
    """(JAX bf16 model, perturbed numpy params, port bf16 model, port f32
    model) for a WaveNet config."""
    jm32 = JaxWaveNet(
        res_channels=cfg["res_channels"], skip_channels=cfg["skip_channels"],
        num_res_layers=cfg["num_res_layers"],
        dilation_cycle=cfg["dilation_cycle"],
        unconditional=cfg["unconditional"],
        mel_upsample=tuple(cfg.get("mel_upsample", (16, 16))))
    params = jax.jit(jm32.init)(jax.random.PRNGKey(seed),
                                jnp.zeros((1, 1, 64), jnp.float32),
                                jnp.zeros((1,), jnp.int32), *init_args)
    p = perturbed(params, seed=seed)
    tm = construct_model(cfg, "bf16",
                         generator=torch.Generator().manual_seed(0))
    load_into(tm, params_from_jax(p, cfg))
    return jm32.clone(dtype=jnp.bfloat16), p, tm.eval(), port_model(p, cfg)


@pytest.fixture(scope="module")
def uncond_bf16():
    return _models(CFG, 0)


@pytest.fixture(scope="module")
def cond_bf16():
    return _models(COND_CFG, 1, jnp.zeros((1, 80, 64 // HOP), jnp.float32))


def _check_eps(out, ref, out32):
    """The bar of tests/test_torch_bf16.py: rms <= 2e-2 and max <= 4e-2 of
    max|ref|; and the port's bf16 eps must differ from its f32 eps."""
    assert np.abs(ref).max() > 1e-2
    assert _rms(out, ref) <= 2e-2, _rms(out, ref)
    assert np.abs(out - ref).max() <= 4e-2 * np.abs(ref).max()
    assert _rms(out, out32) > 1e-3


def test_bf16_unconditional_eps_matches_jax(uncond_bf16):
    """bf16 eps through kernel 11f's plain version against JAX's bf16 XLA
    path, which takes the gate on bf16 tensors and rounds the 1x1 convs'
    outputs before its residual add: the model-level bar covers that."""
    jm, p, tm, tm32 = uncond_bf16
    rng = np.random.RandomState(0)
    audio = rng.randn(3, 1, 512).astype(np.float32)
    t = np.array([0, 57, 199], np.int32)
    ref = np.asarray(jax.jit(jm.apply)(p, jnp.asarray(audio),
                                       jnp.asarray(t)))
    assert ref.dtype == np.float32
    x, s = torch.from_numpy(audio), torch.from_numpy(t)
    with torch.no_grad():
        out = tm(x, s)
        plain = tm(x, s, ops=ops.PLAIN)
        out32 = tm32(x, s).numpy()
    assert out.dtype == torch.float32 and torch.equal(out, plain)
    _check_eps(out.numpy(), ref, out32)


def test_bf16_conditional_eps_matches_jax(cond_bf16):
    """The mel-conditioned WaveNet at bf16 (the mel upsampled and projected
    at bf16), in-block and with hoisted mel terms, which agree exactly."""
    jm, p, tm, tm32 = cond_bf16
    rng = np.random.RandomState(1)
    audio = rng.randn(2, 1, 256).astype(np.float32)
    mel = rng.randn(2, 80, 256 // HOP).astype(np.float32)
    t = np.array([3, 40], np.int32)
    ref = np.asarray(jax.jit(jm.apply)(p, jnp.asarray(audio),
                                       jnp.asarray(t), jnp.asarray(mel)))
    x, s, m = map(torch.from_numpy, (audio, t, mel))
    with torch.no_grad():
        out = tm(x, s, mel=m)
        hoisted = tm(x, s, mel_conds=tm.compute_mel_conds(m, 256))
        out32 = tm32(x, s, mel=m).numpy()
    assert torch.equal(out, hoisted)
    assert all(c.dtype == BF for c in tm.compute_mel_conds(m, 256))
    _check_eps(out.numpy(), ref, out32)


def test_bf16_wavenet_sampler_matches_jax_loop_with_injected_noise(
        uncond_bf16):
    """3 steps at bf16 with one shared noise stack (x_t f32, eps cast to
    f32): x_0 rms <= 2e-2 and max <= 4e-2 of max|ref|, the eps bar."""
    jm, p, tm, _ = uncond_bf16
    apply = jax.jit(jm.apply)
    js = jax_schedule(DIFFUSION)
    a, ab, sg = (np.asarray(r) for r in (js.alpha, js.alpha_bar, js.sigma))
    shape = (2, 1, 512)
    noise = np.random.RandomState(7).randn(js.T + 1, *shape).astype(
        np.float32)
    x = noise[0]
    for i, t in enumerate(range(js.T - 1, -1, -1)):
        eps = np.asarray(apply(p, jnp.asarray(x), jnp.full((2,), t)),
                         np.float32)
        x = (x - (1.0 - a[t]) / np.sqrt(1.0 - ab[t]) * eps) / np.sqrt(a[t])
        if t > 0:
            x = x + sg[t] * noise[i + 1]
    out = sampling(tm, shape, schedule_from_cfg(DIFFUSION),
                   noise=torch.from_numpy(noise)).numpy()
    assert _rms(out, x) <= 2e-2, _rms(out, x)
    assert np.abs(out - x).max() <= 4e-2 * np.abs(x).max()


def test_shipped_wavenet_command_runs_at_bf16_on_the_cpu(tmp_path,
                                                         monkeypatch):
    """``main(["experiment=sc09_wavenet", ...])`` with no precision
    override samples at bf16 (the config's default) at a tiny size and
    differs from the same command at ``compute.precision=f32`` by bf16
    roundings only."""
    monkeypatch.chdir(tmp_path)
    shrink = ["experiment=sc09_wavenet", "model.res_channels=16",
              "model.skip_channels=16", "model.num_res_layers=2",
              "dataset.segment_length=1024", "diffusion.T=3",
              "generate.n_samples=1", "+generate.device=cpu"]
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
    wav = os.path.join("exp", run, "waveforms", "0", "0k_0.wav")
    outs = {}
    for label, extra in (("bf16", []), ("f32", ["compute.precision=f32"])):
        main(shrink + extra)
        sr, outs[label] = wavfile.read(wav)
        assert sr == 16000 and outs[label].shape == (1024,)
        assert np.isfinite(outs[label]).all()
    diff = np.abs(outs["bf16"] - outs["f32"]).max()
    assert 0 < diff <= 5e-2 * np.abs(outs["f32"]).max()
