"""Port parity for the runtime options the evaluation loop uses, at the
JAX suite's small sizes on the CPU:

- ``compute.remat`` on the WaveNet (res 24, 4 layers, f32): gradients
  bit-equal to the plain ones and within atol 1e-3 / rtol 1e-2 of JAX's
  ``remat=True``; the conditional WaveNet's mel term inside the
  checkpoint, bit-equal;
- ``smooth_checkpoints`` against JAX's on the same port-format files
  (which JAX's ``load_checkpoint`` converts through
  ``params_from_torch_sd``), bit for bit;
- ``generate(params=, write_wavs=False)``, ``generate.ckpt_smooth`` and a
  ``-m`` sweep of the generate CLI."""

import os

import numpy as np
import pytest
import torch

from test_torch_common import SMALL_CFG, jax_to_numpy, perturbed
from test_torch_eval_remat import _batch, _hold_remat, _port_grads

import jax
import jax.numpy as jnp

from diffwave_sashimi_tpu.models.wavenet import WaveNet as JaxWaveNet
from diffwave_sashimi_tpu.runtime.checkpoint import \
    smooth_checkpoints as jax_smooth
from diffwave_sashimi_torch.config import load_config
from diffwave_sashimi_torch.models import construct_model
from diffwave_sashimi_torch.runtime import generate as port_generate
from diffwave_sashimi_torch.runtime.checkpoint import (
    load_into, save_checkpoint, smooth_checkpoints)
from diffwave_sashimi_torch.utils.exp import local_directory
from diffwave_sashimi_torch.utils.jax_compat import params_from_jax

DIFFUSION = {"T": 200, "beta_0": 0.0001, "beta_T": 0.02, "beta": None}
FAST3 = dict(DIFFUSION, fast_steps=3)    # generate() samples in 3 steps
WNET_CFG = {"_name_": "wavenet", "unconditional": True, "in_channels": 1,
            "out_channels": 1, "diffusion_step_embed_dim_in": 128,
            "diffusion_step_embed_dim_mid": 512,
            "diffusion_step_embed_dim_out": 512, "res_channels": 24,
            "skip_channels": 16, "num_res_layers": 4, "dilation_cycle": 2}
WNET_COND_CFG = dict(WNET_CFG, unconditional=False, mel_upsample=[4, 4])


@pytest.fixture(scope="module")
def wavenet_params():
    model = JaxWaveNet(res_channels=24, skip_channels=16, num_res_layers=4,
                       dilation_cycle=2)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 1, 64), jnp.float32),
                                 jnp.zeros((1,), jnp.int32))
    return perturbed(params)


def test_wavenet_remat_gradients(wavenet_params):
    model = JaxWaveNet(res_channels=24, skip_channels=16, num_res_layers=4,
                       dilation_cycle=2, remat=True)
    _hold_remat(WNET_CFG, wavenet_params, *_batch(512), jax_model=model)


def test_conditional_wavenet_remat_gradients():
    """The mel term is computed inside the checkpointed block."""
    model = construct_model(WNET_COND_CFG,
                            generator=torch.Generator().manual_seed(0))
    np_sd = {k: v.numpy() for k, v in model.state_dict().items()}
    plain = construct_model(WNET_COND_CFG)
    remat = construct_model(WNET_COND_CFG, remat=True)
    mel = np.random.RandomState(5).randn(2, 80, 32).astype(np.float32)
    grads = []
    for m in (plain, remat):
        load_into(m, {k: torch.from_numpy(v) for k, v in np_sd.items()})
        grads.append(_port_grads(m, *_batch(512), mel=mel))
    assert torch.equal(grads[0][0], grads[1][0])
    for name, g in grads[0][1].items():
        other = grads[1][1][name]
        assert (g is None and other is None) or torch.equal(g, other), name


def _save_perturbed(ckpt_dir, iters):
    """Port checkpoints of the d8 model at ``iters``, each with its own
    seeded weights; returns their state dicts."""
    out = {}
    for i, it in enumerate(iters):
        model = construct_model(SMALL_CFG,
                                generator=torch.Generator().manual_seed(i))
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator()
                                          .manual_seed(100 + i)))
        save_checkpoint(ckpt_dir, it, model)
        out[it] = model.state_dict()
    return out


@pytest.mark.parametrize("lo, hi", [(0, 30), (10, 30), (0, 20), (20, 30)])
def test_smooth_checkpoints_matches_jax(tmp_path, lo, hi):
    ckpt = str(tmp_path / "checkpoint")
    _save_perturbed(ckpt, (10, 20, 30))
    mine = smooth_checkpoints(ckpt, lo, hi, SMALL_CFG)
    ref = jax_smooth(ckpt, lo, hi, SMALL_CFG)
    assert mine["smoothed_over"] == ref["smoothed_over"] == [
        it for it in (10, 20, 30) if lo < it <= hi]
    assert mine["step"] == ref["step"] == hi
    want = params_from_jax(jax_to_numpy(ref["model_state_dict"]), SMALL_CFG)
    assert set(want) == set(mine["model_state_dict"])
    for k, v in want.items():
        assert torch.equal(mine["model_state_dict"][k].reshape(v.shape), v), k
    with pytest.raises(FileNotFoundError, match=r"\(30, 40\]"):
        smooth_checkpoints(ckpt, 30, 40, SMALL_CFG)


@pytest.fixture
def small_run(tmp_path, monkeypatch):
    """cwd in tmp_path, the d8 model's checkpoints 1 and 2 in its run
    directory; yields (dataset config, run name, {iter: state dict})."""
    monkeypatch.chdir(tmp_path)
    data = {"_name_": "sc09", "data_path": str(tmp_path / "none"),
            "segment_length": 16000, "sampling_rate": 16000}
    run, ckpt = local_directory(None, SMALL_CFG, FAST3, data, "checkpoint")
    return data, run, _save_perturbed(ckpt, (1, 2))


def _wavs(run, it):
    d = os.path.join("exp", run, "waveforms", str(it))
    return sorted(f for f in os.listdir(d) if f.endswith(".wav"))


def test_generate_from_params_writes_no_wav(small_run):
    data, run, sds = small_run
    kw = dict(n_samples=2, seed=4, device="cpu")
    mine = port_generate.generate(FAST3, SMALL_CFG, data, ckpt_iter=1,
                                  params=sds[2], write_wavs=False, **kw)
    assert _wavs(run, 1) == []          # ckpt_iter names the folder only
    ref = port_generate.generate(FAST3, SMALL_CFG, data, ckpt_iter=2, **kw)
    assert mine.shape == (2, 1, 16000) and np.array_equal(mine, ref)
    assert _wavs(run, 2) == ["0k_0.wav", "0k_1.wav"]


def test_generate_ckpt_smooth_samples_the_mean(small_run):
    data, run, sds = small_run
    kw = dict(n_samples=1, seed=2, device="cpu")
    mean = {k: (v * 1 + sds[2][k]) / 2 for k, v in sds[1].items()}
    mine = port_generate.generate(FAST3, SMALL_CFG, data, ckpt_iter="max",
                                  ckpt_smooth=0, **kw)
    ref = port_generate.generate(FAST3, SMALL_CFG, data, ckpt_iter=2,
                                 params=mean, write_wavs=False, **kw)
    assert np.array_equal(mine, ref) and _wavs(run, 2) == ["0k_0.wav"]
    one = port_generate.generate(FAST3, SMALL_CFG, data, ckpt_iter=2,
                                 ckpt_smooth=1, write_wavs=False, **kw)
    assert np.array_equal(one, port_generate.generate(
        FAST3, SMALL_CFG, data, ckpt_iter=2, write_wavs=False, **kw))


def test_generate_main_multirun_sweeps_jobs(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    base = ["experiment=sc09", "model.d_model=8", "model.n_layers=1",
            "diffusion.fast_steps=3", "compute.precision=f32",
            "generate.ckpt_iter=1", "+generate.device=cpu"]
    cfg = load_config(overrides=base)
    run, ckpt = local_directory(None, cfg.model, cfg.diffusion, cfg.dataset,
                                "checkpoint")
    save_checkpoint(ckpt, 1, construct_model(cfg.model))
    port_generate.main(["-m"] + base + ["generate.n_samples=1,2"])
    out = capsys.readouterr().out
    assert "[multirun] job 0/2:" in out and "[multirun] job 1/2:" in out
    assert out.count("generated 1 samples") == 1
    assert out.count("generated 2 samples") == 1
    assert _wavs(run, 1) == ["0k_0.wav", "0k_1.wav"]
