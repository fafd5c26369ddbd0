"""Port parity for the mel-conditioned SaShiMi vocoder at the JAX suite's
``sashimi_small`` width (d_model 8, n_layers 1, pool [4, 4]) with a short
trained length (L 1024, hop 16, mel_upsample [4, 4]): the mel front end
(STFT, Mel2Samp) to 1e-6, the mel upsampler to 1e-5, the conditional eps
at the trained length and at 4x it (the S4 kernels capped at the trained
length, the per-tier mel cut), the sampler's x_0 with JAX's own noise, the
weight round trip, and generate()'s vocoding routes.  Model tolerance:
atol 1e-3, rtol 1e-2 (as tests/test_torch_sashimi.py)."""

import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from test_torch_common import jax_to_numpy, port_model

import jax
import jax.numpy as jnp

from diffwave_sashimi_tpu.data.mel2samp import Mel2Samp as JaxMel2Samp
from diffwave_sashimi_tpu.data.stft import TacotronSTFT as JaxSTFT
from diffwave_sashimi_tpu.diffusion.sampling import sampling as jax_sampling
from diffwave_sashimi_tpu.diffusion.schedule import \
    schedule_from_cfg as jax_schedule
from diffwave_sashimi_tpu.models.sashimi import Sashimi as JaxSashimi
from diffwave_sashimi_tpu.ops.mel_upsample import MelUpsampler as JaxUp
from diffwave_sashimi_tpu.utils.torch_compat import sashimi_from_torch
from diffwave_sashimi_torch.data import mel2samp
from diffwave_sashimi_torch.data.stft import TacotronSTFT
from diffwave_sashimi_torch.diffusion.sampling import sampling
from diffwave_sashimi_torch.diffusion.schedule import schedule_from_cfg
from diffwave_sashimi_torch.ops.mel_upsample import MelUpsampler
from diffwave_sashimi_torch.runtime.checkpoint import save_checkpoint
from diffwave_sashimi_torch.runtime.generate import generate
from diffwave_sashimi_torch.utils.exp import local_directory
from diffwave_sashimi_torch.utils.jax_compat import params_from_jax

ATOL, RTOL = 1e-3, 1e-2
L_TRAIN, HOP = 1024, 16
COND_CFG = {"_name_": "sashimi", "unconditional": False,
            "mel_upsample": [4, 4], "in_channels": 1, "out_channels": 1,
            "diffusion_step_embed_dim_in": 128,
            "diffusion_step_embed_dim_mid": 512,
            "diffusion_step_embed_dim_out": 512, "unet": True, "d_model": 8,
            "n_layers": 1, "pool": [4, 4], "expand": 2, "ff": 2,
            "L": L_TRAIN}
DIFFUSION = {"T": 3, "beta_0": 0.0001, "beta_T": 0.05, "beta": None}
STFT_CFG = dict(filter_length=64, hop_length=HOP, win_length=64,
                sampling_rate=22050, mel_fmin=0.0, mel_fmax=8000.0)


def _perturb(tree, rng, scale=0.05):
    """Every parameter moved a little (the mel branch and the zero-init
    head included), so no comparison is one of zeros."""
    if hasattr(tree, "items"):
        return {k: _perturb(v, rng, scale) for k, v in tree.items()}
    return (tree + scale * rng.randn(*tree.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def cond():
    """(JAX model, perturbed numpy params, port model carrying them)."""
    model = JaxSashimi(d_model=8, n_layers=1, pool=(4, 4), expand=2, ff=2,
                       L=L_TRAIN, unconditional=False, mel_upsample=(4, 4))
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, L_TRAIN), jnp.float32),
        jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 80, L_TRAIN // HOP), jnp.float32))
    p = _perturb(jax_to_numpy(params), np.random.RandomState(0))
    return model, p, port_model(p, COND_CFG)


def _inputs(L, B=2, seed=0):
    rng = np.random.RandomState(seed)
    return ((0.5 * rng.randn(B, 1, L)).astype(np.float32),
            np.array([3, 41], np.int32)[:B],
            rng.randn(B, 80, L // HOP).astype(np.float32))


def _write_wav(path, n, f0, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 22050.0
    wav = 0.4 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.randn(n)
    wavfile.write(path, 22050, (wav * 32767).astype(np.int16))


def test_mel_front_end_matches_jax(tmp_path):
    """TacotronSTFT.mel_spectrogram, Mel2Samp.get_mel and a training-mode
    item (the same seeded crop) to 1e-6; the file order too."""
    rng = np.random.RandomState(1)
    audio = (0.3 * rng.randn(2, 1000)).astype(np.float32)
    for kw in (STFT_CFG, {}):
        ref = JaxSTFT(**kw).mel_spectrogram(audio)
        out = TacotronSTFT(**kw).mel_spectrogram(audio)
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)
    for i, n in enumerate((700, 1300, 2100)):
        _write_wav(str(tmp_path / f"u{i}.wav"), n, 150 + 40 * i, i)
    kw = dict(STFT_CFG, data_path=str(tmp_path), segment_length=1024)
    mine, ref = mel2samp.Mel2Samp(**kw), JaxMel2Samp(**kw)
    assert mine.files == ref.files
    raw = 3000.0 * audio[0]
    np.testing.assert_allclose(mine.get_mel(raw), ref.get_mel(raw),
                               atol=1e-6, rtol=1e-6)
    for idx in range(3):
        (m1, a1), (m2, a2) = mine[idx], ref[idx]
        np.testing.assert_array_equal(a1, a2)
        np.testing.assert_allclose(m1, m2, atol=1e-6, rtol=1e-6)


def test_mel_upsampler_matches_jax():
    rng = np.random.RandomState(2)
    mel = rng.randn(2, 80, 9).astype(np.float32)
    params = {f"upsample{i}": {
        "v": rng.randn(1, 1, 3, 2 * s).astype(np.float32),
        "g": np.abs(rng.randn(1)).astype(np.float32) + 0.5,
        "b": rng.randn(1).astype(np.float32)} for i, s in enumerate((4, 8))}
    ref = np.asarray(JaxUp((4, 8)).apply({"params": params},
                                         jnp.asarray(mel), 250))
    up = MelUpsampler((4, 8))
    with torch.no_grad():
        for i, stage in enumerate(up):
            q = params[f"upsample{i}"]
            stage.weight_v.copy_(torch.from_numpy(q["v"]))
            stage.weight_g.copy_(torch.from_numpy(q["g"]).reshape(1, 1, 1, 1))
            stage.bias.copy_(torch.from_numpy(q["b"]))
        out = up(torch.from_numpy(mel), 250).numpy()
    assert out.shape == ref.shape == (2, 80, 250)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="audio length"):
        up(torch.from_numpy(mel), 9 * 32 + 1)


@pytest.mark.parametrize("L", [L_TRAIN, 4 * L_TRAIN])
def test_conditional_eps_matches_jax(cond, L):
    """JAX Sashimi.apply(x, t, mel) (the flat path) against the port's
    in-block mel path and its hoisted mel terms, which agree exactly."""
    model, p, tm = cond
    audio, steps, mel = _inputs(L)
    ref = np.asarray(jax.jit(model.apply)(p, jnp.asarray(audio),
                                          jnp.asarray(steps),
                                          jnp.asarray(mel)))
    x, t, m = map(torch.from_numpy, (audio, steps, mel))
    with torch.no_grad():
        out = tm(x, t, mel=m)
        hoisted = tm(x, t, mel_conds=tm.compute_mel_conds(m, L))
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    assert torch.equal(out, hoisted)
    with pytest.raises(ValueError, match="takes a mel"):
        tm(x, t)
    # the training form (each block's term under autograd) computes the
    # same eps
    with torch.no_grad():
        trained = tm(x, t, mel=m, train=True)
    np.testing.assert_allclose(trained.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_sampler_x0_matches_jax_with_its_noise(cond):
    """JAX sampling(..., condition=mel) draws x_T and one normal per step
    from split keys; the same draws, made here with jax.random, are the
    port sampler's injected noise stack."""
    model, p, tm = cond
    _, _, mel = _inputs(L_TRAIN)
    shape, rng = (2, 1, L_TRAIN), jax.random.PRNGKey(5)
    js = jax_schedule(DIFFUSION)
    ref = np.asarray(jax_sampling(jax.jit(model.apply), p, shape, js, rng,
                                  condition=jnp.asarray(mel)))
    init_rng, key = jax.random.split(rng)
    noise = [jax.random.normal(init_rng, shape)]
    for _ in range(js.T):
        key, sub = jax.random.split(key)
        noise.append(jax.random.normal(sub, shape))
    noise = torch.from_numpy(np.stack([np.asarray(z) for z in noise]))
    m = torch.from_numpy(mel)
    out = sampling(tm, shape, schedule_from_cfg(DIFFUSION), noise=noise,
                   mel_conds=tm.compute_mel_conds(m, L_TRAIN)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_params_from_jax_round_trips_conditional(cond):
    _, p, tm = cond
    sd = params_from_jax(p, COND_CFG)
    assert set(sd) == set(tm.state_dict())
    assert "u_layers.1.upsample_conv2d.1.weight_g" in sd
    back = sashimi_from_torch(sd, 1, [4, 4], conditional=True)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    flat_p = jax.tree_util.tree_leaves_with_path(p["params"])
    assert [k for k, _ in flat_b] == [k for k, _ in flat_p]
    for (k, x), (_, y) in zip(flat_b, flat_p):
        assert x.dtype == y.dtype and np.array_equal(x, y), k
    per_block = sashimi_from_torch(sd, 1, [4, 4], conditional=True,
                                   block_scan=False)
    sd2 = params_from_jax({"params": per_block}, COND_CFG)
    assert set(sd2) == set(sd) and all(torch.equal(sd2[k], sd[k])
                                       for k in sd)


def test_generate_vocodes_on_the_cpu(cond, tmp_path, monkeypatch):
    """mel_name computes the mel from {data_path}/<name>.wav; mel_path
    reads it as the port's mel2samp CLI wrote it; the output is frames x
    hop long, finite, depends on the mel, and fidelity.json is written."""
    tm = cond[2]
    data = tmp_path / "wavs"
    data.mkdir()
    _write_wav(str(data / "a.wav"), 1000, 220.0, 0)
    _write_wav(str(data / "b.wav"), 1000, 330.0, 1)
    monkeypatch.chdir(tmp_path)
    dataset = dict(STFT_CFG, _name_="ljspeech", data_path=str(data),
                   segment_length=L_TRAIN, valid=False)
    run, _ = local_directory(None, COND_CFG, DIFFUSION, dataset, "checkpoint")
    assert run.endswith(f"_L{L_TRAIN}_hop{HOP}_cond")
    save_checkpoint(os.path.join("exp", run, "checkpoint"), 1000, tm)
    kw = dict(n_samples=2, seed=4, device="cpu")
    a = generate(DIFFUSION, COND_CFG, dataset, mel_name="a", **kw)
    frames = 1 + 1000 // HOP
    assert a.shape == (2, 1, frames * HOP) and np.isfinite(a).all()
    wav_dir = os.path.join("exp", run, "waveforms", "1000")
    assert sorted(os.listdir(wav_dir)) == ["1k_0.wav", "1k_1.wav",
                                           "fidelity.json"]
    b = generate(DIFFUSION, COND_CFG, dataset, mel_name="b", **kw)
    assert np.abs(a - b).max() > 1e-3
    n = mel2samp.main([
        "experiment=ljspeech", f"dataset.data_path={data}",
        f"dataset.hop_length={HOP}", "dataset.filter_length=64",
        "dataset.win_length=64", f"+output_dir={tmp_path / 'mels'}"])
    assert n == 2 and (tmp_path / "mels" / "a.wav.npy").exists()
    pre = generate(DIFFUSION, COND_CFG, dataset, mel_name="a",
                   mel_path=str(tmp_path / "mels"), **kw)
    np.testing.assert_array_equal(pre, a)
