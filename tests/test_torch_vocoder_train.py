"""Port parity for mel-conditioned training and bf16 WaveNet training:
one training step's loss and every parameter gradient of a conditional
SaShiMi (d_model 8, n_layers 1, mel_upsample [4, 4], L 1024) and of a
conditional WaveNet (res 16, skip 16, 4 layers) against
``jax.value_and_grad`` of the JAX models' training forms, at f32 and at
bf16; the unconditional bf16 WaveNet likewise; the port's LJSpeech
(Mel2Samp) batches against the JAX dataloader's on synthetic wavs with the
same seed; and ``train experiment=ljspeech`` through ``main`` on the CPU
at a tiny width (the shipped bf16 precision, with an in-training sample
for ``generate.mel_name``).  Noise, steps and mels are passed in
explicitly, as in tests/test_torch_train.py."""

import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from test_torch_common import jax_to_numpy

import jax
import jax.numpy as jnp

from diffwave_sashimi_tpu.data import dataloader as jax_dataloader
from diffwave_sashimi_tpu.diffusion.schedule import \
    schedule_from_cfg as jax_schedule
from diffwave_sashimi_tpu.models.sashimi import Sashimi as JaxSashimi
from diffwave_sashimi_tpu.models.wavenet import WaveNet as JaxWaveNet
from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.data import dataloader
from diffwave_sashimi_torch.diffusion.loss import training_loss
from diffwave_sashimi_torch.diffusion.schedule import schedule_from_cfg
from diffwave_sashimi_torch.models import construct_model
from diffwave_sashimi_torch.runtime.checkpoint import load_into
from diffwave_sashimi_torch.runtime.train import main
from diffwave_sashimi_torch.utils.exp import local_directory
from diffwave_sashimi_torch.utils.jax_compat import params_from_jax

L, HOP = 1024, 16                       # mel_upsample (4, 4)
DIFFUSION = {"T": 200, "beta_0": 0.0001, "beta_T": 0.02, "beta": None}
EMBED = {"diffusion_step_embed_dim_in": 128,
         "diffusion_step_embed_dim_mid": 512,
         "diffusion_step_embed_dim_out": 512}
SASHIMI_COND = dict(EMBED, _name_="sashimi", unconditional=False,
                    mel_upsample=[4, 4], in_channels=1, out_channels=1,
                    unet=True, d_model=8, n_layers=1, pool=[4, 4], expand=2,
                    ff=2, L=L)
WAVENET = dict(EMBED, _name_="wavenet", unconditional=True, in_channels=1,
               out_channels=1, res_channels=16, skip_channels=16,
               num_res_layers=4, dilation_cycle=2)
WAVENET_COND = dict(WAVENET, unconditional=False, mel_upsample=[4, 4])
CASES = {"sashimi_cond": SASHIMI_COND, "wavenet": WAVENET,
         "wavenet_cond": WAVENET_COND}
STFT = {"filter_length": 64, "hop_length": HOP, "win_length": 64,
        "sampling_rate": 22050, "mel_fmin": 0.0, "mel_fmax": 8000.0}


def _perturb(tree, rng, scale=0.05):
    """Every parameter moved a little (the mel branch and the zero-init
    heads included), so no gradient is one of zeros."""
    if hasattr(tree, "items"):
        return {k: _perturb(v, rng, scale) for k, v in tree.items()}
    return (tree + scale * rng.randn(*tree.shape)).astype(np.float32)


def _jax_model(cfg, dtype):
    if cfg["_name_"] == "wavenet":
        return JaxWaveNet(
            res_channels=cfg["res_channels"],
            skip_channels=cfg["skip_channels"],
            num_res_layers=cfg["num_res_layers"],
            dilation_cycle=cfg["dilation_cycle"],
            unconditional=cfg["unconditional"],
            mel_upsample=tuple(cfg.get("mel_upsample", (16, 16))),
            dtype=dtype)
    return JaxSashimi(d_model=8, n_layers=1, pool=(4, 4), expand=2, ff=2,
                      L=L, unconditional=False, mel_upsample=(4, 4),
                      dtype=dtype)


@pytest.fixture(scope="module")
def params():
    """Perturbed numpy params of each config, from one jitted init each."""
    out = {}
    for key, cfg in CASES.items():
        mel = () if cfg["unconditional"] else (
            jnp.zeros((1, 80, L // HOP), jnp.float32),)
        p = jax.jit(_jax_model(cfg, jnp.float32).init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 1, L), jnp.float32),
            jnp.zeros((1,), jnp.int32), *mel)
        out[key] = _perturb(jax_to_numpy(p), np.random.RandomState(1))
    return out


def _inputs(cfg, seed=3):
    rng = np.random.RandomState(seed)
    audio = (0.5 * rng.randn(2, 1, L)).astype(np.float32)
    t = np.array([7, 160], np.int32)
    z = rng.randn(2, 1, L).astype(np.float32)
    mel = None if cfg["unconditional"] else rng.randn(
        2, 80, L // HOP).astype(np.float32)
    return audio, t, z, mel


def _jax_step(cfg, p, dtype):
    """JAX loss and gradients (port names, f32) of one training step."""
    audio, t, z, mel = _inputs(cfg)
    jm = _jax_model(cfg, dtype)
    abar = np.asarray(jax_schedule(DIFFUSION).alpha_bar)[t].reshape(2, 1, 1)
    jmel = None if mel is None else jnp.asarray(mel)

    def loss_fn(q):
        x_t = jnp.sqrt(abar) * audio + jnp.sqrt(1.0 - abar) * z
        eps = jm.apply(q, x_t, jnp.asarray(t), jmel, train=True)
        return jnp.mean((eps.astype(jnp.float32) - z) ** 2)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(p)
    grads = jax.tree.map(lambda a: np.asarray(a, np.float32), grads)
    return float(loss), params_from_jax(grads, cfg)


@pytest.fixture(scope="module")
def jax_steps(params):
    """The JAX (loss, gradients) of each case at f32 and at bf16."""
    return {(case, dt): _jax_step(CASES[case], params[case], jdt)
            for case in CASES for dt, jdt in (("f32", jnp.float32),
                                               ("bf16", jnp.bfloat16))}


def _port_step(cfg, p, precision, route="FUSED"):
    audio, t, z, mel = _inputs(cfg)
    model = construct_model(cfg, precision,
                            generator=torch.Generator().manual_seed(0))
    load_into(model, params_from_jax(p, cfg))
    loss = training_loss(model, torch.from_numpy(audio),
                         schedule_from_cfg(DIFFUSION), t=torch.from_numpy(t),
                         z=torch.from_numpy(z), ops=getattr(ops, route),
                         mel=None if mel is None else torch.from_numpy(mel))
    loss.backward()
    # a parameter the loss does not reach (the last WaveNet block's
    # res_conv) has no gradient in torch and zeros in JAX
    return loss.item(), {n: torch.zeros_like(q) if q.grad is None
                         else q.grad for n, q in model.named_parameters()}


@pytest.mark.parametrize("route", ["FUSED", "PLAIN"])
@pytest.mark.parametrize("case", ["sashimi_cond", "wavenet_cond"])
def test_f32_conditional_train_step_matches_jax(params, jax_steps, case,
                                                route):
    """f32: the loss to 1e-5 relative, every gradient tensor (the mel
    upsampler's and mel_conv's among them) to 1e-4 of its max |JAX grad|,
    or of 1e-3 of the model's largest where the tensor's gradient cancels
    below that (the WaveNet upsampler's bias: 5.2e-7, a sum over every
    upsampled position); SaShiMi's ``*.log_dt`` to 1e-3 and init_conv's
    weight_v as roundoff, as tests/test_torch_train.py states them; a
    tensor the loss does not reach is zero on both sides."""
    cfg = CASES[case]
    jloss, ref = jax_steps[case, "f32"]
    loss, grads = _port_step(cfg, params[case], "f32", route)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    assert set(ref) == set(grads)
    assert any("mel_conv" in n for n in ref) and any(
        "upsample_conv2d" in n for n in ref)
    top = max(float(g.abs().max()) for g in ref.values())
    g_scale = float(ref["init_conv.0.conv.weight_g"].abs().max())
    for name, g in ref.items():
        mine = grads[name].reshape(g.shape)
        scale = float(g.abs().max())
        if name == "init_conv.0.conv.weight_v":
            assert float(mine.abs().max()) <= 1e-6 * g_scale
            continue
        if scale == 0:
            assert float(mine.abs().max()) == 0, name
            continue
        tol = 1e-3 if name.endswith("kernel.kernel.log_dt") else 1e-4
        assert float((mine - g).abs().max()) <= tol * max(
            scale, 1e-3 * top), name


def _grad_distance(mine, ref):
    """The median over tensors of |a - b|_2 / |b|_2, and the largest
    entry error over max |ref|."""
    per = [float((mine[n].reshape(r.shape) - r).norm() / r.norm())
           for n, r in ref.items() if float(r.norm()) > 0]
    worst = max(float((mine[n].reshape(r.shape) - r).abs().max())
                for n, r in ref.items())
    scale = max(float(r.abs().max()) for r in ref.values())
    return float(np.median(per)), worst / scale


# bf16: the port's and JAX's bf16 roundings land differently after sums in
# other orders (tests/test_torch_bf16_train.py), so the port's bf16 step
# is held against JAX's bf16 step no farther than twice JAX's own bf16
# step is from its f32 step on the same inputs: the median per-tensor
# distance and the largest entry error, and the loss to 4e-4 relative.
# No per-tensor bar: the mel upsampler's scalar weight_g gradients are
# projections of its weight_v gradients that cancel some 40-fold (the
# conditional SaShiMi's u_layers.3.upsample_conv2d.1: 2.3e-6 at f32 from
# entries near 3e-5), so bf16 roundings move them by their own size on
# either side.  The port's bf16 gradients must differ from its own f32
# ones (median > 1e-3): bf16 really ran.  Measured on these inputs (the
# port's median, entry and loss; JAX's own median and entry): conditional
# SaShiMi 2.6e-2, 1.6e-3, 1.2e-5 (3.3e-2, 2.2e-3); WaveNet 7.4e-3,
# 3.3e-3, 5.5e-6 (7.6e-3, 3.2e-3); conditional WaveNet 2.0e-2, 5.4e-3,
# 2.2e-6 (2.7e-2, 6.7e-3).  The WaveNet's training tail is
# ``gate_res_skip_ref``, which computes its gate and residual sum in f32
# and rounds each once.
TOL_BF16_LOSS = 4e-4


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_train_step_matches_jax(params, jax_steps, case):
    """bf16 (SaShiMi's kernels' forms, WaveNet's bf16 convs and its plain
    tail under autograd): loss and gradients of one step against JAX
    ``dtype=bfloat16`` at the bars above; the gradients f32."""
    cfg = CASES[case]
    jloss, ref = jax_steps[case, "bf16"]
    _, ref32 = jax_steps[case, "f32"]
    loss, grads = _port_step(cfg, params[case], "bf16")
    assert all(g.dtype == torch.float32 for g in grads.values())
    ref = {n: r for n, r in ref.items() if n != "init_conv.0.conv.weight_v"}
    assert abs(loss - jloss) <= TOL_BF16_LOSS * abs(jloss)
    median, entry = _grad_distance(grads, ref)
    own_median, own_entry = _grad_distance(ref, {n: ref32[n] for n in ref})
    assert median <= 2 * own_median and entry <= 2 * own_entry, (
        median, own_median, entry, own_entry)
    _, f32 = _port_step(cfg, params[case], "f32")
    assert _grad_distance(grads, {n: f32[n] for n in ref})[0] > 1e-3


# ---- the LJSpeech loader and the training command --------------------------

def _write_lj(root, lengths, seed=0):
    os.makedirs(root)
    rng = np.random.RandomState(seed)
    for i, n in enumerate(lengths):
        t = np.arange(n) / 22050.0
        wav = 0.3 * np.sin(2 * np.pi * (180 + 30 * i) * t) \
            + 0.05 * rng.randn(n)
        wavfile.write(os.path.join(root, f"LJ00{i}.wav"), 22050,
                      (wav * 32767).astype(np.int16))
    return root


@pytest.mark.parametrize("replicas,replica_id", [(1, 0), (2, 1)])
def test_mel2samp_batches_match_jax_dataloader(tmp_path, replicas,
                                               replica_id):
    """Two epochs of (mel, audio) batches of the conditional loader equal
    the JAX dataloader's: the same file order, the same seeded crops
    (one clip shorter than the segment: zero-padded), the mels to 1e-6."""
    data = _write_lj(str(tmp_path / "wavs"), (3000, 900, 2500, 4100, 1500))
    cfg = dict(STFT, _name_="ljspeech", data_path=data, segment_length=L,
               valid=False)
    mine = dataloader(cfg, batch_size=2, num_replicas=replicas,
                      replica_id=replica_id, unconditional=False)
    ref = jax_dataloader(cfg, batch_size=2, num_replicas=replicas,
                         replica_id=replica_id, unconditional=False)
    assert len(mine) == len(ref) > 0
    for _ in range(2):
        got, want = list(mine), list(ref)
        assert len(got) == len(want)
        for (m1, a1), (m2, a2) in zip(got, want):
            assert m1.shape == (2, 80, L // HOP + 1) and a1.shape == (2, 1, L)
            assert a1.dtype == np.float32
            np.testing.assert_array_equal(a1, a2)
            np.testing.assert_allclose(m1, m2, atol=1e-6, rtol=1e-6)


def test_ljspeech_training_command_runs_on_the_cpu(tmp_path, monkeypatch):
    """``main(["experiment=ljspeech", ...])`` at the shipped bf16 with a
    tiny width: 2 iterations, checkpoint 1 under the run's
    ``_L1024_hop16_cond`` name, an in-training sample for
    ``generate.mel_name`` at f32, finite logged losses."""
    data = _write_lj(str(tmp_path / "wavs"), (3000, 2600))
    monkeypatch.chdir(tmp_path)
    overrides = [
        "experiment=ljspeech", "model.d_model=8", "model.n_layers=1",
        f"dataset.segment_length={L}", f"dataset.hop_length={HOP}",
        "dataset.filter_length=64", "dataset.win_length=64",
        "model.mel_upsample=[4,4]", "diffusion.T=3", "train.n_iters=1",
        "train.iters_per_ckpt=1", "train.iters_per_logging=1",
        "train.batch_size_per_gpu=2", "generate.n_samples=1",
        "generate.mel_name=LJ000", f"dataset.data_path={data}",
        "+train.device=cpu"]
    main(overrides)
    from diffwave_sashimi_torch.config import load_config
    cfg = load_config(overrides=overrides)
    run, ckpt = local_directory(None, cfg.model, cfg.diffusion, cfg.dataset,
                                "checkpoint", makedirs=False)
    assert run.endswith("_L1024_hop16_cond")
    assert sorted(os.listdir(ckpt)) == ["1.pkl"]
    saved = torch.load(os.path.join(ckpt, "1.pkl"), weights_only=True)
    assert any("mel_conv" in k for k in saved["model_state_dict"])
    with open(os.path.join("exp", run, "metrics.jsonl")) as f:
        losses = [r["train/loss"] for r in map(json.loads, f)
                  if "train/loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert os.listdir(os.path.join("exp", run, "waveforms", "1"))


def test_conditional_in_training_samples_need_a_mel_name(tmp_path,
                                                        monkeypatch):
    """A conditional model that draws in-training samples needs
    generate.mel_name (JAX asserts it at the first checkpoint): refused
    before the first step; with no samples drawn it trains."""
    data = _write_lj(str(tmp_path / "wavs"), (3000, 2600))
    monkeypatch.chdir(tmp_path)
    base = ["experiment=ljspeech", "model.d_model=8", "model.n_layers=1",
            f"dataset.segment_length={L}", f"dataset.hop_length={HOP}",
            "dataset.filter_length=64", "dataset.win_length=64",
            "model.mel_upsample=[4,4]", "train.n_iters=0",
            "train.batch_size_per_gpu=2", f"dataset.data_path={data}",
            "generate.mel_name=null", "+train.device=cpu"]
    with pytest.raises(ValueError, match="generate.mel_name"):
        main(base + ["generate.n_samples=1"])
    assert not os.path.exists("exp") or not any(
        f.endswith(".pkl") for _, _, fs in os.walk("exp") for f in fs)
    main(base + ["generate.n_samples=0"])
