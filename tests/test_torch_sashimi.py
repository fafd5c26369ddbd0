"""Port parity for the whole SC09 sampling slice at the JAX suite's
``sashimi_small`` size (d_model 8, n_layers 1, pool [4, 4], L 16000):
eps against the JAX flat and compact paths, a 3-step aligned sampler with
injected noise, generate() from a JAX-written checkpoint, the exact weight
round trip, the jax-free import of the port, and the chip smoke test's
config literals.  Model tolerance: atol 1e-3, rtol 1e-2 (the JAX package's
bar against the reference torch model, tests/test_sashimi_parity.py)."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from test_torch_common import SMALL_CFG, perturbed, port_model

import jax
import jax.numpy as jnp

from diffwave_sashimi_tpu.diffusion.schedule import \
    schedule_from_cfg as jax_schedule
from diffwave_sashimi_tpu.models.sashimi import Sashimi as JaxSashimi
from diffwave_sashimi_tpu.runtime.checkpoint import save_checkpoint
from diffwave_sashimi_tpu.utils.torch_compat import sashimi_from_torch
from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.diffusion.sampling import (
    sampling, sampling_step, schedule_table)
from diffwave_sashimi_torch.diffusion.loss import training_loss
from diffwave_sashimi_torch.diffusion.schedule import schedule_from_cfg
from diffwave_sashimi_torch.models import construct_model
from diffwave_sashimi_torch.runtime.checkpoint import (
    load_into, load_state_dict, save_checkpoint as port_save)
from diffwave_sashimi_torch.runtime.generate import generate, main
from diffwave_sashimi_torch.runtime.train import train
from diffwave_sashimi_torch.utils.exp import local_directory
from diffwave_sashimi_torch.utils.jax_compat import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 1e-3, 1e-2
FAST3 = {"T": 200, "beta_0": 0.0001, "beta_T": 0.02, "beta": None,
         "fast_steps": 3}


@pytest.fixture(scope="module")
def small(sashimi_small):
    """(JAX model, perturbed numpy params, jitted flat apply, port model)."""
    model, params = sashimi_small
    p = perturbed(params)
    return model, p, jax.jit(model.apply), port_model(p)


def _inputs(B=2, seed=0):
    rng = np.random.RandomState(seed)
    audio = (0.5 * rng.randn(B, 1, 16000)).astype(np.float32)
    return audio, np.array([7.0, 100.5], np.float32)[:B]


def test_eps_matches_jax_flat_and_compact_paths(small):
    model, p, apply, tm = small
    audio, steps = _inputs()
    ref_flat = np.asarray(apply(p, jnp.asarray(audio), jnp.asarray(steps)))
    kernels = jax.jit(lambda q: model.apply(
        q, 16000, "v2", method=JaxSashimi.compute_kernels))(p)
    ref_v2 = np.asarray(jax.jit(lambda q, a, s, k: model.apply(
        q, a, s, kernels=k))(p, jnp.asarray(audio), jnp.asarray(steps),
                             kernels))
    with torch.no_grad():
        out = tm(torch.from_numpy(audio), torch.from_numpy(steps)).numpy()
    assert np.abs(ref_flat).max() > 1e-2          # not a comparison of zeros
    np.testing.assert_allclose(out, ref_flat, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out, ref_v2, atol=ATOL, rtol=RTOL)


def test_sampler_matches_jax_loop_with_injected_noise(small):
    """3 aligned fast steps (fractional t_embed) with one shared noise
    stack; the JAX side is the update of diffusion/sampling.py:66-68."""
    _, p, apply, tm = small
    js = jax_schedule(FAST3, fast=True)
    a, ab, sg, te = (np.asarray(r) for r in
                     (js.alpha, js.alpha_bar, js.sigma, js.t_embed))
    shape = (2, 1, 16000)
    noise = np.random.RandomState(7).randn(js.T + 1, *shape).astype(
        np.float32)
    x = noise[0]
    for i, t in enumerate(range(js.T - 1, -1, -1)):
        eps = np.asarray(apply(p, jnp.asarray(x),
                               jnp.full((2,), te[t], jnp.float32)))
        x = (x - (1.0 - a[t]) / np.sqrt(1.0 - ab[t]) * eps) / np.sqrt(a[t])
        if t > 0:
            x = x + sg[t] * noise[i + 1]
    out = sampling(tm, shape, schedule_from_cfg(FAST3, fast=True),
                   noise=torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(out, x, atol=ATOL, rtol=RTOL)


def test_sampling_step_rejects_mismatched_schedule_rows(small):
    tm = small[3]
    s = schedule_from_cfg(FAST3, fast=True)
    table = schedule_table(s)
    assert table.shape[0] == 4
    with pytest.raises(ValueError, match="rows"):
        sampling_step(tm, torch.zeros(1, 1, 16000), 2, table[:3], True,
                      torch.zeros(1, 1, 16000))


def test_generate_from_jax_checkpoint(small, tmp_path, monkeypatch):
    """generate() resolves ckpt_iter='max' among JAX-written pickles, loads
    the flax tree through params_from_jax, and writes the reference wav
    layout; its samples equal the sampler's with the same seed."""
    model, p, _, tm = small
    monkeypatch.chdir(tmp_path)
    dataset = {"_name_": "sc09", "segment_length": 16000,
               "sampling_rate": 16000}
    run, _ = local_directory(None, SMALL_CFG, FAST3, dataset, "checkpoint")
    ck = os.path.join("exp", run, "checkpoint")
    zero_head = {"params": dict(p["params"], final_conv2={
        k: np.zeros_like(v) for k, v in p["params"]["final_conv2"].items()})}
    save_checkpoint(ck, 1000, zero_head)         # older: must not be picked
    save_checkpoint(ck, 2000, p)
    out = generate(FAST3, SMALL_CFG, dataset, ckpt_iter="max", n_samples=2,
                   batch_size=1, seed=3, device="cpu")
    assert out.shape == (2, 1, 16000) and np.isfinite(out).all()
    wav_dir = os.path.join("exp", run, "waveforms", "2000")
    assert sorted(os.listdir(wav_dir)) == ["2k_0.wav", "2k_1.wav"]
    sr, wav = wavfile.read(os.path.join(wav_dir, "2k_1.wav"))
    assert sr == 16000 and wav.dtype == np.float32
    np.testing.assert_array_equal(wav, out[1, 0])
    g = torch.Generator().manual_seed(3)
    s = schedule_from_cfg(FAST3, fast=True)
    want = [sampling(tm, (1, 1, 16000), s, generator=g) for _ in range(2)]
    np.testing.assert_array_equal(out, torch.cat(want).numpy())


def test_params_from_jax_round_trips_through_sashimi_from_torch(small):
    p = small[1]
    sd = params_from_jax(p, SMALL_CFG)
    assert set(sd) == set(small[3].state_dict())      # reference names
    back = sashimi_from_torch(sd, 1, [4, 4])
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    flat_p = jax.tree_util.tree_leaves_with_path(p["params"])
    assert [k for k, _ in flat_b] == [k for k, _ in flat_p]
    for (k, x), (_, y) in zip(flat_b, flat_p):
        assert x.dtype == y.dtype and np.array_equal(x, y), k
    per_block = sashimi_from_torch(sd, 1, [4, 4], block_scan=False)
    sd2 = params_from_jax({"params": per_block}, SMALL_CFG)
    assert set(sd2) == set(sd)
    assert all(torch.equal(sd2[k], sd[k]) for k in sd)


def test_port_checkpoint_and_reference_bias_shape(small, tmp_path):
    """The port's own checkpoint round-trips, and a reference state dict
    whose output-linear bias is stored (2H, 1) loads into (2H,)."""
    tm = small[3]
    port_save(str(tmp_path), 5, tm)
    sd = load_state_dict(str(tmp_path), "max", SMALL_CFG)
    assert all(torch.equal(sd[k], v) for k, v in tm.state_dict().items())
    key = "c_layers.0.layer.output_linear.0.bias"
    ref_sd = dict(sd, **{key: sd[key].reshape(-1, 1) + 1.0})
    other = construct_model(SMALL_CFG)
    load_into(other, ref_sd)
    assert torch.equal(other.state_dict()[key], sd[key] + 1.0)


def test_port_imports_no_jax():
    code = ("import importlib, pkgutil, sys, diffwave_sashimi_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'diffwave_sashimi_tpu'))\n"
            "print(len([m for m in sys.modules if m.startswith(p.__name__)]),"
            " bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[0]) >= 20        # every module was imported


def test_chip_smoke_config_literals_match_load_config():
    from diffwave_sashimi_tpu.config import load_config
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = json.loads(json.dumps(load_config(overrides=["experiment=sc09"])))
    assert cfg["diffusion"] == smoke.DIFFUSION_CFG
    assert cfg["model"] == smoke.MODEL_CFG
    assert cfg["dataset"] == smoke.DATASET_CFG
    voc = json.loads(json.dumps(load_config(
        overrides=["experiment=ljspeech"])))
    assert voc["diffusion"] == smoke.VOC_DIFFUSION_CFG
    assert voc["model"] == smoke.VOC_MODEL_CFG
    assert voc["dataset"] == smoke.VOC_DATASET_CFG
    assert voc["generate"]["mel_name"] == smoke.VOC_MEL
    assert voc["generate"]["n_samples"] == smoke.VOC_SAMPLES
    # phase 26 trains experiment=ljspeech_harder at its config and batch
    harder = json.loads(json.dumps(load_config(
        overrides=["experiment=ljspeech_harder"])))
    assert harder["model"] == smoke.HARDER_MODEL_CFG
    assert harder["dataset"] == smoke.HARDER_DATASET_CFG
    assert harder["diffusion"] == smoke.VOC_DIFFUSION_CFG
    assert harder["train"]["batch_size_per_gpu"] == smoke.HARDER_SAMPLES
    assert voc["train"]["batch_size_per_gpu"] == smoke.N_SAMPLES
    # its top tier's 12 blocks at n 2^17 take kernel 9 (the conv and its
    # conjugate form) and 5L, the other 18 kernels 1f and 5f; every block
    # kernels 2f, 3f, 4, 6f, 7f and 8
    assert smoke.HARDER_BF16_STEP == dict(
        smoke.TRAIN_BF16_STEP, fftconv_bf16=2 * 18, fftconv_dkf_bf16=18,
        fftconv_long=2 * 12, fftconv_dkf_long=12)
    assert {k: 4 * v for k, v in smoke.TRAIN_BF16_STEP.items()} == \
        smoke.TRAIN_BF16_LAUNCHES
    wnet = json.loads(json.dumps(load_config(
        overrides=["experiment=sc09_wavenet"])))
    assert wnet["model"] == smoke.WNET_MODEL_CFG
    assert wnet["diffusion"] == smoke.DIFFUSION_CFG
    assert wnet["dataset"] == smoke.DATASET_CFG
    assert smoke.WNET_LAUNCHES["gate_res_skip"] == (
        wnet["model"]["num_res_layers"] * wnet["diffusion"]["T"])
    # phases 13b and 20b run the shipped commands at their precision, bf16
    assert wnet["compute"]["precision"] == voc["compute"]["precision"] == \
        "bf16"
    assert smoke.WNET_BF16_LAUNCHES == {"gate_res_skip_bf16": (
        wnet["model"]["num_res_layers"] * wnet["diffusion"]["T"])}
    T = voc["diffusion"]["T"]
    assert smoke.VOC_BF16_LAUNCHES == {
        "fftconv_long_ln_bias_gelu_d_bf16": 24 * T,
        "fftconv_ln_bias_gelu_d_bf16": 6 * T, "glu_res_bf16": 30 * T,
        "ln_ff_res_bf16": 30 * T, "cauchy": 30}
    # phase 8b runs the shipped precision at the main path's batch
    train = load_config(overrides=smoke.TRAIN_BF16_OVERRIDES)
    assert train["compute"]["precision"] == "bf16"
    assert train["train"]["batch_size_per_gpu"] == smoke.N_SAMPLES
    # the phases through main() train on one card, whatever the machine
    # holds: they read this process's launch counts
    assert train["mesh"]["data"] == 1
    # phase 27 trains the shipped model at bf16 over DP_RANKS ranks, the
    # global batch N_SAMPLES split evenly, for DP_ITERS iterations
    dp = load_config(overrides=smoke.DP_OVERRIDES)
    assert json.loads(json.dumps(dp["model"])) == smoke.MODEL_CFG
    assert dp["compute"]["precision"] == "bf16"
    assert smoke.N_SAMPLES % smoke.DP_RANKS == 0
    assert dp["train"]["n_iters"] + 1 == smoke.DP_ITERS


_WNET_SMALL = {"_name_": "wavenet", "res_channels": 16, "skip_channels": 16,
               "num_res_layers": 2, "dilation_cycle": 2}
_DATA = {"_name_": "sc09", "segment_length": 16000, "sampling_rate": 16000,
         "data_path": "."}


_VOC_SMALL = dict(SMALL_CFG, unconditional=False, mel_upsample=[4, 4])


def _run_bf16(cfg, L, mel_frames=None):
    """eps of a bf16 model built from ``cfg`` at length L (a mel of
    ``mel_frames`` frames for a conditional one), on the CPU."""
    model = construct_model(cfg, "bf16",
                            generator=torch.Generator().manual_seed(0))
    assert model.act_dtype == torch.bfloat16
    mel = None if mel_frames is None else torch.randn(1, 80, mel_frames)
    with torch.no_grad():
        eps = model(0.5 * torch.randn(1, 1, L), torch.tensor([3]), mel=mel)
    return eps


def _bf16_conv_at_kernel9_size():
    """The sampling conv with a factorized (kernel 9) spectrum at bf16:
    kernel 9f's plain version, by dtype."""
    kp = ops.long_spectrum(torch.fft.rfft(0.01 * torch.randn(8, 65536),
                                          n=65536))
    u = torch.randn(1, 8, 40000).to(torch.bfloat16)
    a, c = torch.ones(1, 40000), torch.zeros(1, 40000)
    args = (u, a, c, torch.zeros(1, 8), kp, torch.ones(8))
    before = ops.fftconv_long_ln_bias_gelu_d_bf16.launches
    out = ops.s4_conv(*args)
    assert ops.fftconv_long_ln_bias_gelu_d_bf16.launches == before
    assert torch.equal(out, ops.fftconv_long_ln_bias_gelu_d_bf16_ref(*args))
    assert torch.equal(out, ops.s4_conv_ref(*args))
    return out


# the bf16 paths that kernels 9f and 11f opened: each builds and runs
# at bf16 on the CPU, through the plain versions
_RUNS = {
    "wavenet": lambda: _run_bf16(_WNET_SMALL, 256),
    "vocoder": lambda: _run_bf16(_VOC_SMALL, 256, mel_frames=16),
    "vocoder_lengths": lambda: _run_bf16(dict(SMALL_CFG, L=32000), 20000),
    "kernel9_conv": _bf16_conv_at_kernel9_size,
}


@pytest.mark.parametrize("case", sorted(_RUNS))
def test_bf16_sampling_path_builds_and_runs(case):
    """What the earlier slices refused at bf16 (WaveNet, the vocoder, FFT
    sizes past 32768, kernel 9's bf16 form) now samples: finite output of
    the right shape and dtype (the models' zero-init heads make their eps
    0; tests/test_torch_bf16_vocoder.py and test_torch_bf16_wavenet.py
    hold the numbers against JAX)."""
    out = _RUNS[case]()
    want = (torch.bfloat16, (1, 8, 40000)) if case == "kernel9_conv" else (
        torch.float32, (1, 1, 20000 if case == "vocoder_lengths" else 256))
    assert (out.dtype, tuple(out.shape)) == want
    assert bool(torch.isfinite(out.float()).all())


def _train_bf16(cfg, L, mel_frames=None):
    """One bf16 training step (loss and backward) of a model built from
    ``cfg`` at length L, on the CPU: the loss and the named gradients."""
    model = construct_model(cfg, "bf16",
                            generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():          # a nonzero head, so every path trains
        model.final_conv[2].conv.weight.normal_(0.0, 0.3, generator=g)
    mel = None if mel_frames is None else torch.randn(1, 80, mel_frames,
                                                      generator=g)
    loss = training_loss(model, 0.5 * torch.randn(1, 1, L, generator=g),
                         schedule_from_cfg(FAST3), g, mel=mel)
    loss.backward()
    return loss, {n: p.grad for n, p in model.named_parameters()}


# what earlier slices refused at bf16 and this one trains: bf16 WaveNet
# training, bf16 vocoder (mel-conditioned) training, and bf16 training past
# FFT size 32768 (a model whose S4 length is past it, and a length past
# the model's), each one bf16 step on the CPU through the plain versions
_TRAINS = {
    "train": lambda: _train_bf16(_WNET_SMALL, 256),
    "train_vocoder": lambda: _train_bf16(_VOC_SMALL, 256, mel_frames=16),
    "train_vocoder_lengths": lambda: _train_bf16(dict(SMALL_CFG, L=32000),
                                                 32000),
    "train_lengths": lambda: _train_bf16(SMALL_CFG, 32000),
}


@pytest.mark.parametrize("case", sorted(_TRAINS))
def test_bf16_training_runs_where_it_was_refused(case):
    """A finite loss and a finite f32 gradient of every parameter the loss
    reaches (the mel branch's too); tests/test_torch_vocoder_train.py and
    test_torch_long_train.py hold the numbers against JAX."""
    loss, grads = _TRAINS[case]()
    assert bool(torch.isfinite(loss))
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
               for g in grads.values() if g is not None)
    if case == "train_vocoder":
        assert float(grads["d_layers.0.mel_conv.conv.weight_v"].abs()
                     .max()) > 0


# what the port still refuses: each raised by name, none run at f32
_REFUSED = {
    "kernel_fft_fast": (lambda: main(["experiment=sc09",
                                      "+model.kernel_fft_fast=true"]),
                        "kernel_fft_fast.*queue 1, item 1"),
    "profile_dir": (lambda: main(["experiment=sc09",
                                  "compute.profile_dir=trace"]),
                    "profile_dir.*queue 1, item 6"),
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_bf16_is_refused_not_run_as_f32(case, tmp_path, monkeypatch):
    """bf16 SaShiMi builds (the shipped default, for sampling and
    training); the config keys the port cannot honour yet raise
    NotImplementedError naming their ROADMAP entry."""
    assert construct_model(SMALL_CFG, "bf16").act_dtype == torch.bfloat16
    monkeypatch.chdir(tmp_path)
    fn, match = _REFUSED[case]
    with pytest.raises(NotImplementedError, match=match):
        fn()


def test_plain_and_fused_ops_agree_on_cpu(small):
    """On CPU tensors every kernel wrapper is its plain version."""
    tm = small[3]
    audio, steps = _inputs(B=1)
    with torch.no_grad():
        a = tm(torch.from_numpy(audio), torch.from_numpy(steps),
               ops=ops.FUSED)
        b = tm(torch.from_numpy(audio), torch.from_numpy(steps),
               ops=ops.PLAIN)
    assert torch.equal(a, b)
