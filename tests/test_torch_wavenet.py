"""Port parity for the WaveNet backbone at the JAX suite's size (res 24,
skip 16, 4 layers, dilation cycle 2, as tests/test_wavenet_parity.py),
L <= 512: the plain gate + res/skip tail (kernel 11's plain version)
against the JAX kernel in interpret mode and its reference, the dilated
WNConv1d, the exact weight round trip, unconditional and conditional eps,
the sampler's x_0 with JAX's own noise draws, one training step's loss and
gradients, Adam, and the CLIs training, resuming and generating on the CPU.

Tolerances: the tail and the conv to 1e-5 (the JAX kernel test's); eps to
atol 2e-5 / rtol 1e-4 (the JAX package's bar against the reference torch
model); the sampler's x_0 to atol 1e-3 / rtol 1e-2 (as the SaShiMi slice);
the training step as tests/test_torch_train.py holds SaShiMi's."""

import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from test_torch_common import jax_to_numpy, perturbed, port_model

import jax
import jax.numpy as jnp

from diffwave_sashimi_tpu.diffusion.sampling import sampling as jax_sampling
from diffwave_sashimi_tpu.diffusion.schedule import \
    schedule_from_cfg as jax_schedule
from diffwave_sashimi_tpu.models.wavenet import WaveNet as JaxWaveNet
from diffwave_sashimi_tpu.ops.conv import WNConv1d as JaxWNConv1d
from diffwave_sashimi_tpu.ops.wavenet_gate import (
    gate_res_skip as jax_gate, gate_res_skip_ref as jax_gate_ref)
from diffwave_sashimi_tpu.runtime.train import \
    make_optimizer as jax_make_optimizer
from diffwave_sashimi_tpu.utils.torch_compat import wavenet_from_torch
from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.diffusion.loss import training_loss
from diffwave_sashimi_torch.diffusion.sampling import sampling
from diffwave_sashimi_torch.diffusion.schedule import schedule_from_cfg
from diffwave_sashimi_torch.ops.conv import WNConv1d
from diffwave_sashimi_torch.runtime import generate as port_generate
from diffwave_sashimi_torch.runtime import train as port_train
from diffwave_sashimi_torch.utils.exp import local_directory
from diffwave_sashimi_torch.utils.jax_compat import params_from_jax

CFG = {"_name_": "wavenet", "unconditional": True, "in_channels": 1,
       "out_channels": 1, "diffusion_step_embed_dim_in": 128,
       "diffusion_step_embed_dim_mid": 512,
       "diffusion_step_embed_dim_out": 512, "res_channels": 24,
       "skip_channels": 16, "num_res_layers": 4, "dilation_cycle": 2}
COND_CFG = dict(CFG, unconditional=False, mel_upsample=[4, 4])
HOP = 16                                  # mel_upsample (4, 4)
ATOL, RTOL = 2e-5, 1e-4
DIFFUSION = {"T": 200, "beta_0": 0.0001, "beta_T": 0.02, "beta": None}
SHORT = {"T": 3, "beta_0": 0.0001, "beta_T": 0.05, "beta": None}


def _jax_model(cfg):
    return JaxWaveNet(
        res_channels=cfg["res_channels"], skip_channels=cfg["skip_channels"],
        num_res_layers=cfg["num_res_layers"],
        dilation_cycle=cfg["dilation_cycle"],
        unconditional=cfg["unconditional"],
        mel_upsample=tuple(cfg.get("mel_upsample", (16, 16))))


@pytest.fixture(scope="module")
def uncond():
    """(JAX model, numpy params with a perturbed final_conv2, port model)."""
    model = _jax_model(CFG)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 1, 64), jnp.float32),
                                 jnp.zeros((1,), jnp.int32))
    p = perturbed(params)
    return model, p, port_model(p, CFG)


@pytest.fixture(scope="module")
def cond():
    model = _jax_model(COND_CFG)
    params = jax.jit(model.init)(jax.random.PRNGKey(1),
                                 jnp.zeros((1, 1, 64), jnp.float32),
                                 jnp.zeros((1,), jnp.int32),
                                 jnp.zeros((1, 80, 64 // HOP), jnp.float32))
    p = perturbed(params, seed=1)
    return model, p, port_model(p, COND_CFG)


def _gate_data(B, C, S, L, seed=0):
    """The JAX kernel test's inputs (tests/test_wavenet_gate.py)."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 2 * C, L).astype(np.float32),
            (0.3 * rng.randn(B, C, L)).astype(np.float32),
            (0.2 * rng.randn(C, C)).astype(np.float32),
            (0.1 * rng.randn(C)).astype(np.float32),
            (0.2 * rng.randn(S, C)).astype(np.float32),
            (0.1 * rng.randn(S)).astype(np.float32))


@pytest.mark.parametrize("B,C,S,L", [(2, 16, 8, 256), (2, 16, 8, 200),
                                     (1, 24, 40, 333)])
def test_gate_ref_matches_jax_kernel_and_ref(B, C, S, L):
    """At the JAX kernel test's shape, at lengths that are no multiple of
    128, and at S > C; on a CPU tensor the wrapper is the plain version
    and counts no launch."""
    data = _gate_data(B, C, S, L)
    refs = [jax_gate_ref(*map(jnp.asarray, data)),
            jax_gate(*map(jnp.asarray, data), fast=False)]   # interpret
    before = ops.gate_res_skip.launches
    mine = ops.gate_res_skip_ref(*map(torch.from_numpy, data))
    wrapped = ops.gate_res_skip(*map(torch.from_numpy, data))
    assert ops.gate_res_skip.launches == before
    assert mine[0].shape == (B, C, L) and mine[1].shape == (B, S, L)
    for ref in refs:
        for out, r in zip(mine, ref):
            np.testing.assert_allclose(out.numpy(), np.asarray(r),
                                       atol=1e-5, rtol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(mine, wrapped))


def test_gate_bf16_form_runs_by_dtype():
    """bf16 h and x take kernel 11f's function (the JAX kernel's
    fast=True form, held to it in tests/test_torch_bf16_wavenet.py): on CPU
    tensors both wrappers are its plain version, count no launch and
    return bf16 res and skip, within one bf16 rounding of the f32 form's
    on the same rounded inputs."""
    data = list(map(torch.from_numpy, _gate_data(1, 8, 8, 16)))
    h, x = (t.to(torch.bfloat16) for t in data[:2])
    before = ops.gate_res_skip_bf16.launches
    outs = [fn(h, x, *data[2:]) for fn in (
        ops.gate_res_skip, ops.gate_res_skip_bf16, ops.gate_res_skip_ref)]
    assert ops.gate_res_skip_bf16.launches == before
    f32 = ops.gate_res_skip_ref(h.float(), x.float(), *data[2:])
    for i in range(2):
        assert all(o[i].dtype == torch.bfloat16 for o in outs)
        assert torch.equal(outs[0][i], outs[2][i])
        assert torch.equal(outs[1][i], outs[2][i])
        err = (outs[0][i].float() - f32[i]).abs().max()
        assert 0 < err <= 2e-2 * f32[i].abs().max()


@pytest.mark.parametrize("dilation", [1, 2, 8])
def test_dilated_wnconv_matches_jax(dilation):
    """k = 3 with 'same' padding d, random v, g and b, at L 100."""
    rng = np.random.RandomState(dilation)
    p = {"v": rng.randn(6, 5, 3).astype(np.float32),
         "g": (np.abs(rng.randn(6)) + 0.5).astype(np.float32),
         "b": rng.randn(6).astype(np.float32)}
    x = rng.randn(2, 5, 100).astype(np.float32)
    ref = JaxWNConv1d(5, 6, kernel_size=3, dilation=dilation,
                      shift_mm=False).apply({"params": p}, jnp.asarray(x))
    conv = WNConv1d(5, 6, kernel_size=3, dilation=dilation)
    with torch.no_grad():
        conv.conv["weight_v"].copy_(torch.from_numpy(p["v"]))
        conv.conv["weight_g"].copy_(torch.from_numpy(p["g"]).reshape(6, 1, 1))
        conv.conv["bias"].copy_(torch.from_numpy(p["b"]))
        out = conv(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 6, 100)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_wavenet_init_matches_torch_defaults():
    """The effective init of test_wavenet_parity.py: v within
    1/sqrt(fan_in) with fan_in = I * K, g = ||v||, zero-init head; the
    dilations cycle 1, 2, 1, 2."""
    from diffwave_sashimi_torch.models import construct_model
    model = construct_model(CFG, generator=torch.Generator().manual_seed(0))
    blocks = model.residual_layer["residual_blocks"]
    assert [b.dilated_conv_layer.dilation for b in blocks] == [1, 2, 1, 2]
    conv = blocks[0].dilated_conv_layer.conv
    v, g, b = (conv[k].detach() for k in ("weight_v", "weight_g", "bias"))
    assert v.shape == (48, 24, 3)
    bound = 1.0 / np.sqrt(24 * 3)
    assert float(v.abs().max()) <= bound + 1e-6
    assert float(b.abs().max()) <= bound + 1e-6
    torch.testing.assert_close(g.reshape(-1), v.square().sum((1, 2)).sqrt())
    head = model.final_conv[2].conv
    assert not head.weight.any() and not head.bias.any()


@pytest.mark.parametrize("conditional", [False, True])
def test_params_from_jax_round_trips_through_wavenet_from_torch(
        uncond, cond, conditional):
    """params_from_jax is the exact inverse of wavenet_from_torch, with
    the reference names (res_conv/skip_conv without a ``.conv`` level)."""
    _, p, tm = cond if conditional else uncond
    sd = params_from_jax(p, COND_CFG if conditional else CFG)
    assert set(sd) == set(tm.state_dict())
    assert "residual_layer.residual_blocks.3.res_conv.weight_v" in sd
    assert ("residual_layer.residual_blocks.0.mel_conv.conv.weight_v"
            in sd) == conditional
    back = wavenet_from_torch(sd, 4, conditional=conditional)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    flat_p = jax.tree_util.tree_leaves_with_path(p["params"])
    assert [k for k, _ in flat_b] == [k for k, _ in flat_p]
    for (k, x), (_, y) in zip(flat_b, flat_p):
        assert x.dtype == y.dtype and np.array_equal(x, y), k


@pytest.mark.parametrize("steps", [[0, 57, 199], [0.5, 57.25, 198.75]])
def test_unconditional_eps_matches_jax(uncond, steps):
    """Integer steps, and the fractional steps of an aligned schedule; the
    kernel route (its plain version here) equals the plain route."""
    model, p, tm = uncond
    rng = np.random.RandomState(0)
    audio = rng.randn(3, 1, 512).astype(np.float32)
    t = np.array(steps, np.int32 if isinstance(steps[0], int)
                 else np.float32)
    ref = np.asarray(jax.jit(model.apply)(p, jnp.asarray(audio),
                                          jnp.asarray(t)))
    x, s = torch.from_numpy(audio), torch.from_numpy(t)
    with torch.no_grad():
        out = tm(x, s)
        plain = tm(x, s, ops=ops.PLAIN)
    assert np.abs(ref).max() > 1e-2            # not a comparison of zeros
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    assert torch.equal(out, plain)


def test_conditional_eps_matches_jax(cond):
    """JAX WaveNet.apply(x, t, mel) against the port's in-block mel path
    and its hoisted mel terms, which agree exactly."""
    model, p, tm = cond
    rng = np.random.RandomState(1)
    audio = rng.randn(2, 1, 256).astype(np.float32)
    mel = rng.randn(2, 80, 256 // HOP).astype(np.float32)
    t = np.array([3, 40], np.int32)
    ref = np.asarray(jax.jit(model.apply)(p, jnp.asarray(audio),
                                          jnp.asarray(t), jnp.asarray(mel)))
    x, s, m = map(torch.from_numpy, (audio, t, mel))
    with torch.no_grad():
        out = tm(x, s, mel=m)
        hoisted = tm(x, s, mel_conds=tm.compute_mel_conds(m, 256))
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    assert torch.equal(out, hoisted)
    with pytest.raises(ValueError, match="takes a mel"):
        tm(x, s)


def test_sampler_x0_matches_jax_with_its_noise(uncond):
    """JAX sampling() draws x_T and one normal per step from split keys;
    the same draws, made here with jax.random, are the port sampler's
    injected noise stack."""
    model, p, tm = uncond
    shape, rng = (2, 1, 256), jax.random.PRNGKey(5)
    js = jax_schedule(SHORT)
    ref = np.asarray(jax_sampling(jax.jit(model.apply), p, shape, js, rng))
    init_rng, key = jax.random.split(rng)
    noise = [jax.random.normal(init_rng, shape)]
    for _ in range(js.T):
        key, sub = jax.random.split(key)
        noise.append(jax.random.normal(sub, shape))
    noise = torch.from_numpy(np.stack([np.asarray(z) for z in noise]))
    out = sampling(tm, shape, schedule_from_cfg(SHORT), noise=noise).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=1e-2)


def test_train_step_loss_and_grads_match_jax(uncond):
    """Loss to 1e-5 relative, every gradient tensor to 1e-4 of its max
    |JAX grad| (JAX: model.apply(..., train=True), the XLA tail).  Two
    stated exceptions: ``init_conv.0.conv.weight_v``, whose gradient is
    exactly 0 (one input element per output channel: W = g sign(v)), must
    be roundoff on both sides; and the last block's res_conv, whose output
    the network discards (as the reference does), has none on either."""
    model_j, p = uncond[0], uncond[1]
    rng = np.random.RandomState(3)
    audio = (0.5 * rng.randn(2, 1, 512)).astype(np.float32)
    t = np.array([3, 170], np.int32)
    z = rng.randn(2, 1, 512).astype(np.float32)
    abar = np.asarray(jax_schedule(DIFFUSION).alpha_bar)[t].reshape(2, 1, 1)

    def loss_fn(q):
        x_t = jnp.sqrt(abar) * audio + jnp.sqrt(1.0 - abar) * z
        eps = model_j.apply(q, x_t, jnp.asarray(t), None, train=True)
        return jnp.mean((eps - z) ** 2)
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(p)
    model = port_model(p, CFG)
    before = ops.gate_res_skip.launches
    loss = training_loss(model, torch.from_numpy(audio),
                         schedule_from_cfg(DIFFUSION), t=torch.from_numpy(t),
                         z=torch.from_numpy(z))
    loss.backward()
    assert ops.gate_res_skip.launches == before
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    ref = params_from_jax(jax_to_numpy(jgrads), CFG)
    named = dict(model.named_parameters())
    assert set(ref) == set(named)
    g_scale = float(ref["init_conv.0.conv.weight_g"].abs().max())
    unused = "residual_layer.residual_blocks.3.res_conv."
    for name, g in ref.items():
        mine = named[name].grad
        scale = float(g.abs().max())
        if name.startswith(unused):
            assert mine is None and scale == 0.0, name
            continue
        mine = mine.reshape(g.shape)
        if name == "init_conv.0.conv.weight_v":
            assert float(mine.abs().max()) <= 1e-6 * g_scale
            assert scale <= 1e-6 * g_scale
            continue
        assert scale > 0, name
        err = float((mine - g).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)


@pytest.mark.parametrize("s4_lr", [None, 1e-3])
def test_adam_keeps_every_wavenet_parameter_in_the_default_group(uncond,
                                                                 s4_lr):
    """With s4_lr set, a model without S4 keeps every parameter in the
    default group, as the JAX multi_transform labels do: two steps match
    optax to 1e-3 of the largest move."""
    rng = np.random.RandomState(4)
    p, *grads = [jax.tree.map(
        lambda x: rng.randn(*x.shape).astype(np.float32), uncond[1])
        for _ in range(3)]
    opt = jax_make_optimizer(2e-4, s4_lr)
    params = jax.tree.map(jnp.asarray, p)
    state = opt.init(params)
    for g in grads:
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state, params)
        params = jax.tree.map(lambda a, b: a + b, params, upd)
    model = port_model(p, CFG)
    optim = port_train.make_optimizer(model, 2e-4, s4_lr)
    named = dict(model.named_parameters())
    assert len(optim.param_groups[0]["params"]) == len(named)
    if s4_lr is not None:
        assert optim.param_groups[1]["params"] == []
    for g in grads:
        for name, t in params_from_jax(g, CFG).items():
            named[name].grad = t.reshape(named[name].shape)
        optim.step()
    want = params_from_jax(jax_to_numpy(params), CFG)
    start = params_from_jax(p, CFG)
    for name, w in want.items():
        moved = float((w - start[name]).abs().max())
        assert moved > 0, name
        got = named[name].detach().reshape(w.shape)
        assert float((got - w).abs().max()) <= 1e-3 * moved, name


def test_clis_train_resume_and_generate_on_the_cpu(tmp_path, monkeypatch):
    """train.main at a shrunk sc09_wavenet: 3 iterations with checkpoint
    2, a resume from 'max' for one more (checkpoint 3 carries Adam's step
    4, so the optimizer state came along), then generate.main from
    checkpoint 3 in the ``wnet_h16_d2`` run."""
    rng = np.random.RandomState(0)
    for label in ("zero", "one"):
        os.makedirs(tmp_path / "sc09" / label)
        for i in range(2):
            wavfile.write(str(tmp_path / "sc09" / label
                              / f"spk{i}_nohash_{i}.wav"), 16000,
                          (rng.randn(1500) * 3000).astype(np.int16))
    monkeypatch.chdir(tmp_path)
    shrink = ["experiment=sc09_wavenet", "compute.precision=f32",
              "model.res_channels=16", "model.skip_channels=16",
              "model.num_res_layers=2", "dataset.segment_length=1024",
              f"dataset.data_path={tmp_path / 'sc09'}"]
    train_args = shrink + ["train.iters_per_logging=1",
                           "train.batch_size_per_gpu=2",
                           "generate.n_samples=0", "+train.device=cpu"]
    port_train.main(train_args + ["train.n_iters=2",
                                  "train.iters_per_ckpt=2"])
    port_train.main(train_args + ["train.n_iters=3",
                                  "train.iters_per_ckpt=3"])
    cfg_model = dict(CFG, res_channels=16, skip_channels=16,
                     num_res_layers=2)
    run, ckpt = local_directory(None, cfg_model, DIFFUSION,
                                {"segment_length": 1024}, "checkpoint",
                                makedirs=False)
    assert run == "wnet_h16_d2_T200_betaT0.02_uncond"
    assert sorted(os.listdir(ckpt)) == ["2.pkl", "3.pkl"]
    saved = torch.load(os.path.join(ckpt, "3.pkl"), weights_only=True)
    assert {int(s["step"]) for s in
            saved["optimizer_state_dict"]["state"].values()} == {4}
    port_generate.main(shrink + ["generate.n_samples=1",
                                 "+generate.device=cpu"])
    sr, wav = wavfile.read(os.path.join("exp", run, "waveforms", "3",
                                        "0k_0.wav"))
    assert sr == 16000 and wav.shape == (1024,) and np.isfinite(wav).all()
