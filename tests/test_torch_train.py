"""Port parity for the SC09 training slice at the JAX suite's
``sashimi_small`` size (d_model 8, n_layers 1, pool [4, 4], L 16000): one
training step's loss and every parameter gradient against JAX, Adam
against optax, the SC09 loader and the config loader against the JAX
package's, and the trainer's runtime (checkpoints, resume, in-training
generation, the card requirement, the jax-free entry points)."""

import inspect
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

from diffwave_sashimi_tpu.config import (
    extract_multirun_flag as jax_extract, load_config as jax_load_config,
    sweep_overrides as jax_sweep)
from diffwave_sashimi_tpu.data import dataloader as jax_dataloader
from diffwave_sashimi_tpu.diffusion.schedule import \
    schedule_from_cfg as jax_schedule
from diffwave_sashimi_tpu.runtime.train import \
    make_optimizer as jax_make_optimizer
from diffwave_sashimi_torch import ops
from diffwave_sashimi_torch.config import (extract_multirun_flag,
                                           load_config, sweep_overrides)
from diffwave_sashimi_torch.data import dataloader
from diffwave_sashimi_torch.diffusion.loss import training_loss
from diffwave_sashimi_torch.diffusion.schedule import schedule_from_cfg
from diffwave_sashimi_torch.models import construct_model
from diffwave_sashimi_torch.runtime import generate as port_generate
from diffwave_sashimi_torch.runtime import train as port_train
from diffwave_sashimi_torch.runtime.checkpoint import load_into
from diffwave_sashimi_torch.runtime.train import (is_ssm_param,
                                                  make_optimizer, train)
from diffwave_sashimi_torch.utils.exp import local_directory
from diffwave_sashimi_torch.utils.jax_compat import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIFFUSION = {"T": 200, "beta_0": 0.0001, "beta_T": 0.02, "beta": None,
             "fast_steps": 3}      # training uses T; generate() the 3 steps
F32 = {"precision": "f32"}


def _np_tree(tree):
    if hasattr(tree, "items"):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _tree_map(fn, *trees):
    if hasattr(trees[0], "items"):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


@pytest.fixture(scope="module")
def small(sashimi_small):
    model, params = sashimi_small
    return model, perturbed(params, seed=1)


@pytest.fixture(scope="module")
def jax_step(small):
    """The JAX loss and gradients of one step: eps-MSE on
    model.apply(p, x_t, t, None, train=True) (the flat XLA path on the
    CPU), with injected t and z."""
    model, p = small
    rng = np.random.RandomState(3)
    audio = (0.5 * rng.randn(2, 1, 16000)).astype(np.float32)
    t = np.array([3, 170], np.int32)
    z = rng.randn(2, 1, 16000).astype(np.float32)
    abar = np.asarray(jax_schedule(DIFFUSION).alpha_bar)[t].reshape(2, 1, 1)

    def loss_fn(q):
        x_t = jnp.sqrt(abar) * audio + jnp.sqrt(1.0 - abar) * z
        eps = model.apply(q, x_t, jnp.asarray(t), None, train=True)
        return jnp.mean((eps - z) ** 2)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(p)
    return (audio, t, z), float(loss), _np_tree(grads)


def test_params_from_jax_is_linear(small):
    """Gradients map to port names through params_from_jax only because it
    is made of renames, reshapes and transposes: a linear map."""
    p = small[1]
    rng = np.random.RandomState(2)
    q = _tree_map(lambda x: rng.randn(*x.shape).astype(np.float32), p)
    both = params_from_jax(_tree_map(lambda a, b: 2.0 * a - 3.0 * b, p, q),
                           SMALL_CFG)
    mp, mq = params_from_jax(p, SMALL_CFG), params_from_jax(q, SMALL_CFG)
    for k, v in both.items():
        torch.testing.assert_close(v, 2.0 * mp[k] - 3.0 * mq[k], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("route", ["FUSED", "PLAIN"])
def test_train_step_loss_and_grads_match_jax(small, jax_step, route):
    """Loss to 1e-5 relative; every gradient tensor to 1e-4 of its max
    |JAX grad|.  FUSED trains through the Functions (their plain backward
    formulas on the CPU), PLAIN through torch autograd.  Two stated
    exceptions:

    - ``*.kernel.kernel.log_dt`` to 1e-3: its gradient sums dt-derivatives
      of the Cauchy terms over every FFT node (8001 at L = 16000, up to
      the Nyquist node, |z| ~ 3e4) in complex64 with cancellation, and
      XLA's and torch's complex64 arithmetic and FFTs round differently
      there (2e-4 measured at the top tier, both routes alike);
    - ``init_conv.0.conv.weight_v`` through its own chain rule: the init
      conv has one input element per output channel, so its weight norm is
      W = g sign(v) and dL/dv is exactly 0; both sides must be roundoff,
      below 1e-6 of that layer's max |dL/dg|."""
    (audio, t, z), jloss, jgrads = jax_step
    model = port_model(small[1])
    loss = training_loss(model, torch.from_numpy(audio),
                         schedule_from_cfg(DIFFUSION), t=torch.from_numpy(t),
                         z=torch.from_numpy(z), ops=getattr(ops, route))
    loss.backward()
    assert abs(loss.item() - jloss) <= 1e-5 * abs(jloss)
    ref = params_from_jax(jgrads, SMALL_CFG)
    named = dict(model.named_parameters())
    assert set(ref) == set(named)
    zero_v = "init_conv.0.conv.weight_v"
    g_scale = float(ref["init_conv.0.conv.weight_g"].abs().max())
    for name, g in ref.items():
        mine = named[name].grad.reshape(g.shape)
        if name == zero_v:
            assert float(mine.abs().max()) <= 1e-6 * g_scale
            assert float(g.abs().max()) <= 1e-6 * g_scale
            continue
        tol = 1e-3 if name.endswith("kernel.kernel.log_dt") else 1e-4
        scale = float(g.abs().max())
        assert scale > 0, name                    # every tensor is trained
        err = float((mine - g).abs().max())
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("s4_lr", [None, 1e-3])
def test_adam_matches_optax(small, s4_lr):
    """Two make_optimizer steps vs the JAX package's optax optimizer on the
    same parameters and gradients, including the s4_lr split: each update
    to 1e-3 of the largest move.  The parameters are small random values
    in the model's tree, so float32 resolves the moves."""
    rng = np.random.RandomState(4)
    p, *grads = [_tree_map(lambda x: rng.randn(*x.shape).astype(np.float32),
                           small[1]) for _ in range(3)]
    opt = jax_make_optimizer(2e-4, s4_lr)

    @jax.jit
    def step(params, state, g):
        upd, state = opt.update(g, state, params)
        return jax.tree.map(lambda a, b: a + b, params, upd), state
    params = jax.tree.map(jnp.asarray, p)
    state = opt.init(params)
    for g in grads:
        params, state = step(params, state, jax.tree.map(jnp.asarray, g))
    model = port_model(p)
    optim = make_optimizer(model, 2e-4, s4_lr)
    named = dict(model.named_parameters())
    assert len(optim.param_groups) == (1 if s4_lr is None else 2)
    if s4_lr is not None:
        assert {n for n in named if is_ssm_param(n)} == {
            n for n in named if n.rsplit(".", 1)[-1] in
            ("log_dt", "B", "P", "inv_w_real", "w_imag")}
    for g in grads:
        for name, t in params_from_jax(g, SMALL_CFG).items():
            named[name].grad = t.reshape(named[name].shape)
        optim.step()
    want = params_from_jax(_np_tree(params), SMALL_CFG)
    start = params_from_jax(p, SMALL_CFG)
    for name, w in want.items():
        got = named[name].detach().reshape(w.shape)
        moved = float((w - start[name]).abs().max())
        assert moved > 0, name
        assert float((got - w).abs().max()) <= 1e-3 * moved, name


def _write_corpus(root, n_per_label=3, seed=0):
    """SpeechCommands-style corpus: ``<digit>/spk<i>_nohash_<i>.wav`` int16
    clips of 12000-20000 samples, plus files the loader must skip."""
    rng = np.random.RandomState(seed)
    for label in ("zero", "one"):
        d = os.path.join(root, label)
        os.makedirs(d)
        for i in range(n_per_label):
            L = [12000, 16000, 20000][i % 3]
            wavfile.write(os.path.join(d, f"spk{i}_nohash_{i}.wav"), 16000,
                          (rng.randn(L) * 3000).astype(np.int16))
        wavfile.write(os.path.join(d, "ignored.wav"), 16000,
                      np.zeros(100, np.int16))
    bg = os.path.join(root, "_background_noise_")
    os.makedirs(bg)
    wavfile.write(os.path.join(bg, "noise_nohash_0.wav"), 16000,
                  np.zeros(100, np.int16))
    return {"_name_": "sc09", "data_path": root, "segment_length": 16000,
            "sampling_rate": 16000}


@pytest.mark.parametrize("replicas,replica_id", [(1, 0), (2, 1)])
def test_sc09_loader_matches_jax(tmp_path, replicas, replica_id):
    """Two epochs of batches, with the epoch-seeded shuffle and the replica
    sharding, equal the JAX dataloader's."""
    cfg = _write_corpus(str(tmp_path))
    mine = dataloader(cfg, batch_size=2, num_replicas=replicas,
                      replica_id=replica_id)
    ref = jax_dataloader(cfg, batch_size=2, num_replicas=replicas,
                         replica_id=replica_id)
    assert len(mine) == len(ref) == 3 // replicas
    for _ in range(2):
        got, want = list(mine), list(ref)
        assert len(got) == len(want)
        for (w1, s1, l1), (w2, s2, l2) in zip(got, want):
            assert w1.shape == (2, 1, 16000) and w1.dtype == np.float32
            np.testing.assert_array_equal(w1, w2)
            assert list(s1) == list(s2) and list(l1) == list(l2)


@pytest.mark.parametrize("overrides", [
    ["experiment=sc09"], ["experiment=sc09_wavenet"],
    ["experiment=ljspeech"], ["experiment=ljspeech_harder"],
    ["experiment=sc09", "model.d_model=64", "train.n_iters=100",
     "+diffusion.fast_steps=6", "compute.precision=f32"],
    ["-m", "model.d_model=32,64", "model.pool=[2,2],[4,4]",
     "train.n_iters=1"]])
def test_load_config_matches_jax(overrides):
    args, multi = extract_multirun_flag(overrides)
    assert (args, multi) == jax_extract(overrides)
    jobs = sweep_overrides(args) if multi else [args]
    assert jobs == (jax_sweep(args) if multi else [args])
    for job in jobs:
        assert json.dumps(load_config(overrides=job)) == json.dumps(
            jax_load_config(overrides=job))


def test_train_checkpoints_resumes_and_generates(tmp_path, monkeypatch):
    """train(device="cpu") at d8: 3 iterations write checkpoint 2 (with the
    in-training sample), resume from 'max' and from an int carries the
    optimizer state on, -1 starts from scratch, and generate() samples
    from the checkpoint."""
    data = _write_corpus(str(tmp_path / "sc09"), n_per_label=1)
    monkeypatch.chdir(tmp_path)
    gen_cfg = {"ckpt_iter": "max", "n_samples": 1, "batch_size": None,
               "ckpt_smooth": None, "mel_path": None, "mel_name": None}
    kw = dict(iters_per_ckpt=2, iters_per_logging=1, batch_size_per_gpu=2,
              compute_cfg=F32, device="cpu")
    out = train(DIFFUSION, SMALL_CFG, data, gen_cfg, n_iters=2, **kw)
    run, ckpt = local_directory(None, SMALL_CFG, DIFFUSION, data,
                                "checkpoint", makedirs=False)
    assert out["step"] == 2 and out["checkpoint_dir"] == ckpt
    assert sorted(os.listdir(ckpt)) == ["2.pkl"]
    assert [i for i, _ in out["losses"]] == [0, 1, 2]
    assert all(np.isfinite(v) for _, v in out["losses"])
    assert os.listdir(os.path.join("exp", run, "waveforms", "2")) == [
        "0k_0.wav"]
    with open(os.path.join("exp", run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert {"train/loss", "train/log_loss", "train/steps_per_sec"} <= set(
        recs[0]) and "train/loss_epoch" in recs[1]

    def adam_steps(result):
        return {int(s["step"]) for s in result["optimizer"].state.values()}
    for ckpt_iter in ("max", 2):
        res = train(DIFFUSION, SMALL_CFG, data, None, ckpt_iter=ckpt_iter,
                    n_iters=3, **kw)
        assert res["step"] == 3 and [i for i, _ in res["losses"]] == [3]
        assert adam_steps(res) == {4}
    fresh = train(DIFFUSION, SMALL_CFG, data, None, ckpt_iter=-1, n_iters=0,
                  **kw)
    assert [i for i, _ in fresh["losses"]] == [0] and adam_steps(fresh) == {1}

    audio = port_generate.generate(DIFFUSION, SMALL_CFG, data, ckpt_iter=2,
                                   n_samples=1, device="cpu")
    assert audio.shape == (1, 1, 16000) and np.isfinite(audio).all()


def test_bf16_train_checkpoints_f32_and_resumes(tmp_path, monkeypatch):
    """train(device="cpu") at bf16 (the shipped precision), d8: 3
    iterations write checkpoint 2, whose tensors are f32 and load into an
    f32 port model; a resume from 'max' runs one more step on the carried
    Adam state (4 steps) of the f32 parameters; the losses are finite."""
    data = _write_corpus(str(tmp_path / "sc09"), n_per_label=1)
    monkeypatch.chdir(tmp_path)
    kw = dict(iters_per_ckpt=2, iters_per_logging=1, batch_size_per_gpu=2,
              device="cpu")
    out = train(DIFFUSION, SMALL_CFG, data, None, n_iters=2,
                compute_cfg={"precision": "bf16"}, **kw)
    assert out["model"].act_dtype == torch.bfloat16
    assert [i for i, _ in out["losses"]] == [0, 1, 2]
    assert all(np.isfinite(v) for _, v in out["losses"])
    _, ckpt = local_directory(None, SMALL_CFG, DIFFUSION, data, "checkpoint",
                              makedirs=False)
    assert sorted(os.listdir(ckpt)) == ["2.pkl"]
    saved = torch.load(os.path.join(ckpt, "2.pkl"), weights_only=True)
    assert {t.dtype for t in saved["model_state_dict"].values()} == {
        torch.float32}
    f32_model = construct_model(SMALL_CFG, "f32")
    load_into(f32_model, saved["model_state_dict"])
    torch.testing.assert_close(f32_model.state_dict(),
                               saved["model_state_dict"], rtol=0, atol=0)
    res = train(DIFFUSION, SMALL_CFG, data, None, ckpt_iter="max",
                n_iters=3, compute_cfg={"precision": "bf16"}, **kw)
    assert res["step"] == 3 and [i for i, _ in res["losses"]] == [3]
    assert {int(s["step"]) for s in res["optimizer"].state.values()} == {4}
    assert all(p.dtype == torch.float32 for p in res["model"].parameters())
    assert np.isfinite(res["losses"][0][1])


def test_bf16_train_samples_at_f32(tmp_path, monkeypatch):
    """The in-training samples are drawn at generate()'s default, f32,
    whatever the training precision, as the JAX trainer's generate() call
    (without a precision) does."""
    data = _write_corpus(str(tmp_path / "sc09"), n_per_label=1)
    monkeypatch.chdir(tmp_path)
    calls = []
    monkeypatch.setattr(port_train, "generate",
                        lambda *a, **k: calls.append(k))
    gen_cfg = {"ckpt_iter": "max", "n_samples": 1, "batch_size": None,
               "ckpt_smooth": None, "mel_path": None, "mel_name": None}
    train(DIFFUSION, SMALL_CFG, data, gen_cfg, n_iters=1, iters_per_ckpt=1,
          iters_per_logging=1, batch_size_per_gpu=2, device="cpu",
          compute_cfg={"precision": "bf16"})
    assert len(calls) == 1 and calls[0]["ckpt_iter"] == 1
    assert "precision" not in calls[0]
    assert inspect.signature(port_generate.generate).parameters[
        "precision"].default == "f32"


def test_train_refuses_ckpt_smooth_before_the_first_step(tmp_path,
                                                        monkeypatch):
    """generate.ckpt_smooth with in-training samples is refused by name,
    citing its ROADMAP item, before any training step runs; with no
    samples drawn it is never read, and training runs."""
    data = _write_corpus(str(tmp_path / "sc09"), n_per_label=1)
    monkeypatch.chdir(tmp_path)
    steps = []
    real_step = port_train.train_step
    monkeypatch.setattr(port_train, "train_step",
                        lambda *a, **k: steps.append(1) or real_step(*a, **k))
    gen_cfg = {"ckpt_iter": "max", "n_samples": 1, "batch_size": None,
               "ckpt_smooth": 1, "mel_path": None, "mel_name": None}
    kw = dict(n_iters=1, iters_per_ckpt=1, iters_per_logging=1,
              batch_size_per_gpu=2, device="cpu", compute_cfg=F32)
    with pytest.raises(NotImplementedError,
                       match=r"generate\.ckpt_smooth.*queue 1, item 6"):
        train(DIFFUSION, SMALL_CFG, data, gen_cfg, **kw)
    assert steps == [] and not os.path.exists(local_directory(
        None, SMALL_CFG, DIFFUSION, data, "checkpoint", makedirs=False)[1])
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        port_generate.generate(DIFFUSION, SMALL_CFG, data, ckpt_smooth=1,
                               device="cpu")
    out = train(DIFFUSION, SMALL_CFG, data, dict(gen_cfg, n_samples=0), **kw)
    assert out["step"] == 1 and len(steps) == 2


def test_failing_in_training_generation_does_not_stop_training(
        tmp_path, monkeypatch, capsys):
    """An in-training generate() that raises is printed, as the JAX
    trainer prints it, and training carries on to its last iteration and
    checkpoint."""
    data = _write_corpus(str(tmp_path / "sc09"), n_per_label=1)
    monkeypatch.chdir(tmp_path)
    calls = []

    def failing(*a, **k):
        calls.append(k["ckpt_iter"])
        raise RuntimeError("sampler broke")
    monkeypatch.setattr(port_train, "generate", failing)
    gen_cfg = {"ckpt_iter": "max", "n_samples": 1, "batch_size": None,
               "ckpt_smooth": None, "mel_path": None, "mel_name": None}
    out = train(DIFFUSION, SMALL_CFG, data, gen_cfg, n_iters=2,
                iters_per_ckpt=1, iters_per_logging=1, batch_size_per_gpu=2,
                device="cpu", compute_cfg=F32)
    assert calls == [1, 2] and out["step"] == 2
    assert [i for i, _ in out["losses"]] == [0, 1, 2]
    assert sorted(os.listdir(out["checkpoint_dir"])) == ["1.pkl", "2.pkl"]
    printed = capsys.readouterr().out
    assert printed.count("in-training generation failed: sampler broke") == 2


def test_failing_fidelity_metrics_do_not_stop_generation(tmp_path,
                                                         monkeypatch, capsys):
    """A fidelity metric that raises is printed as skipped, as JAX's
    generate() prints it, and generate() still returns and writes its
    wavs."""
    data = _write_corpus(str(tmp_path / "sc09"), n_per_label=1)
    monkeypatch.chdir(tmp_path)
    train(DIFFUSION, SMALL_CFG, data, None, n_iters=1, iters_per_ckpt=1,
          iters_per_logging=1, batch_size_per_gpu=2, device="cpu",
          compute_cfg=F32)

    def broken(*a, **k):
        raise ValueError("metric broke")
    monkeypatch.setattr(port_generate, "write_fidelity", broken)
    # an unconditional model sampled with a mel_name is not a path; give
    # generate() a source wav by stubbing the condition instead
    monkeypatch.setattr(port_generate, "resolve_condition",
                        lambda *a: (None, 16000))
    src = os.path.join(data["data_path"], "zero", "spk0_nohash_0.wav")
    audio = port_generate.generate(
        DIFFUSION, SMALL_CFG, dict(data, data_path=os.path.dirname(src)),
        ckpt_iter=1, n_samples=1, mel_name="spk0_nohash_0", device="cpu")
    assert audio.shape == (1, 1, 16000) and np.isfinite(audio).all()
    assert "fidelity metrics skipped: ValueError: metric broke" in \
        capsys.readouterr().out


def test_entry_points_require_a_card_unless_asked_for_the_cpu(
        tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = {"_name_": "sc09", "data_path": str(tmp_path),
            "segment_length": 16000, "sampling_rate": 16000}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_generate.generate(DIFFUSION, SMALL_CFG, data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(DIFFUSION, SMALL_CFG, data, None, compute_cfg=F32)
    # bf16 SaShiMi trains, and so does a bf16 conditional (vocoder)
    # config: past every refusal, its LJSpeech loader finds no clips here
    with pytest.raises(ValueError, match="0 batches"):
        train(DIFFUSION, dict(SMALL_CFG, unconditional=False),
              dict(data, _name_="ljspeech", hop_length=256), None,
              device="cpu",
              compute_cfg={"precision": "bf16"})


def test_entry_point_mains_import_no_jax(tmp_path):
    """Both runtimes' main() (generation for SC09, for the vocoder and for
    the WaveNet; training for SaShiMi and for the WaveNet) load the config
    through the port's own config.py and reach the device check, and the
    mel precompute CLI runs; the data-parallel launcher starts two CPU
    ranks through train's main() (each finds no clips and raises) and
    through ``parallel.launch``; by then no module of jax or of the JAX
    package has been imported, in this process or in a rank."""
    code = (
        "import sys\n"
        "from diffwave_sashimi_torch.data import mel2samp\n"
        "from diffwave_sashimi_torch.runtime import generate, train\n"
        "for main, exp in ((generate.main, 'sc09'), (train.main, 'sc09'),\n"
        "                  (generate.main, 'ljspeech'),\n"
        "                  (generate.main, 'sc09_wavenet'),\n"
        "                  (train.main, 'sc09_wavenet')):\n"
        "    try:\n"
        "        main(['experiment=' + exp, 'compute.precision=f32'])\n"
        "    except RuntimeError as e:\n"
        "        assert 'no CUDA device' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('main() ran without a card')\n"
        "assert mel2samp.main(['experiment=ljspeech', "
        "'+output_dir=mels']) == 0\n"
        "from diffwave_sashimi_torch.parallel import launch\n"
        "import test_torch_parallel_ranks as ranks\n"
        "try:\n"
        "    train.main(['experiment=sc09', 'compute.precision=f32',\n"
        "                'mesh.data=2', '+train.device=cpu',\n"
        "                'dataset.data_path=no_clips'])\n"
        "except Exception as e:\n"
        "    assert '0 batches' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('two ranks trained on no clips')\n"
        "assert launch(ranks.jax_modules, 2, 'gloo', 'cpu') == [[], []]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'diffwave_sashimi_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests"),
                                           os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert r.stdout.count("d_model: 128") == 4    # each printed the config
    assert r.stdout.count("mel_upsample:") == 1
    assert r.stdout.count("num_res_layers: 36") == 2
