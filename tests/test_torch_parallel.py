"""Data-parallel training of the port on the CPU over gloo: two ranks, each
a spawned process (``torch.set_num_threads(1)``) in a process group whose
rendezvous is a file store in a fresh temporary directory.

- One 2-rank step against the port's 1-rank step on the same global batch
  of 4, for the suite's small SaShiMi, a small WaveNet and the conditional
  SaShiMi (``tests/test_torch_vocoder_train.py``'s widths), and the same
  2-rank SaShiMi step against JAX's ``value_and_grad`` jitted with the
  batch sharded over ``make_mesh(data=2)``.
- The noise draws: rank r's rows of the global draws, which at one rank
  are ``training_loss``'s own; the world-1 trainer bit for bit the plain
  loop it was before data parallelism.
- ``main()`` with ``mesh.data=2 +train.device=cpu``: rank 0's checkpoint
  and metrics, the logged loss the ranks' mean, a resume at two ranks and
  at one, and a ``max_seconds`` stop, in a subprocess under a time limit.
- ``generate(rank, world)``, ``mesh.data``'s world size, a failing rank,
  and that the parameters the loss does not reach are the ones DDP is
  told to leave out.

The rank functions live in ``test_torch_parallel_ranks.py``, which spawned
processes import; it holds no JAX."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import test_torch_parallel_ranks as ranks
from test_torch_common import SMALL_CFG, perturbed

import jax
import jax.numpy as jnp

from diffwave_sashimi_tpu.diffusion.schedule import \
    schedule_from_cfg as jax_schedule
from diffwave_sashimi_tpu.parallel import make_mesh, replicated, shard_batch
from diffwave_sashimi_torch.data import dataloader
from diffwave_sashimi_torch.diffusion.loss import training_loss
from diffwave_sashimi_torch.diffusion.sampling import sampling
from diffwave_sashimi_torch.diffusion.schedule import schedule_from_cfg
from diffwave_sashimi_torch.models import construct_model
from diffwave_sashimi_torch.parallel import launch, mesh, world_size
from diffwave_sashimi_torch.runtime import generate as port_generate
from diffwave_sashimi_torch.runtime.checkpoint import load_into, \
    save_checkpoint
from diffwave_sashimi_torch.runtime.train import (make_optimizer,
                                                  rank_noise, train,
                                                  train_step)
from diffwave_sashimi_torch.utils.exp import local_directory
from diffwave_sashimi_torch.utils.jax_compat import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
DIFFUSION = {"T": 200, "beta_0": 0.0001, "beta_T": 0.02, "beta": None,
             "fast_steps": 3}
EMBED = {"diffusion_step_embed_dim_in": 128,
         "diffusion_step_embed_dim_mid": 512,
         "diffusion_step_embed_dim_out": 512}
L_SMALL = 1024
WAVENET = dict(EMBED, _name_="wavenet", unconditional=True, in_channels=1,
               out_channels=1, res_channels=16, skip_channels=16,
               num_res_layers=4, dilation_cycle=2)
SASHIMI_COND = dict(EMBED, _name_="sashimi", unconditional=False,
                    mel_upsample=[4, 4], in_channels=1, out_channels=1,
                    unet=True, d_model=8, n_layers=1, pool=[4, 4], expand=2,
                    ff=2, L=L_SMALL)
CASES = {"sashimi": SMALL_CFG, "wavenet": WAVENET,
         "sashimi_cond": SASHIMI_COND,
         "wavenet_cond": dict(WAVENET, unconditional=False,
                              mel_upsample=[4, 4])}
TIMEOUT = 120       # seconds a collective may wait before its rank raises
ROUNDOFF = "init_conv.0.conv.weight_v"   # dL/dv = 0 (test_torch_train.py)


def _cancels(name):
    """A gradient that sums over every position with cancellation."""
    return name.endswith("kernel.kernel.log_dt") or (
        "upsample_conv2d" in name and name.endswith(("weight_g", "bias")))


def _length(cfg):
    return cfg.get("L", L_SMALL)


def _batch(cfg, seed=3):
    """A global batch of 4: audio, t, z and (conditional) mel."""
    rng = np.random.RandomState(seed)
    L = _length(cfg)
    return {"audio": torch.from_numpy((0.5 * rng.randn(4, 1, L)).astype(
                np.float32)),
            "t": torch.tensor([3, 170, 58, 120]),
            "z": torch.from_numpy(rng.randn(4, 1, L).astype(np.float32)),
            "mel": None if cfg["unconditional"] else torch.from_numpy(
                rng.randn(4, 80, L // 16).astype(np.float32))}


def _state(case, small):
    """The case's parameters: SaShiMi's are JAX's perturbed ones; the
    others a seeded init with every tensor moved (zero-init heads too)."""
    cfg = CASES[case]
    if case == "sashimi":
        return params_from_jax(small[1], cfg)
    gen = torch.Generator().manual_seed(0)
    model = construct_model(cfg, generator=gen)
    return {k: v + 0.05 * torch.randn(v.shape, generator=gen)
            for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def small(sashimi_small):
    model, params = sashimi_small
    return model, perturbed(params, seed=1)


@pytest.fixture(scope="module")
def steps(small):
    """Per case: (the 1-rank steps, each rank's steps at world 2), two
    Adam steps each on the global batch of 4."""
    out = {}
    for case in ("sashimi", "wavenet", "sashimi_cond"):
        cfg, state = CASES[case], _state(case, small)
        args = (cfg, state, _batch(cfg), DIFFUSION)
        one = ranks.train_steps(0, 1, torch.device("cpu"), *args)
        out[case] = one, launch(ranks.train_steps, 2, "gloo", "cpu", args,
                                timeout=TIMEOUT)
    return out


@pytest.mark.parametrize("case", ["sashimi", "wavenet", "sashimi_cond"])
def test_two_ranks_take_the_one_rank_step(steps, case):
    """Each of two steps: the ranks' mean loss within 1e-6 relative of the
    1-rank loss; both ranks' gradients and parameters bit-equal; each
    all-reduced gradient within 1e-5 of its tensor's max; the parameters
    within 1e-6 of the 1-rank update (of max(1, max |p|): one ulp of an S4
    ``w_imag`` above 8 is 1e-6).  Stated exceptions:

    - ``init_conv.0.conv.weight_v``: its gradient is roundoff (W = g
      sign(v), test_torch_train.py), so Adam takes the sign of noise
      there; its gradient is held within 1e-6 of init_conv's weight_g
      gradient, its update not at all;
    - the gradients that are sums cancelling over every position, where
      the batch split moves the rounding: ``*.log_dt`` (its bar in
      test_torch_train.py, 1e-3; measured up to 1.3e-4) and the
      conditional SaShiMi's mel upsampler scalars ``upsample_conv2d.*.
      weight_g`` and ``.bias`` (measured up to 3.3e-4), at 1e-3;
    - the WaveNet's last res_conv, which the loss does not reach: no
      gradient, and it stays where it was on every rank."""
    one, (r0, r1) = steps[case]
    unreached = set(construct_model(CASES[case]).unreached_in_training())
    assert bool(unreached) == case.startswith("wavenet")
    for k in range(2):
        assert abs(r0[k]["loss_mean"] - one[k]["loss"]) <= \
            1e-6 * abs(one[k]["loss"])
        assert r0[k]["loss_mean"] == r1[k]["loss_mean"]
        g_scale = float(one[k]["grads"]["init_conv.0.conv.weight_g"].abs()
                        .max())
        for name, g in one[k]["grads"].items():
            p = one[k]["params"][name]
            assert torch.equal(r0[k]["params"][name], r1[k]["params"][name])
            if name in unreached:
                assert g is None and r0[k]["grads"][name] is None
                assert torch.equal(r0[k]["params"][name], p)
                continue
            assert torch.equal(r0[k]["grads"][name], r1[k]["grads"][name])
            err = float((r0[k]["grads"][name] - g).abs().max())
            if name == ROUNDOFF:
                assert err <= 1e-6 * g_scale, (name, err)
                continue
            tol = 1e-3 if _cancels(name) else 1e-5
            assert err <= tol * float(g.abs().max()), (name, k, err)
            assert float((r0[k]["params"][name] - p).abs().max()) <= \
                1e-6 * max(1.0, float(p.abs().max())), (name, k)


def test_two_ranks_match_jax_sharded_step(small, steps):
    """The 2-rank SaShiMi step's loss and gradients against JAX's
    value_and_grad of the injected-(t, z) loss, jitted with the batch
    sharded over a 2-device mesh: test_torch_train.py's tolerances (loss
    1e-5 relative, each gradient 1e-4 of its max, log_dt 1e-3, init_conv's
    weight_v as roundoff)."""
    model, p = small
    batch = _batch(SMALL_CFG)
    abar_all = jnp.asarray(jax_schedule(DIFFUSION).alpha_bar)

    def loss_fn(q, audio, t, z):
        abar = abar_all[t].reshape(-1, 1, 1)
        x_t = jnp.sqrt(abar) * audio + jnp.sqrt(1.0 - abar) * z
        eps = model.apply(q, x_t, t, None, train=True)
        return jnp.mean((eps - z) ** 2)
    mesh2 = make_mesh(data=2)
    with mesh2:
        args = [shard_batch(batch[k].numpy().astype(dt), mesh2)
                for k, dt in (("audio", np.float32), ("t", np.int32),
                              ("z", np.float32))]
        jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
            jax.device_put(p, replicated(mesh2)), *args)
    ref = params_from_jax(jax.tree.map(np.asarray, jgrads), SMALL_CFG)
    r0 = steps["sashimi"][1][0][0]
    assert abs(r0["loss_mean"] - float(jloss)) <= 1e-5 * abs(float(jloss))
    g_scale = float(ref["init_conv.0.conv.weight_g"].abs().max())
    for name, g in ref.items():
        mine = r0["grads"][name].reshape(g.shape)
        err = float((mine - g).abs().max())
        if name == ROUNDOFF:
            assert float(mine.abs().max()) <= 1e-6 * g_scale
            assert float(g.abs().max()) <= 1e-6 * g_scale
            continue
        tol = 1e-3 if name.endswith("kernel.kernel.log_dt") else 1e-4
        assert err <= tol * float(g.abs().max()), (name, err)


def test_rank_draws_are_rows_of_the_global_draws():
    """Rank r's (t, z) are rows [r b, (r + 1) b) of the world-1 draws over
    the global batch; those are, bit for bit, the two draws training_loss
    makes from the same generator, in its order (t, then z), and give its
    loss."""
    audio = torch.zeros(2, 1, 64)
    gen = torch.Generator()
    t1, z1 = rank_noise(gen.manual_seed(7), 200, torch.zeros(4, 1, 64))
    for r in range(2):
        t, z = rank_noise(gen.manual_seed(7), 200, audio, r, 2)
        assert torch.equal(t, t1[2 * r:2 * r + 2])
        assert torch.equal(z, z1[2 * r:2 * r + 2])
    gen.manual_seed(7)
    assert torch.equal(t1, torch.randint(0, 200, (4,), generator=gen))
    assert torch.equal(z1, torch.randn((4, 1, 64), generator=gen))

    model = construct_model(WAVENET, generator=torch.Generator().manual_seed(
        0))
    audio = torch.from_numpy(np.random.RandomState(1).randn(
        4, 1, 256).astype(np.float32))
    schedule = schedule_from_cfg(DIFFUSION)
    drawn = training_loss(model, audio, schedule, gen.manual_seed(11))
    t, z = rank_noise(gen.manual_seed(11), schedule.T, audio)
    assert torch.equal(drawn, training_loss(model, audio, schedule, t=t,
                                            z=z))


def _write_corpus(root, per_label=4, seed=0):
    from scipy.io import wavfile
    rng = np.random.RandomState(seed)
    for label in ("zero", "one"):
        os.makedirs(os.path.join(root, label))
        for i in range(per_label):
            wavfile.write(os.path.join(root, label, f"spk{i}_nohash_{i}.wav"),
                          16000, (rng.randn(4000) * 3000).astype(np.int16))
    return {"_name_": "sc09", "data_path": root, "segment_length": 4000,
            "sampling_rate": 16000}


SHORT = dict(SMALL_CFG, L=4000)       # tiers L 4000, 1000, 250


def test_world_one_trainer_is_the_plain_loop(tmp_path, monkeypatch):
    """At one rank train() draws, steps and saves bit for bit what the
    loop without data parallelism did: seed, init, Adam, and per
    iteration training_loss's own draws from the (seed, iteration)
    generator."""
    data = _write_corpus(str(tmp_path / "sc09"))
    monkeypatch.chdir(tmp_path)
    out = train(DIFFUSION, SHORT, data, None, n_iters=2, iters_per_ckpt=2,
                iters_per_logging=1, batch_size_per_gpu=2,
                compute_cfg={"precision": "f32"}, device="cpu", seed=5)
    torch.manual_seed(5)
    model = construct_model(SHORT, "f32")
    optim = make_optimizer(model, 2e-4)
    schedule = schedule_from_cfg(DIFFUSION)
    gen, want = torch.Generator(), []
    for n, (wavs, _, _) in zip(range(3), dataloader(data, batch_size=2)):
        gen.manual_seed(5 * 1_000_003 + n)
        want.append((n, train_step(model, optim, torch.from_numpy(wavs),
                                   schedule, gen).item()))
    assert out["losses"] == want
    saved = torch.load(os.path.join(out["checkpoint_dir"], "2.pkl"),
                       weights_only=True)
    assert saved["model_state_dict"].keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert torch.equal(saved["model_state_dict"][k], v), k


def _run_main(tmp_path, args):
    """runtime.train.main(args) in a subprocess of its own session under
    a time limit (the whole session killed past it); its stdout."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + TESTS)
    code = ("import sys, torch\ntorch.set_num_threads(1)\n"
            "from diffwave_sashimi_torch.runtime.train import main\n"
            "main(sys.argv[1:])\n")
    proc = subprocess.Popen([sys.executable, "-c", code] + args,
                            cwd=str(tmp_path), env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=180)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"main {args} did not end within 180 s")
    assert proc.returncode == 0, out[-3000:]
    return out


def test_main_trains_two_ranks_on_the_cpu(tmp_path):
    """main() with mesh.data=2 +train.device=cpu: two gloo ranks, B2 each;
    rank 0 alone prints, writes the checkpoint (names free of
    ``module.``) and one record a step to metrics.jsonl; the logged loss
    of iteration 0 is the mean of the two ranks' losses on their shards
    and draws; a second main() resumes at two ranks from checkpoint 2, and
    train() at one rank resumes from its checkpoint 4; a third, with
    ``max_seconds``, stops every rank after its first step, with no
    hang."""
    data = _write_corpus(str(tmp_path / "sc09"))
    args = ["experiment=sc09", "model.d_model=8", "model.n_layers=1",
            "model.L=4000", "dataset.segment_length=4000",
            f"dataset.data_path={data['data_path']}",
            "compute.precision=f32", "train.batch_size_per_gpu=2",
            "train.iters_per_logging=1", "generate.n_samples=0",
            "mesh.data=2", "+train.device=cpu"]
    out = _run_main(tmp_path, args + ["train.n_iters=3",
                                      "train.iters_per_ckpt=2"])
    assert out.count("Data loaded: 2 batches (4 global, 2 devices)") == 1
    assert out.count("iter 0 loss") == 1
    run, ckpt = local_directory(None, SHORT, DIFFUSION, data, "checkpoint",
                                makedirs=False)
    ckpt = os.path.join(tmp_path, ckpt)
    assert sorted(os.listdir(ckpt)) == ["2.pkl"]
    saved = torch.load(os.path.join(ckpt, "2.pkl"), weights_only=True)
    assert not any(k.startswith("module.") for k in
                   saved["model_state_dict"])
    with open(os.path.join(tmp_path, "exp", run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if "train/loss" in r] == [0, 1, 2, 3]

    torch.manual_seed(0)                  # the trainer's init, seed 0
    model = construct_model(SHORT, "f32")
    schedule = schedule_from_cfg(DIFFUSION)
    mine = []
    for r in range(2):
        wavs = next(iter(dataloader(data, batch_size=2, num_replicas=2,
                                    replica_id=r)))[0]
        audio = torch.from_numpy(wavs)
        t, z = rank_noise(torch.Generator().manual_seed(0), schedule.T,
                          audio, r, 2)
        mine.append(training_loss(model, audio, schedule, t=t, z=z))
    logged = recs[0]["train/loss"]
    assert abs(logged - float((mine[0] + mine[1]) / 2)) <= 1e-6 * logged

    _run_main(tmp_path, args + ["train.n_iters=4", "train.iters_per_ckpt=2"])
    assert sorted(os.listdir(ckpt)) == ["2.pkl", "4.pkl"]
    four = torch.load(os.path.join(ckpt, "4.pkl"), weights_only=True)
    assert {int(s["step"]) for s in
            four["optimizer_state_dict"]["state"].values()} == {5}
    prev = os.getcwd()
    os.chdir(tmp_path)
    try:
        res = train(DIFFUSION, SHORT, data, None, n_iters=5,
                    iters_per_logging=1, batch_size_per_gpu=2,
                    compute_cfg={"precision": "f32"}, device="cpu")
    finally:
        os.chdir(prev)
    assert [i for i, _ in res["losses"]] == [5]
    assert {int(s["step"]) for s in res["optimizer"].state.values()} == {6}

    out = _run_main(tmp_path, args + ["train.n_iters=1000",
                                      "train.iters_per_ckpt=1000",
                                      "+train.max_seconds=1e-9",
                                      "train.ckpt_iter=-1"])
    assert out.count("iter 0 loss") == 1 and "iter 1 loss" not in out


def test_generate_rank_offsets_names_and_draws(tmp_path, monkeypatch):
    """generate(rank=1, world=2) writes wavs numbered from n_samples and
    samples other noise than rank 0; rank 0, at world 1 or 2, draws
    today's bits: the sampler from manual_seed(seed)."""
    monkeypatch.chdir(tmp_path)
    data = {"_name_": "sc09", "data_path": str(tmp_path),
            "segment_length": 4000, "sampling_rate": 16000}
    model = construct_model(SHORT, generator=torch.Generator().manual_seed(0))
    fc2 = model.final_conv[2].conv
    with torch.no_grad():                 # eps all 0 hides the noise
        fc2.weight.normal_(0, 0.1, generator=torch.Generator().manual_seed(1))
    _, ckpt = local_directory(None, SHORT, DIFFUSION, data, "checkpoint")
    save_checkpoint(ckpt, 3000, model)
    kw = dict(ckpt_iter=3000, n_samples=2, seed=4, device="cpu")
    r1 = port_generate.generate(DIFFUSION, SHORT, data, rank=1, world=2,
                                **kw)
    r0 = port_generate.generate(DIFFUSION, SHORT, data, rank=0, world=2,
                                **kw)
    single = port_generate.generate(DIFFUSION, SHORT, data, **kw)
    wav_dir = os.path.join(os.path.dirname(ckpt), "waveforms", "3000")
    assert sorted(os.listdir(wav_dir)) == [f"3k_{i}.wav" for i in range(4)]
    assert np.array_equal(r0, single)
    assert not np.allclose(r0, r1, atol=0.1)
    with torch.no_grad():
        ref = sampling(model.eval(), (2, 1, 4000),
                       schedule_from_cfg(DIFFUSION, fast=True),
                       device=torch.device("cpu"),
                       generator=torch.Generator().manual_seed(4))
    assert np.array_equal(single, ref.numpy())
    with pytest.raises(ValueError, match="rank 2 of world 2"):
        port_generate.generate(DIFFUSION, SHORT, data, rank=2, world=2, **kw)


def test_world_size_from_mesh_data(monkeypatch):
    """-1 is every card on cuda (device_count(), monkeypatched) and one
    rank on the CPU; a number past the cards raises, naming both; train()
    in one process refuses a mesh.data asking for more ranks (before the
    port ran data parallel it refused any mesh.data > 1)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert world_size(-1, "cuda") == 4 and world_size(None, "cuda") == 4
    assert world_size(2, "cuda") == 2
    with pytest.raises(ValueError, match=r"mesh\.data=5 asks for 5 ranks.*"
                                         r"4 card"):
        world_size(5, "cuda")
    assert world_size(-1, "cpu") == 1 and world_size(3, "cpu") == 3
    with pytest.raises(ValueError, match="mesh.data=0"):
        world_size(0, "cpu")
    # a single process refuses a mesh.data asking for more ranks
    with pytest.raises(ValueError, match=r"mesh\.data=4 asks for 4 ranks"):
        train(DIFFUSION, SMALL_CFG, {"_name_": "sc09", "data_path": "none",
                                     "segment_length": 16000},
              None, device="cpu", compute_cfg={"precision": "f32"},
              mesh_cfg={"data": 4})
    assert mesh.row_range(1, 2, 8) == (4, 8)
    with pytest.raises(ValueError, match="not a multiple"):
        mesh.row_range(0, 3, 8)


def test_a_failing_rank_ends_the_run():
    """A rank that raises ends its peer (waiting for it in an all-reduce),
    and the launcher raises (whichever rank it hears from first) well
    before the collectives' time limit: no hang."""
    t0 = time.monotonic()
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="rank 1 failed|Connection reset"):
        launch(ranks.rank_1_raises, 2, "gloo", "cpu", timeout=TIMEOUT)
    assert time.monotonic() - t0 < TIMEOUT / 2


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_parameter_the_loss_reaches_gets_a_gradient(small, case):
    """One step of each model: the parameters without a gradient are
    exactly ``unreached_in_training()``, the ones data parallelism leaves
    out of DDP's reduction (none for SaShiMi, the vocoder among them; the
    last block's res_conv for the WaveNet)."""
    cfg = CASES[case]
    model = construct_model(cfg)
    load_into(model, _state(case, small))
    batch = _batch(cfg)
    training_loss(model, batch["audio"], schedule_from_cfg(DIFFUSION),
                  t=batch["t"], z=batch["z"], mel=batch["mel"]).backward()
    missing = [n for n, p in model.named_parameters() if p.grad is None]
    assert sorted(missing) == sorted(model.unreached_in_training())
