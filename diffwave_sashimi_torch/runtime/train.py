"""Training runtime: SaShiMi or WaveNet, unconditional on SC09 or
mel-conditioned on LJSpeech (the vocoder), at bf16 as shipped or f32, on
one card or data-parallel over several.

Port of ``diffwave_sashimi_tpu/runtime/train.py`` (the reference's
``train.py``): run name and ``exp/<run>`` layout, diffusion schedule, SC09
or Mel2Samp loader (a conditional model's batches are (mel, audio), the
mel threaded into the loss), Adam at ``learning_rate`` (optionally
``s4_lr`` for the SSM
tensors), resume from ``ckpt_iter`` ('max' | int | -1), loss logging every
``iters_per_logging``, a checkpoint (and, with ``generate.n_samples > 0``,
samples from it) every ``iters_per_ckpt``, ``n_iters + 1`` iterations and
an optional wall-clock budget ``max_seconds``.  A failing in-training
``generate()`` is printed and training goes on, as in JAX.

Data parallelism (``mesh.data``: N ranks, or -1 for every card;
:mod:`..parallel`): :func:`main` starts one process a rank (:func:`
train_ranks`), rank r on ``cuda:r`` over NCCL, or on the CPU over gloo.
Each rank loads its shard of the data (``batch_size_per_gpu`` rows a step,
the global batch ``batch_size_per_gpu`` x ranks), and DDP averages the
gradients.  Rank 0 alone writes checkpoints and metrics, prints, and draws
the in-training samples; the logged losses are the means over the ranks.

Each step draws t and z for the whole global batch from a generator seeded
by (seed, iteration), and each rank keeps its rows (at one rank, the draws
``training_loss`` makes), so a resumed run draws what an uninterrupted one
would, and N ranks take the step one rank takes on their batches stacked.
Each step runs the model's
training form through the kernels (``ops.FUSED``: for SaShiMi forward
kernels 1-4, backward kernels 1, 5-8, or at bf16 their fast forms 1f, 2f,
3f and 1f, 5f, 6f, 7f with kernels 4 and 8; past FFT size 32768 the conv
by kernel 9's training entries and its spectrum gradient by kernel 5L;
WaveNet's training form has none, as in JAX: cuDNN convs and the plain
gate under autograd) and takes one Adam step on the f32 parameters, so a
checkpoint is f32 whatever the precision.  In-training samples are drawn
at f32, as the JAX trainer's ``generate()`` call does; a conditional
model draws them for ``generate.mel_name``, which it needs.  Not ported,
and refused by name (``models.check_supported(..., train=True)`` and the
rest of :func:`_refuse_unported`): dropout, activation
rematerialisation, wandb and, where samples are drawn,
``generate.ckpt_smooth``: each before the first step.
"""

from __future__ import annotations

import hashlib
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import extract_multirun_flag, load_config, sweep_overrides
from ..data import dataloader
from ..diffusion.loss import training_loss
from ..diffusion.schedule import schedule_from_cfg
from ..models import check_supported, construct_model
from ..ops import COUNTED, FUSED, Ops
from ..parallel import (agree, all_reduce_mean, data_parallel, distributed,
                        is_main_process, launch, row_range, world_size)
from ..utils.exp import local_directory
from .checkpoint import load_checkpoint, load_into, save_checkpoint
from .generate import CKPT_SMOOTH_TODO, generate, resolve_device
from .metrics import MetricsLogger

SSM_PARAM_NAMES = frozenset(
    {"log_dt", "B", "P", "inv_w_real", "w_imag", "inv_A_real", "A_imag"})


def is_ssm_param(name: str) -> bool:
    """An SSM tensor of an S4 kernel (the JAX package labels a parameter
    "s4" when it sits under a ``kernel`` module and is named in
    :data:`SSM_PARAM_NAMES`)."""
    parts = name.split(".")
    return parts[-1] in SSM_PARAM_NAMES and "kernel" in parts[:-1]


def make_optimizer(model: torch.nn.Module, learning_rate: float,
                   s4_lr: Optional[float] = None) -> torch.optim.Adam:
    """Adam (optax.adam's defaults), with a second parameter group at
    ``s4_lr`` for the SSM tensors when it is set (empty for a model without
    S4, whose parameters all stay in the first, as under the JAX
    ``multi_transform`` labels)."""
    if s4_lr is None:
        return torch.optim.Adam(model.parameters(), lr=learning_rate)
    named = list(model.named_parameters())
    return torch.optim.Adam([
        {"params": [p for n, p in named if not is_ssm_param(n)],
         "lr": learning_rate},
        {"params": [p for n, p in named if is_ssm_param(n)], "lr": s4_lr}])


def train_step(model, optimizer, audio: torch.Tensor, schedule,
               generator: Optional[torch.Generator] = None,
               ops: Ops = FUSED,
               mel: Optional[torch.Tensor] = None,
               t: Optional[torch.Tensor] = None,
               z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One loss, backward and Adam update; returns the loss (detached).
    ``mel``: the conditional model's batch of spectrograms; ``t`` and
    ``z``, when given, replace the draws from ``generator``."""
    optimizer.zero_grad(set_to_none=True)
    loss = training_loss(model, audio, schedule, generator, t=t, z=z,
                         ops=ops, mel=mel)
    loss.backward()
    optimizer.step()
    return loss.detach()


def rank_noise(generator: torch.Generator, T: int, audio: torch.Tensor,
               rank: int = 0, world: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank ``rank``'s rows of t and z, drawn from ``generator`` for the
    global batch of ``world`` ranks' ``audio`` (B, 1, L) each, in
    ``training_loss``'s order: t (world B,), then z (world B, 1, L).  At
    one rank these are ``training_loss``'s own draws."""
    B = audio.shape[0] * world
    t = torch.randint(0, T, (B,), generator=generator, device=audio.device)
    z = torch.randn((B,) + tuple(audio.shape[1:]), generator=generator,
                    device=audio.device, dtype=audio.dtype)
    lo, hi = row_range(rank, world, B)
    return t[lo:hi], z[lo:hi]


def _refuse_unported(model_cfg, compute_cfg, wandb_cfg, generate_cfg,
                     device_type) -> str:
    """The compute precision, after refusing what is not ported on
    ``device_type``, the in-training ``generate()`` arguments among it
    (checked only where samples are drawn, ``generate.n_samples > 0``)."""
    compute_cfg = compute_cfg or {}
    precision = compute_cfg.get("precision", "bf16")
    check_supported(model_cfg, precision, train=True,
                    device_type=device_type)
    if compute_cfg.get("remat"):
        raise NotImplementedError("compute.remat (activation "
                                  "rematerialisation) is not ported: "
                                  "ROADMAP.md queue 1, item 6")
    if (wandb_cfg or {}).get("mode", "disabled") != "disabled":
        raise NotImplementedError("wandb logging is not ported: ROADMAP.md "
                                  "queue 1, item 6")
    if float(model_cfg.get("dropout", 0.0) or 0.0):
        raise NotImplementedError("S4 dropout is not ported: ROADMAP.md "
                                  "queue 1, item 7")
    generate_cfg = generate_cfg or {}
    if int(generate_cfg.get("n_samples") or 0) > 0:
        if generate_cfg.get("ckpt_smooth") is not None:
            raise NotImplementedError(CKPT_SMOOTH_TODO)
        if not model_cfg.get("unconditional", True) \
                and generate_cfg.get("mel_name") is None:
            raise ValueError("a conditional model's in-training samples "
                             "need generate.mel_name (or "
                             "generate.n_samples=0)")
    return precision


def train(diffusion_cfg, model_cfg, dataset_cfg, generate_cfg,
          ckpt_iter="max", n_iters: int = 1000001,
          iters_per_ckpt: int = 10000, iters_per_logging: int = 100,
          learning_rate: float = 2e-4, batch_size_per_gpu: int = 4,
          s4_lr: Optional[float] = None, name: Optional[str] = None,
          mesh_cfg=None, compute_cfg=None, wandb_cfg=None, seed: int = 0,
          max_seconds: Optional[float] = None,
          device=None, rank: int = 0, world: int = 1) -> Dict[str, Any]:
    """Run the training loop; returns {'model', 'optimizer', 'step',
    'checkpoint_dir', 'losses'} ('model': the module, not its DDP wrapper;
    'losses': the logged (iteration, loss) pairs, means over the ranks).
    ``device`` defaults to the first card.  ``rank`` of ``world``: one
    rank of a process group that :func:`train_ranks` starts (``world`` >
    1 needs one); a single process (``world`` 1) refuses a ``mesh.data``
    that asks for more ranks."""
    device = resolve_device(device)
    precision = _refuse_unported(model_cfg, compute_cfg, wandb_cfg,
                                 generate_cfg, device.type)
    data = (mesh_cfg or {}).get("data", -1)
    asked = world_size(data, device.type)
    if world == 1 and asked != 1:
        raise ValueError(f"mesh.data={data} asks for {asked} ranks, and "
                         f"train() runs one: start them with main() or "
                         f"train_ranks(), or set mesh.data=1")
    if world > 1 and not distributed():
        raise RuntimeError(f"train() at {world} ranks needs a process "
                           f"group: start the ranks with train_ranks()")
    main_proc = is_main_process()

    def say(msg):
        if main_proc:
            print(msg, flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 means f32
    torch.backends.cudnn.allow_tf32 = False
    local_path, ckpt_dir = local_directory(name, model_cfg, diffusion_cfg,
                                           dataset_cfg, "checkpoint")
    schedule = schedule_from_cfg(diffusion_cfg, fast=False)
    data_loader = dataloader(dataset_cfg, batch_size=batch_size_per_gpu,
                             num_replicas=world, replica_id=rank,
                             unconditional=model_cfg["unconditional"])
    say(f"Data loaded: {len(data_loader)} batches "
        f"({batch_size_per_gpu * world} global, {world} "
        f"device{'s' * (world > 1)})")
    if len(data_loader) == 0:
        raise ValueError(
            f"dataset yielded 0 batches of {batch_size_per_gpu} (a rank's "
            f"shard of {world}) - check "
            f"data_path={dataset_cfg.get('data_path')!r} (the SC09 loader "
            f"keeps only '*_nohash_*.wav' files, LJSpeech's every '*.wav') "
            f"and that it holds >= one batch of clips a rank")

    torch.manual_seed(seed)          # the initialisation, on the device
    with torch.device(device):
        model = construct_model(model_cfg, precision)
    say(f"{model.__class__.__name__} Parameters: "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.6f}M")
    optimizer = make_optimizer(model, learning_rate, s4_lr)

    ck = load_checkpoint(ckpt_dir, ckpt_iter, model_cfg)
    if ck is not None:
        load_into(model, ck["model_state_dict"])
        if ck["optimizer_state_dict"] is not None:
            optimizer.load_state_dict(ck["optimizer_state_dict"])
        start_iter = ck["step"] + 1
        say(f"Successfully loaded model at iteration {ck['step']}")
    else:
        start_iter = 0
        say("No valid checkpoint model found - training from scratch.")
    model.train()
    net = data_parallel(model) if distributed() else model

    def out_of_time() -> bool:      # rank 0's decision, on every rank
        return bool(max_seconds) and agree(
            time.time() - t_start > max_seconds, device)

    gen_kwargs = {k: v for k, v in dict(generate_cfg or {}).items()
                  if k != "ckpt_iter"}
    logger = MetricsLogger(os.path.join("exp", local_path),
                           enabled=main_proc)
    step_gen = torch.Generator(device=device)
    losses = []
    n_iter = start_iter
    t_start = time.time()
    try:
        while n_iter < n_iters + 1:
            epoch_loss, epoch_batches = None, 0
            for data in data_loader:
                if model_cfg["unconditional"]:
                    audio = data[0] if isinstance(data, tuple) else data
                    mel = None
                else:
                    mel, audio = data[0], data[1]
                    mel = torch.from_numpy(np.asarray(mel, np.float32)).to(
                        device)
                audio = torch.from_numpy(np.asarray(audio, np.float32)).to(
                    device)
                step_gen.manual_seed(seed * 1_000_003 + n_iter)
                t, z = rank_noise(step_gen, schedule.T, audio, rank, world)
                loss = train_step(net, optimizer, audio, schedule, mel=mel,
                                  t=t, z=z)
                epoch_loss = loss if epoch_loss is None else epoch_loss + loss
                epoch_batches += 1

                if n_iter % iters_per_logging == 0:
                    loss_v = float(all_reduce_mean(loss))
                    losses.append((n_iter, loss_v))
                    logger.log({"train/loss": loss_v,
                                "train/log_loss": math.log(max(loss_v,
                                                               1e-12)),
                                "train/steps_per_sec":
                                    (n_iter - start_iter + 1)
                                    / (time.time() - t_start)},
                               step=n_iter)
                    say(f"iter {n_iter} loss {loss_v:.5f}")

                if main_proc and n_iter > 0 and n_iter % iters_per_ckpt == 0:
                    save_checkpoint(ckpt_dir, n_iter, model, optimizer)
                    say(f"model at iteration {n_iter} is saved")
                    if int(gen_kwargs.get("n_samples") or 0) > 0:
                        # at generate()'s default precision, f32, as the
                        # JAX trainer samples whatever it trains at
                        try:
                            generate(diffusion_cfg, model_cfg, dataset_cfg,
                                     ckpt_iter=n_iter, name=name,
                                     device=device, **gen_kwargs)
                        except Exception as e:  # sampling must not kill training
                            traceback.print_exc()
                            say(f"in-training generation failed: {e}")

                n_iter += 1
                if n_iter >= n_iters + 1:
                    break
                if out_of_time():
                    break
            if epoch_batches:
                logger.log({"train/loss_epoch":
                            float(all_reduce_mean(epoch_loss))
                            / epoch_batches}, step=n_iter)
            if out_of_time():
                break
    finally:
        logger.finish()
    return {"model": model, "optimizer": optimizer, "step": n_iter - 1,
            "checkpoint_dir": ckpt_dir, "losses": losses}


def params_sha256(model: torch.nn.Module) -> str:
    """A digest of every parameter's bits, in order (equal on two ranks
    exactly when their parameters are bit-equal)."""
    h = hashlib.sha256()
    for name, p in model.named_parameters():
        h.update(name.encode())
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _train_rank(rank: int, world: int, device: torch.device,
                kwargs: Dict[str, Any]) -> Dict[str, Any]:
    out = train(**kwargs, device=device, rank=rank, world=world)
    return {"step": out["step"], "losses": out["losses"],
            "params_sha256": params_sha256(out["model"]),
            "launches": {k: f.launches for k, f in COUNTED.items()}}


def train_ranks(train_kwargs: Dict[str, Any], world: int, backend: str,
                device_type: str = "cuda") -> List[Dict[str, Any]]:
    """:func:`train` at ``world`` ranks, one spawned process each, in a
    ``backend`` ("nccl" or "gloo") process group, also at one rank; rank r
    on ``cuda:r`` (modulo the cards: gloo may put two ranks on one card)
    or on the CPU.  ``train_kwargs``: train()'s arguments but ``device``,
    ``rank`` and ``world``.  Returns each rank's {'step', 'losses',
    'params_sha256', 'launches'} ('launches': the kernel launch counts of
    its process)."""
    return launch(_train_rank, world, backend, device_type, (train_kwargs,))


def train_kwargs(cfg) -> Dict[str, Any]:
    """:func:`train`'s arguments from a loaded config, but ``device``."""
    train_cfg = dict(cfg.train)
    train_cfg.pop("device", None)
    return dict(diffusion_cfg=cfg.diffusion, model_cfg=cfg.model,
                dataset_cfg=cfg.dataset, generate_cfg=cfg.generate,
                name=train_cfg.pop("name", None), mesh_cfg=cfg.get("mesh"),
                compute_cfg=cfg.get("compute"), wandb_cfg=cfg.get("wandb"),
                **train_cfg)


def main(argv=None):
    """CLI: ``python -m diffwave_sashimi_torch.runtime.train
    experiment=sc09 ...`` (Hydra-style overrides;
    ``-m`` sweeps comma-listed values as sequential jobs).  Trains on the
    card, on ``mesh.data`` cards (-1, the config's: every card) one process
    each; ``+train.device=cpu`` asks for the CPU (``mesh.data`` > 1: that
    many processes over gloo)."""
    args, multirun = extract_multirun_flag(
        argv if argv is not None else sys.argv[1:])
    if multirun:
        jobs = sweep_overrides(args)
        for i, job in enumerate(jobs):
            print(f"[multirun] job {i}/{len(jobs)}: {' '.join(job)}",
                  flush=True)
            main(job)
        return
    cfg = load_config(overrides=args)
    print(cfg.to_yaml())
    os.makedirs("exp/", mode=0o775, exist_ok=True)
    kwargs = train_kwargs(cfg)
    device = resolve_device(cfg.train.get("device"))
    world = world_size((cfg.get("mesh") or {}).get("data", -1), device.type)
    if world == 1:
        train(**kwargs, device=device)
    else:
        train_ranks(kwargs, world,
                    "nccl" if device.type == "cuda" else "gloo", device.type)


if __name__ == "__main__":
    main()
