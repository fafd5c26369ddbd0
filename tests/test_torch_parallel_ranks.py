"""Rank functions for tests/test_torch_parallel.py, which the port's
launcher (``diffwave_sashimi_torch.parallel.launch``) runs in spawned
processes.  This module imports torch and the port, never JAX, and holds
no tests."""

import sys

import torch
import torch.distributed as dist

from diffwave_sashimi_torch.diffusion.schedule import schedule_from_cfg
from diffwave_sashimi_torch.models import construct_model
from diffwave_sashimi_torch.parallel import (all_reduce_mean, data_parallel,
                                             distributed, row_range)
from diffwave_sashimi_torch.runtime.checkpoint import load_into
from diffwave_sashimi_torch.runtime.train import make_optimizer, train_step

torch.set_num_threads(1)


def train_steps(rank, world, device, cfg, state, batch, diffusion, steps=2):
    """``steps`` Adam steps (lr 2e-4) of the f32 model ``cfg`` carrying
    ``state`` on this rank's rows of ``batch`` ({"audio", "t", "z", "mel"}
    of the global batch), through DDP inside a process group; each step's
    {"loss" (this rank's), "loss_mean" (over the ranks), "grads" (after
    the reduction; None where the loss does not reach), "params"}."""
    model = construct_model(cfg, "f32")
    load_into(model, state)
    net = data_parallel(model) if distributed() else model
    optim = make_optimizer(model, 2e-4)
    schedule = schedule_from_cfg(diffusion)
    lo, hi = row_range(rank, world, batch["audio"].shape[0])
    rows = {k: None if v is None else v[lo:hi] for k, v in batch.items()}
    out = []
    for _ in range(steps):
        loss = train_step(net, optim, rows["audio"], schedule, t=rows["t"],
                          z=rows["z"], mel=rows["mel"])
        out.append({
            "loss": loss.item(), "loss_mean": all_reduce_mean(loss).item(),
            "grads": {n: None if p.grad is None else p.grad.clone()
                      for n, p in model.named_parameters()},
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()}})
    return out


def jax_modules(rank, world, device):
    """The modules of jax or of the JAX package a rank holds once the
    trainer is imported."""
    import diffwave_sashimi_torch.runtime.train  # noqa: F401
    return sorted(m for m in sys.modules if m.split(".")[0] in
                  ("jax", "jaxlib", "flax", "diffwave_sashimi_tpu"))


def rank_1_raises(rank, world, device):
    """Rank 1 raises while rank 0 waits for it in an all-reduce."""
    if rank == 1:
        raise RuntimeError("rank 1 failed")
    dist.all_reduce(torch.zeros(1))
