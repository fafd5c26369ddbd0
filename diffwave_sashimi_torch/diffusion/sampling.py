"""Reverse-diffusion sampling: the T-step DDPM loop.

Port of ``diffwave_sashimi_tpu/diffusion/sampling.py::sampling`` as a plain
Python loop (the JAX package's host-pipelined variant exists only to dodge
a TPU watchdog):

    for t = T-1 .. 0:
        eps = net(x, t)
        x = (x - (1 - alpha_t) / sqrt(1 - abar_t) * eps) / sqrt(alpha_t)
        if t > 0: x += sigma_t * N(0, I)

The S4 kernels depend only on the parameters, and a vocoder's mel terms
only on the mel and the parameters, so both are built once, before the
loop.  Noise comes from a ``torch.Generator``, or from an injected stack so
a test can share it with the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..ops import FUSED, Ops
from .schedule import DiffusionSchedule


def schedule_table(schedule: DiffusionSchedule) -> torch.Tensor:
    """(rows, T) float32: alpha, alpha_bar, sigma [, t_embed]."""
    rows = [schedule.alpha, schedule.alpha_bar, schedule.sigma]
    if schedule.t_embed is not None:
        rows.append(schedule.t_embed)
    return torch.stack(rows)


def sampling_step(net, x: torch.Tensor, t: int, table: torch.Tensor,
                  has_embed: bool, noise: Optional[torch.Tensor]
                  ) -> torch.Tensor:
    """One reverse step at diffusion step t.  ``table`` must carry the
    t_embed row exactly when ``has_embed``: a mismatch would feed the sigma
    row to the model as step values."""
    rows = 4 if has_embed else 3
    if table.shape[0] != rows:
        raise ValueError(f"schedule table has {table.shape[0]} rows, the "
                         f"step expects {rows} (t_embed "
                         f"{'on' if has_embed else 'off'})")
    alpha_t, abar_t, sigma_t = (float(v) for v in table[:3, t])
    step = float(table[3, t]) if has_embed else t
    steps = torch.full((x.shape[0],), step, device=x.device,
                       dtype=torch.float32 if has_embed else torch.int64)
    eps = net(x, steps).float()          # x_t stays f32 at any precision
    x = (x - (1.0 - alpha_t) / (1.0 - abar_t) ** 0.5 * eps) / alpha_t ** 0.5
    if t > 0:
        x = x + sigma_t * noise
    return x


@torch.no_grad()
def sampling(model, shape: Sequence[int], schedule: DiffusionSchedule,
             device=None, generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None,
             mel_conds: Optional[List[torch.Tensor]] = None,
             ops: Optional[Ops] = None) -> torch.Tensor:
    """Draw (B, 1, L) samples, through ``ops`` (default ``ops.FUSED``).
    ``noise`` (T+1, *shape), if given, replaces the generator: noise[0] is
    x_T and noise[1 + i] the draw of the i-th step (t = T-1-i; the last
    step draws none).  A conditional model takes
    its mel terms from ``model.compute_mel_conds(mel, L)``."""
    device = torch.device(device if device is not None else "cpu")
    T = schedule.T
    if noise is not None and tuple(noise.shape) != (T + 1, *shape):
        raise ValueError(f"noise stack {tuple(noise.shape)} != "
                         f"{(T + 1, *shape)}")

    def draw(i):
        if noise is not None:
            return noise[i].to(device)
        return torch.randn(tuple(shape), generator=generator, device=device)

    ops = FUSED if ops is None else ops
    kernels = model.compute_kernels(shape[-1], ops)

    def net(x, steps):
        return model(x, steps, kernels, ops, mel_conds=mel_conds)

    table = schedule_table(schedule)
    has_embed = schedule.t_embed is not None
    x = draw(0)
    for i, t in enumerate(range(T - 1, -1, -1)):
        x = sampling_step(net, x, t, table, has_embed,
                          draw(i + 1) if t > 0 else None)
    return x
