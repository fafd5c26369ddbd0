"""Denoising score-matching training loss.

Port of ``diffwave_sashimi_tpu/diffusion/loss.py::training_loss``: a
uniform step t in [0, T) per batch element, the forward q-sample
``x_t = sqrt(abar_t) x_0 + sqrt(1 - abar_t) z``, and the MSE between the
predicted and the true noise, in f32.  t and z come from an explicit
``torch.Generator``, or are passed in (the parity tests share them with
the JAX package that way).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import FUSED, Ops
from .schedule import DiffusionSchedule


def training_loss(model, audio: torch.Tensor, schedule: DiffusionSchedule,
                  generator: Optional[torch.Generator] = None,
                  t: Optional[torch.Tensor] = None,
                  z: Optional[torch.Tensor] = None,
                  ops: Ops = FUSED,
                  mel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The eps-prediction MSE for clean audio (B, 1, L); differentiable in
    the model's parameters.  ``t`` (B,) int and ``z`` (B, 1, L), when given,
    replace the draws from ``generator``; ``mel`` (B, 80, frames), the
    conditional model's spectrogram, goes to the model (JAX's
    ``mel_spec``)."""
    B = audio.shape[0]
    if t is None:
        t = torch.randint(0, schedule.T, (B,), generator=generator,
                          device=audio.device)
    if z is None:
        z = torch.randn(audio.shape, generator=generator,
                        device=audio.device, dtype=audio.dtype)
    abar = schedule.alpha_bar.to(audio.device)[t].reshape(B, 1, 1)
    x_t = abar.sqrt() * audio + (1.0 - abar).sqrt() * z
    eps = model(x_t, t, ops=ops, train=True, mel=mel)
    return torch.mean((eps.float() - z.float()) ** 2)
