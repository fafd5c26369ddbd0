"""Sinusoidal diffusion-step embedding.

Port of ``diffwave_sashimi_tpu/models/embedding.py``: frequencies
exp(-log(10000) i / (half - 1)), embedding [sin(t f) ; cos(t f)].  Steps may
be fractional (aligned fast schedules feed trained-schedule step values).
"""

from __future__ import annotations

import math

import torch


def diffusion_step_embedding(steps: torch.Tensor,
                             dim_in: int = 128) -> torch.Tensor:
    """steps: (B,) or (B, 1), any numeric dtype -> (B, dim_in) float32."""
    if dim_in % 2:
        raise ValueError(f"embedding dim must be even, got {dim_in}")
    half = dim_in // 2
    steps = steps.to(torch.float32).reshape(-1, 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=steps.device)
                      * (-math.log(10000.0) / (half - 1)))
    args = steps * freqs
    return torch.cat([torch.sin(args), torch.cos(args)], dim=1)
