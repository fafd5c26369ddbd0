"""DDPM diffusion schedule.

Port of ``diffwave_sashimi_tpu/diffusion/schedule.py``: linear beta
schedule, cumulative-product alpha-bar and sigma = sqrt(beta_tilde), computed
in float64 numpy and stored as float32 tensors; the fast/``beta`` override
with ``fast_beta_list`` (canon | geom) and the ``align`` fractional step
row ``t_embed`` (the model was trained on the full schedule, so a fast
step feeds the full-schedule step with the same sqrt(alpha_bar)).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


class DiffusionSchedule(NamedTuple):
    T: int                          # number of diffusion steps
    beta: torch.Tensor              # (T,) float32
    alpha: torch.Tensor             # (T,) 1 - beta
    alpha_bar: torch.Tensor         # (T,) cumprod of alpha
    sigma: torch.Tensor             # (T,) sqrt(beta_tilde)
    t_embed: Optional[torch.Tensor] = None   # (T,) fractional steps, or None


# DiffWave's published 6-entry fast variance schedule
FAST_BETA_6 = (0.0001, 0.001, 0.01, 0.05, 0.2, 0.5)


def fast_beta_list(T: int, shape: str = "canon"):
    """A T-entry fast variance schedule over the canonical endpoints:
    ``canon`` resamples the 6-entry list log-linearly in index space,
    ``geom`` is pure log spacing; T = 6 is the canonical list."""
    if T == 6:
        return [float(b) for b in FAST_BETA_6]
    if shape == "canon":
        xs = np.linspace(0.0, len(FAST_BETA_6) - 1, T)
        return [float(b) for b in
                np.exp(np.interp(xs, np.arange(len(FAST_BETA_6)),
                                 np.log(FAST_BETA_6)))]
    if shape == "geom":
        return [float(b) for b in
                np.geomspace(FAST_BETA_6[0], FAST_BETA_6[-1], T)]
    raise ValueError(f"unknown fast schedule shape {shape!r} "
                     "(expected 'canon' or 'geom')")


def align_fast_steps(abar_fast: np.ndarray, T: int, beta_0: float,
                     beta_T: float) -> np.ndarray:
    """For each fast step, the (fractional, clamped) trained-schedule step
    t in [0, T-1] with the same sqrt(alpha_bar); float64."""
    b = np.linspace(beta_0, beta_T, T, dtype=np.float64)
    st = np.sqrt(np.cumprod(1.0 - b))
    sf = np.sqrt(np.asarray(abar_fast, dtype=np.float64))
    return np.interp(sf, st[::-1], np.arange(T, dtype=np.float64)[::-1])


def diffusion_schedule(T: int, beta_0: float, beta_T: float,
                       beta: Optional[Sequence[float]] = None,
                       fast: bool = False,
                       align: bool = True) -> DiffusionSchedule:
    t_embed = None
    if fast and beta is not None:
        b = np.asarray(beta, dtype=np.float64)
        if align:
            t_embed = torch.tensor(align_fast_steps(np.cumprod(1.0 - b), T,
                                                    beta_0, beta_T),
                                   dtype=torch.float32)
        T = len(b)
    else:
        b = np.linspace(beta_0, beta_T, T, dtype=np.float64)
    a = 1.0 - b
    abar = np.cumprod(a)
    beta_tilde = b.copy()
    beta_tilde[1:] = b[1:] * (1.0 - abar[:-1]) / (1.0 - abar[1:])

    def f32(x):
        return torch.tensor(x, dtype=torch.float32)

    return DiffusionSchedule(T=int(T), beta=f32(b), alpha=f32(a),
                             alpha_bar=f32(abar),
                             sigma=f32(np.sqrt(beta_tilde)), t_embed=t_embed)


def schedule_from_cfg(diffusion_cfg, fast: bool = False) -> DiffusionSchedule:
    """From a ``diffusion:`` config block (T, beta_0, beta_T, beta, and
    optionally align / fast_steps / fast_shape)."""
    beta = diffusion_cfg.get("beta")
    if fast and beta is None and diffusion_cfg.get("fast_steps"):
        beta = fast_beta_list(int(diffusion_cfg["fast_steps"]),
                              str(diffusion_cfg.get("fast_shape", "canon")))
    return diffusion_schedule(
        T=int(diffusion_cfg["T"]), beta_0=float(diffusion_cfg["beta_0"]),
        beta_T=float(diffusion_cfg["beta_T"]), beta=beta, fast=fast,
        align=bool(diffusion_cfg.get("align", True)))
