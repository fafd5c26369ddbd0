"""Mel-spectrogram upsampler of the conditional DiffWave block.

Port of ``diffwave_sashimi_tpu/ops/mel_upsample.py`` (the reference's
conditioner): per factor s, a weight-normalised ``ConvTranspose2d(1, 1,
(3, 2s), stride (1, s), padding (1, s // 2))`` on the (80, frames) mel
image, then ``leaky_relu(0.4)``; the result, frames x prod(s) samples
long, is cut to the requested length.  A plain ``F.conv_transpose2d``:
no TPU kernel stands behind it.

The upsampler runs at its input's dtype.  bf16 follows the JAX package's
policy (ops/mel_upsample.py:56-70): the mel and the effective weight are
rounded to bf16 for the transpose conv, which accumulates in f32, the f32
bias is added and the sum rounded to bf16, and ``leaky_relu`` runs on the
bf16 tensor.

:class:`MelUpsampler` is a ModuleList of the stages, so a block holding it
as ``upsample_conv2d`` has the reference's state-dict keys
``upsample_conv2d.{i}.weight_v`` (1, 1, 3, 2s), ``.weight_g`` (1, 1, 1, 1)
and ``.bias`` (1,).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .conv import torch_uniform_
from .fftconv import as_operand


class WNConvTranspose2d(nn.Module):
    """One (3, 2s) transpose-conv stage; torch's default init of a
    ConvTranspose2d (fan_in = out_channels * kh * kw = 6s) with
    g = ||v||."""

    def __init__(self, s: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.s = s
        fan_in = 3 * 2 * s
        v = torch_uniform_(torch.empty(1, 1, 3, 2 * s), fan_in, generator)
        self.weight_v = nn.Parameter(v)
        self.weight_g = nn.Parameter(v.square().sum().sqrt().reshape(1, 1, 1,
                                                                     1))
        self.bias = nn.Parameter(torch_uniform_(torch.empty(1), fan_in,
                                                generator))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, 1, M, T) -> (B, 1, M, s T), in mel's dtype."""
        v = self.weight_v
        w = self.weight_g * v / v.square().sum().sqrt()
        return F.conv_transpose2d(
            mel.float(), as_operand(w, mel.dtype), self.bias,
            stride=(1, self.s), padding=(1, self.s // 2)).to(mel.dtype)


class MelUpsampler(nn.ModuleList):
    """The transpose-conv stages with leaky_relu(0.4), cut to length."""

    def __init__(self, factors: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__([WNConvTranspose2d(s, generator) for s in factors])
        self.hop = math.prod(factors)

    def forward(self, mel: torch.Tensor, out_length: int) -> torch.Tensor:
        """mel (B, M, T) -> (B, M, out_length), out_length <= T * hop, in
        mel's dtype."""
        if out_length > mel.shape[-1] * self.hop:
            raise ValueError(f"upsampled mel length {mel.shape[-1]} x "
                             f"{self.hop} < audio length {out_length}")
        x = mel[:, None]
        for stage in self:
            x = F.leaky_relu(stage(x), 0.4)
        return x[:, 0, :, :out_length]
