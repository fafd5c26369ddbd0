"""Conv/linear primitives in the (B, C, L) layout with the reference's
initialisation and state-dict names.

Port of ``diffwave_sashimi_tpu/ops/conv.py``.  The reference wraps each conv
in ``weight_norm`` (keys ``<name>.conv.weight_v`` / ``.weight_g`` /
``.bias``); its later ``kaiming_normal_`` on the materialised weight is a
no-op, so the effective init is torch's default U(+-1/sqrt(fan_in)) for v
and the bias, with g = ||v|| per output channel.  These convolutions run
outside the fused kernels, as plain ``F.conv1d`` / ``torch.matmul``: the 1x1
convs, and WaveNet's dilated k=3 conv, which the JAX package also leaves to
XLA (its shifted-matmul form is a TPU workaround and is not ported).

bf16 activations follow the JAX package's policy (ops/conv.py:94-97,
:116-119, :135-142): the weights are rounded to bf16 for the product,
which accumulates in f32; ``WNConv1d`` rounds the product to bf16 and adds
the bf16-rounded bias in bf16, ``ZeroConv1d`` and ``TorchLinear`` add the
f32 bias to the f32 sum and round once.  The parameters stay f32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .fftconv import as_operand


def torch_uniform_(t: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """torch's default kaiming_uniform(a=sqrt(5)) == U(+-1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def weight_norm_params(in_channels: int, out_channels: int,
                       kernel_size: int = 1,
                       generator: Optional[torch.Generator] = None
                       ) -> nn.ParameterDict:
    """A weight-normalised conv's parameters ``weight_v`` (O, I, K),
    ``weight_g`` (O, 1, 1) = ||v|| and ``bias`` (O,), with fan-in I * K.
    Held directly by a module, the keys sit at that module's level (the
    reference's ``res_conv.weight_v``)."""
    fan_in = in_channels * kernel_size
    v = torch_uniform_(torch.empty(out_channels, in_channels, kernel_size),
                       fan_in, generator)
    g = v.square().sum(dim=(1, 2), keepdim=True).sqrt()
    b = torch_uniform_(torch.empty(out_channels), fan_in, generator)
    return nn.ParameterDict({"weight_v": nn.Parameter(v),
                             "weight_g": nn.Parameter(g),
                             "bias": nn.Parameter(b)})


def weight_norm(p: nn.ParameterDict) -> torch.Tensor:
    """W = g * v / ||v||, norm over axes (1, 2); shape (O, I, K)."""
    v = p["weight_v"]
    g = p["weight_g"].reshape(-1, 1, 1)
    return g * v / v.square().sum(dim=(1, 2), keepdim=True).sqrt()


class WNConv1d(nn.Module):
    """Weight-normalised Conv1d with 'same' padding of
    ``dilation * (kernel_size - 1) // 2`` (1x1 unless asked).

    Parameters sit in a ``conv`` dict so the state-dict keys read
    ``conv.weight_v`` (O, I, K), ``conv.weight_g`` (O, 1, 1) and
    ``conv.bias`` (O,), as under the reference's ``Conv`` wrapper."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, dilation: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dilation = dilation
        self.padding = dilation * (kernel_size - 1) // 2
        self.conv = weight_norm_params(in_channels, out_channels,
                                       kernel_size, generator)

    def effective_weight(self) -> torch.Tensor:
        return weight_norm(self.conv)

    @property
    def bias(self) -> torch.Tensor:
        return self.conv["bias"]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.effective_weight()
        if x.dtype != torch.bfloat16:
            return F.conv1d(x, w, self.bias, padding=self.padding,
                            dilation=self.dilation)
        y = F.conv1d(x, w.to(x.dtype), padding=self.padding,
                     dilation=self.dilation)
        return y + self.bias.to(x.dtype)[:, None]


class ZeroConv1d(nn.Module):
    """1x1 conv with zero-initialised weight and bias (key ``conv.*``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size=1)
        with torch.no_grad():
            self.conv.weight.zero_()
            self.conv.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.bfloat16:
            return self.conv(x)
        return F.conv1d(x.float(), as_operand(self.conv.weight, x.dtype),
                        self.conv.bias).to(x.dtype)


class TorchLinear(nn.Linear):
    """nn.Linear whose default init draws from an explicit generator."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features)
        torch_uniform_(self.weight, in_features, generator)
        torch_uniform_(self.bias, in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.bfloat16:
            return super().forward(x)
        return F.linear(x.float(), as_operand(self.weight, x.dtype),
                        self.bias).to(x.dtype)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)
