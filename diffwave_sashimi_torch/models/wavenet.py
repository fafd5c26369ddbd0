"""DiffWave's WaveNet backbone: dilated-conv residual eps-prediction network.

Port of ``diffwave_sashimi_tpu/models/wavenet.py`` with the reference's
state-dict names (``init_conv.0.conv.*``, ``residual_layer.fc_t1/fc_t2``,
``residual_layer.residual_blocks.{n}.*``, ``final_conv.{0,2}.conv.*``):

  init 1x1 conv + ReLU
  -> num_res_layers residual blocks (dilation 2^(n % dilation_cycle)):
       h = x + fc_t(embed)[..., None]
       h = dilated k=3 conv(h) -> 2C channels   (F.conv1d: cuDNN on the card)
       [conditional] h += mel_conv(upsampled mel)
       res, skip = the tail (ops.gate, kernel 11): tanh/sigmoid gate, then
                   (x + res_conv(out)) sqrt(1/2) and skip_conv(out)
  -> sum of skips * sqrt(1 / num_res_layers)
  -> 1x1 conv -> ReLU -> zero-init 1x1 conv

The diffusion-step embedding goes through the two shared swish FC layers
(fc_t1/fc_t2) and one FC per block (fc_t).  At eval time every block's tail
goes through ``ops.gate`` at any length (the JAX guard L % 128 == 0 is a TPU
lane constraint); ``train=True`` differentiates the plain tail
(``gate_res_skip_ref``) under autograd at either precision, as the JAX
training path has no kernel there; with ``remat`` (``compute.remat``)
each block runs under an activation checkpoint (:mod:`.remat`).  A
block's mel term
depends only on the mel and the parameters, so :meth:`WaveNet.
compute_mel_conds` may compute all of them once per run (the JAX package
recomputes them every step; the function is the same).

``dtype=torch.bfloat16`` is the JAX package's bf16 policy (models/
wavenet.py:128-170): the audio is cast once, the step embedding is made in
f32 and cast, every conv and linear layer runs on bf16 activations (f32
accumulation, ops/conv.py), the mel is cast before its terms are
computed, the tail takes kernel 11f, the skip sum accumulates in bf16 and
is scaled by sqrt(1 / num_res_layers) rounded to bf16, as JAX's is, and
eps is returned as f32.  The parameters stay f32.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from ..ops import FUSED, Ops, gate_res_skip_ref, widen
from ..ops.conv import (TorchLinear, WNConv1d, ZeroConv1d, swish,
                        weight_norm, weight_norm_params)
from ..ops.mel_upsample import MelUpsampler
from .embedding import diffusion_step_embedding
from .remat import checkpointed


class ResidualBlock(nn.Module):
    """fc_t -> dilated conv [+ mel term] -> gate + res/skip tail (keys fc_t,
    dilated_conv_layer.conv.*, res_conv.*, skip_conv.*; conditional:
    upsample_conv2d.{0,1}.*, mel_conv.conv.*)."""

    def __init__(self, res_channels: int, skip_channels: int, dilation: int,
                 diffusion_step_embed_dim_out: int = 512,
                 unconditional: bool = True,
                 mel_upsample: Sequence[int] = (16, 16),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        C, g = res_channels, generator
        self.fc_t = TorchLinear(diffusion_step_embed_dim_out, C, generator=g)
        self.dilated_conv_layer = WNConv1d(C, 2 * C, kernel_size=3,
                                           dilation=dilation, generator=g)
        if not unconditional:
            self.upsample_conv2d = MelUpsampler(mel_upsample, g)
            self.mel_conv = WNConv1d(80, 2 * C, generator=g)
        # the reference's res/skip 1x1 convs have no ``.conv`` level
        self.res_conv = weight_norm_params(C, C, generator=g)
        self.skip_conv = weight_norm_params(C, skip_channels, generator=g)

    def compute_mel_cond(self, mel: torch.Tensor, L: int) -> torch.Tensor:
        """``mel_conv(upsample(mel))``, (B, 2C, L) for mel (B, 80, frames)."""
        return self.mel_conv(self.upsample_conv2d(mel, L))

    def forward(self, x, embed, ops: Ops = FUSED, train: bool = False,
                mel_cond=None, mel=None):
        """(block output (B, C, L), skip (B, S, L)); the mel term is
        ``mel_cond``, or computed here from ``mel``."""
        if mel is not None:
            mel_cond = self.compute_mel_cond(mel, x.shape[-1])
        h = x + self.fc_t(embed)[:, :, None]
        h = self.dilated_conv_layer(h)
        if mel_cond is not None:
            h = h + mel_cond
        tail = gate_res_skip_ref if train else ops.gate
        return tail(h, x, weight_norm(self.res_conv)[:, :, 0],
                    self.res_conv["bias"],
                    weight_norm(self.skip_conv)[:, :, 0],
                    self.skip_conv["bias"])


class WaveNet(nn.Module):
    """eps_theta((x_t, t), mel) with the reference constructor surface."""

    def __init__(self, in_channels: int = 1, res_channels: int = 256,
                 skip_channels: int = 128, out_channels: int = 1,
                 num_res_layers: int = 30, dilation_cycle: int = 10,
                 diffusion_step_embed_dim_in: int = 128,
                 diffusion_step_embed_dim_mid: int = 512,
                 diffusion_step_embed_dim_out: int = 512,
                 unconditional: bool = True,
                 mel_upsample: Sequence[int] = (16, 16),
                 remat: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.remat = remat      # the training form checkpoints each block
        self.unconditional = unconditional
        self.act_dtype = dtype          # the parameters stay f32
        self.embed_dim_in = diffusion_step_embed_dim_in
        self.init_conv = nn.Sequential(
            WNConv1d(in_channels, res_channels, generator=g), nn.ReLU())
        # the shared step-embedding MLP and the blocks (reference keys
        # residual_layer.fc_t1/fc_t2 and residual_layer.residual_blocks.{n})
        self.residual_layer = nn.ModuleDict({
            "fc_t1": TorchLinear(diffusion_step_embed_dim_in,
                                 diffusion_step_embed_dim_mid, generator=g),
            "fc_t2": TorchLinear(diffusion_step_embed_dim_mid,
                                 diffusion_step_embed_dim_out, generator=g),
            "residual_blocks": nn.ModuleList([
                ResidualBlock(res_channels, skip_channels,
                              2 ** (n % dilation_cycle),
                              diffusion_step_embed_dim_out, unconditional,
                              mel_upsample, g)
                for n in range(num_res_layers)])})
        self.final_conv = nn.Sequential(
            WNConv1d(skip_channels, skip_channels, generator=g), nn.ReLU(),
            ZeroConv1d(skip_channels, out_channels))

    def compute_kernels(self, audio_length: int, ops: Ops = FUSED,
                        train: bool = False) -> List[torch.Tensor]:
        """No S4 kernels to build (the sampler's interface): []."""
        return []

    def unreached_in_training(self) -> List[str]:
        """The parameters the training loss never reaches: the last
        block's res_conv, whose block output feeds nothing (torch leaves
        their gradients None, JAX gives zeros); data parallelism leaves
        them out of its reduction."""
        last = len(self.residual_layer["residual_blocks"]) - 1
        return [f"residual_layer.residual_blocks.{last}.res_conv.{k}"
                for k in ("weight_v", "weight_g", "bias")]

    def compute_mel_conds(self, mel: torch.Tensor,
                          audio_length: int) -> List[torch.Tensor]:
        """Every block's mel term (B, 2C, L) for mel (B, 80, frames), in
        block order and the activation dtype: a pure function of the mel
        and the parameters."""
        mel = mel.to(self.act_dtype)
        return [b.compute_mel_cond(mel, audio_length)
                for b in self.residual_layer["residual_blocks"]]

    def forward(self, audio: torch.Tensor, steps: torch.Tensor,
                kernels: Optional[List[torch.Tensor]] = None,
                ops: Ops = FUSED, train: bool = False,
                mel: Optional[torch.Tensor] = None,
                mel_conds: Optional[List[torch.Tensor]] = None
                ) -> torch.Tensor:
        """audio (B, in_channels, L), steps (B,) -> eps (B, out_channels,
        L).  ``kernels`` is accepted for the sampler's interface and unused.
        The conditional model takes ``mel`` (B or 1, 80, frames), each block
        computing its term, or the terms from :meth:`compute_mel_conds`."""
        conditioned = mel is not None or mel_conds is not None
        if conditioned == self.unconditional:
            raise ValueError("a conditional model takes a mel (mel or "
                             "mel_conds), an unconditional one none")
        group = self.residual_layer
        blocks = group["residual_blocks"]
        dtype = self.act_dtype
        x = self.init_conv(audio.to(dtype))
        embed = diffusion_step_embedding(steps, self.embed_dim_in).to(dtype)
        embed = swish(group["fc_t2"](swish(group["fc_t1"](embed))))
        mel = None if mel is None else mel.to(dtype)
        skip_sum = None
        for n, block in enumerate(blocks):
            args = (x, embed, ops, train,
                    None if mel_conds is None else mel_conds[n], mel)
            x, skip = (checkpointed(block, *args) if train and self.remat
                       else block(*args))
            skip_sum = skip if skip_sum is None else skip_sum + skip
        # the scale as a scalar of the activations' dtype, as JAX's
        scale = torch.tensor(math.sqrt(1.0 / len(blocks)), dtype=dtype).item()
        return widen(self.final_conv(skip_sum * scale))
