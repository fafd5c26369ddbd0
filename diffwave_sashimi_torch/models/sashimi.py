"""SaShiMi backbone: S4-based UNet eps-prediction network.

Port of ``diffwave_sashimi_tpu/models/sashimi.py`` with the reference's
ModuleList layout and state-dict names (``d_layers.{i}``, ``c_layers.{j}``,
``u_layers.{i}``, ``init_conv.0.conv.*``, ``final_conv.{0,2}.conv.*``):

  init 1x1 conv + ReLU
  -> per pool factor: n_layers DiffWaveBlocks (if unet), DownPool
  -> n_layers centre blocks, + centre skip
  -> per pool factor (reversed): UpPool + pool skip, n_layers blocks each
     followed by the matching down block's input (UNet skip, reverse order)
  -> TransposedLN -> 1x1 conv -> ReLU -> zero-init 1x1 conv

Each DiffWaveBlock runs the fused eval form of the JAX package
(models/sashimi.py:222-254) as three kernels: norm1 + step bias + S4 conv +
D-skip + GELU (kernel 1, or kernel 9 past kernel 1's FFT sizes), output
linear + GLU + residual (kernel 2), and norm2 + FF + residual + UNet skip
(kernel 3), which also emits the channel statistics the next block's norm1
needs; only the first block after a pool computes them itself.  With ``train=True`` each block runs the training
form (JAX models/sashimi.py:193-220): norm1 and the step bias in autograd,
then the S4 training path (its conv by kernels 1 and 5 up to FFT size
32768, by kernel 9's training entries and kernel 5L past it, up to 2^20),
then norm2 + FF + residual + UNet skip as one differentiable Function
(kernels 3 and 7); the S4 kernels are rebuilt with gradients in every
forward.

The conditional (vocoder) model adds, in every block, ``mel_conv(upsample(
mel))`` to the residual that kernel 2 adds (JAX models/sashimi.py:237-242,
equal to the reference's post-S4 add).  The term depends only on the mel
and the parameters, so :meth:`Sashimi.compute_mel_conds` computes all 30
once per run, like the S4 kernels; the training form computes each
block's term in the block, under autograd, and adds it to the same
residual.  At a pooled tier it is the full-rate upsampled mel cut to that
tier's length, as in the JAX package and the reference.

``dtype=torch.bfloat16`` is the JAX package's bf16 policy (models/
sashimi.py:725, :739-743): the input is cast once, activations, skips and
pool outputs are bf16, the step embedding is made in f32 and cast,
channel statistics (norm1, TransposedLN, kernel 3's emitted ones) are
f32, the S4 spectra stay complex64, the kernels take their bf16 forms
(sampling: 1f or, past kernel 1's FFT sizes, 9f, 2f, 3f, or 12 with the
int8 ops; training: 1f, 2f, 3f forward, 1f, 5f, 6f, 7f backward, and past
kernel 1's FFT sizes kernel 9 on the widened activations and kernel 5L on
the bf16 ones) and eps is returned as f32.  The parameters, and
so their gradients, stay f32.  The mel is cast to bf16 before its terms
are computed, so they and the residual ``x + mel_cond`` are bf16 too.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from ..ops import FUSED, Ops, chmix, widen
from ..ops.conv import TorchLinear, WNConv1d, ZeroConv1d, swish
from ..ops.fftconv_long import MAX_N
from ..ops.mel_upsample import MelUpsampler
from .embedding import diffusion_step_embedding
from .s4 import S4

def check_train_length(L: int, device_type: str) -> None:
    """Raise ValueError, before anything runs, where the card cannot train
    on sequences of L samples: past the long conv's FFT size MAX_N (n =
    the power of two >= 2L; kernels 9 and 5L stop there).  Up to it every
    length trains at either precision, through kernels 1 and 5 up to FFT
    size 32768 and kernel 9's training entries and kernel 5L past it; the
    CPU's plain path trains any length, as JAX does."""
    n = 1 << (2 * L - 1).bit_length()
    if device_type == "cuda" and n > MAX_N:
        raise ValueError(f"FFT size {n} (L {L}) is past the long conv's "
                         f"{MAX_N}: training segment too long for the card")


def check_mixer_widths(d_model: int, expand: int, n_pools: int, ff: int,
                       dtype: torch.dtype, train: bool) -> None:
    """Raise NotImplementedError, naming the width, where a channel-mixer
    kernel (2 and 3 at sampling, 6 and 7 too in training; their f forms
    at bf16) does not take a UNet tier's widths (H = d_model expand^i, F =
    ff H): the card runs every block through these kernels.  Every tier
    of d_model 128 and 256 passes."""
    H = d_model
    for _ in range(n_pools + 1):
        why = [chmix.glu_refusal(H, dtype),
               chmix.ff_refusal(H, ff * H, dtype)]
        if train:
            why += [chmix.glu_bwd_refusal(H, dtype),
                    chmix.ff_bwd_refusal(H, ff * H, dtype)]
        why = next((w for w in why if w), None)
        if why:
            raise NotImplementedError(
                f"{why}; on the card these widths are not ported: "
                "ROADMAP.md queue 1, item 8")
        H *= expand


class TransposedLN(nn.Module):
    """LayerNorm over the channel axis with scalar affine (m, s): population
    std and no eps, so ``nn.LayerNorm`` is not a drop-in."""

    def __init__(self):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(1))
        self.s = nn.Parameter(torch.ones(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Statistics and normalisation in f32; the result in x's dtype."""
        x32 = widen(x)
        var, mean = torch.var_mean(x32, dim=1, unbiased=False, keepdim=True)
        return ((self.s / torch.sqrt(var)) * (x32 - mean + self.m)).to(
            x.dtype)


class DownPool(nn.Module):
    """(B, H, L) -> (B, H_out, L / pool): h-major reshape + 1x1 conv."""

    def __init__(self, d_input: int, d_output: int, pool: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pool = pool
        self.linear = WNConv1d(d_input * pool, d_output, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, L = x.shape
        s = self.pool
        # '... h (l s) -> ... (h s) l'
        x = x.reshape(B, H, L // s, s).transpose(2, 3)
        return self.linear(x.reshape(B, H * s, L // s))


class UpPool(nn.Module):
    """(B, H_in, L) -> (B, H_out, L * pool): 1x1 conv + DownPool's inverse
    reshape."""

    def __init__(self, d_input: int, d_output: int, pool: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pool = pool
        self.linear = WNConv1d(d_input, d_output * pool, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.linear(x)
        B, Hs, L = x.shape
        s = self.pool
        # '... (h s) l -> ... h (l s)'
        return x.reshape(B, Hs // s, s, L).transpose(2, 3).reshape(
            B, Hs // s, L * s)


class DiffWaveBlock(nn.Module):
    """norm1 -> + step bias -> bidirectional S4 -> residual [+ mel term]
    -> norm2 -> FF -> residual (reference keys fc_t, norm1, norm2, layer,
    ff.ff.{0,2}; conditional: upsample_conv2d.{0,1}, mel_conv)."""

    def __init__(self, d_model: int, L: int, ff: int = 2,
                 diffusion_step_embed_dim_out: int = 512,
                 unconditional: bool = True,
                 mel_upsample: Sequence[int] = (16, 16),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        H = d_model
        self.fc_t = TorchLinear(diffusion_step_embed_dim_out, H,
                                generator=generator)
        self.layer = S4(H, l_max=L, bidirectional=True, generator=generator)
        self.norm1 = TransposedLN()
        self.norm2 = TransposedLN()
        self.ff = nn.ModuleDict({"ff": nn.Sequential(
            WNConv1d(H, ff * H, generator=generator), nn.GELU(),
            WNConv1d(ff * H, H, generator=generator))})
        if not unconditional:
            self.upsample_conv2d = MelUpsampler(mel_upsample, generator)
            self.mel_conv = WNConv1d(80, H, generator=generator)

    def compute_mel_cond(self, mel: torch.Tensor, L_gen: int) -> torch.Tensor:
        """``mel_conv(upsample(mel))[..., :L_gen]``, (B, H, L_gen) for mel
        (B, 80, frames) (JAX models/sashimi.py:160-175, flat layout)."""
        return self.mel_conv(self.upsample_conv2d(mel, L_gen))

    def forward(self, x, embed, khat, stats=None, skip=None,
                ops: Ops = FUSED, mel_cond=None):
        """Returns (out, (mean, var)): the block output [+ skip] and its
        channel statistics per position.  ``stats`` are x's, when known;
        ``mel_cond`` (B or 1, H, L) joins kernel 2's residual."""
        bias = self.fc_t(embed)                                # (B, H)
        if stats is None:
            var, mean = torch.var_mean(widen(x), dim=1, unbiased=False)
        else:
            mean, var = stats
        a = self.norm1.s * torch.rsqrt(var)                    # (B, L)
        c = (self.norm1.m - mean) * a
        res = x if mel_cond is None else x + mel_cond
        x = self.layer(x, khat, a, c, bias, residual=res, ops=ops)
        ff1, ff2 = self.ff["ff"][0], self.ff["ff"][2]
        out, mean, var = ops.ff(
            x, self.norm2.m, self.norm2.s, ff1.effective_weight()[:, :, 0],
            ff1.bias, ff2.effective_weight()[:, :, 0], ff2.bias, skip=skip,
            emit_stats=True)
        return out, (mean, var)

    def forward_train(self, x, embed, khat, skip=None, ops: Ops = FUSED,
                      mel_cond=None):
        """The differentiable block: out [+ skip].  ``mel_cond`` (B or 1,
        H, L) joins the residual that the GLU kernel (2 and 6, or 2f and
        6f) takes, in x's dtype (JAX models/sashimi.py:204-210); its
        gradient reaches the upsampler and mel_conv through autograd of
        that sum."""
        y = self.norm1(x) + self.fc_t(embed)[:, :, None]
        res = x if mel_cond is None else x + mel_cond.to(x.dtype)
        x = self.layer.forward_train(y, khat, residual=res, ops=ops)
        ff1, ff2 = self.ff["ff"][0], self.ff["ff"][2]
        return ops.ff_train(
            x, self.norm2.m, self.norm2.s, ff1.effective_weight()[:, :, 0],
            ff1.bias, ff2.effective_weight()[:, :, 0], ff2.bias, skip=skip)


class Sashimi(nn.Module):
    """eps_theta((x_t, t), mel) with the reference constructor surface."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 d_model: int = 64, n_layers: int = 8,
                 pool: Sequence[int] = (4, 4), expand: int = 2, ff: int = 2,
                 unet: bool = True, diffusion_step_embed_dim_in: int = 128,
                 diffusion_step_embed_dim_mid: int = 512,
                 diffusion_step_embed_dim_out: int = 512,
                 unconditional: bool = True,
                 mel_upsample: Sequence[int] = (16, 16), L: int = 16000,
                 dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dropout:
            raise NotImplementedError("S4 dropout (DropoutNd) is not ported "
                                      "yet: ROADMAP.md queue 1, item 7")
        g = generator
        self.pool, self.unet = tuple(pool), unet
        self.unconditional = unconditional
        self.embed_dim_in = diffusion_step_embed_dim_in
        self.act_dtype = dtype          # the parameters stay f32
        H = d_model

        def block(H, L):
            return DiffWaveBlock(H, L, ff, diffusion_step_embed_dim_out,
                                 unconditional, mel_upsample, g)

        self.init_conv = nn.Sequential(WNConv1d(in_channels, H, generator=g),
                                       nn.ReLU())
        self.fc_t1 = TorchLinear(diffusion_step_embed_dim_in,
                                 diffusion_step_embed_dim_mid, generator=g)
        self.fc_t2 = TorchLinear(diffusion_step_embed_dim_mid,
                                 diffusion_step_embed_dim_out, generator=g)
        d_layers = []
        for p in self.pool:
            if unet:
                d_layers += [block(H, L) for _ in range(n_layers)]
            d_layers.append(DownPool(H, H * expand, p, generator=g))
            L //= p
            H *= expand
        self.d_layers = nn.ModuleList(d_layers)
        self.c_layers = nn.ModuleList([block(H, L) for _ in range(n_layers)])
        u_layers = []
        for p in self.pool[::-1]:
            H //= expand
            L *= p
            u_layers.append(UpPool(H * expand, H, p, generator=g))
            u_layers += [block(H, L) for _ in range(n_layers)]
        self.u_layers = nn.ModuleList(u_layers)
        self.norm = TransposedLN()
        self.final_conv = nn.Sequential(WNConv1d(H, H, generator=g), nn.ReLU(),
                                        ZeroConv1d(H, out_channels))

    def _blocks(self, audio_length: int):
        """(block, its sequence length) for every block, in block order."""
        L, out = audio_length, []
        for layer in self.d_layers:
            if isinstance(layer, DownPool):
                L //= layer.pool
            else:
                out.append((layer, L))
        out += [(b, L) for b in self.c_layers]
        for layer in self.u_layers:
            if isinstance(layer, UpPool):
                L *= layer.pool
            else:
                out.append((layer, L))
        return out

    def compute_kernels(self, audio_length: int, ops: Ops = FUSED,
                        train: bool = False) -> List[torch.Tensor]:
        """Every block's conv-kernel spectrum for sequences of
        ``audio_length`` samples, in block order.  A pure function of the
        parameters: the sampler computes it once for all T steps.  For the
        sampling form each spectrum comes in the layout of the conv kernel
        that takes its FFT size (``ops.spectrum``); ``train`` keeps the
        half spectra of the training conv."""
        blocks = self._blocks(audio_length)
        out = [b.layer.compute_kernel_freq(L, ops) for b, L in blocks]
        if train:
            return out
        return [ops.spectrum(k, L) for k, (_, L) in zip(out, blocks)]

    def unreached_in_training(self) -> List[str]:
        """The parameters the training loss never reaches: none (data
        parallelism reduces every gradient)."""
        return []

    def compute_mel_conds(self, mel: torch.Tensor,
                          audio_length: int) -> List[torch.Tensor]:
        """Every block's mel term (B, H, L_tier) for mel (B, 80, frames),
        in block order and the activation dtype: a pure function of the mel
        and the parameters, so the sampler computes it once for all T steps
        (JAX models/sashimi.py:673-698; one block at a time, which bounds
        the upsampler's transients)."""
        mel = mel.to(self.act_dtype)
        return [b.compute_mel_cond(mel, L)
                for b, L in self._blocks(audio_length)]

    def forward(self, audio: torch.Tensor, steps: torch.Tensor,
                kernels: Optional[List[torch.Tensor]] = None,
                ops: Ops = FUSED, train: bool = False,
                mel: Optional[torch.Tensor] = None,
                mel_conds: Optional[List[torch.Tensor]] = None
                ) -> torch.Tensor:
        """audio (B, in_channels, L), steps (B,) -> eps (B, out_channels, L).
        ``kernels`` from :meth:`compute_kernels` (computed here if None).
        ``train`` runs the differentiable training form of every block.
        The conditional model takes ``mel`` (B or 1, 80, frames), each
        block computing its term, or the terms from
        :meth:`compute_mel_conds`."""
        if audio.shape[-1] % math.prod(self.pool):
            raise ValueError(f"audio length {audio.shape[-1]} must divide "
                             f"the pooling {self.pool}")
        conditioned = mel is not None or mel_conds is not None
        if conditioned == self.unconditional:
            raise ValueError("a conditional model takes a mel (mel or "
                             "mel_conds), an unconditional one none")
        if train:
            check_train_length(audio.shape[-1], audio.device.type)
        if kernels is None:
            kernels = self.compute_kernels(audio.shape[-1], ops, train)
        khats = iter(kernels)
        conds = None if mel_conds is None else iter(mel_conds)
        mel = None if mel is None else mel.to(self.act_dtype)
        x = self.init_conv(audio.to(self.act_dtype))
        embed = diffusion_step_embedding(steps, self.embed_dim_in).to(
            self.act_dtype)
        embed = swish(self.fc_t2(swish(self.fc_t1(embed))))

        def block(layer, x, stats, skip=None):
            cond = next(conds) if conds is not None else (
                None if mel is None
                else layer.compute_mel_cond(mel, x.shape[-1]))
            if train:
                return layer.forward_train(x, embed, next(khats), skip,
                                           ops=ops, mel_cond=cond), None
            return layer(x, embed, next(khats), stats, skip=skip, ops=ops,
                         mel_cond=cond)

        outputs, stats = [], None
        for layer in self.d_layers:
            outputs.append(x)
            if isinstance(layer, DownPool):
                x, stats = layer(x), None
            else:
                x, stats = block(layer, x, stats)
        outputs.append(x)
        stats = None
        for layer in self.c_layers:
            x, stats = block(layer, x, stats)
        x = x + outputs.pop()
        for layer in self.u_layers:
            if isinstance(layer, UpPool):
                x, stats = layer(x) + outputs.pop(), None
            else:
                skip = outputs.pop() if self.unet else None
                x, stats = block(layer, x, stats, skip)
        return widen(self.final_conv(self.norm(x)))
