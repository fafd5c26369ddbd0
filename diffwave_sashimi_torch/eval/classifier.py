"""SC09 digit classifier: features and class probabilities for FID and IS.

Port of ``diffwave_sashimi_tpu/eval/classifier.py``.  The SaShiMi and
DiffWave papers score SC09 samples with a spoken-digit classifier
(arXiv:2202.09729 §4); none ships with the reference, so the harness
trains its own: a compact log-mel CNN (:class:`MelCNN`), checkpointed to
disk, then used to extract (pooled features, class probabilities) for
FID and IS.  Absolute values depend on the classifier; compare runs
scored with the same checkpoint.

The checkpoint is the JAX package's file: a pickle of numpy arrays in
flax's layout, ``{"params": {"params": {conv0-3: {kernel (3, 3, I, O),
bias}, ln0-3: {scale, bias}, head: {kernel (in, out), bias}}}, "meta":
...}``.  :func:`load_classifier` reads it into the module and
:func:`save_classifier` writes the module back in it, so either package
loads the other's classifier.  What the module does to match flax:

- ``nn.Conv`` pads ``SAME``: at kernel 3 and stride 2 an even length pads
  (0, 1) and an odd one (1, 1), so each layer pads explicitly
  (:func:`same_pads`);
- ``nn.LayerNorm`` normalises each position over its channels with
  epsilon 1e-6 and the variance E[x^2] - E[x]^2 (:class:`ChannelLayerNorm`);
- conv kernels are HWIO over (B, mels, frames, 1), so the module takes that
  layout and runs NCHW with OIHW weights (``kernel.permute(3, 2, 0, 1)``).

The network runs on the card unless a ``device`` asks for the CPU, with
TF32 off (f32 means f32, as in the port's f32 paths); the log-mel front end
is numpy on the host (:mod:`..data.stft`).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..data.stft import TacotronSTFT
from ..runtime.generate import resolve_device

SR = 16000
N_MELS = 40
N_FFT, HOP = 512, 128
N_CLASSES = 10
LABELS = ("zero", "one", "two", "three", "four",
          "five", "six", "seven", "eight", "nine")
LN_EPS = 1e-6                    # flax nn.LayerNorm's default epsilon


def mel_features(audio: np.ndarray) -> np.ndarray:
    """(B, L) float [-1,1] -> (B, n_mels, frames) log-mel at the
    classifier's front-end resolution."""
    stft = TacotronSTFT(N_FFT, HOP, N_FFT, N_MELS, SR, 0.0, SR / 2)
    return stft.mel_spectrogram(np.asarray(audio, np.float32))


def _prep(mel: np.ndarray) -> np.ndarray:
    """(B, mels, frames) -> (B, mels, frames, 1), mean/scale normalized."""
    x = (np.asarray(mel, np.float32) + 5.0) / 5.0
    return x[..., None]


def same_pads(n: int) -> Tuple[int, int]:
    """flax/XLA ``SAME`` padding (low, high) of a length-n axis for the
    3-tap, stride-2 convs: the output has ceil(n / 2) positions, the low
    side takes the smaller half."""
    total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
    return total // 2, total - total // 2


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator]) -> None:
    """flax's default kernel init: a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class ChannelLayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the channel axis of NCHW activations:
    y = (x - mean) (rsqrt(var + 1e-6) scale) + bias, var = E[x^2] -
    E[x]^2 clipped at 0."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(1, keepdim=True)
        var = ((x * x).mean(1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + LN_EPS) * self.scale[:, None, None]
        return (x - mean) * mul + self.bias[:, None, None]


class MelCNN(nn.Module):
    """4-block strided conv net over (B, mels, frames, 1) log-mels:
    conv 3x3 stride 2 (SAME) -> LayerNorm -> ReLU at widths w, 2w, 4w, 4w,
    a mean over positions (the features), a linear head (the logits)."""

    def __init__(self, width: int = 32, n_classes: int = N_CLASSES,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        chans = (1, width, 2 * width, 4 * width, 4 * width)
        self.conv = nn.ModuleList(nn.Conv2d(i, o, 3, stride=2)
                                  for i, o in zip(chans, chans[1:]))
        self.ln = nn.ModuleList(ChannelLayerNorm(o) for o in chans[1:])
        self.head = nn.Linear(4 * width, n_classes)
        with torch.no_grad():
            for c in self.conv:
                _lecun_normal_(c.weight, 9 * c.in_channels, generator)
                c.bias.zero_()
            _lecun_normal_(self.head.weight, 4 * width, generator)
            self.head.bias.zero_()

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, mels, frames, 1) -> (logits (B, classes), features (B,
        4w))."""
        x = x.permute(0, 3, 1, 2)
        for conv, ln in zip(self.conv, self.ln):
            x = F.pad(x, (*same_pads(x.shape[3]), *same_pads(x.shape[2])))
            x = torch.relu(ln(conv(x)))
        feats = x.mean(dim=(2, 3))
        return self.head(feats), feats


def _f32_only() -> None:
    """No TF32 in the convolutions and the head on the card: with it the
    features drift from the CPU's by about 1e-3."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@torch.no_grad()
def extract(model: MelCNN, audio: np.ndarray, batch: int = 64,
            device=None) -> Tuple[np.ndarray, np.ndarray]:
    """(probs (N, C), features (N, D)) for float [-1,1] audio (N, L).
    ``device`` defaults to the first card; the model is moved there."""
    device = resolve_device(device)
    _f32_only()
    model = model.to(device).eval()
    probs, feats = [], []
    for s in range(0, len(audio), batch):
        mel = torch.from_numpy(_prep(mel_features(audio[s:s + batch])))
        logits, f = model(mel.to(device))
        probs.append(torch.softmax(logits, dim=-1).cpu().numpy())
        feats.append(f.cpu().numpy())
    return np.concatenate(probs), np.concatenate(feats)


def params_tree(model: MelCNN) -> Dict[str, Dict[str, np.ndarray]]:
    """The module's weights as flax's ``params`` tree of numpy arrays."""
    def a(p, *perm):
        t = p.detach()
        return t.permute(*perm).cpu().numpy() if perm else t.cpu().numpy()
    tree = {}
    for i, (conv, ln) in enumerate(zip(model.conv, model.ln)):
        tree[f"conv{i}"] = {"kernel": a(conv.weight, 2, 3, 1, 0),
                            "bias": a(conv.bias)}
        tree[f"ln{i}"] = {"scale": a(ln.scale), "bias": a(ln.bias)}
    tree["head"] = {"kernel": a(model.head.weight, 1, 0),
                    "bias": a(model.head.bias)}
    return tree


def from_params_tree(tree: Dict[str, Dict[str, Any]]) -> MelCNN:
    """A module (on the CPU) carrying a flax ``params`` tree's weights."""
    def t(x):
        return torch.from_numpy(np.array(x, np.float32))
    width = int(np.shape(tree["conv0"]["kernel"])[-1])
    model = MelCNN(width, int(np.shape(tree["head"]["kernel"])[-1]))
    with torch.no_grad():
        for i, (conv, ln) in enumerate(zip(model.conv, model.ln)):
            conv.weight.copy_(t(tree[f"conv{i}"]["kernel"]).permute(3, 2, 0, 1))
            conv.bias.copy_(t(tree[f"conv{i}"]["bias"]))
            ln.scale.copy_(t(tree[f"ln{i}"]["scale"]))
            ln.bias.copy_(t(tree[f"ln{i}"]["bias"]))
        model.head.weight.copy_(t(tree["head"]["kernel"]).t())
        model.head.bias.copy_(t(tree["head"]["bias"]))
    return model


def save_classifier(path: str, model: MelCNN,
                    meta: Optional[Dict] = None) -> None:
    """Write the JAX package's checkpoint layout (a plain pickle of numpy
    arrays), which its ``load_classifier`` reads."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"params": {"params": params_tree(model)},
                     "meta": meta or {}}, f)


def load_classifier(path: str) -> Tuple[MelCNN, Dict]:
    """(module on the CPU, meta) from a checkpoint in the JAX package's
    layout (trusted input: a pickle this project writes)."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    return from_params_tree(blob["params"]["params"]), blob.get("meta", {})


def classifier_step(model: MelCNN, optimizer: torch.optim.Optimizer,
                    mel: torch.Tensor, labels: torch.Tensor
                    ) -> Tuple[float, float]:
    """One softmax cross-entropy step on a (B, mels, frames, 1) batch;
    (loss, accuracy) of the logits before the update, as JAX's step."""
    optimizer.zero_grad(set_to_none=True)
    logits, _ = model(mel)
    loss = F.cross_entropy(logits, labels)
    loss.backward()
    optimizer.step()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss.item(), acc.item()


def train_classifier(data_path: str, out_path: str, epochs: int = 5,
                     batch: int = 32, lr: float = 1e-3, seed: int = 0,
                     width: int = 32, log_every: int = 50,
                     device=None) -> Dict[str, Any]:
    """Train the mel-CNN on a labeled SC09 directory tree and checkpoint it
    (JAX's loop: ``RandomState(seed)`` permutations each epoch, full
    batches only, Adam at ``lr`` with optax's defaults).  Labels are the
    wav files' parent directory names mapped through ``LABELS`` (unknown
    labels are skipped).  ``device`` defaults to the first card."""
    from ..data.sc09 import SpeechCommands

    device = resolve_device(device)
    _f32_only()
    ds = SpeechCommands(data_path)
    keep = [(i, LABELS.index(ds.label(i))) for i in range(len(ds))
            if ds.label(i) in LABELS]
    if not keep:
        raise ValueError(f"no labeled digit wavs under {data_path}")
    idx = np.asarray([i for i, _ in keep])
    ys = np.asarray([y for _, y in keep], np.int64)

    model = MelCNN(width, generator=torch.Generator().manual_seed(seed))
    model = model.to(device).train()
    optimizer = torch.optim.Adam(model.parameters(), lr=lr)
    rng_np = np.random.RandomState(seed)
    it = 0
    last = {}
    for ep in range(epochs):
        order = rng_np.permutation(len(idx))
        for s in range(0, len(order) - batch + 1, batch):
            sel = order[s:s + batch]
            wavs = np.stack([ds[int(idx[i])][0][0] for i in sel])
            mel = torch.from_numpy(_prep(mel_features(wavs))).to(device)
            loss, acc = classifier_step(model, optimizer, mel,
                                        torch.from_numpy(ys[sel]).to(device))
            last = {"iter": it, "epoch": ep, "loss": loss, "acc": acc}
            if it % log_every == 0:
                print(f"[clf] ep {ep} it {it} loss {loss:.4f} "
                      f"acc {acc:.3f}", flush=True)
            it += 1
    save_classifier(out_path, model,
                    meta={"width": width, "epochs": epochs, **last})
    return {"model": model, **last}


__all__ = ["MelCNN", "mel_features", "extract", "train_classifier",
           "save_classifier", "load_classifier", "LABELS", "N_MELS", "HOP"]
