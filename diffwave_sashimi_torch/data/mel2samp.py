"""Mel2Samp: LJSpeech-style (mel, audio) pairs, and the mel precompute CLI.

Port of ``diffwave_sashimi_tpu/data/mel2samp.py``: every ``*.wav`` under
``data_path``, shuffled once with a fixed seed; training mode crops a
random ``segment_length`` window (zero-padded when shorter) and computes
its log-mel, ``valid`` mode keeps whole utterances; a file at another
sample rate raises.  The CLI precomputes spectrograms for a directory as
``<output_dir>/<name>.wav.npy``, which ``generate(mel_path=...)`` reads:

    python -m diffwave_sashimi_torch.data.mel2samp experiment=ljspeech \\
        dataset.data_path=<dir of wavs> +output_dir=<dir>
"""

from __future__ import annotations

import glob
import os
import sys
from typing import Optional, Tuple

import numpy as np

from .stft import TacotronSTFT
from .wav import MAX_WAV_VALUE, load_wav_raw


class Mel2Samp:
    def __init__(self, data_path: str, segment_length: int = 16000,
                 filter_length: int = 1024, hop_length: int = 256,
                 win_length: int = 1024, sampling_rate: int = 22050,
                 mel_fmin: float = 0.0, mel_fmax: Optional[float] = 8000.0,
                 valid: bool = False, n_mel_channels: int = 80,
                 seed: int = 1234, **_ignored):
        files = sorted(glob.glob(os.path.join(data_path, "*.wav")))
        order = np.random.RandomState(seed).permutation(len(files))
        self.files = [files[i] for i in order]
        self.segment_length = int(segment_length)
        self.sampling_rate = int(sampling_rate)
        self.hop_length = int(hop_length)
        self.valid = bool(valid)
        self.stft = TacotronSTFT(filter_length, hop_length, win_length,
                                 n_mel_channels, sampling_rate,
                                 mel_fmin, mel_fmax)
        self._rng = np.random.RandomState(seed + 1)

    def __len__(self) -> int:
        return len(self.files)

    def _load(self, path: str) -> np.ndarray:
        audio, sr = load_wav_raw(path)
        if sr != self.sampling_rate:
            raise ValueError(f"{path} SR {sr} doesn't match target SR "
                             f"{self.sampling_rate}")
        return audio

    def get_mel(self, audio: np.ndarray) -> np.ndarray:
        """Raw-scale (+-32768) audio (L,) -> log-mel (80, 1 + L // hop)."""
        audio_norm = np.asarray(audio, np.float32) / MAX_WAV_VALUE
        return self.stft.mel_spectrogram(audio_norm[None, :])[0]

    def crop(self, audio: np.ndarray,
             start: Optional[int] = None) -> np.ndarray:
        L = self.segment_length
        if len(audio) >= L:
            if start is None:
                start = int(self._rng.randint(0, len(audio) - L + 1))
            return audio[start:start + L]
        return np.pad(audio, (0, L - len(audio)))

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """(log-mel (80, frames), audio (1, L) in [-1, 1])."""
        audio = self._load(self.files[idx])
        if not self.valid:
            audio = self.crop(audio)
        audio_norm = (audio / MAX_WAV_VALUE).astype(np.float32)
        mel = self.stft.mel_spectrogram(audio_norm[None, :])[0]
        return mel, audio_norm[None, :]


def mel_file_path(output_dir: str, wav_path: str) -> str:
    return os.path.join(output_dir, os.path.basename(wav_path) + ".npy")


def load_mel_file(path: str) -> np.ndarray:
    """A precomputed spectrogram for ``path`` = ``<dir>/<name>.wav`` (the
    reference's mel_path convention): ``<path>.npy`` as the CLI writes it,
    else a torch file (``<dir>/<name>.pt``, ``<path>.pt`` or ``path``)."""
    npy = path + ".npy"
    if os.path.exists(npy):
        return np.load(npy)
    for cand in (path.replace(".wav", ".pt"), path + ".pt", path):
        if os.path.exists(cand):
            import torch
            t = torch.load(cand, map_location="cpu", weights_only=False)
            return np.asarray(t, np.float32)
    raise FileNotFoundError(f"no precomputed mel at {path}[.npy|.pt]")


def main(overrides=None) -> int:
    """Precompute the spectrogram of every wav in ``dataset.data_path``
    into ``+output_dir``; returns the number of files."""
    from ..config import load_config
    cfg = load_config(overrides=list(overrides if overrides is not None
                                     else sys.argv[1:]))
    output_dir = cfg["output_dir"]
    os.makedirs(output_dir, mode=0o775, exist_ok=True)
    ds_cfg = {k: v for k, v in dict(cfg.dataset).items()
              if k not in ("_name_", "valid")}
    ds = Mel2Samp(valid=True, **ds_cfg)
    for path in ds.files:
        mel = ds.get_mel(ds._load(path))
        out = mel_file_path(output_dir, path)
        np.save(out, mel)
        print(f"{path} -> {out} {mel.shape}", flush=True)
    return len(ds.files)


if __name__ == "__main__":
    main()
