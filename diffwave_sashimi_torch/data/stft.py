"""Mel-spectrogram front end of the vocoder, numpy.

Port of ``diffwave_sashimi_tpu/data/stft.py`` (the reference's Tacotron2
STFT stack): reflect-padded framing, periodic Hann window, magnitude
rfft, the Slaney-normalised mel filterbank (librosa ``htk=False,
norm='slaney'``), and log dynamic-range compression.  The inverse
transform and Griffin-Lim of the JAX package are not ported: nothing on
the vocoding path calls them.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np


def hann_window(n: int) -> np.ndarray:
    """Periodic (fftbins=True) Hann window."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)) \
        .astype(np.float32)


def _padded_window(n_fft: int, win_length: int) -> np.ndarray:
    """Window of win_length centre-padded to n_fft (librosa pad_center)."""
    w = hann_window(win_length)
    if win_length == n_fft:
        return w
    if win_length > n_fft:
        raise ValueError(f"win_length {win_length} > filter_length {n_fft}")
    lpad = (n_fft - win_length) // 2
    out = np.zeros(n_fft, np.float32)
    out[lpad:lpad + win_length] = w
    return out


def _frame(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """(B, L) -> (B, 1 + L // hop, n_fft) after reflect padding of n_fft//2
    on both sides."""
    pad = n_fft // 2
    x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    n_frames = 1 + (x.shape[-1] - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    return x[..., idx]


def stft_magnitude(audio: np.ndarray, n_fft: int, hop: int,
                   win_length: int) -> np.ndarray:
    """(B, L) float -> magnitude spectrogram (B, n_fft//2+1, n_frames)."""
    frames = _frame(np.asarray(audio, np.float32), n_fft, hop)
    spec = np.fft.rfft(frames * _padded_window(n_fft, win_length), axis=-1)
    return np.abs(np.swapaxes(spec, -1, -2)).astype(np.float32)


def _hz_to_mel(f):
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    f = np.asarray(f, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep, f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    m * f_sp)


@lru_cache(maxsize=8)
def _mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float,
                    fmax: float) -> np.ndarray:
    fftfreqs = np.linspace(0, sr / 2.0, n_fft // 2 + 1)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                   n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.astype(np.float32)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: Optional[float]) -> np.ndarray:
    """(n_mels, n_fft//2+1) Slaney-normalised triangular mel bank."""
    return _mel_filterbank(int(sr), int(n_fft), int(n_mels), float(fmin),
                           float(sr / 2.0 if fmax is None else fmax))


def dynamic_range_compression(x: np.ndarray, clip_val: float = 1e-5
                              ) -> np.ndarray:
    """log(clamp(x, 1e-5))."""
    return np.log(np.clip(x, clip_val, None)).astype(np.float32)


class TacotronSTFT:
    """Magnitude STFT -> mel bank -> log compression."""

    def __init__(self, filter_length: int = 1024, hop_length: int = 256,
                 win_length: int = 1024, n_mel_channels: int = 80,
                 sampling_rate: int = 22050, mel_fmin: float = 0.0,
                 mel_fmax: Optional[float] = 8000.0):
        self.filter_length = filter_length
        self.hop_length = hop_length
        self.win_length = win_length
        self.mel_basis = mel_filterbank(sampling_rate, filter_length,
                                        n_mel_channels, mel_fmin, mel_fmax)

    def mel_spectrogram(self, audio: np.ndarray) -> np.ndarray:
        """(B, L) float in [-1, 1] -> (B, n_mels, 1 + L // hop) log-mel."""
        audio = np.asarray(audio, np.float32)
        if audio.ndim != 2:
            raise ValueError(f"audio must be (B, L), got {audio.shape}")
        mag = stft_magnitude(audio, self.filter_length, self.hop_length,
                             self.win_length)
        mel = np.einsum("mf,bft->bmt", self.mel_basis, mag)
        return dynamic_range_compression(mel)
