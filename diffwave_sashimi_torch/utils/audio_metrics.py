"""Waveform fidelity metrics of a vocoded utterance against its source.

Port of ``diffwave_sashimi_tpu/utils/audio_metrics.py::compare`` and what
it calls: waveform MSE and SNR of the aligned signals, the L2 distance of
their log-mel spectrograms (the vocoder's own mel pipeline), and the
multi-resolution STFT distance (spectral convergence and log-magnitude).
``generate()`` writes them to ``fidelity.json`` when it vocodes a wav.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..data.stft import TacotronSTFT, stft_magnitude


def waveform_mse(a: np.ndarray, b: np.ndarray) -> float:
    n = min(a.shape[-1], b.shape[-1])
    return float(np.mean((a[..., :n] - b[..., :n]) ** 2))


def snr_db(ref: np.ndarray, est: np.ndarray) -> float:
    n = min(ref.shape[-1], est.shape[-1])
    ref, est = ref[..., :n], est[..., :n]
    noise = np.mean((ref - est) ** 2)
    if noise == 0:
        return float("inf")
    return float(10 * np.log10(np.mean(ref ** 2) / noise))


def log_mel_distance(a: np.ndarray, b: np.ndarray, sampling_rate: int,
                     filter_length: int = 1024, hop_length: int = 256,
                     win_length: int = 1024) -> float:
    """L2 distance between log-mel spectrograms (lower is better)."""
    stft = TacotronSTFT(filter_length, hop_length, win_length, 80,
                        sampling_rate, 0.0, sampling_rate / 2.0)
    n = min(a.shape[-1], b.shape[-1])
    ma = stft.mel_spectrogram(np.clip(a[..., :n], -1, 1)[None])
    mb = stft.mel_spectrogram(np.clip(b[..., :n], -1, 1)[None])
    return float(np.sqrt(np.mean((ma - mb) ** 2)))


def multires_stft_distance(a: np.ndarray, b: np.ndarray,
                           resolutions=((512, 128, 512), (1024, 256, 1024),
                                        (2048, 512, 2048))
                           ) -> Dict[str, float]:
    """Spectral convergence and log-STFT-magnitude distance, averaged over
    the resolutions the signals are long enough for."""
    n = min(a.shape[-1], b.shape[-1])
    a, b = a[..., :n], b[..., :n]
    sc, lm = [], []
    for n_fft, hop, win in resolutions:
        if n < n_fft:
            continue
        ma = stft_magnitude(a[None], n_fft, hop, win)
        mb = stft_magnitude(b[None], n_fft, hop, win)
        sc.append(np.linalg.norm(ma - mb) / (np.linalg.norm(ma) + 1e-9))
        lm.append(np.mean(np.abs(np.log(ma + 1e-7) - np.log(mb + 1e-7))))
    return {"spectral_convergence": float(np.mean(sc)),
            "log_stft_magnitude": float(np.mean(lm))}


def compare(a: np.ndarray, b: np.ndarray, sampling_rate: int
            ) -> Dict[str, float]:
    out = {"waveform_mse": waveform_mse(a, b),
           "snr_db": snr_db(a, b),
           "log_mel_l2": log_mel_distance(a, b, sampling_rate)}
    out.update(multires_stft_distance(a, b))
    return out
