"""WAV reading for the data layer (scipy).

Port of ``diffwave_sashimi_tpu/data/wav.py`` (``load_wav_raw``,
``load_wav_float``): files store int16 PCM, and model-side audio is float
in [-1, 1] after division by :data:`MAX_WAV_VALUE` (the reference's
convention).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.io import wavfile

MAX_WAV_VALUE = 32768.0


def load_wav_raw(path: str) -> Tuple[np.ndarray, int]:
    """(audio float32 at int16 scale (+-32768), sample_rate).  Stereo is
    reduced to the first channel (the reference datasets are mono)."""
    sr, data = wavfile.read(path)
    if data.ndim > 1:
        data = data[:, 0]
    if data.dtype == np.int16:
        audio = data.astype(np.float32)
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 65536.0
    elif data.dtype in (np.float32, np.float64):
        audio = (data * MAX_WAV_VALUE).astype(np.float32)
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) * 256.0
    else:
        raise ValueError(f"unsupported wav dtype {data.dtype} in {path}")
    return audio, int(sr)


def load_wav_float(path: str) -> Tuple[np.ndarray, int]:
    """(audio float32 in [-1, 1], sample_rate)."""
    audio, sr = load_wav_raw(path)
    return audio / MAX_WAV_VALUE, sr
